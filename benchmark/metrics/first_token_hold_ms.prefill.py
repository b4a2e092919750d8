"""Mean time a request's first token waits to be returned: from the end
of its ``prefill`` span (the host holds the token) to the end of the
``tick`` around it (``step()`` returns, after the tick's later prefills
and its decode step), over the requests submitted in the window's host
part and admitted before its end, from the program's own spans."""

from benchmark import program_spans as ps


def read(rec):
    return ps.mean_ms(ps.root(p).end - p.end for _, p in ps.admitted(rec))
