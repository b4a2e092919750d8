"""Mean time from a request's ``submit`` to the start of its ``prefill``
span, over the requests submitted in the window's host part and admitted
before its end, from the program's own spans. Unlike
``queue_wait_ms.prefill`` (to the admitting tick's start), this counts
the wait behind the earlier prefills of the same tick."""

from benchmark import program_spans as ps


def read(rec):
    return ps.mean_ms(p.start - s.start for s, p in ps.admitted(rec))
