"""Mean host time of the ``decode`` span of ``PagedScheduler.step()``
over the plain ticks (that admitted nothing) of the window's host part:
the host enqueueing the batched decode step's launches, from the
program's own spans. Part of what ``decode_tick_ms.decode`` times whole
from outside."""

from benchmark import program_spans as ps


def read(rec):
    return ps.mean_ms(t["decode"].seconds
                      for t in ps.plain_ticks(ps.host_part(rec)))
