"""Percent of the reserved KV pages' rows that hold a token: tokens held
over pages reserved times the page size, summed over the ``tick`` spans
of the window's host part (each counted at the tick's start, from the
scheduler's allocator)."""

from benchmark import program_spans as ps


def read(rec):
    ticks = [s.counts for s in ps.host_part(rec) if s.name == "tick"]
    rows = sum(c["pages"] * c["page_size"] for c in ticks)
    if not rows:
        return None
    return 100.0 * sum(c["tokens"] for c in ticks) / rows
