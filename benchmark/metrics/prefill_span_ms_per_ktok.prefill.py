"""Prefill time per thousand true prompt tokens, from the ``prefill``
spans of the window's host part (forward over the bucket, the splice
into pages, the first token's sample): their summed host time over
their summed ``prompt`` tokens. Bucket padding is time spent, not tokens
served. Times what ``prefill_ms_per_ktok.prefill`` infers from the
admitting ticks less a mean decode tick."""

from benchmark import program_spans as ps


def read(rec):
    pre = [s for s in ps.host_part(rec) if s.name == "prefill"]
    tokens = sum(s.counts["prompt"] for s in pre)
    if not tokens:
        return None
    return 1e3 * sum(s.seconds for s in pre) / (tokens / 1e3)
