"""Percent of the prefills' bucket tokens that are padding: the sum of
``bucket`` less ``prompt`` over the sum of ``bucket``, over the
``prefill`` spans of the window's host part."""

from benchmark import program_spans as ps


def read(rec):
    pre = [s.counts for s in ps.host_part(rec) if s.name == "prefill"]
    bucket = sum(c["bucket"] for c in pre)
    if not bucket:
        return None
    return 100.0 * sum(c["bucket"] - c["prompt"] for c in pre) / bucket
