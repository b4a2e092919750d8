"""K1 (csrc/flash_fwd.cu) over the profiled ticks: the least time of each
prefill's causal attention at its true prompt length (``arith.k1_launch``;
the bucket's padding counts as lost share) over K1's device time, in
percent."""

from benchmark import arith, readings


def read(rec):
    s = rec["shape"]
    return readings.roofline(
        rec, "flash_fwd",
        lambda t: [arith.k1_launch(s, n) for n, _ in t["prefills"]])
