"""K6 (csrc/paged_decode.cu) over the profiled ticks: the least time of
its launches (each layer's, over the active slots' window-capped
contexts, ``arith.k6_launch``) over its device time (kernel names with
``PagedRows``), in percent."""

from benchmark import arith, readings


def read(rec):
    s, nb, sc = rec["shape"], rec["kv_bytes"], rec["kv_scaled"]
    return readings.roofline(
        rec, "paged_decode",
        lambda t: [arith.k6_launch(s, t["contexts"], nb, sc)])
