"""K1 (csrc/flash_fwd.cu) in the profiled training steps: the least time
of each layer's causal forward over the step's sequence (window-capped
kept pairs, ``arith.k1_launch``) over K1's device time, in percent."""

from benchmark import arith, readings


def read(rec):
    return readings.train_roofline(rec, ("flash_fwd",), arith.k1_launch)
