"""K3 and K4 (csrc/flash_bwd.cu) in the profiled training steps: the
least time of each layer's attention backward (``arith.k34_launch``) over
the two kernels' summed device time, in percent."""

from benchmark import arith, readings


def read(rec):
    return readings.train_roofline(rec, ("flash_bwd_q", "flash_bwd_kv"),
                                   arith.k34_launch)
