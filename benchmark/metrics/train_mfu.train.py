"""The whole training step's share of the card's bf16 peak: the
operations one step needs (``arith.train_flops``: 6 per weight per token,
attention forward and backward over the kept pairs, the output head),
over the unprofiled steps' time, in percent."""

from benchmark import arith, readings


def read(rec):
    steps = readings.train_steps(rec, False)
    if not steps:
        return None
    s, cell = rec["shape"], rec["cell"]
    flops = arith.train_flops(s, cell["seq_len"]) * cell["batch"] * len(steps)
    return 100.0 * flops / ((steps[-1]["t1"] - rec["t0"]) * arith.BF16_FLOPS)
