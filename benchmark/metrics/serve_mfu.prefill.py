"""The whole step's share of the card's bf16 peak: the operations the
model needs for what the window served (projections at 2 per weight per
true token, attention over the kept pairs, the output head once per
emitted token), over the host part of the window's time, in percent."""

from benchmark import readings


def read(rec):
    return readings.mfu(rec)
