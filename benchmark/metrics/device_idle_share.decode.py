"""Percent of the traced window in which no operation ran on the card:
1 - busy / window, busy the union of the device operations' intervals.
The profiler's own host cost lengthens the window, so this reads high."""

from benchmark import readings


def read(rec):
    return readings.idle_share(rec)
