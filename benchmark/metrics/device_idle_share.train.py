"""Percent of the traced training window in which no operation ran on
the card: 1 - busy / window. The profiler's host cost lengthens the
window, so this reads high."""

from benchmark import readings


def read(rec):
    return readings.idle_share(rec)
