"""Slots a decode tick serves: tokens the decode steps emitted (the
scheduler's ``tokens`` less its ``prefills``) per decode step, from the
scheduler's own counters over the host part of the window."""

from benchmark import readings


def read(rec):
    ticks = readings.host_ticks(rec)
    steps = sum(t["stats"]["decode_steps"] for t in ticks)
    if not steps:
        return None
    return sum(t["stats"]["tokens"] - t["stats"]["prefills"]
               for t in ticks) / steps
