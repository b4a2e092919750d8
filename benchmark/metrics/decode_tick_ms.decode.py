"""Mean host-clock time of the ticks that admitted nothing (a decode step
over every slot, ending in the sampled tokens' copy to the host), over
the host part of the window."""

from benchmark import readings


def read(rec):
    ticks = [t for t in readings.host_ticks(rec) if not t["prefills"]]
    if not ticks:
        return None
    return 1e3 * sum(t["t1"] - t["t0"] for t in ticks) / len(ticks)
