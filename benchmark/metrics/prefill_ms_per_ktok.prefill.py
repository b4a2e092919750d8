"""Prefill time per thousand true prompt tokens: the admitting ticks'
time less as many mean non-admitting ticks (the decode step they also
run), over the prompt tokens they admitted, in the host part of the
window. Bucket padding is time spent, not tokens served."""

from benchmark import readings


def read(rec):
    ticks = readings.host_ticks(rec)
    admit = [t for t in ticks if t["prefills"]]
    plain = [t["t1"] - t["t0"] for t in ticks if not t["prefills"]]
    if not admit or not plain:
        return None
    decode = sum(plain) / len(plain)
    spent = sum(t["t1"] - t["t0"] - decode for t in admit)
    tokens = sum(n for t in admit for n, _ in t["prefills"])
    return 1e3 * spent / (tokens / 1e3)
