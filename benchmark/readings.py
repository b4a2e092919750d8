"""What the per-layer readers share: the ticks of a run's record.

A traced run profiles the last ``trace_seconds`` of its window. Readings
taken on the host's clock use the ticks before the profiler started, so
that its cost does not count; readings from the device trace use the
profiled ticks, and the trace's own window.
"""

from __future__ import annotations

from benchmark import arith


def host_ticks(rec) -> list:
    return [t for t in rec["ticks"] if t["in_window"] and not t["profiled"]]


def traced_ticks(rec) -> list:
    return [t for t in rec["ticks"] if t["profiled"]]


def tick_flops(rec, tick) -> float:
    """What the model needed in a tick: each prefill at its true length,
    each decoded token at its context."""
    s = rec["shape"]
    return (sum(arith.prefill_flops(s, t) for t, _ in tick["prefills"])
            + sum(arith.decode_flops(s, c) for c in tick["contexts"]))


def mfu(rec) -> float | None:
    """Percent of the bf16 peak that the model's needed operations reach
    over the host part of the window, from its start to the end of its
    last unprofiled tick."""
    ticks = host_ticks(rec)
    if not ticks:
        return None
    seconds = ticks[-1]["t1"] - rec["t0"]
    return 100.0 * sum(tick_flops(rec, t) for t in ticks) / (
        seconds * arith.BF16_FLOPS)


def idle_share(rec) -> float | None:
    tr = rec["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def roofline(rec, group: str, launch) -> float | None:
    """Percent of the least time over the device time of a kernel group
    in the profiled ticks; ``launch(tick)`` gives the (operations, bytes)
    of each of the tick's launches of one layer."""
    tr = rec["trace"]
    if tr is None or tr["groups"].get(group, 0.0) <= 0:
        return None
    layers = rec["shape"].layers
    least = sum(arith.least_seconds(f, b) * layers
                for t in traced_ticks(rec) for f, b in launch(t))
    return 100.0 * least / tr["groups"][group] if least > 0 else None


def train_steps(rec, profiled: bool) -> list:
    return [t for t in rec["steps"] if t["profiled"] == profiled]


def train_roofline(rec, groups, launch) -> float | None:
    """Percent of the least time of ``launch`` (one layer's operations and
    bytes for one sequence) over the device time of ``groups``, over the
    profiled steps."""
    tr = rec["trace"]
    busy = sum(tr["groups"].get(g, 0.0) for g in groups) if tr else 0.0
    if busy <= 0:
        return None
    s, cell = rec["shape"], rec["cell"]
    least = arith.least_seconds(*launch(s, cell["seq_len"]))
    n = len(train_steps(rec, True)) * cell["batch"] * s.layers
    return 100.0 * least * n / busy
