"""Mean device time of a training step's ``clip`` (the global norm) and
``optimizer`` (AdamW) spans, between the CUDA events the program records
around each under the profiler, over the ``train_step`` spans that
started inside a profiled step of the window. None without the card's
events."""

from benchmark import program_spans as ps


def read(rec):
    steps = [t for t in rec["steps"] if t["profiled"]]
    if not steps:
        return None
    spans = ps.window(steps[0]["t0"], steps[-1]["t1"])
    kids = ps.children(spans)
    per_step = []
    for s in spans:
        if s.name == "train_step" and any(
                t["t0"] <= s.start <= t["t1"] for t in steps):
            ms = [c.device_ms for c in kids.get(s, ())
                  if c.name in ("clip", "optimizer")]
            if len(ms) != 2 or None in ms:
                return None
            per_step.append(sum(ms))
    return sum(per_step) / len(per_step) if per_step else None
