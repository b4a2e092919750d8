"""Reading the device trace of a window: busy time, kernel groups, idle gaps.

``torch.profiler`` records the card's kernels, copies and fills beside the
host's operations on one clock. The harness marks its own spans with
``record_function`` names that start with ``bench:``. From the raw events:

- busy seconds: the union of the device operations' intervals;
- seconds by kernel group (``arith.GROUPS``) and by kernel name;
- idle time: the stretches of the window with no device operation, each
  part named by the harness span open on the host then.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

from benchmark import arith

SPAN = "bench:"


def span(name: str):
    """A harness span, visible in the trace (a no-op cost when no profiler
    runs)."""
    return torch.profiler.record_function(SPAN + name)


def profiler(device) -> torch.profiler.profile:
    """A profiler of the host and, on a CUDA device, of the card."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _events(prof):
    for e in prof.profiler.kineto_results.events():
        yield (e.name(), e.device_type(), e.start_ns() * 1e-9,
               e.duration_ns() * 1e-9, e.is_user_annotation())


def summarize(prof) -> dict:
    return summarize_events(_events(prof))


def summarize_events(events) -> dict:
    """The traced window, from the start of the first harness span to the
    end of the last, in the profiler's clock (seconds):
    {"busy_s", "window_s", "groups", "kernels", "idle_by_span"}.
    ``events``: (name, device type, start s, duration s, is annotation)."""
    device, spans = [], []
    for name, dev, start, dur, annotation in events:
        if name.startswith(SPAN):
            if dev == torch.autograd.DeviceType.CPU:
                spans.append((start, start + dur, name[len(SPAN):]))
            continue
        if dev == torch.autograd.DeviceType.CUDA and not annotation:
            device.append((start, start + dur, name))
    if not device or not spans:
        raise RuntimeError("the trace holds no device operation or no span")
    spans.sort()
    t0, t1 = spans[0][0], max(e for _, e, _ in spans)
    device.sort()
    groups, kernels = defaultdict(float), defaultdict(float)
    busy, gaps, end = 0.0, [], t0
    for s, e, name in device:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        groups[arith.group_of(name)] += e - s
        kernels[name] += e - s
        if s > end:
            gaps.append((end, s))
        if e > end:
            busy += e - max(s, end)
            end = e
    if t1 > end:
        gaps.append((end, t1))
    starts = [s for s, _, _ in spans]
    idle = defaultdict(float)
    for gs, ge in gaps:
        # The harness's spans do not nest: each part of a gap is named by
        # the span open then, or "harness" between spans.
        i, t = max(bisect.bisect_right(starts, gs) - 1, 0), gs
        while t < ge:
            while i < len(spans) and spans[i][1] <= t:
                i += 1
            if i == len(spans):
                idle["harness"] += ge - t
                break
            s, e, name = spans[i]
            step = min(ge, s if s > t else e)
            idle["harness" if s > t else name] += step - t
            t = step
    return {"busy_s": busy, "window_s": t1 - t0, "groups": dict(groups),
            "kernels": dict(kernels), "idle_by_span": dict(idle)}
