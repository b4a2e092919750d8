"""What the readers of the program's own spans share.

The program records its spans into one process-level ring,
``mfa_tpu_torch.utils.tracing.metrics``, on ``time.perf_counter()``: the
clock of the record's ``t0``, ``host_end``, ``t1`` and its ticks' and
steps' bounds. ``PagedScheduler.step()`` records a ``tick`` with the
children retire, admit (one ``prefill`` a request), prepare, decode, sync
and emit, and ``submit`` an instant; ``train_step`` records forward,
backward, clip and optimizer. A reader gives nothing where the program
has no such recorder, or where spans of its interval fell out of the
ring.
"""

from __future__ import annotations


def window(since: float, until: float) -> list:
    """The program's spans and instants that started in [since, until];
    empty without the recorder or if any of them was dropped."""
    try:
        from mfa_tpu_torch.utils.tracing import metrics
    except ImportError:             # a program without the recorder
        return []
    if metrics.lost(since):
        return []
    return metrics.spans(since, until)


def host_part(rec) -> list:
    """The spans that started in the window's host part, [t0, host_end]:
    the ticks before the profiler started."""
    return window(rec["t0"], rec["host_end"])


def children(spans) -> dict:
    """Each span → its recorded children, in the order they started."""
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    return kids


def root(span):
    """The outermost span around ``span`` (its tick or training step)."""
    while span.parent is not None:
        span = span.parent
    return span


def plain_ticks(spans) -> list[dict]:
    """The ``tick`` spans that decoded and admitted nothing (no
    ``prefill`` under their ``admit``), each as {child name: child}."""
    kids = children(spans)
    out = []
    for t in spans:
        if t.name == "tick":
            named = {c.name: c for c in kids.get(t, ())}
            if "decode" in named and not kids.get(named["admit"]):
                out.append(named)
    return out


def admitted(rec) -> list[tuple]:
    """(``submit``, ``prefill``) of each request submitted in the host
    part and admitted before ``host_end``."""
    spans = host_part(rec)
    submitted = {s.req: s for s in spans if s.name == "submit"}
    return [(submitted[s.req], s) for s in spans
            if s.name == "prefill" and s.req in submitted]


def mean_ms(seconds) -> float | None:
    seconds = list(seconds)
    return 1e3 * sum(seconds) / len(seconds) if seconds else None
