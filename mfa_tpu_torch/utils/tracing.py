"""The port's one recorder: counters, gauges and spans, and a Chrome trace.

Port of ``mfa_tpu/utils/profiling.py``'s ``Metrics``, its module-level
``metrics`` instance (the one the program reports into) and ``trace``
(``jax.profiler.trace`` there), extended with spans:

- :meth:`Metrics.span` records ``(name, start, end, parent, req, counts)``
  into a bounded ring: ``start`` and ``end`` on ``time.perf_counter()``,
  ``parent`` the span open around it on the same thread, ``req`` the
  ``Request.id`` it served, ``counts`` what it counted;
- :meth:`Metrics.event` records an instant (a span whose end is its
  start);
- :meth:`Metrics.spans` reads them back, :meth:`Metrics.lost` says
  whether any that started after a time fell out of the ring.

While a ``torch.profiler`` records, a span also opens
``record_function("mfa:" + name)``, so it lies on the trace's clock
beside the kernels it launched; with ``device=True`` it also records a
CUDA event pair on the current stream, read as device milliseconds
(:attr:`Span.device_ms`) only when the span is read. With no profiler
running a span makes no torch call but that check: no synchronize, no
copy.

A leaf module (torch, the standard library and ``utils/device.py``), so
that the scheduler and the trainer can report into it while
``utils/profiling.py`` imports them.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict, deque
from pathlib import Path
from time import perf_counter

import torch

from mfa_tpu_torch.utils.device import resolve_device

TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "trace"
# Spans kept: a 51-second window of 128-slot chat makes ~530 ticks of
# 8-10 spans each, so four times three such windows fit.
RING = 65536
# The prefix of a span's name in a profiler trace.
PREFIX = "mfa:"

_profiling = torch._C._autograd._profiler_enabled


class Span:
    """One recorded span, or an instant (``end == start``); a context
    (:meth:`Metrics.span`)."""

    __slots__ = ("name", "start", "end", "parent", "req", "counts",
                 "_metrics", "_device", "_mirror", "_events", "_device_ms")

    def __init__(self, metrics, name, req, device, counts):
        self.name, self.req, self.counts = name, req, counts
        self.start = self.end = self.parent = None
        self._metrics, self._device = metrics, device
        self._mirror = self._events = self._device_ms = None

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def device_ms(self) -> float | None:
        """Milliseconds on the card between the span's CUDA events (waits
        for the later one), or None where the span recorded none."""
        if self._events is not None:
            first, last = self._events
            last.synchronize()
            self._device_ms = first.elapsed_time(last)
            self._events = None
        return self._device_ms

    def __enter__(self):
        m = self._metrics
        stack = m._stack()
        self.parent = stack[-1] if stack else None
        if _profiling():
            self._mirror = torch.profiler.record_function(PREFIX + self.name)
            self._mirror.__enter__()
            if self._device and torch.cuda.is_initialized():
                first = torch.cuda.Event(enable_timing=True)
                first.record()
                self._events = (first, None)
        stack.append(self)
        self.start = perf_counter()
        m._push(self)

    def __exit__(self, *exc) -> bool:
        self.end = perf_counter()
        self._metrics._stack().pop()
        if self._mirror is not None:
            if self._events is not None:
                last = torch.cuda.Event(enable_timing=True)
                last.record()
                self._events = (self._events[0], last)
            self._mirror.__exit__(None, None, None)
            self._mirror = None
        return False


class Metrics:
    """Thread-safe counters, gauges and a ring of spans.

    ``snapshot()`` keeps ``mfa_tpu``'s keys; its latencies are computed
    from the spans in the ring (count, mean and max by name)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self.counters: dict = defaultdict(int)
        self.gauges: dict = {}
        self._ring: deque = deque(maxlen=RING)
        self.dropped = 0                # spans that fell out of the ring
        self._lost_to = float("-inf")   # the start of the newest of them

    def inc(self, name: str, value: int = 1):
        with self._lock:
            self.counters[name] += value

    def set(self, name: str, value):
        with self._lock:
            self.gauges[name] = value

    def span(self, name: str, *, req=None, device: bool = False,
             **counts) -> Span:
        """A context recording the host time of its block under ``name``,
        also when the block raises (``device``: and, under a profiler,
        the card's time between its start and end)."""
        return Span(self, name, req, device, counts)

    def timed(self, name: str) -> Span:
        """``mfa_tpu``'s name for a span: end card work inside it with
        ``torch.cuda.synchronize()`` to include that work."""
        return self.span(name)

    def event(self, name: str, *, req=None, **counts):
        """Record an instant under ``name``."""
        s = Span(self, name, req, False, counts)
        stack = self._stack()
        s.parent = stack[-1] if stack else None
        s.start = s.end = perf_counter()
        self._push(s)

    def spans(self, since: float = float("-inf"),
              until: float = float("inf")) -> list[Span]:
        """The ended spans and instants that started in [since, until],
        in the order they started."""
        with self._lock:
            return [s for s in self._ring
                    if s.end is not None and since <= s.start <= until]

    def lost(self, since: float = float("-inf")) -> bool:
        """Whether any span that started at ``since`` or later fell out of
        the ring (it drops the oldest first)."""
        return self.dropped > 0 and self._lost_to >= since

    def clear(self):
        """Empty the ring and its count of dropped spans."""
        with self._lock:
            self._ring.clear()
            self.dropped = 0
            self._lost_to = float("-inf")

    def snapshot(self) -> dict:
        by_name = defaultdict(list)
        for s in self.spans():
            if s.end != s.start:
                by_name[s.name].append(s.seconds)
        lat = {k: {"count": len(v), "mean_ms": 1e3 * sum(v) / len(v),
                   "max_ms": 1e3 * max(v)} for k, v in by_name.items()}
        with self._lock:
            return {"counters": dict(self.counters),
                    "gauges": dict(self.gauges), "latencies": lat}

    def _stack(self) -> list:
        """The spans open on this thread, innermost last."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _push(self, span: Span):
        with self._lock:
            ring = self._ring
            if len(ring) == ring.maxlen:
                self.dropped += 1
                self._lost_to = max(self._lost_to, ring[0].start)
            ring.append(span)


metrics = Metrics()


@contextlib.contextmanager
def trace(log_dir=TRACE_DIR, *, device="cuda"):
    """Profile a region with ``torch.profiler`` (host activity, and the
    card's kernels for ``device`` cuda) and write its Chrome trace into
    ``log_dir`` (open it in chrome://tracing or Perfetto). Yields the
    directory."""
    dev = resolve_device(device)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(str(log_dir / f"trace_{time.time_ns()}.json"))
