"""Two-level kernel cache.

Port of ``mfa_tpu/ops/cache.py``:

- *library cache*, keyed by the shape class (head dim, precision, mask
  and soft-cap options, device): the kernel descriptor, i.e. the table
  row and precision policy resolved for that class;
- *pipeline cache*, keyed by the exact problem: the kernel launch with
  its descriptor, GQA group, softmax scale and output type bound, ready
  to call.

A hit at the pipeline level skips building the problem descriptor, the
table lookup and the precision policy. The kernel library itself is
built and loaded once per process (``kernels/build.py``).

Each cache also holds the winners of the dispatch-path autotune
(:class:`AutotuneMemo`, ``MFA_AUTOTUNE``), cleared with it.

Lock-protected: serving may run schedulers on several threads.
"""

from __future__ import annotations

import collections
import threading
from dataclasses import dataclass


@dataclass
class CacheStats:
    library_hits: int = 0
    library_misses: int = 0
    pipeline_hits: int = 0
    pipeline_misses: int = 0


class TwoLevelCache:
    """Generic two-level (shape-class, exact-problem) memo.

    ``get_pipeline(problem_key, kernel_key, build_kernel, build_pipeline)``
    probes the pipeline cache; on a miss it probes or fills the library
    cache with ``build_kernel()``, builds the pipeline with
    ``build_pipeline(kernel)``, memoizes and returns it.
    """

    def __init__(self, name: str = "cache"):
        self.name = name
        self._library: dict = {}
        self._pipeline: dict = {}
        self._lock = threading.Lock()
        self.stats = CacheStats()
        self.tuned = AutotuneMemo()

    def get_pipeline(self, problem_key, kernel_key, build_kernel,
                     build_pipeline):
        with self._lock:
            hit = self._pipeline.get(problem_key)
            if hit is not None:
                self.stats.pipeline_hits += 1
                return hit
            self.stats.pipeline_misses += 1
            kernel = self._library.get(kernel_key)
            if kernel is None:
                self.stats.library_misses += 1
            else:
                self.stats.library_hits += 1
        # Build outside the lock; two threads may race to build the same
        # entry and one result wins.
        if kernel is None:
            kernel = build_kernel()
        pipeline = build_pipeline(kernel)
        with self._lock:
            self._library.setdefault(kernel_key, kernel)
            pipeline = self._pipeline.setdefault(problem_key, pipeline)
        return pipeline

    def clear(self):
        with self._lock:
            self._library.clear()
            self._pipeline.clear()
            self.stats = CacheStats()
        self.tuned.clear()

    def evict_if(self, predicate):
        """Drop pipeline and library entries whose key satisfies
        ``predicate`` (the dispatch autotune evicts its losing candidates'
        entries after a search)."""
        with self._lock:
            for d in (self._pipeline, self._library):
                for key in [k for k in d if predicate(k)]:
                    del d[key]

    def __len__(self):
        return len(self._pipeline)


class AutotuneMemo:
    """The winners of the dispatch-path autotune, by shape class.

    :meth:`resolve` runs a class's search once: a thread that asks for a
    class whose search another thread is running waits for its winner
    instead of searching again (two searches could memoize different
    winners). ``searches`` and ``timed`` count, per class, the searches
    run and the candidates they timed; ``notes`` keeps what each search
    measured.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._winners: dict = {}
        self._inflight: dict = {}
        self._local = threading.local()
        self.searches = collections.Counter()
        self.timed = collections.Counter()
        self.notes: dict = {}

    def get(self, key):
        with self._lock:
            return self._winners.get(key)

    def resolve(self, key, search):
        """The winner of class ``key``: the memo's, else what ``search()``
        returns, memoized."""
        while True:
            with self._lock:
                hit = self._winners.get(key)
                if hit is not None:
                    return hit
                event = self._inflight.get(key)
                owner = event is None
                if owner:
                    event = self._inflight[key] = threading.Event()
                    self.searches[key] += 1
            if not owner:
                event.wait()
                continue
            with _Search(self, key, event):
                winner = search()
                with self._lock:
                    return self._winners.setdefault(key, winner)

    def searching(self) -> bool:
        """Whether this thread is inside a search (its launches time
        candidates)."""
        return getattr(self._local, "searching", False)

    def clear(self):
        with self._lock:
            self._winners.clear()
            self.searches.clear()
            self.timed.clear()
            self.notes.clear()


class _Search:
    """One class's search in flight: marks the thread as searching and,
    on leaving, whether the search returned or raised, drops the class
    from those in flight and wakes the threads waiting on it (a thread
    woken without a winner searches itself)."""

    def __init__(self, memo: AutotuneMemo, key, event: threading.Event):
        self.memo, self.key, self.event = memo, key, event

    def __enter__(self):
        self.memo._local.searching = True
        return self

    def __exit__(self, *exc):
        self.memo._local.searching = False
        with self.memo._lock:
            self.memo._inflight.pop(self.key, None)
        self.event.set()
        return False


attention_cache = TwoLevelCache("attention")
gemm_cache = TwoLevelCache("gemm")
