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

Lock-protected: serving may run schedulers on several threads.
"""

from __future__ import annotations

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

    def __len__(self):
        return len(self._pipeline)


attention_cache = TwoLevelCache("attention")
gemm_cache = TwoLevelCache("gemm")
