"""Roofline accounting: the reference's instruction model on the H100.

Port of ``mfa_tpu/utils/roofline.py``. The reference measures attention
as GINSTRS/s, where the work is (2D+5)·N² for the forward, (3D+5)·N² for
dQ and (4D+5)·N² for dK/dV, and one instruction is one FMA-class op on
one element (GINSTRS = GFLOPS/2). :func:`attention_instrs` and
:func:`attention_flops` are that arithmetic, unchanged.

The peaks are those of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates at the full 700 W power limit): bf16 on the tensor cores, fp32
outside them, and HBM. :func:`bound` is the one formula behind every
bound that ``chip_smoke.py`` prints: the larger of the operations over
the peak rate of their type and the bytes over the HBM rate.
:func:`cuda_ms` times a function on the card with CUDA events, its
launches queued behind a device spin; :func:`measure` wraps it into a
:class:`BenchResult`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOPS = 989e12            # dense bf16 tensor cores
FP32_FLOPS = 67e12             # fp32 outside the tensor cores


def attention_instrs(kernel_type: str, seq_len_q: int, seq_len_kv: int,
                     head_dim: int, batch_heads: int = 1,
                     causal: bool = False) -> float:
    """Instruction count per the reference cost model: forward
    (2D+5)·R·C, backward_query (3D+5)·R·C, backward_key_value
    (4D+5)·R·C, a full train step (9D+15)·R·C. Causal halves the area."""
    per_cell = {
        "forward": 2 * head_dim + 5,
        "backward_query": 3 * head_dim + 5,
        "backward_key_value": 4 * head_dim + 5,
        "train": 9 * head_dim + 15,
    }[kernel_type]
    area = seq_len_q * seq_len_kv
    if causal:
        area = area / 2
    return per_cell * area * batch_heads


def attention_flops(kernel_type: str, seq_len_q: int, seq_len_kv: int,
                    head_dim: int, batch_heads: int = 1,
                    causal: bool = False) -> float:
    """FLOPs = 2 x instructions (an FMA is two FLOPs)."""
    return 2.0 * attention_instrs(kernel_type, seq_len_q, seq_len_kv,
                                  head_dim, batch_heads, causal)


def bound(flops: float, nbytes: float,
          peak_flops: float = BF16_FLOPS) -> tuple[float, str]:
    """(least ms the card could take, what bounds it: "operations" or
    "bytes") for work of ``flops`` operations at ``peak_flops`` and
    ``nbytes`` moved at the HBM rate."""
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


@dataclass
class BenchResult:
    name: str
    latency_s: float
    flops: float
    bytes_accessed: float
    peak_flops: float = BF16_FLOPS     # FP32_FLOPS for fp32 work

    @property
    def tflops(self) -> float:
        return self.flops / self.latency_s / 1e12

    @property
    def ginstrs(self) -> float:
        return self.flops / 2 / self.latency_s / 1e9

    @property
    def hbm_gbps(self) -> float:
        return self.bytes_accessed / self.latency_s / 1e9

    @property
    def compute_bound_utilization(self) -> float:
        return self.flops / self.latency_s / self.peak_flops

    @property
    def roofline_utilization(self) -> float:
        """Achieved ÷ speed of light, where the least time is the larger
        of the operation-bound and the byte-bound time."""
        t_flops = self.flops / self.peak_flops
        t_bytes = self.bytes_accessed / HBM_BYTES_PER_S
        return max(t_flops, t_bytes) / self.latency_s


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device ms of fn() over ``iters`` launches (CUDA events). The
    card first spins for ~30 ms (``torch.cuda._sleep``) while the host
    queues the launches, so the events time the kernels back to back and
    not the host's launch rate (a wrapper's Python costs tens of
    microseconds, as long as a decode-sized kernel)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def measure(fn, args, flops: float, bytes_accessed: float,
            name: str = "kernel", iters: int = 20, warmup: int = 3,
            peak_flops: float = BF16_FLOPS) -> BenchResult:
    """Time fn(*args) on the card (:func:`cuda_ms`) as a
    :class:`BenchResult` of work ``flops`` and ``bytes_accessed``."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure times on the card; no CUDA device is "
                           "available")
    ms = cuda_ms(lambda: fn(*args), iters, warmup)
    return BenchResult(name=name, latency_s=ms / 1e3, flops=flops,
                       bytes_accessed=bytes_accessed, peak_flops=peak_flops)
