"""Public GEMM API: descriptor-driven, cached, all four transpose states.

Port of ``mfa_tpu/ops/gemm.py::gemm``. Dispatch path:

  gemm(a, b, c0)
    └─ gemm_cache probe (ops/cache.py); on a miss only:
       GEMMDescriptor → kernel_descriptor(device)   [tile heuristic]
    └─ MFA_AUTOTUNE only: the tuned tile and band of this shape class
    └─ kernels/gemm_kernel.gemm_kernel               [CUDA kernel K7]

On a CUDA tensor every call launches K7. Not carried over: ``mfa_tpu``'s
concession to XLA's matmul above 1152^3 or for ``transpose_a`` (a TPU
measurement). The kernel function is looked up in its module at each
call, so a caller may swap in the plain version.

The dispatch-path autotune (``MFA_AUTOTUNE=1`` or ``set_autotune(True)``;
off by default, when dispatch takes the heuristic's tile at no cost):
the first call of a shape class on the card times K7 on the heuristic's
tile and on the other tiles and tile-walk bands it compiles, one axis at
a time (:func:`_autotune_candidates`), and every later call of the class
launches the fastest. ``torch.matmul`` is timed beside them as a
yardstick only: what runs is always K7.
"""

from __future__ import annotations

import dataclasses
import os
import time

import torch

from mfa_tpu_torch.kernels import gemm_kernel as gemm_kernel_mod
from mfa_tpu_torch.ops import params as params_mod
from mfa_tpu_torch.ops.cache import gemm_cache
from mfa_tpu_torch.ops.descriptors import GEMMDescriptor
from mfa_tpu_torch.ops.precision import OperandPrecision
from mfa_tpu_torch.utils import roofline
from mfa_tpu_torch.utils.device import check_on, resolve_device

_autotune_enabled: bool | None = None     # None: follow MFA_AUTOTUNE
# A candidate's timing (roofline.cuda_ms): warm-up launches, then timed
# launches; a search launches the kernel this many times a candidate.
MEASURE_WARMUP = 3
MEASURE_ITERS = 20
SEARCH_LAUNCHES = MEASURE_WARMUP + MEASURE_ITERS


def set_autotune(enabled: bool | None) -> None:
    """Force the dispatch-path autotune on or off (None: follow the
    ``MFA_AUTOTUNE`` environment variable)."""
    global _autotune_enabled
    _autotune_enabled = enabled


def autotune_active() -> bool:
    if _autotune_enabled is not None:
        return _autotune_enabled
    return os.environ.get("MFA_AUTOTUNE", "0") not in ("", "0", "false")


def _measure_dispatch(thunk) -> float:
    """Device ms of one call of ``thunk`` on the card (CUDA events)."""
    return roofline.cuda_ms(thunk, iters=MEASURE_ITERS,
                            warmup=MEASURE_WARMUP)


def _no_measuring() -> bool:
    """Under CUDA graph capture or torch.compile nothing can be timed: the
    hooks use the memo or the table row, and memoize nothing."""
    return torch.compiler.is_compiling() or (
        torch.cuda.is_available() and torch.cuda.is_current_stream_capturing())


def gemm(a, b, c0=None, *, transpose_a: bool = False,
         transpose_b: bool = False, out_dtype: torch.dtype | None = None,
         device="cuda"):
    """C = op(A) @ op(B) (+ C0), op an optional transpose of the stored
    operand, fp32 accumulation.

    2-D ([m, k]) or 3-D batched ([batch, m, k]) operands; the batch dims
    must match. ``c0`` is added before the one cast (``mfa_tpu``'s
    ``load_previous_C``). The output type is ``out_dtype`` or the
    promotion of the operand types. All tensors must lie on ``device``
    (default ``cuda``); on the CPU the kernel's plain version runs.
    """
    dev = resolve_device(device)
    check_on(dev, a=a, b=b, **({} if c0 is None else {"c0": c0}))
    if a.dim() != b.dim() or a.dim() not in (2, 3):
        raise ValueError(f"a and b must both be 2-D or 3-D, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    squeeze = a.dim() == 2
    if squeeze:
        a, b = a[None], b[None]
        c0 = None if c0 is None else c0[None]
    batch = a.shape[0]
    if b.shape[0] != batch:
        raise ValueError(f"batch mismatch: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    m = a.shape[2] if transpose_a else a.shape[1]
    k = a.shape[1] if transpose_a else a.shape[2]
    kb = b.shape[2] if transpose_b else b.shape[1]
    n = b.shape[1] if transpose_b else b.shape[2]
    if k != kb:
        raise ValueError(f"K mismatch: {k} vs {kb}")
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    for name, dt in (("a", a.dtype), ("b", b.dtype), ("out", out_dtype)):
        if dt not in gemm_kernel_mod.TYPE_CODES:
            raise TypeError(f"gemm takes fp32, bf16 or fp16; {name} is {dt}")

    def descriptor():
        return GEMMDescriptor(
            m=m, n=n, k=k,
            a_precision=OperandPrecision.from_dtype(a.dtype),
            b_precision=OperandPrecision.from_dtype(b.dtype),
            c_precision=OperandPrecision.from_dtype(out_dtype),
            transpose_a=transpose_a, transpose_b=transpose_b, batch=batch,
            load_previous_c=c0 is not None)

    key = (batch, m, n, k, a.dtype, b.dtype, out_dtype, transpose_a,
           transpose_b, c0 is not None, str(dev))
    kd = gemm_cache.get_pipeline(
        key, key,
        lambda: descriptor().kernel_descriptor(params_mod.detect_device(dev)),
        lambda kd: kd)
    if dev.type == "cuda" and autotune_active():
        kd = _autotuned_kd(kd, descriptor(), a, b, c0, out_dtype)
    c = gemm_kernel_mod.gemm_kernel(a, b, c0, kd, out_dtype=out_dtype)
    return c[0] if squeeze else c


def _autotune_candidates(kd, mappable: bool,
                         device: params_mod.HopperDevice = params_mod.H100
                         ) -> list[tuple]:
    """The candidates of the dispatch-path autotune, as (slot, tile name,
    band): K7's launch with ``params.GEMM_TILES[name]`` as the
    descriptor's ``slot`` ("tile", or "mma_tile" where TMA cannot map the
    operands of a wgmma tile) and ``band`` tile rows a band of its walk
    (None: GEMM_TILE_GROUP). The heuristic's choice first, then one axis
    at a time: the other tiles K7 compiles for the path the launch takes
    (the wgmma tiles w256 and w128 where TMA maps the operands, the
    mma.sync tiles m128, m64 and m16 where it does not and for fp16), and
    on a wgmma tile the bands of ``params.GEMM_TILE_GROUPS``. The FMA tile
    has no alternative. Every tile passes ``params.check_tile_fits``."""
    if kd.tile.path == "wgmma":
        slot = "tile" if mappable else "mma_tile"
    else:
        slot = "tile"
    base = getattr(kd, slot)
    if base.path == "ffma":
        return [(slot, base.name, None)]
    names = [t.name for t in params_mod.GEMM_TILES.values()
             if t.path == base.path]
    cands = [(slot, base.name, None)]
    cands += [(slot, name, None) for name in names if name != base.name]
    if base.path == "wgmma":
        cands += [(slot, base.name, g) for g in params_mod.GEMM_TILE_GROUPS
                  if g != params_mod.GEMM_TILE_GROUP]
    for _, name, _ in cands:
        tile = params_mod.GEMM_TILES[name]
        params_mod.check_tile_fits(
            params_mod.gemm_smem_bytes(tile, kd.transpose_a, kd.transpose_b),
            tile, device)
    return cands


def _with_candidate(kd, cand):
    """kd launched as candidate ``cand`` (only its tile and band change)."""
    slot, name, band = cand
    return dataclasses.replace(kd, **{slot: params_mod.GEMM_TILES[name]},
                               group=band)


def _candidate_kd(cls_key, kd, cand):
    """The descriptor of candidate ``cand`` of class ``cls_key``, kept in
    gemm_cache (the winner's stays there after a search; the losers' are
    evicted)."""
    return gemm_cache.get_pipeline((cls_key, cand), cls_key, lambda: kd,
                                   lambda kd0: _with_candidate(kd0, cand))


def _autotuned_kd(kd, desc, a, b, c0, out_dtype, measure=None):
    """kd with the tile and band that the autotune memo holds for this
    shape class, running the candidate search on the class's first call.

    ``measure(candidate_kd)`` gives a candidate's time; the default
    launches K7 on these operands and times it on the card, and then
    also times ``torch.matmul`` on them (recorded in the memo's notes,
    never launched in K7's place). Under CUDA graph capture or
    torch.compile nothing is timed: the memo's winner or kd, unmemoized.
    """
    mappable = gemm_kernel_mod.tma_mappable(_as_launched(a), _as_launched(b))
    cls_key = (desc.m, desc.n, desc.k, desc.batch, str(a.dtype),
               str(b.dtype), str(out_dtype), desc.transpose_a,
               desc.transpose_b, desc.load_previous_c, mappable,
               str(a.device))
    memo = gemm_cache.tuned
    if measure is None and _no_measuring():
        hit = memo.get(cls_key)
        return kd if hit is None else _with_candidate(kd, hit)
    yardstick = measure is None
    if measure is None:
        def measure(cand_kd):
            return _measure_dispatch(lambda: gemm_kernel_mod.gemm_kernel(
                a, b, c0, cand_kd, out_dtype=out_dtype))

    def search():
        cands = _autotune_candidates(
            kd, mappable, params_mod.detect_device(a.device))
        if len(cands) == 1:
            return cands[0]
        t0 = time.perf_counter()
        times = [measure(_candidate_kd(cls_key, kd, c)) for c in cands]
        memo.timed[cls_key] += len(cands)
        best = cands[min(range(len(cands)), key=times.__getitem__)]
        note = {"candidates": [(c[1], c[2], t) for c, t in zip(cands, times)],
                "winner": best[1:], "heuristic_ms": times[0],
                "winner_ms": min(times)}
        note["search_s"] = time.perf_counter() - t0
        if yardstick:
            note["matmul_ms"] = _measure_dispatch(
                lambda: _torch_matmul(a, b, c0, desc, out_dtype))
        memo.notes[cls_key] = note
        gemm_cache.evict_if(lambda key: (
            isinstance(key, tuple) and len(key) == 2 and key[0] == cls_key
            and key[1] != best))
        return best

    return _candidate_kd(cls_key, kd, memo.resolve(cls_key, search))


def _as_launched(t):
    """The operand as K7 reads it, for its TMA check: ``t``, or where its
    innermost stride is not 1 (the wrapper then copies it) a contiguous
    meta tensor of its shape, which nothing copies."""
    if t.stride(2) == 1 or t.shape[2] == 1:
        return t
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _torch_matmul(a, b, c0, desc, out_dtype):
    """torch.matmul of the same operands (the yardstick)."""
    y = torch.matmul(a.transpose(1, 2) if desc.transpose_a else a,
                     b.transpose(1, 2) if desc.transpose_b else b)
    if c0 is not None:
        y = y.float() + c0.float()
    return y.to(out_dtype)
