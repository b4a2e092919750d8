"""Public GEMM API: descriptor-driven, cached, all four transpose states.

Port of ``mfa_tpu/ops/gemm.py::gemm``. Dispatch path:

  gemm(a, b, c0)
    └─ gemm_cache probe (ops/cache.py); on a miss only:
       GEMMDescriptor → kernel_descriptor(device)   [tile heuristic]
    └─ kernels/gemm_kernel.gemm_kernel               [CUDA kernel K7]

On a CUDA tensor every call launches K7. Not carried over: ``mfa_tpu``'s
concession to XLA's matmul above 1152^3 or for ``transpose_a`` (a TPU
measurement), and its ``MFA_AUTOTUNE`` dispatch hook (queued with the
tooling in ROADMAP.md). The kernel function is looked up in its module
at each call, so a caller may swap in the plain version.
"""

from __future__ import annotations

import torch

from mfa_tpu_torch.kernels import gemm_kernel as gemm_kernel_mod
from mfa_tpu_torch.ops import params as params_mod
from mfa_tpu_torch.ops.cache import gemm_cache
from mfa_tpu_torch.ops.descriptors import GEMMDescriptor
from mfa_tpu_torch.ops.precision import OperandPrecision
from mfa_tpu_torch.utils.device import check_on, resolve_device


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

    def build_kernel():
        return GEMMDescriptor(
            m=m, n=n, k=k,
            a_precision=OperandPrecision.from_dtype(a.dtype),
            b_precision=OperandPrecision.from_dtype(b.dtype),
            c_precision=OperandPrecision.from_dtype(out_dtype),
            transpose_a=transpose_a, transpose_b=transpose_b, batch=batch,
            load_previous_c=c0 is not None,
        ).kernel_descriptor(params_mod.detect_device(dev))

    key = (batch, m, n, k, a.dtype, b.dtype, out_dtype, transpose_a,
           transpose_b, c0 is not None, str(dev))
    kd = gemm_cache.get_pipeline(key, key, build_kernel, lambda kd: kd)
    c = gemm_kernel_mod.gemm_kernel(a, b, c0, kd, out_dtype=out_dtype)
    return c[0] if squeeze else c
