"""KV-cache quantization primitives: per-row INT8 and FP8 with scales.

Port of the KV half of ``mfa_tpu/kernels/quant.py``. The scale of a row
is max(amax, 1e-8) * (1 / qmax) over the trailing axis, with 1 / qmax
rounded to fp32 first: that is what ``mfa_tpu``'s quantizers compute
under ``jax.jit`` (XLA turns the division by a constant into that
product), so the port stores the same bits as ``mfa_tpu``'s jitted
prefill and fused decode paths. Values are x / scale; INT8 rounds half
to even and clips at +-127. The fused decode kernel quantizes its
appended row with the same formulas.
"""

from __future__ import annotations

import torch

INT8_MAX = 127.0
FP8_E4M3_MAX = 448.0
FP8_E5M2_MAX = 57344.0


def recip(qmax: float) -> torch.Tensor:
    """1 / qmax rounded to fp32."""
    return torch.tensor(1.0 / qmax, dtype=torch.float32)


def fp8_max(dtype: torch.dtype) -> float:
    """Dynamic-range max of an fp8 storage type."""
    return FP8_E5M2_MAX if dtype == torch.float8_e5m2 else FP8_E4M3_MAX


def quantize_int8(x: torch.Tensor, axis: int = -1):
    """Symmetric per-row int8: returns (values int8, scales f32 with
    ``axis`` kept as size 1), x ~ values * scales."""
    xf = x.float()
    amax = xf.abs().amax(dim=axis, keepdim=True)
    scale = amax.clamp_min(1e-8) * recip(INT8_MAX)
    q = torch.round(xf / scale).clamp(-INT8_MAX, INT8_MAX).to(torch.int8)
    return q, scale


def quantize_fp8(x: torch.Tensor, axis: int = -1,
                 dtype: torch.dtype = torch.float8_e4m3fn):
    """Scaled fp8 storage: x ~ values.float() * scales."""
    xf = x.float()
    amax = xf.abs().amax(dim=axis, keepdim=True)
    scale = amax.clamp_min(1e-8) * recip(fp8_max(dtype))
    return (xf / scale).to(dtype), scale


def quantize_for(storage: torch.dtype, x: torch.Tensor):
    """x [..., D] → (values in ``storage``, [...] fp32 scales) per row over
    the trailing axis: int8 and fp8 quantize, other types just cast with
    scale 1. The KV cache's one quantizer (update and fused append)."""
    if storage == torch.int8:
        q, s = quantize_int8(x, axis=-1)
    elif storage in (torch.float8_e4m3fn, torch.float8_e5m2):
        q, s = quantize_fp8(x, axis=-1, dtype=storage)
    else:
        return x.to(storage), torch.ones(x.shape[:-1], dtype=torch.float32,
                                         device=x.device)
    return q, s[..., 0]


def dequantize(values: torch.Tensor, scales: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (values.float() * scales).to(dtype)
