"""Quantization primitives: KV rows (INT8, FP8) and weights (INT8, INT4).

Port of ``mfa_tpu/kernels/quant.py``.

KV half. The scale of a row is max(amax, 1e-8) * (1 / qmax) over the
trailing axis, with 1 / qmax rounded to fp32 first: that is what
``mfa_tpu``'s quantizers compute under ``jax.jit`` (XLA turns the division
by a constant into that product), so the port stores the same bits as
``mfa_tpu``'s jitted prefill and fused decode paths. Values are
x / scale; INT8 rounds half to even and clips at +-127. The fused decode
kernel quantizes its appended row with the same formulas.

Weight half. ``mfa_tpu``'s ``quantize_params`` runs eagerly, so its weight
scales are max(amax, 1e-8) / qmax, a true division (not the jitted
product above): :func:`pack_int4_halves`, :func:`pack_int4_biased`,
:func:`quantize_int4` and :func:`quantize_weight` divide, and give
``mfa_tpu``'s eager bits. INT4 weights are HALF-SPLIT: in ``mfa_tpu``'s
layout [K/2, N], byte[i, o] holds logical row i of the [K, N] weight in
its low nibble and row i + K/2 in its high nibble. (``mfa_tpu``'s
``QuantizedWeight`` docstring says [out, in/2]; its real INT4 layout is
this [in/2, out] one.) The port's :class:`QuantizedWeight` keeps the same
bytes transposed to [N, K/2], so that a row of the kernel's B tile is
contiguous along K.
"""

from __future__ import annotations

from dataclasses import dataclass

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


# ---------------------------------------------------------------------------
# Weight-only quantization
# ---------------------------------------------------------------------------

INT4_MAX = 7.0
INT4_BIAS = 8
# QuantizedWeight.layout → the packed tensor's dtype.
WEIGHT_LAYOUTS = {"int8": torch.int8, "int4": torch.int8,
                  "int4_biased": torch.uint8}


@dataclass
class QuantizedWeight:
    """A weight-only quantized projection y = x @ W, W [K, N] (K = in).

    layout "int8":        w [N, K] int8, scale [N] fp32: W = w.T * scale.
    layout "int4":        w [N, K/2] int8, half-split signed nibbles:
                          byte[n, i] holds q[i, n] (low nibble) and
                          q[i + K/2, n] (high nibble), q in [-7, 7];
                          scale [N] fp32.
    layout "int4_biased": w [N, K/2] uint8, the same geometry with q + 8
                          in [1, 15] in each nibble.
    """

    w: torch.Tensor
    scale: torch.Tensor
    layout: str

    def __post_init__(self):
        want = WEIGHT_LAYOUTS.get(self.layout)
        if want is None:
            raise ValueError(f"unknown weight layout {self.layout!r}")
        if self.w.dtype != want:
            raise TypeError(f"layout {self.layout!r} stores {want}, got "
                            f"{self.w.dtype}")

    def to(self, device) -> "QuantizedWeight":
        return QuantizedWeight(self.w.to(device), self.scale.to(device),
                               self.layout)

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """W as [N, K] in ``dtype`` (test and yardstick helper)."""
        if self.layout == "int8":
            q = self.w.float()
        else:
            lo, hi = (unpack_int4_biased if self.layout == "int4_biased"
                      else unpack_int4_halves)(self.w)
            q = torch.cat([lo, hi], dim=1).float()
        return (q * self.scale[:, None]).to(dtype)


def _weight_scale(wf: torch.Tensor, qmax: float, dim: int) -> torch.Tensor:
    """max(amax, 1e-8) / qmax over ``dim``, kept: the eager division."""
    return wf.abs().amax(dim=dim, keepdim=True).clamp_min(1e-8) / qmax


def _int4_values(wf: torch.Tensor, dim: int):
    scale = _weight_scale(wf, INT4_MAX, dim)
    q = torch.round(wf / scale).clamp(-INT4_MAX, INT4_MAX).to(torch.int8)
    return q, scale


def _half_split_values(w: torch.Tensor):
    """w [K, N] float → (q [K, N] int8 in [-7, 7], scale [1, N] fp32),
    per-output-channel scales over the contraction axis."""
    wf = w.float()
    if wf.shape[0] % 2 != 0:
        raise ValueError(f"half-split int4 needs even contraction dim, got "
                         f"{tuple(wf.shape)}")
    return _int4_values(wf, 0)


def pack_int4_halves(w: torch.Tensor):
    """``mfa_tpu``'s half-split INT4 in its layout: w [K, N] float →
    (packed [K/2, N] int8, scale [1, N] fp32)."""
    q, scale = _half_split_values(w)
    kh = q.shape[0] // 2
    return (q[:kh] & 0x0F) | ((q[kh:] & 0x0F) << 4), scale


def unpack_int4_halves(packed: torch.Tensor):
    """Signed half-split bytes → (low half, high half) int8 in [-8, 7]:
    the low nibble sign-extended, the high nibble an arithmetic shift."""
    return (packed << 4) >> 4, packed >> 4


def pack_int4_biased(w: torch.Tensor):
    """Half-split packing with +8-biased unsigned nibbles: w [K, N] float
    → (packed [K/2, N] uint8, scale [1, N] fp32)."""
    q, scale = _half_split_values(w)
    kh = q.shape[0] // 2
    qb = (q.to(torch.int32) + INT4_BIAS).to(torch.uint8)
    return qb[:kh] | (qb[kh:] << 4), scale


def unpack_int4_biased(packed: torch.Tensor):
    """Biased half-split bytes → (low, high) int32 halves in [-8, 7], the
    bias removed (the kernel keeps it and subtracts 8 * rowsum(x))."""
    p32 = packed.to(torch.int32)
    return (p32 & 0x0F) - INT4_BIAS, (p32 >> 4) - INT4_BIAS


def quantize_int4(x: torch.Tensor, axis: int = -1):
    """Nibble-interleaved symmetric INT4: (packed int8 [..., k/2], scales);
    value i sits in nibble i % 2 of byte i // 2, along the last axis
    whatever the scale ``axis``."""
    xf = x.float()
    q, scale = _int4_values(xf, axis)
    if q.shape[-1] % 2 != 0:
        raise ValueError(f"int4 packing needs even last dim, got "
                         f"{tuple(q.shape)}")
    return (q[..., 0::2] & 0x0F) | ((q[..., 1::2] & 0x0F) << 4), scale


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[..., k/2] int8 → [..., k] int8 (interleaved nibbles)."""
    lo, hi = unpack_int4_halves(packed)
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1],
                                                 packed.shape[-1] * 2)


def dequantize_int4(packed: torch.Tensor, scales: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (unpack_int4(packed).float() * scales).to(dtype)


def quantize_weight(w: torch.Tensor, layout: str) -> QuantizedWeight:
    """A projection weight in the port's [N, K] layout → QuantizedWeight
    with ``mfa_tpu``'s eager bits (``quantize_params``: INT8 per output
    channel over the input axis; INT4 half-split)."""
    wf = w.float()
    if layout == "int8":
        scale = _weight_scale(wf, INT8_MAX, 1)
        q = torch.round(wf / scale).clamp(-INT8_MAX, INT8_MAX).to(torch.int8)
        return QuantizedWeight(q, scale[:, 0], layout)
    packs = {"int4": pack_int4_halves, "int4_biased": pack_int4_biased}
    if layout not in packs:
        raise ValueError(f"unknown weight layout {layout!r}")
    packed, scale = packs[layout](wf.t())
    return QuantizedWeight(packed.t().contiguous(), scale[0].contiguous(),
                           layout)
