"""Plain-PyTorch golden reference for the attention forward.

Port of ``attention_reference`` from ``mfa_tpu/ops/reference.py``: the
forward oracle over [B, H, S, D] operands with GQA, causal masks aligned
to the sequence ends, sliding window and tanh soft-cap. Computes in fp32
(or float64 when given float64) with L as the natural-log logsumexp.
The analytic gradients come with the training slice.
"""

from __future__ import annotations

import math

import torch


def _expand_kv(x: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    """Broadcast KV heads to Q heads for GQA. x: [B, Hkv, S, D]."""
    hkv = x.shape[1]
    if hkv == num_q_heads:
        return x
    return torch.repeat_interleave(x, num_q_heads // hkv, dim=1)


def attention_reference(q, k, v, scale: float | None = None,
                        causal: bool = False,
                        logit_soft_cap: float | None = None,
                        sliding_window: int | None = None):
    """q: [B, Hq, R, D]; k, v: [B, Hkv, C, D] → (O [B, Hq, R, D],
    L [B, Hq, R]). Rows that see no key give O = 0 and L = 0."""
    work = torch.float64 if q.dtype == torch.float64 else torch.float32
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    hq = q.shape[1]
    k = _expand_kv(k, hq).to(work)
    v = _expand_kv(v, hq).to(work)
    s = torch.einsum("bhrd,bhcd->bhrc", q.to(work), k) * scale
    if logit_soft_cap is not None:
        s = logit_soft_cap * torch.tanh(s / logit_soft_cap)
    if causal or sliding_window is not None:
        r, c = s.shape[-2], s.shape[-1]
        row = torch.arange(r, device=s.device)[:, None]
        col = torch.arange(c, device=s.device)[None, :]
        mask = col <= row + (c - r)
        if sliding_window is not None:
            mask &= col >= row + (c - r) - (sliding_window - 1)
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-37)
    o = torch.einsum("bhrc,bhcd->bhrd", p, v) / l
    lse = (m + torch.log(l))[..., 0]
    return o, lse
