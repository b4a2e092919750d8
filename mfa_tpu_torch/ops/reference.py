"""Plain-PyTorch golden reference: attention forward and gradients.

Port of ``mfa_tpu/ops/reference.py``: the forward oracle
(:func:`attention_reference`) over [B, H, S, D] operands with GQA, causal
masks aligned to the sequence ends, sliding window and tanh soft-cap; the
analytic gradients through explicit dS (:func:`attention_grads_reference`,
dK/dV summed over each GQA group); and the loss Phi = sum(dO * O) whose
gradient they are (:func:`phi_loss`). Computes in fp32 (or float64 when
given float64) with L as the natural-log logsumexp.
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


def _visible(r: int, c: int, causal: bool, sliding_window: int | None,
             device) -> torch.Tensor | None:
    """[R, C] bool mask (diagonal aligned to the ends), or None."""
    if not (causal or sliding_window is not None):
        return None
    row = torch.arange(r, device=device)[:, None]
    col = torch.arange(c, device=device)[None, :]
    mask = col <= row + (c - r)
    if sliding_window is not None:
        mask &= col >= row + (c - r) - (sliding_window - 1)
    return mask


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
    mask = _visible(s.shape[-2], s.shape[-1], causal, sliding_window,
                    s.device)
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-37)
    o = torch.einsum("bhrc,bhcd->bhrd", p, v) / l
    lse = (m + torch.log(l))[..., 0]
    return o, lse


def attention_grads_reference(q, k, v, d_o, scale: float | None = None,
                              causal: bool = False,
                              logit_soft_cap: float | None = None,
                              sliding_window: int | None = None):
    """Analytic (dQ, dK, dV, D-term) via explicit dS rows, where D-term =
    rowsum(dO * O) [B, Hq, R]. GQA: dK/dV are summed over each kv head's
    query group."""
    work = torch.float64 if q.dtype == torch.float64 else torch.float32
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    hq, hkv = q.shape[1], k.shape[1]
    kx = _expand_kv(k, hq).to(work)
    vx = _expand_kv(v, hq).to(work)
    qf, dof = q.to(work), d_o.to(work)

    s = torch.einsum("bhrd,bhcd->bhrc", qf, kx) * scale
    cap_grad = None
    if logit_soft_cap is not None:
        t = torch.tanh(s / logit_soft_cap)
        s = logit_soft_cap * t
        cap_grad = 1.0 - t * t
    mask = _visible(s.shape[-2], s.shape[-1], causal, sliding_window,
                    s.device)
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(s - m)
    p = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-37)
    o = torch.einsum("bhrc,bhcd->bhrd", p, vx)

    d_term = (dof * o).sum(dim=-1)
    dp = torch.einsum("bhrd,bhcd->bhrc", dof, vx)
    ds = p * (dp - d_term[..., None])
    if cap_grad is not None:
        ds = ds * cap_grad
    ds = ds * scale

    dq = torch.einsum("bhrc,bhcd->bhrd", ds, kx)
    dk = torch.einsum("bhrc,bhrd->bhcd", ds, qf)
    dv = torch.einsum("bhrc,bhrd->bhcd", p, dof)
    if hkv != hq:
        b, group = q.shape[0], hq // hkv
        dk = dk.reshape(b, hkv, group, *dk.shape[2:]).sum(dim=2)
        dv = dv.reshape(b, hkv, group, *dv.shape[2:]).sum(dim=2)
    return dq, dk, dv, d_term


def phi_loss(q, k, v, d_o, **kw):
    """Phi = sum(dO * O): its gradient with respect to (q, k, v) is what
    the backward kernels compute for the cotangent dO."""
    o, _ = attention_reference(q, k, v, **kw)
    return (d_o.to(o.dtype) * o).sum()
