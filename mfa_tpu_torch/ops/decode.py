"""Public decode-attention API over a KV cache.

Port of ``decode_attention_append`` from ``mfa_tpu/ops/decode.py``: the
decode hot path, one new token per sequence attending over its cache
while the same kernel (K2, ``kernels/decode.py``) appends that token's
K/V row. The port always fuses: a GPU CTA streams the cache in tiles, so
there is no single-block VMEM budget and no fallback to ``update()`` plus
an unfused decode.
"""

from __future__ import annotations

import math

import torch

from mfa_tpu_torch.kernels import decode as decode_kernel
from mfa_tpu_torch.kernels.flash_fwd import LOG2E
from mfa_tpu_torch.serving.kv_cache import KVCache
from mfa_tpu_torch.utils.device import check_on, resolve_device


def decode_attention_append(q, k_new, v_new, cache: KVCache, *,
                            scale: float | None = None,
                            sliding_window: int | None = None,
                            device="cuda"):
    """Fused append + attend.

    q: [B, Hq, D] (the new token's queries, roped); k_new, v_new:
    [B, Hkv, D] (k roped). Writes the new K/V row into ``cache`` at each
    sequence's length (in place) and returns (O [B, Hq, D] in q's dtype,
    cache). The new token's column is computed from the unquantized
    k_new/v_new. Lengths advance by one and stay capped at max_len: a full
    slot keeps attending over its whole cache and writes nothing.
    """
    dev = resolve_device(device)
    check_on(dev, q=q, k_new=k_new, v_new=v_new, cache=cache.k)
    b, hq, d = q.shape
    hkv = cache.num_kv_heads
    if hq % hkv != 0:
        raise ValueError(f"num_q_heads ({hq}) must be a multiple of "
                         f"num_kv_heads ({hkv})")
    if cache.head_dim != d or k_new.shape != (b, hkv, d) \
            or v_new.shape != k_new.shape:
        raise ValueError("q, k_new, v_new and the cache disagree on shape")
    group = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    bh, max_len = b * hkv, cache.max_len

    # Pre-scale with scale*log2e and round to q's dtype (exp2 domain).
    qs = (q.float() * (scale * LOG2E)).to(q.dtype)
    o = decode_kernel.decode_fused_append(
        qs.reshape(bh, group, d).contiguous(),
        cache.k.view(bh, max_len, d), cache.v.view(bh, max_len, d),
        cache.k_scale.view(bh, max_len), cache.v_scale.view(bh, max_len),
        k_new.to(q.dtype).reshape(bh, d).contiguous(),
        v_new.to(q.dtype).reshape(bh, d).contiguous(),
        cache.lengths, num_kv_heads=hkv, sliding_window=sliding_window)
    cache.lengths = torch.clamp(cache.lengths + 1, max=max_len)
    return o.reshape(b, hq, d), cache
