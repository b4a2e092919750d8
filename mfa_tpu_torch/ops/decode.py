"""Public decode-attention API over a KV cache.

Port of ``mfa_tpu/ops/decode.py``: one new token per sequence attends
over its cache.

- :func:`decode_attention_append`, the contiguous serving hot path: the
  fused kernel K2 (``kernels/decode.py``) appends the token's K/V row
  while it attends. The port always fuses: a GPU CTA streams the cache in
  tiles, so there is no single-block VMEM budget and no fallback to
  ``update()`` plus an unfused decode.
- :func:`decode_attention`, the unfused form over a contiguous cache
  (K5, ``kernels/decode.py``), with no head-dim padding and no KV block
  choice: the TPU's VMEM cap has no meaning on the card.
- :func:`paged_decode_attention` over a paged cache (K6,
  ``kernels/paged_decode.py``), what the paged scheduler runs.

The kernel functions are looked up in their modules at each call, so a
check can swap in their plain versions by assigning module attributes.
"""

from __future__ import annotations

import math

import torch

from mfa_tpu_torch.kernels import decode as decode_kernel
from mfa_tpu_torch.kernels import paged_decode as paged_kernel
from mfa_tpu_torch.kernels.flash_fwd import LOG2E
from mfa_tpu_torch.serving.kv_cache import KVCache
from mfa_tpu_torch.utils.device import check_on, resolve_device


def _group(hq: int, hkv: int) -> int:
    if hq % hkv != 0:
        raise ValueError(f"num_q_heads ({hq}) must be a multiple of "
                         f"num_kv_heads ({hkv})")
    return hq // hkv


def _prescale(q, scale: float | None):
    """q * scale * log2e, rounded to q's dtype (the exp2 domain)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return (q.float() * (scale * LOG2E)).to(q.dtype)


def decode_attention(q, cache: KVCache, *, scale: float | None = None,
                     sliding_window: int | None = None, device="cuda"):
    """One-token GQA attention against a contiguous cache.

    q: [B, Hq, D] (the new token's queries; Hq a multiple of the cache's
    kv heads). Rows past each sequence's ``cache.lengths`` are ignored; a
    window keeps the last ``sliding_window`` of them. Returns [B, Hq, D] in
    q's dtype; a sequence of length 0 gets zeros.
    """
    dev = resolve_device(device)
    check_on(dev, q=q, cache=cache.k)
    b, hq, d = q.shape
    hkv = cache.num_kv_heads
    group = _group(hq, hkv)
    if cache.head_dim != d:
        raise ValueError(f"q's head dim {d} does not match the cache's "
                         f"{cache.head_dim}")
    bh, max_len = b * hkv, cache.max_len
    o = decode_kernel.decode_attend(
        _prescale(q, scale).reshape(bh, group, d).contiguous(),
        cache.k.view(bh, max_len, d), cache.v.view(bh, max_len, d),
        cache.k_scale.view(bh, max_len), cache.v_scale.view(bh, max_len),
        cache.lengths, num_kv_heads=hkv, sliding_window=sliding_window)
    return o.reshape(b, hq, d)


def paged_decode_attention(q, cache, *, scale: float | None = None,
                           sliding_window: int | None = None, device="cuda"):
    """One-token GQA attention against a paged cache.

    q: [S, Hq, D]. ``cache`` is a ``PagedKVCache`` or anything with
    ``.pool``, ``.max_pages`` and ``device_tables()`` (the paged
    scheduler's per-layer view). Pages are read through the tables; rows
    past each sequence's length are ignored. Returns [S, Hq, D] in q's
    dtype.
    """
    dev = resolve_device(device)
    pool = cache.pool
    tables, lengths = cache.device_tables()
    check_on(dev, q=q, pool=pool.k_pages, tables=tables, lengths=lengths)
    s, hq, d = q.shape
    hkv = pool.num_kv_heads
    group = _group(hq, hkv)
    if tables.shape != (s, cache.max_pages):
        raise ValueError(f"tables {tuple(tables.shape)} do not match "
                         f"{s} sequences x {cache.max_pages} pages")
    # q head h attends kv head h // group, so [S, Hq, D] is already
    # [S * Hkv, G, D] row by row.
    o = paged_kernel.paged_decode(
        _prescale(q, scale).reshape(s * hkv, group, d).contiguous(),
        pool.k_pages, pool.v_pages, pool.k_scale, pool.v_scale, tables,
        lengths, sliding_window=sliding_window)
    return o.reshape(s, hq, d)


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
    group = _group(hq, hkv)
    if cache.head_dim != d or k_new.shape != (b, hkv, d) \
            or v_new.shape != k_new.shape:
        raise ValueError("q, k_new, v_new and the cache disagree on shape")
    bh, max_len = b * hkv, cache.max_len
    o = decode_kernel.decode_fused_append(
        _prescale(q, scale).reshape(bh, group, d).contiguous(),
        cache.k.view(bh, max_len, d), cache.v.view(bh, max_len, d),
        cache.k_scale.view(bh, max_len), cache.v_scale.view(bh, max_len),
        k_new.to(q.dtype).reshape(bh, d).contiguous(),
        v_new.to(q.dtype).reshape(bh, d).contiguous(),
        cache.lengths, num_kv_heads=hkv, sliding_window=sliding_window)
    cache.lengths = torch.clamp(cache.lengths + 1, max=max_len)
    return o.reshape(b, hq, d), cache
