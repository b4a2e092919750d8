"""KV cache: contiguous per-sequence cache with optional INT8/FP8 storage.

Port of ``mfa_tpu/serving/kv_cache.py``. Layout [batch, num_kv_heads,
max_len, head_dim] with no padding of the head dim, per-token scales as
[batch, num_kv_heads, max_len] fp32 (ones when unquantized), lengths [B]
int32. Quantization happens per appended token over the head dim.

Unlike the JAX version, the cache is updated IN PLACE: ``update``,
``write_slot``, ``reset_slot`` and the fused decode kernel write into the
existing tensors (``lengths`` is replaced by a new tensor on append, so a
view of the old lengths taken as positions stays valid).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from mfa_tpu_torch.kernels import quant
from mfa_tpu_torch.ops.precision import OperandPrecision
from mfa_tpu_torch.utils.device import resolve_device


@dataclass
class KVCache:
    k: torch.Tensor          # [B, Hkv, max_len, D] storage dtype
    v: torch.Tensor
    k_scale: torch.Tensor    # [B, Hkv, max_len] fp32
    v_scale: torch.Tensor
    lengths: torch.Tensor    # [B] int32 — tokens currently in the cache
    precision: OperandPrecision

    def dequant(self):
        """(k, v) as fp32 [B, Hkv, max_len, D] — test/oracle helper."""
        return (self.k.float() * self.k_scale[..., None],
                self.v.float() * self.v_scale[..., None])

    @property
    def batch(self) -> int:
        return self.k.shape[0]

    @property
    def num_kv_heads(self) -> int:
        return self.k.shape[1]

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def head_dim(self) -> int:
        return self.k.shape[3]

    @property
    def quantized(self) -> bool:
        return self.precision.is_quantized


def create(batch: int, num_kv_heads: int, max_len: int, head_dim: int,
           precision: OperandPrecision = OperandPrecision.BF16, *,
           device="cuda") -> KVCache:
    """An empty cache on ``device``. Storage is zero-filled so rows past a
    length never hold non-finite values."""
    if precision is OperandPrecision.INT4:
        raise ValueError("INT4 is not a KV-cache format")
    dev = resolve_device(device)
    shape = (batch, num_kv_heads, max_len, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=precision.dtype, device=dev),
        v=torch.zeros(shape, dtype=precision.dtype, device=dev),
        k_scale=torch.ones(shape[:3], dtype=torch.float32, device=dev),
        v_scale=torch.ones(shape[:3], dtype=torch.float32, device=dev),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=dev),
        precision=precision,
    )


def update(cache: KVCache, k_new: torch.Tensor,
           v_new: torch.Tensor) -> KVCache:
    """Append T tokens per sequence at each sequence's current length, in
    place. k_new, v_new: [B, Hkv, T, D]. As with the JAX version's
    dynamic_update_slice, a start past max_len - T is clamped."""
    b, hkv, t, _ = k_new.shape
    kq, ks = quant.quantize_for(cache.k.dtype, k_new)
    vq, vs = quant.quantize_for(cache.k.dtype, v_new)
    dev = cache.k.device
    start = cache.lengths.long().clamp(0, cache.max_len - t)
    bi = torch.arange(b, device=dev)[:, None, None]
    hi = torch.arange(hkv, device=dev)[None, :, None]
    pos = (start[:, None] + torch.arange(t, device=dev)[None, :])[:, None, :]
    cache.k[bi, hi, pos] = kq
    cache.v[bi, hi, pos] = vq
    cache.k_scale[bi, hi, pos] = ks
    cache.v_scale[bi, hi, pos] = vs
    cache.lengths = cache.lengths + t
    return cache


def write_slot(cache: KVCache, slot: int, src: KVCache,
               true_len: int) -> KVCache:
    """Splice batch-1 cache ``src`` into ``slot`` in place, setting the
    slot's length to ``true_len`` (drops any padded tail the prefill
    appended). Continuous-batching admission path."""
    cache.k[slot].copy_(src.k[0])
    cache.v[slot].copy_(src.v[0])
    cache.k_scale[slot].copy_(src.k_scale[0])
    cache.v_scale[slot].copy_(src.v_scale[0])
    cache.lengths[slot] = true_len
    return cache


def reset_slot(cache: KVCache, slot: int) -> KVCache:
    """Free a slot in place (length 0; its data is dead past the length)."""
    cache.lengths[slot] = 0
    return cache
