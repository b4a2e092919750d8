"""Paged KV cache: page-granular memory for serving.

Port of ``mfa_tpu/serving/paged_kv_cache.py``. Sequences own pages of
``page_size`` tokens from a shared pool through a per-sequence page table,
so memory is allocated by actual length, not by the worst-case max_len,
and a finished sequence's pages return to the pool at once. The
allocator (free list, tables, lengths) lives on the host, in numpy; the
pool lives on the device. The decode kernel reads pages through the
tables (``kernels/paged_decode.py``).

Layout (no head-dim padding, and no singleton lane axis on the scales):
  k_pages, v_pages : [num_pages, Hkv, page, D]  storage dtype
  k_scale, v_scale : [num_pages, Hkv, page] fp32 (ones when unquantized)
  page_tables      : [num_seqs, max_pages] int32, host numpy; 0 = the
                     null page
  lengths          : [num_seqs] int32, host numpy

Unlike the JAX version, writes go into the pool IN PLACE. Quantization
uses the port's one quantizer (``kernels/quant.py``: scale = amax *
fp32(1/qmax), the form ``mfa_tpu`` computes under ``jax.jit``), also in
``append``, where ``mfa_tpu`` quantizes eagerly (amax / qmax, which can
differ by one ulp in the scale).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mfa_tpu_torch.kernels import quant
from mfa_tpu_torch.ops.precision import OperandPrecision
from mfa_tpu_torch.utils.device import resolve_device

# Default page granularity, kept from mfa_tpu, where 128 rows is the TPU's
# lane quantum; PagedKVCache keeps its page_size % 128 rule for parity.
PAGE_SIZE = 128


@dataclass
class PagePool:
    k_pages: torch.Tensor      # [num_pages, Hkv, page, D] storage dtype
    v_pages: torch.Tensor
    k_scale: torch.Tensor      # [num_pages, Hkv, page] fp32
    v_scale: torch.Tensor
    precision: OperandPrecision

    @classmethod
    def create(cls, num_pages: int, num_kv_heads: int, head_dim: int,
               page_size: int,
               precision: OperandPrecision = OperandPrecision.BF16, *,
               device="cuda") -> "PagePool":
        """A zero-filled pool (scales ones) on ``device``."""
        if precision is OperandPrecision.INT4:
            raise ValueError("INT4 is not a KV-cache format")
        dev = resolve_device(device)
        shape = (num_pages, num_kv_heads, page_size, head_dim)
        return cls(
            k_pages=torch.zeros(shape, dtype=precision.dtype, device=dev),
            v_pages=torch.zeros(shape, dtype=precision.dtype, device=dev),
            k_scale=torch.ones(shape[:3], dtype=torch.float32, device=dev),
            v_scale=torch.ones(shape[:3], dtype=torch.float32, device=dev),
            precision=precision)

    @property
    def num_pages(self) -> int:
        return self.k_pages.shape[0]

    @property
    def num_kv_heads(self) -> int:
        return self.k_pages.shape[1]

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[2]

    @property
    def head_dim(self) -> int:
        return self.k_pages.shape[3]


class PagedKVCache:
    """Host-side manager: the pool on the device, the free list, page
    tables and lengths on the host."""

    def __init__(self, num_pages: int, num_kv_heads: int, head_dim: int,
                 num_seqs: int, max_len: int,
                 precision: OperandPrecision = OperandPrecision.BF16,
                 page_size: int = PAGE_SIZE, *, device="cuda"):
        if page_size % 128 != 0:
            raise ValueError(f"page_size must be a multiple of 128 "
                             f"(got {page_size})")
        self.page_size = page_size
        self.device = resolve_device(device)
        self.pool = PagePool.create(num_pages, num_kv_heads, head_dim,
                                    page_size, precision, device=self.device)
        self.max_pages = -(-max_len // page_size)
        # Page 0 is the null page: tables point at it for unallocated
        # entries, and kernels read it only for slots of length 0 that a
        # batched step writes into it.
        self._free = list(range(num_pages - 1, 0, -1))
        self.page_tables = np.zeros((num_seqs, self.max_pages), np.int32)
        self.lengths = np.zeros((num_seqs,), np.int32)

    # -- allocation -------------------------------------------------------

    def pages_in_use(self, seq: int) -> int:
        ps = self.page_size
        return (int(self.lengths[seq]) + ps - 1) // ps

    def _ensure_capacity(self, seq: int, new_len: int):
        ps = self.page_size
        need = (new_len + ps - 1) // ps
        if need > self.max_pages:
            raise ValueError(f"sequence {seq} exceeds max_len "
                             f"({new_len} > {self.max_pages * ps})")
        for i in range(self.pages_in_use(seq), need):
            if not self._free:
                raise MemoryError("page pool exhausted")
            self.page_tables[seq, i] = self._free.pop()

    def free_seq(self, seq: int):
        for i in range(self.pages_in_use(seq)):
            page = int(self.page_tables[seq, i])
            if page != 0:
                self._free.append(page)
        self.page_tables[seq, :] = 0
        self.lengths[seq] = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    # -- writes -----------------------------------------------------------

    def append(self, seq: int, k_new, v_new):
        """Append T tokens to one sequence, split at page boundaries.
        k_new, v_new: [Hkv, T, D]."""
        t = k_new.shape[1]
        start = int(self.lengths[seq])
        self._ensure_capacity(seq, start + t)
        pool = self.pool
        kq, ks = quant.quantize_for(pool.k_pages.dtype, k_new)
        vq, vs = quant.quantize_for(pool.k_pages.dtype, v_new)
        ps = self.page_size
        off = 0
        while off < t:
            pos = start + off
            page = int(self.page_tables[seq, pos // ps])
            at = pos % ps
            n = min(ps - at, t - off)
            for buf, new in ((pool.k_pages, kq), (pool.v_pages, vq),
                             (pool.k_scale, ks), (pool.v_scale, vs)):
                buf[page, :, at:at + n] = new[:, off:off + n]
            off += n
        self.lengths[seq] = start + t

    def splice_prefill(self, seq: int, k_new, v_new):
        """Prefill write for a fresh sequence (length 0): allocate its pages
        and write the whole prompt with one indexed write per pool tensor.
        k_new, v_new: [Hkv, T, D]."""
        if int(self.lengths[seq]) != 0:
            raise ValueError("splice_prefill needs a fresh sequence")
        t = k_new.shape[1]
        self._ensure_capacity(seq, t)
        n_pages = -(-t // self.page_size)
        ids = torch.as_tensor(self.page_tables[seq, :n_pages],
                              dtype=torch.long, device=self.device)
        pad = n_pages * self.page_size - t
        splice_pages(self.pool, ids,
                     torch.nn.functional.pad(k_new, (0, 0, 0, pad)),
                     torch.nn.functional.pad(v_new, (0, 0, 0, pad)))
        self.lengths[seq] = t

    # -- device views -----------------------------------------------------

    def device_tables(self):
        """(page tables [num_seqs, max_pages], lengths [num_seqs]), int32
        copies on the pool's device."""
        return (torch.tensor(self.page_tables, device=self.device),
                torch.tensor(self.lengths, device=self.device))


def splice_pages(pool: PagePool, page_ids, k_new, v_new) -> PagePool:
    """Bulk page write, in place: quantize page-aligned K/V and write it
    into the pool.

    page_ids: [n] int64, the destination pages in token order from
    position 0. k_new, v_new: [Hkv, n * page, D], tail-padded to a page
    boundary (the last page's tail takes the padding; reads are masked by
    the sequence length, and decode appends overwrite those rows).
    """
    ps = pool.page_size
    for pages, scales, x in ((pool.k_pages, pool.k_scale, k_new),
                             (pool.v_pages, pool.v_scale, v_new)):
        xq, xs = quant.quantize_for(pages.dtype, x)
        hkv, tp = xs.shape
        pages[page_ids] = xq.reshape(hkv, tp // ps, ps, -1).transpose(0, 1)
        scales[page_ids] = xs.reshape(hkv, tp // ps, ps).transpose(0, 1)
    return pool
