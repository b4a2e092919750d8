"""Paged decode attention: the Hopper kernel K6 and its plain version.

Replaces ``mfa_tpu/kernels/paged_decode.py::_paged_decode_kernel``; the
CUDA source is ``csrc/paged_decode.cu``, over the body K5 uses for a
contiguous cache (``csrc/decode_split.cuh``), here reading each row
through the page table. Any head dim up to 512, on K5's paths (the
tensor-core pair for bf16 q at 64 <= D <= 512 over pages of any storage
type whose rows and pool share a copy granule of 4 bytes or more, FMA
otherwise), counted by path
in ``paged_decode.launches_by_path``.
:func:`paged_decode` launches the kernel for CUDA tensors and takes
:func:`paged_decode_plain` only for CPU tensors.

Operands (S sequences, G query rows per kv head):
  q        [S * Hkv, G, D]          pre-scaled by scale*log2e, bf16 or fp32
                                    ([S, Hkv * G, D] in the JAX layout)
  k_pages, v_pages [P, Hkv, page, D] storage (bf16, int8, fp8-e4m3 or
                                    fp8-e5m2)
  k_scale, v_scale [P, Hkv, page]   fp32 per-token scales
  tables   [S, max_pages] int32     page ids; entries past the live pages
                                    are 0, the null page
  lengths  [S] int32                tokens per sequence
Returns O [S * Hkv, G, D] in q's dtype. K6 rounds as K5 does
(:func:`mfa_tpu_torch.kernels.decode.attend_plain`).
"""

from __future__ import annotations

import collections

import torch

from mfa_tpu_torch.kernels import build
from mfa_tpu_torch.kernels import decode as decode_mod
from mfa_tpu_torch.ops import params as params_mod


def gather_rows(x, tables):
    """[P, Hkv, page, ...] pages → [S * Hkv, max_pages * page, ...] rows of
    each (sequence, kv head), in position order, through the tables."""
    s, max_pages = tables.shape
    _, hkv, ps = x.shape[:3]
    g = x[tables.long()]                       # [S, max_pages, Hkv, page, ...]
    g = g.transpose(1, 2)                      # [S, Hkv, max_pages, page, ...]
    return g.reshape(s * hkv, max_pages * ps, *x.shape[3:])


def paged_decode_plain(q3, k_pages, v_pages, k_scale, v_scale, tables,
                       lengths, *, sliding_window: int | None = None):
    """Plain PyTorch version of K6: gather the pages through the tables,
    then K5's arithmetic."""
    hkv, ps = k_pages.shape[1:3]
    live = decode_mod.live_rows(lengths, tables.shape[1] * ps, hkv,
                                sliding_window)
    return decode_mod.attend_plain(
        q3, gather_rows(k_pages, tables), gather_rows(v_pages, tables),
        gather_rows(k_scale, tables), gather_rows(v_scale, tables), live)


def _check(q3, k_pages, v_pages, k_scale, v_scale, tables, lengths):
    n, g, d = q3.shape
    if k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError("k/v pages must be [num_pages, Hkv, page, D]")
    p, hkv, ps, dk = k_pages.shape
    if dk != d:
        raise ValueError(f"pages' head dim {dk} does not match q's {d}")
    if k_scale.shape != (p, hkv, ps) or v_scale.shape != k_scale.shape:
        raise ValueError("scales must be [num_pages, Hkv, page]")
    if tables.dim() != 2 or lengths.shape != (tables.shape[0],):
        raise ValueError("tables must be [S, max_pages], lengths [S]")
    if n != tables.shape[0] * hkv:
        raise ValueError(f"q has {n} rows of query groups; the tables give "
                         f"{tables.shape[0]} sequences x {hkv} kv heads")
    if tables.dtype != torch.int32:
        raise TypeError("tables must be int32")
    decode_mod.check_types(q3, k_pages, v_pages, k_scale, v_scale, lengths)


def paged_decode(q3, k_pages, v_pages, k_scale, v_scale, tables, lengths,
                 *, sliding_window: int | None = None, out=None):
    """K6: launches the CUDA kernel for CUDA tensors (or raises); takes the
    plain version for CPU tensors. Returns O, in ``out`` when given."""
    _check(q3, k_pages, v_pages, k_scale, v_scale, tables, lengths)
    decode_mod.check_window(sliding_window)
    if q3.device.type == "cpu":
        o = paged_decode_plain(q3, k_pages, v_pages, k_scale, v_scale,
                               tables, lengths,
                               sliding_window=sliding_window)
        return o if out is None else out.copy_(o)
    decode_mod.check_launch("paged_decode", q3, k_pages, v_pages,
                            k_scale=k_scale, v_scale=v_scale, tables=tables,
                            lengths=lengths)
    path = decode_mod.launch_path("paged_decode", q3, k_pages, v_pages)
    n, g, d = q3.shape
    hkv, ps = k_pages.shape[1:3]
    max_pages = tables.shape[1]
    o = decode_mod.output_like(q3, out)
    # K5's split of a contiguous cache of the same capacity.
    rows, chunk, workspace = decode_mod.split_launch(n, g, max_pages * ps,
                                                     d, q3.device)
    build.library().call(
        "mfa_paged_decode", q3.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        tables.data_ptr(), lengths.data_ptr(), o.data_ptr(),
        workspace.data_ptr(), n, hkv, g, max_pages, ps, d,
        sliding_window or 0, int(q3.dtype == torch.bfloat16),
        decode_mod.KV_FORMATS[k_pages.dtype], rows, chunk,
        params_mod.decode_threads(d, chunk, path),
        params_mod.DECODE_PATHS[path],
        torch.cuda.current_stream(q3.device).cuda_stream)
    paged_decode.launches += 1
    _PATHS[path] += 1
    return o


# Launches, and launches by path (decode.launch_path's labels), which stay
# with the kernel whatever stands in for the function.
paged_decode.launches = 0
paged_decode.launches_by_path = _PATHS = collections.Counter()
