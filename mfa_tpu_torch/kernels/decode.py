"""Decode attention kernels over a contiguous KV cache, each beside its
plain version: K2, fused decode + append, and K5, unfused decode.

K2 replaces ``mfa_tpu/kernels/decode.py::_decode_fused_kernel`` (CUDA
source ``csrc/decode.cu``); K5 replaces ``_decode_kernel_single`` and
``_decode_kernel`` (``csrc/decode_attend.cu``). All three (and the paged
kernel K6 in ``kernels/paged_decode.py``) share one split-KV body,
``csrc/decode_split.cuh``, and one launch shape (:func:`split_launch`).
All three take any head dim 1 <= D <= 512 over an unpadded cache (D
values a row: 200 bytes at D 100 in bf16, 100 in int8 and fp8). bf16 q
at 64 <= D <= 512 over any of the four storage types runs on tensor
cores where the cache's rows and bases share a copy granule of 4 bytes
or more (``ops/params.py::decode_granule``: 16 at D 80, 96, 112, 192,
256, 384 and 512 in bf16, 8 at D 100 and 300, 4 at D 100 and 300 in
int8 and fp8 and at D 250 in bf16; 1-byte storage widened to bf16, K2's
int8 requantization exact), its rows padded with zeros to 128 values in
shared memory past D 64 and 128, to 256 past D 128 and to 512 past D
256; every other case (fp32 q, odd D, granules under 4, D < 64) runs on
FMA in ``decode_split.cuh::RowLayout``'s rows, which copy a 16-byte
aligned cache in 16-byte granules whatever a row's alignment
(``ops/params.py::decode_row_layout`` mirrors it). Each wrapper counts
its launches by path (``launches_by_path``: ``mma/g16``, ``mma/g8``,
``mma/g4``, ``fma``, ``fma/exact``; :func:`launch_path`), and the C
launch refuses a launch whose path it would choose otherwise. A CTA
has ``ops/params.py::decode_threads`` threads (128 on the 256- and
512-wide tensor-core pair and at D <= 8 with query chunks of 8, 256
otherwise).
:func:`decode_fused_append` and :func:`decode_attend` launch their
kernels for CUDA tensors and take their plain versions only for CPU
tensors.

Operands (BH = batch * kv heads, G query rows per kv head):
  q        [BH, G, D]   pre-scaled by scale*log2e, bf16 or fp32
  k, v     [BH, L, D]   cache storage (bf16, int8, fp8-e4m3 or fp8-e5m2);
                        K2 updates them in place
  k_scale, v_scale [BH, L] fp32 per-token scales (K2: updated in place)
  k_new, v_new [BH, D]  K2 only: the step's new K (roped) and V, q's dtype
  lengths  [B] int32    K2: pre-append lengths; K5: the live rows
Both return O [BH, G, D] in q's dtype. K2 writes the new row to row
lengths[b] unless that slot is full (lengths[b] == L).
"""

from __future__ import annotations

import collections

import torch

from mfa_tpu_torch.kernels import build, quant
from mfa_tpu_torch.kernels.flash_fwd import MASK_VALUE
from mfa_tpu_torch.ops import params as params_mod

INT8_MAX = quant.INT8_MAX
# Cache storage types the kernel takes, with its format codes.
KV_FORMATS = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 2,
              torch.float8_e5m2: 3}
# Storage types whose per-token scales multiply S and P.
QUANTIZED = (torch.int8, torch.float8_e4m3fn, torch.float8_e5m2)


def decode_fused_append_plain(q3, k, v, k_scale, v_scale, k_new, v_new,
                              lengths, *, num_kv_heads: int,
                              sliding_window: int | None = None):
    """Plain PyTorch version of K2, same rounding points: int8 caches
    requantize q and P per row to s8 (integer-valued fp32 products, exact
    below 2^24); other caches multiply P by the V scale and round it to
    q's type before PV."""
    bh, _, d = q3.shape
    L = k.shape[1]
    quantized = k.dtype in QUANTIZED
    lens = lengths.long().clamp(0, L).repeat_interleave(num_kv_heads)
    col = torch.arange(L, device=q3.device)[None, :]
    live = col < lens[:, None]
    if sliding_window is not None:
        live &= col >= (lens + 1 - sliding_window).clamp_min(0)[:, None]
    live = live[:, None, :]                                  # [BH, 1, L]

    qf = q3.float()
    kn = k_new.float()
    vn = v_new.float()
    s_new = torch.bmm(qf, kn[:, :, None])                    # [BH, G, 1]
    ks = k_scale[:, None, :]
    vs = v_scale[:, None, :]
    int8 = k.dtype == torch.int8
    inv127 = quant.recip(INT8_MAX).to(q3.device)
    if int8:
        qscale = qf.abs().amax(-1, keepdim=True).clamp_min(1e-30) * inv127
        q_s8 = torch.round(qf / qscale).clamp(-INT8_MAX, INT8_MAX)
        s = torch.bmm(q_s8, k.float().transpose(1, 2)) * qscale * ks
    else:
        s = torch.bmm(qf, k.float().transpose(1, 2))
        if quantized:
            s = s * ks
    s = torch.where(live, s, torch.full_like(s, MASK_VALUE))
    m = torch.maximum(s.amax(-1, keepdim=True), s_new)
    p = torch.exp2(s - m)
    p_new = torch.exp2(s_new - m)
    l = (p.sum(-1, keepdim=True) + p_new).clamp_min(1e-37)
    if int8:
        pv = p * vs
        pscale = pv.abs().amax(-1, keepdim=True).clamp_min(1e-30) * inv127
        p_s8 = torch.round(pv / pscale).clamp(-INT8_MAX, INT8_MAX)
        o = (torch.bmm(p_s8, v.float()) * pscale + p_new * vn[:, None, :]) / l
    else:
        if quantized:
            p = p * vs
        p = p.to(q3.dtype).float()
        o = (torch.bmm(p, v.float()) + p_new * vn[:, None, :]) / l

    # Append at each sequence's length; a full slot keeps its contents.
    rows = torch.nonzero(lens < L).flatten()
    if rows.numel():
        at = lens[rows]
        for cache, scales, x in ((k, k_scale, kn), (v, v_scale, vn)):
            xq, xs = quant.quantize_for(cache.dtype, x[rows])
            cache[rows, at] = xq
            scales[rows, at] = xs
    return o.to(q3.dtype)


def check_types(q3, k, v, k_scale, v_scale, lengths) -> None:
    """The operand types K2, K5 and K6 share."""
    if q3.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bf16 or fp32, not {q3.dtype}")
    if v.dtype != k.dtype:
        raise TypeError("k and v caches must share one dtype")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError("scales must be fp32")
    if lengths.dtype != torch.int32:
        raise TypeError("lengths must be int32")


def check_launch(name: str, q3, k, v, **others) -> None:
    """What a launch needs beyond the operands' shapes and types: one CUDA
    device, contiguous tensors, and a storage type and head dim (any D up
    to 512) the kernels take. (Cache alignment: :func:`launch_path`.)"""
    if not q3.is_cuda:
        raise ValueError(f"{name}: unsupported device {q3.device}")
    for tname, t in dict(q=q3, k=k, v=v, **others).items():
        if t.device != q3.device:
            raise ValueError(f"{tname} is on {t.device}, q on {q3.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
    if k.dtype not in KV_FORMATS:
        raise TypeError(f"cache storage {k.dtype} not taken by the kernel "
                        f"(takes {list(KV_FORMATS)})")
    d, most = q3.shape[-1], params_mod.DECODE_MAX_HEAD_DIM
    if not 1 <= d <= most:
        raise ValueError(
            f"head dim {d}: the kernel takes 1 <= D <= {most} (a row of "
            f"{d * k.element_size()} bytes is {-(-d // 8)} chunks of 8 "
            f"values; a warp's 32 lanes take at most two chunks each, "
            f"{most * k.element_size()} bytes a row)")


def launch_path(name: str, q3, k, v) -> str:
    """The path a launch takes (``ops/params.py::decode_path``, the key of
    DECODE_PATHS the C launch is handed): the tensor-core pair at the copy
    granule that the rows and the bases of k and v share, else FMA, which
    needs 16-byte aligned cache storage (its rows need not be: it copies
    16-byte granules of it)."""
    d = q3.shape[-1]
    granule = params_mod.decode_granule(d, k.element_size(), k.data_ptr(),
                                        v.data_ptr())
    path = params_mod.decode_path(d, k.dtype, q3.dtype == torch.bfloat16,
                                  granule)
    if path.startswith("fma") and any(t.data_ptr() % 16 for t in (k, v)):
        raise ValueError(f"{name}: cache storage must be 16-byte aligned "
                         f"on the FMA path ({path})")
    return path


def output_like(q3, out):
    """O's buffer: ``out`` when given (contiguous, q's shape and dtype, on
    q's device), else a new empty tensor."""
    if out is None:
        return torch.empty_like(q3)
    if (out.shape != q3.shape or out.dtype != q3.dtype
            or out.device != q3.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {q3.dtype} "
                         f"{tuple(q3.shape)} tensor on {q3.device}")
    return out


def _check(q3, k, v, k_scale, v_scale, k_new, v_new, lengths, hkv):
    bh, g, d = q3.shape
    L = k.shape[1]
    if k.shape != (bh, L, d) or v.shape != k.shape:
        raise ValueError(f"cache shape {tuple(k.shape)} does not match q "
                         f"{tuple(q3.shape)}")
    if k_scale.shape != (bh, L) or v_scale.shape != (bh, L):
        raise ValueError("scales must be [BH, max_len]")
    if k_new is not None and (k_new.shape != (bh, d)
                              or v_new.shape != (bh, d)):
        raise ValueError("k_new/v_new must be [BH, D]")
    if lengths.shape != (bh // hkv,) or bh % hkv:
        raise ValueError("lengths must be [batch]")
    check_types(q3, k, v, k_scale, v_scale, lengths)
    if k_new is not None and (k_new.dtype != q3.dtype
                              or v_new.dtype != q3.dtype):
        raise TypeError("k_new/v_new must have q's dtype")


def check_window(sliding_window) -> None:
    if sliding_window is not None and sliding_window < 1:
        raise ValueError("sliding_window must be >= 1")


def decode_fused_append(q3, k, v, k_scale, v_scale, k_new, v_new, lengths,
                        *, num_kv_heads: int,
                        sliding_window: int | None = None, out=None):
    """K2: launches the CUDA kernel for CUDA tensors (or raises); takes the
    plain version for CPU tensors. Returns O, in ``out`` when given; the
    cache is updated in place."""
    _check(q3, k, v, k_scale, v_scale, k_new, v_new, lengths, num_kv_heads)
    check_window(sliding_window)
    if q3.device.type == "cpu":
        o = decode_fused_append_plain(
            q3, k, v, k_scale, v_scale, k_new, v_new, lengths,
            num_kv_heads=num_kv_heads, sliding_window=sliding_window)
        return o if out is None else out.copy_(o)
    check_launch("decode_fused_append", q3, k, v, k_scale=k_scale,
                 v_scale=v_scale, k_new=k_new, v_new=v_new, lengths=lengths)
    path = launch_path("decode_fused_append", q3, k, v)
    bh, g, d = q3.shape
    L = k.shape[1]
    o = output_like(q3, out)
    rows, chunk, workspace = split_launch(bh, g, L, d, q3.device, fused=True)
    build.library().call(
        "mfa_decode_fused_append", q3.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), lengths.data_ptr(), o.data_ptr(),
        workspace.data_ptr(), bh, num_kv_heads, g, L, d,
        sliding_window or 0, int(q3.dtype == torch.bfloat16),
        KV_FORMATS[k.dtype], rows, chunk,
        params_mod.decode_threads(d, chunk, path),
        params_mod.DECODE_PATHS[path],
        torch.cuda.current_stream(q3.device).cuda_stream)
    decode_fused_append.launches += 1
    _FUSED_PATHS[path] += 1
    return o


# Launches, and launches by path (launch_path's labels). The path counts
# stay with the kernel whatever stands in for the function (as
# flash_fwd.launches_by_row).
decode_fused_append.launches = 0
decode_fused_append.launches_by_path = _FUSED_PATHS = collections.Counter()


# ---------------------------------------------------------------------------
# K5: unfused decode (K6, the paged kernel, shares its plain arithmetic)
# ---------------------------------------------------------------------------


def live_rows(lengths, capacity: int, num_kv_heads: int,
              sliding_window: int | None = None) -> torch.Tensor:
    """[B * Hkv, capacity] bool: positions [max(len - W, 0), len) of each
    (sequence, kv head), lengths clamped to [0, capacity]."""
    lens = lengths.long().clamp(0, capacity).repeat_interleave(num_kv_heads)
    col = torch.arange(capacity, device=lengths.device)[None, :]
    live = col < lens[:, None]
    if sliding_window is not None:
        live &= col >= (lens - sliding_window).clamp_min(0)[:, None]
    return live


def attend_plain(q3, k, v, k_scale, v_scale, live):
    """S, P and O of one-token decode over cache rows, by K5's and K6's
    rounding rule: S = (q . K_raw) * ks (quantized storage), the
    large-finite sentinel where not live; P = exp2(S - max S); P * vs
    rounded to q's type before P V; O = P V / sum(P), and 0 for a row with
    no live key. Rows that are not live never reach the sums, whatever
    they hold.

    q3 [N, G, D] pre-scaled; k, v [N, L, D] storage; k_scale, v_scale
    [N, L] fp32; live [N, L] bool. Returns O [N, G, D] in q's dtype."""
    quantized = k.dtype in QUANTIZED
    rows = live[:, :, None]
    kf = torch.where(rows, k.float(), 0.0)
    vf = torch.where(rows, v.float(), 0.0)
    cols = live[:, None, :]
    s = torch.bmm(q3.float(), kf.transpose(1, 2))
    if quantized:
        s = s * torch.where(live, k_scale, 0.0)[:, None, :]
    s = torch.where(cols, s, MASK_VALUE)
    m = s.amax(-1, keepdim=True)
    p = torch.where(cols, torch.exp2(s - m), 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-37)
    if quantized:
        p = p * torch.where(live, v_scale, 0.0)[:, None, :]
    p = p.to(q3.dtype).float()
    o = torch.bmm(p, vf) / l
    o = torch.where(m == MASK_VALUE, 0.0, o)
    return o.to(q3.dtype)


def decode_attend_plain(q3, k, v, k_scale, v_scale, lengths, *,
                        num_kv_heads: int,
                        sliding_window: int | None = None):
    """Plain PyTorch version of K5."""
    live = live_rows(lengths, k.shape[1], num_kv_heads, sliding_window)
    return attend_plain(q3, k, v, k_scale, v_scale, live)


def split_launch(n: int, group: int, capacity: int, head_dim: int,
                 device: torch.device, *, fused: bool = False):
    """The split-KV launch shape K2, K5 and K6 share, from the shapes
    alone: (split rows R, query rows a CTA, workspace). The fp32 workspace
    holds the scores [n, chunks, capacity, query rows a CTA], each split's
    row max and row sum [n, group, S] and partial O [n, group, S, D]
    (S = ceil(capacity / R)), the kernel's arrival counters (zeroed by the
    kernel itself) and, ``fused`` (K2), each split's max |P vs| [n, group,
    S] (an int8 cache's P scale)."""
    rows = params_mod.decode_split_rows(n, group, capacity,
                                        params_mod.detect_device(device))
    chunk = params_mod.decode_group_chunk(group)
    splits = max(1, -(-capacity // rows))
    chunks = -(-group // chunk)
    workspace = torch.empty(
        n * chunks * (capacity * chunk + 1)
        + n * group * splits * (head_dim + 2 + int(fused)),
        dtype=torch.float32, device=device)
    return rows, chunk, workspace


def decode_attend(q3, k, v, k_scale, v_scale, lengths, *,
                  num_kv_heads: int, sliding_window: int | None = None,
                  out=None):
    """K5: launches the CUDA kernel for CUDA tensors (or raises); takes the
    plain version for CPU tensors. Returns O, in ``out`` when given."""
    _check(q3, k, v, k_scale, v_scale, None, None, lengths, num_kv_heads)
    check_window(sliding_window)
    if q3.device.type == "cpu":
        o = decode_attend_plain(q3, k, v, k_scale, v_scale, lengths,
                                num_kv_heads=num_kv_heads,
                                sliding_window=sliding_window)
        return o if out is None else out.copy_(o)
    check_launch("decode_attend", q3, k, v, k_scale=k_scale,
                 v_scale=v_scale, lengths=lengths)
    path = launch_path("decode_attend", q3, k, v)
    bh, g, d = q3.shape
    L = k.shape[1]
    o = output_like(q3, out)
    rows, chunk, workspace = split_launch(bh, g, L, d, q3.device)
    build.library().call(
        "mfa_decode_attend", q3.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), lengths.data_ptr(),
        o.data_ptr(), workspace.data_ptr(), bh, num_kv_heads, g, L, d,
        sliding_window or 0, int(q3.dtype == torch.bfloat16),
        KV_FORMATS[k.dtype], rows, chunk,
        params_mod.decode_threads(d, chunk, path),
        params_mod.DECODE_PATHS[path],
        torch.cuda.current_stream(q3.device).cuda_stream)
    decode_attend.launches += 1
    _ATTEND_PATHS[path] += 1
    return o


decode_attend.launches = 0
decode_attend.launches_by_path = _ATTEND_PATHS = collections.Counter()
