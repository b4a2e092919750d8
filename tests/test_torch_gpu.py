"""The port's CUDA kernels against their plain versions on the card, at
shapes chip_smoke.py does not reach (odd lengths, every table row's head
dim, GQA groups 1-16, fp32 queries, windows, soft-cap, all four KV
storage types, shuffled page tables; GEMM transpose states, strided
slices and ragged edges; INT4 matmul layouts and ragged M/N), and a tiny
Llama on the card against the same on the CPU (forward, decode, both
schedulers, training steps, INT4 weights).

Needs a CUDA device; skips elsewhere. On the card (no JAX there, so
without the suite's conftest):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import copy
import dataclasses
import math
import threading

import numpy as np
import pytest
import torch

from mfa_tpu_torch.kernels import decode as k2
from mfa_tpu_torch.kernels import flash_bwd as k34
from mfa_tpu_torch.kernels import flash_fwd as k1
from mfa_tpu_torch.kernels import gemm_kernel as k7
from mfa_tpu_torch.kernels import paged_decode as k6
from mfa_tpu_torch.kernels import quant
from mfa_tpu_torch.kernels import quant_matmul as k8
from mfa_tpu_torch.models import llama, training
from mfa_tpu_torch.ops.descriptors import (
    AttentionDescriptor,
    AttentionKernelType,
    GEMMDescriptor,
    launch_row,
    row_label,
)
from mfa_tpu_torch.ops.gemm import gemm
from mfa_tpu_torch.ops.precision import OperandPrecision
from mfa_tpu_torch.serving import kv_cache
from mfa_tpu_torch.serving.paged_scheduler import PagedScheduler
from mfa_tpu_torch.serving.scheduler import ContinuousBatchingScheduler, Request
from mfa_tpu_torch.utils.testing import (
    KERNEL_BUDGETS,
    assert_close,
    assert_fully_written,
    garbage_pad,
    nan_canary,
    shifted_copy,
    shuffled_page_pool,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (dtype, D, R, C, Hq, Hkv, options, fp32 O)
K1_CASES = [
    ("bf16", 64, 300, 300, 4, 2, dict(causal=True), False),
    ("bf16", 256, 200, 333, 8, 2, dict(sliding_window=50,
                                       logit_soft_cap=30.0), False),
    ("bf16", 32, 150, 70, 4, 4, dict(causal=True), False),     # R > C
    ("bf16", 96, 129, 257, 6, 3, dict(), False),               # D padded
    ("bf16", 128, 128, 128, 8, 1, dict(causal=True), True),   # fp32 O
    ("fp32", 64, 100, 100, 4, 2, dict(causal=True), False),
    ("fp32", 256, 77, 130, 2, 1, dict(), False),
    ("fp32", 40, 65, 65, 4, 2, dict(sliding_window=9), False),
    # The wgmma rows (D 64 and 128): R not a multiple of 64, R > C (the
    # first R - C rows see no key), window edges, soft-cap, fp32 O, half
    # and less than half of a 128-row CTA.
    ("bf16", 128, 129, 129, 8, 2, dict(causal=True), False),
    ("bf16", 128, 333, 333, 4, 1, dict(causal=True, logit_soft_cap=30.0),
     False),
    ("bf16", 64, 333, 200, 4, 2, dict(causal=True), False),       # R > C
    ("bf16", 128, 150, 129, 4, 4, dict(causal=True), False),      # R > C
    ("bf16", 128, 300, 700, 8, 2, dict(sliding_window=100), False),
    ("bf16", 64, 129, 333, 4, 1, dict(sliding_window=64,
                                      logit_soft_cap=20.0), False),
    ("bf16", 128, 1000, 1000, 4, 2, dict(), True),               # fp32 O
    ("bf16", 64, 129, 129, 4, 2, dict(causal=True), True),       # fp32 O
    ("bf16", 128, 64, 64, 8, 2, dict(causal=True), False),
    ("bf16", 128, 16, 16, 2, 1, dict(causal=True), False),
    ("bf16", 36, 65, 77, 2, 1, dict(causal=True), False),  # no TMA rows
    # Rows TMA cannot map on the wgmma kernel's copying producer (D even,
    # up to 256): OpenLLaMA-3B's D 100 (200-byte rows, 8-byte granule),
    # MHA and GQA, causal and not, fp32 O; D 42 and 250 (4-byte granule),
    # R > C, window and soft-cap; D 162 on the 192-wide panel. Odd D keeps
    # the mma.sync row.
    ("bf16", 100, 300, 300, 4, 4, dict(causal=True), False),
    ("bf16", 100, 129, 257, 4, 2, dict(), False),
    ("bf16", 100, 1000, 1000, 2, 2, dict(causal=True), True),    # fp32 O
    ("bf16", 42, 150, 70, 4, 2, dict(causal=True), False),       # R > C
    ("bf16", 250, 200, 333, 4, 2, dict(sliding_window=50,
                                       logit_soft_cap=30.0), False),
    ("bf16", 162, 257, 257, 4, 1, dict(causal=True), False),
    ("bf16", 37, 65, 77, 2, 1, dict(causal=True), False),
]


def _k1_check(cuda, q, k, v, kd, kw, dt, o_dtype, want_kernel):
    """One K1 launch into NaN-prefilled outputs against its plain version:
    the row that ran (its kernel, and its producer where not TMA:
    row_label), every output written, O and L within budget."""
    hq, r, d = q.shape
    assert row_label(launch_row(kd, d, (q, k, v))) == want_kernel
    n, n_row = k1.flash_fwd.launches, k1.launches_by_row[want_kernel]
    o, lse = k1.flash_fwd(q, k, v, kd, **kw, out=(
        nan_canary((hq, r, d), o_dtype, device=cuda),
        nan_canary((hq, r), device=cuda)))
    torch.cuda.synchronize()
    assert k1.flash_fwd.launches == n + 1
    assert k1.launches_by_row[want_kernel] == n_row + 1
    assert_fully_written(o, "O")
    assert_fully_written(lse, "L")
    # No atomics and a fixed order of sums: a second launch gives the same
    # bits (a race in the tile ring would show here).
    o2, lse2 = k1.flash_fwd(q, k, v, kd, **kw)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    o_p, lse_p = k1.flash_fwd_plain(q, k, v, kd, **kw)
    assert o.dtype == o_dtype
    atol, rtol = KERNEL_BUDGETS[f"flash_fwd_o_{dt}"]
    assert_close(o, o_p, atol, "O", rtol=rtol)
    assert_close(lse, lse_p, KERNEL_BUDGETS["flash_fwd_l"][0], "L")


def _k1_kernel(dt, d):
    """The row a K1 (or K3, K4) launch of aligned operands runs up to D =
    256: wgmma for bf16 at D <= 128, one CTA of the head-dim-split kernel
    (wgmma_dblk) past it, by TMA at D % 8 == 0 and with the copying
    producer at other even D ("/copy"); the kept mma.sync kernel at odd
    D, the FMA kernel for fp32."""
    if dt == "fp32":
        return ""
    if d % 2:
        return "mma"
    kernel = "wgmma" if d <= 128 else "wgmma_dblk"
    return kernel if d % 8 == 0 else f"{kernel}/copy"


@pytest.mark.parametrize("case", K1_CASES,
                         ids=[f"k1-{i}" for i in range(len(K1_CASES))])
def test_flash_fwd_kernel_matches_plain(cuda, case):
    dt, d, r, c, hq, hkv, opts, o_f32 = case
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    gen = torch.Generator(device=cuda).manual_seed(d + r + c)
    q = torch.randn((hq, r, d), generator=gen, device=cuda).to(dtype)
    k = torch.randn((hkv, c, d), generator=gen, device=cuda).to(dtype)
    v = torch.randn((hkv, c, d), generator=gen, device=cuda).to(dtype)
    desc = AttentionDescriptor(
        batch=1, num_q_heads=hq, num_kv_heads=hkv, seq_len_q=r,
        seq_len_kv=c, head_dim=d, low_precision_inputs=dt == "bf16",
        low_precision_intermediates=dt == "bf16" and not o_f32, **opts)
    kd = desc.kernel_descriptor(AttentionKernelType.FORWARD)
    o_dtype = torch.float32 if o_f32 or dt == "fp32" else dtype
    kw = dict(group=hq // hkv, scale=desc.softmax_scale, o_dtype=o_dtype)
    _k1_check(cuda, q, k, v, kd, kw, dt, o_dtype, _k1_kernel(dt, d))


def _k1_bf16(cuda, hq, hkv, r, c, d, seed, **opts):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (torch.randn((h, n, d), generator=gen, device=cuda).bfloat16()
               for h, n in ((hq, r), (hkv, c), (hkv, c)))
    desc = AttentionDescriptor(
        batch=1, num_q_heads=hq, num_kv_heads=hkv, seq_len_q=r,
        seq_len_kv=c, head_dim=d, low_precision_inputs=True,
        low_precision_intermediates=True, **opts)
    kw = dict(group=hq // hkv, scale=desc.softmax_scale,
              o_dtype=torch.bfloat16)
    return q, k, v, desc.kernel_descriptor(AttentionKernelType.FORWARD), kw


def test_flash_fwd_misaligned_view_takes_the_mma_row(cuda):
    """A q view two bytes into its storage cannot be mapped by TMA: the
    launch runs the mma.sync row of its head dim, and agrees."""
    q, k, v, kd, kw = _k1_bf16(cuda, 4, 2, 200, 200, 128, 11, causal=True)
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
    shifted = buf[1:].view(q.shape)
    shifted.copy_(q)
    _k1_check(cuda, shifted, k, v, kd, kw, "bf16", torch.bfloat16, "mma")


@pytest.mark.parametrize("d", [192, 256])
def test_flash_fwd_misaligned_view_past_128_takes_the_mma_row(cuda, d):
    """Past D = 128 too, a q or O view two bytes into its storage cannot
    be mapped by TMA: K1 runs the mma.sync row of its head dim in place of
    the one-CTA head-dim-split row, and agrees."""
    q, k, v, kd, kw = _k1_bf16(cuda, 4, 2, 300, 300, d, d + 3, causal=True)
    assert launch_row(kd, d, (q, k, v)).kernel == "wgmma_dblk"
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
    shifted = buf[1:].view(q.shape)
    shifted.copy_(q)
    _k1_check(cuda, shifted, k, v, kd, kw, "bf16", torch.bfloat16, "mma")


@pytest.mark.parametrize("d, shift, o_shift", [
    (128, 4, 0), (128, 8, 0), (100, 4, 0), (100, 0, 8), (250, 8, 4)])
def test_flash_fwd_shifted_view_takes_the_copying_producer(cuda, d, shift,
                                                           o_shift):
    """A q view 4 or 8 bytes into its storage (or an O buffer so shifted)
    cannot be mapped by TMA, but its rows and bases share 4 bytes: K1 keeps
    the wgmma row with its copying producer at that granule (D 128 and
    OpenLLaMA-3B's 100 on the 128-wide panel, D 250 on one CTA of the
    256-wide one), and agrees."""
    q, k, v, kd, kw = _k1_bf16(cuda, 4, 2, 300, 333, d, d + shift,
                               causal=True)
    buf = torch.empty(q.numel() + 8, dtype=q.dtype, device=cuda)
    shifted = buf[shift // 2:shift // 2 + q.numel()].view(q.shape)
    shifted.copy_(q)
    kernel = "wgmma" if d <= 128 else "wgmma_dblk"
    if o_shift:
        obuf = torch.full((q.numel() + 8,), float("nan"), dtype=q.dtype,
                          device=cuda)
        o = obuf[o_shift // 2:o_shift // 2 + q.numel()].view(q.shape)
        row = launch_row(kd, d, (shifted, k, v, o))
        assert row_label(row) == f"{kernel}/copy"
        lse = nan_canary(q.shape[:2], device=cuda)
        k1.flash_fwd(shifted, k, v, kd, **kw, out=(o, lse))
        torch.cuda.synchronize()
        assert_fully_written(o, "O")
        o_p, lse_p = k1.flash_fwd_plain(shifted, k, v, kd, **kw)
        atol, rtol = KERNEL_BUDGETS["flash_fwd_o_bf16"]
        assert_close(o, o_p, atol, "O", rtol=rtol)
        assert_close(lse, lse_p, KERNEL_BUDGETS["flash_fwd_l"][0], "L")
        # Nothing written past the view's last row.
        assert bool(torch.isnan(obuf[o_shift // 2 + q.numel():]).all())
        return
    _k1_check(cuda, shifted, k, v, kd, kw, "bf16", torch.bfloat16,
              f"{kernel}/copy")


def test_flash_fwd_kernel_takes_more_than_65535_heads(cuda):
    """Blocks and heads share grid.x: 70 000 heads of 16 rows run on the
    wgmma row, and agree with the plain version."""
    q, k, v, kd, kw = _k1_bf16(cuda, 70_000, 70_000, 16, 16, 64, 5,
                               causal=True)
    _k1_check(cuda, q, k, v, kd, kw, "bf16", torch.bfloat16, "wgmma")


# Head dims past D = 8 * 2^k (the cache keeps D values a row: 200 bytes
# at D 100 in bf16, 100 in int8 and fp8, D 250's 500 and 250; D 384 takes
# two chunks a lane): (D, G, window, q dtype).
HEAD_DIMS = ((80, 4, None, "bf16"), (96, 8, None, "bf16"),
             (100, 1, 50, "bf16"), (250, 4, None, "fp32"),
             (384, 8, None, "bf16"))
K2_CASES = [(fmt, d, g, w, qdt)
            for fmt in ("bf16", "int8", "fp8_e4m3", "fp8_e5m2")
            for d, g, w, qdt in ((64, 1, None, "bf16"), (128, 4, 100, "bf16"),
                                 (256, 8, None, "bf16"), (32, 2, None, "fp32"))
            + HEAD_DIMS]
_FORMATS = {"bf16": OperandPrecision.BF16, "int8": OperandPrecision.INT8,
            "fp8_e4m3": OperandPrecision.FP8_E4M3,
            "fp8_e5m2": OperandPrecision.FP8_E5M2}


def _bits(t):
    return t.view(torch.uint8 if t.element_size() == 1 else torch.int16)


@pytest.mark.parametrize("case", K2_CASES,
                         ids=[f"k2-{c[0]}-D{c[1]}-G{c[2]}-w{c[3]}-{c[4]}"
                              for c in K2_CASES])
def test_decode_kernel_matches_plain(cuda, case):
    fmt, d, g, window, qdt = case
    b, hkv, max_len = 4, 2, 256
    qdtype = torch.bfloat16 if qdt == "bf16" else torch.float32
    gen = torch.Generator(device=cuda).manual_seed(d * g)
    cache = kv_cache.create(b, hkv, max_len, d, _FORMATS[fmt], device=cuda)
    kv_cache.update(cache,
                    torch.randn((b, hkv, max_len, d), generator=gen,
                                device=cuda),
                    torch.randn((b, hkv, max_len, d), generator=gen,
                                device=cuda))
    cache.lengths = torch.tensor([0, 5, max_len - 1, max_len],
                                 dtype=torch.int32, device=cuda)
    bh = b * hkv
    q3 = (torch.randn((bh, g, d), generator=gen, device=cuda)
          * (math.log2(math.e) / math.sqrt(d))).to(qdtype)
    kn = torch.randn((bh, d), generator=gen, device=cuda).to(qdtype)
    vn = torch.randn((bh, d), generator=gen, device=cuda).to(qdtype)
    twin = kv_cache.KVCache(cache.k.clone(), cache.v.clone(),
                            cache.k_scale.clone(), cache.v_scale.clone(),
                            cache.lengths.clone(), cache.precision)

    def views(c):
        return (c.k.view(bh, max_len, d), c.v.view(bh, max_len, d),
                c.k_scale.view(bh, max_len), c.v_scale.view(bh, max_len))

    o = k2.decode_fused_append(q3, *views(cache), kn, vn, cache.lengths,
                               num_kv_heads=hkv, sliding_window=window)
    torch.cuda.synchronize()
    o_p = k2.decode_fused_append_plain(q3, *views(twin), kn, vn,
                                       twin.lengths, num_kv_heads=hkv,
                                       sliding_window=window)
    atol, rtol = KERNEL_BUDGETS["decode_o"]
    assert_close(o, o_p, atol, "O", rtol=rtol)
    for f in ("k", "v"):
        assert torch.equal(_bits(getattr(cache, f)), _bits(getattr(twin, f)))
    for f in ("k_scale", "v_scale"):
        torch.testing.assert_close(getattr(cache, f), getattr(twin, f),
                                   rtol=1e-6, atol=0)


# (storage, D, G, window, q dtype, lengths): K5 and K6 share these.
ATTEND_CASES = [
    ("bf16", 64, 1, None, "bf16", (0, 1, 77, 256)),
    ("int8", 128, 4, None, "bf16", (5, 129, 255, 256)),
    ("fp8_e4m3", 256, 7, 50, "bf16", (0, 100, 200, 256)),
    ("fp8_e5m2", 128, 16, None, "bf16", (3, 128, 130, 256)),
    ("bf16", 128, 12, 33, "fp32", (1, 60, 255, 256)),
    ("int8", 64, 4, 9, "fp32", (0, 8, 9, 250)),
    ("fp8_e5m2", 8, 2, None, "bf16", (17, 1, 256, 128)),
] + [(fmt, d, g, w, qdt, (0, 33, 255, 256))
     for fmt in ("bf16", "int8", "fp8_e4m3", "fp8_e5m2")
     for d, g, w, qdt in HEAD_DIMS]
_ATTEND_IDS = [f"{c[0]}-D{c[1]}-G{c[2]}-w{c[3]}-{c[4]}" for c in ATTEND_CASES]
# K5 alone also at D 512 (two chunks a lane, the partial O at 131,072
# bytes of shared memory).
K5_CASES = ATTEND_CASES + [("bf16", 512, 1, None, "bf16", (3, 200, 256, 64))]


def _attend_inputs(cuda, case, hkv, cap):
    fmt, d, g, _, qdt, lens = case
    gen = torch.Generator(device=cuda).manual_seed(d * g + cap)
    b = len(lens)
    q3 = (torch.randn((b * hkv, g, d), generator=gen, device=cuda)
          * (math.log2(math.e) / math.sqrt(d))).to(
              torch.bfloat16 if qdt == "bf16" else torch.float32)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    return q3, lengths, gen


@pytest.mark.parametrize("case", K5_CASES, ids=_ATTEND_IDS + ["bf16-D512"])
def test_decode_attend_kernel_matches_plain(cuda, case):
    fmt, d, g, window, _, lens = case
    b, hkv, max_len = len(lens), 2, 256
    q3, lengths, gen = _attend_inputs(cuda, case, hkv, max_len)
    cache = kv_cache.create(b, hkv, max_len, d, _FORMATS[fmt], device=cuda)
    kv_cache.update(cache,
                    torch.randn((b, hkv, max_len, d), generator=gen,
                                device=cuda),
                    torch.randn((b, hkv, max_len, d), generator=gen,
                                device=cuda))
    args = (cache.k.view(b * hkv, max_len, d), cache.v.view(b * hkv, max_len, d),
            cache.k_scale.view(b * hkv, max_len),
            cache.v_scale.view(b * hkv, max_len), lengths)
    kw = dict(num_kv_heads=hkv, sliding_window=window)
    n = k2.decode_attend.launches
    o = k2.decode_attend(q3, *args, **kw,
                         out=nan_canary(q3.shape, q3.dtype, device=cuda))
    torch.cuda.synchronize()
    assert k2.decode_attend.launches == n + 1
    assert_fully_written(o, "O")
    o_p = k2.decode_attend_plain(q3, *args, **kw)
    atol, rtol = KERNEL_BUDGETS["decode_attend_o"]
    assert_close(o, o_p, atol, "O", rtol=rtol)
    for i, ln in enumerate(lens):
        if ln == 0:
            assert not o[i * hkv:(i + 1) * hkv].any()


@pytest.mark.parametrize("ps", [128, 512])
@pytest.mark.parametrize("case", ATTEND_CASES, ids=_ATTEND_IDS)
def test_paged_decode_kernel_matches_plain(cuda, case, ps):
    fmt, d, g, window, _, lens = case
    hkv, max_pages = 2, -(-1024 // ps)
    lens = tuple(4 * ln for ln in lens)             # up to 1024 rows
    q3, lengths, gen = _attend_inputs(cuda, case[:5] + (lens,), hkv, ps)
    operands = (*shuffled_page_pool(_FORMATS[fmt].dtype, lens, hkv, d, ps,
                                    max_pages, generator=gen, device=cuda),
                lengths)
    n = k6.paged_decode.launches
    o = k6.paged_decode(q3, *operands, sliding_window=window,
                        out=nan_canary(q3.shape, q3.dtype, device=cuda))
    torch.cuda.synchronize()
    assert k6.paged_decode.launches == n + 1
    assert_fully_written(o, "O")
    o_p = k6.paged_decode_plain(q3, *operands, sliding_window=window)
    atol, rtol = KERNEL_BUDGETS["paged_decode_o"]
    assert_close(o, o_p, atol, "O", rtol=rtol)
    # Paged and contiguous agree on the same rows.
    k, v, ks, vs = (k6.gather_rows(t, operands[4]) for t in operands[:4])
    o_c = k2.decode_attend(q3, k.contiguous(), v.contiguous(),
                           ks.contiguous(), vs.contiguous(), lengths,
                           num_kv_heads=hkv, sliding_window=window)
    assert_close(o, o_c, 0.0, "O paged vs contiguous")


@pytest.mark.parametrize("fmt, d, ps", [("int8", 100, 3), ("bf16", 100, 24),
                                       ("fp8_e5m2", 250, 24),
                                       ("int8", 80, 5)])
def test_paged_decode_pages_of_odd_bytes_match_plain(cuda, fmt, d, ps):
    """Pages whose bytes are not a multiple of 16 (a page of 3 rows of 100
    int8 values starts 4-byte aligned): K6 copies such runs byte by byte,
    page by page; equal to K5 over the same rows, within its budget."""
    hkv, g, window = 2, 4, None
    lens = (0, 7, 70, 301)
    max_pages = -(-max(lens) // ps)
    q3, lengths, gen = _attend_inputs(
        cuda, (fmt, d, g, window, "bf16", lens), hkv, ps)
    operands = (*shuffled_page_pool(_FORMATS[fmt].dtype, lens, hkv, d, ps,
                                    max_pages, generator=gen, device=cuda),
                lengths)
    o = k6.paged_decode(q3, *operands,
                        out=nan_canary(q3.shape, q3.dtype, device=cuda))
    torch.cuda.synchronize()
    assert_fully_written(o, "O")
    atol, rtol = KERNEL_BUDGETS["paged_decode_o"]
    assert_close(o, k6.paged_decode_plain(q3, *operands), atol, "O",
                 rtol=rtol)
    k, v, ks, vs = (k6.gather_rows(t, operands[4]) for t in operands[:4])
    o_c = k2.decode_attend(q3, k.contiguous(), v.contiguous(),
                           ks.contiguous(), vs.contiguous(), lengths,
                           num_kv_heads=hkv)
    assert torch.equal(o, o_c)


# The path each decode launch takes (ops/params.py::decode_path, counted
# by the wrapper's launches_by_path and checked by the C launch): the
# tensor-core pair at 64 <= D <= 512 over every storage type (K2, K5 and
# K6 alike; int8 and fp8 widened to bf16) over rows padded to 128 (256
# past D 128, 512 past D 256) in shared memory and copied at the granule
# their rows and bases share (16 at D 80, 96, 112, 384, 512; 8 at D 100
# and 300 in bf16 and at bases 8 bytes off; 4 at int8 and fp8 D 100 and
# 300, bf16 D 250 and at bases 4 bytes off; D 64 and 128 off 16 bytes on
# the padded instances), and FMA where it stays (odd D, D 250 and 302
# over 1-byte storage, D < 64): (kernel, storage, D, G, base shift in
# bytes, path).
PATH_CASES = [
    ("k2", "bf16", 80, 4, 0, "mma/g16"), ("k2", "bf16", 96, 8, 0, "mma/g16"),
    ("k2", "bf16", 100, 1, 0, "mma/g8"), ("k2", "bf16", 112, 4, 0, "mma/g16"),
    ("k2", "fp8_e4m3", 100, 1, 0, "mma/g4"),
    ("k2", "fp8_e5m2", 96, 8, 0, "mma/g16"),
    ("k2", "bf16", 100, 4, 4, "mma/g4"),
    ("k2", "fp8_e4m3", 128, 4, 8, "mma/g8"),
    ("k2", "int8", 100, 1, 0, "mma/g4"), ("k2", "bf16", 99, 1, 0, "fma"),
    ("k2", "int8", 128, 4, 0, "mma/g16"), ("k2", "int8", 128, 4, 4, "mma/g4"),
    ("k2", "int8", 64, 8, 0, "mma/g16"), ("k2", "int8", 99, 1, 0, "fma"),
    ("k5", "bf16", 80, 4, 0, "mma/g16"), ("k5", "bf16", 100, 1, 4, "mma/g4"),
    ("k5", "bf16", 96, 8, 8, "mma/g8"), ("k5", "bf16", 128, 4, 8, "mma/g8"),
    ("k5", "bf16", 64, 8, 4, "mma/g4"), ("k5", "bf16", 112, 2, 0, "mma/g16"),
    ("k5", "bf16", 99, 1, 0, "fma"), ("k5", "fp8_e4m3", 100, 1, 0, "mma/g4"),
    ("k5", "int8", 100, 1, 0, "mma/g4"), ("k5", "int8", 128, 4, 0, "mma/g16"),
    ("k5", "int8", 128, 4, 4, "mma/g4"), ("k5", "int8", 99, 1, 0, "fma"),
    ("k5", "fp8_e5m2", 128, 4, 0, "mma/g16"),
    ("k6", "bf16", 80, 4, 0, "mma/g16"), ("k6", "bf16", 100, 1, 0, "mma/g8"),
    ("k6", "bf16", 100, 1, 4, "mma/g4"), ("k6", "bf16", 96, 8, 0, "mma/g16"),
    ("k6", "bf16", 99, 4, 0, "fma"), ("k6", "fp8_e5m2", 100, 1, 0, "mma/g4"),
    ("k6", "int8", 100, 1, 0, "mma/g4"), ("k6", "int8", 128, 4, 0, "mma/g16"),
    ("k6", "int8", 128, 4, 4, "mma/g4"), ("k6", "fp8_e4m3", 128, 4, 0,
                                          "mma/g16"),
    # Past D 128 on the 256-wide pair and past D 256 on the 512-wide one
    # (granule read at run time), D 250 and 302 over 1-byte storage and
    # odd D 385 on FMA (two chunks a lane over 2- and 1-byte rows).
    ("k2", "int8", 192, 8, 0, "mma/g16"), ("k2", "int8", 256, 4, 0, "mma/g16"),
    ("k2", "bf16", 250, 4, 0, "mma/g4"), ("k2", "bf16", 192, 8, 4, "mma/g4"),
    ("k2", "fp8_e4m3", 256, 4, 8, "mma/g8"), ("k2", "int8", 250, 4, 0, "fma"),
    ("k2", "bf16", 384, 8, 0, "mma/g16"),
    ("k2", "int8", 512, 1, 0, "mma/g16"), ("k2", "int8", 300, 4, 0, "mma/g4"),
    ("k2", "bf16", 300, 4, 4, "mma/g4"), ("k2", "int8", 302, 4, 0, "fma"),
    ("k2", "int8", 385, 8, 0, "fma"), ("k2", "fp8_e5m2", 385, 8, 0, "fma"),
    ("k5", "bf16", 192, 8, 0, "mma/g16"), ("k5", "bf16", 250, 4, 0, "mma/g4"),
    ("k5", "bf16", 256, 4, 8, "mma/g8"), ("k5", "int8", 256, 4, 4, "mma/g4"),
    ("k5", "fp8_e5m2", 192, 8, 0, "mma/g16"), ("k5", "bf16", 130, 4, 0,
                                               "mma/g4"),
    ("k5", "bf16", 136, 2, 0, "mma/g16"), ("k5", "fp8_e4m3", 250, 4, 0, "fma"),
    ("k5", "bf16", 512, 1, 0, "mma/g16"),
    ("k5", "fp8_e4m3", 384, 8, 8, "mma/g8"), ("k5", "bf16", 300, 4, 0,
                                              "mma/g8"),
    ("k5", "bf16", 385, 8, 0, "fma"), ("k5", "fp8_e4m3", 385, 8, 0, "fma"),
    ("k6", "bf16", 192, 8, 0, "mma/g16"), ("k6", "bf16", 250, 4, 0, "mma/g4"),
    ("k6", "int8", 256, 4, 0, "mma/g16"), ("k6", "fp8_e4m3", 192, 8, 4,
                                           "mma/g4"),
    ("k6", "int8", 250, 4, 0, "fma"), ("k6", "bf16", 384, 8, 0, "mma/g16"),
    ("k6", "int8", 384, 8, 0, "mma/g16"), ("k6", "fp8_e5m2", 300, 4, 0,
                                           "mma/g4"),
    ("k6", "bf16", 512, 1, 4, "mma/g4"), ("k6", "int8", 385, 8, 0, "fma"),
    # D <= 8 with query chunks of 8: 128 threads a CTA.
    ("k2", "bf16", 4, 8, 0, "fma"), ("k2", "int8", 8, 8, 0, "fma/exact"),
    ("k5", "bf16", 8, 8, 0, "fma/exact"), ("k5", "int8", 4, 8, 0, "fma"),
    ("k6", "bf16", 8, 8, 0, "fma/exact"), ("k6", "fp8_e4m3", 4, 8, 0, "fma"),
]


@pytest.mark.parametrize("case", PATH_CASES,
                         ids=[f"{c[0]}-{c[1]}-D{c[2]}-G{c[3]}-off{c[4]}"
                              for c in PATH_CASES])
def test_decode_launch_takes_its_named_path(cuda, case):
    """Each launch lands on the path its case names, fills a NaN-filled
    O, agrees with its plain version within its budget, and a second
    launch gives the same bits (K2: the appended rows equal the plain
    version's)."""
    from mfa_tpu_torch.ops import params

    kernel, fmt, d, g, shift, want = case
    hkv, max_len, lens = 2, 256, (0, 33, 255, 256)
    b, bh = len(lens), len(lens) * hkv
    storage = _FORMATS[fmt].dtype
    gen = torch.Generator(device=cuda).manual_seed(d * g + shift)
    q3 = (torch.randn((bh, g, d), generator=gen, device=cuda)
          * (math.log2(math.e) / math.sqrt(d))).bfloat16()
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    if kernel == "k6":
        k, v, ks, vs, tables = shuffled_page_pool(
            storage, lens, hkv, d, 128, 2, generator=gen, device=cuda)
        k, v = shifted_copy(k, shift), shifted_copy(v, shift)
        fn, counter = k6.paged_decode, k6.paged_decode.launches_by_path

        def run(out):
            return fn(q3, k, v, ks, vs, tables, lengths, out=out)

        want_o = k6.paged_decode_plain(q3, k, v, ks, vs, tables, lengths)
        budget = "paged_decode_o"
    else:
        cache = kv_cache.create(b, hkv, max_len, d, _FORMATS[fmt],
                                device=cuda)
        kv_cache.update(cache, *torch.randn((2, b, hkv, max_len, d),
                                            generator=gen, device=cuda))
        k, v = (shifted_copy(t.view(bh, max_len, d), shift)
                for t in (cache.k, cache.v))
        ks, vs = (t.view(bh, max_len) for t in (cache.k_scale,
                                                 cache.v_scale))
        if kernel == "k5":
            fn, counter = k2.decode_attend, k2.decode_attend.launches_by_path

            def run(out):
                return fn(q3, k, v, ks, vs, lengths, num_kv_heads=hkv,
                          out=out)

            want_o = k2.decode_attend_plain(q3, k, v, ks, vs, lengths,
                                            num_kv_heads=hkv)
            budget = "decode_attend_o"
        else:
            kn, vn = (torch.randn((bh, d), generator=gen, device=cuda)
                      .bfloat16() for _ in range(2))
            fn = k2.decode_fused_append
            counter = k2.decode_fused_append.launches_by_path
            twin = [t.clone() for t in (k, v, ks, vs)]

            def run(out):
                return fn(q3, k, v, ks, vs, kn, vn, lengths,
                          num_kv_heads=hkv, out=out)

            want_o = k2.decode_fused_append_plain(q3, *twin, kn, vn,
                                                  lengths, num_kv_heads=hkv)
            budget = "decode_o"
    assert k.data_ptr() % 16 == shift
    granule = params.decode_granule(d, k.element_size(), k.data_ptr(),
                                    v.data_ptr())
    assert params.decode_path(d, storage, True, granule) == want
    before = dict(counter)
    o = run(nan_canary(q3.shape, q3.dtype, device=cuda))
    torch.cuda.synchronize()
    assert counter[want] == before.get(want, 0) + 1
    assert sum(counter.values()) == sum(before.values()) + 1
    assert_fully_written(o, "O")
    atol, rtol = KERNEL_BUDGETS[budget]
    assert_close(o, want_o, atol, "O", rtol=rtol)
    o2 = run(nan_canary(q3.shape, q3.dtype, device=cuda))
    assert torch.equal(_bits(o2), _bits(o))
    if kernel == "k2":
        for got, ref in zip((k, v), twin[:2]):
            assert torch.equal(_bits(got), _bits(ref))


def test_decode_fma_path_refuses_a_cache_off_16_bytes(cuda):
    """The FMA pair copies 16-byte granules of a 16-byte aligned cache:
    int8 storage 4 bytes off 16 under fp32 q (which the tensor-core pair
    never takes) is refused before any launch."""
    bh, hkv, max_len, d = 4, 2, 64, 100
    q3 = torch.randn((bh, 1, d), device=cuda)
    k, v = (shifted_copy(torch.zeros((bh, max_len, d), dtype=torch.int8,
                                     device=cuda), 4) for _ in range(2))
    ks = vs = torch.ones((bh, max_len), device=cuda)
    lengths = torch.full((bh // hkv,), 10, dtype=torch.int32, device=cuda)
    n = k2.decode_attend.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        k2.decode_attend(q3, k, v, ks, vs, lengths, num_kv_heads=hkv)
    assert k2.decode_attend.launches == n


# K5 and K6 over a cache of many splits, the lengths at split edges (0, 1,
# R - 1, R, R + 1, capacity - 1, capacity, for the split rows R that
# ops/params.py gives the shape): (storage, G, window, q dtype). G = 12
# and 16 cross the query-chunk axis; windows of 77-1000 start inside a
# split.
SPLIT_CASES = [
    ("bf16", 4, None, "bf16"),
    ("int8", 12, None, "bf16"),
    ("fp8_e4m3", 16, 1000, "bf16"),
    ("fp8_e5m2", 4, 300, "fp32"),
    ("bf16", 12, 77, "fp32"),
    ("int8", 1, None, "fp32"),
    ("fp8_e4m3", 8, None, "fp32"),
    ("fp8_e5m2", 16, 129, "bf16"),
    ("bf16", 12, 513, "bf16"),
    ("bf16", 8, None, "bf16"),
]


@pytest.mark.parametrize("ps", [128, 512])
@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=[f"{c[0]}-G{c[1]}-w{c[2]}-{c[3]}"
                              for c in SPLIT_CASES])
def test_split_edges_k5_and_k6_match_plain(cuda, case, ps):
    from mfa_tpu_torch.ops import params

    fmt, g, window, qdt = case
    hkv, d, cap = 2, 128, 4096
    rows = params.decode_split_rows(7 * hkv, g, cap,
                                    params.detect_device(cuda))
    assert -(-cap // rows) >= 4
    lens = (0, 1, rows - 1, rows, rows + 1, cap - 1, cap)
    q3, lengths, gen = _attend_inputs(cuda, (fmt, d, g, window, qdt, lens),
                                      hkv, cap + ps)
    pool = shuffled_page_pool(_FORMATS[fmt].dtype, lens, hkv, d, ps,
                              cap // ps, generator=gen, device=cuda)
    operands = (*pool, lengths)
    contiguous = [k6.gather_rows(t, pool[4]).contiguous() for t in pool[:4]]
    n5, n6 = k2.decode_attend.launches, k6.paged_decode.launches
    o6 = k6.paged_decode(q3, *operands, sliding_window=window,
                         out=nan_canary(q3.shape, q3.dtype, device=cuda))
    o5 = k2.decode_attend(q3, *contiguous, lengths, num_kv_heads=hkv,
                          sliding_window=window,
                          out=nan_canary(q3.shape, q3.dtype, device=cuda))
    torch.cuda.synchronize()
    assert (k2.decode_attend.launches, k6.paged_decode.launches) == (
        n5 + 1, n6 + 1)
    assert_fully_written(o6, "O paged")
    assert_fully_written(o5, "O contiguous")
    atol, rtol = KERNEL_BUDGETS["paged_decode_o"]
    assert_close(o6, k6.paged_decode_plain(q3, *operands,
                                           sliding_window=window),
                 atol, "O paged", rtol=rtol)
    atol, rtol = KERNEL_BUDGETS["decode_attend_o"]
    assert_close(o5, k2.decode_attend_plain(q3, *contiguous, lengths,
                                            num_kv_heads=hkv,
                                            sliding_window=window),
                 atol, "O contiguous", rtol=rtol)
    assert torch.equal(o6, o5)
    assert not o5[:hkv].any()                    # length 0 gives zeros


# K2 over a cache of many splits, the lengths at split edges (0, 1, R - 1,
# R, R + 1, capacity - 1, capacity for the split rows R of the shape), for
# every storage type, groups 1-16 (12 and 16 cross the query-chunk axis;
# 12 with fp32 q) and windows (300 starts inside a split; 1 keeps only the
# new token).
K2_SPLIT_CASES = [(fmt, g, w) for fmt in ("bf16", "int8", "fp8_e4m3",
                                          "fp8_e5m2")
                  for g in (1, 4, 8, 12, 16) for w in (None, 300, 1)]


@pytest.mark.parametrize("case", K2_SPLIT_CASES,
                         ids=[f"k2s-{c[0]}-G{c[1]}-w{c[2]}"
                              for c in K2_SPLIT_CASES])
def test_split_edges_k2_match_plain(cuda, case):
    from mfa_tpu_torch.ops import params

    fmt, g, window = case
    hkv, d, cap = 2, 128, 4096
    qdtype = torch.float32 if g == 12 else torch.bfloat16
    rows = params.decode_split_rows(7 * hkv, g, cap,
                                    params.detect_device(cuda))
    assert -(-cap // rows) >= 4
    lens = (0, 1, rows - 1, rows, rows + 1, cap - 1, cap)
    b, bh = len(lens), len(lens) * hkv
    gen = torch.Generator(device=cuda).manual_seed(g * 31 + (window or 0))
    cache = kv_cache.create(b, hkv, cap, d, _FORMATS[fmt], device=cuda)
    kv_cache.update(cache, *torch.randn((2, b, hkv, cap, d), generator=gen,
                                        device=cuda))
    cache.lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    q3 = (torch.randn((bh, g, d), generator=gen, device=cuda)
          * (math.log2(math.e) / math.sqrt(d))).to(qdtype)
    kn, vn = (torch.randn((bh, d), generator=gen, device=cuda).to(qdtype)
              for _ in range(2))
    twins = [kv_cache.KVCache(cache.k.clone(), cache.v.clone(),
                              cache.k_scale.clone(), cache.v_scale.clone(),
                              cache.lengths.clone(), cache.precision)
             for _ in range(2)]

    def views(c):
        return (c.k.view(bh, cap, d), c.v.view(bh, cap, d),
                c.k_scale.view(bh, cap), c.v_scale.view(bh, cap))

    kw = dict(num_kv_heads=hkv, sliding_window=window)
    n = k2.decode_fused_append.launches
    _nan_filled_pool(cuda, q3.numel(), qdtype)
    o = k2.decode_fused_append(q3, *views(cache), kn, vn, cache.lengths,
                               **kw)
    o2 = k2.decode_fused_append(q3, *views(twins[0]), kn, vn,
                                twins[0].lengths, **kw)
    torch.cuda.synchronize()
    assert k2.decode_fused_append.launches == n + 2
    assert_fully_written(o, "O")
    # No atomics on values and a fixed order of sums: the same bits again.
    assert torch.equal(o, o2)
    o_p = k2.decode_fused_append_plain(q3, *views(twins[1]), kn, vn,
                                       twins[1].lengths, **kw)
    atol, rtol = KERNEL_BUDGETS["decode_o"]
    assert_close(o, o_p, atol, "O", rtol=rtol)
    for f in ("k", "v"):
        assert torch.equal(_bits(getattr(cache, f)),
                           _bits(getattr(twins[1], f)))
    for f in ("k_scale", "v_scale"):
        torch.testing.assert_close(getattr(cache, f), getattr(twins[1], f),
                                   rtol=1e-6, atol=0)
    # Length 0 (and a window of 1) attends only the new token.
    assert torch.equal(o[:hkv], vn[:hkv, None, :].expand(hkv, g, d))


def test_paged_scheduler_on_cuda_matches_cpu(cuda):
    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, torch.Generator().manual_seed(3),
                               torch.float32)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (3, 5, 2, 4, 6)]
    tokens = []
    for dev in ("cpu", cuda):
        for prec in _FORMATS.values():
            model = llama.Llama(cfg, params, device=dev)
            sched = PagedScheduler(model, num_slots=2, num_pages=4,
                                   max_len=256, prompt_buckets=(8, 16),
                                   kv_precision=prec, device=dev)
            reqs = [Request(prompt=p, max_new_tokens=5) for p in prompts]
            for r in reqs:
                sched.submit(r)
            done = {c.request.id: c.tokens for c in sched.run()}
            tokens.append([done[r.id] for r in reqs])
            assert sched.free_pages == 3
    assert tokens[:4] == tokens[4:]


def test_tiny_llama_on_cuda_matches_cpu(cuda):
    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               torch.float32)
    cpu = llama.Llama(cfg, params, device="cpu")
    gpu = llama.Llama(cfg, params, device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)))
    assert_close(gpu(tokens.to(cuda)), cpu(tokens), 1e-3, "forward")
    for prec in _FORMATS.values():
        cc, gc = cpu.make_caches(2, 128, prec), gpu.make_caches(2, 128, prec)
        cpu(tokens, caches=cc)
        gpu(tokens.to(cuda), caches=gc)
        for step in range(3):
            tok = tokens[:, step]
            lc, cc = cpu.decode_step(tok, cc)
            lg, gc = gpu.decode_step(tok.to(cuda), gc)
            assert_close(lg, lc, 2e-2, f"decode {step} {prec.value}")


def test_openllama_width_decode_step_matches_cpu(cuda):
    """One decode step of a 2-layer model at OpenLLaMA-3B's widths (width
    3200, 32 heads of head dim 100, MHA, FFN 8640, vocab 32000; bf16) on
    the card (K1 on its bf16_mma row, K2 at D 100) against the same model
    on the CPU (the plain versions), over bf16, INT8 and FP8-e4m3 caches:
    logits within the mixed budget of their largest."""
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), vocab_size=32000,
                              dim=3200, n_layers=2, n_heads=32,
                              n_kv_heads=32, ffn_hidden=8640,
                              rope_theta=10000.0, norm_eps=1e-6)
    assert cfg.head_dim == 100
    params = llama.init_params(cfg, torch.Generator().manual_seed(7),
                               torch.bfloat16)
    cpu = llama.Llama(cfg, params, device="cpu")
    gpu = llama.Llama(cfg, params, device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        1, cfg.vocab_size, (2, 37)))
    n1, n2 = k1.flash_fwd.launches, k2.decode_fused_append.launches
    for name in ("bf16", "int8", "fp8_e4m3"):
        prec = _FORMATS[name]
        cc, gc = cpu.make_caches(2, 64, prec), gpu.make_caches(2, 64, prec)
        cpu(tokens, caches=cc)
        gpu(tokens.to(cuda), caches=gc)
        lc, _ = cpu.decode_step(tokens[:, -1], cc)
        lg, _ = gpu.decode_step(tokens[:, -1].to(cuda), gc)
        scale = float(lc.float().abs().max())
        assert_close(lg, lc, 5e-2 * max(1.0, scale), f"decode ({name})")
    assert k1.flash_fwd.launches - n1 == 3 * cfg.n_layers
    assert k2.decode_fused_append.launches - n2 == 3 * cfg.n_layers


def test_scheduler_on_cuda_matches_cpu(cuda):
    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, torch.Generator().manual_seed(1),
                               torch.float32)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (3, 5, 2, 4, 6)]
    tokens = []
    for dev in ("cpu", cuda):
        model = llama.Llama(cfg, params, device=dev)
        sched = ContinuousBatchingScheduler(model, num_slots=2, max_len=64,
                                            prompt_buckets=(8, 16),
                                            device=dev)
        reqs = [Request(prompt=p, max_new_tokens=5) for p in prompts]
        for r in reqs:
            sched.submit(r)
        done = {c.request.id: c.tokens for c in sched.run()}
        tokens.append([done[r.id] for r in reqs])
    assert tokens[0] == tokens[1]


# (dtype, D, R, C, Hq, Hkv, options, fp32 O)
BWD_CASES = [
    ("bf16", 32, 150, 70, 4, 4, dict(causal=True)),             # R > C
    ("bf16", 64, 96, 96, 4, 2, dict(causal=True), True),        # fp32 O
    ("bf16", 64, 300, 300, 4, 2, dict(causal=True)),
    ("bf16", 96, 129, 257, 6, 3, dict()),                       # D padded
    ("bf16", 36, 65, 77, 2, 1, dict(causal=True)),              # no 16 B loads
    ("bf16", 128, 200, 333, 8, 1, dict(sliding_window=50,
                                       logit_soft_cap=30.0)),
    ("bf16", 128, 64, 500, 8, 2, dict(causal=True,
                                      sliding_window=40)),      # unseen keys
    ("bf16", 256, 190, 190, 8, 2, dict(causal=True)),
    # The wgmma rows (D 64 and 128): R != C, causal, window, soft-cap.
    ("bf16", 64, 200, 333, 4, 2, dict(causal=True, logit_soft_cap=30.0)),
    ("bf16", 64, 333, 200, 4, 1, dict(sliding_window=50)),       # R > C
    ("bf16", 64, 1000, 1000, 6, 2, dict()),       # odd walks, both WGs
    ("bf16", 128, 129, 700, 4, 4, dict(causal=True)),
    ("bf16", 128, 700, 129, 4, 2, dict(causal=True)),            # R > C
    ("bf16", 128, 300, 300, 8, 2, dict(causal=True, sliding_window=64,
                                       logit_soft_cap=20.0)),
    ("bf16", 128, 16, 16, 2, 1, dict(causal=True)),   # tiles past R and C
    # Rows TMA cannot map (D % 8 != 0) on the wgmma kernels' copying
    # producers (D even, up to 256): D 129-256 on one CTA of the
    # head-dim-split kernels (4-byte granule at D 250 and 162);
    # OpenLLaMA-3B's D 100 (8-byte granule), MHA and GQA, causal and not,
    # fp32 O, window and soft-cap; D 42 (4 bytes), R > C. Odd D keeps the
    # mma.sync rows.
    ("bf16", 250, 300, 300, 8, 2, dict(causal=True)),
    ("bf16", 162, 129, 257, 4, 4, dict()),                      # R < C
    ("bf16", 250, 512, 2048, 4, 2, dict(causal=True, sliding_window=256,
                                        logit_soft_cap=20.0)),  # unseen keys
    ("bf16", 100, 300, 300, 4, 4, dict(causal=True)),
    ("bf16", 100, 129, 257, 4, 2, dict()),                      # R < C
    ("bf16", 100, 1000, 1000, 2, 2, dict(causal=True), True),   # fp32 O
    ("bf16", 100, 333, 200, 4, 4, dict(sliding_window=50,
                                       logit_soft_cap=30.0)),   # R > C
    ("bf16", 100, 64, 500, 4, 1, dict(causal=True,
                                      sliding_window=40)),      # unseen keys
    ("bf16", 42, 150, 70, 4, 2, dict(causal=True)),             # R > C
    ("bf16", 37, 65, 77, 2, 1, dict(causal=True)),              # odd D
    ("fp32", 64, 100, 100, 4, 2, dict(causal=True)),
    ("fp32", 256, 77, 130, 2, 1, dict()),
    ("fp32", 40, 65, 65, 4, 2, dict(sliding_window=9)),
    ("fp32", 128, 50, 120, 8, 8, dict(causal=True, logit_soft_cap=20.0)),
]


def _followed_by_garbage(x, rng):
    """x's values in a contiguous tensor whose storage runs on into
    uniform garbage (a read past the end corrupts the result)."""
    n = x.numel() // x.shape[-1]
    buf = garbage_pad(x.reshape(1, n, x.shape[-1]), n + 64, x.shape[-1], rng)
    return buf[0, :n].view(x.shape)


@pytest.mark.parametrize("case", BWD_CASES,
                         ids=[f"k34-{c[0]}-D{c[1]}-{c[2]}x{c[3]}-G{c[4] // c[5]}"
                              for c in BWD_CASES])
def test_flash_bwd_kernels_match_plain(cuda, case):
    dt, d, r, c, hq, hkv, opts, *o_f32 = case
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    gen = torch.Generator(device=cuda).manual_seed(d + r + c)
    rng = np.random.default_rng(d + r)

    def rnd(h, s):
        return _followed_by_garbage(
            torch.randn((h, s, d), generator=gen, device=cuda).to(dtype), rng)

    q, k, v, do = rnd(hq, r), rnd(hkv, c), rnd(hkv, c), rnd(hq, r)
    desc = AttentionDescriptor(
        batch=1, num_q_heads=hq, num_kv_heads=hkv, seq_len_q=r,
        seq_len_kv=c, head_dim=d, low_precision_inputs=dt == "bf16",
        low_precision_intermediates=dt == "bf16", **opts)
    kd_f, kd_q, kd_kv = (desc.kernel_descriptor(t)
                         for t in AttentionKernelType)
    kw = dict(group=hq // hkv, scale=desc.softmax_scale)
    o, lse = k1.flash_fwd(q, k, v, kd_f, **kw,
                          o_dtype=torch.float32 if o_f32 else dtype)
    # The rows say which kernel runs: wgmma for bf16 up to D = 128, the
    # head-dim-split kernel (one CTA) up to D = 256, by TMA at D % 8 == 0
    # and with the copying producer at other even D; the kept mma.sync
    # kernel at odd D.
    label = _k1_kernel(dt, d)
    for kd in (kd_q, kd_kv):
        assert row_label(k34.launch_row(kd, d, (q, k, v, do))) == label
    n3, n4 = k34.flash_bwd_q.launches, k34.flash_bwd_kv.launches
    by3 = k34.launches_by_row["flash_bwd_q"][label]
    by4 = k34.launches_by_row["flash_bwd_kv"][label]
    dq, dterm = k34.flash_bwd_q(
        q, k, v, o, do, lse, kd_q, **kw,
        out=(nan_canary((hq, r, d), device=cuda),
             nan_canary((hq, r), device=cuda)))
    dk, dv = k34.flash_bwd_kv(
        q, k, v, do, lse, dterm, kd_kv, **kw,
        out=(nan_canary((hkv, c, d), device=cuda),
             nan_canary((hkv, c, d), device=cuda)))
    torch.cuda.synchronize()
    assert (k34.flash_bwd_q.launches, k34.flash_bwd_kv.launches) == (n3 + 1,
                                                                     n4 + 1)
    assert (k34.launches_by_row["flash_bwd_q"][label],
            k34.launches_by_row["flash_bwd_kv"][label]) == (by3 + 1, by4 + 1)
    for name, t in (("dQ", dq), ("D-term", dterm), ("dK", dk), ("dV", dv)):
        assert_fully_written(t, name)
    dq_p, dterm_p = k34.flash_bwd_q_plain(q, k, v, o, do, lse, kd_q, **kw)
    dk_p, dv_p = k34.flash_bwd_kv_plain(q, k, v, do, lse, dterm, kd_kv, **kw)
    for key, got, want in (("dterm", dterm, dterm_p), (f"dq_{dt}", dq, dq_p),
                           (f"dk_{dt}", dk, dk_p), (f"dv_{dt}", dv, dv_p)):
        atol, rtol = KERNEL_BUDGETS[f"flash_bwd_{key}"]
        assert_close(got, want, atol, key, rtol=rtol)
    # Atomics-free: a second run gives the same bits.
    dk2, dv2 = k34.flash_bwd_kv(q, k, v, do, lse, dterm, kd_kv, **kw)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


def _k34_check(cuda, q, k, v, do, kd_f, kd_q, kd_kv, kw, want):
    """K3 and K4 on q (any view), k, v, dO against their plain versions:
    the row both launches take (row_label) is ``want``, every output
    written, dQ, the D-term, dK and dV within budget, a second launch
    bit-equal."""
    hq, r, d = q.shape
    hkv, c, _ = k.shape
    for kd in (kd_q, kd_kv):
        assert row_label(launch_row(kd, d, (q, k, v, do))) == want
    o, lse = k1.flash_fwd(q, k, v, kd_f, o_dtype=torch.bfloat16, **kw)
    n3, n4 = (k34.launches_by_row["flash_bwd_q"][want],
              k34.launches_by_row["flash_bwd_kv"][want])
    dq, dterm = k34.flash_bwd_q(
        q, k, v, o, do, lse, kd_q, **kw,
        out=(nan_canary((hq, r, d), device=cuda),
             nan_canary((hq, r), device=cuda)))
    dk, dv = k34.flash_bwd_kv(
        q, k, v, do, lse, dterm, kd_kv, **kw,
        out=(nan_canary((hkv, c, d), device=cuda),
             nan_canary((hkv, c, d), device=cuda)))
    torch.cuda.synchronize()
    assert (k34.launches_by_row["flash_bwd_q"][want],
            k34.launches_by_row["flash_bwd_kv"][want]) == (n3 + 1, n4 + 1)
    for name, t in (("dQ", dq), ("D-term", dterm), ("dK", dk), ("dV", dv)):
        assert_fully_written(t, name)
    dq_p, dterm_p = k34.flash_bwd_q_plain(q, k, v, o, do, lse, kd_q, **kw)
    dk_p, dv_p = k34.flash_bwd_kv_plain(q, k, v, do, lse, dterm, kd_kv, **kw)
    for key, got, want_ in (("dterm", dterm, dterm_p), ("dq_bf16", dq, dq_p),
                            ("dk_bf16", dk, dk_p), ("dv_bf16", dv, dv_p)):
        atol, rtol = KERNEL_BUDGETS[f"flash_bwd_{key}"]
        assert_close(got, want_, atol, key, rtol=rtol)
    dq2, dterm2 = k34.flash_bwd_q(q, k, v, o, do, lse, kd_q, **kw)
    dk2, dv2 = k34.flash_bwd_kv(q, k, v, do, lse, dterm, kd_kv, **kw)
    assert torch.equal(dq, dq2) and torch.equal(dterm, dterm2)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


@pytest.mark.parametrize("d, shift, do_shift", [
    (100, 4, 0), (100, 8, 0), (100, 0, 4), (128, 4, 0), (128, 0, 8),
    (250, 8, 0), (36, 4, 4)])
def test_flash_bwd_shifted_view_takes_the_copying_producer(cuda, d, shift,
                                                           do_shift):
    """A q or dO view 4 or 8 bytes into its storage cannot be mapped by
    TMA, but its rows and bases share 4 bytes: K3 and K4 keep their wgmma
    rows with the copying producer at that granule (D 128, OpenLLaMA-3B's
    100 and 36 on the 128- and 64-wide panels, D 250 on one CTA of the
    256-wide one), and agree."""
    q, k, v, kd_f, kw = _k1_bf16(cuda, 4, 2, 300, 333, d, d + shift,
                                 causal=True)
    kw.pop("o_dtype")
    gen = torch.Generator(device=cuda).manual_seed(d + 1)
    do = torch.randn(q.shape, generator=gen, device=cuda).bfloat16()
    views = []
    for t, at in ((q, shift), (do, do_shift)):
        buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=cuda)
        view = buf[at // 2:at // 2 + t.numel()].view(t.shape)
        view.copy_(t)
        views.append(view)
    desc = AttentionDescriptor(
        batch=1, num_q_heads=4, num_kv_heads=2, seq_len_q=300,
        seq_len_kv=333, head_dim=d, causal=True, low_precision_inputs=True,
        low_precision_intermediates=True)
    _, kd_q, kd_kv = (desc.kernel_descriptor(t) for t in AttentionKernelType)
    kernel = "wgmma" if d <= 128 else "wgmma_dblk"
    _k34_check(cuda, views[0], k, v, views[1], kd_f, kd_q, kd_kv, kw,
               f"{kernel}/copy")


@pytest.mark.parametrize("d", [192, 256, 100])
def test_flash_bwd_misaligned_view_takes_the_mma_row(cuda, d):
    """A q view two bytes into its storage cannot be mapped by TMA, nor
    copied at 4 bytes or more: K3 and K4 run the mma.sync row of the head
    dim (D 129-256, and OpenLLaMA-3B's 100) in place of the wgmma rows,
    and agree with their plain versions, every output written, a second
    launch bit-equal."""
    q, k, v, kd_f, kw = _k1_bf16(cuda, 4, 2, 300, 300, d, d + 7, causal=True)
    gen = torch.Generator(device=cuda).manual_seed(d)
    do = torch.randn(q.shape, generator=gen, device=cuda).bfloat16()
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
    shifted = buf[1:].view(q.shape)
    shifted.copy_(q)
    desc = AttentionDescriptor(
        batch=1, num_q_heads=4, num_kv_heads=2, seq_len_q=300,
        seq_len_kv=300, head_dim=d, causal=True, low_precision_inputs=True,
        low_precision_intermediates=True)
    _, kd_q, kd_kv = (desc.kernel_descriptor(t) for t in AttentionKernelType)
    for kd in (kd_q, kd_kv):
        assert kd.kernel == ("wgmma" if d <= 128 else "wgmma_dblk")
        assert launch_row(kd, d, (shifted, k, v, do)).kernel == "mma"
    kw = dict(group=2, scale=desc.softmax_scale)
    o, lse = k1.flash_fwd(shifted, k, v, kd_f, o_dtype=torch.bfloat16, **kw)
    n3, n4 = k34.flash_bwd_q.launches, k34.flash_bwd_kv.launches
    dq, dterm = k34.flash_bwd_q(
        shifted, k, v, o, do, lse, kd_q, **kw,
        out=(nan_canary((4, 300, d), device=cuda),
             nan_canary((4, 300), device=cuda)))
    dk, dv = k34.flash_bwd_kv(
        shifted, k, v, do, lse, dterm, kd_kv, **kw,
        out=(nan_canary((2, 300, d), device=cuda),
             nan_canary((2, 300, d), device=cuda)))
    torch.cuda.synchronize()
    assert (k34.flash_bwd_q.launches, k34.flash_bwd_kv.launches) == (n3 + 1,
                                                                     n4 + 1)
    for name, t in (("dQ", dq), ("D-term", dterm), ("dK", dk), ("dV", dv)):
        assert_fully_written(t, name)
    dq_p, dterm_p = k34.flash_bwd_q_plain(shifted, k, v, o, do, lse, kd_q,
                                          **kw)
    dk_p, dv_p = k34.flash_bwd_kv_plain(shifted, k, v, do, lse, dterm, kd_kv,
                                        **kw)
    for key, got, want in (("dterm", dterm, dterm_p), ("dq_bf16", dq, dq_p),
                           ("dk_bf16", dk, dk_p), ("dv_bf16", dv, dv_p)):
        atol, rtol = KERNEL_BUDGETS[f"flash_bwd_{key}"]
        assert_close(got, want, atol, key, rtol=rtol)
    dq2, dterm2 = k34.flash_bwd_q(shifted, k, v, o, do, lse, kd_q, **kw)
    dk2, dv2 = k34.flash_bwd_kv(shifted, k, v, do, lse, dterm, kd_kv, **kw)
    assert torch.equal(dq, dq2) and torch.equal(dterm, dterm2)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


def test_flash_bwd_kernels_take_more_than_65535_heads(cuda):
    """Blocks and heads share grid.x: 70 000 heads of 16 rows run, and
    agree with the plain versions."""
    hq, n, d = 70_000, 16, 64
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v, do = (torch.randn((hq, n, d), generator=gen, device=cuda)
                   .bfloat16() for _ in range(4))
    desc = AttentionDescriptor(
        batch=1, num_q_heads=hq, num_kv_heads=hq, seq_len_q=n, seq_len_kv=n,
        head_dim=d, causal=True, low_precision_inputs=True,
        low_precision_intermediates=True)
    kd_f, kd_q, kd_kv = (desc.kernel_descriptor(t)
                         for t in AttentionKernelType)
    kw = dict(group=1, scale=desc.softmax_scale)
    o, lse = k1.flash_fwd_plain(q, k, v, kd_f, o_dtype=torch.bfloat16, **kw)
    dq, dterm = k34.flash_bwd_q(q, k, v, o, do, lse, kd_q, **kw)
    dk, dv = k34.flash_bwd_kv(q, k, v, do, lse, dterm, kd_kv, **kw)
    dq_p, dterm_p = k34.flash_bwd_q_plain(q, k, v, o, do, lse, kd_q, **kw)
    dk_p, dv_p = k34.flash_bwd_kv_plain(q, k, v, do, lse, dterm, kd_kv, **kw)
    for key, got, want in (("dterm", dterm, dterm_p), ("dq_bf16", dq, dq_p),
                           ("dk_bf16", dk, dk_p), ("dv_bf16", dv, dv_p)):
        atol, rtol = KERNEL_BUDGETS[f"flash_bwd_{key}"]
        assert_close(got, want, atol, key, rtol=rtol)


# Head dims past 128: the head-dim-split kernels (wgmma_dblk) for bf16 up
# to D = 512 where TMA maps a row (one CTA up to D = 256, clusters of two
# past it), the rest on the D-blocked rows (mma_dblk, fma_dblk): (dtype,
# D, R, C, Hq, Hkv, options). Panels that divide D, a tail panel (D 136,
# 160, 264, 320), D % 8 != 0 (no 16-byte loads), causal and not, GQA, R
# != C, window, soft-cap and keys no query sees (R 512 against C 2048
# under a window).
DBLK_CASES = [
    ("bf16", 384, 300, 300, 4, 2, dict(causal=True)),
    ("bf16", 512, 129, 257, 2, 2, dict()),
    ("bf16", 300, 200, 150, 4, 1, dict(causal=True)),            # R > C
    ("bf16", 384, 64, 500, 2, 1, dict(causal=True, sliding_window=40,
                                      logit_soft_cap=20.0)),  # unseen keys
    ("bf16", 1024, 96, 96, 2, 2, dict(causal=True)),
    ("fp32", 384, 100, 130, 2, 1, dict(causal=True)),
    ("fp32", 300, 70, 70, 2, 2, dict(sliding_window=20)),
    ("fp32", 512, 65, 65, 1, 1, dict()),
    ("bf16", 264, 100, 100, 2, 2, dict()),
    ("bf16", 320, 200, 150, 4, 2, dict(causal=True)),            # R > C
    ("bf16", 384, 257, 257, 2, 2, dict()),
    ("bf16", 512, 300, 300, 4, 2, dict(causal=True)),
    ("bf16", 512, 64, 400, 2, 1, dict(causal=True, sliding_window=100,
                                      logit_soft_cap=30.0)),  # unseen keys
    ("bf16", 320, 130, 260, 4, 2, dict(sliding_window=70,
                                       logit_soft_cap=15.0)),
    # K1, K3 and K4 on one CTA (D 129-256); D 136 is the 192-wide panel's
    # widest tail, D 256 with Gemma-2-9B's soft-cap 50 and GQA.
    ("bf16", 160, 300, 300, 4, 2, dict(causal=True)),
    ("bf16", 192, 257, 257, 4, 1, dict()),
    ("bf16", 256, 300, 300, 4, 2, dict(causal=True)),
    ("bf16", 256, 200, 333, 4, 4, dict()),                       # R < C
    ("bf16", 192, 300, 300, 2, 2, dict(causal=True, sliding_window=64,
                                       logit_soft_cap=20.0)),
    ("bf16", 160, 333, 200, 4, 2, dict(causal=True)),            # R > C
    ("bf16", 256, 512, 2048, 4, 2, dict(causal=True,
                                        sliding_window=256)),  # unseen keys
    ("bf16", 192, 512, 2048, 2, 1, dict(sliding_window=100,
                                        logit_soft_cap=30.0)),  # unseen keys
    ("bf16", 160, 512, 2048, 4, 4, dict(causal=True, sliding_window=300,
                                        logit_soft_cap=10.0)),  # unseen keys
    ("bf16", 136, 300, 300, 4, 2, dict(causal=True)),
    ("bf16", 256, 333, 333, 8, 4, dict(causal=True, logit_soft_cap=50.0)),
]


def _dblk_kernels(dt, d):
    """The rows K1, K3 and K4 run past D = 128: the head-dim-split kernel
    where TMA maps a bf16 row up to D = 512, else the first cut (mma.sync
    up to D = 256, D-blocked past it)."""
    if dt == "fp32":
        return ("fma_dblk",) * 3
    split = ("wgmma_dblk" if d % 8 == 0 and d <= 512
             else "mma" if d <= 256 else "mma_dblk")
    return (split,) * 3


@pytest.mark.parametrize("case", DBLK_CASES,
                         ids=[f"dblk-{c[0]}-D{c[1]}-{c[2]}x{c[3]}"
                              for c in DBLK_CASES])
def test_flash_d_blocked_kernels_match_plain(cuda, case):
    """K1, K3 and K4 on their rows past D = 128 (the head-dim-split
    kernels, one CTA up to D = 256; the D-blocked first cut) against
    their plain versions at KERNEL_BUDGETS, every output written
    (NaN-prefilled), a second launch of each bit-equal, dK = dV = 0 on
    keys no query sees."""
    dt, d, r, c, hq, hkv, opts = case
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    gen = torch.Generator(device=cuda).manual_seed(d + r + c)
    q, do = (torch.randn((hq, r, d), generator=gen, device=cuda).to(dtype)
             for _ in range(2))
    k, v = (torch.randn((hkv, c, d), generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    desc = AttentionDescriptor(
        batch=1, num_q_heads=hq, num_kv_heads=hkv, seq_len_q=r,
        seq_len_kv=c, head_dim=d, low_precision_inputs=dt == "bf16",
        low_precision_intermediates=dt == "bf16", **opts)
    kd_f, kd_q, kd_kv = (desc.kernel_descriptor(t)
                         for t in AttentionKernelType)
    kernels = _dblk_kernels(dt, d)
    for kd, want_kernel in zip((kd_f, kd_q, kd_kv), kernels):
        assert launch_row(kd, d, (q, k, v, do)).kernel == want_kernel
        assert kd.block_d < d if d > 256 else d <= kd.block_d
    kw = dict(group=hq // hkv, scale=desc.softmax_scale)
    _k1_check(cuda, q, k, v, kd_f, dict(kw, o_dtype=dtype), dt, dtype,
              kernels[0])
    o, lse = k1.flash_fwd(q, k, v, kd_f, o_dtype=dtype, **kw)
    dq, dterm = k34.flash_bwd_q(
        q, k, v, o, do, lse, kd_q, **kw,
        out=(nan_canary((hq, r, d), device=cuda),
             nan_canary((hq, r), device=cuda)))
    dk, dv = k34.flash_bwd_kv(
        q, k, v, do, lse, dterm, kd_kv, **kw,
        out=(nan_canary((hkv, c, d), device=cuda),
             nan_canary((hkv, c, d), device=cuda)))
    torch.cuda.synchronize()
    for name, t in (("dQ", dq), ("D-term", dterm), ("dK", dk), ("dV", dv)):
        assert_fully_written(t, name)
    dq_p, dterm_p = k34.flash_bwd_q_plain(q, k, v, o, do, lse, kd_q, **kw)
    dk_p, dv_p = k34.flash_bwd_kv_plain(q, k, v, do, lse, dterm, kd_kv, **kw)
    for key, got, want in (("dterm", dterm, dterm_p), (f"dq_{dt}", dq, dq_p),
                           (f"dk_{dt}", dk, dk_p), (f"dv_{dt}", dv, dv_p)):
        atol, rtol = KERNEL_BUDGETS[f"flash_bwd_{key}"]
        assert_close(got, want, atol, key, rtol=rtol)
    dq2, dterm2 = k34.flash_bwd_q(q, k, v, o, do, lse, kd_q, **kw)
    dk2, dv2 = k34.flash_bwd_kv(q, k, v, do, lse, dterm, kd_kv, **kw)
    assert torch.equal(dq, dq2) and torch.equal(dterm, dterm2)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    unseen = ~k1.visible_mask(r, c, kd_kv.causal, kd_kv.sliding_window,
                              cuda).any(dim=0)
    assert bool((dk[:, unseen] == 0).all() and (dv[:, unseen] == 0).all())


def test_flash_attention_backward_at_d384_matches_plain(cuda, monkeypatch):
    """flash_attention's forward and backward at D 384 through K1, K3 and
    K4 (one launch each, all three on the head-dim-split cluster rows)
    against the same call through their plain versions."""
    from mfa_tpu_torch.ops.attention import flash_attention

    gen = torch.Generator(device=cuda).manual_seed(384)
    q, k, v, do = (torch.randn((1, 4, 300, 384), generator=gen, device=cuda)
                   .bfloat16() for _ in range(4))

    def run():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_attention(*leaves, causal=True)
        out.backward(do)
        return [out.detach()] + [t.grad for t in leaves]

    # Each kernel's wrapper, noting the row its launch runs; while it
    # stands in the module, the kernel's launch count lands on it.
    seen, wrapped = [], []
    with monkeypatch.context() as m:
        for module, name, at in ((k1, "flash_fwd", 3),
                                 (k34, "flash_bwd_q", 6),
                                 (k34, "flash_bwd_kv", 6)):
            fn = getattr(module, name)

            def rec(*args, _fn=fn, _at=at, **kwargs):
                seen.append(launch_row(args[_at], 384, args[:3]).kernel)
                return _fn(*args, **kwargs)

            rec.launches = rec.noncausal_launches = 0
            wrapped.append(rec)
            m.setattr(module, name, rec)
        got = run()
        torch.cuda.synchronize()
    assert [w.launches for w in wrapped] == [1, 1, 1]
    assert seen == ["wgmma_dblk", "wgmma_dblk", "wgmma_dblk"]
    with monkeypatch.context() as m:
        m.setattr(k1, "flash_fwd", k1.flash_fwd_plain)
        m.setattr(k34, "flash_bwd_q", k34.flash_bwd_q_plain)
        m.setattr(k34, "flash_bwd_kv", k34.flash_bwd_kv_plain)
        want = run()
    atol, rtol = KERNEL_BUDGETS["flash_fwd_o_bf16"]
    assert_close(got[0], want[0], atol, "O", rtol=rtol)
    for label, g, w in zip(("dQ", "dK", "dV"), got[1:], want[1:]):
        assert g.dtype == torch.bfloat16
        assert_fully_written(g, label)
        rel = float((g.float() - w.float()).norm() / w.float().norm())
        assert rel <= 5e-2, (label, rel)


@pytest.mark.parametrize("d", [128, 256, 384])
def test_tma_kernels_launch_from_a_fresh_host_thread(cuda, d):
    """A host thread whose first CUDA call is a TMA kernel's launch (an
    autograd worker's first backward work can be K3) has no current
    context until one is bound: K1, K3 and K4 on their TMA rows at D 128,
    256 and 384, each first in a thread of its own, give the bits they
    give on the main thread."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    q, do = (torch.randn((4, 200, d), generator=gen, device=cuda).bfloat16()
             for _ in range(2))
    k, v = (torch.randn((2, 200, d), generator=gen, device=cuda).bfloat16()
            for _ in range(2))
    desc = AttentionDescriptor(
        batch=1, num_q_heads=4, num_kv_heads=2, seq_len_q=200,
        seq_len_kv=200, head_dim=d, causal=True, low_precision_inputs=True,
        low_precision_intermediates=True)
    kd_f, kd_q, kd_kv = (desc.kernel_descriptor(t)
                         for t in AttentionKernelType)
    assert launch_row(kd_q, d, (q, k, v, do)).kernel in ("wgmma",
                                                         "wgmma_dblk")
    kw = dict(group=2, scale=desc.softmax_scale)
    o, lse = k1.flash_fwd(q, k, v, kd_f, o_dtype=torch.bfloat16, **kw)
    dq, dterm = k34.flash_bwd_q(q, k, v, o, do, lse, kd_q, **kw)
    dk, dv = k34.flash_bwd_kv(q, k, v, do, lse, dterm, kd_kv, **kw)
    calls = {
        "k1": (lambda: k1.flash_fwd(q, k, v, kd_f, o_dtype=torch.bfloat16,
                                    **kw), (o, lse)),
        "k3": (lambda: k34.flash_bwd_q(q, k, v, o, do, lse, kd_q, **kw),
               (dq, dterm)),
        "k4": (lambda: k34.flash_bwd_kv(q, k, v, do, lse, dterm, kd_kv,
                                        **kw), (dk, dv)),
    }
    got, errors = {}, {}

    def first_call(name, fn):
        try:
            got[name] = fn()
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 (reported below)
            errors[name] = repr(e)

    for name, (fn, _) in calls.items():
        thread = threading.Thread(target=first_call, args=(name, fn))
        thread.start()
        thread.join()
    assert not errors, errors
    for name, (_, want) in calls.items():
        assert all(torch.equal(a, b) for a, b in zip(got[name], want)), name


def test_tiny_llama_train_step_on_cuda_matches_cpu(cuda):
    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, torch.Generator().manual_seed(2),
                               torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 33)))
    runs = []
    for dev in ("cpu", cuda):
        # A copy: on the CPU the model's parameters alias the tensors it is
        # given, and train_step updates them in place.
        model = llama.Llama(cfg, copy.deepcopy(params), device=dev,
                            trainable=True)
        state = training.create_train_state(
            model, training.make_optimizer(lr=1e-2, warmup_steps=1,
                                           total_steps=50))
        losses = [float(training.train_step(state, tokens.to(dev))["loss"])]
        grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
        losses += [float(training.train_step(state, tokens.to(dev))["loss"])
                   for _ in range(3)]
        runs.append((losses, grads))
    (loss_c, grads_c), (loss_g, grads_g) = runs
    np.testing.assert_allclose(loss_g, loss_c, rtol=1e-4)
    assert loss_g[-1] < loss_g[0]
    for name, g in grads_g.items():
        tol = 1e-4 * float(grads_c[name].abs().max())
        assert_close(g, grads_c[name], tol, name)


_DT = {"bf16": torch.bfloat16, "fp16": torch.float16, "fp32": torch.float32}

# (A type, B type, out, batch, M, N, K, transpose_a, transpose_b, C0,
# extra columns of the buffer each operand is sliced from)
GEMM_CASES = [
    ("bf16", "bf16", None, 1, 200, 129, 127, False, False, False, 0),
    ("bf16", "bf16", "fp32", 1, 33, 70, 64, True, True, True, 0),
    ("fp16", "fp16", None, 1, 1536, 1536, 96, False, True, False, 0),
    ("bf16", "bf16", None, 1, 5, 300, 257, True, False, True, 0),      # m16
    ("bf16", "bf16", None, 3, 200, 129, 127, False, True, False, 0),
    ("bf16", "bf16", "fp32", 2, 64, 128, 256, False, False, True, 8),  # 16 B
    ("bf16", "bf16", None, 1, 7, 127, 129, True, True, False, 3),      # odd
    ("fp32", "fp32", None, 1, 129, 200, 7, False, False, True, 0),
    ("fp32", "bf16", None, 2, 65, 33, 130, True, True, False, 5),      # mixed
    ("bf16", "fp32", "bf16", 1, 100, 100, 100, False, True, True, 0),
]


@pytest.mark.parametrize("case", GEMM_CASES,
                         ids=[f"k7-{i}" for i in range(len(GEMM_CASES))])
def test_gemm_kernel_matches_plain(cuda, case):
    adt, bdt, odt, batch, m, n, k, ta, tb, with_c0, pad = case
    gen = torch.Generator(device=cuda).manual_seed(m + n + k)

    def operand(rows, cols, dt):
        big = torch.randn((batch, rows + pad, cols + pad), generator=gen,
                          device=cuda).to(_DT[dt])
        return big[:, :rows, :cols]

    a = operand(k, m, adt) if ta else operand(m, k, adt)
    b = operand(n, k, bdt) if tb else operand(k, n, bdt)
    c0 = operand(m, n, "fp32") if with_c0 else None
    out_dtype = _DT[odt] if odt else torch.promote_types(a.dtype, b.dtype)
    n7 = k7.gemm_kernel.launches
    c = gemm(a, b, c0, transpose_a=ta, transpose_b=tb,
             out_dtype=odt and _DT[odt], device=cuda)
    torch.cuda.synchronize()
    assert k7.gemm_kernel.launches == n7 + 1
    assert c.dtype == out_dtype and c.shape == (batch, m, n)
    want = gemm(a.cpu(), b.cpu(), None if c0 is None else c0.cpu(),
                transpose_a=ta, transpose_b=tb, out_dtype=out_dtype,
                device="cpu")
    tag = "fp32" if out_dtype == torch.float32 and "fp32" in (adt, bdt) \
        else "bf16"
    atol, rtol = KERNEL_BUDGETS[f"gemm_{tag}"]
    assert_close(c, want, atol * max(1.0, k / 4096), "C", rtol=rtol)
    if batch == 1:                     # 2-D operands take the same path
        c2 = gemm(a[0], b[0], None if c0 is None else c0[0],
                  transpose_a=ta, transpose_b=tb,
                  out_dtype=odt and _DT[odt], device=cuda)
        assert c2.shape == (m, n)


# K7's wgmma kernel: (transpose_a, transpose_b, batch, M, N, K, C0, out,
# extra rows and columns of the buffers the operands are sliced from):
# the four transpose states at sizes that are multiples of 8 but not of
# the tiles, a batch with batch strides, C0 into bf16 and fp32, strided
# slices with 16-byte-aligned strides, M just above the decode tile, an
# odd N (stored B [N, K]), and K below one step.
GEMM_WGMMA_CASES = [
    (False, False, 1, 1000, 1032, 1048, False, None, 0),
    (False, True, 1, 1000, 1032, 1048, False, None, 0),
    (True, False, 1, 1000, 1032, 1048, False, None, 0),
    (True, True, 1, 1000, 1032, 1048, False, None, 0),
    (False, False, 3, 200, 136, 256, False, None, 8),
    (True, True, 3, 256, 200, 64, True, "fp32", 8),
    (False, True, 1, 1000, 1032, 1048, True, "bf16", 0),
    (True, False, 2, 520, 264, 200, True, "bf16", 24),
    (False, False, 1, 17, 4096, 512, False, None, 0),
    (False, True, 1, 300, 333, 64, True, "fp32", 0),
    (True, True, 1, 136, 72, 8, False, None, 0),
]


def _nan_filled_pool(cuda, numel, dtype):
    """Leaves NaN in the caching allocator's next block of this size, so
    that an output the kernel does not fully write shows up as NaN."""
    torch.full((numel,), float("nan"), dtype=dtype, device=cuda)


@pytest.mark.parametrize("case", GEMM_WGMMA_CASES,
                         ids=[f"k7w-{i}" for i in range(len(GEMM_WGMMA_CASES))])
def test_gemm_wgmma_kernel_matches_plain(cuda, case):
    ta, tb, batch, m, n, k, with_c0, odt, pad = case
    gen = torch.Generator(device=cuda).manual_seed(m * n + k)

    def operand(rows, cols, dt):
        big = torch.randn((batch, rows + pad, cols + pad), generator=gen,
                          device=cuda).to(dt)
        return big[:, :rows, :cols]

    a = operand(k, m, torch.bfloat16) if ta else operand(m, k, torch.bfloat16)
    b = operand(n, k, torch.bfloat16) if tb else operand(k, n, torch.bfloat16)
    c0 = operand(m, n, torch.float32) if with_c0 else None
    out_dtype = _DT[odt] if odt else torch.bfloat16
    kw = dict(transpose_a=ta, transpose_b=tb, out_dtype=out_dtype,
              device=cuda)
    kd = GEMMDescriptor(
        m=m, n=n, k=k, a_precision=OperandPrecision.BF16,
        b_precision=OperandPrecision.BF16,
        c_precision=OperandPrecision.from_dtype(out_dtype), transpose_a=ta,
        transpose_b=tb, batch=batch,
        load_previous_c=with_c0).kernel_descriptor()
    assert k7.launch_tile(kd, a, b).path == "wgmma"
    n7 = k7.gemm_kernel.launches
    _nan_filled_pool(cuda, batch * m * n, out_dtype)
    c = gemm(a, b, c0, **kw)
    torch.cuda.synchronize()
    assert k7.gemm_kernel.launches == n7 + 1
    assert c.dtype == out_dtype and c.shape == (batch, m, n)
    assert_fully_written(c, "C")
    assert torch.equal(c, gemm(a, b, c0, **kw))
    want = gemm(a.cpu(), b.cpu(), None if c0 is None else c0.cpu(),
                transpose_a=ta, transpose_b=tb, out_dtype=out_dtype,
                device="cpu")
    atol, rtol = KERNEL_BUDGETS["gemm_bf16"]
    assert_close(c, want, atol * max(1.0, k / 4096), "C", rtol=rtol)


def test_gemm_misaligned_view_takes_the_mma_tile(cuda):
    """A base that is not 16-byte aligned cannot be mapped by TMA: the
    launch takes the descriptor's mma.sync tile, and agrees all the
    same."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    big = torch.randn((1, 300, 272), generator=gen, device=cuda).bfloat16()
    a, b = big[:, :, 1:257], big[:, :256, 8:264]
    assert k7.tma_mappable(b) and not k7.tma_mappable(a)
    kd = GEMMDescriptor(m=300, n=256, k=256,
                        a_precision=OperandPrecision.BF16,
                        b_precision=OperandPrecision.BF16).kernel_descriptor()
    assert kd.tile.path == "wgmma"
    assert k7.launch_tile(kd, a, b) is kd.mma_tile
    c = gemm(a, b, device=cuda)
    want = gemm(a.cpu(), b.cpu(), device="cpu")
    atol, rtol = KERNEL_BUDGETS["gemm_bf16"]
    assert_close(c, want, atol, "C", rtol=rtol)


# (layout, x type, M, N, K)
QMM_CASES = [(layout, xdt, m, n, k)
             for layout in ("int4", "int4_biased")
             for xdt, m, n, k in (("bf16", 1, 64, 64),         # d8
                                  ("bf16", 4, 100, 4096),       # d8, ragged
                                  ("bf16", 12, 1000, 256),      # d16
                                  ("bf16", 17, 1000, 256),      # w128
                                  ("bf16", 130, 72, 96),        # w128
                                  ("bf16", 1100, 2000, 128),    # w256
                                  ("fp32", 5, 130, 160),
                                  ("fp32", 70, 64, 64),
                                  # K % 32 != 0: re-split before K8
                                  ("bf16", 4, 64, 40),          # d8
                                  ("bf16", 64, 64, 100),        # w128
                                  ("bf16", 4, 4096, 4080),      # d8
                                  ("bf16", 2048, 4096, 4080),   # w256
                                  ("fp32", 5, 64, 100))]


@pytest.mark.parametrize("case", QMM_CASES,
                         ids=[f"k8-{c[0]}-{c[1]}-M{c[2]}-N{c[3]}-K{c[4]}"
                              for c in QMM_CASES])
def test_int4_matmul_kernel_matches_plain(cuda, case):
    layout, xdt, m, n, k = case
    gen = torch.Generator(device=cuda).manual_seed(m * n + k)
    w = torch.randn((n, k), generator=gen, device=cuda) / math.sqrt(k)
    qw = quant.quantize_weight(w, layout)
    x = torch.randn((m, k), generator=gen, device=cuda).to(_DT[xdt])
    n8 = k8.int4_matmul.launches
    y = k8.int4_matmul(x, qw.w, qw.scale, layout=layout, device=cuda)
    torch.cuda.synchronize()
    assert k8.int4_matmul.launches == n8 + 1
    assert y.dtype == x.dtype and y.shape == (m, n)
    assert_fully_written(y, "y")
    want = k8.int4_matmul_plain(x, qw.w, qw.scale, layout=layout)
    atol, rtol = KERNEL_BUDGETS["int4_matmul_" + (
        "biased" if layout == "int4_biased" else "signed")]
    assert_close(y, want, atol, "y", rtol=rtol)
    # Leading dims flatten to rows.
    y3 = k8.int4_matmul(x[None], qw.w, qw.scale, layout=layout,
                        device=cuda)
    assert torch.equal(y3[0], y)


@pytest.mark.parametrize("layout", ["int4", "int4_biased"])
@pytest.mark.parametrize("m, k, shift", [(4, 4096, 8), (2048, 4096, 8),
                                         (4, 4080, 3), (2048, 100, 4)])
def test_int4_matmul_takes_packed_weights_off_16_bytes(cuda, layout, m, k,
                                                       shift):
    """Packed weights ``shift`` bytes off 16 (utils/testing.py::
    shifted_copy) are re-split into aligned rows before K8: one counted
    launch, within its budget of the plain version over the same bytes."""
    n = 4096 if m > 64 or k > 1000 else 64
    gen = torch.Generator(device=cuda).manual_seed(m + k + shift)
    w = torch.randn((n, k), generator=gen, device=cuda) / math.sqrt(k)
    qw = quant.quantize_weight(w, layout)
    packed = shifted_copy(qw.w, shift)
    assert packed.data_ptr() % 16 == shift
    x = torch.randn((m, k), generator=gen, device=cuda).bfloat16()
    n8 = k8.int4_matmul.launches
    y = k8.int4_matmul(x, packed, qw.scale, layout=layout, device=cuda)
    torch.cuda.synchronize()
    assert k8.int4_matmul.launches == n8 + 1
    assert_fully_written(y, "y")
    want = k8.int4_matmul_plain(x, packed, qw.scale, layout=layout)
    atol, rtol = KERNEL_BUDGETS["int4_matmul_" + (
        "biased" if layout == "int4_biased" else "signed")]
    assert_close(y, want, atol, "y", rtol=rtol)


# K8's wgmma tiles: (layout, M, N, K, tile) at Llama-3-8B's four
# projections with M 2048, and ragged tokens and channels (M 17, 100,
# 1100, 2040; N 1000, 4000); K 96 has less than one 64-byte step in each
# half.
QMM_WGMMA_CASES = [(layout, m, n, k, tile)
                   for layout in ("int4", "int4_biased")
                   for m, n, k, tile in (
                       (2048, 4096, 4096, "w256"), (2048, 1024, 4096, "w128"),
                       (2048, 14336, 4096, "w256"),
                       (2048, 4096, 14336, "w256"), (17, 1000, 256, "w128"),
                       (100, 1000, 4096, "w128"), (1100, 1000, 96, "w128"),
                       (2040, 4000, 256, "w256"))]


@pytest.mark.parametrize("case", QMM_WGMMA_CASES,
                         ids=[f"k8w-{c[0]}-M{c[1]}-N{c[2]}-K{c[3]}"
                              for c in QMM_WGMMA_CASES])
def test_int4_matmul_wgmma_tile_matches_plain(cuda, case):
    layout, m, n, k, tile = case
    assert k8.int4_tile(m, n, torch.bfloat16).name == tile
    gen = torch.Generator(device=cuda).manual_seed(m + n + k)
    w = torch.randn((n, k), generator=gen, device=cuda) / math.sqrt(k)
    qw = quant.quantize_weight(w, layout)
    x = torch.randn((m, k), generator=gen, device=cuda).bfloat16()
    n8 = k8.int4_matmul.launches
    _nan_filled_pool(cuda, m * n, torch.bfloat16)
    y = k8.int4_matmul(x, qw.w, qw.scale, layout=layout, device=cuda)
    torch.cuda.synchronize()
    assert k8.int4_matmul.launches == n8 + 1
    assert y.dtype == x.dtype and y.shape == (m, n)
    assert_fully_written(y, "y")
    want = k8.int4_matmul_plain(x, qw.w, qw.scale, layout=layout)
    atol, rtol = KERNEL_BUDGETS["int4_matmul_" + (
        "biased" if layout == "int4_biased" else "signed")]
    assert_close(y, want, atol, "y", rtol=rtol)
    # A second launch gives the same bits; leading dims flatten to rows.
    y3 = k8.int4_matmul(x.view(1, m, k), qw.w, qw.scale, layout=layout,
                        device=cuda)
    assert torch.equal(y3[0], y)


# K8's split-K decode tiles at Llama-3-8B's four projections (K -> N),
# every decode batch (M 1, 4, 8, 16; d8 up to 8 rows, d16 above).
QMM_DECODE_CASES = [(layout, m, k, n)
                    for layout in ("int4", "int4_biased")
                    for k, n in ((4096, 4096), (4096, 1024), (4096, 14336),
                                 (14336, 4096))
                    for m in (1, 4, 8, 16)]


@pytest.mark.parametrize("case", QMM_DECODE_CASES,
                         ids=[f"k8d-{c[0]}-M{c[1]}-K{c[2]}-N{c[3]}"
                              for c in QMM_DECODE_CASES])
def test_int4_matmul_decode_tile_matches_plain(cuda, case):
    layout, m, k, n = case
    assert k8.int4_tile(m, n, torch.bfloat16).path == "splitk"
    gen = torch.Generator(device=cuda).manual_seed(m * 7 + n + k)
    w = torch.randn((n, k), generator=gen, device=cuda) / math.sqrt(k)
    qw = quant.quantize_weight(w, layout)
    x = torch.randn((m, k), generator=gen, device=cuda).bfloat16()
    n8 = k8.int4_matmul.launches
    _nan_filled_pool(cuda, m * n, torch.bfloat16)
    y = k8.int4_matmul(x, qw.w, qw.scale, layout=layout, device=cuda)
    y2 = k8.int4_matmul(x, qw.w, qw.scale, layout=layout, device=cuda)
    torch.cuda.synchronize()
    assert k8.int4_matmul.launches == n8 + 2
    assert y.dtype == x.dtype and y.shape == (m, n)
    assert_fully_written(y, "y")
    # The splits meet in a fixed order, whichever CTA arrives last.
    assert torch.equal(y, y2)
    want = k8.int4_matmul_plain(x, qw.w, qw.scale, layout=layout)
    atol, rtol = KERNEL_BUDGETS["int4_matmul_" + (
        "biased" if layout == "int4_biased" else "signed")]
    assert_close(y, want, atol, "y", rtol=rtol)


@pytest.mark.parametrize("precision", [OperandPrecision.INT4,
                                       OperandPrecision.INT8])
def test_quantized_llama_on_cuda_matches_cpu(cuda, precision):
    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, torch.Generator().manual_seed(5),
                               torch.float32, weight_precision=precision)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (3, 5, 2, 4, 6)]
    tokens = []
    for dev in ("cpu", cuda):
        model = llama.Llama(cfg, params, device=dev)
        sched = ContinuousBatchingScheduler(
            model, num_slots=2, max_len=64, prompt_buckets=(8, 16),
            kv_precision=OperandPrecision.FP8_E4M3, device=dev)
        reqs = [Request(prompt=p, max_new_tokens=5) for p in prompts]
        for r in reqs:
            sched.submit(r)
        done = {c.request.id: c.tokens for c in sched.run()}
        tokens.append([done[r.id] for r in reqs])
    assert tokens[0] == tokens[1]
    cpu = llama.Llama(cfg, params, device="cpu")
    gpu = llama.Llama(cfg, params, device=cuda)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 40)))
    assert_close(gpu(toks.to(cuda)), cpu(toks), 1e-3, "forward")


@pytest.mark.parametrize("option", [dict(qkv_bias=True),
                                    dict(sliding_window=12),
                                    dict(tie_embeddings=True)],
                         ids=["qkv_bias", "window12", "tied"])
def test_preset_options_on_cuda_match_cpu(cuda, option):
    """The options the Qwen2 and Mistral presets turn on (QKV bias with
    random values, a window shorter than the prompt, tied embeddings),
    at Qwen2's GQA group of 7 (7 query heads over 1), on the card against
    the CPU: forward, then prefill and three decode steps per format."""
    import dataclasses

    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dim=224, n_heads=7,
                              n_kv_heads=1, **option)
    params = llama.init_params(cfg, torch.Generator().manual_seed(5),
                               torch.float32)
    gen = torch.Generator().manual_seed(6)
    for layer in params["layers"]:
        for name in ("bq", "bk", "bv"):
            if name in layer:
                layer[name] = torch.randn(layer[name].shape, generator=gen)
    cpu = llama.Llama(cfg, params, device="cpu")
    gpu = llama.Llama(cfg, params, device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 20)))
    assert_close(gpu(tokens.to(cuda)), cpu(tokens), 1e-3, "forward")
    for prec in _FORMATS.values():
        cc, gc = cpu.make_caches(2, 128, prec), gpu.make_caches(2, 128, prec)
        cpu(tokens, caches=cc)
        gpu(tokens.to(cuda), caches=gc)
        for step in range(3):
            tok = tokens[:, step]
            lc, cc = cpu.decode_step(tok, cc)
            lg, gc = gpu.decode_step(tok.to(cuda), gc)
            assert_close(lg, lc, 2e-2, f"decode {step} {prec.value}")


def test_checkpoint_restores_onto_each_templates_device(cuda, tmp_path):
    """INT4 weights and an FP8 cache saved from the card load into CPU
    and card templates alike, bit for bit, each on its template's
    device."""
    from mfa_tpu_torch.utils import checkpoint

    cfg = llama.LlamaConfig.tiny()
    int4 = OperandPrecision.INT4
    model = llama.Llama.init(
        cfg, generator=torch.Generator(device=cuda).manual_seed(0),
        dtype=torch.bfloat16, device=cuda, weight_precision=int4)
    caches = model.make_caches(2, 128, OperandPrecision.FP8_E4M3)
    with torch.inference_mode():
        model(torch.tensor([[1, 2, 3], [4, 5, 6]], device=cuda),
              caches=caches)
    checkpoint.save(tmp_path / "p", model.params())
    checkpoint.save(tmp_path / "kv", caches)
    want = {k: v.cpu() for k, v in model.state_dict().items()}
    for dev in ("cpu", cuda):
        fresh = llama.Llama.init(
            cfg, generator=torch.Generator(device=dev).manual_seed(1),
            dtype=torch.bfloat16, device=dev, weight_precision=int4)
        checkpoint.load(tmp_path / "p", fresh.params())
        for k, t in fresh.state_dict().items():
            assert t.device.type == torch.device(dev).type, k
            assert torch.equal(_bits(t.cpu()), _bits(want[k])), k
        like = fresh.make_caches(2, 128, OperandPrecision.FP8_E4M3)
        checkpoint.load(tmp_path / "kv", like)
        for got, c in zip(like, caches):
            assert got.k.device.type == torch.device(dev).type
            assert torch.equal(_bits(got.k.cpu()), _bits(c.k.cpu()))
            assert got.lengths.tolist() == c.lengths.tolist() == [3, 3]


def test_k2_under_cancellation_is_within_a_rounding_step_of_its_terms(
        cuda):
    """Where attention concentrates and O cancels to near 0 from large
    terms (decode_tuning.ROUNDING_CASES), K2 holds decode_o against its
    plain version with the relative term taken of sum P |v| / l, and both
    are within one bf16 step (2^-7) of those terms from an fp64 decode:
    each rounds P v to bf16 at the same point. Against |O| the share can
    exceed 1 (ROADMAP.md §C 4), which is why chip_smoke's in-context K2
    check takes the terms' magnitude."""
    from mfa_tpu_torch.utils.decode_tuning import rounding

    for row in rounding(trials=2):
        assert row["k2_share_of_terms"] <= 1, row
        assert row["k2_bf16_steps_from_fp64"] <= 1, row
        assert row["plain_bf16_steps_from_fp64"] <= 1, row


def test_k5_k6_and_k1_under_cancellation_are_within_their_terms(cuda):
    """The same concentrated inputs through K5, K6 (the cache without the
    new token) and K1 (causal, alone and inside the sp = 4 ring's merge):
    each holds its budget against its plain version with the relative
    term taken of sum P |v| / l (against |O| K5 and K6 reached 4.18 and K1
    3.16 on the card); K5 and K6 are within one bf16 step of those terms
    from fp64, and K1, whose plain version also rounds the pre-scaled Q
    to bf16 (several steps from fp64 when the scores are large), is no
    more than one step further than its plain version."""
    from mfa_tpu_torch.utils.decode_tuning import rounding

    for row in rounding(trials=2):
        for k in ("k5", "k6"):
            assert row[f"{k}_share_of_terms"] <= 1, row
            assert row[f"{k}_bf16_steps_from_fp64"] <= 1, row
            assert row[f"{k}_plain_bf16_steps_from_fp64"] <= 1, row
        for k in ("k1", "ring_k1"):
            if f"{k}_share_of_terms" in row:
                assert row[f"{k}_share_of_terms"] <= 1, row
                assert (row[f"{k}_bf16_steps_from_fp64"]
                        <= row[f"{k}_plain_bf16_steps_from_fp64"] + 1), row


@pytest.mark.parametrize("causal", [False, True])
def test_ring_schedule_at_full_width_matches_plain(cuda, monkeypatch,
                                                   causal):
    """The sp = 4 ring (parallel/ring_attention.py::ring_schedule, every
    rank's steps in one process) at Llama-3-8B's attention width (Hq 32,
    Hkv 8, D 128, bf16; 8192 tokens in chunks of 2048) through K1, K3 and
    K4 against the same schedule over their plain versions, one KV head
    at a time, at KERNEL_BUDGETS; K1's non-causal mode counted."""
    from mfa_tpu_torch.parallel.ring_attention import ring_schedule

    gen = torch.Generator(device=cuda).manual_seed(32)
    q, k, v, do = (torch.randn((1, h, 8192, 128), generator=gen,
                               device=cuda).bfloat16()
                   for h in (32, 8, 8, 32))
    before = k1.flash_fwd.noncausal_launches
    got = ring_schedule(q, k, v, do, n=4, causal=causal, device=cuda)
    torch.cuda.synchronize()
    # Off-diagonal chunks: all 16 steps, or the 6 below the diagonal.
    assert k1.flash_fwd.noncausal_launches - before == (6 if causal else 16)
    with monkeypatch.context() as m:
        m.setattr(k1, "flash_fwd", k1.flash_fwd_plain)
        m.setattr(k34, "flash_bwd_q", k34.flash_bwd_q_plain)
        m.setattr(k34, "flash_bwd_kv", k34.flash_bwd_kv_plain)
        want = [torch.cat(parts, dim=1) for parts in zip(*(
            ring_schedule(q[:, 4 * h:4 * h + 4], k[:, h:h + 1],
                          v[:, h:h + 1], do[:, 4 * h:4 * h + 4], n=4,
                          causal=causal, device=cuda) for h in range(8)))]
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        assert_fully_written(g, name)
        budget = KERNEL_BUDGETS["flash_fwd_o_bf16" if name == "o"
                                else f"flash_bwd_{name}_bf16"]
        assert_close(g, w, budget[0], name, rtol=budget[1])


def test_tp_llama_over_one_rank_of_nccl_is_bit_equal(cuda, tmp_path):
    """A world-1 NCCL mesh: the tiny Llama sharded at tp = 1 (its own
    tensors) gives the unsharded model's forward and decode logits bit for
    bit through the NCCL group."""
    import torch.distributed as dist

    from mfa_tpu_torch.parallel import mesh as mesh_mod
    from mfa_tpu_torch.parallel import sharding

    mesh = mesh_mod.make_mesh(device=cuda, init_method=f"file://{tmp_path}/"
                              "rendezvous", rank=0, world_size=1)
    cfg = llama.LlamaConfig.tiny()
    model = llama.Llama.init(cfg, generator=torch.Generator(
        device=cuda).manual_seed(5), dtype=torch.bfloat16, device=cuda)
    tp_model = sharding.shard_model(model, mesh)
    assert tp_model.layers[0].wq.data_ptr() == model.layers[0].wq.data_ptr()
    tokens = torch.randint(1, cfg.vocab_size, (2, 24), device=cuda)

    def run(m):
        with torch.inference_mode():
            out = [m(tokens)]
            logits, caches = m(tokens, caches=m.make_caches(2, 64))
            for _ in range(3):
                logits, caches = m.decode_step(logits[:, -1].argmax(-1)
                                               if logits.dim() == 3
                                               else logits.argmax(-1),
                                               caches)
                out.append(logits)
        return out

    for a, b in zip(run(tp_model), run(model)):
        assert torch.equal(a, b)
    dist.destroy_process_group()


def test_sharded_scheduler_over_one_rank_of_nccl_matches_single_card(
        cuda, tmp_path):
    """A world-1 NCCL mesh (dp 1, tp 1): ShardedScheduler on the tiny
    Llama gives ContinuousBatchingScheduler's greedy tokens over bf16 and
    INT8 caches, K1 and K2 carrying its prefills and decode steps."""
    import torch.distributed as dist

    from mfa_tpu_torch.parallel import mesh as mesh_mod
    from mfa_tpu_torch.serving.distributed import ShardedScheduler

    mesh = mesh_mod.make_mesh(device=cuda, init_method=f"file://{tmp_path}/"
                              "rendezvous", rank=0, world_size=1)
    cfg = llama.LlamaConfig.tiny()
    model = llama.Llama.init(cfg, generator=torch.Generator(
        device=cuda).manual_seed(6), dtype=torch.bfloat16, device=cuda)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (3, 9, 17, 30, 5)]

    def run(sched):
        reqs = [Request(prompt=p, max_new_tokens=6) for p in prompts]
        for r in reqs:
            sched.submit(r)
        done = {c.request.id: c.tokens for c in sched.run()}
        return [done[r.id] for r in reqs]

    for prec in (OperandPrecision.BF16, OperandPrecision.INT8):
        kw = dict(num_slots=2, max_len=64, kv_precision=prec,
                  prompt_buckets=(16, 32), device=cuda)
        want = run(ContinuousBatchingScheduler(model, **kw))
        k1.flash_fwd.launches = k2.decode_fused_append.launches = 0
        sched = ShardedScheduler(model, mesh=mesh, **kw)
        assert sched.model.layers[0].wq.data_ptr() == \
            model.layers[0].wq.data_ptr()
        assert run(sched) == want
        assert k1.flash_fwd.launches == cfg.n_layers * len(prompts)
        assert k2.decode_fused_append.launches == \
            cfg.n_layers * sched.stats["decode_steps"]
    dist.destroy_process_group()


def test_pipeline_schedule_at_full_width_matches_forward(cuda):
    """pipeline_schedule (parallel/pipeline.py, every stage in one
    process) of Llama-3-8B's widths at 4 layers over 2 stages and 4
    microbatches against forward on the same tokens, within the bf16 mixed
    budget (5e-2 relative above 1), K1 at every stage's every step."""
    from dataclasses import replace

    cfg = replace(llama.LlamaConfig.llama3_8b(), n_layers=4)
    model = llama.Llama.init(cfg, generator=torch.Generator(
        device=cuda).manual_seed(7), dtype=torch.bfloat16, device=cuda)
    tokens = torch.randint(1, cfg.vocab_size, (4, 256), device=cuda,
                           generator=torch.Generator(
                               device=cuda).manual_seed(8))
    with torch.inference_mode():
        want = model(tokens)
        before = k1.flash_fwd.launches
        got = llama.forward_pipeline_schedule(model, tokens, n_stages=2,
                                              num_microbatches=4)
    assert k1.flash_fwd.launches - before == 2 * (4 + 2 - 1) * 2
    assert torch.isfinite(got).all()
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 5e-2 * scale
