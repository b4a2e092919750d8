"""The split rule of the split-KV decode kernels (K2
``decode_fused_append``, K5 ``decode_attend``, K6 ``paged_decode``) on the
CPU: ``ops/params.py::decode_split_rows``, and the launch arguments the
wrappers hand the kernel library, recorded by a stand-in library over meta
tensors (no kernel runs here)."""

import types

import pytest
import torch

from mfa_tpu_torch.kernels import build
from mfa_tpu_torch.kernels import decode as k5
from mfa_tpu_torch.kernels import paged_decode as k6
from mfa_tpu_torch.ops import params

SHAPES = [(n, g, cap) for n in (1, 2, 14, 32, 64, 256, 2048)
          for g in (1, 4, 7, 8, 12, 16)
          for cap in (1, 100, 256, 2048, 4096, 8192, 131072)]


def _ctas(n, group, capacity, rows):
    chunks = -(-group // params.decode_group_chunk(group))
    return n * chunks * max(1, -(-capacity // rows))


def test_split_rows_are_a_power_of_two_and_deterministic():
    for n, g, cap in SHAPES:
        rows = params.decode_split_rows(n, g, cap)
        assert rows >= 1 and rows & (rows - 1) == 0, (n, g, cap, rows)
        assert (params.DECODE_SPLIT_MIN_ROWS <= rows
                <= params.DECODE_SPLIT_MAX_ROWS)
        assert rows == params.decode_split_rows(n, g, cap)
        # SPLITS splits of a full cache (within [MIN, MAX]), more only
        # while the grid would leave an SM without a CTA.
        whole = params.DECODE_SPLIT_MIN_ROWS
        while (whole < params.DECODE_SPLIT_MAX_ROWS
               and whole * params.DECODE_SPLITS < cap):
            whole *= 2
        assert rows <= whole
        if rows < whole:
            assert _ctas(n, g, cap, 2 * rows) < params.H100.sm_count


@pytest.mark.parametrize("n, group, capacity, rows", [
    (32, 4, 2048, 256),     # chip_smoke k5: B = 4, Hkv = 8, L = 2048
    (32, 4, 8192, 1024),    # and L = 8192
    (64, 4, 2048, 256),     # k6 and paged serving: 8 sequences x Hkv 8
])
def test_split_rows_fill_the_card_at_the_table_shapes(n, group, capacity,
                                                      rows):
    """The measured best R at these shapes (utils/decode_tuning.py sweep
    on an H100), about two CTAs an SM (~2 x 132) or more."""
    assert params.decode_split_rows(n, group, capacity, params.H100) == rows
    assert _ctas(n, group, capacity, rows) >= 256


def test_k2_split_fills_the_card_at_chip_smokes_shape():
    """K2 takes K5's rule: at chip_smoke's k2 shape (4 sequences x Hkv 8,
    G 4, L 2048) its grid holds more CTAs than the H100 has SMs (the
    kernel before held one a (sequence, kv head): 32)."""
    rows = params.decode_split_rows(32, 4, 2048, params.H100)
    assert _ctas(32, 4, 2048, rows) >= params.H100.sm_count


def test_split_rows_for_one_short_sequence():
    """A grid of a few (sequence, kv head) pairs still fills the SMs."""
    rows = params.decode_split_rows(2, 4, 8192, params.H100)
    assert rows == params.DECODE_SPLIT_MIN_ROWS
    assert _ctas(2, 4, 8192, rows) >= params.H100.sm_count
    assert params.decode_split_rows(2048, 4, 100, params.H100) == 64


def test_split_rows_follow_the_sm_count():
    half = params.HopperDevice("sm90", 66, params.H100.smem_per_block,
                               (9, 0))
    for n, g, cap in SHAPES:
        assert (params.decode_split_rows(n, g, cap, half)
                >= params.decode_split_rows(n, g, cap, params.H100))


class _Library:
    """Records the calls a wrapper makes instead of launching."""

    def __init__(self):
        self.calls = []

    def call(self, name, *args):
        self.calls.append((name, args))


@pytest.fixture
def library(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(k5, "check_launch", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    return lib


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("seqs, hkv, group, page, max_pages, d", [
    (4, 8, 4, 512, 4, 128), (4, 8, 4, 512, 16, 128), (8, 8, 4, 512, 4, 128),
    (7, 2, 12, 128, 32, 128), (3, 1, 16, 256, 3, 64), (1, 4, 1, 128, 1, 8),
])
def test_k5_and_k6_split_alike_and_count_one_launch(library, seqs, hkv,
                                                    group, page, max_pages,
                                                    d):
    n, cap = seqs * hkv, page * max_pages
    q3 = _meta(n, group, d, dtype=torch.bfloat16)
    lengths = _meta(seqs, dtype=torch.int32)
    n5, n6 = k5.decode_attend.launches, k6.paged_decode.launches
    path = params.decode_path(d, torch.bfloat16, True)
    p5 = k5.decode_attend.launches_by_path[path]
    p6 = k6.paged_decode.launches_by_path[path]
    k5.decode_attend(q3, _meta(n, cap, d, dtype=torch.bfloat16),
                     _meta(n, cap, d, dtype=torch.bfloat16), _meta(n, cap),
                     _meta(n, cap), lengths, num_kv_heads=hkv)
    pages = _meta(5, hkv, page, d, dtype=torch.bfloat16)
    k6.paged_decode(q3, pages, pages, _meta(5, hkv, page),
                    _meta(5, hkv, page),
                    _meta(seqs, max_pages, dtype=torch.int32), lengths)
    assert (k5.decode_attend.launches, k6.paged_decode.launches) == (n5 + 1,
                                                                     n6 + 1)
    assert (k5.decode_attend.launches_by_path[path],
            k6.paged_decode.launches_by_path[path]) == (p5 + 1, p6 + 1)
    (name5, args5), (name6, args6) = library.calls
    assert (name5, name6) == ("mfa_decode_attend", "mfa_paged_decode")
    # split rows, query rows a CTA, threads, then the path's code: the
    # same for both.
    rows = params.decode_split_rows(n, group, cap)
    chunk = params.decode_group_chunk(group)
    assert args5[-5:-1] == args6[-5:-1] == (
        rows, chunk, params.decode_threads(d, chunk, path),
        params.DECODE_PATHS[path])


@pytest.mark.parametrize("d, group, threads", [
    (4, 8, 128), (8, 8, 128), (1, 16, 128), (8, 4, 256), (9, 8, 256),
    (128, 8, 256), (136, 4, 128), (256, 8, 128), (384, 8, 128),
    (300, 2, 128), (385, 8, 256)])
def test_small_d_with_chunks_of_8_takes_128_threads(library, d, group,
                                                    threads):
    """K5, K6 and K2 at D <= 8 with query chunks of 8 hand the launch 128
    threads (their scores fit shared memory there; the C entry takes any
    multiple of 32 up to 256), and so do the 256-wide tensor-core pair
    (bf16 at 128 < D <= 256: two CTAs an SM) and the 512-wide one (bf16
    at 256 < D <= 512: one CTA an SM); 256 elsewhere (odd D 385 on FMA)."""
    seqs, hkv, cap = 2, 2, 256
    n = seqs * hkv
    q3 = _meta(n, group, d, dtype=torch.bfloat16)
    lengths = _meta(seqs, dtype=torch.int32)
    cache = _meta(n, cap, d, dtype=torch.bfloat16)
    k5.decode_attend(q3, cache, cache, _meta(n, cap), _meta(n, cap),
                     lengths, num_kv_heads=hkv)
    k5.decode_fused_append(q3, cache, cache, _meta(n, cap), _meta(n, cap),
                           _meta(n, d, dtype=torch.bfloat16),
                           _meta(n, d, dtype=torch.bfloat16), lengths,
                           num_kv_heads=hkv)
    pages = _meta(5, hkv, 128, d, dtype=torch.bfloat16)
    k6.paged_decode(q3, pages, pages, _meta(5, hkv, 128),
                    _meta(5, hkv, 128), _meta(seqs, 2, dtype=torch.int32),
                    lengths)
    path = params.decode_path(d, torch.bfloat16, True)
    assert params.decode_threads(d, params.decode_group_chunk(group),
                                 path) == threads
    if path.startswith("mma") and d > 128:
        assert threads == 128
    assert [args[-3] for _, args in library.calls] == [threads] * 3
    smem = params.decode_smem_bytes(d, torch.bfloat16,
                                    params.decode_group_chunk(group),
                                    fused=True, table_ints=4)
    assert max(smem) <= params.H100.smem_per_block


def test_workspace_holds_what_the_kernel_carves():
    for n, g, cap in SHAPES[::7]:
        for d in (8, 128, 256):
            rows, chunk, ws = k5.split_launch(n, g, cap, d,
                                              torch.device("meta"))
            splits, chunks = max(1, -(-cap // rows)), -(-g // chunk)
            # scores (a chunk's query rows each), split maxes and sums,
            # partial O, one counter a chunk
            need = (n * chunks * cap * chunk
                    + n * g * (2 * splits + splits * d) + n * chunks)
            assert ws.dtype == torch.float32 and ws.numel() >= need
            assert chunk in (4, 8) and chunk >= min(g, 8)


def test_k2_workspace_holds_each_splits_p_scale_too():
    """K2's workspace: K5's, then each split's max |P vs| (an int8
    cache's P scale) after the counters."""
    for n, g, cap in SHAPES[::7]:
        for d in (8, 128, 256):
            rows, chunk, ws = k5.split_launch(n, g, cap, d,
                                              torch.device("meta"),
                                              fused=True)
            splits, chunks = max(1, -(-cap // rows)), -(-g // chunk)
            need = (n * chunks * cap * chunk
                    + n * g * (3 * splits + splits * d) + n * chunks)
            assert ws.dtype == torch.float32 and ws.numel() >= need


@pytest.mark.parametrize("seqs, hkv, group, cap, d, window", [
    (4, 8, 4, 2048, 128, None), (4, 8, 4, 8192, 128, 512),
    (4, 2, 16, 2048, 128, 512), (3, 1, 12, 300, 64, None),
    (1, 4, 1, 128, 8, 1), (2, 1, 33, 1024, 256, None),
    (2, 2, 8, 1024, 512, None),
])
def test_k2_takes_the_split_and_counts_one_launch(library, monkeypatch,
                                                  seqs, hkv, group, cap, d,
                                                  window):
    """Through the entry point: one counted K2 call a step, K5's split
    rows, query chunk and CTA size, any group (no limit of 8 rows)."""
    from mfa_tpu_torch.ops import decode as ops_decode
    from mfa_tpu_torch.ops.precision import OperandPrecision
    from mfa_tpu_torch.serving.kv_cache import KVCache

    monkeypatch.setattr(ops_decode, "resolve_device",
                        lambda device: torch.device("meta"))
    n = seqs * hkv
    storage = _meta(seqs, hkv, cap, d, dtype=torch.int8)
    cache = KVCache(storage, storage, _meta(seqs, hkv, cap),
                    _meta(seqs, hkv, cap), _meta(seqs, dtype=torch.int32),
                    OperandPrecision.INT8)
    q = _meta(seqs, hkv * group, d, dtype=torch.bfloat16)
    kn = _meta(seqs, hkv, d, dtype=torch.bfloat16)
    before = k5.decode_fused_append.launches
    o, cache = ops_decode.decode_attention_append(
        q, kn, kn, cache, sliding_window=window, device="cuda")
    assert o.shape == q.shape
    assert k5.decode_fused_append.launches == before + 1
    ((name, args),) = library.calls
    assert name == "mfa_decode_fused_append"
    # bh hkv group L D window q_bf16 format, then split rows, query rows a
    # CTA and threads before the stream.
    assert args[10:18] == (n, hkv, group, cap, d, window or 0, 1,
                           k5.KV_FORMATS[torch.int8])
    # The path's code: int8 on the tensor-core pair at D 64, 128, 256 and
    # 512, FMA in the exact layout at D 8 (every case's D is 8 * 2^k).
    path = "mma/g16" if 64 <= d <= 512 else "fma/exact"
    assert params.decode_path(d, torch.int8, True) == path
    chunk = params.decode_group_chunk(group)
    assert args[18:21] == (params.decode_split_rows(n, group, cap), chunk,
                           params.decode_threads(d, chunk, path))
    assert args[20] == (128 if d > 128 else 256)
    assert args[21] == params.DECODE_PATHS[path]


def test_k5_bit_guard_covers_every_recorded_case(monkeypatch):
    """chip_smoke.py's guard on K5's bits: k5_bits gives one digest for
    each case of K5_DIGESTS, and the same digests at a second call (its
    inputs come from a seed alone). On the CPU K5 is its plain version,
    so the digests themselves are the card's only there."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_k5", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setattr(torch.Tensor, "cuda", lambda self: self)
    first = smoke.k5_bits(torch)
    assert sorted(first) == sorted(smoke.K5_DIGESTS)
    assert all(len(v) == 16 for v in smoke.K5_DIGESTS.values())
    assert smoke.k5_bits(torch) == first


def test_k2_bit_guard_covers_every_recorded_case(monkeypatch):
    """chip_smoke.py's guard on K2's bits over an int8 cache: k2_bits
    gives one digest for each case of K2_INT8_DIGESTS, recorded for each,
    and the same digests at a second call (its inputs come from a seed
    alone). On the CPU K2 is its plain version, so the digests themselves
    are the card's only there."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_k2", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setattr(torch.Tensor, "cuda", lambda self: self)
    first = smoke.k2_bits(torch)
    assert sorted(first) == sorted(smoke.K2_INT8_DIGESTS)
    assert all(isinstance(v, str) and len(v) == 16
               for v in smoke.K2_INT8_DIGESTS.values())
    assert smoke.k2_bits(torch) == first


# The tensor-core pair's largest row, in values (decode_mma_width), and
# the k16 step of its mma.sync.
PAIR_WIDTH, MMA_K = 512, 16


def _fp32_steps(a, b, axis_len):
    """a @ b summed as the pair's mma.sync does: fp32 products of 16
    along the summed axis at a time, the steps added in order in fp32."""
    c = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k0 in range(0, axis_len, MMA_K):
        c = c + a[:, k0:k0 + MMA_K] @ b[k0:k0 + MMA_K, :]
    return c


@pytest.mark.parametrize("d", [100, 128, 192, 256, 300, 384, 512])
@pytest.mark.parametrize("length", [1, 777, 1024, 1025, 2047, 2048])
@pytest.mark.parametrize("fill", ["pm127", "random"])
def test_pair_keeps_k2_int8_requantization_exact(d, length, fill):
    """K2 over an int8 cache as the tensor-core pair computes it
    (csrc/decode_split.cuh, kRequant): q_s8 and P_s8 are integers up to
    127, exact as bf16 operands, as are the int8 K and V widened to bf16;
    S's dots sum 16 products a step over a row padded with zeros to 128
    values (256 past D 128, 512 past D 256), P V 16 rows a step over
    splits of DECODE_SPLIT_MAX_ROWS rows, the splits' partials added in
    split order, all in fp32. Every one of those sums is an integer below
    2^24 (512 * 127^2 a dot, 1024 * 127^2 a split), so exact, and O equals
    decode_fused_append_plain's bit for bit; at +-127 (every q, K and V
    value at the clip, every live P at 127) the sums reach their
    largest."""
    from mfa_tpu_torch.kernels import quant

    rows = params.DECODE_SPLIT_MAX_ROWS
    assert PAIR_WIDTH * 127 ** 2 < 2 ** 24
    assert rows * 127 ** 2 < 2 ** 24
    width = params.decode_mma_width(d, 4)
    assert width == (128 if d <= 128 else 256 if d <= 256
                     else PAIR_WIDTH) >= d
    g, cap = 4, 2048
    gen = torch.Generator().manual_seed(d * 7 + length)
    if fill == "pm127":
        q3 = torch.full((1, g, d), 0.25).bfloat16()
        k = torch.full((1, cap, d), 127, dtype=torch.int8)
        v = torch.where(torch.arange(d) % 2 == 0, 127, -127).to(
            torch.int8).expand(1, cap, d).contiguous()
        ks = vs = torch.full((1, cap), 0.01)
    else:
        q3 = torch.randn((1, g, d), generator=gen).bfloat16()
        k, v = (torch.randint(-127, 128, (1, cap, d), generator=gen,
                              dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand((1, cap), generator=gen) * 0.015 + 0.005
                  for _ in range(2))
    kn, vn = (torch.randn((1, d), generator=gen).bfloat16() * 0.5
              for _ in range(2))
    lengths = torch.tensor([length], dtype=torch.int32)
    want = k5.decode_fused_append_plain(
        q3, k.clone(), v.clone(), ks.clone(), vs.clone(), kn, vn, lengths,
        num_kv_heads=1)

    inv127 = quant.recip(quant.INT8_MAX)
    qf = q3[0].float()
    qscale = qf.abs().amax(-1, keepdim=True).clamp_min(1e-30) * inv127
    q_s8 = torch.round(qf / qscale).clamp(-127, 127)            # [G, D]
    kw, vw = k[0, :length].float(), v[0, :length].float()
    for x in (q_s8, kw, vw):
        assert torch.equal(x.bfloat16().float(), x)
    pad = width - d
    dot = _fp32_steps(torch.nn.functional.pad(kw, (0, pad)),
                      torch.nn.functional.pad(q_s8, (0, pad)).T,
                      width)                                      # [L, G]
    exact = kw.double() @ q_s8.double().T
    assert torch.equal(dot.double(), exact)
    assert float(exact.abs().max()) <= width * 127 ** 2
    if fill == "pm127":
        assert float(exact.abs().max()) == d * 127 ** 2
    s = (dot.T * qscale * ks[:, :length]).unsqueeze(0)        # [1, G, L]
    s_new = torch.bmm(qf[None], kn.float()[:, :, None])
    m = torch.maximum(s.amax(-1, keepdim=True), s_new)
    p, p_new = torch.exp2(s - m), torch.exp2(s_new - m)
    l = (p.sum(-1, keepdim=True) + p_new).clamp_min(1e-37)
    pv = p * vs[:, None, :length]
    pscale = pv.abs().amax(-1, keepdim=True).clamp_min(1e-30) * inv127
    p_s8 = torch.round(pv / pscale).clamp(-127, 127)[0]          # [G, L]
    assert torch.equal(p_s8.bfloat16().float(), p_s8)
    if fill == "pm127":
        assert bool((p_s8 == 127).all())
    tot = torch.zeros((g, d))
    for s0 in range(0, length, rows):
        s1 = min(length, s0 + rows)
        part = _fp32_steps(torch.nn.functional.pad(p_s8[:, s0:s1],
                                                   (0, -(s1 - s0) % MMA_K)),
                           torch.nn.functional.pad(vw[s0:s1],
                                                   (0, 0, 0,
                                                    -(s1 - s0) % MMA_K)),
                           -(-(s1 - s0) // MMA_K) * MMA_K)
        exact = p_s8[:, s0:s1].double() @ vw[s0:s1].double()
        assert torch.equal(part.double(), exact)
        assert float(exact.abs().max()) < 2 ** 24
        tot = tot + part
    o = ((tot[None] * pscale + p_new * vn.float()[:, None, :]) / l).to(
        q3.dtype)
    assert torch.equal(o.view(torch.int16), want.view(torch.int16))
