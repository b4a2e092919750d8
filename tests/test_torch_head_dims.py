"""The decode kernels' head dims past D = 8 * 2^k (K2
``decode_fused_append``, K5 ``decode_attend``, K6 ``paged_decode``): the
port's three decode entry points (their plain versions on the CPU)
against mfa_tpu's (Pallas kernels in interpret mode) at D 80, 96, 100,
192, 250, 256 and 384 over bf16, INT8 and FP8-e4m3 caches, at D 300 and
512 over bf16 and INT8, and at D 4 and 8 with query chunks of 8 (G 8),
with the port's unpadded cache rows bit-equal to mfa_tpu's padded rows'
first D values;
both schedulers token for token against mfa_tpu's at an MHA model of
head dim 100 (OpenLLaMA-3B's) and GQA models of 80 and 384; OpenLLaMA-3B's
published config read alike by both packages; and the host reckoning of
the kernels' row layout (``ops/params.py::decode_row_layout``, mirror of
``csrc/decode_split.cuh::RowLayout``): lane groups, 16-byte granules that
put each row where its lanes read it, and shared memory."""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.models import convert as jax_convert
from mfa_tpu.models import llama as jax_llama
from mfa_tpu.ops.decode import decode_attention as jax_decode
from mfa_tpu.ops.decode import decode_attention_append as jax_decode_append
from mfa_tpu.ops.decode import paged_decode_attention as jax_paged_attention
from mfa_tpu.ops.precision import OperandPrecision as JPrec
from mfa_tpu.serving import kv_cache as jax_kv
from mfa_tpu.serving import paged_kv_cache as jax_paged
from mfa_tpu.serving.paged_scheduler import PagedScheduler as JaxPaged
from mfa_tpu.serving.scheduler import ContinuousBatchingScheduler as JaxSched
from mfa_tpu.serving.scheduler import Request as JaxRequest
from mfa_tpu_torch.models import convert, llama
from mfa_tpu_torch.models.from_jax import params_from_numpy
from mfa_tpu_torch.ops import params
from mfa_tpu_torch.ops.decode import (
    decode_attention,
    decode_attention_append,
    paged_decode_attention,
)
from mfa_tpu_torch.ops.precision import OperandPrecision
from mfa_tpu_torch.serving import kv_cache
from mfa_tpu_torch.serving.paged_kv_cache import PagedKVCache
from mfa_tpu_torch.serving.paged_scheduler import PagedScheduler
from mfa_tpu_torch.serving.scheduler import ContinuousBatchingScheduler, Request

HQ, HKV = 4, 2
HEAD_DIMS = (80, 96, 100, 192, 250, 256, 384)
# Budgets against mfa_tpu, those of tests/test_torch_decode.py (K2) and
# tests/test_torch_decode_attention.py / test_torch_paged.py (K5, K6):
# the mixed budget for bf16 storage, 6e-2 for quantized storage.
FORMATS = {
    "bf16": (JPrec.BF16, OperandPrecision.BF16, 5e-2, 2e-2),
    "int8": (JPrec.INT8, OperandPrecision.INT8, 6e-2, 6e-2),
    "fp8_e4m3": (JPrec.FP8_E4M3, OperandPrecision.FP8_E4M3, 6e-2, 6e-2),
}
FP8_E5M2 = (JPrec.FP8_E5M2, OperandPrecision.FP8_E5M2, 6e-2, 6e-2)
# (D, storage, window): every head dim over every storage, and D 100 (a
# row of 200 bytes in bf16, 100 in int8 and fp8: the tensor-core pair's
# copy granule 4) under a window over each storage, and over fp8-e5m2.
CASES = ([(d, name, None) for d in HEAD_DIMS for name in FORMATS]
         + [(100, name, 64) for name in FORMATS]
         + [(100, "fp8_e5m2", None)])
_IDS = [f"D{d}-{name}" + (f"-w{w}" if w else "") for d, name, w in CASES]
MAX_LEN = 256


def _format(name):
    """(mfa_tpu's precision, the port's, K5/K6's budget, K2's)."""
    return FP8_E5M2 if name == "fp8_e5m2" else FORMATS[name]


def _assert_close(got, want, tol, what):
    """|got - want| <= tol * max(1, |want|) elementwise."""
    got = got.float().numpy()
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert float(err.max()) <= tol, f"{what}: {float(err.max())} > {tol}"


def _filled(rng, d, jprec, tprec, lengths):
    """Both contiguous caches filled with the same rows; mfa_tpu's under
    jax.jit (its head dim padded to a multiple of 128), the port's with D
    values a row."""
    b = len(lengths)
    fill = rng.standard_normal((2, b, HKV, MAX_LEN, d)).astype(np.float32)
    jc = jax.jit(jax_kv.update)(jax_kv.create(b, HKV, MAX_LEN, d, jprec),
                                jnp.asarray(fill[0]), jnp.asarray(fill[1]))
    jc = dataclasses.replace(jc, lengths=jnp.asarray(lengths, jnp.int32))
    tc = kv_cache.update(
        kv_cache.create(b, HKV, MAX_LEN, d, tprec, device="cpu"),
        torch.from_numpy(fill[0]), torch.from_numpy(fill[1]))
    tc.lengths = torch.tensor(lengths, dtype=torch.int32)
    assert tc.k.shape[-1] == d and jc.k.shape[-1] == -(-d // 128) * 128
    return jc, tc


def _assert_same_cache(jc, tc, d):
    """The port's rows equal mfa_tpu's first D values bit for bit, scales
    within an ulp (as tests/test_torch_decode.py holds them)."""
    for f in ("k", "v"):
        np.testing.assert_array_equal(
            getattr(tc, f).float().numpy(),
            np.asarray(getattr(jc, f).astype(jnp.float32))[..., :d],
            err_msg=f)
    for f in ("k_scale", "v_scale"):
        np.testing.assert_allclose(getattr(tc, f).numpy(),
                                   np.asarray(getattr(jc, f))[:, :, 0, :],
                                   rtol=1e-6, err_msg=f)


@pytest.mark.parametrize("d, name, window", CASES, ids=_IDS)
def test_decode_attention_matches_mfa_tpu(d, name, window):
    """K5's entry point."""
    _decode_matches(d, name, window, HQ)


def _decode_matches(d, name, window, hq):
    jprec, tprec, tol, _ = _format(name)
    rng = np.random.default_rng(d)
    lengths = [0, 131, 37, MAX_LEN]      # empty, unaligned, short, full
    jc, tc = _filled(rng, d, jprec, tprec, lengths)
    _assert_same_cache(jc, tc, d)
    q = rng.standard_normal((len(lengths), hq, d)).astype(np.float32)
    o_j = jax_decode(jnp.asarray(q, jnp.bfloat16), jc, sliding_window=window)
    o_t = decode_attention(torch.from_numpy(q).bfloat16(), tc,
                           sliding_window=window, device="cpu")
    assert o_t.dtype == torch.bfloat16 and o_t.shape == q.shape
    _assert_close(o_t, np.asarray(o_j, np.float32), tol, f"O D {d} {name}")
    assert not o_t[0].any()                        # length 0 gives zeros


@pytest.mark.parametrize("d, name, window", CASES, ids=_IDS)
def test_decode_attention_append_matches_mfa_tpu(d, name, window):
    """K2's entry point, two steps: the second fills the last slot, and
    the caches after each append are bit-equal."""
    _append_matches(d, name, window, HQ)


def _append_matches(d, name, window, hq):
    jprec, tprec, _, tol = _format(name)
    rng = np.random.default_rng(1000 + d)
    jc, tc = _filled(rng, d, jprec, tprec, [0, 131, MAX_LEN - 2])
    for step in range(2):
        q = rng.standard_normal((3, hq, d)).astype(np.float32)
        kn, vn = (rng.standard_normal((2, 3, HKV, d)) * 0.5).astype(
            np.float32)
        o_j, jc = jax_decode_append(jnp.asarray(q, jnp.bfloat16),
                                    jnp.asarray(kn, jnp.bfloat16),
                                    jnp.asarray(vn, jnp.bfloat16), jc,
                                    sliding_window=window)
        o_t, tc = decode_attention_append(
            torch.from_numpy(q).bfloat16(), torch.from_numpy(kn).bfloat16(),
            torch.from_numpy(vn).bfloat16(), tc, sliding_window=window,
            device="cpu")
        _assert_same_cache(jc, tc, d)
        _assert_close(o_t, np.asarray(o_j, np.float32), tol,
                      f"O step {step} D {d} {name}")
    assert tc.lengths.tolist() == [2, 133, MAX_LEN]


def _to_torch(a, dtype):
    """A JAX array as a torch tensor of ``dtype``, bit for bit."""
    a = np.array(a)
    if a.dtype.itemsize == 2 and dtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if a.dtype.itemsize == 1 and dtype != torch.int8:
        return torch.from_numpy(a.view(np.uint8)).view(dtype)
    return torch.from_numpy(a)


@pytest.mark.parametrize("d, name, window", CASES, ids=_IDS)
def test_paged_decode_attention_matches_mfa_tpu(d, name, window):
    """K6's entry point over the same pool: the same uneven appends give
    the same tables, then the port's pool takes mfa_tpu's bytes (its first
    D values a row; mfa_tpu's eager append rounds its scales a step apart
    from the jitted quantizer, tests/test_torch_paged.py)."""
    _paged_matches(d, name, window, HQ)


def _paged_matches(d, name, window, hq):
    jprec, tprec, tol, _ = _format(name)
    rng = np.random.default_rng(2000 + d)
    lens = [200, 391, 0]
    jc = jax_paged.PagedKVCache(16, HKV, d, len(lens), 512, jprec)
    tc = PagedKVCache(16, HKV, d, len(lens), 512, tprec, device="cpu")
    for s, ln in enumerate(lens):
        kv = rng.standard_normal((2, HKV, ln, d)).astype(np.float32)
        for lo, hi in ((0, 7), (7, 137), (137, ln)):
            if lo < min(hi, ln):
                jc.append(s, jnp.asarray(kv[0, :, lo:hi]),
                          jnp.asarray(kv[1, :, lo:hi]))
                tc.append(s, torch.from_numpy(kv[0, :, lo:hi]),
                          torch.from_numpy(kv[1, :, lo:hi]))
    np.testing.assert_array_equal(tc.page_tables, jc.page_tables)
    dt = tc.pool.k_pages.dtype
    for f in ("k_pages", "v_pages"):
        getattr(tc.pool, f).copy_(_to_torch(getattr(jc.pool, f)[..., :d], dt))
    for f in ("k_scale", "v_scale"):
        getattr(tc.pool, f).copy_(
            _to_torch(getattr(jc.pool, f)[:, :, 0, :], torch.float32))
    q = rng.standard_normal((len(lens), hq, d)).astype(np.float32)
    o_j = jax_paged_attention(jnp.asarray(q, jnp.bfloat16), jc,
                              sliding_window=window)
    o_t = paged_decode_attention(torch.from_numpy(q).bfloat16(), tc,
                                 sliding_window=window, device="cpu")
    assert o_t.shape == (len(lens), hq, d)
    _assert_close(o_t, np.asarray(o_j, np.float32), tol,
                  f"paged O D {d} {name}")
    assert not o_t[2].any()                        # length 0 gives zeros


# D <= 8 with query chunks of 8 (G 8: 16 query heads over HKV): the shape
# whose CTAs the wrappers give 128 threads (ops/params.py::decode_threads).
SMALL_D_CASES = [(kind, d, name) for kind in ("decode", "append", "paged")
                 for d in (4, 8) for name in ("bf16", "int8")]
_SMALL_IDS = [f"{kind}-D{d}-{name}-G8" for kind, d, name in SMALL_D_CASES]


@pytest.mark.parametrize("kind, d, name", SMALL_D_CASES, ids=_SMALL_IDS)
def test_small_d_with_chunks_of_8_matches_mfa_tpu(kind, d, name):
    """K5's, K2's and K6's entry points at D <= 8 and G 8 (mfa_tpu pads
    these rows to 128 values; the port keeps D)."""
    hq = 8 * HKV
    assert params.decode_group_chunk(hq // HKV) == 8
    assert params.decode_threads(d, 8) == 128
    {"decode": _decode_matches, "append": _append_matches,
     "paged": _paged_matches}[kind](d, name, None, hq)


# Past D 256, where the 512-wide tensor-core pair runs on the card: D 512
# (granule 16) and a tail of D 300 (rows of 600 bytes in bf16, granule 8;
# of 300 in int8, granule 4), over bf16 and int8, no window.
PAST_D256_CASES = [(kind, d, name) for kind in ("decode", "append", "paged")
                   for d in (300, 512) for name in ("bf16", "int8")]
_PAST_IDS = [f"{kind}-D{d}-{name}" for kind, d, name in PAST_D256_CASES]


@pytest.mark.parametrize("kind, d, name", PAST_D256_CASES, ids=_PAST_IDS)
def test_past_d256_matches_mfa_tpu(kind, d, name):
    """K5's, K2's and K6's entry points at D 300 and 512 against
    mfa_tpu's (which pads these rows to 384 and 512 values; the port
    keeps D), with the path each launch would take on the card."""
    storage = FORMATS[name][1].dtype
    want = {(300, "bf16"): "mma/g8", (300, "int8"): "mma/g4"}.get(
        (d, name), "mma/g16")
    assert params.decode_path(d, storage, True) == want
    assert params.decode_mma_width(d) == 512
    {"decode": _decode_matches, "append": _append_matches,
     "paged": _paged_matches}[kind](d, name, None, HQ)


# ---------------------------------------------------------------------------
# Schedulers at head dims 100 (MHA, OpenLLaMA-3B's), 80 and 384 (GQA)
# ---------------------------------------------------------------------------

MODELS = {"mha_d100": (200, 2, 2), "gqa_d80": (320, 4, 2),
          "gqa_d384": (768, 2, 1)}
SHAPES = [(3, 4), (5, 2), (2, 6), (4, 3), (6, 5)]   # (prompt, new tokens)


@pytest.fixture(scope="module", params=list(MODELS))
def model_pair(request):
    dim, heads, kv_heads = MODELS[request.param]
    fields = dict(vocab_size=256, dim=dim, n_layers=2, n_heads=heads,
                  n_kv_heads=kv_heads, ffn_hidden=256, rope_theta=10000.0)
    cfg_j = jax_llama.LlamaConfig(**fields)
    cfg = llama.LlamaConfig(**fields)
    assert cfg.head_dim == cfg_j.head_dim == dim // heads
    p = jax_llama.init_params(jax.random.key(1), cfg_j, jnp.float32)
    model = params_from_numpy(jax.tree.map(np.asarray, p), cfg, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, ln).tolist()
               for ln, _ in SHAPES]
    return cfg_j, p, model, prompts


def _tokens(sched, requests):
    for r in requests:
        sched.submit(r)
    done = {c.request.id: c.tokens for c in sched.run()}
    return [done[r.id] for r in requests], dict(sched.stats)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_schedulers_match_mfa_tpu_at_odd_head_dims(model_pair, paged):
    """Greedy tokens and statistics equal to mfa_tpu's scheduler, more
    requests than slots."""
    cfg_j, p, model, prompts = model_pair
    kw = dict(num_slots=2, prompt_buckets=(8, 16))
    if paged:
        kw.update(num_pages=8, max_len=256)
        jsched, sched = (JaxPaged(p, cfg_j, **kw),
                         PagedScheduler(model, device="cpu", **kw))
    else:
        kw.update(max_len=64)
        jsched, sched = (JaxSched(p, cfg_j, **kw),
                         ContinuousBatchingScheduler(model, device="cpu",
                                                     **kw))
    want, jstats = _tokens(jsched, [JaxRequest(prompt=x, max_new_tokens=n)
                                    for x, (_, n) in zip(prompts, SHAPES)])
    got, stats = _tokens(sched, [Request(prompt=x, max_new_tokens=n)
                                 for x, (_, n) in zip(prompts, SHAPES)])
    assert got == want
    assert stats == jstats and stats["prefills"] == len(SHAPES)


# OpenLLaMA-3B's published config.json fields (openlm-research/
# open_llama_3b): no num_key_value_heads (MHA), no rope_theta.
OPENLLAMA_3B = dict(
    architectures=["LlamaForCausalLM"], model_type="llama",
    hidden_act="silu", hidden_size=3200, intermediate_size=8640,
    num_hidden_layers=26, num_attention_heads=32,
    max_position_embeddings=2048, rms_norm_eps=1e-6,
    tie_word_embeddings=False, vocab_size=32000, torch_dtype="float16")


def test_openllama_3b_config_reads_alike():
    cfg = convert.config_from_hf(SimpleNamespace(**OPENLLAMA_3B))
    cfg_j = jax_convert.config_from_hf(SimpleNamespace(**OPENLLAMA_3B))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    assert (cfg.head_dim, cfg.n_heads, cfg.n_kv_heads) == (100, 32, 32)
    assert (cfg.dim, cfg.n_layers, cfg.ffn_hidden) == (3200, 26, 8640)
    # The profiler's OpenLLaMA-3B is the same configuration.
    from mfa_tpu_torch.utils import profiling
    assert profiling.MODELS["openllama_3b"] == cfg


# ---------------------------------------------------------------------------
# The row layout's host reckoning
# ---------------------------------------------------------------------------

STORAGE = {"bf16": torch.bfloat16, "int8": torch.int8,
           "fp8_e4m3": torch.float8_e4m3fn}


@pytest.mark.parametrize("itemsize", [2, 1], ids=["bf16", "1-byte"])
def test_lane_groups_follow_the_rule(itemsize):
    """W = min(32, next power of two >= ceil(D / 8)) lanes a row, one
    chunk a lane up to D = 256 and two past it (half the rows a tile);
    the kernel before's layout (W = D / 8) at D = 8 * 2^k."""
    for d in range(1, params.DECODE_MAX_HEAD_DIM + 1):
        lay = params.decode_row_layout(d, itemsize)
        chunks = -(-d // 8)
        w = 1 << (chunks - 1).bit_length()
        assert lay.chunks == chunks and lay.lanes == min(32, w), d
        assert lay.run_rows * lay.lanes == 32
        assert lay.row_groups == params.DECODE_ATTEND_THREADS // lay.lanes
        assert lay.chunks_per_lane == (1 if d <= 256 else 2), d
        assert lay.unroll == (8 if d <= 256 else 4)
        # D = 8 * 2^k <= 256: the layout before, a chunk a thread.
        assert lay.exact == (d <= 256 and d == 8 * w)
        if lay.exact:
            assert lay.run_bytes == 32 * 8 * itemsize
    assert params.decode_row_layout(100, 2).align == 8      # 200-byte rows
    assert params.decode_row_layout(100, 1).align == 4
    assert params.decode_row_layout(250, 1).align == 2
    assert params.decode_row_layout(128, 1).align == 8


def _copy_run(cache, at, run_end, granular, rb, l0, l1, slot_bytes):
    """csrc/decode_split.cuh::copy_run on the host: the slot's bytes, the
    run's offset in it and the (slot offset, bytes) of each copy."""
    slot = np.full(slot_bytes, 0xEE, np.uint8)
    writes = []
    first = at(l0) * rb
    dst = first % 16
    l = l0
    while l < l1:
        e = run_end(l, l1)
        gs = first if l == l0 else at(l) * rb
        n = (e - l) * rb
        ds = dst + (l - l0) * rb
        if granular:
            a = gs & ~15
            span = ((gs + n + 15) & ~15) - a
            d0 = ds - (gs & 15)
            assert d0 % 16 == 0 and a % 16 == 0 and span % 16 == 0
            # Never past the 16-byte granule that holds the storage's
            # last byte.
            assert a + span <= -(-len(cache) // 16) * 16
            assert 0 <= d0 and d0 + span <= slot_bytes
            got = cache[a:a + span]
            slot[d0:d0 + len(got)] = got
            writes.append((d0, span))
        else:
            slot[ds:ds + n] = cache[gs:gs + n]
            writes.append((ds, n))
        l = e
    return slot, dst, writes


def _check_runs(d, itemsize, at, run_end, granular, s_lo, s_hi, cache):
    """Every run of the first two tiles of a split [s_lo, s_hi): the
    granules are aligned on both sides and inside the slot, no two copies
    share a byte, and every lane's chunk read is aligned to the layout's
    ``align``, inside the slot, and holds its row's values."""
    lay = params.decode_row_layout(d, itemsize)
    rb, e8 = lay.row_bytes, 8 * itemsize
    tile = lay.row_groups * lay.unroll
    assert e8 % lay.align == 0 and lay.run_bytes % 16 == 0
    if lay.exact:
        # Each thread's chunk by one cp.async of its own size: aligned in
        # the cache (rows of whole chunks) and in its warp's slot.
        assert rb % e8 == 0 and lay.run_bytes == 32 * e8
        for base in (s_lo, s_lo + tile):
            for u in range(lay.unroll):
                for l in range(base + u * lay.row_groups,
                               min(base + (u + 1) * lay.row_groups, s_hi)):
                    assert at(l) * rb % e8 == 0
        return
    for base in (s_lo, s_lo + tile):
        for u in range(lay.unroll):
            for w in range(params.DECODE_ATTEND_THREADS // 32):
                l0 = base + u * lay.row_groups + w * lay.run_rows
                if l0 >= s_hi:
                    continue
                l1 = min(l0 + lay.run_rows, s_hi)
                slot, off, writes = _copy_run(cache, at, run_end, granular,
                                              rb, l0, l1, lay.run_bytes)
                assert not lay.aligned or off == 0
                writes.sort()
                for (a, n), (b, _) in zip(writes, writes[1:]):
                    assert a + n <= b
                for j in range(l1 - l0):
                    start = off + j * rb
                    assert start % lay.align == 0
                    # The last chunk's 8 values end inside the slot.
                    assert start + lay.chunks * e8 <= lay.run_bytes
                    row = at(l0 + j) * rb
                    np.testing.assert_array_equal(slot[start:start + rb],
                                                  cache[row:row + rb])


@pytest.mark.parametrize("itemsize", [2, 1], ids=["bf16", "1-byte"])
@pytest.mark.parametrize("d", [7, 8, 13, 64, 80, 96, 100, 128, 250, 256,
                               300, 384, 500, 512])
def test_granules_put_each_row_where_its_lanes_read_it(d, itemsize):
    """A contiguous cache ([BH, L, D], L odd or even, the split starting
    at any row, a window's first row among them) and a paged one (pages of
    128 tokens, granular; of 3 and 24, whose bytes are not always a
    multiple of 16, byte by byte) under a shuffled page table."""
    rng = np.random.default_rng(d * itemsize)
    rb = d * itemsize
    for length in (257, 256):
        cache = rng.integers(0, 256, 4 * length * rb, dtype=np.uint8)
        for bh in (0, 3):
            for s_lo in (0, 1, 3, 7, 77):
                _check_runs(d, itemsize, lambda l: bh * length + l,
                            lambda l, hi: hi, True, s_lo, length, cache)
    for ps in (128, 3, 24):
        pages = rng.permutation(np.arange(1, 40))
        pool = rng.integers(0, 256, 41 * HKV * ps * rb, dtype=np.uint8)
        for h in (0, 1):
            def at(l, h=h):
                return (int(pages[l // ps]) * HKV + h) * ps + l % ps
            for s_lo in (0, 5, 130):
                _check_runs(d, itemsize, at,
                            lambda l, hi: min(hi, (l // ps + 1) * ps),
                            ps * rb % 16 == 0, s_lo, min(39 * ps, 600),
                            pool)


def _smem_by_hand(d, storage, gc, fused, q_bf16, table_ints):
    """launch_passes' shared memory written out: the ring (kStages = 3 of
    unroll rows: the run slots, then GC scores a row group (attend), then
    one scale a row group), the partial O it also holds, the row max, row
    sums, flag, page ids and K2's s_new / P scale. The tensor-core pair's
    rows are 128 values wide in shared memory at every D it takes up to
    128 but 64 (16-byte aligned bases: D 64's rows are whole granules),
    256 past 128, where a thread holds two chunks of its row, and 512
    past 256, where it holds four, so its row groups are those of that
    width, and the partial O holds D columns; over 1-byte storage both
    passes also hold the bf16 tile they widen the rows into. A CTA has
    256 threads, 128 at D <= 8 with query chunks of 8 and on the 256- and
    512-wide pair."""
    itemsize = torch.empty((), dtype=storage).element_size()
    pair = params.decode_tensor_cores(d, storage, q_bf16)
    width = (64 if d == 64 else 128 if d <= 128 else 256 if d <= 256
             else 512)
    t = 128 if (d <= 8 and gc == 8) or (pair and d > 128) else 256
    assert t == params.decode_threads(d, gc, "mma" if pair else "fma")
    nw = t // 32
    if pair:
        slots = t * max(1, width // 128)
        rg, chunk, unroll = slots // (width // 8), slots * 8 * itemsize, 8
        wide = 8 * slots * 16 if itemsize == 1 else 0
    else:
        lay = params.decode_row_layout(d, itemsize, t)
        rg, chunk, unroll, wide = (lay.row_groups, nw * lay.run_bytes,
                                   lay.unroll, 0)
    score = 3 * unroll * (chunk + 4 * rg) + wide + 4 * nw * gc + 4 * table_ints
    attend = max(3 * unroll * (chunk + 4 * rg * gc + 4 * rg) + wide,
                 nw * gc * d * 4)
    attend += 4 * (gc + nw * gc) + 4 + 4 * table_ints + (8 * gc if fused
                                                         else 0)
    return score, attend


@pytest.mark.parametrize("storage", list(STORAGE))
def test_smem_reckons_the_launch_code_and_fits_to_d512(storage):
    """decode_smem_bytes equals the launch code's sum, and every D up to
    512 at both query chunks fits the H100's 232,448 bytes (the FMA
    pair's partial O at D 512: 8 warps x 8 rows x 512 fp32, 131,072
    bytes; the pair's 256-wide bf16 ring: 3 x 8 x (256 chunks of 16
    bytes + 8 row groups' scores and scales) at 128 threads, ~103 KB,
    two CTAs an SM; its 512-wide one 3 x 8 x (512 chunks + 8 row groups)
    at 128 threads, ~199 KB, over 1-byte storage ~103 KB of chunks and a
    64 KB widened tile). D <= 8
    gives one lane a row: with 256 threads its
    256 row groups' scores at 8 query rows would overflow it, so those
    CTAs have 128 threads (decode_threads)."""
    dt = STORAGE[storage]
    for d in range(1, params.DECODE_MAX_HEAD_DIM + 1):
        for gc in (4, 8):
            for fused, q_bf16, table in ((False, True, 0), (True, True, 0),
                                         (False, False, 10)):
                got = params.decode_smem_bytes(d, dt, gc, fused=fused,
                                               q_bf16=q_bf16,
                                               table_ints=table)
                assert got == _smem_by_hand(d, dt, gc, fused, q_bf16, table)
                assert max(got) <= params.H100.smem_per_block, (d, gc, got)
    # 256 threads at D <= 8 and chunks of 8 would not fit.
    for d in range(1, 9):
        got = params.decode_smem_bytes(d, dt, 8, threads=256)
        assert max(got) > params.H100.smem_per_block
    # The kernel before's FMA layout at D 128 (int8, fp32 q): each
    # thread's chunk, 16 row groups; with bf16 q the tensor-core pair's
    # ring of the same chunks, and the bf16 tile it widens them into.
    assert params.decode_smem_bytes(128, torch.int8, 4, q_bf16=False)[0] == (
        3 * 8 * (256 * 8 + 16 * 4) + 4 * 8 * 4)
    assert params.decode_smem_bytes(128, torch.int8, 4)[0] == (
        3 * 8 * (256 * 8 + 16 * 4) + 8 * 256 * 16 + 4 * 8 * 4)
    assert params.decode_attend_union_bytes(512, 2, 8) == 8 * 8 * 512 * 4
    # The 512-wide pair at 128 threads: four chunks a thread, 8 row
    # groups; fp32 q keeps the FMA pair's layout.
    t = 128
    assert params.decode_smem_bytes(512, torch.bfloat16, 8)[1] == (
        3 * 8 * (4 * t * 16 + t // 16 * 8 * 4 + t // 16 * 4)
        + 4 * (8 + t // 32 * 8) + 4)
    assert params.decode_smem_bytes(384, torch.int8, 4)[0] == (
        3 * 8 * (4 * t * 8 + t // 16 * 4) + 8 * 4 * t * 16 + 4 * t // 32 * 4)
    assert params.decode_smem_bytes(512, torch.bfloat16, 8,
                                    q_bf16=False)[1] == (
        8 * 8 * 512 * 4 + 4 * (8 + 8 * 8) + 4)


FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)


@pytest.mark.parametrize("d", [64, 80, 96, 100, 112, 128])
def test_tensor_cores_take_bf16_from_d64_to_d128(d):
    """The pair runs bf16 q at 64 <= D <= 128 over every storage type
    (bf16; int8, fp8-e4m3 and fp8-e5m2 widened to bf16), for K2 (fused),
    K5 and K6 alike: decode_path names no kernel. fp32 q stays on FMA."""
    for storage in (*STORAGE.values(), torch.float8_e5m2):
        itemsize = torch.empty((), dtype=storage).element_size()
        granule = params.decode_granule(d, itemsize)
        assert granule >= 4
        assert params.decode_tensor_cores(d, storage, True)
        assert not params.decode_tensor_cores(d, storage, False)
        assert params.decode_path(d, storage, True) == f"mma/g{granule}"
        assert params.decode_path(d, storage, False) == (
            "fma/exact" if d in (64, 128) else "fma")
    # OpenLLaMA-3B's D 100: 100-byte rows in int8 and fp8 share 4 bytes.
    if d == 100:
        for storage in (torch.int8, *FP8):
            assert params.decode_path(d, storage, True) == "mma/g4"


ALL_STORAGE = (*STORAGE.values(), torch.float8_e5m2)


@pytest.mark.parametrize("d", [130, 136, 160, 192, 200, 250, 256])
def test_tensor_cores_take_bf16_past_d128(d):
    """Past D 128 up to 256 the pair runs bf16 q over every storage type
    whose rows and bases share a granule of 4 bytes or more, on rows
    padded to 256 values, for K2, K5 and K6 alike; at bases 4, 8 and 12
    bytes off 16 at the granule they leave, and at 2 bytes off (or rows
    only 2-byte aligned: D 130 and 250 over 1-byte storage) on FMA. fp32
    q stays on FMA."""
    for storage in ALL_STORAGE:
        itemsize = torch.empty((), dtype=storage).element_size()
        for shift in (0, 2, 4, 8, 12):
            if shift % itemsize:
                continue
            granule = params.decode_granule(d, itemsize, shift)
            on = params.decode_tensor_cores(d, storage, True, granule)
            assert on == (granule >= 4), (d, storage, shift)
            assert not params.decode_tensor_cores(d, storage, False, granule)
            path = params.decode_path(d, storage, True, granule)
            if on:
                assert path == f"mma/g{granule}"
                assert params.decode_mma_width(d, granule) == 256
            else:
                assert path.startswith("fma")
            assert params.decode_path(d, storage, False, granule).startswith(
                "fma")
        want = {"bf16": 16 if d * 2 % 16 == 0 else 8 if d * 2 % 8 == 0
                else 4, "byte": 16 if d % 16 == 0 else 8 if d % 8 == 0
                else 4 if d % 4 == 0 else 0}["bf16" if itemsize == 2
                                             else "byte"]
        assert params.decode_granule(d, itemsize) == want
        assert params.decode_tensor_cores(d, storage, True) == (want >= 4)
    # D 250: 500-byte bf16 rows share 4 bytes, 250-byte int8 and fp8 rows
    # only 2.
    if d == 250:
        assert params.decode_path(d, torch.bfloat16, True) == "mma/g4"
        for storage in (torch.int8, *FP8):
            assert params.decode_path(d, storage, True) == "fma"


@pytest.mark.parametrize("d", [258, 264, 300, 320, 384, 500, 512])
def test_tensor_cores_take_bf16_past_d256(d):
    """Past D 256 up to 512 the pair runs bf16 q over every storage type
    whose rows and bases share a granule of 4 bytes or more, on rows
    padded to 512 values, for K2, K5 and K6 alike; at bases 4, 8 and 12
    bytes off 16 at the granule they leave, and at 2 bytes off (or rows
    only 2-byte aligned: D 258 over 1-byte storage) on FMA. fp32 q stays
    on FMA. D 300 takes 8 bytes in bf16 and 4 over 1-byte storage, D 264
    and 500 likewise, D 258 4 in bf16."""
    for storage in ALL_STORAGE:
        itemsize = torch.empty((), dtype=storage).element_size()
        for shift in (0, 2, 4, 8, 12):
            if shift % itemsize:
                continue
            granule = params.decode_granule(d, itemsize, shift)
            on = params.decode_tensor_cores(d, storage, True, granule)
            assert on == (granule >= 4), (d, storage, shift)
            assert not params.decode_tensor_cores(d, storage, False, granule)
            path = params.decode_path(d, storage, True, granule)
            if on:
                assert path == f"mma/g{granule}"
                assert params.decode_mma_width(d, granule) == 512
                assert params.decode_threads(d, 8, path) == 128
            else:
                assert path.startswith("fma")
            assert params.decode_path(d, storage, False, granule).startswith(
                "fma")
            if shift == 2:
                assert not on
        rb = d * itemsize
        want = 16 if rb % 16 == 0 else 8 if rb % 8 == 0 else (
            4 if rb % 4 == 0 else 0)
        assert params.decode_granule(d, itemsize) == want
        assert params.decode_tensor_cores(d, storage, True) == (want >= 4)
    if d == 300:
        assert params.decode_path(d, torch.bfloat16, True) == "mma/g8"
        for storage in (torch.int8, *FP8):
            assert params.decode_path(d, storage, True) == "mma/g4"
    if d in (384, 512):
        for storage in ALL_STORAGE:
            assert params.decode_path(d, storage, True) == "mma/g16"
    if d == 258:
        assert params.decode_path(d, torch.bfloat16, True) == "mma/g4"
        assert params.decode_path(d, torch.int8, True) == "fma"


@pytest.mark.parametrize("d, storage", [
    (99, torch.bfloat16), (101, torch.bfloat16), (48, torch.bfloat16),
    (257, torch.bfloat16), (62, torch.bfloat16), (385, torch.bfloat16),
    (98, torch.float8_e4m3fn), (99, torch.float8_e5m2), (99, torch.int8),
    (63, torch.int8), (511, torch.float8_e5m2), (102, torch.int8),
    (250, torch.int8), (250, torch.float8_e4m3fn), (302, torch.int8)])
def test_tensor_cores_stay_off_outside_the_rule(d, storage):
    """Odd D (rows 2- or 1-byte aligned: D 257, 385, 511 as well), D <
    64 and 1-byte rows not a multiple of 4 bytes (D 250 and 302 over int8
    and fp8) run FMA, for every kernel, whatever the storage."""
    assert not params.decode_tensor_cores(d, storage, True)
    assert params.decode_path(d, storage, True).startswith("fma")


def test_granule_of_rows_and_bases():
    """The copy granule is the largest of 16, 8 and 4 bytes dividing the
    row bytes and both bases, worked out from real (CPU) cache views
    shifted off 16 bytes; a base 2 bytes off takes no granule, and then
    no tensor core, whatever the storage."""
    from mfa_tpu_torch.utils.testing import shifted_copy

    cases = [  # (D, storage, shift bytes, granule)
        (80, torch.bfloat16, 0, 16), (96, torch.bfloat16, 0, 16),
        (112, torch.bfloat16, 0, 16), (100, torch.bfloat16, 0, 8),
        (100, torch.float8_e4m3fn, 0, 4), (80, torch.float8_e5m2, 0, 16),
        (98, torch.bfloat16, 0, 4), (100, torch.bfloat16, 4, 4),
        (100, torch.bfloat16, 8, 8), (96, torch.bfloat16, 8, 8),
        (128, torch.bfloat16, 4, 4), (64, torch.float8_e4m3fn, 8, 8),
        (100, torch.float8_e4m3fn, 12, 4), (100, torch.bfloat16, 2, 0),
        (128, torch.bfloat16, 6, 0), (99, torch.bfloat16, 0, 0),
        (100, torch.int8, 0, 4), (128, torch.int8, 0, 16),
        (128, torch.int8, 4, 4), (96, torch.int8, 8, 8),
        (100, torch.int8, 2, 0), (99, torch.int8, 0, 0)]
    for d, storage, shift, want in cases:
        rows = torch.zeros((3, 7, d), dtype=torch.float32).to(storage)
        k, v = shifted_copy(rows, shift), shifted_copy(rows, 0)
        assert k.data_ptr() % 16 == shift
        got = params.decode_granule(d, k.element_size(), k.data_ptr(),
                                    v.data_ptr())
        assert got == want, (d, storage, shift, got)
        on = params.decode_tensor_cores(d, storage, True, got)
        assert on == (want >= 4)
        path = params.decode_path(d, storage, True, got)
        if on:
            assert path == f"mma/g{want}"
        else:
            assert path.startswith("fma")


@pytest.mark.parametrize("itemsize", [2, 1], ids=["bf16", "fp8"])
def test_padded_rows_copy_each_live_byte_once_at_its_granule(itemsize):
    """The pair's copies of a padded row (decode_split.cuh::copy_live;
    past D 128 at the launch's granule (at_granule), a thread's chunks cc
    + 16 k, k < 2, and past D 256 k < 4): the thread of chunk cc copies
    bytes [0, lb) of it, lb =
    (D - 8 cc) E clamped to [0, 8 E], in copies of the granule GR (at
    most 8 for fp8's 8-byte chunks). For every D the pair takes, every
    row start at the
    granule's alignment and every base shift it allows, each copy is
    aligned to GR in the cache and in its 16-byte slot, the copies cover
    the row's bytes exactly once, and the bytes past D (zeroed once a
    CTA) are never written."""
    storage = torch.bfloat16 if itemsize == 2 else torch.float8_e4m3fn
    chunk = 8 * itemsize
    for d in range(64, 513):
        for shift in (0, 4, 8, 12):
            g = params.decode_granule(d, itemsize, shift)
            if not params.decode_tensor_cores(d, storage, True, g):
                continue
            gr = min(g, chunk)
            width = params.decode_mma_width(d, g)
            assert width in (64, 128, 256, 512) and width >= d
            assert (width == 256) == (128 < d <= 256)
            assert (width == 512) == (d > 256)
            # Past DD 128 16 threads take a row, each its chunks cc + 16
            # k, k < decode_mma_chunks.
            assert width <= 128 or (
                width // 8 == 16 * params.decode_mma_chunks(width))
            for row in (0, 1, 7, 1000):
                start = shift + row * d * itemsize
                covered = []
                for cc in range(width // 8):
                    lb = min(chunk, max(0, (d - 8 * cc) * itemsize))
                    assert lb % gr == 0
                    for j in range(0, lb, gr):
                        src = start + cc * chunk + j
                        assert src % gr == 0 and j % gr == 0
                        covered.extend(range(src, src + gr))
                assert covered == list(range(start, start + d * itemsize))


@pytest.mark.parametrize("d, shift", [(64, 8), (128, 4), (100, 0),
                                      (100, 4), (80, 0), (192, 8),
                                      (256, 4), (250, 0), (300, 0),
                                      (384, 4), (512, 8)])
def test_smem_of_the_padded_pair_at_shifted_bases(d, shift):
    """Off 16 bytes, D 64 and 128 run the 128-wide padded instances: the
    shared memory is that of 16 row groups (the partial O of D columns
    stays under the ring). Past D 128 every base runs the 256-wide
    instance, past D 256 the 512-wide one, whose granule is read at run
    time: the same shared memory at any shift."""
    g = params.decode_granule(d, 2, shift)
    for gc in (4, 8):
        for fused in (False, True):
            got = params.decode_smem_bytes(d, torch.bfloat16, gc,
                                           fused=fused, granule=g)
            if params.decode_mma_width(d, g) == 128:
                assert got == _smem_by_hand(100, torch.bfloat16, gc, fused,
                                            True, 0)
            if d > 128:
                assert params.decode_mma_width(d, g) == (256 if d <= 256
                                                         else 512)
                assert got == _smem_by_hand(d, torch.bfloat16, gc, fused,
                                            True, 0)
            assert max(got) <= params.H100.smem_per_block
