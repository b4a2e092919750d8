"""Port PagedKVCache and paged_decode_attention (the plain version of K6
on the CPU) against mfa_tpu's (Pallas kernel in interpret mode), on the
same numpy inputs: page allocation and tables after the same uneven
appends, pool contents, and attention over the same pool for bf16, INT8,
FP8-e4m3 and FP8-e5m2 storage."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.ops.decode import paged_decode_attention as jax_paged_attention
from mfa_tpu.ops.precision import OperandPrecision as JPrec
from mfa_tpu.serving import paged_kv_cache as jax_paged
from mfa_tpu_torch.kernels import paged_decode as k6
from mfa_tpu_torch.ops.decode import paged_decode_attention
from mfa_tpu_torch.ops.precision import OperandPrecision
from mfa_tpu_torch.serving.paged_kv_cache import (
    PAGE_SIZE,
    PagedKVCache,
    PagePool,
    splice_pages,
)
from mfa_tpu_torch.utils.testing import assert_close

HQ, HKV, D = 8, 2, 64
LENS = [200, 391, 0]
CHUNKS = (7, 130, 64, 10_000)      # uneven appends across page boundaries
# Budgets against mfa_tpu (ops/precision.py): bf16 storage and queries are
# the mixed budget 5e-2; quantized storage 6e-2 (mfa_tpu widens fp8
# subnormals to about +-2^-7, the port exactly).
FORMATS = {
    "bf16": (JPrec.BF16, OperandPrecision.BF16, 5e-2),
    "int8": (JPrec.INT8, OperandPrecision.INT8, 6e-2),
    "fp8_e4m3": (JPrec.FP8_E4M3, OperandPrecision.FP8_E4M3, 6e-2),
    "fp8_e5m2": (JPrec.FP8_E5M2, OperandPrecision.FP8_E5M2, 6e-2),
}


def _to_torch(a, dtype: torch.dtype) -> torch.Tensor:
    """A JAX array as a torch tensor of ``dtype``, bit for bit."""
    a = np.array(a)
    if a.dtype.itemsize == 2 and dtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if a.dtype.itemsize == 1 and dtype != torch.int8:
        return torch.from_numpy(a.view(np.uint8)).view(dtype)
    return torch.from_numpy(a)


def _build(rng, jprec, tprec, lens=LENS, num_pages=64, max_len=1024):
    """Both caches after the same uneven appends of the same rows."""
    jc = jax_paged.PagedKVCache(num_pages, HKV, D, len(lens), max_len, jprec)
    tc = PagedKVCache(num_pages, HKV, D, len(lens), max_len, tprec,
                      device="cpu")
    for s, ln in enumerate(lens):
        k = rng.standard_normal((HKV, ln, D)).astype(np.float32)
        v = rng.standard_normal((HKV, ln, D)).astype(np.float32)
        off = 0
        for chunk in CHUNKS:
            n = min(chunk, ln - off)
            if n <= 0:
                break
            jc.append(s, jnp.asarray(k[:, off:off + n]),
                      jnp.asarray(v[:, off:off + n]))
            tc.append(s, torch.from_numpy(k[:, off:off + n]),
                      torch.from_numpy(v[:, off:off + n]))
            off += n
    return jc, tc


def _copy_pool(jc, tc):
    """Make the port's pool hold mfa_tpu's bytes (its head dim unpadded,
    its scales without the lane axis)."""
    dt = tc.pool.k_pages.dtype
    for name in ("k_pages", "v_pages"):
        getattr(tc.pool, name).copy_(
            _to_torch(getattr(jc.pool, name)[..., :D], dt))
    for name in ("k_scale", "v_scale"):
        getattr(tc.pool, name).copy_(
            _to_torch(getattr(jc.pool, name)[:, :, 0, :], torch.float32))


@pytest.mark.parametrize("name", list(FORMATS))
def test_tables_and_pool_match_mfa_tpu(name):
    jprec, tprec, _ = FORMATS[name]
    jc, tc = _build(np.random.default_rng(1), jprec, tprec)
    np.testing.assert_array_equal(tc.page_tables, jc.page_tables)
    np.testing.assert_array_equal(tc.lengths, jc.lengths)
    assert tc.free_pages == jc.free_pages
    # mfa_tpu's append quantizes eagerly (amax / qmax), the port as under
    # jax.jit (amax * fp32(1/qmax)): scales agree within an ulp, values
    # within one quantization step.
    for f in ("k", "v"):
        js = np.asarray(getattr(jc.pool, f"{f}_scale"))[:, :, 0, :]
        ts = getattr(tc.pool, f"{f}_scale").numpy()
        np.testing.assert_allclose(ts, js, rtol=2.5e-7, atol=0)
        jv = np.asarray(getattr(jc.pool, f"{f}_pages").astype(jnp.float32))
        tv = getattr(tc.pool, f"{f}_pages").float().numpy()
        jv = jv[..., :D]
        if name == "int8":
            step = 1.0
        else:       # one fp8 step: (min normal or |x|) * 2^-mantissa bits
            tiny, rel = ((2.0 ** -6, 2.0 ** -3) if name == "fp8_e4m3"
                         else (2.0 ** -14, 2.0 ** -2))
            step = np.maximum(np.abs(jv), tiny) * rel
        assert np.all(np.abs(tv - jv) <= step)
        if name == "bf16":
            np.testing.assert_array_equal(tv, jv)


@pytest.mark.parametrize("name", ["int8", "fp8_e4m3", "fp8_e5m2"])
def test_splice_pages_matches_jitted_mfa_tpu(name):
    """The bulk page write stores mfa_tpu's jitted splice_pages bits."""
    jprec, tprec, _ = FORMATS[name]
    ps, n = PAGE_SIZE, 3
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, HKV, n * ps, D)).astype(np.float32)
    ids = np.array([5, 2, 7], np.int32)
    jpool = jax_paged.PagedKVCache(8, HKV, D, 1, 1024, jprec).pool
    pad = ((0, 0), (0, 0), (0, 128 - D))
    jpool = jax.jit(jax_paged.splice_pages)(
        jpool, jnp.asarray(ids), jnp.pad(jnp.asarray(x[0]), pad),
        jnp.pad(jnp.asarray(x[1]), pad))
    tpool = splice_pages(PagePool.create(8, HKV, D, ps, tprec, device="cpu"),
                         torch.from_numpy(ids).long(),
                         torch.from_numpy(x[0]), torch.from_numpy(x[1]))
    for f in ("k", "v"):
        want = _to_torch(getattr(jpool, f"{f}_pages")[..., :D],
                         tpool.k_pages.dtype)
        got = getattr(tpool, f"{f}_pages")
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8)), f
        np.testing.assert_array_equal(
            getattr(tpool, f"{f}_scale").numpy(),
            np.asarray(getattr(jpool, f"{f}_scale"))[:, :, 0, :])


@pytest.mark.parametrize("name,window", [(n, None) for n in FORMATS]
                         + [("bf16", 100), ("int8", 100)])
def test_paged_decode_attention_matches_mfa_tpu(name, window):
    jprec, tprec, tol = FORMATS[name]
    rng = np.random.default_rng(3)
    jc, tc = _build(rng, jprec, tprec)
    _copy_pool(jc, tc)
    q = rng.standard_normal((len(LENS), HQ, D)).astype(np.float32)
    o_j = jax_paged_attention(jnp.asarray(q, jnp.bfloat16), jc,
                              sliding_window=window)
    o_t = paged_decode_attention(torch.from_numpy(q).bfloat16(), tc,
                                 sliding_window=window, device="cpu")
    assert o_t.dtype == torch.bfloat16 and o_t.shape == (len(LENS), HQ, D)
    assert_close(o_t, np.asarray(o_j, np.float32), tol,
                 f"paged O ({name}, window {window})")
    assert torch.equal(o_t[2], torch.zeros_like(o_t[2]))   # length 0


def test_paged_decode_fp32_matches_mfa_tpu():
    """fp32 queries over a bf16 pool: no P rounding on either side, so the
    fp32 budget (2e-5) holds."""
    jc, tc = _build(np.random.default_rng(4), JPrec.BF16,
                    OperandPrecision.BF16)
    q = np.random.default_rng(5).standard_normal(
        (len(LENS), HQ, D)).astype(np.float32)
    o_j = jax_paged_attention(jnp.asarray(q), jc)
    o_t = paged_decode_attention(torch.from_numpy(q), tc, device="cpu")
    assert_close(o_t, np.asarray(o_j), 2e-5, "paged O fp32")


def test_page_allocation_and_free():
    cache = PagedKVCache(num_pages=8, num_kv_heads=1, head_dim=32,
                         num_seqs=2, max_len=512, device="cpu")
    assert cache.free_pages == 7          # page 0 reserved
    k = torch.ones(1, 300, 32)
    cache.append(0, k, k)
    assert cache.pages_in_use(0) == 3     # ceil(300 / 128)
    assert cache.free_pages == 4
    assert 0 not in cache.page_tables[0, :3]
    cache.free_seq(0)
    assert cache.free_pages == 7
    assert int(cache.lengths[0]) == 0
    assert not cache.page_tables.any()


def test_pool_exhaustion():
    cache = PagedKVCache(num_pages=3, num_kv_heads=1, head_dim=32,
                         num_seqs=1, max_len=1024, device="cpu")
    k = torch.ones(1, PAGE_SIZE * 2, 32)
    cache.append(0, k, k)                 # uses both free pages
    with pytest.raises(MemoryError, match="exhausted"):
        cache.append(0, torch.ones(1, 1, 32), torch.ones(1, 1, 32))


def test_max_len_guard_and_page_size_rule():
    cache = PagedKVCache(num_pages=16, num_kv_heads=1, head_dim=32,
                         num_seqs=1, max_len=256, device="cpu")
    with pytest.raises(ValueError, match="exceeds max_len"):
        cache.append(0, torch.ones(1, 300, 32), torch.ones(1, 300, 32))
    with pytest.raises(ValueError, match="multiple of 128"):
        PagedKVCache(4, 1, 32, 1, 256, page_size=96, device="cpu")


def test_page_reuse_no_stale_data():
    """Free then reuse: the new sequence must not see the old pages."""
    rng = np.random.default_rng(6)
    cache = PagedKVCache(num_pages=8, num_kv_heads=1, head_dim=32,
                         num_seqs=1, max_len=512, device="cpu")
    k1 = torch.full((1, 130, 32), 7.0)
    cache.append(0, k1, k1)
    cache.free_seq(0)
    k2 = torch.from_numpy(rng.standard_normal((1, 40, 32)).astype(np.float32))
    v2 = torch.from_numpy(rng.standard_normal((1, 40, 32)).astype(np.float32))
    cache.append(0, k2, v2)
    q = torch.from_numpy(rng.standard_normal((1, 1, 32)).astype(np.float32))
    o = paged_decode_attention(q, cache, device="cpu")
    # The pool holds bf16 rows; fp32 queries round nothing else.
    kb, vb = k2[0].bfloat16().float(), v2[0].bfloat16().float()
    p = torch.softmax(q[0] @ kb.T / 32 ** 0.5, dim=-1)
    assert_close(o[0], p @ vb, 2e-5, "paged O after reuse")


def test_null_page_and_splice_prefill():
    """An empty table reads only the null page; splice_prefill fills a fresh
    sequence like append does."""
    rng = np.random.default_rng(7)
    cache = PagedKVCache(num_pages=6, num_kv_heads=HKV, head_dim=D,
                         num_seqs=2, max_len=512, device="cpu")
    x = torch.from_numpy(rng.standard_normal((2, HKV, 150, D)).astype(
        np.float32))
    cache.splice_prefill(0, x[0], x[1])
    assert cache.pages_in_use(0) == 2 and int(cache.lengths[0]) == 150
    ref = PagedKVCache(num_pages=6, num_kv_heads=HKV, head_dim=D,
                       num_seqs=2, max_len=512, device="cpu")
    ref.append(0, x[0], x[1])
    for f in ("k_pages", "v_pages"):
        assert torch.equal(getattr(cache.pool, f)[1:3, :, :, :],
                           getattr(ref.pool, f)[1:3, :, :, :])
    with pytest.raises(ValueError, match="fresh"):
        cache.splice_prefill(0, x[0], x[1])
    # Sequence 1 has length 1 through an all-zero table: the null page's
    # row 0 is its only key, and the answer is that row's V.
    cache.pool.v_pages[0, :, 0] = 3.0
    cache.lengths[1] = 1
    q = torch.zeros(2, HQ, D)
    o = paged_decode_attention(q, cache, device="cpu")
    assert torch.equal(o[1], torch.full((HQ, D), 3.0))


def test_kernel_wrapper_refuses_bad_operands():
    pool = PagePool.create(4, 2, 16, 128, device="cpu")
    q3 = torch.zeros(4, 2, 16)
    tables = torch.zeros(2, 3, dtype=torch.int32)
    lengths = torch.zeros(2, dtype=torch.int32)
    args = (pool.k_pages, pool.v_pages, pool.k_scale, pool.v_scale)
    with pytest.raises(TypeError, match="tables"):
        k6.paged_decode(q3, *args, tables.long(), lengths)
    with pytest.raises(ValueError, match="sequences"):
        k6.paged_decode(q3[:2], *args, tables, lengths)
    with pytest.raises(ValueError, match="scales"):
        k6.paged_decode(q3, pool.k_pages, pool.v_pages, pool.k_scale[..., :8],
                        pool.v_scale, tables, lengths)
    with pytest.raises(ValueError, match="sliding_window"):
        k6.paged_decode(q3, *args, tables, lengths, sliding_window=0)
