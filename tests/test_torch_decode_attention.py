"""Port decode_attention (the plain version of K5 on the CPU) against
mfa_tpu's (Pallas kernels in interpret mode) over the same cache, for
bf16, INT8, FP8-e4m3 and FP8-e5m2 storage, lengths including 0 and
capacity, a window, and one cache long enough for mfa_tpu's multi-block
kernel; and K2 with an FP8-e5m2 cache against mfa_tpu's
decode_attention_append."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.ops.decode import decode_attention as jax_decode
from mfa_tpu.ops.decode import decode_attention_append as jax_decode_append
from mfa_tpu.ops.precision import OperandPrecision as JPrec
from mfa_tpu.serving import kv_cache as jax_kv
from mfa_tpu_torch.kernels import decode as k5
from mfa_tpu_torch.ops.decode import decode_attention, decode_attention_append
from mfa_tpu_torch.ops.precision import OperandPrecision
from mfa_tpu_torch.serving import kv_cache
from mfa_tpu_torch.utils.testing import assert_close

HQ, HKV, D = 8, 2, 64
# Budgets against mfa_tpu (ops/precision.py): mixed 5e-2 for bf16, 6e-2
# for quantized storage. At these cache sizes mfa_tpu takes its
# single-block kernel, which requantizes q and P to int8 for an INT8
# cache; the port does not (Hopper converts int8 natively). Both lie
# within 6e-2 of the exact answer, so the INT8 budget holds them to each
# other. mfa_tpu widens fp8 subnormals to about +-2^-7, the port exactly.
FORMATS = {
    "bf16": (JPrec.BF16, OperandPrecision.BF16, 5e-2),
    "int8": (JPrec.INT8, OperandPrecision.INT8, 6e-2),
    "fp8_e4m3": (JPrec.FP8_E4M3, OperandPrecision.FP8_E4M3, 6e-2),
    "fp8_e5m2": (JPrec.FP8_E5M2, OperandPrecision.FP8_E5M2, 6e-2),
}


def _filled(rng, jprec, tprec, lengths, max_len):
    """Both caches filled with the same rows; mfa_tpu's under jax.jit,
    whose quantizer the port follows (kernels/quant.py)."""
    b = len(lengths)
    fill = rng.standard_normal((2, b, HKV, max_len, D)).astype(np.float32)
    jc = jax.jit(jax_kv.update)(jax_kv.create(b, HKV, max_len, D, jprec),
                                jnp.asarray(fill[0]), jnp.asarray(fill[1]))
    jc = dataclasses.replace(jc, lengths=jnp.asarray(lengths, jnp.int32))
    tc = kv_cache.update(
        kv_cache.create(b, HKV, max_len, D, tprec, device="cpu"),
        torch.from_numpy(fill[0]), torch.from_numpy(fill[1]))
    tc.lengths = torch.tensor(lengths, dtype=torch.int32)
    for f in ("k", "v"):
        np.testing.assert_array_equal(
            getattr(tc, f).float().numpy(),
            np.asarray(getattr(jc, f).astype(jnp.float32))[..., :D])
    return jc, tc


@pytest.mark.parametrize("name,window", [(n, None) for n in FORMATS]
                         + [("bf16", 64), ("fp8_e5m2", 64)])
def test_decode_attention_matches_mfa_tpu(name, window):
    jprec, tprec, tol = FORMATS[name]
    rng = np.random.default_rng(21)
    lengths = [0, 300, 37, 512]          # empty, unaligned, short, full
    jc, tc = _filled(rng, jprec, tprec, lengths, 512)
    q = rng.standard_normal((len(lengths), HQ, D)).astype(np.float32)
    o_j = jax_decode(jnp.asarray(q, jnp.bfloat16), jc, sliding_window=window)
    o_t = decode_attention(torch.from_numpy(q).bfloat16(), tc,
                           sliding_window=window, device="cpu")
    assert o_t.dtype == torch.bfloat16 and o_t.shape == q.shape
    assert_close(o_t, np.asarray(o_j, np.float32), tol,
                 f"O ({name}, window {window})")
    assert torch.equal(o_t[0], torch.zeros_like(o_t[0]))   # length 0


def test_decode_attention_multi_block_matches_mfa_tpu():
    """A bf16 cache of 4224 rows: past mfa_tpu's single-block budget (4096
    rows of bf16 K and V at D 128), so it runs its online-softmax kernel
    over two blocks; the port's K5 has no such switch."""
    rng = np.random.default_rng(22)
    jc, tc = _filled(rng, JPrec.BF16, OperandPrecision.BF16, [4150], 4224)
    q = rng.standard_normal((1, 4, D)).astype(np.float32)
    hkv_one = dataclasses.replace(
        jc, k=jc.k[:, :1], v=jc.v[:, :1], k_scale=jc.k_scale[:, :1],
        v_scale=jc.v_scale[:, :1])
    tc_one = kv_cache.KVCache(tc.k[:, :1].contiguous(),
                              tc.v[:, :1].contiguous(),
                              tc.k_scale[:, :1].contiguous(),
                              tc.v_scale[:, :1].contiguous(), tc.lengths,
                              tc.precision)
    o_j = jax_decode(jnp.asarray(q, jnp.bfloat16), hkv_one)
    o_t = decode_attention(torch.from_numpy(q).bfloat16(), tc_one,
                           device="cpu")
    assert_close(o_t, np.asarray(o_j, np.float32), 5e-2, "O multi-block")


def test_decode_attention_fp32_matches_mfa_tpu():
    """fp32 queries over a bf16 cache round nothing: the fp32 budget."""
    rng = np.random.default_rng(23)
    jc, tc = _filled(rng, JPrec.BF16, OperandPrecision.BF16, [5, 128], 128)
    q = rng.standard_normal((2, HQ, D)).astype(np.float32)
    o_j = jax_decode(jnp.asarray(q), jc)
    o_t = decode_attention(torch.from_numpy(q), tc, device="cpu")
    assert_close(o_t, np.asarray(o_j), 2e-5, "O fp32")


def test_decode_attention_after_update_equals_fused_append():
    """update() then decode_attention reads the appended row back in its
    stored form; the fused K2 path takes the unquantized one. In bf16 with
    fp32 queries the two agree to the row's bf16 rounding."""
    rng = np.random.default_rng(24)
    b, max_len = 2, 64
    fill = torch.from_numpy(rng.standard_normal((2, b, HKV, 20, D)).astype(
        np.float32)).bfloat16().float()
    q = torch.from_numpy(rng.standard_normal((b, HQ, D)).astype(np.float32))
    kn, vn = torch.from_numpy(rng.standard_normal((2, b, HKV, D)).astype(
        np.float32)).bfloat16().float()
    caches = [kv_cache.update(kv_cache.create(b, HKV, max_len, D,
                                              device="cpu"), *fill)
              for _ in range(2)]
    o_fused, _ = decode_attention_append(q, kn, vn, caches[0], device="cpu")
    kv_cache.update(caches[1], kn[:, :, None], vn[:, :, None])
    o_unfused = decode_attention(q, caches[1], device="cpu")
    assert_close(o_unfused, o_fused, 2e-5, "O update + decode vs fused")


def test_fused_append_e5m2_matches_mfa_tpu():
    """K2 takes FP8-e5m2 caches: appended rows and scales equal mfa_tpu's
    (maxq 57344), O within the quantized budget, over three steps."""
    rng = np.random.default_rng(25)
    lengths = [0, 300, 511]
    jc, tc = _filled(rng, JPrec.FP8_E5M2, OperandPrecision.FP8_E5M2,
                     lengths, 512)
    for step in range(3):
        q = rng.standard_normal((3, HQ, D)).astype(np.float32)
        kn = (rng.standard_normal((3, HKV, D)) * 0.5).astype(np.float32)
        vn = (rng.standard_normal((3, HKV, D)) * 0.5).astype(np.float32)
        o_j, jc = jax_decode_append(jnp.asarray(q, jnp.bfloat16),
                                    jnp.asarray(kn, jnp.bfloat16),
                                    jnp.asarray(vn, jnp.bfloat16), jc)
        o_t, tc = decode_attention_append(
            torch.from_numpy(q).bfloat16(), torch.from_numpy(kn).bfloat16(),
            torch.from_numpy(vn).bfloat16(), tc, device="cpu")
        for f in ("k", "v"):
            np.testing.assert_array_equal(
                getattr(tc, f).float().numpy(),
                np.asarray(getattr(jc, f).astype(jnp.float32))[..., :D])
            np.testing.assert_allclose(
                getattr(tc, f"{f}_scale").numpy(),
                np.asarray(getattr(jc, f"{f}_scale"))[:, :, 0, :], rtol=1e-6)
        assert_close(o_t, np.asarray(o_j, np.float32), 6e-2,
                     f"O step {step} (fp8_e5m2)")
    assert tc.lengths.tolist() == [3, 303, 512]
    assert k5.KV_FORMATS[torch.float8_e5m2] == 3


def test_kernel_wrapper_refuses_bad_operands():
    q3 = torch.zeros(2, 4, 32, dtype=torch.bfloat16)
    k = torch.zeros(2, 64, 32, dtype=torch.int8)
    s = torch.ones(2, 64)
    lengths = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError, match="lengths"):
        k5.decode_attend(q3, k, k, s, s, lengths.long(), num_kv_heads=1)
    with pytest.raises(ValueError, match="scales"):
        k5.decode_attend(q3, k, k, s[:, :8], s, lengths, num_kv_heads=1)
    with pytest.raises(TypeError, match="share one dtype"):
        k5.decode_attend(q3, k, k.bfloat16(), s, s, lengths, num_kv_heads=1)
    with pytest.raises(ValueError, match="sliding_window"):
        k5.decode_attend(q3, k, k, s, s, lengths, num_kv_heads=1,
                         sliding_window=0)
    out = torch.full_like(q3, float("nan"))
    o = k5.decode_attend(q3, k, k, s, s, lengths, num_kv_heads=1, out=out)
    assert o is out and torch.equal(out, torch.zeros_like(out))
