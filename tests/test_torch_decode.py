"""Port decode_attention_append (plain version of K2 on the CPU) against
mfa_tpu's (fused Pallas kernel in interpret mode), for bf16, INT8 and
FP8-e4m3 caches filled through each side's own update()."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.ops.decode import decode_attention_append as jax_decode_append
from mfa_tpu.ops.precision import OperandPrecision as JPrec
from mfa_tpu.serving import kv_cache as jax_kv
from mfa_tpu_torch.kernels.decode import decode_fused_append
from mfa_tpu_torch.ops.decode import decode_attention_append
from mfa_tpu_torch.ops.precision import OperandPrecision
from mfa_tpu_torch.serving import kv_cache
from mfa_tpu_torch.utils.testing import (
    assert_close,
    decode_fp64,
    rounding_steps,
)

B, HQ, HKV, D, MAX_LEN = 3, 8, 2, 64, 512
# 0 (empty slot: only the new token is live), unaligned, and one short of
# capacity: the second step fills it, the third is capped.
LENGTHS = [0, 300, MAX_LEN - 1]
PRECISIONS = {
    "bf16": (JPrec.BF16, OperandPrecision.BF16, 2e-2),
    "int8": (JPrec.INT8, OperandPrecision.INT8, 6e-2),
    "fp8_e4m3": (JPrec.FP8_E4M3, OperandPrecision.FP8_E4M3, 6e-2),
}


def _filled(rng, jprec, tprec, window=None, hkv=HKV):
    fill = max(LENGTHS)
    k_all = rng.standard_normal((B, hkv, fill, D)).astype(np.float32)
    v_all = rng.standard_normal((B, hkv, fill, D)).astype(np.float32)
    # Under jit, as mfa_tpu's prefill runs it: XLA computes the scale as
    # amax * (1 / qmax), which the port follows (kernels/quant.py).
    jc = jax.jit(jax_kv.update)(jax_kv.create(B, hkv, MAX_LEN, D, jprec),
                                jnp.asarray(k_all), jnp.asarray(v_all))
    jc = dataclasses.replace(jc, lengths=jnp.asarray(LENGTHS, jnp.int32))
    tc = kv_cache.update(
        kv_cache.create(B, hkv, MAX_LEN, D, tprec, device="cpu"),
        torch.from_numpy(k_all), torch.from_numpy(v_all))
    tc.lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    return jc, tc


def _assert_same_cache(jc, tc):
    for f in ("k", "v"):
        a = np.asarray(getattr(jc, f).astype(jnp.float32))[..., :D]
        np.testing.assert_array_equal(getattr(tc, f).float().numpy(), a,
                                      err_msg=f)
    for f in ("k_scale", "v_scale"):
        a = np.asarray(getattr(jc, f))[:, :, 0, :]
        np.testing.assert_allclose(getattr(tc, f).numpy(), a, rtol=1e-6,
                                   err_msg=f)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))


@pytest.mark.parametrize("name", list(PRECISIONS))
def test_decode_append_matches_mfa_tpu(name):
    jprec, tprec, tol = PRECISIONS[name]
    rng = np.random.default_rng(11)
    jc, tc = _filled(rng, jprec, tprec)
    _assert_same_cache(jc, tc)
    for step in range(3):
        q = rng.standard_normal((B, HQ, D)).astype(np.float32)
        kn = (rng.standard_normal((B, HKV, D)) * 0.5).astype(np.float32)
        vn = (rng.standard_normal((B, HKV, D)) * 0.5).astype(np.float32)
        o_j, jc = jax_decode_append(jnp.asarray(q, jnp.bfloat16),
                                    jnp.asarray(kn, jnp.bfloat16),
                                    jnp.asarray(vn, jnp.bfloat16), jc)
        o_t, tc = decode_attention_append(
            torch.from_numpy(q).bfloat16(), torch.from_numpy(kn).bfloat16(),
            torch.from_numpy(vn).bfloat16(), tc, device="cpu")
        assert o_t.dtype == torch.bfloat16
        assert torch.isfinite(o_t.float()).all()
        _assert_same_cache(jc, tc)
        assert_close(o_t, np.asarray(o_j, np.float32), tol,
                     f"O step {step} ({name})")
    assert tc.lengths.tolist() == [3, 303, MAX_LEN]


@pytest.mark.parametrize("name", ["bf16", "int8"])
def test_decode_append_sliding_window_matches_mfa_tpu(name):
    jprec, tprec, tol = PRECISIONS[name]
    rng = np.random.default_rng(12)
    jc, tc = _filled(rng, jprec, tprec)
    q = rng.standard_normal((B, HQ, D)).astype(np.float32)
    kn = (rng.standard_normal((B, HKV, D)) * 0.5).astype(np.float32)
    vn = (rng.standard_normal((B, HKV, D)) * 0.5).astype(np.float32)
    o_j, jc = jax_decode_append(jnp.asarray(q, jnp.bfloat16),
                                jnp.asarray(kn, jnp.bfloat16),
                                jnp.asarray(vn, jnp.bfloat16), jc,
                                sliding_window=64)
    o_t, tc = decode_attention_append(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(kn).bfloat16(),
        torch.from_numpy(vn).bfloat16(), tc, sliding_window=64,
        device="cpu")
    _assert_same_cache(jc, tc)
    assert_close(o_t, np.asarray(o_j, np.float32), tol, "O window")


@pytest.mark.parametrize("name", ["bf16", "int8"])
def test_decode_append_group_16_matches_mfa_tpu(name):
    """Hq / Hkv = 16: two of the kernel's query chunks on the card (its
    group limit of 8 is gone); mfa_tpu's fused kernel takes the whole
    group in one block. Two steps, the second under a window."""
    jprec, tprec, tol = PRECISIONS[name]
    rng = np.random.default_rng(13)
    hkv, hq = 1, 16
    jc, tc = _filled(rng, jprec, tprec, hkv=hkv)
    for step, window in enumerate((None, 100)):
        q = rng.standard_normal((B, hq, D)).astype(np.float32)
        kn = (rng.standard_normal((B, hkv, D)) * 0.5).astype(np.float32)
        vn = (rng.standard_normal((B, hkv, D)) * 0.5).astype(np.float32)
        o_j, jc = jax_decode_append(jnp.asarray(q, jnp.bfloat16),
                                    jnp.asarray(kn, jnp.bfloat16),
                                    jnp.asarray(vn, jnp.bfloat16), jc,
                                    sliding_window=window)
        o_t, tc = decode_attention_append(
            torch.from_numpy(q).bfloat16(), torch.from_numpy(kn).bfloat16(),
            torch.from_numpy(vn).bfloat16(), tc, sliding_window=window,
            device="cpu")
        _assert_same_cache(jc, tc)
        assert_close(o_t, np.asarray(o_j, np.float32), tol,
                     f"O step {step} ({name}, G 16)")
    assert tc.lengths.tolist() == [2, 302, MAX_LEN]


def test_empty_slot_attends_only_the_new_token():
    """Length 0: the new token's V is the whole answer."""
    rng = np.random.default_rng(3)
    tc = kv_cache.create(1, 1, 128, 32, OperandPrecision.INT8, device="cpu")
    q = torch.from_numpy(rng.standard_normal((1, 2, 32)).astype(np.float32))
    kn = torch.from_numpy(rng.standard_normal((1, 1, 32)).astype(np.float32))
    vn = torch.from_numpy(rng.standard_normal((1, 1, 32)).astype(np.float32))
    o, tc = decode_attention_append(q, kn, vn, tc, device="cpu")
    assert_close(o, vn.expand(1, 2, 32), 1e-6, "O")
    assert tc.lengths.tolist() == [1]


def test_kernel_wrapper_refuses_bad_operands():
    q3 = torch.zeros(2, 4, 32, dtype=torch.bfloat16)
    k = torch.zeros(2, 64, 32, dtype=torch.int8)
    s = torch.ones(2, 64)
    kn = torch.zeros(2, 32, dtype=torch.bfloat16)
    lengths = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError, match="lengths"):
        decode_fused_append(q3, k, k, s, s, kn, kn, lengths.long(),
                            num_kv_heads=1)
    with pytest.raises(ValueError, match="scales"):
        decode_fused_append(q3, k, k, s[:, :8], s, kn, kn, lengths,
                            num_kv_heads=1)


@pytest.mark.parametrize("fmt", ["int8", "fp8_e4m3"])
def test_quantizers_match_jitted_mfa_tpu(fmt):
    """Per-row quantization is bit-equal to mfa_tpu's quantizers as jax.jit
    compiles them (scale = amax * fp32(1/qmax)); dequantize inverts it
    within half a quantization step."""
    from mfa_tpu.kernels import quant as jq
    from mfa_tpu_torch.kernels import quant as tq

    x = np.random.default_rng(5).standard_normal((4096, 64)).astype(
        np.float32)
    if fmt == "int8":
        qj, sj = jax.jit(jq.quantize_int8)(jnp.asarray(x))
        qt, st = tq.quantize_int8(torch.from_numpy(x))
        step = st
    else:
        qj, sj = jax.jit(jq.quantize_fp8)(jnp.asarray(x))
        qt, st = tq.quantize_fp8(torch.from_numpy(x))
        step = st * 32.0        # e4m3 keeps 3 mantissa bits (2^-4 rel.)
    np.testing.assert_array_equal(qt.float().numpy(),
                                  np.asarray(qj.astype(jnp.float32)))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    back = tq.dequantize(qt, st)
    assert torch.all((back - torch.from_numpy(x)).abs() <= step)


def test_cache_dequant_recovers_the_filled_rows():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 2, 40, 32)).astype(np.float32)
    tc = kv_cache.update(
        kv_cache.create(1, 2, 64, 32, OperandPrecision.INT8, device="cpu"),
        torch.from_numpy(x), torch.from_numpy(-x))
    k, v = tc.dequant()
    tol = float(np.abs(x).max()) / 127
    assert_close(k[:, :, :40], x, tol, "k")
    assert_close(v[:, :, :40], -x, tol, "v")
    assert tc.lengths.tolist() == [40]


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("name", ["bf16", "fp8_e4m3"])
def test_fp64_decode_is_within_a_rounding_step_of_both_packages(name,
                                                                window):
    """utils/testing.py::decode_fp64, the exact decode that chip_smoke.py
    holds K2's in-context launches against: the port's K2 (its plain
    version here) and mfa_tpu's fused kernel (interpret mode) on the same
    cache both lie within one bf16 step (2^-7) of sum P |v| / l of it,
    plus decode_o's atol (measured 0.12-0.21 steps). The window is the
    one decode_fp64 is given: without it the case lies ~75 steps away."""
    jprec, tprec, _ = PRECISIONS[name]
    rng = np.random.default_rng(14)
    jc, tc = _filled(rng, jprec, tprec)
    q = rng.standard_normal((B, HQ, D)).astype(np.float32)
    kn = (rng.standard_normal((B, HKV, D)) * 0.5).astype(np.float32)
    vn = (rng.standard_normal((B, HKV, D)) * 0.5).astype(np.float32)
    bh, g = B * HKV, HQ // HKV
    # decode_attention_append's operands: q * scale * log2(e) in bf16.
    q3 = (torch.from_numpy(q).bfloat16().float()
          * (math.log2(math.e) / math.sqrt(D))).bfloat16().reshape(bh, g, D)
    kn3, vn3 = (torch.from_numpy(x).bfloat16().reshape(bh, D)
                for x in (kn, vn))
    cache = [tc.k.view(bh, MAX_LEN, D), tc.v.view(bh, MAX_LEN, D),
             tc.k_scale.view(bh, MAX_LEN), tc.v_scale.view(bh, MAX_LEN)]
    kw = dict(num_kv_heads=HKV, sliding_window=window)
    exact, terms = (decode_fp64(q3, *cache, kn3, vn3, tc.lengths,
                                magnitudes=mag, **kw)
                    for mag in (False, True))
    o_t = decode_fused_append(q3, *[t.clone() for t in cache], kn3, vn3,
                              tc.lengths.clone(), **kw)
    o_j, _ = jax_decode_append(jnp.asarray(q, jnp.bfloat16),
                               jnp.asarray(kn, jnp.bfloat16),
                               jnp.asarray(vn, jnp.bfloat16), jc,
                               sliding_window=window)
    o_j = torch.from_numpy(np.asarray(o_j, np.float32)).reshape(bh, g, D)
    for side, o in (("port", o_t), ("mfa_tpu", o_j)):
        steps = float(rounding_steps(o, exact, terms, 1e-4).max())
        assert steps <= 1, f"{side}: {steps} bf16 steps from fp64"
    if window is not None:
        unwindowed = decode_fp64(q3, *cache, kn3, vn3, tc.lengths,
                                 num_kv_heads=HKV)
        assert float(rounding_steps(o_t, unwindowed, terms,
                                    1e-4).max()) > 10
