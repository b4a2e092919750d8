"""The port's perplexity harness (utils/evaluate.py) against mfa_tpu's on
the same tiny fp32 parameters and tokens. 120 tokens make both packages'
default max_len (t + 8) 128, where mfa_tpu's decode fuses as the port's
always does (mfa_tpu/ops/decode.py:214-218)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mfa_tpu.models import llama as jax_llama
from mfa_tpu.ops.precision import OperandPrecision as JPrec
from mfa_tpu.utils import evaluate as jax_evaluate
from mfa_tpu_torch.models import llama
from mfa_tpu_torch.models.from_jax import params_from_numpy
from mfa_tpu_torch.ops.precision import OperandPrecision
from mfa_tpu_torch.utils import evaluate

T = 120
# Perplexities of fp32 models, relative: a mean over ~240 token NLLs,
# each in summation order only (mfa_tpu/ops/precision.py's fp32 budget,
# 2e-5; measured 1e-6 on the CPU, a bf16 cache included). An INT8 cache's
# stored values can differ by one step where the quantizers' scales differ
# by an ulp (the port's amax * fp32(1/qmax) against mfa_tpu's eager
# amax / qmax): 1e-4, tighter than the mixed budget of 5e-2 (measured
# 1.4e-5).
FP32_RTOL = 2e-5
QUANT_RTOL = 1e-4


@pytest.fixture(scope="module")
def models():
    cfg_j = jax_llama.LlamaConfig.tiny()
    params = jax_llama.init_params(jax.random.key(2), cfg_j, jnp.float32)
    model = params_from_numpy(jax.tree.map(np.asarray, params),
                              llama.LlamaConfig.tiny(), device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg_j.vocab_size, (2, T))
    return cfg_j, params, model, tokens


def test_perplexity_full_matches(models):
    cfg_j, params, model, tokens = models
    want = jax_evaluate.perplexity_full(params, cfg_j,
                                        jnp.asarray(tokens, jnp.int32))
    got = evaluate.perplexity_full(model, tokens)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, rtol=FP32_RTOL)


@pytest.mark.parametrize("fmt,rtol", [("BF16", FP32_RTOL),
                                      ("INT8", QUANT_RTOL),
                                      ("FP8_E4M3", QUANT_RTOL)])
def test_perplexity_decode_matches(models, fmt, rtol):
    """At an explicit max_len of 128."""
    cfg_j, params, model, tokens = models
    want = jax_evaluate.perplexity_decode(
        params, cfg_j, jnp.asarray(tokens, jnp.int32), getattr(JPrec, fmt),
        max_len=128)
    got = evaluate.perplexity_decode(model, tokens,
                                     getattr(OperandPrecision, fmt),
                                     max_len=128)
    np.testing.assert_allclose(got, want, rtol=rtol)


def test_kv_quantization_ppl_delta_matches(models):
    """Both packages' own default max_len (t + 8 = 128); the delta is held
    to tests/test_aux.py's conditions on the port's side too."""
    cfg_j, params, model, tokens = models
    p_ref_j, p_q_j, delta_j = jax_evaluate.kv_quantization_ppl_delta(
        params, cfg_j, jnp.asarray(tokens, jnp.int32), JPrec.INT8)
    p_ref, p_q, delta = evaluate.kv_quantization_ppl_delta(
        model, tokens, OperandPrecision.INT8)
    np.testing.assert_allclose(p_ref, p_ref_j, rtol=FP32_RTOL)
    np.testing.assert_allclose(p_q, p_q_j, rtol=QUANT_RTOL)
    assert delta == abs(p_q - p_ref)
    np.testing.assert_allclose(delta, delta_j, atol=2 * QUANT_RTOL * p_ref)
    p_full = evaluate.perplexity_full(model, tokens)
    assert 0.5 * p_full < p_ref < 2.0 * p_full
    assert delta / p_ref < 0.02
