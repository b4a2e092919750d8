"""The port's LlamaConfig presets against mfa_tpu's, and the model options
the presets turn on (Qwen2's QKV bias, Mistral's sliding window, tied
embeddings) held against mfa_tpu's Llama on the same numpy parameters:
the forward, and a prefill followed by six decode steps over bf16 and
INT8 caches."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.models import llama as jax_llama
from mfa_tpu.ops.precision import OperandPrecision as JPrec
from mfa_tpu_torch.models import llama
from mfa_tpu_torch.models.from_jax import params_from_numpy
from mfa_tpu_torch.ops.precision import OperandPrecision
from mfa_tpu_torch.utils.testing import assert_close

PRESETS = ("llama3_8b", "llama3_1b_proxy", "mistral_7b", "qwen2_7b", "tiny")

# Tiny fp32 models with one option each. The window (8) is shorter than
# the prompt (10) and the six decode steps, so it masks keys in K1's
# prefill and in K2's decode.
OPTIONS = {
    "qkv_bias": dict(qkv_bias=True),
    "window": dict(sliding_window=8),
    "tied": dict(tie_embeddings=True),
}
MAX_LEN = 128
# fp32 models on both sides: the forward and the prefill differ only in
# summation order (at most 4.7e-6 on the CPU, over the parameter and token
# seeds below plus 1-15). A decode step reads K/V rows back from the
# cache, and an appended row's rounding to the cache's type can flip by
# one step where the two sides' fp32 k_new differ in the last bits; a
# step with no flip stays below 5e-6. The largest decode error of each
# option and format on the test's own seeds, then in brackets over all 16
# (every figure above 5e-6 comes from a flip): QKV bias, bf16 3.0e-6 (2.2e-3), INT8
# 2.1e-6 (6.0e-3); window, bf16 2.4e-3 (2.4e-3), INT8 3.3e-6 (3.2e-3);
# tied, bf16 2.3e-4 (2.3e-4), INT8 7.7e-7 (1.7e-3). Each tolerance sits a
# little above the largest.
FORWARD_TOL = 1e-5
DECODE_TOL = {
    ("qkv_bias", "bf16"): 3e-3, ("qkv_bias", "int8"): 8e-3,
    ("window", "bf16"): 3e-3, ("window", "int8"): 4e-3,
    ("tied", "bf16"): 3e-4, ("tied", "int8"): 2e-3,
}
FORMATS = {"bf16": (JPrec.BF16, OperandPrecision.BF16),
           "int8": (JPrec.INT8, OperandPrecision.INT8)}


@pytest.mark.parametrize("name", PRESETS)
def test_presets_equal_mfa_tpus(name):
    ours = getattr(llama.LlamaConfig, name)()
    theirs = getattr(jax_llama.LlamaConfig, name)()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.head_dim == theirs.head_dim


@pytest.fixture(scope="module", params=list(OPTIONS))
def option_models(request):
    opts = OPTIONS[request.param]
    cfg_j = dataclasses.replace(jax_llama.LlamaConfig.tiny(), **opts)
    params = jax_llama.init_params(jax.random.key(7), cfg_j, jnp.float32)
    if cfg_j.qkv_bias:
        # mfa_tpu initialises the biases to zeros: give them values.
        rng = np.random.default_rng(7)
        for layer in params["layers"]:
            for b in ("bq", "bk", "bv"):
                layer[b] = jnp.asarray(rng.standard_normal(
                    layer[b].shape).astype(np.float32) * 0.5)
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), **opts)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    return request.param, cfg_j, params, cfg, model


def test_option_forward_matches(option_models):
    name, cfg_j, params, cfg, model = option_models
    layer = model.layers[0]
    assert layer.has("bq") == cfg.qkv_bias
    assert (model.lm_head is None) == cfg.tie_embeddings
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 24))
    want = jax_llama.forward(params, cfg_j, jnp.asarray(tokens, jnp.int32))
    got = model(torch.from_numpy(tokens))
    assert_close(got, np.asarray(want), FORWARD_TOL, f"logits ({name})")


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_option_prefill_and_six_decode_steps_match(option_models, fmt):
    name, cfg_j, params, cfg, model = option_models
    jprec, tprec = FORMATS[fmt]
    tol = DECODE_TOL[name, fmt]
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab_size, (2, 10))
    caches_j = jax_llama.make_caches(cfg_j, 2, MAX_LEN, jprec)
    caches_t = model.make_caches(2, MAX_LEN, tprec)
    lj, caches_j = jax_llama.forward(params, cfg_j,
                                     jnp.asarray(prompt, jnp.int32),
                                     caches=caches_j)
    lt, caches_t = model(torch.from_numpy(prompt), caches=caches_t)
    assert_close(lt, np.asarray(lj), FORWARD_TOL, f"prefill ({name}, {fmt})")
    for step in range(6):
        tok = rng.integers(0, cfg.vocab_size, (2,))
        lj, caches_j = jax_llama.decode_step(
            params, cfg_j, jnp.asarray(tok, jnp.int32), caches_j)
        lt, caches_t = model.decode_step(torch.from_numpy(tok), caches_t)
        assert_close(lt, np.asarray(lj), tol,
                     f"decode {step} ({name}, {fmt})")
    assert caches_t[0].lengths.tolist() == [16, 16]
