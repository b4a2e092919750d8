"""Port Llama (plain kernel versions on the CPU) against mfa_tpu's Llama
from the same parameters: full forward, and prefill into KV caches
followed by decode steps for bf16, INT8 and FP8-e4m3 caches."""

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

MAX_LEN = 128
# fp32 model: the two sides differ only in summation order (2e-4). With
# quantized caches, the port's scale (amax * fp32(1/qmax)) can differ by
# one ulp from the JAX eager update's (amax / qmax); a stored value that
# flips by one quantization step moves a logit by far less than 2e-2.
FORMATS = {
    "bf16": (JPrec.BF16, OperandPrecision.BF16, 2e-4),
    "int8": (JPrec.INT8, OperandPrecision.INT8, 2e-2),
    "fp8_e4m3": (JPrec.FP8_E4M3, OperandPrecision.FP8_E4M3, 2e-2),
}


@pytest.fixture(scope="module")
def models():
    cfg_j = jax_llama.LlamaConfig.tiny()
    params = jax_llama.init_params(jax.random.key(1), cfg_j, jnp.float32)
    tree = jax.tree.map(np.asarray, params)
    cfg = llama.LlamaConfig.tiny()
    return cfg_j, params, cfg, params_from_numpy(tree, cfg, device="cpu")


def test_params_from_numpy_layout(models):
    cfg_j, params, cfg, model = models
    assert model.layers[0].wq.shape == (cfg.n_heads * cfg.head_dim, cfg.dim)
    np.testing.assert_array_equal(model.layers[1].w_down.numpy(),
                                  np.asarray(params["layers"][1]["w_down"]).T)
    assert not any(p.requires_grad for p in model.parameters())


def test_forward_logits_match(models):
    cfg_j, params, cfg, model = models
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12))
    want = jax_llama.forward(params, cfg_j, jnp.asarray(tokens, jnp.int32))
    got = model(torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == (2, 12, cfg.vocab_size)
    assert_close(got, np.asarray(want), 2e-4, "logits")


@pytest.mark.parametrize("name", list(FORMATS))
def test_prefill_and_decode_match(models, name):
    cfg_j, params, cfg, model = models
    jprec, tprec, tol = FORMATS[name]
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, (2, 10))
    caches_j = jax_llama.make_caches(cfg_j, 2, MAX_LEN, jprec)
    caches_t = model.make_caches(2, MAX_LEN, tprec)
    lj, caches_j = jax_llama.forward(params, cfg_j,
                                     jnp.asarray(prompt, jnp.int32),
                                     caches=caches_j)
    lt, caches_t = model(torch.from_numpy(prompt), caches=caches_t)
    assert_close(lt, np.asarray(lj), tol, f"prefill logits ({name})")
    for step in range(3):
        tok = rng.integers(0, cfg.vocab_size, (2,))
        lj, caches_j = jax_llama.decode_step(
            params, cfg_j, jnp.asarray(tok, jnp.int32), caches_j)
        lt, caches_t = model.decode_step(torch.from_numpy(tok), caches_t)
        assert_close(lt, np.asarray(lj), tol, f"decode {step} ({name})")
        for cj, ct in zip(caches_j, caches_t):
            np.testing.assert_array_equal(ct.lengths.numpy(),
                                          np.asarray(cj.lengths))
    assert caches_t[0].lengths.tolist() == [13, 13]


def test_model_init_from_generator_is_seeded():
    cfg = llama.LlamaConfig.tiny()
    a = llama.Llama.init(cfg, generator=torch.Generator().manual_seed(3),
                         dtype=torch.bfloat16, device="cpu")
    b = llama.Llama.init(cfg, generator=torch.Generator().manual_seed(3),
                         dtype=torch.bfloat16, device="cpu")
    assert a.embed.dtype == torch.bfloat16
    assert a.final_norm.dtype == torch.float32
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    logits = a(torch.tensor([[1, 2, 3]]))
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
