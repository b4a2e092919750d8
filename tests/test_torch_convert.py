"""Hugging Face conversion of the port (models/convert.py) against
transformers and against mfa_tpu's conversion, on tiny models built in
memory from a config (nothing is downloaded): a Llama, a Qwen2 (QKV
bias), a Mistral whose window (16) is shorter than the sequence, and a
Llama with tied embeddings. For each: the port's logits against
transformers' and against mfa_tpu's params_from_hf + forward, and greedy
generation against transformers' generate."""

import importlib.util
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from mfa_tpu.models import convert as jax_convert  # noqa: E402
from mfa_tpu.models import llama as jax_llama  # noqa: E402
from mfa_tpu_torch.models import convert  # noqa: E402
from mfa_tpu_torch.models.llama import LlamaConfig  # noqa: E402
from mfa_tpu_torch.ops.precision import OperandPrecision  # noqa: E402
from mfa_tpu_torch.utils.testing import assert_close  # noqa: E402

# Two independent fp32 implementations (torch eager against the port's
# kernels' plain versions): tests/test_convert.py's bound for mfa_tpu.
HF_TOL = 2e-3
# The port against mfa_tpu from the same weights: fp32, summation order
# only (mfa_tpu/ops/precision.py's fp32 budget).
JAX_TOL = 2e-5
SEQ = 24

_COMMON = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, max_position_embeddings=128,
               rope_theta=10000.0, attn_implementation="eager")
FAMILIES = {
    "llama": (transformers.LlamaConfig, transformers.LlamaForCausalLM,
              dict(rms_norm_eps=1e-5, tie_word_embeddings=False)),
    "qwen2": (transformers.Qwen2Config, transformers.Qwen2ForCausalLM,
              dict(rms_norm_eps=1e-6, tie_word_embeddings=False,
                   use_sliding_window=False)),
    "mistral": (transformers.MistralConfig,
                transformers.MistralForCausalLM,
                dict(rms_norm_eps=1e-5, tie_word_embeddings=False,
                     sliding_window=16)),
    "llama_tied": (transformers.LlamaConfig,
                   transformers.LlamaForCausalLM,
                   dict(rms_norm_eps=1e-5, tie_word_embeddings=True)),
}


@pytest.fixture(scope="module", params=list(FAMILIES))
def hf(request):
    config_cls, model_cls, extra = FAMILIES[request.param]
    cfg = config_cls(**_COMMON, **extra)
    torch.manual_seed(len(request.param))
    model = model_cls(cfg).eval()
    if request.param == "qwen2":
        # transformers initialises the QKV biases to zeros: give them values.
        with torch.no_grad():
            for layer in model.model.layers:
                for proj in ("q_proj", "k_proj", "v_proj"):
                    getattr(layer.self_attn, proj).bias.normal_(0.0, 0.5)
    return request.param, cfg, model


def test_config_reads_each_family(hf):
    name, hf_cfg, _ = hf
    cfg = convert.config_from_hf(hf_cfg)
    assert cfg.qkv_bias == (name == "qwen2")
    assert cfg.sliding_window == (16 if name == "mistral" else None)
    assert cfg.tie_embeddings == (name == "llama_tied")
    assert cfg == LlamaConfig(**jax_convert.config_from_hf(hf_cfg).__dict__)


def test_logits_match_transformers_and_mfa_tpu(hf):
    name, hf_cfg, model = hf
    cfg = convert.config_from_hf(hf_cfg)
    ours = convert.params_from_hf(model.state_dict(), cfg, torch.float32,
                                  device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, SEQ))
    with torch.no_grad():
        want_hf = model(torch.from_numpy(tokens)).logits.float()
        got = ours(torch.from_numpy(tokens))
    assert_close(got, want_hf, HF_TOL, f"logits against transformers ({name})")
    assert torch.equal(got.argmax(-1), want_hf.argmax(-1))

    jcfg = jax_convert.config_from_hf(hf_cfg)
    jparams = jax_convert.params_from_hf(model.state_dict(), jcfg,
                                         jnp.float32)
    want_jax = jax_llama.forward(jparams, jcfg, jnp.asarray(tokens,
                                                            jnp.int32))
    assert_close(got, np.asarray(want_jax), JAX_TOL,
                 f"logits against mfa_tpu ({name})")


def test_greedy_generation_matches_transformers(hf):
    """Prefill, then greedy decode steps through the fused decode over an
    fp32 cache, against transformers' generate (prompt 12 + 8 new tokens:
    past the Mistral window of 16)."""
    name, hf_cfg, model = hf
    cfg = convert.config_from_hf(hf_cfg)
    ours = convert.params_from_hf(model.state_dict(), cfg, torch.float32,
                                  device="cpu")
    prompt = np.random.default_rng(1).integers(1, cfg.vocab_size, (1, 12))
    with torch.no_grad():
        hf_out = model.generate(torch.from_numpy(prompt), max_new_tokens=8,
                                do_sample=False, pad_token_id=0)
    want = hf_out[0, prompt.shape[1]:].tolist()

    caches = ours.make_caches(1, 128, OperandPrecision.FP32)
    with torch.no_grad():
        logits, caches = ours(torch.from_numpy(prompt), caches=caches)
    tok = int(logits[0, -1].argmax())
    got = [tok]
    for _ in range(7):
        logits, caches = ours.decode_step(torch.tensor([tok]), caches)
        tok = int(logits[0].argmax())
        got.append(tok)
    assert got == want, (name, got, want)


def test_namespace_config_equals_transformers_config():
    """chip_smoke.py's published config.json fields of Qwen2-7B and
    Mistral-7B, as the namespace the card reads and as transformers'
    config objects, give the presets. Qwen2-7B's published config has
    sliding_window 131072 with use_sliding_window false, which
    Qwen2Config turns into None and a namespace keeps."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_cfg", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for fields, cls, preset in (
            (smoke.QWEN2_7B_CONFIG, transformers.Qwen2Config,
             LlamaConfig.qwen2_7b()),
            (smoke.MISTRAL_7B_CONFIG, transformers.MistralConfig,
             LlamaConfig.mistral_7b())):
        obj = cls(**{k: v for k, v in fields.items() if k != "model_type"})
        assert obj.sliding_window == (None if cls is transformers.Qwen2Config
                                      else 4096)
        assert fields["sliding_window"] in (131072, 4096)
        assert convert.config_from_hf(types.SimpleNamespace(**fields)) \
            == preset
        assert convert.config_from_hf(obj) == preset


def test_numpy_and_tensor_state_dicts_give_the_same_model(hf):
    name, hf_cfg, model = hf
    cfg = convert.config_from_hf(hf_cfg)
    sd = model.state_dict()
    from_torch = convert.params_from_hf(sd, cfg, torch.bfloat16,
                                        device="cpu")
    from_numpy = convert.params_from_hf(
        {k: v.numpy() for k, v in sd.items()}, cfg, torch.bfloat16,
        device="cpu")
    a, b = from_torch.state_dict(), from_numpy.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    assert from_torch.embed.dtype == torch.bfloat16
    assert from_torch.final_norm.dtype == torch.float32
    if cfg.qkv_bias:
        assert from_torch.layers[0].bq.dtype == torch.float32


def test_lm_head_falls_back_to_the_embedding():
    """Untied embeddings and no lm_head.weight: the head is the embedding
    (mfa_tpu takes embed.T, the same matrix in its [in, out] layout)."""
    hf_cfg = transformers.LlamaConfig(**_COMMON, rms_norm_eps=1e-5,
                                      tie_word_embeddings=False)
    torch.manual_seed(3)
    model = transformers.LlamaForCausalLM(hf_cfg).eval()
    sd = {k: v for k, v in model.state_dict().items() if k != "lm_head.weight"}
    cfg = convert.config_from_hf(hf_cfg)
    ours = convert.params_from_hf(sd, cfg, torch.float32, device="cpu")
    assert torch.equal(ours.lm_head, sd["model.embed_tokens.weight"])
    assert ours.lm_head.data_ptr() != ours.embed.data_ptr()
    jparams = jax_convert.params_from_hf(
        sd, jax_convert.config_from_hf(hf_cfg), jnp.float32)
    np.testing.assert_array_equal(ours.lm_head.detach().numpy(),
                                  np.asarray(jparams["lm_head"]).T)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 10))
    want = jax_llama.forward(jparams, jax_convert.config_from_hf(hf_cfg),
                             jnp.asarray(tokens, jnp.int32))
    with torch.no_grad():
        got = ours(torch.from_numpy(tokens))
    assert_close(got, np.asarray(want), JAX_TOL, "logits, fallback head")
