"""Port Llama with weight-only INT8/INT4 projections (plain kernel
versions on the CPU) against mfa_tpu's on the same parameters: the
weight quantizer bit for bit, the tiny fp32 model's forward and decode
logits through params_from_numpy of mfa_tpu's quantized params (fp32
budget 2e-5), and the continuous-batching scheduler with INT4 weights
and an FP8-e4m3 KV cache token for token."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.kernels import quant as jquant
from mfa_tpu.models import llama as jax_llama
from mfa_tpu.ops.precision import OperandPrecision as JPrec
from mfa_tpu.serving.scheduler import ContinuousBatchingScheduler as JaxSched
from mfa_tpu.serving.scheduler import Request as JaxRequest
from mfa_tpu_torch.kernels import quant
from mfa_tpu_torch.models import llama
from mfa_tpu_torch.models.from_jax import params_from_numpy
from mfa_tpu_torch.ops.precision import OperandPrecision
from mfa_tpu_torch.serving.scheduler import ContinuousBatchingScheduler, Request
from mfa_tpu_torch.utils.testing import assert_close

PRECISIONS = {"int8": (JPrec.INT8, OperandPrecision.INT8),
              "int4": (JPrec.INT4, OperandPrecision.INT4)}
MAX_LEN = 64


@pytest.fixture(scope="module")
def base():
    cfg_j = jax_llama.LlamaConfig.tiny()
    params = jax_llama.init_params(jax.random.key(1), cfg_j, jnp.float32)
    cfg = llama.LlamaConfig.tiny()
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    return cfg_j, params, cfg, model


def _quantized(base, name):
    cfg_j, params, cfg, _ = base
    qj = jax_llama.quantize_params(params, PRECISIONS[name][0])
    return qj, params_from_numpy(jax.tree.map(np.asarray, qj), cfg,
                                 device="cpu")


@pytest.mark.parametrize("name", list(PRECISIONS))
def test_quantize_params_bit_equal(base, name):
    """mfa_tpu's quantize_params runs eagerly: scale = amax / qmax, a true
    division; the port's quantizer gives the same bytes and scales."""
    _, params, cfg, model = base
    jprec, tprec = PRECISIONS[name]
    qj = jax.tree.map(np.asarray,
                      jax_llama.quantize_params(params, jprec))
    qt = llama.quantize_params(model.params(), tprec)
    for lj, lt in zip(qj["layers"], qt["layers"]):
        for wname in llama._QUANTIZABLE:
            a, b = lj[wname], lt[wname]
            assert b.layout == name
            np.testing.assert_array_equal(b.w.numpy(), a.w.T)
            np.testing.assert_array_equal(b.scale.numpy(), a.scale[0])
        assert torch.equal(lt["attn_norm"], model.layers[0].attn_norm.data)
    assert torch.equal(qt["embed"], model.embed.data)


@pytest.mark.parametrize("name", list(PRECISIONS))
def test_forward_and_decode_logits_match(base, name):
    cfg_j, _, cfg, _ = base
    qj, model = _quantized(base, name)
    assert not any(isinstance(p, torch.nn.Parameter) and p.dtype in
                   (torch.int8, torch.uint8) for p in model.parameters())
    assert isinstance(model.layers[0].wq, quant.QuantizedWeight)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab_size, (2, 12))
    want = jax_llama.forward(qj, cfg_j, jnp.asarray(tokens, jnp.int32))
    assert_close(model(torch.from_numpy(tokens)), np.asarray(want), 2e-5,
                 f"forward ({name})")
    caches_j = jax_llama.make_caches(cfg_j, 2, MAX_LEN, JPrec.FP32)
    caches_t = model.make_caches(2, MAX_LEN, OperandPrecision.FP32)
    lj, caches_j = jax_llama.forward(qj, cfg_j, jnp.asarray(tokens, jnp.int32),
                                     caches=caches_j)
    lt, caches_t = model(torch.from_numpy(tokens), caches=caches_t)
    assert_close(lt, np.asarray(lj), 2e-5, f"prefill ({name})")
    for step in range(3):
        tok = rng.integers(0, cfg.vocab_size, (2,))
        lj, caches_j = jax_llama.decode_step(
            qj, cfg_j, jnp.asarray(tok, jnp.int32), caches_j)
        lt, caches_t = model.decode_step(torch.from_numpy(tok), caches_t)
        assert_close(lt, np.asarray(lj), 2e-5, f"decode {step} ({name})")


def test_biased_leaf_maps_to_biased_layout(base):
    """A uint8 INT4 leaf is the biased layout; mfa_tpu dispatches it to
    its biased kernel, the port by the layout tag."""
    cfg_j, params, cfg, _ = base
    qj = jax_llama.quantize_params(params, JPrec.INT4)
    for layer, src in zip(qj["layers"], params["layers"]):
        for wname in llama._QUANTIZABLE:
            packed, scale = jquant.pack_int4_biased(src[wname])
            layer[wname] = jquant.QuantizedWeight(packed, scale, "int4")
    model = params_from_numpy(jax.tree.map(np.asarray, qj), cfg,
                              device="cpu")
    assert model.layers[1].w_down.layout == "int4_biased"
    assert model.layers[1].w_down.w.dtype == torch.uint8
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 9))
    want = jax_llama.forward(qj, cfg_j, jnp.asarray(tokens, jnp.int32))
    assert_close(model(torch.from_numpy(tokens)), np.asarray(want), 2e-5,
                 "forward (int4_biased)")


def test_quantized_init_equals_quantize_of_init():
    cfg = llama.LlamaConfig.tiny()
    for prec in (OperandPrecision.INT4, OperandPrecision.INT8):
        lean = llama.init_params_quantized(
            cfg, torch.Generator().manual_seed(7), prec)
        full = llama.quantize_params(
            llama.init_params(cfg, torch.Generator().manual_seed(7)), prec)
        for ll, lf in zip(lean["layers"], full["layers"]):
            for wname in llama._QUANTIZABLE:
                assert torch.equal(ll[wname].w, lf[wname].w)
                assert torch.equal(ll[wname].scale, lf[wname].scale)
        assert torch.equal(lean["lm_head"], full["lm_head"])
        assert lean["lm_head"].dtype == torch.bfloat16
        model = llama.Llama.init(cfg, generator=torch.Generator().manual_seed(7),
                                 device="cpu", weight_precision=prec)
        assert torch.equal(model.layers[0].w_up.w, lean["layers"][0]["w_up"].w)
    with pytest.raises(ValueError, match="cannot train"):
        llama.Llama.init(cfg, generator=torch.Generator().manual_seed(7),
                         device="cpu", trainable=True,
                         weight_precision=OperandPrecision.INT4)
    with pytest.raises(ValueError, match="weight precision"):
        llama.init_params_quantized(cfg, torch.Generator(),
                                    OperandPrecision.FP8_E4M3)


def test_quantized_weights_are_buffers_not_parameters():
    cfg = llama.LlamaConfig.tiny()
    bf16 = llama.Llama.init(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    q = bf16.quantized(OperandPrecision.INT4)
    names = {n for n, _ in q.named_parameters()}
    assert "layers.0.wq" not in names and "layers.0.attn_norm" in names
    assert {"layers.0.wq_q", "layers.0.wq_scale"} <= {
        n for n, _ in q.named_buffers()}
    assert q.embed.data_ptr() == bf16.embed.data_ptr()    # shared
    assert q.layers[0].has("wq") and not q.layers[0].has("bq")
    with pytest.raises(ValueError, match="cannot train"):
        llama.Llama(cfg, q.params(), device="cpu", trainable=True)
    tokens = torch.tensor([[1, 2, 3, 4]])
    assert torch.isfinite(q(tokens)).all()


def test_int4_fp8_scheduler_matches_mfa_tpu(base):
    cfg_j, _, cfg, _ = base
    qj, model = _quantized(base, "int4")
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5, 2), (2, 6), (4, 3), (6, 5)]
    prompts = [rng.integers(1, cfg.vocab_size, ln).tolist()
               for ln, _ in shapes]
    jsched = JaxSched(qj, cfg_j, num_slots=2, max_len=MAX_LEN,
                      prompt_buckets=(8, 16), kv_precision=JPrec.FP8_E4M3)
    jreqs = [JaxRequest(prompt=p, max_new_tokens=n)
             for p, (_, n) in zip(prompts, shapes)]
    for r in jreqs:
        jsched.submit(r)
    jdone = {c.request.id: c.tokens for c in jsched.run()}
    sched = ContinuousBatchingScheduler(
        model, num_slots=2, max_len=MAX_LEN, prompt_buckets=(8, 16),
        kv_precision=OperandPrecision.FP8_E4M3, device="cpu")
    reqs = [Request(prompt=p, max_new_tokens=n)
            for p, (_, n) in zip(prompts, shapes)]
    for r in reqs:
        sched.submit(r)
    done = {c.request.id: c.tokens for c in sched.run()}
    assert sched.stats == jsched.stats
    for jr, r, (_, n) in zip(jreqs, reqs, shapes):
        assert len(done[r.id]) == n
        assert done[r.id] == jdone[jr.id], f"request {r.id} diverged"
