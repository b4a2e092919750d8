"""Port training (plain kernel versions on the CPU) against mfa_tpu's:
the optimizer schedule, the loss, one step's loss and gradients and an
8-step loss curve of the tiny fp32 Llama from the same parameters, the
same for an OpenLLaMA-shaped model (head dim 100, MHA) built through
both packages' Hugging Face conversion, the sanity guards and the token
dataset."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mfa_tpu.models import convert as jax_convert
from mfa_tpu.models import llama as jax_llama
from mfa_tpu.models import training as jax_training
from mfa_tpu.utils import data as jax_data
from mfa_tpu.utils import sanity as jax_sanity
from mfa_tpu_torch.models import convert, llama, training
from mfa_tpu_torch.models.from_jax import params_from_numpy
from mfa_tpu_torch.utils import data, sanity

_TRANSPOSED = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
               "lm_head")


@pytest.mark.parametrize("warmup,total,peak,end", [
    (1, 50, 1e-2, 1e-3), (10, 100, 3e-4, 3e-5), (0, 20, 1e-3, 0.0),
    (5, 6, 1e-3, 1e-4)])
def test_schedule_matches_optax(warmup, total, peak, end):
    want = optax.warmup_cosine_decay_schedule(0.0, peak, warmup, total,
                                              end_value=end)
    got = training.warmup_cosine_decay_schedule(0.0, peak, warmup, total,
                                                end_value=end)
    for count in range(total + 5):
        assert abs(got(count) - float(want(count))) <= 1e-7, count
    assert got(0) == 0.0 or warmup == 0


def test_cross_entropy_masks_ignored_targets():
    logits = torch.zeros(1, 4, 10)
    targets = torch.tensor([[1, 2, -100, -100]])
    loss = training.cross_entropy_loss(logits, targets)
    np.testing.assert_allclose(float(loss), np.log(10), rtol=1e-6)
    rng = np.random.default_rng(0)
    lg = rng.standard_normal((2, 5, 7)).astype(np.float32)
    tg = rng.integers(0, 7, (2, 5))
    tg[0, 1] = tg[1, 4] = -100
    want = jax_training.cross_entropy_loss(jnp.asarray(lg), jnp.asarray(tg))
    got = training.cross_entropy_loss(torch.from_numpy(lg),
                                      torch.from_numpy(tg))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_cross_entropy_all_ignored_is_zero():
    loss = training.cross_entropy_loss(torch.zeros(1, 3, 10),
                                       torch.full((1, 3), -100))
    assert torch.isfinite(loss) and float(loss) == 0.0


@pytest.fixture(scope="module")
def tiny():
    cfg_j = jax_llama.LlamaConfig.tiny()
    params = jax_llama.init_params(jax.random.key(0), cfg_j, jnp.float32)
    tokens = np.random.default_rng(0).integers(0, cfg_j.vocab_size, (2, 24))
    return cfg_j, params, tokens


def _port_state(tiny):
    cfg_j, params, _ = tiny
    model = params_from_numpy(jax.tree.map(np.asarray, params),
                              llama.LlamaConfig.tiny(), device="cpu",
                              trainable=True)
    opt = training.make_optimizer(lr=1e-2, warmup_steps=1, total_steps=50)
    return training.create_train_state(model, opt)


def _port_grads(model):
    out = {}
    for name, p in model.named_parameters():
        g = p.grad.numpy()
        out[name] = g.T if name.split(".")[-1] in _TRANSPOSED else g
    return out


def _jax_grads(grads):
    out = {"embed": grads["embed"], "final_norm": grads["final_norm"],
           "lm_head": grads["lm_head"]}
    for i, layer in enumerate(grads["layers"]):
        out.update({f"layers.{i}.{n}": g for n, g in layer.items()})
    return {n: np.asarray(g) for n, g in out.items()}


def test_first_step_loss_and_grads_match(tiny):
    cfg_j, params, tokens = tiny
    tj = jnp.asarray(tokens, jnp.int32)

    def loss_fn(p):
        logits = jax_llama.forward(p, cfg_j, tj[:, :-1], interpret=True)
        return jax_training.cross_entropy_loss(logits, tj[:, 1:])

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    state = _port_state(tiny)
    metrics = training.train_step(state, torch.from_numpy(tokens))
    assert abs(float(metrics["loss"]) - float(want_loss)) \
        <= 1e-5 * abs(float(want_loss))
    want = _jax_grads(want_grads)
    got = _port_grads(state.model)
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name]
        assert g.shape == w.shape, name
        tol = 1e-4 * float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=name)
    gnorm = float(optax.global_norm(want_grads))
    np.testing.assert_allclose(float(metrics["grad_norm"]), gnorm, rtol=1e-4)


def test_loss_curve_matches(tiny):
    cfg_j, params, tokens = tiny
    opt = jax_training.make_optimizer(lr=1e-2, warmup_steps=1,
                                      total_steps=50)
    jstate = jax_training.create_train_state(params, opt)
    step = jax.jit(lambda s, t: jax_training.train_step(
        s, t, cfg_j, opt, interpret=True))
    state = _port_state(tiny)
    tj, tt = jnp.asarray(tokens, jnp.int32), torch.from_numpy(tokens)
    want, got = [], []
    for _ in range(8):
        jstate, jm = step(jstate, tj)
        want.append(float(jm["loss"]))
        got.append(float(training.train_step(state, tt)["loss"]))
    assert abs(got[0] - want[0]) <= 1e-5 * abs(want[0])
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert got[-1] < got[0] * 0.8, got
    assert state.step == 8


# OpenLLaMA-3B's published config.json fields (openlm-research/
# open_llama_3b: no num_key_value_heads, so MHA; no rope_theta) cut to a
# tiny width that keeps its head dim of 100 (two heads over width 200).
OPENLLAMA_TINY = dict(
    architectures=["LlamaForCausalLM"], model_type="llama",
    hidden_act="silu", hidden_size=200, intermediate_size=256,
    num_hidden_layers=2, num_attention_heads=2,
    max_position_embeddings=2048, rms_norm_eps=1e-6,
    tie_word_embeddings=False, vocab_size=256)


@pytest.fixture(scope="module")
def openllama_tiny():
    """Both packages' configs from the same fields, a numpy state dict
    under Hugging Face's key names (seed 40: projections N(0, 1/d_in), the
    embedding N(0, 1) * 0.02, norms ones) and a 2 x 24 batch."""
    fields = types.SimpleNamespace(**OPENLLAMA_TINY)
    cfg, jcfg = convert.config_from_hf(fields), jax_convert.config_from_hf(
        fields)
    assert cfg.head_dim == 100 and cfg.n_kv_heads == cfg.n_heads == 2
    rng = np.random.default_rng(40)

    def rand(scale, *shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    hd, dim, ffn = cfg.head_dim, cfg.dim, cfg.ffn_hidden
    sd = {"model.embed_tokens.weight": rand(0.02, cfg.vocab_size, dim),
          "model.norm.weight": np.ones(dim, np.float32),
          "lm_head.weight": rand(dim ** -0.5, cfg.vocab_size, dim)}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        for name, d_out, d_in in (
                ("self_attn.q_proj", cfg.n_heads * hd, dim),
                ("self_attn.k_proj", cfg.n_kv_heads * hd, dim),
                ("self_attn.v_proj", cfg.n_kv_heads * hd, dim),
                ("self_attn.o_proj", dim, cfg.n_heads * hd),
                ("mlp.gate_proj", ffn, dim), ("mlp.up_proj", ffn, dim),
                ("mlp.down_proj", dim, ffn)):
            sd[p + name + ".weight"] = rand(d_in ** -0.5, d_out, d_in)
        sd[p + "input_layernorm.weight"] = np.ones(dim, np.float32)
        sd[p + "post_attention_layernorm.weight"] = np.ones(dim, np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (2, 24))
    return cfg, jcfg, sd, tokens


def _openllama_states(openllama_tiny):
    """(the port's TrainState, mfa_tpu's params) from the same weights,
    each package through its own params_from_hf."""
    cfg, jcfg, sd, _ = openllama_tiny
    model = convert.params_from_hf(sd, cfg, torch.float32, device="cpu",
                                   trainable=True)
    assert all(p.requires_grad for p in model.parameters())
    opt = training.make_optimizer(lr=1e-2, warmup_steps=1, total_steps=50)
    return (training.create_train_state(model, opt),
            jax_convert.params_from_hf(sd, jcfg, jnp.float32))


def test_openllama_shaped_first_step_matches(openllama_tiny):
    """One train_step of the OpenLLaMA-shaped model (D 100, MHA) from
    Hugging Face weights: the loss within 1e-5 of mfa_tpu's (relative) and
    every gradient within 1e-4 of its largest, as for the tiny Llama."""
    _, jcfg, _, tokens = openllama_tiny
    state, params = _openllama_states(openllama_tiny)
    tj = jnp.asarray(tokens, jnp.int32)

    def loss_fn(p):
        logits = jax_llama.forward(p, jcfg, tj[:, :-1], interpret=True)
        return jax_training.cross_entropy_loss(logits, tj[:, 1:])

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    metrics = training.train_step(state, torch.from_numpy(tokens))
    assert abs(float(metrics["loss"]) - float(want_loss)) \
        <= 1e-5 * abs(float(want_loss))
    want = _jax_grads(want_grads)
    got = _port_grads(state.model)
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name]
        assert g.shape == w.shape, name
        tol = 1e-4 * float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=name)
    gnorm = float(optax.global_norm(want_grads))
    np.testing.assert_allclose(float(metrics["grad_norm"]), gnorm, rtol=1e-4)


def test_openllama_shaped_loss_curve_matches(openllama_tiny):
    """Four train_steps of the OpenLLaMA-shaped model against mfa_tpu's
    jitted train_step from the same weights: losses within 1e-3."""
    _, jcfg, _, tokens = openllama_tiny
    state, params = _openllama_states(openllama_tiny)
    opt = jax_training.make_optimizer(lr=1e-2, warmup_steps=1,
                                      total_steps=50)
    jstate = jax_training.create_train_state(params, opt)
    step = jax.jit(lambda s, t: jax_training.train_step(
        s, t, jcfg, opt, interpret=True))
    tj, tt = jnp.asarray(tokens, jnp.int32), torch.from_numpy(tokens)
    want, got = [], []
    for _ in range(4):
        jstate, jm = step(jstate, tj)
        want.append(float(jm["loss"]))
        got.append(float(training.train_step(state, tt)["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert got[-1] < got[0], got
    assert state.step == 4


def test_train_state_needs_trainable_model():
    model = llama.Llama.init(llama.LlamaConfig.tiny(),
                             generator=torch.Generator().manual_seed(0),
                             dtype=torch.float32, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    with pytest.raises(ValueError, match="trainable"):
        training.create_train_state(model, training.make_optimizer())


def test_sanity_guards_match_mfa_tpu():
    good = np.ones((3, 2), np.float32)
    bad = np.array([1.0, np.nan, np.inf], np.float32)
    tree = {"a": good, "b": bad, "c": np.array([0, 1], np.int32)}
    want = jax_sanity.nonfinite_leaves(
        {n: jnp.asarray(x) for n, x in tree.items()})
    named = {n: torch.from_numpy(x) for n, x in tree.items()}
    got = sanity.nonfinite_leaves(named)
    assert want == [f"['{n}']" for n in got] and got == ["b"]
    with pytest.raises(sanity.NonFiniteError, match="b"):
        sanity.check_finite(named, "grads")
    sanity.check_finite({"a": named["a"]})

    grads = {"a": named["a"], "b": named["b"]}
    ok_j, zeroed_j = jax_sanity.finite_or_skip(
        {n: jnp.asarray(tree[n]) for n in grads}, None)
    ok, zeroed = sanity.finite_or_skip(grads)
    assert bool(ok) == bool(ok_j) is False
    for n in grads:
        np.testing.assert_array_equal(zeroed[n].numpy(),
                                      np.asarray(zeroed_j[n]))
    ok, kept = sanity.finite_or_skip({"a": named["a"]})
    assert bool(ok) and torch.equal(kept["a"], named["a"])

    model = llama.Llama.init(llama.LlamaConfig.tiny(),
                             generator=torch.Generator().manual_seed(0),
                             dtype=torch.float32, device="cpu",
                             trainable=True)
    assert sanity.nonfinite_leaves(model) == []
    model.final_norm.grad = torch.full_like(model.final_norm, float("nan"))
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    assert sanity.nonfinite_leaves(grads) == ["final_norm"]


@pytest.mark.parametrize("n,seq,batch,seed", [(1000, 16, 4, 0),
                                              (2049, 2048, 1, 3),
                                              (513, 32, 3, 7)])
def test_token_dataset_matches_mfa_tpu(n, seq, batch, seed):
    stream = np.random.default_rng(seed).integers(0, 50_000, n)
    want = jax_data.TokenDataset(stream, seq, batch, seed=seed)
    got = data.TokenDataset(stream, seq, batch, seed=seed)
    assert len(got) == len(want)
    for epoch in (0, 1):
        pairs = list(zip(got.epoch(epoch), want.epoch(epoch), strict=True))
        assert pairs
        for a, b in pairs:
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="too short"):
        data.TokenDataset(stream[:10], seq, batch)
