"""The port's tensor and data parallel layer (parallel/mesh.py,
parallel/sharding.py, the tp Llama, the dp/tp train steps) on four gloo
ranks, spawned once for the file, against mfa_tpu on its 8-device
virtual mesh from the same numpy inputs: forward, prefill and decode
logits over sharded caches at tp 2, tp 4 and dp 2 x tp 2, INT8 weights
under tp, the dry run's (dp, tp) SGD step; and the port's AdamW step over
(dp 2, tp 2) against its own single-process step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from mfa_tpu.models import llama as jax_llama
from mfa_tpu.ops.precision import OperandPrecision as JPrec
from mfa_tpu.parallel import mesh as jax_mesh
from mfa_tpu.parallel import sharding as jax_sharding
from mfa_tpu_torch.kernels.quant import quantize_weight
from mfa_tpu_torch.models import llama
from mfa_tpu_torch.ops.precision import OperandPrecision
from mfa_tpu_torch.parallel import dryrun, sharding
from mfa_tpu_torch.parallel import mesh as mesh_mod
from mfa_tpu_torch.utils.testing import assert_close

WORLD = 4
# mfa_tpu's own budget for sharded against replicated logits
# (tests/test_parallel.py:60); the fp32 sides differ in summation order.
TOL = 1e-3


def _jax_cfg(cfg):
    return jax_llama.LlamaConfig(**{f: getattr(cfg, f) for f in (
        "vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
        "ffn_hidden", "rope_theta", "norm_eps")})


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    tiny = jax_llama.LlamaConfig.tiny()
    variant = _jax_cfg(torch_ranks.variant_config())
    dcfg = _jax_cfg(dryrun.dryrun_config(2))
    params = {
        "tiny": jax_llama.init_params(jax.random.key(0), tiny, jnp.float32),
        "variant": jax_llama.init_params(jax.random.key(1), variant,
                                         jnp.float32),
        "dryrun_params": jax_llama.init_params(jax.random.key(0), dcfg,
                                               jnp.float32),
    }
    out = {name: jax.tree.map(np.asarray, p) for name, p in params.items()}
    out.update(
        jax=params, cfgs={"tiny": tiny, "variant": variant, "dryrun": dcfg},
        tokens=rng.integers(0, tiny.vocab_size, (2, 16)),
        prompt=rng.integers(0, tiny.vocab_size, (2, 10)),
        decode=[rng.integers(0, tiny.vocab_size, (2,)) for _ in range(3)],
        dryrun_tokens=rng.integers(0, dcfg.vocab_size, (4, 33)),
        train_tokens=rng.integers(0, tiny.vocab_size, (4, 17)))
    return out


@pytest.fixture(scope="module")
def ranks(data):
    """The four ranks' results (llama_suite), spawned once."""
    sent = {k: v for k, v in data.items() if k not in ("jax", "cfgs")}
    return mesh_mod.spawn(torch_ranks.llama_suite, WORLD, sent,
                          timeout_s=600)


def _assemble(ranks, case, key):
    """The dp slices of one output in dp order (every tp rank of a dp
    slice holds the same replicated logits: they must agree bit for
    bit)."""
    by_dp = {}
    for r in ranks:
        if case in r:
            got = r[case][key]
            prev = by_dp.setdefault(r[case]["dp"], got)
            np.testing.assert_array_equal(prev, got)
    # decode: [steps, B/dp, V] a dp rank.
    return np.concatenate([np.asarray(by_dp[i]) for i in sorted(by_dp)],
                          axis=1 if key == "decode" else 0)


def test_make_mesh_refuses_a_world_smaller_than_the_mesh(ranks, tmp_path):
    with pytest.raises(ValueError, match="need 64 ranks, have 8"):
        mesh_mod.make_mesh(dp=4, tp=4, sp=4, device="cpu",
                           init_method=f"file://{tmp_path}/rdv", rank=0,
                           world_size=8)
    assert not torch.distributed.is_initialized()
    assert all(r["too_few_ranks"] for r in ranks)
    with pytest.raises(ValueError):
        jax_mesh.make_mesh(dp=4, tp=4, sp=4)


@pytest.mark.parametrize("tp", [1, 2])
def test_local_params_shapes(tp):
    cfg = llama.LlamaConfig.tiny()
    full = llama.init_params(cfg, torch.Generator().manual_seed(0),
                             torch.float32)
    hd = cfg.head_dim
    for rank in range(tp):
        local = sharding.local_params(full, cfg, tp, rank)
        layer = local["layers"][0]
        assert layer["wq"].shape == (cfg.n_heads * hd // tp, cfg.dim)
        assert layer["wk"].shape == (cfg.n_kv_heads * hd // tp, cfg.dim)
        assert layer["wo"].shape == (cfg.dim, cfg.n_heads * hd // tp)
        assert layer["w_up"].shape == (cfg.ffn_hidden // tp, cfg.dim)
        assert layer["w_down"].shape == (cfg.dim, cfg.ffn_hidden // tp)
        assert local["lm_head"].shape == (cfg.vocab_size // tp, cfg.dim)
        assert local["embed"] is full["embed"]
        assert layer["attn_norm"] is full["layers"][0]["attn_norm"]
        n = cfg.n_heads * hd // tp
        assert torch.equal(layer["wq"], full["layers"][0]["wq"][
            rank * n:(rank + 1) * n])
        d = cfg.ffn_hidden // tp
        assert torch.equal(layer["w_down"], full["layers"][0]["w_down"][
            :, rank * d:(rank + 1) * d])
    if tp == 1:
        # No second copy: the same tensors.
        assert local["layers"][1]["w_down"] is full["layers"][1]["w_down"]


def test_specs_match_mfa_tpu():
    cfg = llama.LlamaConfig.tiny()
    full = llama.init_params(cfg, torch.Generator().manual_seed(0),
                             torch.float32)
    jparams = jax_llama.init_params(jax.random.key(0),
                                    jax_llama.LlamaConfig.tiny(), jnp.float32)
    jspecs = jax_sharding.param_specs(jparams)
    specs = sharding.param_specs(full)
    # mfa_tpu's [in, out] dim d over tp is the port's [out, in] dim 1 - d.
    for name, spec in specs["layers"][0].items():
        jspec = tuple(jspecs["layers"][0][name])
        want = None if "tp" not in jspec else 1 - jspec.index("tp")
        assert spec == want, name
    assert specs["lm_head"] == 0 and specs["embed"] is None


def test_int4_row_parallel_and_indivisible_heads_raise():
    cfg = llama.LlamaConfig.tiny()
    full = llama.init_params(cfg, torch.Generator().manual_seed(0),
                             torch.float32)
    int4 = llama.quantize_params(full, OperandPrecision.INT4)
    with pytest.raises(NotImplementedError, match="row-parallel"):
        sharding.local_params(int4, cfg, 2, 0)
    col = dict(full, layers=[dict(layer, wq=quantize_weight(layer["wq"],
                                                            "int4"))
                             for layer in full["layers"]])
    local = sharding.local_params(col, cfg, 2, 1)
    wq = local["layers"][0]["wq"]
    assert wq.w.shape == (cfg.dim // 2, cfg.dim // 2)
    assert torch.equal(wq.scale, col["layers"][0]["wq"].scale[cfg.dim // 2:])
    with pytest.raises(ValueError, match="does not divide n_kv_heads = 2"):
        sharding.local_params(full, cfg, 4, 0)
    with pytest.raises(ValueError, match="does not divide n_heads = 4"):
        sharding.local_params(full, cfg, 3, 0)


def test_int8_shards_its_scale_with_column_parallel_weights():
    cfg = llama.LlamaConfig.tiny()
    full = llama.quantize_params(
        llama.init_params(cfg, torch.Generator().manual_seed(0),
                          torch.float32), OperandPrecision.INT8)
    layer = sharding.local_params(full, cfg, 2, 1)["layers"][0]
    g = full["layers"][0]
    assert torch.equal(layer["wq"].scale, g["wq"].scale[cfg.dim // 2:])
    assert layer["wo"].scale is g["wo"].scale
    assert torch.equal(layer["wo"].w, g["wo"].w[:, cfg.dim // 2:])


def _jax_logits(data, key):
    params, cfg = data["jax"][key], data["cfgs"][key]
    return np.asarray(jax_llama.forward(params, cfg,
                                        jnp.asarray(data["tokens"],
                                                    jnp.int32)))


@pytest.mark.parametrize("case,key", [("tp2", "tiny"), ("dp2_tp2", "tiny"),
                                      ("tp4", "variant")])
def test_tp_forward_matches_mfa_tpu(ranks, data, case, key):
    assert_close(_assemble(ranks, case, "logits"), _jax_logits(data, key),
                 TOL, f"{case} logits")


@pytest.mark.parametrize("case,key", [("tp2", "tiny"), ("dp2_tp2", "tiny"),
                                      ("tp4", "variant")])
def test_tp_prefill_and_decode_on_sharded_caches_match_mfa_tpu(
        ranks, data, case, key):
    params, cfg = data["jax"][key], data["cfgs"][key]
    caches = jax_llama.make_caches(cfg, 2, torch_ranks.MAX_LEN, JPrec.BF16)
    want, caches = jax_llama.forward(
        params, cfg, jnp.asarray(data["prompt"], jnp.int32), caches=caches)
    assert_close(_assemble(ranks, case, "prefill"), np.asarray(want), TOL,
                 f"{case} prefill")
    got = _assemble(ranks, case, "decode")
    for step, tok in enumerate(data["decode"]):
        want, caches = jax_llama.decode_step(
            params, cfg, jnp.asarray(tok, jnp.int32), caches)
        assert_close(got[step], np.asarray(want), TOL,
                     f"{case} decode {step}")
    tp = 4 if case == "tp4" else 2
    heads = {r[case]["cache_heads"] for r in ranks if case in r}
    assert heads == {cfg.n_kv_heads // tp}


@pytest.mark.parametrize("case,key", [("int8_tp2", "tiny"),
                                      ("int8_tp4", "variant")])
def test_tp_int8_forward_matches_mfa_tpu(ranks, data, case, key):
    params = jax_llama.quantize_params(data["jax"][key], JPrec.INT8)
    want = jax_llama.forward(params, data["cfgs"][key],
                             jnp.asarray(data["tokens"], jnp.int32))
    assert_close(_assemble(ranks, case, "logits"), np.asarray(want), TOL,
                 f"{case} logits")


def _jax_sgd_step(params, cfg, tokens):
    """__graft_entry__.py::dryrun_multichip's train step."""
    def loss_fn(p):
        logits = jax_llama.forward(p, cfg, tokens[:, :-1])
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, tokens[:, 1:][..., None], axis=-1)
        return jnp.mean(nll)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return loss, jax.tree_util.tree_map(lambda p, g: p - 1e-3 * g, params,
                                        grads)


def test_dryrun_sgd_step_matches_mfa_tpu(ranks, data):
    cfg = data["cfgs"]["dryrun"]
    loss, new = _jax_sgd_step(data["jax"]["dryrun_params"], cfg,
                              jnp.asarray(data["dryrun_tokens"], jnp.int32))
    for r in ranks:
        np.testing.assert_allclose(r["sgd"]["loss"], float(loss), rtol=1e-5)
    new = jax.tree.map(np.asarray, new)
    checked = 0
    for r in ranks:
        for name, got in r["sgd"]["params"].items():
            parts = name.split(".")
            want = (new[parts[0]] if parts[0] != "layers"
                    else new["layers"][int(parts[1])][parts[2]])
            if parts[-1] in ("wq", "wk", "wv", "wo", "w_gate", "w_up",
                             "w_down", "lm_head"):
                want = want.T
            dim = sharding.tp_dim(name)
            if dim is not None:
                n = want.shape[dim] // 2
                want = np.take(want, range(r["sgd"]["tp"] * n,
                                           (r["sgd"]["tp"] + 1) * n), dim)
            assert_close(got, want, 1e-5, f"rank sgd {name}")
            checked += 1
    assert checked == WORLD * (3 + 9 * cfg.n_layers)


def test_adamw_train_step_over_dp_and_tp_matches_one_process(ranks):
    for r in ranks:
        res = r["adamw"]
        # Loss and the clip's global norm (tp-sharded squares summed over
        # tp, replicated ones once) at each step: fp32 summation order.
        for row in res["steps"]:
            for key, (got, want) in row.items():
                np.testing.assert_allclose(got, want, rtol=1e-5,
                                           err_msg=key)
        assert res["steps"][-1]["loss"][0] < res["steps"][0]["loss"][0]
        # The first step's gradients (same parameters on both sides): the
        # Megatron pair and the dp mean, up to summation order.
        for name, (got, want) in res["grads"].items():
            assert_close(got, want, 1e-5 * float(np.abs(want).max()),
                         f"grad {name}")
        # AdamW is scale-free: an element whose gradient is near the
        # summation noise may take a different fraction of its ~lr step.
        # 1e-3 is a tenth of one step at lr 1e-2.
        worst = max(res["param_diff"].values())
        assert worst <= 1e-3, res["param_diff"]


def test_parity_checks_hold_on_four_ranks(ranks):
    """parallel/dryrun.py::parity_checks, what the four-card run executes
    over NCCL: the ring at sp 4 equal to its one-process schedule bit for
    bit, Ulysses equal to full-sequence attention (here bit for bit), a
    tp 4 Llama's logits within the bf16 mixed budget of the unsharded
    one's."""
    for r in ranks:
        res = r["parity"]
        assert res["ok"], res
        assert all(res[f"{kind}_{mode}_bit_equal"]
                   for kind in ("ring", "ulysses")
                   for mode in ("causal", "noncausal")), res
        assert res["kv_heads_a_rank"] == 1 and len(res["logit_shares"]) == 4
