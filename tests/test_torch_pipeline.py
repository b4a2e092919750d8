"""The port's pipeline (parallel/pipeline.py, models/llama.py's
stack_layer_params and forward_pipelined) on eight gloo ranks, spawned
once for the file, against mfa_tpu from the same numpy inputs, at
tests/test_pipeline.py's sizes and budgets: the GPipe schedule against
serial stages at M 4, 8 and 6 (fp32, 1e-5), with dp (pp 4 x dp 2), the
pp axis required, dp sharding real (each replica sees mb/dp examples),
gradients against serial (1e-4), a pp 2 Llama against mfa_tpu's
forward_pipelined and forward (2e-4, rtol 1e-4); the one-process
pipeline_schedule equal to the gloo pipeline bit for bit; and
utils/overlap.py's order check of the ring's and the pipeline's
transfers (twin of tests/test_parallel.py::
test_ring_ppermute_overlap_structure), which flags an edit that waits
for a rotation in its own step."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from mfa_tpu.models import llama as jax_llama
from mfa_tpu.parallel import mesh as jax_mesh
from mfa_tpu_torch.models import llama
from mfa_tpu_torch.models.from_jax import params_from_numpy
from mfa_tpu_torch.ops.precision import OperandPrecision
from mfa_tpu_torch.parallel import mesh as mesh_mod
from mfa_tpu_torch.parallel import pipeline
from mfa_tpu_torch.utils import overlap

WORLD = 8


def _stage_fn(p, x):
    """tests/test_pipeline.py's stage, in JAX."""
    h = jnp.tanh(x @ p["w1"] + p["b1"])
    return x + h @ p["w2"]


def _serial(stages, x):
    for p in stages:
        x = _stage_fn(p, x)
    return x


def _make_stages(rng, n_stages, dim, hidden):
    return [{"w1": (rng.standard_normal((dim, hidden)) * 0.1
                    ).astype(np.float32),
             "b1": (rng.standard_normal((hidden,)) * 0.1).astype(np.float32),
             "w2": (rng.standard_normal((hidden, dim)) * 0.1
                    ).astype(np.float32)} for _ in range(n_stages)]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    cfg = replace(jax_llama.LlamaConfig.tiny(), n_layers=4)
    params = jax_llama.init_params(jax.random.key(0), cfg, jnp.float32)
    return {
        "stages4": _make_stages(rng, 4, 64, 128),
        "x": {m: rng.standard_normal((m * 3, 16, 64)).astype(np.float32)
              for m in (4, 8, 6)},
        "stages_dp": _make_stages(rng, 4, 32, 64),
        "x_dp": rng.standard_normal((8, 4, 32)).astype(np.float32),
        "stages_probe": _make_stages(rng, 2, 16, 32),
        "x_probe": rng.standard_normal((8, 4, 16)).astype(np.float32),
        "stages_grad": _make_stages(rng, 2, 16, 32),
        "x_grad": rng.standard_normal((4, 2, 16)).astype(np.float32),
        "llama": jax.tree.map(np.asarray, params),
        "tokens": rng.integers(0, cfg.vocab_size, (8, 16)),
        "ring": [rng.standard_normal((1, 2, 16, 16)).astype(np.float32)
                 for _ in range(3)],
        "jax": (cfg, params)}


@pytest.fixture(scope="module")
def ranks(data):
    sent = {k: v for k, v in data.items() if k != "jax"}
    return mesh_mod.spawn(torch_ranks.pipeline_suite, WORLD, sent,
                          timeout_s=600)


@pytest.mark.parametrize("num_micro", [4, 8, 6])
def test_pipeline_matches_serial(ranks, data, num_micro):
    want = np.asarray(_serial(data["stages4"], data["x"][num_micro]))
    outs = [r["serial"][num_micro] for r in ranks if r["serial"]]
    assert len(outs) == 4
    for got in outs:       # the exit replicates the output over pp
        np.testing.assert_array_equal(got, outs[0])
    np.testing.assert_allclose(outs[0], want, atol=1e-5)


@pytest.mark.parametrize("num_micro", [4, 8, 6])
def test_pipeline_schedule_is_bit_equal_to_the_ranks(ranks, num_micro):
    np.testing.assert_array_equal(ranks[0]["schedule"][num_micro],
                                  ranks[0]["serial"][num_micro])


def test_pipeline_with_dp(ranks, data):
    want = np.asarray(_serial(data["stages_dp"], data["x_dp"]))
    for r in ranks:
        np.testing.assert_allclose(r["with_dp"], want, atol=1e-5)


def test_pipeline_requires_pp_axis(ranks):
    assert all(r["no_pp_axis"] and r["bad_batch"] for r in ranks)


def test_pipeline_dp_sharding_is_real(ranks):
    """microbatch = 8/4 = 2 examples; dp = 2: each replica's stage sees
    one, at every one of the M + S - 1 steps."""
    shapes = [r["probe_shapes"] for r in ranks if "probe_shapes" in r]
    assert len(shapes) == 4
    for seen in shapes:
        assert len(seen) == 4 + 2 - 1 and all(s[0] == 1 for s in seen)


def test_pipeline_grad(ranks, data):
    """Each stage's gradients of sum(out^2) against mfa_tpu's serial
    stack's, from the same weights."""
    stages, x = data["stages_grad"], data["x_grad"]

    def loss_serial(p):
        return jnp.sum(_serial(p, x) ** 2)

    want = jax.grad(loss_serial)(stages)
    got = {r["grads"]["stage"]: r["grads"]["grads"] for r in ranks
           if "grads" in r}
    assert sorted(got) == [0, 1]
    for s, grads in got.items():
        for name, g in grads.items():
            np.testing.assert_allclose(g, np.asarray(want[s][name]),
                                       atol=1e-4, rtol=1e-4, err_msg=name)


def test_llama_forward_pipelined_matches_mfa_tpu(ranks, data):
    cfg, params = data["jax"]
    mesh = jax_mesh.make_mesh(pp=2)
    tokens = jnp.asarray(data["tokens"], jnp.int32)
    want_pp = np.asarray(jax_llama.forward_pipelined(
        params, cfg, tokens, mesh=mesh, num_microbatches=4))
    want = np.asarray(jax_llama.forward(params, cfg, tokens))
    outs = [r for r in ranks if "llama" in r]
    assert len(outs) == 2 and {r["llama_stage_layers"] for r in outs} == {2}
    for r in outs:
        np.testing.assert_allclose(r["llama"], want_pp, atol=2e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(r["llama"], want, atol=2e-4, rtol=1e-4)
        np.testing.assert_array_equal(r["llama_schedule"], r["llama"])


def test_stack_layer_params_matches_mfa_tpu(data):
    """Every stacked leaf [stages, layers a stage, ...] equal to mfa_tpu's
    (its projections stored [in, out], the port's [out, in])."""
    cfg, params = data["jax"]
    want = jax_llama.stack_layer_params(params, 2)
    model = params_from_numpy(data["llama"], replace(
        llama.LlamaConfig.tiny(), n_layers=4), device="cpu")
    got = llama.stack_layer_params(model.params(), 2)
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        w = np.asarray(want[name])
        if w.ndim == 4:
            w = np.swapaxes(w, -1, -2)
        assert t.shape[:2] == (2, 2)
        np.testing.assert_array_equal(t.numpy(), w, err_msg=name)
    with pytest.raises(ValueError, match="not divisible"):
        llama.stack_layer_params(model.params(), 3)
    # Quantized weights stack too (both their bytes and their scales),
    # and a rank's stage of them is whole layers again.
    qparams = llama.quantize_params(model.params(), OperandPrecision.INT8)
    stacked = llama.stack_layer_params(qparams, 2)
    wq = stacked["wq"]
    assert wq.layout == "int8" and wq.w.shape[:2] == wq.scale.shape[:2] \
        == (2, 2)
    assert torch.equal(wq.w[1, 0], qparams["layers"][2]["wq"].w)
    assert torch.equal(wq.scale[1, 1], qparams["layers"][3]["wq"].scale)
    layers = llama._stage_layers(pipeline.tree_map(lambda a: a[1], stacked))
    assert len(layers) == 2 and torch.equal(
        layers[1].wq.w, qparams["layers"][3]["wq"].w)


def test_ring_and_pipeline_transfers_overlap(ranks):
    """Every rotation of the ring (forward: n - 1 = 7 a rank; backward 7
    K/V and 8 dK/dV) and every hop of the pipeline (M + S - 2 = 6 a
    stage) is waited for only after the compute of the step that issued
    it; the ring edited to wait before its step's compute is flagged."""
    for r in ranks:
        rep = r["overlap"]
        assert rep["ring_forward"]["ok"], rep["ring_forward"]
        assert rep["ring_forward"]["permutes"] == WORLD - 1
        assert rep["ring_grads"]["ok"], rep["ring_grads"]
        assert rep["ring_grads"]["scans"] == 2
        assert rep["ring_grads"]["permutes"] == (WORLD - 1) + (2 * WORLD - 1)
        edited = rep["ring_edited"]
        assert not edited["ok"]
        assert len(edited["violations"]) == WORLD - 1
        assert all("before that step's compute" in v
                   for _, v in edited["violations"])
    stages = [r["overlap"] for r in ranks if "pipeline" in r["overlap"]]
    assert len(stages) == 4
    for rep in stages:
        for key in ("pipeline", "pipeline_grads"):
            assert rep[key]["ok"], rep[key]
            assert rep[key]["permutes"] == 4 + 4 - 2


def test_overlap_flags_a_transfer_read_in_its_own_step():
    """The checker on hand-made loops: a transfer waited for before its
    step's compute, and one never waited for, are violations."""
    def loop(order):
        pending = {}
        for s in range(3):
            for event in order:
                if event == "issue":
                    pending[s] = object()
                    overlap.note("issue", "loop", s, pending[s])
                elif event == "compute":
                    overlap.note("compute", "loop", s)
                elif s in pending:
                    overlap.note("consume", "loop", s, pending.pop(s))

    good = overlap.check_overlap(loop, ("issue", "compute", "consume"))
    assert good.ok and good.permutes_seen == 3 and good.scans_seen == 1
    bad = overlap.check_overlap(loop, ("issue", "consume", "compute"))
    assert not bad.ok and len(bad.violations) == 3
    never = overlap.check_overlap(loop, ("issue", "compute"))
    assert not never.ok and all("never" in v for _, v in never.violations)
    assert not overlap.check_overlap(lambda: None).ok
    overlap.note("compute", "loop", 0)          # no check running: no-op


def test_pipeline_schedule_refuses_a_batch_that_does_not_divide():
    x = np.zeros((5, 2, 4), np.float32)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline.pipeline_schedule(torch_ranks.stage_fn, [{}],
                                   torch.from_numpy(x), num_microbatches=2)
