"""The port's sharded serving (serving/distributed.py) on four gloo ranks,
spawned once for the file, against mfa_tpu's single-chip step and
scheduler from the same numpy weights, at tests/test_distributed.py's
sizes and budgets: the (dp 2, tp 2) decode step's logits (2e-4),
lengths (exact) and appended K row (2e-5); a tp that does not divide
the KV heads and slots that do not divide over dp raise; the sharded
scheduler's greedy tokens equal to mfa_tpu's ContinuousBatchingScheduler
exactly over FP32 and INT8 caches; and the dry run's sharded cycle and
its four-card parity checks (parallel/dryrun.py) at small sizes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_ranks
from mfa_tpu.models import llama as jax_llama
from mfa_tpu.ops.precision import OperandPrecision as JPrec
from mfa_tpu.serving import kv_cache as jax_kv
from mfa_tpu.serving.scheduler import ContinuousBatchingScheduler, Request
from mfa_tpu_torch.parallel import mesh as mesh_mod
from mfa_tpu_torch.parallel import sharding
from mfa_tpu_torch.serving import distributed

WORLD = 4
BATCH, CTX = 4, 96
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], [11, 12, 13, 14, 15, 16, 17]]


@pytest.fixture(scope="module")
def data():
    cfg = jax_llama.LlamaConfig.tiny()
    rng = np.random.default_rng(0)
    fill = [(rng.standard_normal((BATCH, cfg.n_kv_heads, CTX, cfg.head_dim))
             * 0.3).astype(np.float32) for _ in range(cfg.n_layers)]
    params = {s: jax_llama.init_params(jax.random.key(s), cfg, jnp.float32)
              for s in (0, 1)}
    return {"cfg": cfg, "jax": params, "fill": fill, "ctx": CTX,
            "prompts": PROMPTS,
            "tiny0": jax.tree.map(np.asarray, params[0]),
            "tiny1": jax.tree.map(np.asarray, params[1])}


@pytest.fixture(scope="module")
def ranks(data):
    sent = {k: v for k, v in data.items() if k not in ("cfg", "jax")}
    return mesh_mod.spawn(torch_ranks.distributed_suite, WORLD, sent,
                          timeout_s=600)


def test_sharded_decode_step_matches_single_chip(ranks, data):
    cfg = data["cfg"]
    caches = [jax_kv.update(c, jnp.asarray(kv), jnp.asarray(kv))
              for c, kv in zip(jax_llama.make_caches(cfg, BATCH, 128,
                                                     JPrec.FP32),
                               data["fill"])]
    logits, caches = jax_llama.decode_step(
        data["jax"][0], cfg, jnp.asarray([3, 5, 7, 11], jnp.int32), caches)
    lengths = np.asarray(caches[0].lengths)
    # mfa_tpu's cache pads the head dim to 128 lanes.
    row = np.asarray(caches[0].k[:, :, CTX, :cfg.head_dim])
    for r in ranks:
        got = r["decode"]
        np.testing.assert_allclose(got["logits"], np.asarray(logits),
                                   atol=2e-4)
        b = slice(2 * got["dp"], 2 * got["dp"] + 2)
        h = slice(got["tp"], got["tp"] + 1)
        np.testing.assert_array_equal(got["lengths"], lengths[b])
        np.testing.assert_allclose(got["row"], row[b, h], atol=2e-5)


def test_sharded_decode_step_rejects_bad_tp(ranks):
    assert all(r["bad_tp"] and r["bad_tp_scheduler"] for r in ranks)


def test_sharded_scheduler_rejects_slots_that_do_not_divide(ranks):
    assert all(r["odd_slots"] for r in ranks)


@pytest.mark.parametrize("kv_prec", [JPrec.FP32, JPrec.INT8])
def test_sharded_scheduler_matches_single_chip(ranks, data, kv_prec):
    """One admit -> decode -> retire cycle over (dp 2, tp 2): mfa_tpu's
    single-chip greedy tokens exactly, on every rank, with local caches
    of one slot and one KV head."""
    ref = ContinuousBatchingScheduler(
        data["jax"][1], data["cfg"], num_slots=2, max_len=128,
        kv_precision=kv_prec, prompt_buckets=(8, 16), temperature=0.0)
    reqs = [Request(prompt=p, max_new_tokens=6) for p in PROMPTS]
    for r in reqs:
        ref.submit(r)
    done = {c.request.id: c.tokens for c in ref.run(max_steps=64)}
    want = [done[r.id] for r in reqs]
    for r in ranks:
        got = r[kv_prec.value]
        assert got["tokens"] == want
        assert got["stats"] == ref.stats
        assert got["cache_shape"][:2] == (1, 1)


def test_cache_specs_match_the_sharding_module():
    assert distributed.cache_spec() == sharding.cache_specs()
    spec = distributed.replicated_cache_spec()
    assert spec["k"] == {"tp": 1} and spec["lengths"] == {}


def test_dryrun_sharded_cycle_and_parity_part2(ranks):
    """parallel/dryrun.py's INT8 cycle (three requests of 4 tokens) and
    the checks its four-card --parity run makes, at small sizes: a pp = 4
    Llama within the bf16 budget of one card and bit-equal to its
    one-process schedule, (dp 2, tp 2) serving logits within the budget,
    every request complete, dp scaling ratios positive."""
    for r in ranks:
        cyc = r["serving_dryrun"]
        assert cyc["completions"] == 3 and cyc["new_tokens"] == [4, 4, 4]
        res = r["parity_part2"]
        assert res["ok"], res
        assert res["pp_bit_equal_schedule"] and res["layers_a_rank"] == 1
        for kv in ("bf16", "int8"):
            assert res[kv]["completions"] == 6
        for step in ("loss_step", "train_step"):
            assert res["scaling"][step]["efficiency"] > 0
            assert res["scaling"][step]["dp"] == WORLD
