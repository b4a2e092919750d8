"""The port's sequence parallel layer (parallel/ring_attention.py,
parallel/ulysses.py) on eight gloo ranks, spawned once for the file,
against mfa_tpu's make_ring_attention, ring_flash_attention and Ulysses
on its 8-device virtual mesh from the same numpy inputs, at
tests/test_parallel.py's, tests/test_ring_bwd.py's and tests/test_aux.py's
sizes and budgets: ring O at sp 4 (with tp 2) causal and not and at sp 8,
ring gradients at sp 4 and 8 in fp32 and with bf16 travel, GQA, Ulysses
forward and backward, bad heads, choose_cp_mode; and the one-process
schedule of every rank's steps (what chip_smoke.py drives on the card)
equal to the gloo ring bit for bit."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import torch_ranks
from mfa_tpu.parallel import mesh as jax_mesh
from mfa_tpu.parallel.ring_attention import (
    make_ring_attention,
    ring_flash_attention,
)
from mfa_tpu.parallel.ulysses import (
    choose_cp_mode as jax_choose_cp_mode,
    make_ulysses_attention,
    ulysses_attention,
)
from mfa_tpu_torch.parallel import mesh as mesh_mod
from mfa_tpu_torch.parallel import ring_attention
from mfa_tpu_torch.parallel.ulysses import HBM_SHARE, choose_cp_mode
from mfa_tpu_torch.utils.testing import assert_close

WORLD = 8
# (name, kind, mesh, (b, hq, hkv, s, d), causal, grads, dtype, budget):
# mfa_tpu's own budgets for its ring and Ulysses against one device.
CASES = [
    ("ring_o_sp4", "ring", dict(tp=2, sp=4), (1, 2, 2, 256, 32), False,
     False, "fp32", 5e-5),
    ("ring_o_sp4_causal", "ring", dict(tp=2, sp=4), (1, 2, 2, 256, 32),
     True, False, "fp32", 5e-5),
    ("ring_o_sp8", "ring", dict(sp=8), (1, 1, 1, 512, 32), True, False,
     "fp32", 5e-5),
    ("ring_grads_sp4", "ring", dict(tp=2, sp=4), (1, 2, 2, 256, 32), False,
     True, "fp32", 5e-5),
    ("ring_grads_sp4_causal", "ring", dict(tp=2, sp=4), (1, 2, 2, 256, 32),
     True, True, "fp32", 5e-5),
    ("ring_grads_sp8", "ring", dict(sp=8), (1, 1, 1, 256, 16), True, True,
     "fp32", 5e-5),
    ("ring_grads_sp4_bf16", "ring", dict(sp=4), (1, 2, 2, 256, 32), True,
     True, "bf16", 5e-2),
    ("ring_grads_sp8_bf16", "ring", dict(sp=8), (1, 2, 2, 256, 32), False,
     True, "bf16", 5e-2),
    ("ring_grads_sp4_gqa", "ring", dict(sp=4), (1, 4, 2, 256, 32), True,
     True, "fp32", 5e-5),
    ("ulysses_o", "ulysses", dict(sp=4), (1, 8, 8, 256, 32), False, False,
     "fp32", 5e-5),
    ("ulysses_o_causal", "ulysses", dict(sp=4), (1, 8, 8, 256, 32), True,
     False, "fp32", 5e-5),
    ("ulysses_grads_causal", "ulysses", dict(sp=4), (1, 8, 8, 256, 32),
     True, True, "fp32", 5e-5),
    ("ulysses_gqa", "ulysses", dict(sp=4), (1, 8, 4, 128, 32), False, False,
     "fp32", 5e-5),
]
BY_NAME = {c[0]: c for c in CASES}
# jnp dtypes of the cases.
JDTYPES = {"fp32": jnp.float32, "bf16": jnp.bfloat16}


def _inputs(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)

    def gen(h):
        return rng.standard_normal((b, h, s, d)).astype(np.float32)

    return gen(hq), gen(hkv), gen(hkv), gen(hq)


@pytest.fixture(scope="module")
def inputs():
    return {c[0]: _inputs(i, *c[3]) for i, c in enumerate(CASES)}


@pytest.fixture(scope="module")
def ranks(inputs):
    cases = [dict(name=name, kind=kind, mesh=mesh, causal=causal,
                  grads=grads, dtype=dtype, inputs=inputs[name])
             for name, kind, mesh, _, causal, grads, dtype, _ in CASES]
    return mesh_mod.spawn(torch_ranks.attention_suite, WORLD, cases,
                          timeout_s=600)


def _assemble(ranks, name, key):
    """Place every rank's block (tp: heads, sp: sequence) in the global
    array."""
    blocks = {}
    for r in ranks:
        if name in r:
            blocks[(r[name]["tp"], r[name]["sp"])] = r[name][key]
    tps = 1 + max(t for t, _ in blocks)
    sps = 1 + max(s for _, s in blocks)
    return np.concatenate([np.concatenate([blocks[(t, s)] for s in range(sps)],
                                          axis=2) for t in range(tps)],
                          axis=1)


def _jax_mesh(mesh):
    return jax_mesh.make_mesh(dp=1, tp=mesh.get("tp", 1), sp=mesh["sp"])


def _jax_grads(kind, mesh, q, k, v, do, causal):
    """tests/test_ring_bwd.py's shard_map gradient of sum(dO * O)."""
    spec = P("dp", "tp", "sp", None)
    attn = ring_flash_attention if kind == "ring" else ulysses_attention

    @jax.jit
    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=(spec,) * 4, out_specs=(spec,) * 4,
                       check_vma=False)
    def grads(q, k, v, do):
        def loss(q, k, v):
            o = attn(q, k, v, causal=causal)
            return jnp.sum(do.astype(jnp.float32) * o.astype(jnp.float32))

        o = attn(q, k, v, causal=causal)
        return (o, *jax.grad(loss, argnums=(0, 1, 2))(q, k, v))

    return grads(q, k, v, do)


def _jax(name, inputs):
    _, kind, mesh, _, causal, grads, dtype, _ = BY_NAME[name]
    q, k, v, do = (jnp.asarray(a, JDTYPES[dtype]) for a in inputs[name])
    m = _jax_mesh(mesh)
    if grads:
        return _jax_grads(kind, m, q, k, v, do, causal)
    make = make_ring_attention if kind == "ring" else make_ulysses_attention
    return (make(m, causal=causal)(q, k, v),)


@pytest.mark.parametrize("name", list(BY_NAME))
def test_matches_mfa_tpu(ranks, inputs, name):
    budget = BY_NAME[name][-1]
    keys = ("o", "dq", "dk", "dv") if BY_NAME[name][5] else ("o",)
    for key, want in zip(keys, _jax(name, inputs)):
        want = np.asarray(jnp.asarray(want, jnp.float32))
        got = _assemble(ranks, name, key)
        assert got.shape == want.shape
        assert_close(got, want, budget, f"{name} {key}")


@pytest.mark.parametrize("name", ["ring_grads_sp8", "ring_grads_sp4_bf16",
                                  "ring_grads_sp8_bf16",
                                  "ring_grads_sp4_gqa"])
def test_one_process_schedule_is_the_ring_bit_for_bit(ranks, name):
    sched = ranks[0]["schedule_" + name]
    for key, got in zip(("o", "dq", "dk", "dv"), sched):
        np.testing.assert_array_equal(got, _assemble(ranks, name, key),
                                      err_msg=f"{name} {key}")


def test_ulysses_rejects_bad_heads(ranks):
    assert [r["bad_heads"] for r in ranks[:4]] == [True] * 4
    assert all("bad_heads" not in r for r in ranks[4:])


def test_merge_of_skipped_chunks_is_finite():
    import torch

    o = torch.ones(1, 1, 3, 2)
    lse = torch.tensor([[[0.5, float("-inf"), 2.0]]])
    empty_o, empty_lse = ring_attention.init_partials(o)
    mo, ml = ring_attention._merge(empty_o, empty_lse, o, lse)
    assert torch.equal(ml, lse)
    assert torch.equal(mo[0, 0, 0], o[0, 0, 0])
    assert torch.equal(mo[0, 0, 1], torch.zeros(2))
    mo, ml = ring_attention._merge(empty_o, empty_lse, empty_o, empty_lse)
    assert torch.isinf(ml).all() and torch.equal(mo, empty_o)


@pytest.mark.parametrize("hq,hkv,s,d,n", [
    (32, 8, 1 << 15, 128, 4), (32, 8, 1 << 20, 128, 8), (28, 4, 1 << 17,
                                                         128, 8),
    (8, 8, 256, 32, 4), (64, 8, 1 << 22, 128, 8), (2, 2, 64, 16, 4)])
@pytest.mark.parametrize("budget", [12 * 2**30, int(HBM_SHARE * 80e9)])
def test_choose_cp_mode_matches_mfa_tpu(hq, hkv, s, d, n, budget):
    for batch in (1, 4):
        kw = dict(hbm_budget_bytes=budget, batch=batch)
        assert choose_cp_mode(hq, hkv, s, d, n, device="cpu", **kw) == \
            jax_choose_cp_mode(hq, hkv, s, d, n, **kw)


def test_choose_cp_mode_needs_a_budget_on_the_cpu():
    with pytest.raises(ValueError, match="hbm_budget_bytes"):
        choose_cp_mode(8, 8, 256, 32, 4, device="cpu")
