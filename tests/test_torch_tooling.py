"""The port's tooling against mfa_tpu's: the roofline arithmetic
(utils/roofline.py), Metrics and trace (utils/profiling.py), and the
nn.Module FlashSelfAttention (models/nn_interop.py) against the flax
module with its weights carried across."""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.models.flax_interop import FlashSelfAttention as FlaxAttention
from mfa_tpu.utils import profiling as jax_profiling
from mfa_tpu.utils import roofline as jax_roofline
from mfa_tpu_torch.models.nn_interop import (
    FlashSelfAttention,
    load_flax_params,
)
from mfa_tpu_torch.utils import profiling, roofline

KINDS = ("forward", "backward_query", "backward_key_value", "train")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("causal", [False, True])
def test_attention_instrs_and_flops_equal_mfa_tpus(kind, causal):
    for r, c, d, bh in ((1, 1, 8, 1), (2048, 2048, 128, 32),
                        (512, 2048, 64, 7), (8192, 8192, 128, 256),
                        (129, 333, 96, 3)):
        args = (kind, r, c, d, bh, causal)
        assert roofline.attention_instrs(*args) == \
            jax_roofline.attention_instrs(*args)
        assert roofline.attention_flops(*args) == \
            jax_roofline.attention_flops(*args)


def test_bound_is_the_larger_of_operations_and_bytes():
    ms, by = roofline.bound(989e9, 1.0)
    assert by == "operations" and ms == pytest.approx(1.0)
    ms, by = roofline.bound(1.0, 3.35e9)
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, _ = roofline.bound(67e9, 0.0, roofline.FP32_FLOPS)
    assert ms == pytest.approx(1.0)


def test_bench_result_arithmetic(monkeypatch):
    """mfa_tpu's BenchResult arithmetic, at the H100's peaks; measure
    times on the card only."""
    res = roofline.BenchResult("k", latency_s=2e-3, flops=989e9,
                               bytes_accessed=3.35e9 * 4)
    assert res.tflops == pytest.approx(989e9 / 2e-3 / 1e12)
    assert res.ginstrs == pytest.approx(989e9 / 2 / 2e-3 / 1e9)
    assert res.hbm_gbps == pytest.approx(3.35e9 * 4 / 2e-3 / 1e9)
    assert res.compute_bound_utilization == pytest.approx(0.5)
    # Byte-bound: 4 ms of bytes against 2 ms measured is impossible, so a
    # result this fast would read as twice the speed of light.
    assert res.roofline_utilization == pytest.approx(2.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        roofline.measure(lambda: None, (), 1.0, 1.0)


def test_metrics_snapshot_has_mfa_tpus_keys():
    ours, theirs = profiling.Metrics(), jax_profiling.Metrics()
    for m in (ours, theirs):
        m.inc("requests")
        m.inc("requests", 2)
        m.set("slots", 4)
        with m.timed("step"):
            pass
    a, b = ours.snapshot(), theirs.snapshot()
    assert a.keys() == b.keys()
    assert a["counters"] == b["counters"] == {"requests": 3}
    assert a["gauges"] == b["gauges"] == {"slots": 4}
    assert a["latencies"].keys() == b["latencies"].keys() == {"step"}
    assert a["latencies"]["step"].keys() == b["latencies"]["step"].keys()
    assert a["latencies"]["step"]["count"] == 1


def test_metrics_counters_survive_threads():
    m = profiling.Metrics()

    def work():
        for _ in range(2000):
            m.inc("n")

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert m.snapshot()["counters"]["n"] == 16000


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with profiling.trace(tmp_path / "t", device="cpu") as d:
        torch.randn(64, 64) @ torch.randn(64, 64)
    files = list(d.glob("trace_*.json"))
    assert len(files) == 1
    assert "traceEvents" in json.loads(files[0].read_text())


# (name, flax/port options): the module's mask options.
ATTN_CASES = {
    "causal_gqa": dict(num_heads=4, num_kv_heads=2, causal=True),
    "mha": dict(num_heads=4),
    "window8": dict(num_heads=4, num_kv_heads=2, causal=True,
                    sliding_window=8),
    "softcap30": dict(num_heads=4, num_kv_heads=1, logit_soft_cap=30.0),
}


@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_flash_self_attention_matches_the_flax_module(name):
    """Outputs, and the input gradient through K3/K4's plain versions
    against jax.grad through mfa_tpu's backward kernels (interpret mode),
    at tests/test_utils.py's atol of 2e-4."""
    opts = ATTN_CASES[name]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 64)).astype(np.float32)
    w = rng.standard_normal((2, 32, 64)).astype(np.float32)
    flax_mod = FlaxAttention(dtype=jnp.float32, **opts)
    params = flax_mod.init(jax.random.key(0), jnp.asarray(x))
    want = flax_mod.apply(params, jnp.asarray(x))
    want_dx = jax.grad(lambda xx: jnp.sum(
        flax_mod.apply(params, xx) * w))(jnp.asarray(x))

    ours = load_flax_params(
        FlashSelfAttention(64, dtype=torch.float32, device="cpu", **opts),
        jax.tree.map(np.asarray, params))
    xt = torch.from_numpy(x).requires_grad_()
    y = ours(xt)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               atol=2e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx),
                               atol=2e-4)
    assert ours.q_proj.weight.grad is not None


def test_flash_self_attention_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FlashSelfAttention(64, 4)
