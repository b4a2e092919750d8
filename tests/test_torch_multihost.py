"""The port's multi-host bootstrap and scaling harness
(parallel/multihost.py), twins of tests/test_multihost.py: the bootstrap
is a no-op in one process, the single-host layout and its axis names,
too many ranks raise, the dp scaling harness gives a positive ratio (four
gloo ranks, spawned once for the file); and the host-first layout over
two "hosts" (a pure function of the sizes and the hosts, and a mesh over
four ranks with LOCAL_WORLD_SIZE = 2)."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_ranks
from mfa_tpu.parallel import mesh as jax_mesh
from mfa_tpu.parallel import multihost as jax_multihost
from mfa_tpu_torch.parallel import mesh as mesh_mod
from mfa_tpu_torch.parallel import multihost

WORLD = 4


@pytest.fixture(scope="module")
def ranks():
    return mesh_mod.spawn(torch_ranks.multihost_suite, WORLD, timeout_s=300)


def test_initialize_noop_single_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    info = multihost.initialize_distributed(device="cpu")
    assert info == {"process_index": 0, "process_count": 1,
                    "local_devices": 1, "global_devices": 1}
    assert not dist.is_initialized()
    assert sorted(info) == sorted(jax_multihost.initialize_distributed())


def test_initialize_reports_the_world_in_a_rank(ranks):
    for rank, r in enumerate(ranks):
        assert r["info"] == {"process_index": rank, "process_count": WORLD,
                             "local_devices": WORLD,
                             "global_devices": WORLD}


def test_hybrid_mesh_single_process_layout(tmp_path):
    layout = multihost.hybrid_layout(dp=2, tp=2, sp=2)
    np.testing.assert_array_equal(layout, np.arange(8).reshape(2, 1, 2, 2))
    mesh_mod.make_mesh(device="cpu", init_method=f"file://{tmp_path}/rdv",
                       rank=0, world_size=1)
    mesh = multihost.make_hybrid_mesh(device="cpu")
    # The axis convention of make_mesh (and of mfa_tpu's two constructors).
    assert mesh.mesh_dim_names == mesh_mod.make_mesh(
        device="cpu").mesh_dim_names == mesh_mod.AXES
    assert mesh_mod.AXES == jax_mesh.make_mesh(dp=2, tp=2, sp=2).axis_names
    dist.destroy_process_group()


def test_hybrid_mesh_too_many_devices(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="need"):
        multihost.make_hybrid_mesh(dp=1024, device="cpu")


def test_hybrid_layout_over_two_hosts():
    """dp crosses the hosts and the inner axes stay in one: two hosts of
    four ranks, dp 2 x tp 2 takes ranks 0, 1 and 4, 5; dp 4 x tp 2 fills
    both hosts in rank order; dp that does not divide over the hosts
    keeps the plain order."""
    np.testing.assert_array_equal(
        multihost.hybrid_layout(dp=2, tp=2, hosts=2, ranks_per_host=4)
        .reshape(2, 2), [[0, 1], [4, 5]])
    np.testing.assert_array_equal(
        multihost.hybrid_layout(dp=4, tp=2, hosts=2, ranks_per_host=4),
        np.arange(8).reshape(4, 1, 2, 1))
    np.testing.assert_array_equal(
        multihost.hybrid_layout(dp=1, tp=4, hosts=2, ranks_per_host=4),
        np.arange(4).reshape(1, 1, 4, 1))
    with pytest.raises(ValueError, match="do not fit"):
        multihost.hybrid_layout(dp=2, tp=8, hosts=2, ranks_per_host=4)


def test_hybrid_mesh_over_two_hosts(ranks):
    """Four ranks as two hosts of two: a dp = 2 mesh takes rank 0 and rank
    2, one a host, and its dp group sums their ranks."""
    for rank, r in enumerate(ranks):
        two = r["two_hosts"]
        assert two["ranks"] == [[[[0]]], [[[2]]]]
        assert tuple(two["names"]) == mesh_mod.AXES
        if rank in (0, 2):
            assert two["coordinate"] == [rank // 2, 0, 0, 0]
            assert r["two_hosts_sum"] == 2.0
        else:
            assert two["coordinate"] is None


def test_dp_scaling_efficiency_harness(ranks):
    """The measurement path runs end to end on gloo ranks and returns the
    same positive ratio on every rank (no claim: CPU processes)."""
    res = ranks[0]["scaling"]
    assert res["dp"] == 4
    assert res["dp1_tok_s"] > 0 and res["dpN_tok_s"] > 0
    assert res["efficiency"] > 0
    assert all(r["scaling"] == res for r in ranks)


def test_measure_tokens_per_s_on_the_cpu():
    calls = []
    rate = multihost.measure_tokens_per_s(
        lambda x: calls.append(x) or torch.ones(1), (3,), 100, warmup=2,
        iters=4, device="cpu")
    assert rate > 0 and calls == [3] * 6


def test_dryrun_watchdog_prints_the_stacks_of_a_stuck_block():
    """parallel/dryrun.py::watchdog: a block that outlasts its seconds
    gets every thread's Python stack on stderr (how a four-card rank stuck
    outside a collective shows where it waits), then goes on."""
    import subprocess
    import sys
    from pathlib import Path

    code = ("import time\n"
            "from mfa_tpu_torch.parallel.dryrun import watchdog\n"
            "def stuck():\n"
            "    time.sleep(2)\n"
            "with watchdog('stuck block', 0.5):\n"
            "    stuck()\n"
            "with watchdog('quick block', 5):\n"
            "    pass\n"
            "time.sleep(0.2)\n"
            "print('done')\n")
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "done"
    assert "stuck block: watchdog 0 s" in out.stderr
    assert "in stuck" in out.stderr and out.stderr.count("Thread") >= 1
