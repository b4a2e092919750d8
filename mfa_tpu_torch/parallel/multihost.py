"""Multi-host bootstrap, host-aware meshes and the dp scaling harness.

Twin of ``mfa_tpu/parallel/multihost.py``. There one JAX process runs on
each host and ``jax.distributed.initialize`` forms the cluster; here one
process drives each card, as ``torchrun`` starts them, and
:func:`initialize_distributed` joins the default process group over
``env://`` (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_WORLD_SIZE``, ``LOCAL_RANK``). A host is ``LOCAL_WORLD_SIZE``
consecutive ranks, as ``torchrun`` numbers them.

:func:`make_hybrid_mesh` lays dp out host-first: the mesh's inner axes
(pp, tp, sp) stay inside one host, on NVLink, and dp crosses hosts, where
its gradient all-reduce tolerates the slower network. The layout
(:func:`hybrid_layout`) is a pure function of the sizes and the hosts.

Launch, on every host::

    torchrun --nnodes 2 --nproc-per-node 4 --rdzv-endpoint HOST0:29500 \\
        -m mfa_tpu_torch.parallel.multihost

Not ported: ``ICI_OVERLAP_XLA_FLAGS``, the libtpu flags that let XLA run
collective-permutes asynchronously under compute on a TPU slice. NCCL
has no such switch: a point-to-point transfer runs on NCCL's own stream
from the moment it is posted, and ``utils/overlap.py`` checks that the
ring and the pipeline post theirs before the compute they overlap.
"""

from __future__ import annotations

import datetime
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from mfa_tpu_torch.parallel import mesh as mesh_mod
from mfa_tpu_torch.utils.device import resolve_device


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name) or default)


def initialize_distributed(init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None, *, device="cuda",
                           timeout_s: float = 600.0) -> dict:
    """Join (or report) the multi-process world.

    Safe to call unconditionally: in one process (``WORLD_SIZE`` unset or
    1, no arguments) or with a process group already formed it starts
    nothing. Otherwise it forms the default group from ``init_method``
    (default ``env://``), ``world_size`` and ``rank`` (default from the
    environment): NCCL on card ``LOCAL_RANK`` for a CUDA ``device``, gloo
    for ``cpu``.

    Returns ``{process_index, process_count, local_devices,
    global_devices}``: this rank, the world size, the ranks on this host
    (``LOCAL_WORLD_SIZE``; the whole world when unset) and the cards (or
    CPU ranks) in the world, one a rank."""
    dev = resolve_device(device)
    world = world_size or _env_int("WORLD_SIZE", 1)
    if world > 1 and not dist.is_initialized():
        if dev.type == "cuda":
            dev = torch.device("cuda", _env_int("LOCAL_RANK", 0))
            torch.cuda.set_device(dev)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=init_method or "env://", world_size=world,
            rank=rank if rank is not None else _env_int("RANK", 0),
            timeout=datetime.timedelta(seconds=timeout_s))
    if dist.is_initialized():
        index, count = dist.get_rank(), dist.get_world_size()
    else:
        index, count = 0, 1
    return {"process_index": index, "process_count": count,
            "local_devices": _env_int("LOCAL_WORLD_SIZE", count),
            "global_devices": count}


def hybrid_layout(dp: int = 1, pp: int = 1, tp: int = 1, sp: int = 1, *,
                  hosts: int = 1, ranks_per_host: int | None = None
                  ) -> np.ndarray:
    """Global ranks [dp, pp, tp, sp] of a hybrid mesh over ``hosts``
    hosts of ``ranks_per_host`` consecutive ranks each. When dp divides
    over the hosts, each host holds a block of ``dp / hosts`` dp indices
    laid out over its first ranks (``mfa_tpu``'s
    ``create_hybrid_device_mesh`` with ``dcn_mesh_shape = (hosts, 1, 1,
    1)``); otherwise, and on one host, the plain rank order."""
    n = dp * pp * tp * sp
    if hosts > 1 and dp % hosts == 0:
        per = n // hosts
        if ranks_per_host is None or per > ranks_per_host:
            raise ValueError(f"{per} ranks a host do not fit "
                             f"{ranks_per_host} ranks per host")
        blocks = [h * ranks_per_host + np.arange(per).reshape(
            dp // hosts, pp, tp, sp) for h in range(hosts)]
        return np.concatenate(blocks, axis=0)
    return np.arange(n).reshape(dp, pp, tp, sp)


def make_hybrid_mesh(dp: int = 1, pp: int = 1, tp: int = 1, sp: int = 1, *,
                     device="cuda") -> DeviceMesh:
    """A (dp, pp, tp, sp) mesh over the initialised world, dp laid out
    host-first (:func:`hybrid_layout`; a host is ``LOCAL_WORLD_SIZE``
    ranks, the whole world when unset). Raises ``ValueError`` when the
    world (``WORLD_SIZE`` before a group is formed) is smaller than the
    mesh. Every rank must call it with the same sizes; ranks outside the
    mesh get one whose ``get_coordinate()`` is None."""
    dev = resolve_device(device)
    n = dp * pp * tp * sp
    world = (dist.get_world_size() if dist.is_initialized()
             else _env_int("WORLD_SIZE", 1))
    if world < n:
        raise ValueError(f"need {n} ranks, have {world}")
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed "
                           "(or parallel.mesh.make_mesh) first")
    per_host = _env_int("LOCAL_WORLD_SIZE", world)
    layout = hybrid_layout(dp, pp, tp, sp, hosts=max(1, world // per_host),
                           ranks_per_host=per_host)
    return DeviceMesh(dev.type, torch.as_tensor(layout),
                      mesh_dim_names=mesh_mod.AXES)


# ---------------------------------------------------------------------------
# Scaling-efficiency harness
# ---------------------------------------------------------------------------


def synchronize(device: torch.device) -> None:
    """Wait for ``device``'s queued work (a CUDA device; nothing to wait
    for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_tokens_per_s(step_fn, args, tokens_per_step: int,
                         warmup: int = 1, iters: int = 3, *,
                         device="cuda") -> float:
    """Wall-clock tokens/s of one step, the card synchronised after the
    warm-up and after the timed steps."""
    dev = resolve_device(device)
    for _ in range(warmup):
        step_fn(*args)
    synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        step_fn(*args)
    synchronize(dev)
    dt = (time.perf_counter() - t0) / iters
    return tokens_per_step / max(dt, 1e-9)


def dp_scaling_efficiency(make_step, *, dp_sizes=(1, None),
                          mesh_kwargs=None, device="cuda") -> dict:
    """tokens/s at dp = ``dp_sizes[0]`` and at dp = ``dp_sizes[1]`` (None:
    the whole world over the other axes), weak scaling (the global batch
    grows with dp): efficiency = speedup / (dp ratio), 1.0 perfect.

    ``make_step(mesh) -> (step_fn, args, tokens_per_step)`` builds the
    step on a mesh (``tokens_per_step``: the global batch's tokens); the
    ranks outside a smaller mesh wait. Every rank of the world calls it
    and gets the same dict: ``{dp1_tok_s, dpN_tok_s, dp, efficiency}``
    (each side's step time the slowest rank's)."""
    dev = resolve_device(device)
    mesh_kwargs = dict(mesh_kwargs or {})
    base_dp, big_dp = dp_sizes
    if big_dp is None:
        inner = int(np.prod(list(mesh_kwargs.values()) or [1]))
        world = dist.get_world_size() if dist.is_initialized() else 1
        big_dp = max(1, world // inner)
    results = {}
    for tag, dp in (("dp1", base_dp), ("dpN", big_dp)):
        mesh = make_hybrid_mesh(dp=dp, device=dev, **mesh_kwargs)
        # (step seconds, tokens a step), 0 on ranks outside the mesh.
        timing = torch.zeros(2, dtype=torch.float64, device=dev)
        if mesh.get_coordinate() is not None:
            step_fn, args, tokens = make_step(mesh)
            rate = measure_tokens_per_s(step_fn, args, tokens, device=dev)
            timing[0], timing[1] = tokens / rate, tokens
            del step_fn, args
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.all_reduce(timing, op=dist.ReduceOp.MAX)
        results[f"{tag}_tok_s"] = float(timing[1] / timing[0])
    results["dp"] = big_dp
    results["efficiency"] = (results["dpN_tok_s"] / results["dp1_tok_s"]
                             / (big_dp / base_dp))
    return results


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="multi-host bootstrap probe")
    ap.add_argument("--coordinator", default=None,
                    help="HOST:PORT of rank 0 (default: MASTER_ADDR and "
                         "MASTER_PORT from the environment)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    init = f"tcp://{args.coordinator}" if args.coordinator else None
    info = initialize_distributed(init, args.num_processes, args.process_id,
                                  device=args.device)
    print(json.dumps(info))
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
