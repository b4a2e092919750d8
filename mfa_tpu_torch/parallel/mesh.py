"""Device mesh over ``torch.distributed`` process groups.

Twin of ``mfa_tpu/parallel/mesh.py``. Axis conventions, as there:

  "dp" — data parallel (batch)
  "pp" — pipeline parallel (layer stages)
  "tp" — tensor parallel (attention heads / FFN hidden)
  "sp" — sequence parallel (ring attention KV rotation)

:func:`make_mesh` returns a ``DeviceMesh`` with dims ("dp", "pp", "tp",
"sp"), tp and sp innermost so that they map to adjacent ranks, dp
outermost. Where ``mfa_tpu`` returns ``NamedSharding``s for XLA to place
global arrays, the port's processes hold rank-local tensors:
:func:`replicated` and :func:`batch_sharded` return this rank's view.

The process group is NCCL on the card and gloo when the caller passes
``device="cpu"``; nothing falls back from one to the other. Rendezvous
goes through the ``init_method`` the caller names (``file://...`` or
``env://``); nothing here picks a port. :func:`spawn` runs one function
in fresh processes, one a rank, on a file rendezvous of its own.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import pickle
import tempfile
import time
from multiprocessing import connection

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from mfa_tpu_torch.utils.device import resolve_device

AXES = ("dp", "pp", "tp", "sp")


def make_mesh(dp: int = 1, tp: int = 1, sp: int = 1, pp: int = 1, *,
              device="cuda", init_method: str | None = None,
              rank: int | None = None, world_size: int | None = None,
              timeout_s: float = 600.0) -> DeviceMesh:
    """A (dp, pp, tp, sp) mesh over the first dp·pp·tp·sp ranks.

    Initialises the default process group when there is none (NCCL for a
    CUDA ``device``, which this process then uses; gloo for ``cpu``) from
    ``init_method`` (default ``env://``), ``rank`` and ``world_size``.
    Raises ``ValueError`` when the world is smaller than the mesh, as
    ``mfa_tpu`` does when it has too few devices. Ranks past the mesh get
    a mesh whose ``get_coordinate()`` is None. Every rank must call it
    with the same sizes."""
    dev = resolve_device(device)
    n = dp * tp * sp * pp
    if not dist.is_initialized():
        if world_size is not None and world_size < n:
            raise ValueError(f"need {n} ranks, have {world_size}")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=init_method or "env://", rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
    world = dist.get_world_size()
    if world < n:
        raise ValueError(f"need {n} ranks, have {world}")
    return DeviceMesh(dev.type, torch.arange(n).reshape(dp, pp, tp, sp),
                      mesh_dim_names=AXES)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along ``axis`` (``DeviceMesh.size`` takes the
    dim's index), 1 for a mesh without it; this rank's place on it is
    ``mesh.get_local_rank``, its group ``mesh.get_group``."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def local_shard(x: torch.Tensor, mesh: DeviceMesh, dims: dict
                ) -> torch.Tensor:
    """This rank's block of a global tensor: for each ``axis: dim`` of
    ``dims``, dim ``dim`` is cut in equal blocks over the axis (a view)."""
    for axis, dim in dims.items():
        n = axis_size(mesh, axis)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not "
                             f"divide over {axis} = {n}")
        size = x.shape[dim] // n
        x = x.narrow(dim, mesh.get_local_rank(axis) * size, size)
    return x


def replicated(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The whole tensor: every rank holds all of it."""
    return x


def batch_sharded(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's slice of the leading (batch) axis over dp."""
    return local_shard(x, mesh, {"dp": 0})


def _run_rank(send, fn, rank, world_size, init_method, args_path):
    torch.set_num_threads(1)
    with open(args_path, "rb") as f:
        args = pickle.load(f)
    send.send(fn(rank, world_size, init_method, *args))
    send.close()


class _Processes(list):
    """Processes that are stopped (terminated, then joined) on exit."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for p in self:
            if p.is_alive():
                p.terminate()
        for p in self:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join(10)
        return False


def spawn(fn, world_size: int, *args, timeout_s: float = 300.0) -> list:
    """Run ``fn(rank, world_size, init_method, *args)`` in ``world_size``
    fresh processes (the spawn start method, one thread each), with a
    file rendezvous in a temporary directory as ``init_method``; return
    their results in rank order. ``fn`` must be importable from a module
    (its processes import that module). Raises if a rank fails or the
    whole run outlasts ``timeout_s``; every process is stopped before it
    returns or raises."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp, _Processes() as procs:
        init = f"file://{tmp}/rendezvous"
        # The arguments go through a file: sent with each process they
        # would fill the pipe that starts it, and each start would wait
        # for the one before to import its modules.
        args_path = f"{tmp}/args.pkl"
        with open(args_path, "wb") as f:
            pickle.dump(args, f)
        pending = {}
        for rank in range(world_size):
            recv, send = ctx.Pipe(duplex=False)
            p = ctx.Process(target=_run_rank, daemon=True,
                            args=(send, fn, rank, world_size, init,
                                  args_path))
            p.start()
            send.close()
            procs.append(p)
            pending[recv] = rank
        results = [None] * world_size
        deadline = time.monotonic() + timeout_s
        while pending:
            ready = connection.wait(list(pending),
                                    max(0.0, deadline - time.monotonic()))
            if not ready:
                raise TimeoutError(
                    f"ranks {sorted(pending.values())} gave no result "
                    f"within {timeout_s} s")
            for conn in ready:
                rank = pending.pop(conn)
                procs[rank].join(0.2)
                if procs[rank].exitcode not in (None, 0):
                    raise RuntimeError(f"rank {rank} failed (exit code "
                                       f"{procs[rank].exitcode})")
                results[rank] = conn.recv()
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    return results
