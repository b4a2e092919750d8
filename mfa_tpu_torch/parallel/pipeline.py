"""Pipeline parallelism: a GPipe microbatch pipeline over the "pp" ranks.

Twin of ``mfa_tpu/parallel/pipeline.py``. There every stage runs one
program under ``shard_map`` and activations move stage → stage + 1 by
``lax.ppermute``; here every "pp" rank runs the same loop on its own
stage's weights, and activations move stage → stage + 1 by point-to-point
send/recv on the pp group (``dist.batch_isend_irecv``).

Schedule: GPipe fill-drain, as there. With ``S`` stages and ``M``
microbatches the loop runs ``M + S − 1`` steps; at step ``t`` stage ``s``
works on microbatch ``t − s``, so the bubble is ``(S − 1)/(M + S − 1)``.
Stages compute at every step: stage 0 on microbatch ``min(t, M − 1)``,
the others on what stage − 1 sent (zeros at step 0, so a slot before
the first microbatch arrives is computed on zeros and what follows from
them); the last stage banks microbatch ``t − (S − 1)`` when that slot is
real, and the other slots never reach the output. The transfer of step
``t``'s output is issued right after its compute, before step ``t + 1``'s,
and waited for only when step ``t + 1`` reads it (``mfa_tpu``'s
``ppermute`` result flows only into the loop carry; ``utils/overlap.py``
checks the same order here).

The exit: the last stage's buffer, masked to zeros on the other stages,
is all-reduced over pp (adding zeros is exact), so every rank returns
the whole output, as ``mfa_tpu``'s exit ``psum`` replicates it.

Gradients: the hop is a ``torch.autograd.Function`` whose backward sends
the gradient of what a stage received back to stage − 1 and receives
from stage + 1 the gradient of what it sent. Every step's output stays
in each rank's graph (masked slots through ``torch.where``, as in
``mfa_tpu``), so every rank runs every hop's backward, in the same order,
and the sends and receives of the backward pair up.

With a "dp" axis each dp replica pipelines its own examples of every
microbatch (``mfa_tpu``'s ``P(None, "dp")``) and the output is
all-gathered over dp. Stage weights are rank-local: :func:`shard_stacked`
gives a rank its own stage only.

:func:`pipeline_schedule` runs every stage's steps in one process, the
same arithmetic bit for bit (the pipeline's counterpart of
``ring_attention.ring_schedule``).
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.distributed as dist

from mfa_tpu_torch.parallel import collectives
from mfa_tpu_torch.parallel import mesh as mesh_mod
from mfa_tpu_torch.utils import overlap


def tree_map(fn, tree, *rest):
    """``fn`` over the tensors of nested dicts, lists, tuples and
    dataclasses of tensors (quantized weights among them), leaf by leaf
    across ``tree`` and ``rest``."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)})
    raise TypeError(f"not a tree of tensors: {type(tree)}")


def stack_stages(per_stage_params):
    """Stack S identically structured stage trees into one tree whose
    tensors have a leading stage axis (cut over "pp" by
    :func:`shard_stacked`)."""
    return tree_map(lambda *xs: torch.stack(xs), *per_stage_params)


def _require_pp(mesh) -> None:
    if "pp" not in (mesh.mesh_dim_names or ()):
        raise ValueError(
            f"the pipeline needs a 'pp' mesh axis; mesh has "
            f"{mesh.mesh_dim_names} (build one with parallel.mesh.make_mesh)")


def shard_stacked(stacked_params, mesh):
    """This rank's stage of a stacked tree (a copy, so that the stack can
    be freed: a rank holds its own stage's weights and nothing more)."""
    _require_pp(mesh)
    stage = mesh.get_local_rank("pp")
    return tree_map(lambda a: a[stage].clone(), stacked_params)


@dataclasses.dataclass
class _Pending:
    """A hop in flight: ``wait`` before the received activation is read."""

    works: list = dataclasses.field(default_factory=list)

    def wait(self) -> None:
        for w in self.works:
            w.wait()
        self.works = []


def _exchange(send, recv, group, upstream: bool):
    """Post ``send`` to the next stage and ``recv`` from the previous one
    (``upstream``: the other way); either may be None."""
    me, n = dist.get_rank(group), dist.get_world_size(group)
    nxt, prev = (me - 1, me + 1) if upstream else (me + 1, me - 1)
    ops = []
    if send is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(),
                              dist.get_global_rank(group, nxt % n), group))
    if recv is not None:
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, prev % n), group))
    return dist.batch_isend_irecv(ops) if ops else []


class _Hop(torch.autograd.Function):
    """Forward: send ``out`` to stage + 1 (unless last) and receive stage
    − 1's (unless first; zeros there), completed by ``pending.wait()``.
    Backward: the received tensor's gradient goes back to stage − 1, and
    ``out``'s comes from stage + 1."""

    @staticmethod
    def forward(ctx, out, group, first, last, pending):
        ctx.group, ctx.first, ctx.last = group, first, last
        received = torch.zeros(out.shape, dtype=out.dtype, device=out.device)
        pending.works = _exchange(None if last else out,
                                  None if first else received, group,
                                  upstream=False)
        return received

    @staticmethod
    def backward(ctx, g):
        g_out = None if ctx.last else torch.empty(g.shape, dtype=g.dtype,
                                                  device=g.device)
        for w in _exchange(None if ctx.first else g, g_out, ctx.group,
                           upstream=True):
            w.wait()
        return g_out, None, None, None, None


def pipeline_apply(stage_fn, stage_params, x, *, mesh,
                   num_microbatches: int, extra=()):
    """Run ``x`` through the S pipeline stages of ``stage_fn`` over the
    mesh's "pp" ranks.

    - ``stage_fn(stage_params, activation, *extra) -> activation`` keeps
      the activation's shape and dtype (a stack of transformer layers
      does; embedding and head stay outside).
    - ``stage_params``: this rank's stage (:func:`shard_stacked`).
    - ``x``: the whole batch [batch, ...], the same on every rank; batch
      divides into ``num_microbatches`` equal microbatches, and with a dp
      axis each microbatch divides over dp.
    - ``extra``: side inputs passed to every call (rope tables).

    Returns the output, shaped as ``x``, on every rank; differentiable.
    """
    _require_pp(mesh)
    if x.shape[0] % num_microbatches:
        raise ValueError(f"batch {x.shape[0]} not divisible into "
                         f"{num_microbatches} microbatches")
    mb = x.shape[0] // num_microbatches
    dp = mesh_mod.axis_size(mesh, "dp")
    if dp > 1 and mb % dp:
        raise ValueError(f"microbatch size {mb} not divisible by dp={dp}")
    n_stages = mesh_mod.axis_size(mesh, "pp")
    stage = mesh.get_local_rank("pp")
    xs = x.reshape((num_microbatches, mb) + x.shape[1:])
    if dp > 1:
        xs = mesh_mod.local_shard(xs, mesh, {"dp": 1})
    group = mesh.get_group("pp")
    first, last = stage == 0, stage == n_stages - 1

    def flag(value: bool):
        return torch.full((), value, dtype=torch.bool, device=x.device)

    carry = torch.zeros_like(xs[0])
    pending = _Pending()
    buf = [torch.zeros_like(xs[0]) for _ in range(num_microbatches)]
    steps = num_microbatches + n_stages - 1
    for t in range(steps):
        pending.wait()
        overlap.note("consume", "pipeline", t, pending if t else None)
        inp = torch.where(flag(first), xs[min(t, num_microbatches - 1)],
                          carry)
        out = stage_fn(stage_params, inp, *extra)
        overlap.note("compute", "pipeline", t)
        # The last stage banks microbatch t - (S - 1) when the slot is
        # real; the where keeps every step's output in the graph.
        mb_idx = t - (n_stages - 1)
        widx = min(max(mb_idx, 0), num_microbatches - 1)
        buf[widx] = torch.where(flag(last and mb_idx >= 0), out, buf[widx])
        if t < steps - 1:
            pending = _Pending()
            carry = _Hop.apply(out, group, first, last, pending)
            overlap.note("issue", "pipeline", t, pending)
    out = torch.stack(buf)
    out = collectives.reduce_from_tp(
        torch.where(flag(last), out, torch.zeros_like(out)), group)
    if dp > 1:
        out = collectives.gather_from_tp(out, mesh.get_group("dp"), dim=1)
    return out.reshape(x.shape)


def make_pipeline(stage_fn, *, mesh, num_microbatches: int):
    """:func:`pipeline_apply` with its stage function and mesh bound."""
    return functools.partial(pipeline_apply, stage_fn, mesh=mesh,
                             num_microbatches=num_microbatches)


def pipeline_schedule(stage_fn, stages, x, *, num_microbatches: int,
                      extra=()):
    """Every stage's steps of an S-stage pipeline in one process, in the
    ranks' order, the hops by passing tensors: ``stages`` is the list of
    the S stages' parameters. Returns the output as :func:`pipeline_apply`
    does, equal to it bit for bit (without dp)."""
    n_stages = len(stages)
    if x.shape[0] % num_microbatches:
        raise ValueError(f"batch {x.shape[0]} not divisible into "
                         f"{num_microbatches} microbatches")
    xs = x.reshape((num_microbatches, x.shape[0] // num_microbatches)
                   + x.shape[1:])
    carries = [torch.zeros_like(xs[0]) for _ in range(n_stages)]
    buf = [torch.zeros_like(xs[0]) for _ in range(num_microbatches)]
    for t in range(num_microbatches + n_stages - 1):
        outs = []
        for s in range(n_stages):
            inp = xs[min(t, num_microbatches - 1)] if s == 0 else carries[s]
            outs.append(stage_fn(stages[s], inp, *extra))
        if t >= n_stages - 1:
            buf[t - (n_stages - 1)] = outs[-1]
        carries = [carries[0]] + outs[:-1]
    return torch.stack(buf).reshape(x.shape)
