"""Collectives of the parallel layer, over ``torch.distributed``.

``mfa_tpu`` never writes a collective by hand: XLA's SPMD partitioner
inserts the tensor-parallel all-reduces and ``shard_map`` bodies call
``psum``, ``all_gather``, ``all_to_all`` and ``ppermute``
(``mfa_tpu/models/llama.py:338-362``, ``parallel/ring_attention.py:62``,
``parallel/ulysses.py:48-60``). The port runs eagerly on rank-local
tensors, so it writes them out here:

- :func:`all_reduce`, :func:`all_gather` (tiled, along a dim),
  :func:`all_to_all` (dim 0 in equal chunks) and :func:`rotate` (to rank
  + 1, from rank - 1, returning a :class:`Rotation` whose ``wait`` the
  caller calls after the compute it overlaps);
- the autograd-aware Megatron pair, which JAX gets for free from
  ``psum``'s transpose: :func:`copy_to_tp` (identity forward, all-reduce
  backward) at the input of each column-parallel projection, and
  :func:`reduce_from_tp` (all-reduce forward, identity backward) after
  each row-parallel one; :func:`gather_from_tp` (all-gather forward,
  this rank's slice backward) for the column-parallel logits; and
  :func:`all_to_all_grad` (its own inverse backward) for Ulysses.

Without :func:`copy_to_tp` the gradients of the replicated norms and of
the embedding would come out as one rank's partial sum. ``group=None``
makes each Megatron function the identity, so an unsharded model runs
the same code with no collective.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.distributed as dist


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks, as a new tensor."""
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def all_gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The ranks' tensors concatenated along ``dim`` in rank order (JAX's
    ``all_gather(..., tiled=True)``)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk j of dim 0 goes to rank j; the result's chunk j came from
    rank j (equal chunks; its own inverse)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


@dataclass
class Rotation:
    """A rotation in flight: ``received`` fills once :meth:`wait` returns."""

    received: list
    works: list = field(default_factory=list)
    sent: list = field(default_factory=list)

    def wait(self) -> list:
        for w in self.works:
            w.wait()
        self.works, self.sent = [], []
        return self.received


def rotate(tensors, group) -> Rotation:
    """Send each tensor to group rank + 1 and receive rank - 1's
    (``ppermute`` over ``i -> i + 1``), issued now and completed by the
    returned rotation's ``wait``. With one rank it is the identity and
    sends nothing."""
    tensors = [t.contiguous() for t in tensors]
    n = dist.get_world_size(group)
    if n == 1:
        return Rotation(received=tensors)
    me = dist.get_rank(group)
    to = dist.get_global_rank(group, (me + 1) % n)
    frm = dist.get_global_rank(group, (me - 1) % n)
    received = [torch.empty_like(t) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t, to, group) for t in tensors]
           + [dist.P2POp(dist.irecv, r, frm, group) for r in received])
    return Rotation(received=received, works=dist.batch_isend_irecv(ops),
                    sent=tensors)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        me = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, me * ctx.size, ctx.size), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group), None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce of the gradient over ``group``."""
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce over ``group`` forward, identity backward."""
    return x if group is None else _ReduceFromTP.apply(x, group)


def gather_from_tp(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """All-gather along ``dim`` forward; backward takes this rank's
    slice (every rank's loss is the same replicated value)."""
    return x if group is None else _GatherFromTP.apply(x, group, dim)


def all_to_all_grad(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`all_to_all` whose backward is the inverse all-to-all."""
    return _AllToAll.apply(x, group)
