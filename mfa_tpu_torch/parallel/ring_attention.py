"""Ring attention: sequence-parallel flash attention over a ring of ranks.

Twin of ``mfa_tpu/parallel/ring_attention.py``. K and V are cut along the
sequence over the "sp" ranks; at each of n steps every rank attends its
query chunk to the K/V chunk it holds, through ``flash_attention(...,
with_lse=True)`` (kernel K1), then passes that chunk to rank + 1. The
per-chunk partials (O, L) are merged in fp32 with the online-softmax
identity lifted to chunks:

    L = log(exp L1 + exp L2),   O = O1·exp(L1 − L) + O2·exp(L2 − L)

Causal handling classifies whole chunks: a source chunk before this
rank's is attended in full (K1's non-causal mode), its own chunk causally
(K1's causal grid), a later one skipped (O = 0, L = −inf). The ring takes
no sliding window (neither does ``mfa_tpu``'s), so K1 never sees a row
with no visible key here: its L = 0 convention for such rows never
reaches :func:`_merge`.

The backward runs the ring again: at each step this rank's additive
share of the global (dQ, dK, dV) comes from ``attention_chunk_grads``
(kernels K3 and K4, with the O and L of the whole ring supplied from
outside); dQ accumulates here in fp32, while dK and dV accumulators
travel with their K/V chunk, in bf16 for bf16 inputs and fp32 for fp32
ones, and rotate after each add; after n hops each arrives home summed.

Overlap: each step issues the rotation of the chunk it holds before its
compute and waits for it after (the order ``mfa_tpu``'s scan body gives
XLA's latency-hiding scheduler); the accumulators of step s are waited
for just before step s + 1 adds to them.

:func:`forward_step`, :func:`chunk_grads` and :func:`accumulate` are the
per-step functions, plain functions of (my, src): the autograd
:class:`RingAttention` runs them over a process group, and
:func:`ring_schedule` runs every rank's steps in one process (the same
arithmetic, bit for bit).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mfa_tpu_torch.ops.attention import attention_chunk_grads, flash_attention
from mfa_tpu_torch.parallel import collectives
from mfa_tpu_torch.utils import overlap
from mfa_tpu_torch.utils.device import resolve_device


def _merge(o1, lse1, o2, lse2):
    """Merge two online-softmax partials (fp32); a −inf L (an empty or
    skipped contribution) gives no NaN."""
    m = torch.maximum(lse1, lse2)
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, torch.zeros_like(m))
    w1 = torch.exp(lse1 - m_safe)
    w2 = torch.exp(lse2 - m_safe)
    denom = (w1 + w2).clamp_min(1e-37)
    o = (o1 * w1[..., None] + o2 * w2[..., None]) / denom[..., None]
    lse = torch.where(finite, m_safe + torch.log(denom),
                      torch.full_like(m, float("-inf")))
    return o, lse


def chunk_mode(my: int, src: int, causal: bool) -> str | None:
    """How rank ``my`` attends source chunk ``src``: "full", "causal"
    (its own chunk) or None (a later chunk under causal masking)."""
    if not causal or src < my:
        return "full"
    return "causal" if src == my else None


def init_partials(q):
    """The merge's identity: O = 0 (fp32), L = −inf."""
    b, h, t, _ = q.shape
    return (torch.zeros(q.shape, dtype=torch.float32, device=q.device),
            torch.full((b, h, t), float("-inf"), device=q.device))


def forward_step(q, kc, vc, o_acc, lse_acc, *, my: int, src: int,
                 causal: bool, scale=None, device="cuda"):
    """Rank ``my``'s step holding source chunk ``src``: K1 on (q, kc, vc)
    with its L, merged into (o_acc, lse_acc); returns the new pair."""
    mode = chunk_mode(my, src, causal)
    if mode is None:
        return o_acc, lse_acc
    with torch.no_grad():
        o, lse = flash_attention(q, kc, vc, causal=mode == "causal",
                                 scale=scale, with_lse=True, device=device)
    return _merge(o_acc, lse_acc, o.float(), lse)


def chunk_grads(q, kc, vc, o, do, lse, *, my: int, src: int, causal: bool,
                scale=None, device="cuda"):
    """Rank ``my``'s share of the global (dQ, dK, dV) from source chunk
    ``src`` under the whole ring's O and L (K3, K4), in fp32; None for a
    skipped chunk."""
    mode = chunk_mode(my, src, causal)
    if mode is None:
        return None
    with torch.no_grad():
        grads = attention_chunk_grads(q, kc, vc, o, do, lse,
                                      causal=mode == "causal", scale=scale,
                                      device=device)
    return tuple(g.float() for g in grads)


def travel_dtype(dtype: torch.dtype) -> torch.dtype:
    """dK/dV accumulators travel in fp32 for fp32 inputs, bf16 otherwise
    (half the backward's extra traffic; ~sqrt(n)·2^-8 relative)."""
    return torch.float32 if dtype == torch.float32 else torch.bfloat16


def accumulate(dq_acc, dk_acc, dv_acc, grads):
    """Add one step's fp32 shares: dQ in fp32, dK and dV in fp32 then
    cast back to their travel dtype."""
    if grads is None:
        return dq_acc, dk_acc, dv_acc
    dq, dk, dv = grads
    return (dq_acc + dq, (dk_acc.float() + dk).to(dk_acc.dtype),
            (dv_acc.float() + dv).to(dv_acc.dtype))


def _ring_forward(q, k, v, group, causal, scale, device):
    n, my = dist.get_world_size(group), dist.get_rank(group)
    o_acc, lse_acc = init_partials(q)
    kc, vc = k, v
    for s in range(n):
        src = (my - s) % n
        nxt = collectives.rotate([kc, vc], group) if s < n - 1 else None
        overlap.note("issue", "ring_forward", s, nxt)
        o_acc, lse_acc = forward_step(q, kc, vc, o_acc, lse_acc, my=my,
                                      src=src, causal=causal, scale=scale,
                                      device=device)
        overlap.note("compute", "ring_forward", s)
        if nxt is not None:
            kc, vc = nxt.wait()
            overlap.note("consume", "ring_forward", s, nxt)
    return o_acc.to(q.dtype), lse_acc


def _ring_backward(q, k, v, o, do, lse, group, causal, scale, device):
    n, my = dist.get_world_size(group), dist.get_rank(group)
    travel = travel_dtype(q.dtype)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=travel, device=k.device)
    dv = torch.zeros(k.shape, dtype=travel, device=k.device)
    kc, vc, accs = k, v, None
    for s in range(n):
        src = (my - s) % n
        nxt = collectives.rotate([kc, vc], group) if s < n - 1 else None
        overlap.note("issue", "ring_backward", s, nxt)
        grads = chunk_grads(q, kc, vc, o, do, lse, my=my, src=src,
                            causal=causal, scale=scale, device=device)
        overlap.note("compute", "ring_backward", s)
        if accs is not None:
            dk, dv = accs.wait()
            overlap.note("consume", "ring_backward", s, accs)
        dq, dk, dv = accumulate(dq, dk, dv, grads)
        accs = collectives.rotate([dk, dv], group)
        overlap.note("issue", "ring_backward", s, accs)
        if nxt is not None:
            kc, vc = nxt.wait()
            overlap.note("consume", "ring_backward", s, nxt)
    dk, dv = accs.wait()
    overlap.note("consume", "ring_backward", n - 1, accs)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class RingAttention(torch.autograd.Function):
    """O = ring attention of rank-local chunks over ``group``; the
    backward is the second ring."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale, device):
        o, lse = _ring_forward(q, k, v, group, causal, scale, device)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (group, causal, scale, device)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, o, do.contiguous(), lse,
                                    *ctx.cfg)
        return dq, dk, dv, None, None, None, None


def ring_flash_attention(q, k, v, *, group, causal: bool = False,
                         scale: float | None = None, device="cuda"):
    """Sequence-parallel attention over the ranks of ``group``.

    q, k, v: this rank's chunks [B, H, T_local, D] (equal chunk sizes; k,
    v may have fewer heads, GQA), laid out in ring order: global position
    = group rank * T_local + local position. Returns this rank's chunk of
    O; differentiable (the ring backward)."""
    dev = resolve_device(device)
    return RingAttention.apply(q, k, v, group, causal, scale, dev)


def make_ring_attention(mesh, *, causal: bool = False, scale=None,
                        device="cuda", axis_name: str = "sp"):
    """Ring attention over the mesh's ``axis_name`` ranks: the returned
    function takes this rank's [B/dp, H/tp, S/sp, D] chunks (dp and tp
    cut batch and heads; :func:`mesh.local_shard` gives them) and returns
    its chunk of O."""
    group = mesh.get_group(axis_name)

    def fn(q, k, v):
        return ring_flash_attention(q, k, v, group=group, causal=causal,
                                    scale=scale, device=device)

    return fn


def ring_schedule(q, k, v, do=None, *, n: int, causal: bool = False,
                  scale=None, device="cuda"):
    """Every rank's steps of an n-rank ring in one process, on global
    [B, H, S, D] tensors cut into n chunks along S: the per-step
    functions in the ranks' order, the rotations by indexing. Returns O
    (and with ``do`` (O, dQ, dK, dV)), assembled, equal bit for bit to
    what the ranks of :func:`ring_flash_attention` return."""
    device = resolve_device(device)
    qs, ks, vs = (list(x.chunk(n, dim=2)) for x in (q, k, v))
    outs = []
    for my in range(n):
        o_acc, lse_acc = init_partials(qs[my])
        for s in range(n):
            o_acc, lse_acc = forward_step(
                qs[my], ks[(my - s) % n], vs[(my - s) % n], o_acc, lse_acc,
                my=my, src=(my - s) % n, causal=causal, scale=scale,
                device=device)
        outs.append((o_acc.to(q.dtype), lse_acc))
    o = torch.cat([x for x, _ in outs], dim=2)
    if do is None:
        return o
    dos = list(do.chunk(n, dim=2))
    travel = travel_dtype(q.dtype)
    dqs = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
           for x in qs]
    # Chunk j's dK/dV accumulator travels with it: at step s rank
    # (j + s) % n holds it and adds its share.
    dks = [torch.zeros(x.shape, dtype=travel, device=x.device) for x in ks]
    dvs = [torch.zeros(x.shape, dtype=travel, device=x.device) for x in ks]
    for s in range(n):
        for my in range(n):
            src = (my - s) % n
            grads = chunk_grads(qs[my], ks[src], vs[src], outs[my][0],
                                dos[my].contiguous(), outs[my][1], my=my,
                                src=src, causal=causal, scale=scale,
                                device=device)
            dqs[my], dks[src], dvs[src] = accumulate(dqs[my], dks[src],
                                                     dvs[src], grads)
    return (o, torch.cat(dqs, dim=2).to(q.dtype),
            torch.cat(dks, dim=2).to(k.dtype),
            torch.cat(dvs, dim=2).to(v.dtype))
