"""Ulysses-style context parallelism: all-to-all head↔sequence swap.

Twin of ``mfa_tpu/parallel/ulysses.py``. Instead of rotating K/V around a
ring, one all-to-all exchanges the sequence cut for a head cut, each rank
runs full-sequence ``flash_attention`` (K1, differentiated by K3 and K4)
on its share of the heads, and a second all-to-all swaps back. Both
all-to-alls are autograd-aware (the backward is the inverse all-to-all).
Cheaper than the ring when the heads divide over the ranks and the whole
sequence fits a card; the ring wins at extreme lengths.
"""

from __future__ import annotations

import torch

from mfa_tpu_torch.ops.attention import flash_attention
from mfa_tpu_torch.parallel import collectives
from mfa_tpu_torch.utils.device import resolve_device

# The share of the card's memory that the head-swapped full-sequence Q,
# K, V and O of one rank may take before choose_cp_mode picks the ring:
# the share mfa_tpu's default budget, 12 GiB, is of a 16 GiB v5e HBM. The
# rest holds weights, activations and the flash kernels' working set.
HBM_SHARE = 0.75


def ulysses_attention(q, k, v, *, group, causal: bool = False,
                      scale: float | None = None, device="cuda"):
    """This rank's chunks [B, H, T_local, D] of a sequence cut over the
    ranks of ``group`` (ring order), with both H and the KV head count
    divisible by the group size; returns this rank's chunk of O.
    Differentiable end to end."""
    dev = resolve_device(device)
    n = torch.distributed.get_world_size(group)
    for name, x in (("q", q), ("kv", k)):
        if x.shape[1] % n != 0:
            raise ValueError(
                f"{name} heads ({x.shape[1]}) must divide over axis size {n}")

    def seq_to_head(x):
        # [B, H, T, D]: head group j goes to rank j, which stacks the
        # sequence chunks it receives in rank order → [B, H/n, n*T, D].
        b, h, t, d = x.shape
        x = x.reshape(b, n, h // n, t, d).movedim(1, 0)
        x = collectives.all_to_all_grad(x, group)        # [n(seq), B, ...]
        return x.movedim(0, 2).reshape(b, h // n, n * t, d)

    def head_to_seq(x):
        b, hn, nt, d = x.shape
        t = nt // n
        x = x.reshape(b, hn, n, t, d).movedim(2, 0)
        x = collectives.all_to_all_grad(x, group)        # [n(heads), ...]
        return x.movedim(0, 1).reshape(b, hn * n, t, d)

    o = flash_attention(seq_to_head(q), seq_to_head(k), seq_to_head(v),
                        causal=causal, scale=scale, device=dev)
    return head_to_seq(o)


def choose_cp_mode(num_q_heads: int, num_kv_heads: int, seq_len: int,
                   head_dim: int, n_devices: int, *,
                   hbm_budget_bytes: int | None = None, in_bytes: int = 2,
                   batch: int = 1, device="cuda") -> str:
    """``mfa_tpu``'s crossover rule between the two context-parallel
    modes: "ring" when the heads do not divide over the ranks or the
    head-swapped full sequence (Q, K, V, O of 1/n of the heads) exceeds
    ``hbm_budget_bytes``, else "ulysses" (~n/2 times less traffic). The
    default budget is :data:`HBM_SHARE` of ``device``'s memory."""
    if hbm_budget_bytes is None:
        dev = resolve_device(device)
        if dev.type != "cuda":
            raise ValueError("pass hbm_budget_bytes for a CPU device")
        hbm_budget_bytes = int(HBM_SHARE * torch.cuda.get_device_properties(
            dev).total_memory)
    if num_q_heads % n_devices or num_kv_heads % n_devices:
        return "ring"
    hq, hkv = num_q_heads // n_devices, num_kv_heads // n_devices
    full_seq_bytes = batch * seq_len * head_dim * in_bytes * (2 * hq + 2 * hkv)
    return "ring" if full_seq_bytes > hbm_budget_bytes else "ulysses"


def make_ulysses_attention(mesh, *, causal: bool = False, scale=None,
                           device="cuda", axis_name: str = "sp"):
    """Ulysses over the mesh's ``axis_name`` ranks on this rank's
    [B/dp, H/tp, S/sp, D] chunks (mirror of ``make_ring_attention``)."""
    group = mesh.get_group(axis_name)

    def fn(q, k, v):
        return ulysses_attention(q, k, v, group=group, causal=causal,
                                 scale=scale, device=device)

    return fn
