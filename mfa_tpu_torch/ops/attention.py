"""Public attention API: descriptor-driven, cached, differentiable.

Port of ``flash_attention``, ``attention_chunk_grads`` and ``mha`` from
``mfa_tpu/ops/attention.py``. Dispatch path:

  flash_attention(q, k, v)
    └─ two-level cache probe (ops/cache.py); on a miss only:
       AttentionDescriptor → kernel_descriptor(FORWARD, BACKWARD_QUERY,
                                               BACKWARD_KEY_VALUE)
    └─ FlashAttentionFunction (torch.autograd.Function)
       forward:  kernels/flash_fwd.flash_fwd      [CUDA kernel K1]
       backward: kernels/flash_bwd.flash_bwd_q    [K3: D-term, dQ]
                 kernels/flash_bwd.flash_bwd_kv   [K4: dK, dV]

The three kernels run in the order of ``mfa_tpu``'s custom VJP: forward,
backward_query, backward_key_value. The kernel functions are looked up in
their modules at each call (the cache holds only descriptors), so a
caller may swap in their plain versions to check the kernels in context.

Under ``MFA_AUTOTUNE`` (``ops/gemm.py::set_autotune``) the first forward
of a problem on the card times K1 on the table row and on the other rows
the library compiles for its head dim and input type
(:func:`_attn_autotune_candidates`), and every later forward of the
problem launches the fastest (:func:`_attn_autotuned_kd`); only the
forward, as in ``mfa_tpu``.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import torch

from mfa_tpu_torch.kernels import flash_bwd as flash_bwd_kernel
from mfa_tpu_torch.kernels import flash_fwd as flash_fwd_kernel
from mfa_tpu_torch.ops import params as params_mod
from mfa_tpu_torch.ops.cache import attention_cache
from mfa_tpu_torch.ops.descriptors import (
    _TABLE,
    AttentionDescriptor,
    AttentionKernelDescriptor,
    AttentionKernelType,
    copy_granule,
    launch_row,
    row_label,
)
from mfa_tpu_torch.ops.precision import AttentionOperand
from mfa_tpu_torch.utils.device import check_on, resolve_device


@dataclass(frozen=True)
class _Launch:
    """What the three kernels need for one exact problem."""

    fwd: AttentionKernelDescriptor
    bwd_q: AttentionKernelDescriptor
    bwd_kv: AttentionKernelDescriptor
    group: int
    scale: float
    o_dtype: torch.dtype


def _problem(q, k, *, causal, scale, logit_soft_cap, sliding_window,
             low_precision_intermediates) -> AttentionDescriptor:
    b, hq, r, d = q.shape
    _, hkv, c, _ = k.shape
    low = q.dtype != torch.float32
    return AttentionDescriptor(
        batch=b, num_q_heads=hq, num_kv_heads=hkv, seq_len_q=r,
        seq_len_kv=c, head_dim=d, causal=causal, scale=scale,
        logit_soft_cap=logit_soft_cap, sliding_window=sliding_window,
        low_precision_inputs=low,
        low_precision_intermediates=(low if low_precision_intermediates
                                     is None
                                     else low_precision_intermediates))


def _launch(q, k, *, causal, scale, logit_soft_cap, sliding_window,
            low_precision_intermediates, dev) -> _Launch:
    """The cached launch parameters of this problem (descriptors are built
    only on a miss)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q, k, v must be [B, H, S, D] with k, v alike")
    b, hq, r, d = q.shape
    _, hkv, c, _ = k.shape
    low = q.dtype != torch.float32
    lpi = (low if low_precision_intermediates is None
           else low_precision_intermediates)

    def problem():
        return _problem(q, k, causal=causal, scale=scale,
                        logit_soft_cap=logit_soft_cap,
                        sliding_window=sliding_window,
                        low_precision_intermediates=lpi)

    def build_kernel():
        desc = problem()
        device = params_mod.detect_device(dev)
        kds = tuple(desc.kernel_descriptor(t, device)
                    for t in AttentionKernelType)
        return kds, desc.precision_policy().mem(AttentionOperand.O).bits <= 16

    def build_pipeline(kernel):
        kds, o_in_input_type = kernel
        desc = problem()          # checks the heads of this exact problem
        return _Launch(*kds, group=hq // hkv, scale=desc.softmax_scale,
                       o_dtype=q.dtype if o_in_input_type else torch.float32)

    shape_class = (d, low, lpi, causal, sliding_window, logit_soft_cap,
                   str(dev))
    return attention_cache.get_pipeline(
        (shape_class, q.dtype, b, hq, hkv, r, c, scale), shape_class,
        build_kernel, build_pipeline)


def _attn_autotune_candidates(kd, desc, tensors=(),
                              device: params_mod.HopperDevice = params_mod.H100
                              ) -> list[AttentionKernelDescriptor]:
    """The candidates of the dispatch-path autotune: kd on its own row
    (the table row) first, then on each row of
    ``params.flash_candidate_rows`` for its kernel, head dim and input
    type (the rows one axis from the table row first), each kept only
    where ``descriptors.launch_row`` launches it as it is on ``tensors``
    (TMA maps them, or the kernel takes them with its copying producer on
    one of its instances ``params.COPY_ROWS``; a row it would send to the
    mma.sync table is that row's candidate) and its shared memory fits
    one SM of ``device``."""
    name = _TABLE[kd.kernel_type]
    in_bytes = kd.q_precision.bits // 8
    d = desc.head_dim
    live = params_mod.ParameterRow(d, kd.block_q, kd.block_kv, kd.block_d,
                                   kd.kernel)
    out = []
    for row in [live] + params_mod.flash_candidate_rows(name, d, in_bytes):
        cand = dataclasses.replace(kd, block_q=row.block_q,
                                   block_kv=row.block_kv,
                                   block_d=row.block_d, kernel=row.kernel)
        run = launch_row(cand, d, tensors)
        if (cand in out or dataclasses.replace(run, producer="") != row
                or (run.producer and (run.block_q, run.block_kv, run.block_d)
                    not in params_mod.COPY_ROWS[name])
                or params_mod.smem_bytes(name, run, in_bytes)
                > device.smem_per_block):
            continue
        out.append(cand)
    return out


def _tuned_axes(kd):
    return (kd.block_q, kd.block_kv, kd.block_d, kd.kernel)


def _with_axes(kd, axes):
    """kd with only the tuned axes (block_q, block_kv, block_d, kernel)
    replaced."""
    block_q, block_kv, block_d, kernel = axes
    return dataclasses.replace(kd, block_q=block_q, block_kv=block_kv,
                               block_d=block_d, kernel=kernel)


def _attn_autotuned_kd(kind, kd, desc, q, k, run_candidate, tensors=()):
    """kd with the tuned axes that the attention memo holds for this
    problem, timing ``run_candidate(candidate_kd)`` for each candidate on
    the problem's first call (on the card; under CUDA graph capture or
    torch.compile the memo's winner or kd, unmemoized). The class is the
    problem, the input types and the copy granule of ``tensors`` (which
    decides how launch_row launches a row)."""
    from mfa_tpu_torch.ops import gemm as gemm_mod

    if not gemm_mod.autotune_active():
        return kd
    memo = attention_cache.tuned
    cls_key = (kind, desc, str(q.dtype), str(k.dtype),
               copy_granule(desc.head_dim, tensors), str(q.device))
    hit = memo.get(cls_key)
    if hit is not None:
        return _with_axes(kd, hit)
    if gemm_mod._no_measuring():
        return kd

    def search():
        cands = _attn_autotune_candidates(kd, desc, tensors,
                                          params_mod.detect_device(q.device))
        if len(cands) == 1:
            return _tuned_axes(cands[0])
        t0 = time.perf_counter()
        times = [gemm_mod._measure_dispatch(lambda c=c: run_candidate(c))
                 for c in cands]
        search_s = time.perf_counter() - t0
        memo.timed[cls_key] += len(cands)
        best = cands[min(range(len(cands)), key=times.__getitem__)]
        memo.notes[cls_key] = {
            "candidates": [(row_label(launch_row(c, desc.head_dim, tensors)),
                            _tuned_axes(c), t) for c, t in zip(cands, times)],
            "winner": _tuned_axes(best),
            "winner_row": row_label(launch_row(best, desc.head_dim,
                                               tensors)),
            "table_ms": times[0], "winner_ms": min(times),
            "search_s": search_s}
        return _tuned_axes(best)

    return _with_axes(kd, memo.resolve(cls_key, search))


def _autotuned_launch(launch: _Launch, desc_fn, q3, k3, v3) -> _Launch:
    """``launch`` with K1's tuned row (the autotune memo's) in ``fwd``;
    ``launch`` itself while the autotune is off."""
    from mfa_tpu_torch.ops import gemm as gemm_mod

    if not gemm_mod.autotune_active():
        return launch

    def run_candidate(kd):
        return flash_fwd_kernel.flash_fwd(
            q3, k3, v3, kd, group=launch.group, scale=launch.scale,
            o_dtype=launch.o_dtype)

    fwd = _attn_autotuned_kd("fwd", launch.fwd, desc_fn(), q3, k3,
                             run_candidate, (q3, k3, v3))
    return launch if fwd == launch.fwd else dataclasses.replace(launch,
                                                                fwd=fwd)


def _backward(q3, k3, v3, o3, do3, lse, launch: _Launch, need_kv: bool):
    """K3 then (when dK or dV is wanted) K4; fp32 (dQ, dK, dV)."""
    do3 = do3.to(q3.dtype).contiguous()
    dq, dterm = flash_bwd_kernel.flash_bwd_q(
        q3, k3, v3, o3, do3, lse, launch.bwd_q, group=launch.group,
        scale=launch.scale)
    dk = dv = None
    if need_kv:
        dk, dv = flash_bwd_kernel.flash_bwd_kv(
            q3, k3, v3, do3, lse, dterm, launch.bwd_kv, group=launch.group,
            scale=launch.scale)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """O = attention(q3, k3, v3) over [BH, S, D] operands, differentiated
    by the backward kernels. Saves the inputs and K1's own O and L."""

    @staticmethod
    def forward(ctx, q3, k3, v3, launch: _Launch):
        o3, lse = flash_fwd_kernel.flash_fwd(
            q3, k3, v3, launch.fwd, group=launch.group, scale=launch.scale,
            o_dtype=launch.o_dtype)
        ctx.save_for_backward(q3, k3, v3, o3, lse)
        ctx.launch = launch
        return o3

    @staticmethod
    def backward(ctx, do3):
        q3, k3, v3, o3, lse = ctx.saved_tensors
        need = ctx.needs_input_grad
        dq, dk, dv = _backward(q3, k3, v3, o3, do3, lse, ctx.launch,
                               need_kv=need[1] or need[2])
        return (dq.to(q3.dtype) if need[0] else None,
                dk.to(k3.dtype) if need[1] else None,
                dv.to(v3.dtype) if need[2] else None, None)


def _fold(x):
    b, h, s, d = x.shape
    return x.reshape(b * h, s, d).contiguous()


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: float | None = None,
                    logit_soft_cap: float | None = None,
                    sliding_window: int | None = None,
                    with_lse: bool = False,
                    low_precision_intermediates: bool | None = None,
                    transpose_q: bool = False, transpose_k: bool = False,
                    transpose_v: bool = False, transpose_o: bool = False,
                    device="cuda"):
    """Flash attention over [batch, heads, seq, head_dim] operands.

    GQA/MQA: ``k``/``v`` may have fewer heads than ``q`` (must divide).
    Differentiable: gradients come from the backward kernels K3 and K4.
    ``with_lse`` also returns the per-row natural-log logsumexp L
    [B, Hq, R]; that path is not differentiable and raises for inputs that
    require grad. ``low_precision_intermediates``: None keeps O in the
    input's type; False forces O to fp32. ``transpose_*``: the operand is
    stored [batch, heads, head_dim, seq] (``transpose_o`` returns O so).
    All tensors must lie on ``device`` (default ``cuda``); on the CPU the
    kernels' plain versions run.
    """
    if transpose_q:
        q = q.transpose(-1, -2)
    if transpose_k:
        k = k.transpose(-1, -2)
    if transpose_v:
        v = v.transpose(-1, -2)
    dev = resolve_device(device)
    check_on(dev, q=q, k=k, v=v)
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    if with_lse and needs_grad:
        raise NotImplementedError(
            "with_lse=True has no backward (as in mfa_tpu); call it under "
            "torch.no_grad() or on tensors without grad")
    if v.shape != k.shape:
        raise ValueError("q, k, v must be [B, H, S, D] with k, v alike")
    launch = _launch(q, k, causal=causal, scale=scale,
                     logit_soft_cap=logit_soft_cap,
                     sliding_window=sliding_window,
                     low_precision_intermediates=low_precision_intermediates,
                     dev=dev)
    b, hq, r, d = q.shape
    q3, k3, v3 = _fold(q), _fold(k), _fold(v)
    if dev.type == "cuda":
        launch = _autotuned_launch(launch, lambda: _problem(
            q, k, causal=causal, scale=scale, logit_soft_cap=logit_soft_cap,
            sliding_window=sliding_window,
            low_precision_intermediates=low_precision_intermediates),
            q3, k3, v3)
    if needs_grad:
        o3 = FlashAttentionFunction.apply(q3, k3, v3, launch)
    else:
        o3, lse = flash_fwd_kernel.flash_fwd(
            q3, k3, v3, launch.fwd, group=launch.group, scale=launch.scale,
            o_dtype=launch.o_dtype)
    o = o3.reshape(b, hq, r, d)
    if transpose_o:
        o = o.transpose(-1, -2)
    if with_lse:
        return o, lse.reshape(b, hq, r)
    return o


def attention_chunk_grads(q, k, v, o, do, lse, *, causal: bool = False,
                          scale: float | None = None,
                          logit_soft_cap: float | None = None,
                          sliding_window: int | None = None, device="cuda"):
    """Backward contributions of one KV chunk under a global softmax.

    [B, H, S, D] operands; ``o``/``do`` align with q and ``lse`` [B, Hq, R]
    is the logsumexp over the full sequence, so K3 and K4 (P = exp(S - L),
    D = rowsum(dO * O) from the given O and L) return this chunk's additive
    share of the global (dQ, dK, dV), in the inputs' types.
    """
    dev = resolve_device(device)
    check_on(dev, q=q, k=k, v=v, o=o, do=do, lse=lse)
    if v.shape != k.shape or o.shape != q.shape or do.shape != q.shape:
        raise ValueError("q, o, do must share a shape, and k, v another")
    launch = _launch(q, k, causal=causal, scale=scale,
                     logit_soft_cap=logit_soft_cap,
                     sliding_window=sliding_window,
                     low_precision_intermediates=None, dev=dev)
    b, hq, r, d = q.shape
    _, hkv, c, _ = k.shape
    o3 = _fold(o if o.dtype in (q.dtype, torch.float32) else o.float())
    lse3 = lse.reshape(b * hq, r).float().contiguous()
    dq, dk, dv = _backward(_fold(q), _fold(k), _fold(v), o3, _fold(do), lse3,
                           launch, need_kv=True)
    return (dq.reshape(b, hq, r, d).to(q.dtype),
            dk.reshape(b, hkv, c, d).to(k.dtype),
            dv.reshape(b, hkv, c, d).to(v.dtype))


def mha(x_q, x_k, x_v, **kwargs):
    """[batch, seq, heads, head_dim] layout: transposes to [B, H, S, D],
    runs :func:`flash_attention`, transposes back."""
    out = flash_attention(x_q.transpose(1, 2), x_k.transpose(1, 2),
                          x_v.transpose(1, 2), **kwargs)
    if isinstance(out, tuple):
        return out[0].transpose(1, 2), out[1]
    return out.transpose(1, 2)
