"""Public attention API: descriptor-driven, cached, forward only.

Port of ``flash_attention`` and ``mha`` from ``mfa_tpu/ops/attention.py``.
Dispatch path:

  flash_attention(q, k, v)
    └─ two-level cache probe (ops/cache.py); on a miss only:
       AttentionDescriptor → kernel_descriptor(FORWARD)   [ops/params.py]
       └─ kernels/flash_fwd.flash_fwd                     [CUDA kernel K1]

The gradients come with the training slice (a ``torch.autograd.Function``
over the backward kernels); until then inputs that need a gradient are
refused.
"""

from __future__ import annotations

import functools

import torch

from mfa_tpu_torch.kernels import flash_fwd as flash_fwd_kernel
from mfa_tpu_torch.ops import params as params_mod
from mfa_tpu_torch.ops.cache import attention_cache
from mfa_tpu_torch.ops.descriptors import (
    AttentionDescriptor,
    AttentionKernelType,
)
from mfa_tpu_torch.ops.precision import AttentionOperand
from mfa_tpu_torch.utils.device import check_on, resolve_device


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: float | None = None,
                    logit_soft_cap: float | None = None,
                    sliding_window: int | None = None,
                    with_lse: bool = False,
                    low_precision_intermediates: bool | None = None,
                    device="cuda"):
    """Flash attention over [batch, heads, seq, head_dim] operands.

    GQA/MQA: ``k``/``v`` may have fewer heads than ``q`` (must divide).
    ``with_lse`` also returns the per-row natural-log logsumexp L
    [B, Hq, R]. ``low_precision_intermediates``: None keeps O in the
    input's type; False forces O to fp32. All tensors must lie on
    ``device`` (default ``cuda``); on the CPU the kernel's plain version
    runs.
    """
    dev = resolve_device(device)
    check_on(dev, q=q, k=k, v=v)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward kernels yet (training slice); "
            "call it under torch.no_grad() or on tensors without grad")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("q, k, v must be [B, H, S, D] with k, v alike")
    b, hq, r, d = q.shape
    _, hkv, c, _ = k.shape
    low = q.dtype != torch.float32
    lpi = (low if low_precision_intermediates is None
           else low_precision_intermediates)

    def problem():
        return AttentionDescriptor(
            batch=b, num_q_heads=hq, num_kv_heads=hkv, seq_len_q=r,
            seq_len_kv=c, head_dim=d, causal=causal, scale=scale,
            logit_soft_cap=logit_soft_cap, sliding_window=sliding_window,
            low_precision_inputs=low, low_precision_intermediates=lpi)

    def build_kernel():
        desc = problem()
        kd = desc.kernel_descriptor(AttentionKernelType.FORWARD,
                                    params_mod.detect_device(dev))
        return kd, desc.precision_policy().mem(AttentionOperand.O).bits <= 16

    def build_pipeline(kernel):
        kd, o_in_input_type = kernel
        desc = problem()          # checks the heads of this exact problem
        return functools.partial(
            flash_fwd_kernel.flash_fwd, kd=kd, group=hq // hkv,
            scale=desc.softmax_scale,
            o_dtype=q.dtype if o_in_input_type else torch.float32)

    shape_class = (d, low, lpi, causal, sliding_window, logit_soft_cap,
                   str(dev))
    fwd = attention_cache.get_pipeline(
        (shape_class, q.dtype, b, hq, hkv, r, c, scale), shape_class,
        build_kernel, build_pipeline)
    o3, lse = fwd(q.reshape(b * hq, r, d).contiguous(),
                  k.reshape(b * hkv, c, d).contiguous(),
                  v.reshape(b * hkv, c, d).contiguous())
    o = o3.reshape(b, hq, r, d)
    if with_lse:
        return o, lse.reshape(b, hq, r)
    return o


def mha(x_q, x_k, x_v, **kwargs):
    """[batch, seq, heads, head_dim] layout: transposes to [B, H, S, D],
    runs :func:`flash_attention`, transposes back."""
    out = flash_attention(x_q.transpose(1, 2), x_k.transpose(1, 2),
                          x_v.transpose(1, 2), **kwargs)
    if isinstance(out, tuple):
        return out[0].transpose(1, 2), out[1]
    return out.transpose(1, 2)
