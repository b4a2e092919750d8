"""Flash-attention forward: the Hopper kernel K1 and its plain version.

Replaces ``mfa_tpu/kernels/flash_fwd.py::_fwd_kernel`` and
``::_fwd_tablegrid_kernel``; the CUDA source is ``csrc/flash_fwd.cu``.
:func:`flash_fwd` launches the kernel for CUDA tensors and takes
:func:`flash_fwd_plain` only for CPU tensors; it counts its launches,
and apart those of the non-causal mode.

Which kernel a launch runs is the descriptor's parameter row
(``ops/params.py``): bf16 rows up to D = 512 name the warp-specialised
wgmma kernel (the depths of its K and V rings from
``params.fwd_rings`` and its ping-pong from ``params.FWD_PINGPONG``,
read at each call), the others the first-cut mma.sync or FMA kernels.
Its producer fills the tiles by TMA where TMA maps the operands;
where it cannot (D % 8 != 0, a base off 16 bytes) but one CTA holds D
(D <= 256) and the rows and every base share 4 bytes (D even), the same
kernel runs with a copying producer (``params.PRODUCERS``, passed
as the C entry's producer code); otherwise the mma.sync row of
its head dim (:func:`~mfa_tpu_torch.ops.descriptors.launch_row`). Past D
= 128 (``wgmma_dblk``) it runs on a 192- or 256-wide head-dim panel: one
CTA up to D = 256; above, the launch covers O in ceil(D / block_d)
panels, as ``mfa_tpu``'s ``_fwd_kernel`` pages D in ``block_d`` slices
(flash_fwd.py:180-252, :413-456), one CTA of a thread-block cluster a
panel, S summed across the cluster, so formed once a block pair. A
cluster row whose operands TMA cannot map takes the D-blocked
``mma_dblk`` row (one CTA a panel, S summed over streamed panels in
each, which also runs past D = 512); fp32 runs ``fma_dblk`` past D =
256.
Blocks, heads and panels share grid.x, so batch * heads has no 65535
limit.

Operands: q [BH, R, D]; k, v [BH / group, C, D] (query head bh reads kv
head bh // group); outputs O [BH, R, D] and the natural-log logsumexp
L [BH, R] in fp32.
"""

from __future__ import annotations

import collections
import math

import torch

from mfa_tpu_torch.kernels import build
from mfa_tpu_torch.ops import params
from mfa_tpu_torch.ops.descriptors import (
    KERNEL_CODES,
    AttentionKernelDescriptor,
    head_dim_panels,
    launch_row,
    row_label,
)

LOG2E = math.log2(math.e)
# Large-finite mask sentinel: (masked - masked) never produces NaN.
MASK_VALUE = -0.5 * float(torch.finfo(torch.float32).max)


def visible_mask(r: int, c: int, causal: bool, sliding_window: int | None,
                 device) -> torch.Tensor:
    """[R, C] bool: column c is visible to row r (diagonal aligned to the
    sequence ends, offset = C - R)."""
    row = torch.arange(r, device=device)[:, None]
    col = torch.arange(c, device=device)[None, :]
    if not (causal or sliding_window is not None):
        return torch.ones((r, c), dtype=torch.bool, device=device)
    mask = col <= row + (c - r)
    if sliding_window is not None:
        mask &= col >= row + (c - r) - (sliding_window - 1)
    return mask


def flash_fwd_plain(q3, k3, v3, kd: AttentionKernelDescriptor, *,
                    group: int, scale: float, o_dtype: torch.dtype):
    """Plain PyTorch version of K1 with the kernel's rounding points: Q
    pre-scaled by scale*log2e and rounded to bf16 for bf16 inputs (S
    scaled instead for fp32), exp2 softmax, P rounded to bf16 before PV
    for bf16 inputs, rows with no visible key giving O = 0 and L = 0."""
    r, c = q3.shape[1], k3.shape[1]
    scale2 = scale * LOG2E
    low = q3.dtype != torch.float32
    kx = k3.repeat_interleave(group, dim=0).float()
    vx = v3.repeat_interleave(group, dim=0).float()
    if low:
        qs = (q3.float() * scale2).to(q3.dtype).float()
        s = torch.bmm(qs, kx.transpose(1, 2))
    else:
        s = torch.bmm(q3.float(), kx.transpose(1, 2)) * scale2
    if kd.logit_soft_cap is not None:
        cap2 = kd.logit_soft_cap * LOG2E
        s = cap2 * torch.tanh(s / cap2)
    mask = visible_mask(r, c, kd.causal, kd.sliding_window, q3.device)
    s = torch.where(mask, s, torch.full_like(s, MASK_VALUE))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-37)
    if low:
        p = p.to(kd.register_dtype(kd.p_register, q3.dtype)).float()
    o = torch.bmm(p, vx) / l_safe
    empty = m == MASK_VALUE
    o = torch.where(empty, torch.zeros_like(o), o).to(o_dtype)
    lse = torch.where(empty, torch.zeros_like(m),
                      (m + torch.log2(l_safe)) * (1.0 / LOG2E))
    return o, lse[..., 0]


def _check(q3, k3, v3, kd, group, o_dtype):
    if q3.dim() != 3 or k3.dim() != 3 or v3.shape != k3.shape:
        raise ValueError(f"bad shapes q {tuple(q3.shape)} k {tuple(k3.shape)} "
                         f"v {tuple(v3.shape)}")
    if q3.shape[0] != k3.shape[0] * group or q3.shape[2] != k3.shape[2]:
        raise ValueError("q and k/v disagree on heads or head dim")
    if q3.shape[1] < 1 or k3.shape[1] < 1:
        raise ValueError("empty sequence")
    if kd.sliding_window is not None and kd.sliding_window < 1:
        raise ValueError("sliding_window must be >= 1")
    if q3.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_fwd takes bf16 or fp32, not {q3.dtype}")
    if k3.dtype != q3.dtype or v3.dtype != q3.dtype:
        raise TypeError("q, k and v must share one dtype")
    if o_dtype not in (q3.dtype, torch.float32):
        raise TypeError(f"unsupported output dtype {o_dtype}")


def output_buffers(out, shapes, dtypes, device):
    """Fresh outputs of ``shapes`` and ``dtypes``, or the caller's
    (checked) buffers ``out`` (the flash kernels' ``out`` arguments)."""
    if out is None:
        return [torch.empty(s, dtype=dt, device=device)
                for s, dt in zip(shapes, dtypes)]
    out = list(out)
    for t, s, dt in zip(out, shapes, dtypes, strict=True):
        if (t.shape != s or t.dtype != dt or t.device != device
                or not t.is_contiguous()):
            raise ValueError(f"out buffer must be contiguous {dt} {s} on "
                             f"{device}")
    return out


def flash_fwd(q3, k3, v3, kd: AttentionKernelDescriptor, *, group: int,
              scale: float, o_dtype: torch.dtype, out=None):
    """K1: launches the CUDA kernel for CUDA tensors (or raises); takes the
    plain version for CPU tensors. Returns (O, L); ``out`` may give the two
    buffers to write (O in ``o_dtype``, L fp32)."""
    _check(q3, k3, v3, kd, group, o_dtype)
    if q3.device.type == "cpu":
        o, lse = flash_fwd_plain(q3, k3, v3, kd, group=group, scale=scale,
                                 o_dtype=o_dtype)
        if out is None:
            return o, lse
        out[0].copy_(o)
        out[1].copy_(lse)
        return tuple(out)
    if not q3.is_cuda:
        raise ValueError(f"flash_fwd: unsupported device {q3.device}")
    for name, t in (("k", k3), ("v", v3)):
        if t.device != q3.device:
            raise ValueError(f"{name} is on {t.device}, q on {q3.device}")
    for name, t in (("q", q3), ("k", k3), ("v", v3)):
        if not t.is_contiguous():
            raise ValueError(f"flash_fwd: {name} must be contiguous")
    bh, r, d = q3.shape
    c = k3.shape[1]
    o, lse = output_buffers(out, [(bh, r, d), (bh, r)],
                            [o_dtype, torch.float32], q3.device)
    row = launch_row(kd, d, (q3, k3, v3, o))
    panels = head_dim_panels(row, d)
    rings = (params.fwd_rings(row) if row.kernel in ("wgmma", "wgmma_dblk")
             else (0, 0))
    dtype_code = (0 if q3.dtype == torch.float32
                  else 2 if o_dtype == torch.float32 else 1)
    cap2 = (kd.logit_soft_cap * LOG2E if kd.logit_soft_cap is not None
            else 0.0)
    build.library().call(
        "mfa_flash_fwd", q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
        o.data_ptr(), lse.data_ptr(), bh, group, r, c, d, panels,
        int(kd.causal), kd.sliding_window or 0, scale * LOG2E, cap2,
        dtype_code,
        KERNEL_CODES[row.kernel], row.block_q, row.block_kv, row.block_d,
        *rings, int(params.FWD_PINGPONG), params.PRODUCERS[row.producer],
        torch.cuda.current_stream(q3.device).cuda_stream)
    flash_fwd.launches += 1
    launches_by_row[row_label(row)] += 1
    if not (kd.causal or kd.sliding_window is not None):
        flash_fwd.noncausal_launches += 1
    return o, lse


# Launches of the kernel, and of them those in its non-causal mode (the
# twin of mfa_tpu's _fwd_kernel; the causal and windowed launches are the
# twin of _fwd_tablegrid_kernel). A stand-in for flash_fwd in this module
# receives both counts while it stands there.
flash_fwd.launches = 0
flash_fwd.noncausal_launches = 0
# The kernel's launches by the row that ran (descriptors.row_label:
# "wgmma", "wgmma/copy", "mma", ...), whatever stands in for flash_fwd.
launches_by_row = collections.Counter()
