"""Flash-attention backward: the Hopper kernels K3 and K4 and their plain
versions.

K3 (:func:`flash_bwd_q`) replaces ``mfa_tpu/kernels/flash_bwd.py::
_bwd_q_kernel``: the D-term rowsum(dO * O) and dQ. K4
(:func:`flash_bwd_kv`) replaces ``::_bwd_kv_kernel``: dK and dV, summed
over each kv head's query group inside the kernel, without atomics. The
CUDA source is ``csrc/flash_bwd.cu``. Each wrapper launches its kernel
for CUDA tensors and takes its plain version only for CPU tensors.

Which kernel a launch runs is the descriptor's parameter row
(``ops/params.py``): bf16 rows up to D = 128 name the warp-specialised
TMA + wgmma kernels, bf16 rows from D 136 to 512 the head-dim-split
kernels (``wgmma_dblk``), the others the first-cut mma.sync or FMA
kernels. Their producers fill the tiles by TMA where TMA maps the
operands; where it cannot (D % 8 != 0, a base off 16 bytes) but one CTA
holds D (D <= 256) and the rows and every base (q, k, v, dO) share 4
bytes (D even), the same kernel runs with a copying producer
(``params.PRODUCERS``, passed as the C entry's last int), as K1's
does;
otherwise the mma.sync row of its head dim
(:func:`~mfa_tpu_torch.ops.descriptors.launch_row`, shared with K1).
Each wrapper counts its launches by the row that ran
(``launches_by_row[name]``).
Past D = 128 a launch covers dQ (K3) or dK
and dV (K4) in ceil(D / block_d) head-dim panels, as ``mfa_tpu``'s
kernels page D in ``block_d`` slices (flash_bwd.py:175-235, :530-656):
the head-dim-split rows give a panel a CTA, one CTA of a 192- or
256-wide panel up to D = 256 and a two-CTA cluster past it, S and dP (K3)
or S^T and dP^T (K4) summed across the cluster; the D-blocked rows past
D = 256 (``mma_dblk``, ``fma_dblk``) give a panel a CTA that streams
every panel. Blocks, heads and panels share grid.x, so batch * heads has
no 65535 limit.

Operands: q, o, dO [BH, R, D]; k, v [BH / group, C, D] (query head bh
reads kv head bh // group); L and the D-term [BH, R] fp32. dO is in the
inputs' type; O in the inputs' type or fp32. Outputs are fp32: dQ
[BH, R, D], dK and dV [BH / group, C, D].
"""

from __future__ import annotations

import collections

import torch

from mfa_tpu_torch.kernels import build
from mfa_tpu_torch.kernels.flash_fwd import (
    LOG2E,
    MASK_VALUE,
    output_buffers,
    visible_mask,
)
from mfa_tpu_torch.ops import params
from mfa_tpu_torch.ops.descriptors import (
    KERNEL_CODES,
    AttentionKernelDescriptor,
    head_dim_panels,
    launch_row,
    row_label,
)


def _probs_and_ds(q3, k3, v3, do3, lse, dterm, kd, group, scale):
    """P and dS [BH, R, C] (fp32) with the kernels' rounding points: S from
    Q pre-scaled by scale*log2e and rounded to bf16 for bf16 inputs (S
    scaled instead for fp32), the soft-cap derivative in the log2 domain,
    dS = P (dP - D) * cap' * scale rounded to the dS register type. Also
    returns K expanded to the query heads, in fp32."""
    r, c = q3.shape[1], k3.shape[1]
    scale2 = scale * LOG2E
    kx = k3.repeat_interleave(group, dim=0).float()
    vx = v3.repeat_interleave(group, dim=0).float()
    if q3.dtype != torch.float32:
        qs = (q3.float() * scale2).to(q3.dtype).float()
        s = torch.bmm(qs, kx.transpose(1, 2))
    else:
        s = torch.bmm(q3, kx.transpose(1, 2)) * scale2
    cap_grad = None
    if kd.logit_soft_cap is not None:
        cap2 = kd.logit_soft_cap * LOG2E
        t = torch.tanh(s / cap2)
        s = cap2 * t
        cap_grad = 1.0 - t * t
    mask = visible_mask(r, c, kd.causal, kd.sliding_window, q3.device)
    s = torch.where(mask, s, torch.full_like(s, MASK_VALUE))
    p = torch.exp2(s - lse[..., None] * LOG2E)
    dp = torch.bmm(do3.float(), vx.transpose(1, 2))
    ds = p * (dp - dterm[..., None])
    if cap_grad is not None:
        ds = ds * cap_grad
    ds = ds * scale
    ds = ds.to(kd.register_dtype(kd.ds_register, q3.dtype)).float()
    return p, ds, kx


def flash_bwd_q_plain(q3, k3, v3, o3, do3, lse,
                      kd: AttentionKernelDescriptor, *, group: int,
                      scale: float):
    """Plain PyTorch version of K3: (dQ, D-term), both fp32."""
    dterm = (do3.float() * o3.float()).sum(dim=-1)
    _, ds, kx = _probs_and_ds(q3, k3, v3, do3, lse, dterm, kd, group, scale)
    return torch.bmm(ds, kx), dterm


def flash_bwd_kv_plain(q3, k3, v3, do3, lse, dterm,
                       kd: AttentionKernelDescriptor, *, group: int,
                       scale: float):
    """Plain PyTorch version of K4: (dK, dV), fp32, each summed over the
    query group of its kv head. P is rounded to the P register type for
    dV only; dK takes the raw Q."""
    p, ds, _ = _probs_and_ds(q3, k3, v3, do3, lse, dterm, kd, group, scale)
    p = p.to(kd.register_dtype(kd.p_register, q3.dtype)).float()
    bhkv, c, d = k3.shape
    dv = torch.bmm(p.transpose(1, 2), do3.float())
    dk = torch.bmm(ds.transpose(1, 2), q3.float())
    return (dk.reshape(bhkv, group, c, d).sum(dim=1),
            dv.reshape(bhkv, group, c, d).sum(dim=1))


def _check(q3, k3, v3, do3, kd, group, o3=None):
    if q3.dim() != 3 or k3.dim() != 3 or v3.shape != k3.shape:
        raise ValueError(f"bad shapes q {tuple(q3.shape)} k {tuple(k3.shape)} "
                         f"v {tuple(v3.shape)}")
    if q3.shape[0] != k3.shape[0] * group or q3.shape[2] != k3.shape[2]:
        raise ValueError("q and k/v disagree on heads or head dim")
    if do3.shape != q3.shape or (o3 is not None and o3.shape != q3.shape):
        raise ValueError("o and dO must have q's shape")
    if q3.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash backward takes bf16 or fp32, not {q3.dtype}")
    if k3.dtype != q3.dtype or v3.dtype != q3.dtype or do3.dtype != q3.dtype:
        raise TypeError("q, k, v and dO must share one dtype")
    if o3 is not None and o3.dtype not in (q3.dtype, torch.float32):
        raise TypeError(f"unsupported O dtype {o3.dtype}")
    if kd.sliding_window is not None and kd.sliding_window < 1:
        raise ValueError("sliding_window must be >= 1")


def _check_cuda(kd, tensors: dict, vectors: dict):
    """Device and contiguity for a kernel launch; returns the parameter
    row it runs and the head-dim panels it covers."""
    first = next(iter(tensors.values()))
    if not first.is_cuda:
        raise ValueError(f"flash backward: unsupported device {first.device}")
    for name, t in {**tensors, **vectors}.items():
        if t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, q on {first.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash backward: {name} must be contiguous")
    for name, t in vectors.items():
        if t.dtype != torch.float32 or t.shape != first.shape[:2]:
            raise ValueError(f"{name} must be fp32 [BH, R]")
    d = first.shape[2]
    row = launch_row(kd, d, [t for name, t in tensors.items() if name != "o"])
    return row, head_dim_panels(row, d)


def _dtype_code(t):
    return 0 if t.dtype == torch.float32 else 1


def _cap2(kd):
    return kd.logit_soft_cap * LOG2E if kd.logit_soft_cap is not None else 0.0


def _launch_codes(row) -> tuple:
    """The row's (kernel code, block_q, block_kv, block_d, producer
    code), the C entry's ints before the stream."""
    return (KERNEL_CODES[row.kernel], row.block_q, row.block_kv,
            row.block_d, params.PRODUCERS[row.producer])


def flash_bwd_q(q3, k3, v3, o3, do3, lse, kd: AttentionKernelDescriptor, *,
                group: int, scale: float, out=None):
    """K3: launches the CUDA kernel for CUDA tensors (or raises); takes the
    plain version for CPU tensors. Returns (dQ, D-term); ``out`` may give
    the two fp32 buffers to write."""
    _check(q3, k3, v3, do3, kd, group, o3)
    if q3.device.type == "cpu":
        dq, dterm = flash_bwd_q_plain(q3, k3, v3, o3, do3, lse, kd,
                                      group=group, scale=scale)
        if out is None:
            return dq, dterm
        out[0].copy_(dq)
        out[1].copy_(dterm)
        return tuple(out)
    bh, r, d = q3.shape
    row, panels = _check_cuda(kd, dict(q=q3, k=k3, v=v3, o=o3, do=do3),
                              dict(lse=lse))
    dq, dterm = output_buffers(out, [(bh, r, d), (bh, r)],
                               [torch.float32] * 2, q3.device)
    build.library().call(
        "mfa_flash_bwd_q", q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
        o3.data_ptr(), do3.data_ptr(), lse.data_ptr(), dq.data_ptr(),
        dterm.data_ptr(), bh, group, r, k3.shape[1], d, panels,
        int(kd.causal), kd.sliding_window or 0, scale * LOG2E, _cap2(kd),
        scale,
        _dtype_code(q3), int(o3.dtype == torch.float32),
        *_launch_codes(row),
        torch.cuda.current_stream(q3.device).cuda_stream)
    flash_bwd_q.launches += 1
    launches_by_row["flash_bwd_q"][row_label(row)] += 1
    return dq, dterm


def flash_bwd_kv(q3, k3, v3, do3, lse, dterm,
                 kd: AttentionKernelDescriptor, *, group: int, scale: float,
                 out=None):
    """K4: launches the CUDA kernel for CUDA tensors (or raises); takes the
    plain version for CPU tensors. Returns (dK, dV); ``out`` may give the
    two fp32 buffers to write."""
    _check(q3, k3, v3, do3, kd, group)
    if q3.device.type == "cpu":
        dk, dv = flash_bwd_kv_plain(q3, k3, v3, do3, lse, dterm, kd,
                                    group=group, scale=scale)
        if out is None:
            return dk, dv
        out[0].copy_(dk)
        out[1].copy_(dv)
        return tuple(out)
    bh, r, d = q3.shape
    bhkv, c, _ = k3.shape
    row, panels = _check_cuda(kd, dict(q=q3, k=k3, v=v3, do=do3),
                              dict(lse=lse, dterm=dterm))
    dk, dv = output_buffers(out, [(bhkv, c, d), (bhkv, c, d)],
                            [torch.float32] * 2, q3.device)
    build.library().call(
        "mfa_flash_bwd_kv", q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
        do3.data_ptr(), lse.data_ptr(), dterm.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), bhkv, group, r, c, d, panels, int(kd.causal),
        kd.sliding_window or 0, scale * LOG2E, _cap2(kd), scale,
        _dtype_code(q3), *_launch_codes(row),
        torch.cuda.current_stream(q3.device).cuda_stream)
    flash_bwd_kv.launches += 1
    launches_by_row["flash_bwd_kv"][row_label(row)] += 1
    return dk, dv


flash_bwd_q.launches = 0
flash_bwd_kv.launches = 0
# Each kernel's launches by the row that ran (descriptors.row_label:
# "wgmma", "wgmma/copy", "mma", ...), whatever stands in for its wrapper.
launches_by_row = {"flash_bwd_q": collections.Counter(),
                   "flash_bwd_kv": collections.Counter()}
