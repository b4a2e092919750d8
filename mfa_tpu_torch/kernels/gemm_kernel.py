"""Batched GEMM: the Hopper kernel K7 and its plain version.

Replaces ``mfa_tpu/kernels/gemm_kernel.py::_gemm_kernel``; the CUDA source
is ``csrc/gemm.cu``. :func:`gemm_kernel` launches the kernel for CUDA
tensors and takes :func:`gemm_kernel_plain` only for CPU tensors.

Operands as stored: A [batch, M, K] (or [batch, K, M] when the kernel
descriptor says ``transpose_a``), B [batch, K, N] (or [batch, N, K] when
``transpose_b``), optional C0 [batch, M, N]; C [batch, M, N] in the
output type. A and B may be slices of larger buffers: the kernel reads
them through their row and batch strides; only a non-unit innermost
stride is copied to a contiguous tensor first. A wgmma tile runs only
where TMA can map both operands (:func:`tma_mappable`); elsewhere the
launch takes the descriptor's mma.sync tile (:func:`launch_tile`).
"""

from __future__ import annotations

import torch

from mfa_tpu_torch.kernels import build
from mfa_tpu_torch.ops import params as params_mod
from mfa_tpu_torch.ops.descriptors import GEMMKernelDescriptor

# Element types as csrc/gemm.cu numbers them.
TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# ops/params.py::GEMM_TILES, as csrc/gemm.cu numbers them.
_TILE_CODES = {"m128": 0, "m64": 1, "m16": 2, "ffma": 3, "w256": 4,
               "w128": 5}


def tma_mappable(*operands: torch.Tensor) -> bool:
    """Whether TMA can map every stored operand [batch, rows, cols] as a
    3-D tensor of bf16: a 16-byte-aligned base, a unit inner stride, and
    row and (for a batch of more than one) batch strides of whole 16
    bytes that do not overlap the dimension inside them."""
    for t in operands:
        batch, rows, cols = t.shape
        if (t.dtype != torch.bfloat16 or t.data_ptr() % 16
                or t.stride(2) != 1 or t.stride(1) % 8
                or t.stride(1) < cols):
            return False
        if batch > 1 and (t.stride(0) % 8 or t.stride(0) < t.stride(1) * rows):
            return False
    return True


def launch_tile(kd: GEMMKernelDescriptor, a3: torch.Tensor,
                b3: torch.Tensor) -> params_mod.MatmulTile:
    """The tile a launch on these stored operands runs: the descriptor's,
    except that a wgmma tile whose operands TMA cannot map takes the
    descriptor's mma.sync tile."""
    if kd.tile.path == "wgmma" and not tma_mappable(a3, b3):
        return kd.mma_tile
    return kd.tile


def dims(a3, b3, kd: GEMMKernelDescriptor):
    """(batch, M, N, K) of stored operands under kd's transposes."""
    m, ka = ((a3.shape[2], a3.shape[1]) if kd.transpose_a
             else (a3.shape[1], a3.shape[2]))
    kb, n = ((b3.shape[2], b3.shape[1]) if kd.transpose_b
             else (b3.shape[1], b3.shape[2]))
    if ka != kb:
        raise ValueError(f"K mismatch: {ka} vs {kb}")
    return a3.shape[0], m, n, ka


def gemm_kernel_plain(a3, b3, c0, kd: GEMMKernelDescriptor, *,
                      out_dtype: torch.dtype):
    """Plain PyTorch version of K7: the fp32 product of the upcast
    operands, plus C0 rounded to the output type first, cast once."""
    a = a3.float().transpose(1, 2) if kd.transpose_a else a3.float()
    b = b3.float().transpose(1, 2) if kd.transpose_b else b3.float()
    c = torch.bmm(a, b)
    if c0 is not None:
        c = c + c0.to(out_dtype).float()
    return c.to(out_dtype)


def _check(a3, b3, c0, kd, out_dtype):
    if a3.dim() != 3 or b3.dim() != 3:
        raise ValueError(f"bad shapes a {tuple(a3.shape)} b {tuple(b3.shape)}")
    batch, m, n, k = dims(a3, b3, kd)
    if b3.shape[0] != batch:
        raise ValueError(f"batch mismatch: {tuple(a3.shape)} vs "
                         f"{tuple(b3.shape)}")
    if min(batch, m, n, k) < 1:
        raise ValueError(f"empty problem: batch {batch}, M {m}, N {n}, K {k}")
    for name, t in (("a", a3), ("b", b3), ("c", out_dtype)):
        dt = t if isinstance(t, torch.dtype) else t.dtype
        if dt not in TYPE_CODES:
            raise TypeError(f"gemm takes fp32, bf16 or fp16; {name} is {dt}")
    if c0 is not None and tuple(c0.shape) != (batch, m, n):
        raise ValueError(f"c0 must be {(batch, m, n)}, got {tuple(c0.shape)}")
    return batch, m, n, k


def _inner_unit(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(2) == 1 or t.shape[2] == 1 else t.contiguous()


def gemm_kernel(a3, b3, c0, kd: GEMMKernelDescriptor, *,
                out_dtype: torch.dtype):
    """K7: launches the CUDA kernel for CUDA tensors (or raises); takes the
    plain version for CPU tensors. Returns C [batch, M, N]."""
    batch, m, n, k = _check(a3, b3, c0, kd, out_dtype)
    if a3.device.type == "cpu":
        return gemm_kernel_plain(a3, b3, c0, kd, out_dtype=out_dtype)
    if not a3.is_cuda:
        raise ValueError(f"gemm_kernel: unsupported device {a3.device}")
    for name, t in (("b", b3), ("c0", c0)):
        if t is not None and t.device != a3.device:
            raise ValueError(f"{name} is on {t.device}, a on {a3.device}")
    if kd.tile.path != "ffma" and not (a3.dtype == b3.dtype != torch.float32):
        raise TypeError(f"the {kd.tile.path} tile takes two bf16 or two "
                        f"fp16 operands")
    a3, b3 = _inner_unit(a3), _inner_unit(b3)
    tile = launch_tile(kd, a3, b3)
    if c0 is not None:
        c0 = c0.to(out_dtype).contiguous()
    c = torch.empty((batch, m, n), dtype=out_dtype, device=a3.device)
    # A batch of one has no batch stride to honour (nor to align).
    build.library().call(
        "mfa_gemm", a3.data_ptr(), b3.data_ptr(),
        None if c0 is None else c0.data_ptr(), c.data_ptr(), batch, m, n, k,
        a3.stride(1), a3.stride(0) if batch > 1 else 0,
        b3.stride(1), b3.stride(0) if batch > 1 else 0,
        TYPE_CODES[a3.dtype], TYPE_CODES[b3.dtype], TYPE_CODES[out_dtype],
        int(kd.transpose_a), int(kd.transpose_b), _TILE_CODES[tile.name],
        tile.stages,
        params_mod.GEMM_TILE_GROUP if kd.group is None else kd.group,
        torch.cuda.current_stream(a3.device).cuda_stream)
    gemm_kernel.launches += 1
    return c


gemm_kernel.launches = 0
