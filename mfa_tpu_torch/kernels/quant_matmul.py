"""INT4-weight matmul: the Hopper kernel K8 and its plain version.

Replaces ``mfa_tpu/kernels/quant_matmul.py::_qmm_kernel`` (signed
nibbles) and ``::_qmm_biased_kernel`` (nibbles q + 8, corrected by
8 * rowsum(x)); the CUDA source is ``csrc/quant_matmul.cu``.
:func:`int4_matmul` launches the kernel for CUDA tensors and takes
:func:`int4_matmul_plain` only for CPU tensors.

The weight is the port's half-split layout (``kernels/quant.py``):
packed [N, K/2], byte (n, i) holding W[i, n] and W[i + K/2, n], with
per-output-channel scales [N] fp32. The layout is named explicitly,
"int4" (int8 bytes, signed nibbles) or "int4_biased" (uint8 bytes), and
must agree with the bytes' dtype: ``mfa_tpu`` inferred it from the dtype
alone.

The kernel copies rows of x and of the packed weights as 16-byte TMA
rows, so it takes K % 32 == 0 and 16-byte aligned packed weights. Any
other even K, or packed weights at another address, the wrapper
re-splits on every call (:func:`repack_halves`), as ``mfa_tpu`` pads K
on every call: the packed rows become [N, K'/2] (K' = K rounded up to
32) with zero bytes past K/2, and x's halves are each padded with zeros
to K'/2, so that byte j still meets x[j] and x[K/2 + j]. A zero byte
adds nothing against x's zero columns, whatever its nibbles mean, and
the biased layout's row sum stays that of x unpadded.
"""

from __future__ import annotations

import torch

from mfa_tpu_torch.kernels import build
from mfa_tpu_torch.kernels.quant import WEIGHT_LAYOUTS, unpack_int4_halves
from mfa_tpu_torch.ops import params as params_mod
from mfa_tpu_torch.utils.device import check_on, resolve_device

# ops/params.py::QMM_TILES, as csrc/quant_matmul.cu numbers them.
_TILE_CODES = {"d8": 0, "d16": 1, "w128": 2, "ffma": 3, "w256": 4}


def int4_tile(m: int, n: int, x_dtype: torch.dtype,
              device: params_mod.HopperDevice = params_mod.H100
              ) -> params_mod.MatmulTile:
    """The tile for M rows of x and N output channels: FMA for fp32
    activations; for bf16 the split-K decode tiles up to 8 or 16 rows
    (M = slots), above them the wgmma tile of 128 or 256 channels whose
    persistent walk takes the fewer rounds times tile area
    (``params.persistent_rounds``; measured on the H100: 256 channels at
    M 2048 on 4096 -> 4096, 14336 -> 4096 and 4096 -> 14336, 128 at
    4096 -> 1024 and at M 100)."""
    tiles = params_mod.QMM_TILES
    if x_dtype == torch.float32:
        return tiles["ffma"]
    if m <= 16:
        return tiles["d8" if m <= 8 else "d16"]
    return min((tiles["w256"], tiles["w128"]),
               key=lambda t: params_mod.persistent_rounds(
                   -(-m // t.block_m) * -(-n // t.block_n),
                   t.block_m * t.block_n, device))


# K8's split-K scratch, one pair per (device, stream): the fp32 partials
# and the int32 arrival counters, each grown as a call needs. The counters
# are zeroed once, then kept at zero between calls by the kernel (the last
# CTA of a channel tile resets its counter); stream order keeps two calls
# from using either at once. Kept, not allocated at each call: the decode
# step makes seven calls a layer.
_SCRATCH: dict = {}


def split_scratch(floats: int, tiles: int, device: torch.device,
                  stream: int):
    """(partials, counters): at least ``floats`` fp32 values and ``tiles``
    int32 counters on ``device`` for the calls on ``stream`` (a
    ``cudaStream_t``), the counters all zero when a call that takes them
    starts (a call ends with every counter it used back at zero)."""
    key = (device, stream)
    part, counters = _SCRATCH.get(key, (None, None))
    if part is None or part.numel() < floats:
        part = torch.empty(max(floats, 1 << 16), dtype=torch.float32,
                           device=device)
    if counters is None or counters.numel() < tiles:
        counters = torch.zeros(max(tiles, 1024), dtype=torch.int32,
                               device=device)
    _SCRATCH[key] = (part, counters)
    return part, counters


def split_launch(m: int, n: int, k: int, tile: params_mod.MatmulTile,
                 device: torch.device, stream: int):
    """K8's decode launch from the shapes alone: (packed columns a split,
    partials, counters). With one split both are None; otherwise the
    partials hold each split's products [tiles, splits, M, block_n] and
    row sums of x [tiles, splits, M] (tiles = ceil(N / block_n)), and the
    counters one per channel tile (:func:`split_scratch`)."""
    cols = params_mod.qmm_split_cols(n, k, tile,
                                     params_mod.detect_device(device))
    splits = -(-(k // 2) // cols)
    if splits == 1:
        return cols, None, None
    tiles = -(-n // tile.block_n)
    return (cols, *split_scratch(tiles * splits * m * (tile.block_n + 1),
                                 tiles, device, stream))


def rowsum(x2: torch.Tensor) -> torch.Tensor:
    """rowsum(x) [M] in fp32 for x [M, K]: the biased layout subtracts 8
    times it, reduced once before the launch as ``mfa_tpu`` does (its
    ``_qmm_biased_kernel`` takes 8 * rowsum(x) as an operand; the kernel
    multiplies by 8, exactly)."""
    return x2.sum(dim=1, dtype=torch.float32)


def repack_halves(x2: torch.Tensor, packed: torch.Tensor):
    """(x', packed') for K8 at K % 32 != 0 or packed weights off 16
    bytes: packed [N, K/2] re-split into a new 16-byte aligned [N, K'/2]
    (K' = K rounded up to 32) with zero bytes past K/2, and x [M, K]
    into [M, K'] as its two halves each padded with zeros to K'/2. The
    products are those of x and packed: padded columns are zero."""
    m, k = x2.shape
    n, kh = packed.shape
    khp = -(-kh // 16) * 16
    wp = packed.new_zeros((n, khp))
    wp[:, :kh] = packed
    xp = x2.new_zeros((m, 2 * khp))
    xp[:, :kh] = x2[:, :kh]
    xp[:, khp:khp + kh] = x2[:, kh:]
    return xp, wp


def int4_matmul_plain(x, packed, scale, *, layout: str):
    """Plain PyTorch version of K8 on x [..., K]: the two K halves against
    the low and high nibbles in fp32 (biased: nibbles q + 8, then minus
    8 * rowsum(x)), times the scale, cast to x's type."""
    n, kh = packed.shape
    *lead, k = x.shape
    x2 = x.reshape(-1, k)
    if layout == "int4":
        lo, hi = unpack_int4_halves(packed)
    else:
        p32 = packed.to(torch.int32)
        lo, hi = p32 & 0x0F, p32 >> 4
    xf = x2.float()
    acc = xf[:, :kh] @ lo.float().t() + xf[:, kh:] @ hi.float().t()
    if layout == "int4_biased":
        acc = acc - 8.0 * rowsum(x2)[:, None]
    return (acc * scale).to(x2.dtype).reshape(*lead, n)


def _check(x, packed, scale, layout):
    want = WEIGHT_LAYOUTS.get(layout)
    if layout not in ("int4", "int4_biased"):
        raise ValueError(f"int4_matmul takes layout 'int4' or 'int4_biased', "
                         f"not {layout!r}")
    if packed.dtype != want:
        raise TypeError(f"layout {layout!r} stores {want} bytes, got "
                        f"{packed.dtype}")
    if packed.dim() != 2:
        raise ValueError(f"packed must be [N, K/2], got {tuple(packed.shape)}")
    n, kh = packed.shape
    if x.shape[-1] != 2 * kh:
        raise ValueError(f"packed rows hold K/2 = {kh} bytes, x has K = "
                         f"{x.shape[-1]}")
    if tuple(scale.shape) != (n,) or scale.dtype != torch.float32:
        raise ValueError(f"scale must be [{n}] fp32, got "
                         f"{tuple(scale.shape)} {scale.dtype}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"int4_matmul takes bf16 or fp32 x, not {x.dtype}")
    if x.numel() == 0:
        raise ValueError("empty x")


def int4_matmul(x, packed, scale, *, layout: str, device="cuda"):
    """K8: y [..., N] = x [..., K] @ W * scale in x's type. All tensors
    must lie on ``device`` (default ``cuda``). Launches the CUDA kernel
    for CUDA tensors (or raises); takes the plain version for CPU
    tensors."""
    _check(x, packed, scale, layout)
    if x.device.type != "cpu" and not x.is_cuda:
        raise ValueError(f"int4_matmul: unsupported device {x.device}")
    check_on(resolve_device(device), x=x, packed=packed, scale=scale)
    *lead, k = x.shape
    n = packed.shape[0]
    if x.device.type == "cpu":
        return int4_matmul_plain(x, packed, scale, layout=layout)
    x2 = x.reshape(-1, k)
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        x2 = x2.clone(memory_format=torch.contiguous_format)
    m = x2.shape[0]
    tile = int4_tile(m, n, x.dtype, params_mod.detect_device(x.device))
    biased = layout == "int4_biased"
    # The row sum of x as given (the repack's zero columns add nothing).
    rs = rowsum(x2) if biased and tile.path == "wgmma" else None
    if k % 32 or not packed.is_contiguous() or packed.data_ptr() % 16:
        x2, packed = repack_halves(x2, packed)
        k = x2.shape[1]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    cols, part, counters = (split_launch(m, n, k, tile, x.device, stream)
                            if tile.path == "splitk" else (0, None, None))
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    build.library().call(
        "mfa_int4_matmul", x2.data_ptr(), packed.data_ptr(),
        scale.contiguous().data_ptr(), *(
            None if t is None else t.data_ptr() for t in (rs, part, counters)),
        y.data_ptr(), m, n, k, int(x.dtype == torch.bfloat16), int(biased),
        _TILE_CODES[tile.name], tile.stages, params_mod.GEMM_TILE_GROUP, cols,
        stream)
    int4_matmul.launches += 1
    return y.reshape(*lead, n)


int4_matmul.launches = 0
