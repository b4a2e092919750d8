"""Problem- and kernel-level descriptors, attention and GEMM.

Port of ``mfa_tpu/ops/descriptors.py``: a frozen problem descriptor
(:class:`AttentionDescriptor`, :class:`GEMMDescriptor`) resolves through
the parameter tables (``ops/params.py``) to a hashable kernel descriptor
(:class:`AttentionKernelDescriptor`, :class:`GEMMKernelDescriptor`).

Dropped from the TPU version: the attention scheduling knobs
``block_q_inner``, ``block_kv_inner`` and ``causal_mode`` (the Hopper
kernel bounds its kv loop per CTA instead), the fp16 refusal, and the
GEMM's VMEM budget and whole-K macro-tiles (TPU measurements): the GEMM
tile comes from the problem's shape and the card's SM count, checked
against its shared memory.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from dataclasses import dataclass

import torch

from mfa_tpu_torch.ops import params as params_mod
from mfa_tpu_torch.ops.precision import (
    AttentionOperand,
    OperandPrecision,
    PrecisionPolicy,
    make_precision_policy,
)


class AttentionKernelType(enum.Enum):
    """The three-kernel split: forward (K1), backward_query (K3, dQ and
    the D-term) and backward_key_value (K4, dK and dV)."""

    FORWARD = "forward"
    BACKWARD_QUERY = "backward_query"
    BACKWARD_KEY_VALUE = "backward_key_value"


_TABLE = {
    AttentionKernelType.FORWARD: "flash_fwd",
    AttentionKernelType.BACKWARD_QUERY: "flash_bwd_q",
    AttentionKernelType.BACKWARD_KEY_VALUE: "flash_bwd_kv",
}


@dataclass(frozen=True)
class AttentionDescriptor:
    """User-facing attention problem spec, with batch, heads and GQA."""

    batch: int
    num_q_heads: int
    num_kv_heads: int
    seq_len_q: int      # R
    seq_len_kv: int     # C
    head_dim: int       # D
    causal: bool = False
    scale: float | None = None      # None => 1/sqrt(D)
    logit_soft_cap: float | None = None
    # Each query attends the W keys ending at its causal diagonal.
    sliding_window: int | None = None
    low_precision_inputs: bool = False
    low_precision_intermediates: bool = False
    kv_cache_precision: OperandPrecision | None = None

    def __post_init__(self):
        if self.num_q_heads % self.num_kv_heads != 0:
            raise ValueError(
                f"num_q_heads ({self.num_q_heads}) must be a multiple of "
                f"num_kv_heads ({self.num_kv_heads})")

    @property
    def softmax_scale(self) -> float:
        return (self.scale if self.scale is not None
                else 1.0 / math.sqrt(self.head_dim))

    def precision_policy(self) -> PrecisionPolicy:
        return make_precision_policy(self.low_precision_inputs,
                                     self.low_precision_intermediates,
                                     self.kv_cache_precision)

    def kernel_descriptor(
        self,
        kernel_type: AttentionKernelType,
        device: params_mod.HopperDevice = params_mod.H100,
    ) -> "AttentionKernelDescriptor":
        """Pick the table row for this kernel, head dim and precision
        class; head dims above 256 take the D-blocked rows. The three
        kernels take their bf16 tables at every even D up to 256 (their
        copying producers) and past it where TMA maps a row."""
        precision = ("fp32" if not self.low_precision_inputs
                     else params_mod.flash_bf16_table_precision(self.head_dim))
        rows = params_mod.parameter_table(_TABLE[kernel_type], precision,
                                          device)
        row = params_mod.select_row(rows, self.head_dim)
        policy = self.precision_policy()
        return AttentionKernelDescriptor(
            kernel_type=kernel_type,
            block_q=row.block_q,
            block_kv=row.block_kv,
            block_d=row.block_d,
            kernel=row.kernel,
            head_dim=self.head_dim,
            causal=self.causal,
            sliding_window=self.sliding_window,
            logit_soft_cap=self.logit_soft_cap,
            q_precision=policy.mem(AttentionOperand.Q),
            kv_precision=policy.mem(AttentionOperand.K),
            o_precision=policy.mem(AttentionOperand.O),
            p_register=policy.reg(AttentionOperand.P),
            ds_register=policy.reg(AttentionOperand.dS),
            device=device.name,
        )


@dataclass(frozen=True)
class AttentionKernelDescriptor:
    """Shape-class descriptor = kernel-cache key: everything the launch
    needs, nothing tied to exact sequence lengths."""

    kernel_type: AttentionKernelType
    block_q: int
    block_kv: int
    block_d: int
    kernel: str
    head_dim: int
    causal: bool
    sliding_window: int | None
    logit_soft_cap: float | None
    q_precision: OperandPrecision
    kv_precision: OperandPrecision
    o_precision: OperandPrecision
    # P -> PV and dS cast decisions (bf16 only for bf16 inputs).
    p_register: OperandPrecision = OperandPrecision.BF16
    ds_register: OperandPrecision = OperandPrecision.BF16
    device: str = "sm90"

    def register_dtype(self, reg: OperandPrecision,
                       operand_dtype: torch.dtype) -> torch.dtype:
        """A 16-bit register precision materializes in the operand's own
        16-bit type; otherwise fp32."""
        if reg.bits > 16 or operand_dtype.itemsize > 2:
            return torch.float32
        return operand_dtype


# The C entries' kernel codes: the first-cut kernels, the wgmma kernels,
# the D-blocked kernels, the head-dim-split cluster kernels.
KERNEL_CODES = {"": 0, "mma": 0, "wgmma": 1, "mma_dblk": 2, "fma_dblk": 2,
                "wgmma_dblk": 3}


def head_dim_panels(row, head_dim: int) -> int:
    """The head-dim panels a flash kernel's launch covers at ``row`` (a
    parameter row or kernel descriptor): D / block_d rounded up for a
    D-blocked row (for ``wgmma_dblk`` the CTAs of a cluster, at most
    ``params.dblk_max_panels``), else 1, and then D must fit block_d."""
    if row.kernel in params_mod.DBLK_KERNELS:
        panels = -(-head_dim // row.block_d)
        if (row.kernel == "wgmma_dblk"
                and panels > params_mod.dblk_max_panels(row.block_d)):
            raise ValueError(f"head dim {head_dim} needs {panels} panels of "
                             f"{row.block_d}, more than the cluster kernel's "
                             f"{params_mod.dblk_max_panels(row.block_d)}")
        return panels
    if head_dim > row.block_d:
        raise ValueError(f"head dim {head_dim} exceeds the kernel's "
                         f"{row.block_d}")
    return 1


def copy_granule(head_dim: int, tensors) -> int:
    """The largest of 16, 8, 4 and 2 bytes that a row of ``head_dim`` bf16
    values and every base address of ``tensors`` are multiples of (as
    csrc/flash_fwd.cu reckons its granule)."""
    g = 16
    while g > 2 and ((2 * head_dim) % g
                     or any(t.data_ptr() % g for t in tensors)):
        g //= 2
    return g


def launch_row(kd: AttentionKernelDescriptor, head_dim: int,
               tensors) -> params_mod.ParameterRow:
    """The parameter row a flash kernel's launch runs: the descriptor's,
    except where TMA cannot map the operands of a wgmma or wgmma_dblk row
    (a row of ``head_dim`` bf16 values that is no multiple of 16 bytes, or
    a base address that is not 16-byte aligned). There K1's, K3's and
    K4's rows keep their kernel with the copying producer (``producer``
    "copy") when one CTA holds the head dim (D <= block_d) and the rows
    and bases share 4 bytes; every other such row takes the mma.sync row
    of its head dim (mma, or mma_dblk past D = 256): odd D, 2-byte-shifted
    bases, the clusters past D = 256. ``tensors`` are the operands the
    producer copies (K1: q, k, v and the O buffer; K3, K4: q, k, v, dO).
    The launch covers ``head_dim_panels(row, head_dim)`` panels of the row
    it returns."""
    row = params_mod.ParameterRow(kd.head_dim, kd.block_q, kd.block_kv,
                                  kd.block_d, kd.kernel)
    if kd.kernel not in ("wgmma", "wgmma_dblk") or (
            head_dim % 8 == 0 and all(t.data_ptr() % 16 == 0
                                      for t in tensors)):
        return row
    if head_dim <= kd.block_d and copy_granule(head_dim, tensors) >= 4:
        return dataclasses.replace(row, producer="copy")
    return params_mod.select_row(params_mod.parameter_table(
        _TABLE[kd.kernel_type], "bf16_mma"), head_dim)


def row_label(row) -> str:
    """A launch row's kernel, and its producer where it is not TMA:
    "wgmma", "wgmma/copy", "mma", ..."""
    producer = getattr(row, "producer", "")
    return f"{row.kernel}/{producer}" if producer else row.kernel


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# GEMM descriptors
# ---------------------------------------------------------------------------

_MMA_TYPES = (OperandPrecision.BF16, OperandPrecision.FP16)


@dataclass(frozen=True)
class GEMMDescriptor:
    """GEMM problem: C[b] = op(A[b]) @ op(B[b]) (+ C0[b]), op an optional
    transpose of the stored operand; fp32 accumulation."""

    m: int
    n: int
    k: int
    a_precision: OperandPrecision = OperandPrecision.FP32
    b_precision: OperandPrecision = OperandPrecision.FP32
    c_precision: OperandPrecision = OperandPrecision.FP32
    transpose_a: bool = False
    transpose_b: bool = False
    batch: int = 1
    load_previous_c: bool = False

    def kernel_descriptor(
        self, device: params_mod.HopperDevice = params_mod.H100,
    ) -> "GEMMKernelDescriptor":
        """Tile heuristic for Hopper. A decode-sized M (<= 16 rows) of two
        16-bit operands of one type takes mma.sync's 16-row tile, so a
        batch of 4-8 rows does not pay for a 128-row tile. Above it, two
        bf16 operands take a wgmma tile: of 128 x 256 and 128 x 128, the
        one whose persistent walk takes the least time in whole rounds of
        one tile an SM (``params.persistent_rounds``; a tie takes the
        larger tile, which reads each operand fewer times), with
        ``mma_tile`` the mma.sync tile for operands TMA cannot map.
        Measured on the H100 (``utils/bwd_tuning.py sweep --only
        matmul``): 128 x 256 at 4096^3 (0.21 against 0.27 ms) and 1536^3
        (0.025 against 0.033), 128 x 128 where one round of it covers the
        problem (2048 x 1024 x 4096: 0.038 against 0.050 ms). fp16, or
        bf16 operands TMA cannot map, take the mma.sync tiles: 128 x 128
        when those tiles alone fill every SM, else 64 x 64. fp32 and mixed operands
        take the FMA tile (fp32 is computed in full precision, never TF32;
        a bf16 operand widens exactly)."""
        mma = (self.a_precision in _MMA_TYPES
               and self.a_precision is self.b_precision)
        mma_tile = None
        if not mma:
            name = "ffma"
        elif self.m <= 16:
            name = "m16"
        else:
            tiles = (-(-self.m // 128)) * (-(-self.n // 128)) * self.batch
            name = "m128" if tiles >= device.sm_count else "m64"
            if self.a_precision is OperandPrecision.BF16:
                mma_tile = params_mod.GEMM_TILES[name]
                name = min(("w256", "w128"), key=lambda t: self._rounds(
                    params_mod.GEMM_TILES[t], device))
        tile = params_mod.GEMM_TILES[name]
        for t in (tile, mma_tile):
            if t is not None:
                params_mod.check_tile_fits(
                    params_mod.gemm_smem_bytes(t, self.transpose_a,
                                               self.transpose_b), t, device)
        return GEMMKernelDescriptor(
            tile=tile,
            mma_tile=mma_tile,
            a_precision=self.a_precision,
            b_precision=self.b_precision,
            c_precision=self.c_precision,
            transpose_a=self.transpose_a,
            transpose_b=self.transpose_b,
            load_previous_c=self.load_previous_c,
            device=device.name,
        )

    def _rounds(self, tile: params_mod.MatmulTile,
                device: params_mod.HopperDevice) -> int:
        tiles = (-(-self.m // tile.block_m) * -(-self.n // tile.block_n)
                 * self.batch)
        return params_mod.persistent_rounds(
            tiles, tile.block_m * tile.block_n, device)


@dataclass(frozen=True)
class GEMMKernelDescriptor:
    """GEMM shape-class descriptor: the tile and what the launch needs.
    Accumulation is always fp32 (a bf16 accumulator is refused, as in
    ``mfa_tpu``: none of the paths has one). ``mma_tile``: with a wgmma
    ``tile``, the mma.sync tile a launch runs when TMA cannot map the
    operands (``kernels/gemm_kernel.py::launch_tile``). ``group``: the
    band (tile rows) of the wgmma kernel's tile walk, None for
    ``params.GEMM_TILE_GROUP`` at launch (the autotune sets it)."""

    tile: params_mod.MatmulTile
    a_precision: OperandPrecision
    b_precision: OperandPrecision
    c_precision: OperandPrecision
    transpose_a: bool
    transpose_b: bool
    load_previous_c: bool
    mma_tile: params_mod.MatmulTile | None = None
    device: str = "sm90"
    group: int | None = None
