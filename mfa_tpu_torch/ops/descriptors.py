"""Problem- and kernel-level attention descriptors.

Port of the attention half of ``mfa_tpu/ops/descriptors.py``: a frozen
problem descriptor (:class:`AttentionDescriptor`) resolves through the
parameter tables (``ops/params.py``) to a hashable kernel descriptor
(:class:`AttentionKernelDescriptor`), the key of the kernel cache.

Dropped from the TPU version: the scheduling knobs ``block_q_inner``,
``block_kv_inner`` and ``causal_mode`` (the Hopper kernel bounds its kv
loop per CTA instead), and the fp16 refusal. GEMM descriptors come with
the GEMM slice.
"""

from __future__ import annotations

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
        class."""
        if self.head_dim > params_mod.MAX_HEAD_DIM:
            raise ValueError(
                f"head_dim {self.head_dim} > {params_mod.MAX_HEAD_DIM}: the "
                "Hopper flash kernels have no head-dim blocking yet")
        rows = params_mod.parameter_table(
            _TABLE[kernel_type],
            "bf16" if self.low_precision_inputs else "fp32", device)
        row = params_mod.select_row(rows, self.head_dim)
        policy = self.precision_policy()
        return AttentionKernelDescriptor(
            kernel_type=kernel_type,
            block_q=row.block_q,
            block_kv=row.block_kv,
            block_d=row.block_d,
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


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
