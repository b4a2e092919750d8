"""Operand precision model and mixed-precision policy.

Port of ``mfa_tpu/ops/precision.py``: :class:`OperandPrecision`, the
per-operand :class:`PrecisionPolicy` built by :func:`make_precision_policy`
from the two boolean knobs (plus the KV-cache knob), and the test budget
model :func:`tolerance_for` (fp32 2e-5, mixed 5e-2, L/D 7e-3).

On Hopper the tensor cores take bf16, fp16, fp8 and int8 operands with
fp32 accumulation, so the policy keeps the same shape as on the TPU.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import torch


class OperandPrecision(enum.Enum):
    """Storage/compute precision of one operand."""

    FP32 = "fp32"
    BF16 = "bf16"
    FP16 = "fp16"
    FP8_E4M3 = "fp8_e4m3"
    FP8_E5M2 = "fp8_e5m2"
    INT8 = "int8"
    INT4 = "int4"

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self]

    @property
    def bits(self) -> int:
        return _BITS[self]

    @property
    def bytes(self) -> float:
        """Size in bytes (INT4 is fractional; it packs 2 values/byte)."""
        return self.bits / 8

    @property
    def is_quantized(self) -> bool:
        """Quantized formats need a scale."""
        return self in (
            OperandPrecision.FP8_E4M3,
            OperandPrecision.FP8_E5M2,
            OperandPrecision.INT8,
            OperandPrecision.INT4,
        )

    @classmethod
    def from_dtype(cls, dtype: torch.dtype) -> "OperandPrecision":
        for prec, dt in _DTYPES.items():
            if prec is not cls.INT4 and dt == dtype:
                return prec
        raise ValueError(f"no OperandPrecision for dtype {dtype}")


_DTYPES = {
    OperandPrecision.FP32: torch.float32,
    OperandPrecision.BF16: torch.bfloat16,
    OperandPrecision.FP16: torch.float16,
    OperandPrecision.FP8_E4M3: torch.float8_e4m3fn,
    OperandPrecision.FP8_E5M2: torch.float8_e5m2,
    OperandPrecision.INT8: torch.int8,
    OperandPrecision.INT4: torch.int8,  # packed 2-per-byte
}

_BITS = {
    OperandPrecision.FP32: 32,
    OperandPrecision.BF16: 16,
    OperandPrecision.FP16: 16,
    OperandPrecision.FP8_E4M3: 8,
    OperandPrecision.FP8_E5M2: 8,
    OperandPrecision.INT8: 8,
    OperandPrecision.INT4: 4,
}


class AttentionOperand(enum.Enum):
    """The operands of the three attention kernels. S, P, dP, dS are
    virtual: they never leave the kernel."""

    Q = "Q"
    K = "K"
    S = "S"
    P = "P"
    V = "V"
    O = "O"
    L = "L"
    D = "D"
    dO = "dO"
    dV = "dV"
    dP = "dP"
    dS = "dS"
    dK = "dK"
    dQ = "dQ"

    @property
    def is_virtual(self) -> bool:
        return self in (
            AttentionOperand.S,
            AttentionOperand.P,
            AttentionOperand.dP,
            AttentionOperand.dS,
        )


@dataclass(frozen=True)
class PrecisionPolicy:
    """Resolved per-operand precisions: ``memory`` is what lives in device
    memory, ``register`` what feeds the tensor cores (accumulators are
    always fp32). L and D stay fp32."""

    memory: dict
    register: dict

    def mem(self, operand: AttentionOperand) -> OperandPrecision:
        return self.memory[operand]

    def reg(self, operand: AttentionOperand) -> OperandPrecision:
        return self.register[operand]


def make_precision_policy(
    low_precision_inputs: bool = False,
    low_precision_intermediates: bool = False,
    kv_cache_precision: OperandPrecision | None = None,
) -> PrecisionPolicy:
    """Map the two boolean knobs plus the KV-cache knob onto per-operand
    precisions (same table as ``mfa_tpu``)."""
    lo = OperandPrecision.BF16 if low_precision_inputs else OperandPrecision.FP32
    fp32 = OperandPrecision.FP32

    memory = {
        AttentionOperand.Q: lo,
        AttentionOperand.K: lo,
        AttentionOperand.V: lo,
        AttentionOperand.dO: lo,
        AttentionOperand.O: lo if low_precision_intermediates else fp32,
        AttentionOperand.L: fp32,
        AttentionOperand.D: fp32,
        AttentionOperand.dV: fp32,
        AttentionOperand.dK: fp32,
        AttentionOperand.dQ: fp32,
    }
    if kv_cache_precision is not None:
        memory[AttentionOperand.K] = kv_cache_precision
        memory[AttentionOperand.V] = kv_cache_precision

    # P (and dS) may drop to bf16 before the PV product when the inputs
    # are low precision.
    reg_p = OperandPrecision.BF16 if low_precision_inputs else fp32
    register = {
        AttentionOperand.Q: lo,
        AttentionOperand.K: lo,
        AttentionOperand.V: lo,
        AttentionOperand.dO: lo,
        AttentionOperand.S: fp32,
        AttentionOperand.P: reg_p,
        AttentionOperand.dP: fp32,
        AttentionOperand.dS: reg_p,
        AttentionOperand.O: fp32,
        AttentionOperand.L: fp32,
        AttentionOperand.D: fp32,
        AttentionOperand.dV: fp32,
        AttentionOperand.dK: fp32,
        AttentionOperand.dQ: fp32,
    }
    return PrecisionPolicy(memory=memory, register=register)


def tolerance_for(policy: PrecisionPolicy, operand: AttentionOperand,
                  accumulation_length: int = 0) -> float:
    """Error budget for tests: 2e-5 all-fp32, 7e-3 for L/D, 5e-2 mixed,
    scaled up linearly past an accumulation length of 4096."""
    mem = policy.mem(operand)
    if (mem is OperandPrecision.FP32
            and policy.mem(AttentionOperand.Q) is OperandPrecision.FP32):
        base = 2e-5
    elif operand in (AttentionOperand.L, AttentionOperand.D):
        base = 7e-3
    else:
        base = 5e-2
    if accumulation_length > 4096:
        base *= accumulation_length / 4096
    return base
