"""The benchmark's arithmetic: peaks, least times, work counts, tails.

Everything here is reckoned from shapes and from the requests the harness
itself sent, never read from the program.

- Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at the
  full 700 W limit): 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s HBM.
- Attention counts 4 * D operations per (query head, key) pair that the
  mask keeps: two for the score, two for the value product.
- A projection of K inputs to N outputs counts 2 * K * N per token.
- The kernel groups are the profiler's kernel-name patterns, first match
  wins.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

# (group, name patterns): K7 and K8 come before "matmul", whose patterns
# would swallow them. K2, K5 and K6 are one template told apart by the
# row functor that each of their kernels carries.
GROUPS = (("flash_fwd", ("flash_fwd",)),
          ("flash_bwd_q", ("flash_bwd_q",)),
          ("flash_bwd_kv", ("flash_bwd_kv",)),
          ("decode_fused_append", ("FusedRows",)),
          ("paged_decode", ("PagedRows",)),
          ("decode_attend", ("ContiguousRows",)),
          ("scatter_append", ("index_elementwise", "index_put",
                              "scatter_gather")),
          ("gemm_kernel", ("mfa_gemm",)),
          ("int4_matmul", ("qmm_int4",)),
          ("matmul", ("gemm", "gemv", "cutlass", "xmma", "nvjet", "sm90_")))


def group_of(kernel_name: str) -> str:
    for group, patterns in GROUPS:
        if any(p in kernel_name for p in patterns):
            return group
    return "other"


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the bf16 peak and the bytes over the HBM rate."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


@dataclass(frozen=True)
class Shape:
    """A decoder's sizes, read from a Hugging Face config.json's fields."""

    layers: int
    dim: int
    heads: int
    kv_heads: int
    head_dim: int
    ffn: int
    vocab: int
    window: int | None
    qkv_bias: bool
    tied: bool

    @classmethod
    def from_config(cls, c: dict) -> "Shape":
        heads = c["num_attention_heads"]
        window = c.get("sliding_window")
        if not c.get("use_sliding_window", True):
            window = None
        return cls(layers=c["num_hidden_layers"], dim=c["hidden_size"],
                   heads=heads,
                   kv_heads=c.get("num_key_value_heads", heads),
                   head_dim=c.get("head_dim") or c["hidden_size"] // heads,
                   ffn=c["intermediate_size"], vocab=c["vocab_size"],
                   window=window, qkv_bias=c["model_type"] == "qwen2",
                   tied=bool(c.get("tie_word_embeddings", False)))

    @property
    def layer_params(self) -> int:
        """Weights of one block: projections, norms and QKV biases."""
        qd, kd = self.heads * self.head_dim, self.kv_heads * self.head_dim
        n = self.dim * (qd + 2 * kd) + qd * self.dim + 3 * self.dim * self.ffn
        n += 2 * self.dim
        if self.qkv_bias:
            n += qd + 2 * kd
        return n

    @property
    def nonembed_params(self) -> int:
        return self.layers * self.layer_params + self.dim

    def span(self, ctx: int) -> int:
        """Keys one query at context ``ctx`` (itself included) attends."""
        return ctx if self.window is None else min(ctx, self.window)


def kept_pairs(t: int, window: int | None) -> int:
    """(query, key) pairs a causal mask over t positions keeps, with a
    sliding window that keeps the last ``window`` keys of each query."""
    if window is None or window >= t:
        return t * (t + 1) // 2
    return window * (window + 1) // 2 + (t - window) * window


def attention_flops(s: Shape, pairs: int) -> float:
    """All layers' attention over ``pairs`` kept pairs of each query head."""
    return 4.0 * s.head_dim * s.heads * pairs * s.layers


def lm_head_flops(s: Shape) -> float:
    return 2.0 * s.dim * s.vocab


def prefill_flops(s: Shape, t: int) -> float:
    """What a prompt of ``t`` true tokens needs: every projection at every
    position, causal attention over the kept pairs, and the logits of the
    last position only (the one the first token is drawn from)."""
    return (2.0 * s.nonembed_params * t
            + attention_flops(s, kept_pairs(t, s.window)) + lm_head_flops(s))


def decode_flops(s: Shape, ctx: int) -> float:
    """One decoded token at context ``ctx`` (after its own append)."""
    return (2.0 * s.nonembed_params + attention_flops(s, s.span(ctx))
            + lm_head_flops(s))


def k6_launch(s: Shape, contexts, kv_bytes: int, scaled: bool):
    """(operations, bytes) of one layer's paged decode over the active
    slots at ``contexts`` (each after its append): every kept K and V row
    read once in its storage type, its fp32 scales where the pages are
    quantized, and each slot's bf16 q read and o written once."""
    flops = nbytes = 0.0
    row = s.kv_heads * s.head_dim * kv_bytes + (s.kv_heads * 4 if scaled
                                               else 0)
    qo = 2 * s.heads * s.head_dim * 2
    for ctx in contexts:
        keys = s.span(ctx)
        flops += 4.0 * s.head_dim * s.heads * keys
        nbytes += 2.0 * keys * row + qo
    return flops, nbytes


def k1_launch(s: Shape, t: int):
    """(operations, bytes) of one layer's causal prefill attention over a
    prompt of ``t`` true tokens: q, k and v read once and o written once
    in bf16, at the true length (bucket padding is not work)."""
    flops = 4.0 * s.head_dim * s.heads * kept_pairs(t, s.window)
    nbytes = 2.0 * t * s.head_dim * (2 * s.heads + 2 * s.kv_heads)
    return flops, nbytes


def k34_launch(s: Shape, t: int):
    """(operations, bytes) of one layer's attention backward (K3 and K4
    together) over a sequence of ``t`` tokens: the four products the
    gradients need (dP, dS into dQ and dK, P into dV; the score that the
    kernels compute again is not counted), 8 * D a kept pair; q, o, dO,
    k, v read and dQ, dK, dV written once in bf16."""
    flops = 8.0 * s.head_dim * s.heads * kept_pairs(t, s.window)
    nbytes = 2.0 * t * s.head_dim * (4 * s.heads + 4 * s.kv_heads)
    return flops, nbytes


def train_flops(s: Shape, t: int) -> float:
    """What one training sequence of ``t`` tokens needs: 6 per weight per
    token, attention forward (4 * D) and backward (8 * D) a kept pair, and
    the output head forward and backward at every position."""
    return (6.0 * s.nonembed_params * t
            + 12.0 * s.head_dim * s.heads * kept_pairs(t, s.window) * s.layers
            + 3.0 * lm_head_flops(s) * t)


def tail(values, q: float = 0.95) -> float:
    """The nearest-rank percentile: the smallest value with at least a
    share ``q`` of the values at or below it."""
    if not values:
        raise ValueError("no values")
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]
