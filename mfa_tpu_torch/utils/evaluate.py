"""Evaluation harness: perplexity with and without a quantized KV cache.

Port of ``mfa_tpu/utils/evaluate.py`` over the port's :class:`Llama`:
:func:`perplexity_full` runs the causal forward (flash kernel K1),
:func:`perplexity_decode` one decode step a token (the fused decode and
append, kernel K2). The north-star gate (``BASELINE.json``) is a
perplexity delta of at most 0.05 between a quantized and a bf16 KV cache;
:func:`kv_quantization_ppl_delta` computes both sides.

One difference from ``mfa_tpu``: its decode path fuses only when
``max_len % 128 == 0`` and one kv block covers the cache, and otherwise
appends with ``update()`` and attends the new token from its stored,
quantized row; the port always fuses and attends it from k_new. The
default ``max_len`` of ``t + 8`` is ``mfa_tpu``'s; pass a multiple of 128
to compare the two.
"""

from __future__ import annotations

import math

import torch

from mfa_tpu_torch.models.llama import Llama
from mfa_tpu_torch.ops.precision import OperandPrecision


def _tokens(model: Llama, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=model.device).long()


def _nll(logits, targets) -> torch.Tensor:
    """Token NLL of targets under fp32 logits [..., V]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets[..., None])[..., 0]


@torch.inference_mode()
def perplexity_full(model: Llama, tokens) -> float:
    """Teacher-forced perplexity of tokens [B, T] through the (flash
    kernel) causal forward."""
    tokens = _tokens(model, tokens)
    logits = model(tokens[:, :-1])
    return float(torch.exp(_nll(logits, tokens[:, 1:]).mean()))


@torch.inference_mode()
def perplexity_decode(model: Llama, tokens, kv_precision: OperandPrecision,
                      max_len: int | None = None) -> float:
    """Teacher-forced perplexity through the decode path: prefill token 0,
    then feed token i through ``decode_step`` (appending its KV to a cache
    in ``kv_precision``) and score token i + 1 from its logits."""
    tokens = _tokens(model, tokens)
    b, t = tokens.shape
    caches = model.make_caches(b, max_len or (t + 8), kv_precision)
    _, caches = model(tokens[:, :1], caches=caches)
    nll_total, count = 0.0, 0
    for i in range(1, t):
        logits, caches = model.decode_step(tokens[:, i], caches)
        if i + 1 < t:
            nll_total += float(_nll(logits, tokens[:, i + 1]).mean())
            count += 1
    return math.exp(nll_total / max(count, 1))


def kv_quantization_ppl_delta(model: Llama, tokens,
                              quant_precision: OperandPrecision,
                              max_len: int | None = None
                              ) -> tuple[float, float, float]:
    """(ppl_bf16_kv, ppl_quant_kv, delta) through the decode path."""
    p_ref = perplexity_decode(model, tokens, OperandPrecision.BF16, max_len)
    p_q = perplexity_decode(model, tokens, quant_precision, max_len)
    return p_ref, p_q, abs(p_q - p_ref)
