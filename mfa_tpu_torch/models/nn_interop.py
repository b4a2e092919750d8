"""``torch.nn`` interop: a drop-in self-attention module over the kernels.

Port of ``mfa_tpu/models/flax_interop.py``. :class:`FlashSelfAttention`
replaces a model's dot-product self-attention with ``flash_attention``
(kernel K1 forward, K3 and K4 backward), with the flax module's contract:
[batch, seq, features] in and out, projections ``q_proj``, ``k_proj``,
``v_proj`` and ``o_proj`` without bias, GQA, causal, sliding window and
soft-cap. A ``torch.nn`` module needs its input width when it is built,
where flax reads it from the first input, so ``features`` is an argument.

:func:`load_flax_params` carries a flax module's ``DenseGeneral``
kernels across: q/k/v kernels [F, H, D] become ``nn.Linear`` weights
[H·D, F], the output kernel [H·D, F] becomes [F, H·D].
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from mfa_tpu_torch.models.from_jax import _tensor
from mfa_tpu_torch.ops.attention import flash_attention
from mfa_tpu_torch.utils.device import resolve_device


class FlashSelfAttention(nn.Module):
    """Multi-head (optionally grouped) self-attention via the flash
    kernels.

    Args:
      features: input and output width.
      num_heads: query heads.
      num_kv_heads: KV heads (GQA); defaults to num_heads.
      head_dim: per-head dim; defaults to features // num_heads.
      causal / sliding_window / logit_soft_cap: mask config.
      dtype: the projections' dtype (bf16 recommended).
      device: where the weights live (``cuda`` unless the caller asks for
        the CPU, where the kernels' plain versions run).
    """

    def __init__(self, features: int, num_heads: int,
                 num_kv_heads: int | None = None,
                 head_dim: int | None = None, *, causal: bool = False,
                 sliding_window: int | None = None,
                 logit_soft_cap: float | None = None,
                 dtype: torch.dtype = torch.bfloat16, device="cuda"):
        super().__init__()
        self.device = resolve_device(device)
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.head_dim = head_dim or features // num_heads
        self.causal = causal
        self.sliding_window = sliding_window
        self.logit_soft_cap = logit_soft_cap
        kw = dict(bias=False, dtype=dtype, device=self.device)
        hd = self.head_dim
        self.q_proj = nn.Linear(features, num_heads * hd, **kw)
        self.k_proj = nn.Linear(features, self.num_kv_heads * hd, **kw)
        self.v_proj = nn.Linear(features, self.num_kv_heads * hd, **kw)
        self.o_proj = nn.Linear(num_heads * hd, features, **kw)

    def forward(self, x):
        b, t, _ = x.shape
        hd = self.head_dim

        def heads(proj, h):
            return proj(x).view(b, t, h, hd).transpose(1, 2)  # [B, H, T, D]

        o = flash_attention(
            heads(self.q_proj, self.num_heads),
            heads(self.k_proj, self.num_kv_heads),
            heads(self.v_proj, self.num_kv_heads),
            causal=self.causal, sliding_window=self.sliding_window,
            logit_soft_cap=self.logit_soft_cap, device=self.device)
        return self.o_proj(o.transpose(1, 2).reshape(b, t, -1))


def load_flax_params(module: FlashSelfAttention,
                     params) -> FlashSelfAttention:
    """Copy a flax ``FlashSelfAttention``'s parameters (its ``init``
    output, with or without the outer ``"params"`` key; numpy arrays or
    anything ``np.asarray`` takes) into ``module``, in place."""
    params = params.get("params", params)
    with torch.no_grad():
        for name in ("q_proj", "k_proj", "v_proj"):
            kernel = _tensor(np.asarray(params[name]["kernel"]))
            w = getattr(module, name).weight
            w.copy_(kernel.reshape(kernel.shape[0], -1).t())
        kernel = _tensor(np.asarray(params["o_proj"]["kernel"]))
        module.o_proj.weight.copy_(kernel.t())
    return module
