"""Random weights from the seed, made on the device in a few large calls.

Both the program and the plain reference are handed these tensors, under
the names below (the port's ``Llama(cfg, params)`` takes the same names).
Every block's bf16 matrices are one draw, cut into views and scaled to
N(0, 1/d_in); QKV biases (where the config has them) are N(0, 0.25) in
bf16, the norms' weights 1 + N(0, 0.01) in fp32. The embedding is N(0, 1)
and the output head N(0, 1/dim), in bf16.
"""

from __future__ import annotations

import math

import torch

from benchmark.arith import Shape


def _layout(s: Shape):
    qd, kd = s.heads * s.head_dim, s.kv_heads * s.head_dim
    mats = [("wq", qd, s.dim), ("wk", kd, s.dim), ("wv", kd, s.dim),
            ("wo", s.dim, qd), ("w_gate", s.ffn, s.dim),
            ("w_up", s.ffn, s.dim), ("w_down", s.dim, s.ffn)]
    biases = [("bq", qd), ("bk", kd), ("bv", kd)] if s.qkv_bias else []
    return mats, biases


def make_params(s: Shape, seed: int, device) -> dict:
    g = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    bf16 = torch.bfloat16
    mats, biases = _layout(s)
    per_layer = (sum(o * i for _, o, i in mats)
                 + sum(n for _, n in biases))
    params = {"embed": torch.randn((s.vocab, s.dim), generator=g,
                                   device=device, dtype=bf16),
              "layers": []}
    for _ in range(s.layers):
        flat = torch.randn(per_layer, generator=g, device=device, dtype=bf16)
        norms = torch.randn(2 * s.dim, generator=g, device=device)
        norms.mul_(0.1).add_(1.0)
        layer, off = {}, 0
        for name, d_out, d_in in mats:
            n = d_out * d_in
            layer[name] = flat[off:off + n].view(d_out, d_in).mul_(
                1.0 / math.sqrt(d_in))
            off += n
        for name, n in biases:
            layer[name] = flat[off:off + n].mul_(0.5)
            off += n
        layer["attn_norm"], layer["mlp_norm"] = norms[:s.dim], norms[s.dim:]
        params["layers"].append(layer)
    fin = torch.randn(s.dim, generator=g, device=device)
    params["final_norm"] = fin.mul_(0.1).add_(1.0)
    if not s.tied:
        params["lm_head"] = torch.randn(
            (s.vocab, s.dim), generator=g, device=device, dtype=bf16).mul_(
                1.0 / math.sqrt(s.dim))
    return params
