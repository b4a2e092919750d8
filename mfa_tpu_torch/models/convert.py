"""Hugging Face Llama/Mistral/Qwen2 checkpoint conversion.

Port of ``mfa_tpu/models/convert.py``: maps a Llama-architecture state
dict with Hugging Face's key names onto the port's :class:`Llama`, so
released weights load directly. Imports no ``transformers``: the config
is read by attribute, so a ``transformers`` config object and a
``types.SimpleNamespace`` of a ``config.json``'s fields both work.

Differences from ``mfa_tpu``:

- Hugging Face stores projections as [out, in], which is ``nn.Linear``'s
  layout and the port's, so nothing is transposed (``mfa_tpu`` transposes
  to its [in, out]).
- Untied embeddings without an ``lm_head.weight`` take the embedding
  itself as the head (``mfa_tpu`` takes its transpose, which is the same
  matrix in its layout).
- ``use_sliding_window: false`` (Qwen2) means no window whatever
  ``sliding_window`` says: ``transformers.Qwen2Config`` sets the window to
  None in that case and a plain namespace keeps the number, so the flag
  is read here and both give None.
"""

from __future__ import annotations

import torch

from mfa_tpu_torch.models.from_jax import _tensor
from mfa_tpu_torch.models.llama import Llama, LlamaConfig


def config_from_hf(hf_config) -> LlamaConfig:
    """LlamaConfig from a Hugging Face Llama/Mistral/Qwen2 config (object
    or namespace of its ``config.json`` fields)."""
    window = getattr(hf_config, "sliding_window", None)
    if not getattr(hf_config, "use_sliding_window", True):
        window = None
    return LlamaConfig(
        vocab_size=hf_config.vocab_size,
        dim=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=getattr(hf_config, "num_key_value_heads",
                           hf_config.num_attention_heads),
        ffn_hidden=hf_config.intermediate_size,
        rope_theta=getattr(hf_config, "rope_theta", 10000.0),
        norm_eps=hf_config.rms_norm_eps,
        tie_embeddings=getattr(hf_config, "tie_word_embeddings", False),
        sliding_window=window,
        # Llama exposes attention_bias; Qwen2 always uses QKV bias.
        qkv_bias=bool(getattr(hf_config, "attention_bias", False)
                      or getattr(hf_config, "model_type", "") == "qwen2"),
    )


def params_from_hf(state_dict, cfg: LlamaConfig,
                   dtype: torch.dtype = torch.bfloat16, *,
                   device="cuda", trainable: bool = False) -> Llama:
    """A Hugging Face state dict (torch tensors or numpy arrays, numpy's
    bfloat16 included) → :class:`Llama` on ``device``: embedding,
    projections and lm_head in ``dtype``, norms and QKV biases in fp32.
    Tensors already on ``device`` in the right dtype are used as they are,
    not copied. RoPE needs no permutation: ``models/llama.apply_rope``
    pairs x[i] with x[i + D/2] as ``transformers`` does. ``trainable``
    makes every parameter require grad, as :meth:`Llama.init`'s does (the
    training path of ``mfa_tpu``: ``config_from_hf``, then
    ``training.train_step``)."""
    def get(name, dt):
        t = state_dict[name]
        t = t.detach() if isinstance(t, torch.Tensor) else _tensor(t)
        return t.to(dtype=dt)

    params = {
        "embed": get("model.embed_tokens.weight", dtype),
        "final_norm": get("model.norm.weight", torch.float32),
        "layers": [],
    }
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        layer = {
            "attn_norm": get(p + "input_layernorm.weight", torch.float32),
            "wq": get(p + "self_attn.q_proj.weight", dtype),
            "wk": get(p + "self_attn.k_proj.weight", dtype),
            "wv": get(p + "self_attn.v_proj.weight", dtype),
            "wo": get(p + "self_attn.o_proj.weight", dtype),
            "mlp_norm": get(p + "post_attention_layernorm.weight",
                            torch.float32),
            "w_gate": get(p + "mlp.gate_proj.weight", dtype),
            "w_up": get(p + "mlp.up_proj.weight", dtype),
            "w_down": get(p + "mlp.down_proj.weight", dtype),
        }
        if cfg.qkv_bias:
            for ours, theirs in (("bq", "q_proj"), ("bk", "k_proj"),
                                 ("bv", "v_proj")):
                layer[ours] = get(p + f"self_attn.{theirs}.bias",
                                  torch.float32)
        params["layers"].append(layer)
    if not cfg.tie_embeddings:
        if "lm_head.weight" in state_dict:
            params["lm_head"] = get("lm_head.weight", dtype)
        else:
            params["lm_head"] = params["embed"].clone()
    return Llama(cfg, params, device=device, trainable=trainable)
