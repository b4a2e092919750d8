"""Llama-family model over the port's kernels (serving and training).

Port of ``mfa_tpu/models/llama.py``: an ``nn.Module`` :class:`Llama`
whose ``forward`` (prefill or training, optionally appending to KV
caches) and ``decode_step`` run over plain functions on tensors.

- Prefill and training attention is ``flash_attention(causal=True)``
  (kernel K1, differentiated by K3 and K4); decode attention is the fused
  append + attend (kernel K2).
- Projections keep ``mfa_tpu``'s names; weights are stored as
  ``nn.Linear`` does, [d_out, d_in], and the products go to
  ``torch.nn.functional.linear`` (where the JAX package used an XLA dot).
- Weight-only quantized projections (:func:`quantize_params`,
  :func:`init_params_quantized`, ``Llama.init(weight_precision=...)``)
  are ``kernels.quant.QuantizedWeight``s held as buffers, never as
  parameters: INT4 runs through kernel K8 (``int4_matmul``), INT8 in
  plain PyTorch as ``mfa_tpu`` left it to XLA (an fp32 product of the
  widened weight, times the scale, cast). Embedding and lm_head stay in
  the model's dtype.
- RMSNorm and the rotary phases in fp32; silu in fp32 then cast; logits
  rounded through the weight dtype, then fp32.
- Parameters require grad only when the model is built with
  ``trainable=True``; ``forward`` is differentiable, ``decode_step`` runs
  under ``torch.inference_mode()`` so serving never builds a graph.
- Tensor parallelism (``tp_group``, ``mfa_tpu``'s ``tp_axis``): a model
  built from ``parallel/sharding.py::shard_params`` holds this rank's
  heads and FFN columns and knows its group; each block all-reduces the
  row-parallel outputs of ``wo`` and ``w_down`` and the column-parallel
  logits are all-gathered (``parallel/collectives.py``), as
  ``mfa_tpu/models/llama.py:338-362`` psums and gathers. Head counts come
  from the projection widths. With ``tp_group=None`` no collective runs.
- Pipeline parallelism (:func:`forward_pipelined`, ``mfa_tpu``'s
  ``forward_pipelined``): the layers cut into stages by
  :func:`stack_layer_params`, each "pp" rank holding its own stage, the
  microbatches through ``parallel/pipeline.py``; embedding, final norm
  and head run replicated outside the pipeline.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from mfa_tpu_torch.kernels import quant
from mfa_tpu_torch.kernels import quant_matmul as quant_matmul_mod
from mfa_tpu_torch.ops.attention import flash_attention
from mfa_tpu_torch.ops.decode import decode_attention_append
from mfa_tpu_torch.ops.precision import OperandPrecision
from mfa_tpu_torch.parallel import collectives
from mfa_tpu_torch.parallel import mesh as mesh_mod
from mfa_tpu_torch.parallel import pipeline
from mfa_tpu_torch.serving import kv_cache as kv_cache_mod
from mfa_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_hidden: int = 14336
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    sliding_window: int | None = None   # Mistral-style SWA (all layers)
    qkv_bias: bool = False              # Qwen2-style attention bias

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @classmethod
    def llama3_8b(cls) -> "LlamaConfig":
        return cls()

    @classmethod
    def llama3_1b_proxy(cls) -> "LlamaConfig":
        """~1B-scale config for single-card experiments."""
        return cls(dim=2048, n_layers=16, n_heads=32, n_kv_heads=8,
                   ffn_hidden=8192)

    @classmethod
    def mistral_7b(cls) -> "LlamaConfig":
        return cls(vocab_size=32000, dim=4096, n_layers=32, n_heads=32,
                   n_kv_heads=8, ffn_hidden=14336, rope_theta=10000.0,
                   sliding_window=4096)

    @classmethod
    def qwen2_7b(cls) -> "LlamaConfig":
        return cls(vocab_size=152064, dim=3584, n_layers=28, n_heads=28,
                   n_kv_heads=4, ffn_hidden=18944, rope_theta=1000000.0,
                   norm_eps=1e-6, qkv_bias=True)

    @classmethod
    def tiny(cls) -> "LlamaConfig":
        """CPU-test scale."""
        return cls(vocab_size=256, dim=128, n_layers=2, n_heads=4,
                   n_kv_heads=2, ffn_hidden=256, rope_theta=10000.0)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

_QUANTIZABLE = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
# OperandPrecision of the weights → QuantizedWeight layout. INT4 is
# signed, as mfa_tpu's quantize_params packs it.
_WEIGHT_LAYOUTS = {OperandPrecision.INT8: "int8",
                   OperandPrecision.INT4: "int4"}


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16, *,
                weight_precision: OperandPrecision | None = None) -> dict:
    """Random parameters on the generator's device, named as in
    ``mfa_tpu`` with projection weights as [d_out, d_in]: N(0, 1/d_in)
    rounded to ``dtype``, the embedding N(0, 1) * 0.02, norms ones (fp32).
    With ``weight_precision`` (INT8 or INT4) each projection is quantized
    as soon as it is drawn (see :func:`init_params_quantized`)."""
    dev = generator.device
    layout = None
    if weight_precision is not None:
        layout = _weight_layout(weight_precision)

    def dense(d_in, d_out, quantize=True):
        w = torch.randn((d_out, d_in), generator=generator, device=dev)
        w = (w / math.sqrt(d_in)).to(dtype)
        if layout is None or not quantize:
            return w
        return quant.quantize_weight(w, layout)

    def ones(n):
        return torch.ones((n,), dtype=torch.float32, device=dev)

    hd = cfg.head_dim
    params = {
        "embed": torch.randn((cfg.vocab_size, cfg.dim), generator=generator,
                             device=dev).to(dtype) * 0.02,
        "final_norm": ones(cfg.dim),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        layer = {
            "attn_norm": ones(cfg.dim),
            "wq": dense(cfg.dim, cfg.n_heads * hd),
            "wk": dense(cfg.dim, cfg.n_kv_heads * hd),
            "wv": dense(cfg.dim, cfg.n_kv_heads * hd),
            "wo": dense(cfg.n_heads * hd, cfg.dim),
            "mlp_norm": ones(cfg.dim),
            "w_gate": dense(cfg.dim, cfg.ffn_hidden),
            "w_up": dense(cfg.dim, cfg.ffn_hidden),
            "w_down": dense(cfg.ffn_hidden, cfg.dim),
        }
        if cfg.qkv_bias:
            for name, n in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                            ("bv", cfg.n_kv_heads)):
                layer[name] = torch.zeros((n * hd,), dtype=torch.float32,
                                          device=dev)
        params["layers"].append(layer)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(cfg.dim, cfg.vocab_size, quantize=False)
    return params


def _weight_layout(precision: OperandPrecision) -> str:
    if precision not in _WEIGHT_LAYOUTS:
        raise ValueError(f"unsupported weight precision {precision}")
    return _WEIGHT_LAYOUTS[precision]


def init_params_quantized(cfg: LlamaConfig, generator: torch.Generator,
                          precision: OperandPrecision,
                          dtype: torch.dtype = torch.bfloat16) -> dict:
    """Memory-lean random init: each projection is drawn (rounded to
    ``dtype``, as :func:`init_params` stores it) and quantized at once, so
    at most one full-precision projection exists at a time. The draws
    come in :func:`init_params`' order, so the result equals
    ``quantize_params(init_params(cfg, generator, dtype), precision)``
    bit for bit from the same generator state."""
    return init_params(cfg, generator, dtype, weight_precision=precision)


def quantize_params(params: dict, precision: OperandPrecision) -> dict:
    """Weight-only quantization of every projection (INT8 or signed INT4,
    per-output-channel scales over the input axis) with ``mfa_tpu``'s
    eager bits; the other entries (embedding, norms, lm_head) are kept as
    they are. ``params`` is a parameter dict as :func:`init_params` gives
    it or :meth:`Llama.params` returns it."""
    layout = _weight_layout(precision)
    out = {name: t for name, t in params.items() if name != "layers"}
    out["layers"] = []
    for layer in params["layers"]:
        nl = dict(layer)
        for name in _QUANTIZABLE:
            nl[name] = quant.quantize_weight(layer[name], layout)
        out["layers"].append(nl)
    return out


class LlamaLayer(nn.Module):
    """One block's parameters (attention + MLP, pre-norm). A quantized
    projection is held as two buffers, ``<name>_q`` and ``<name>_scale``,
    and read back as a ``QuantizedWeight`` under its own name."""

    def __init__(self, tensors: dict, trainable: bool = False):
        super().__init__()
        self._layouts = {}
        for name, t in tensors.items():
            if isinstance(t, quant.QuantizedWeight):
                if trainable:
                    raise ValueError(f"{name} is quantized: a model with "
                                     "quantized weights cannot train")
                self.register_buffer(name + "_q", t.w)
                self.register_buffer(name + "_scale", t.scale)
                self._layouts[name] = t.layout
            else:
                self.register_parameter(
                    name, nn.Parameter(t, requires_grad=trainable))

    def __getattr__(self, name: str):
        layouts = self.__dict__.get("_layouts", {})
        if name in layouts:
            return quant.QuantizedWeight(getattr(self, name + "_q"),
                                         getattr(self, name + "_scale"),
                                         layouts[name])
        return super().__getattr__(name)

    def has(self, name: str) -> bool:
        return name in self._parameters or name in self._layouts


class Llama(nn.Module):
    """Llama over the port's kernels; ``forward`` and ``decode_step``.
    ``trainable`` makes every parameter require grad (off by default);
    ``tp_group`` is the tensor-parallel group of a model whose ``params``
    are one rank's shard (``parallel/sharding.py``)."""

    def __init__(self, cfg: LlamaConfig, params: dict, *, device="cuda",
                 trainable: bool = False, tp_group=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.device = dev
        self.tp_group = tp_group

        def p(t):
            return nn.Parameter(t.to(dev), requires_grad=trainable)

        self.embed = p(params["embed"])
        self.final_norm = p(params["final_norm"])
        self.layers = nn.ModuleList(
            LlamaLayer({n: t.to(dev) for n, t in layer.items()}, trainable)
            for layer in params["layers"])
        self.lm_head = p(params["lm_head"]) if "lm_head" in params else None

    @classmethod
    def init(cls, cfg: LlamaConfig, *, generator: torch.Generator,
             dtype: torch.dtype = torch.bfloat16, device="cuda",
             trainable: bool = False,
             weight_precision: OperandPrecision | None = None) -> "Llama":
        """Random weights from ``generator`` (which must live on
        ``device``); ``weight_precision`` INT8 or INT4 quantizes every
        projection as it is drawn (:func:`init_params_quantized`)."""
        dev = resolve_device(device)
        if generator.device.type != dev.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{dev}")
        if trainable and weight_precision is not None:
            raise ValueError("a model with quantized weights cannot train")
        return cls(cfg, init_params(cfg, generator, dtype,
                                    weight_precision=weight_precision),
                   device=dev, trainable=trainable)

    def params(self) -> dict:
        """The weights as a parameter dict (the model's own tensors, not
        copies; quantized projections as ``QuantizedWeight``)."""
        out = {"embed": self.embed.data, "final_norm": self.final_norm.data,
               "layers": []}
        if self.lm_head is not None:
            out["lm_head"] = self.lm_head.data
        for layer in self.layers:
            names = list(layer._parameters) + list(layer._layouts)
            out["layers"].append({n: (getattr(layer, n) if n in layer._layouts
                                      else getattr(layer, n).data)
                                  for n in names})
        return out

    def quantized(self, precision: OperandPrecision) -> "Llama":
        """A serving copy with every projection quantized (INT8 or INT4);
        embedding, norms and lm_head are this model's own tensors."""
        return Llama(self.cfg, quantize_params(self.params(), precision),
                     device=self.device)

    def make_caches(self, batch: int, max_len: int,
                    precision: OperandPrecision = OperandPrecision.BF16):
        """Caches of this model's own KV heads (a tp shard's share)."""
        wk = self.layers[0].wk
        w = wk.w if isinstance(wk, quant.QuantizedWeight) else wk
        return [kv_cache_mod.create(batch, w.shape[0] // self.cfg.head_dim,
                                    max_len, self.cfg.head_dim, precision,
                                    device=self.device)
                for _ in range(self.cfg.n_layers)]

    def forward(self, tokens, *, positions=None, caches=None):
        return forward(self, tokens, positions=positions, caches=caches,
                       tp_group=self.tp_group)

    @torch.inference_mode()
    def decode_step(self, tokens, caches):
        return decode_step(self, tokens, caches, tp_group=self.tp_group)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def _matmul(x, w):
    """x @ w.T in x's dtype (fp32 accumulation), with transparent
    weight-only dequantization: INT4 through kernel K8 (looked up in its
    module at each call, so a caller may swap in the plain version), INT8
    as ``mfa_tpu`` runs it, an fp32 product of the widened weight times
    the per-channel scale, cast once."""
    if isinstance(w, quant.QuantizedWeight):
        if w.layout == "int8":
            y = F.linear(x.float(), w.w.float())
            return (y * w.scale).to(x.dtype)
        return quant_matmul_mod.int4_matmul(x, w.w, w.scale, layout=w.layout,
                                            device=x.device)
    return F.linear(x, w)


def rms_norm(x, weight, eps: float):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight).to(x.dtype)


def rope_frequencies(cfg: LlamaConfig, device) -> torch.Tensor:
    hd = cfg.head_dim
    expo = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / (cfg.rope_theta ** expo)


def apply_rope(x, positions, inv_freq):
    """x: [B, H, T, D]; positions: [B, T] (absolute). Half-split rotation
    with fp32 phases."""
    angles = positions[:, None, :, None].float() * inv_freq
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _project_qkv(layer: LlamaLayer, x, cfg: LlamaConfig):
    b, t, _ = x.shape
    hd = cfg.head_dim

    def proj(wname, bname):
        y = _matmul(x, getattr(layer, wname))
        if layer.has(bname):                 # Qwen2-style attention bias
            y = (y.float() + getattr(layer, bname).float()).to(x.dtype)
        return y.reshape(b, t, -1, hd).transpose(1, 2)   # [B, H, T, D]

    return proj("wq", "bq"), proj("wk", "bk"), proj("wv", "bv")


def _mlp(layer: LlamaLayer, x):
    gate = _matmul(x, layer.w_gate)
    up = _matmul(x, layer.w_up)
    return _matmul(F.silu(gate.float()).to(x.dtype) * up, layer.w_down)


def _norm_in(x, weight, cfg: LlamaConfig, tp_group):
    """RMSNorm, then the input of column-parallel projections (identity
    forward; under tp the gradient is all-reduced)."""
    return collectives.copy_to_tp(rms_norm(x, weight, cfg.norm_eps),
                                  tp_group)


def _layer_apply(layer: LlamaLayer, x, positions, inv_freq,
                 cfg: LlamaConfig, device, return_kv: bool = False,
                 tp_group=None):
    """One transformer block; ``return_kv`` also yields the roped K and
    the raw V for prefill cache appends. Under ``tp_group`` the outputs
    of ``wo`` and ``w_down`` (row-parallel partial sums) are all-reduced
    and the activations stay replicated."""
    b, t, _ = x.shape
    h = _norm_in(x, layer.attn_norm, cfg, tp_group)
    q, k, v = _project_qkv(layer, h, cfg)
    q = apply_rope(q, positions, inv_freq)
    k = apply_rope(k, positions, inv_freq)
    o = flash_attention(q, k, v, causal=True,
                        sliding_window=cfg.sliding_window, device=device)
    att = _matmul(o.transpose(1, 2).reshape(b, t, -1), layer.wo)
    x = x + collectives.reduce_from_tp(att, tp_group)
    mlp = _mlp(layer, _norm_in(x, layer.mlp_norm, cfg, tp_group))
    x = x + collectives.reduce_from_tp(mlp, tp_group)
    if return_kv:
        return x, (k, v)
    return x


def _lm_head(model: Llama, x, tp_group=None):
    """Final norm + fp32 logits. Under ``tp_group`` lm_head is
    column-parallel and the vocab shards are all-gathered; tied
    embeddings are replicated (full logits, no gather)."""
    if model.lm_head is None:
        x = rms_norm(x, model.final_norm, model.cfg.norm_eps)
        return torch.matmul(x.float(), model.embed.float().t())
    x = _norm_in(x, model.final_norm, model.cfg, tp_group)
    return collectives.gather_from_tp(_matmul(x, model.lm_head).float(),
                                      tp_group)


def forward(model: Llama, tokens, *, positions=None, caches=None,
            tp_group=None):
    """[B, T] tokens → logits [B, T, vocab]. With ``caches`` (one KVCache
    per layer): prefill mode, each layer's K/V are appended to its cache
    and (logits, caches) is returned. ``tp_group``: the tensor-parallel
    group of a sharded model (``Llama.forward`` passes the model's)."""
    cfg = model.cfg
    b, t = tokens.shape
    dev = model.device
    if positions is None:
        ar = torch.arange(t, device=dev)[None, :]
        positions = (caches[0].lengths.long()[:, None] + ar
                     if caches is not None else ar.expand(b, t))
    inv_freq = rope_frequencies(cfg, dev)
    x = model.embed[tokens]
    for li, layer in enumerate(model.layers):
        if caches is not None:
            x, (k, v) = _layer_apply(layer, x, positions, inv_freq, cfg, dev,
                                     return_kv=True, tp_group=tp_group)
            kv_cache_mod.update(caches[li], k, v)
        else:
            x = _layer_apply(layer, x, positions, inv_freq, cfg, dev,
                             tp_group=tp_group)
    logits = _lm_head(model, x, tp_group)
    if caches is not None:
        return logits, caches
    return logits


def decode_step(model: Llama, tokens, caches, *, tp_group=None):
    """One decode step: tokens [B] (the latest token per sequence) →
    (logits [B, vocab], caches), appending to every layer's cache. Under
    ``tp_group`` the caches hold this rank's KV heads
    (``parallel/sharding.py::shard_cache``)."""
    cfg = model.cfg
    dev = model.device
    b = tokens.shape[0]
    positions = caches[0].lengths.long()[:, None]          # [B, 1], a copy
    inv_freq = rope_frequencies(cfg, dev)
    x = model.embed[tokens][:, None, :]                    # [B, 1, dim]
    for li, layer in enumerate(model.layers):
        h = _norm_in(x, layer.attn_norm, cfg, tp_group)
        q, k, v = _project_qkv(layer, h, cfg)              # [B, H, 1, D]
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
        o, _ = decode_attention_append(
            q[:, :, 0, :], k[:, :, 0, :], v[:, :, 0, :], caches[li],
            sliding_window=cfg.sliding_window, device=dev)
        att = _matmul(o.reshape(b, 1, -1), layer.wo)
        x = x + collectives.reduce_from_tp(att, tp_group)
        mlp = _mlp(layer, _norm_in(x, layer.mlp_norm, cfg, tp_group))
        x = x + collectives.reduce_from_tp(mlp, tp_group)
    return _lm_head(model, x[:, 0], tp_group), caches


def stack_layer_params(params: dict, n_stages: int) -> dict:
    """The layers of a parameter dict (as :meth:`Llama.params` gives it)
    cut into ``n_stages`` equal stages, each stage's layers stacked along a
    leading axis and the stages stacked: every tensor gains leading dims
    [n_stages, layers_per_stage] (``parallel.pipeline.shard_stacked``
    takes a rank's stage). Quantized weights stack too."""
    layers = params["layers"]
    if len(layers) % n_stages:
        raise ValueError(
            f"{len(layers)} layers not divisible into {n_stages} stages")
    per = len(layers) // n_stages
    return pipeline.stack_stages([
        pipeline.stack_stages(layers[s * per:(s + 1) * per])
        for s in range(n_stages)])


def _stage_layers(stacked: dict) -> list:
    """The layers of one stage's stacked tensors [per, ...], as views."""
    per = next(iter(stacked.values()))
    per = (per.w if isinstance(per, quant.QuantizedWeight) else per).shape[0]
    return [LlamaLayer(pipeline.tree_map(lambda a: a[i], stacked))
            for i in range(per)]


def _pipelined(model: Llama, tokens, run):
    """Embedding, the layer stack through ``run(stage_fn, x, extra)``,
    final norm and head (fp32 logits)."""
    cfg, dev = model.cfg, model.device
    positions = torch.arange(tokens.shape[1], device=dev)[None, :]
    inv_freq = rope_frequencies(cfg, dev)

    def stage_fn(layers, x, positions, inv_freq):
        for layer in layers:
            x = _layer_apply(layer, x, positions, inv_freq, cfg, dev)
        return x

    x = run(stage_fn, model.embed[tokens], (positions, inv_freq))
    return _lm_head(model, x)


def forward_pipelined(model: Llama, tokens, *, mesh, num_microbatches: int,
                      stacked_layers=None):
    """Logits [B, T, vocab] with the layer stack pipelined over the mesh's
    "pp" ranks (GPipe microbatches over the batch;
    ``parallel/pipeline.py``), on every rank. ``stacked_layers``: this
    rank's stage (``shard_stacked(stack_layer_params(...), mesh)``), so
    ``model`` need hold only embedding, final norm and head; without it
    the stage is cut from ``model``'s own layers."""
    if stacked_layers is None:
        stacked_layers = pipeline.shard_stacked(stack_layer_params(
            model.params(), mesh_mod.axis_size(mesh, "pp")), mesh)
    layers = _stage_layers(stacked_layers)
    return _pipelined(model, tokens, lambda fn, x, extra: (
        pipeline.pipeline_apply(fn, layers, x, mesh=mesh,
                                num_microbatches=num_microbatches,
                                extra=extra)))


def forward_pipeline_schedule(model: Llama, tokens, *, n_stages: int,
                              num_microbatches: int):
    """:func:`forward_pipelined`'s arithmetic in one process:
    ``pipeline_schedule`` over ``n_stages`` stages of ``model``'s own
    layers (no copy)."""
    layers = list(model.layers)
    if len(layers) % n_stages:
        raise ValueError(
            f"{len(layers)} layers not divisible into {n_stages} stages")
    per = len(layers) // n_stages
    stages = [layers[s * per:(s + 1) * per] for s in range(n_stages)]
    return _pipelined(model, tokens, lambda fn, x, extra: (
        pipeline.pipeline_schedule(fn, stages, x,
                                   num_microbatches=num_microbatches,
                                   extra=extra)))


def make_caches(cfg: LlamaConfig, batch: int, max_len: int,
                precision: OperandPrecision = OperandPrecision.BF16, *,
                device="cuda"):
    return [kv_cache_mod.create(batch, cfg.n_kv_heads, max_len, cfg.head_dim,
                                precision, device=device)
            for _ in range(cfg.n_layers)]
