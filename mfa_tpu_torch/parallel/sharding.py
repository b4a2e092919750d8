"""Megatron tensor parallelism of the Llama parameters and KV caches.

Twin of ``mfa_tpu/parallel/sharding.py``, in the port's ``F.linear``
layout (projections stored [out, in]):

  wq/wk/wv, bq/bk/bv : column-parallel — dim 0 (output, heads) over "tp"
  wo                 : row-parallel    — dim 1 (input, heads) over "tp"
  w_gate/w_up        : column-parallel — dim 0 (ffn_hidden) over "tp"
  w_down             : row-parallel    — dim 1 (ffn_hidden) over "tp"
  embed, norms       : replicated; lm_head column-parallel (dim 0, vocab)
  KV cache           : batch over "dp", KV heads over "tp"

A spec is the dim cut over tp, or None for a replicated tensor. A
quantized projection's spec is the pair (weight dim, scale dim): INT8
shards its scale with a column-parallel weight and keeps it replicated
for a row-parallel one; INT4 shards column-parallel only. Its [N, K/2]
half-split bytes hold logical input rows i and i + K/2 in one byte, so a
block of packed columns is no block of the input, and row-parallel INT4
raises ``NotImplementedError``, as ``mfa_tpu`` does.

Where ``mfa_tpu`` places global arrays under ``NamedSharding``s and lets
XLA insert the collectives, :func:`shard_params` returns this rank's
tensors and ``models/llama.py`` runs the two all-reduces and the logits
all-gather (``parallel/collectives.py``). tp must divide both head
counts (Llama-3-8B's 8 KV heads take tp <= 8, Qwen2-7B's 4 take tp <= 4).
"""

from __future__ import annotations

from dataclasses import replace

from mfa_tpu_torch.kernels.quant import QuantizedWeight
from mfa_tpu_torch.models.llama import Llama
from mfa_tpu_torch.parallel import mesh as mesh_mod

_COLUMN = ("wq", "wk", "wv", "w_gate", "w_up", "bq", "bk", "bv", "lm_head")
_ROW = ("wo", "w_down")


def tp_dim(name: str) -> int | None:
    """The dim of parameter ``name`` (its last dotted part) cut over tp:
    0 column-parallel, 1 row-parallel, None replicated."""
    leaf = name.rsplit(".", 1)[-1]
    return 0 if leaf in _COLUMN else 1 if leaf in _ROW else None


def _spec(name: str, t):
    dim = tp_dim(name)
    if not isinstance(t, QuantizedWeight):
        return dim
    if t.layout == "int8":
        return (dim, 0 if dim == 0 else None)
    if dim == 1:
        raise NotImplementedError(
            f"INT4 half-split weights cannot be row-parallel-sharded "
            f"({name} under tp); use INT8 weights for tensor-parallel "
            f"serving")
    return (0, 0)


def param_specs(params: dict) -> dict:
    """Spec tree matching ``models/llama.init_params``' output."""
    out = {name: _spec(name, t) for name, t in params.items()
           if name != "layers"}
    out["layers"] = [{name: _spec(name, t) for name, t in layer.items()}
                     for layer in params["layers"]]
    return out


def _block(t, dim, n, rank):
    if dim is None or n == 1:
        return t
    size = t.shape[dim] // n
    return t.narrow(dim, rank * size, size).contiguous()


def local_params(params: dict, cfg, tp: int, rank: int) -> dict:
    """Rank ``rank``'s tensors of ``params`` under tp = ``tp`` (blocks of
    the global tensors: views where the block is contiguous, so tp = 1
    holds no second copy)."""
    for what, heads in (("n_heads", cfg.n_heads),
                        ("n_kv_heads", cfg.n_kv_heads)):
        if heads % tp:
            raise ValueError(f"tp = {tp} does not divide {what} = {heads}")
    if cfg.ffn_hidden % tp:
        raise ValueError(f"tp = {tp} does not divide ffn_hidden = "
                         f"{cfg.ffn_hidden}")
    if "lm_head" in params and cfg.vocab_size % tp:
        raise ValueError(f"tp = {tp} does not divide vocab_size = "
                         f"{cfg.vocab_size} (lm_head is column-parallel)")
    specs = param_specs(params)

    def cut(t, spec):
        if isinstance(t, QuantizedWeight):
            return QuantizedWeight(_block(t.w, spec[0], tp, rank),
                                   _block(t.scale, spec[1], tp, rank),
                                   t.layout)
        return _block(t, spec, tp, rank)

    out = {name: cut(t, specs[name]) for name, t in params.items()
           if name != "layers"}
    out["layers"] = [{name: cut(t, s[name]) for name, t in layer.items()}
                     for layer, s in zip(params["layers"], specs["layers"])]
    return out


def shard_params(params: dict, mesh, cfg) -> dict:
    """This rank's parameters under the mesh's tp (see
    :func:`local_params`); build the model with
    ``Llama(cfg, shard_params(...), tp_group=mesh.get_group("tp"))``
    (or :func:`shard_model`)."""
    return local_params(params, cfg, mesh_mod.axis_size(mesh, "tp"),
                        mesh.get_local_rank("tp"))


def shard_model(model, mesh, *, trainable: bool = False):
    """A ``Llama`` of this rank's block of ``model``'s weights that knows
    its tp group (tp = 1: the same tensors, no copy)."""
    return Llama(model.cfg, shard_params(model.params(), mesh, model.cfg),
                 device=model.device, trainable=trainable,
                 tp_group=mesh.get_group("tp"))


def cache_specs() -> dict:
    """KV cache dims: batch over dp, KV heads over tp."""
    data = {"dp": 0, "tp": 1}
    return {"k": data, "v": data, "k_scale": data, "v_scale": data,
            "lengths": {"dp": 0}}


def shard_cache(cache, mesh):
    """This rank's block of a global ``KVCache`` (a contiguous copy
    unless the block is the whole cache: the decode kernel writes it in
    place)."""
    specs = cache_specs()
    return replace(cache, **{
        name: mesh_mod.local_shard(getattr(cache, name), mesh,
                                   spec).contiguous()
        for name, spec in specs.items()})
