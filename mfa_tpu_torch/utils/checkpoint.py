"""Checkpoint / resume: parameters, KV caches, training state.

Port of ``mfa_tpu/utils/checkpoint.py``. A checkpoint is a directory
with two files:

- ``tensors.pt``: one flat dict from leaf path to tensor, written by
  ``torch.save`` and read back with ``weights_only=True``, so nothing is
  unpickled but tensors. Every dtype keeps its bits (bf16, fp32, int8,
  uint8, FP8-e4m3 and FP8-e5m2 included); numpy has no bf16 or FP8, so
  the tensors are never routed through it.
- ``meta.json``: the format, each leaf's path, kind, dtype and shape,
  Python numbers (a training state's step), and the caller's metadata.

Leaves are keyed by their path string, written as ``jax.tree_util.keystr``
writes it (``['layers'][0]['wq'].w``), and no class is pickled: the
structure, a ``QuantizedWeight``'s layout, a cache's precision and the
optimizer's settings come from the template that :func:`load` is given.

What a tree may hold: dicts, lists and tuples; dataclasses (``KVCache``,
``PagePool``, ``QuantizedWeight``, ``training.TrainState``), whose fields
are its children; an ``nn.Module`` (a ``Llama``), whose parameters and
buffers are its leaves; a ``PagedKVCache`` (its pool, page tables,
lengths and free list). Leaves are tensors, numpy arrays and the Python
numbers of mutable containers (a frozen dataclass holds settings, which
come from the template). A tensor reached twice (a ``TrainState`` holds
its model's parameters twice) is stored once, under its first path.

Unlike ``mfa_tpu``'s functional ``load``, :func:`load` writes the saved
values into the template's own tensors, on the template's devices, and
returns the template: a ``TrainState`` resumes with its model's
parameters, and a model built for serving reads the restored weights. A
numpy leaf is written into the template's own array, wherever it sits
(a dict, a list, a dataclass). A leaf of another dtype or shape than the
template's is refused, never cast. The one leaf replaced rather than
written into is a ``PagedKVCache``'s free list, whose length changes by
design.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch
from torch import nn

from mfa_tpu_torch.serving.paged_kv_cache import PagedKVCache

FORMAT = "mfa-torch-ckpt-v1"


class _Leaf:
    """One leaf: its value in the tree and how a loaded value goes back."""

    def __init__(self, key: str, value, restore):
        self.key, self.value, self.restore = key, value, restore


def _copy_tensor(key: str, dst: torch.Tensor):
    def restore(src: torch.Tensor):
        if src.dtype != dst.dtype or src.shape != dst.shape:
            raise ValueError(
                f"leaf {key!r}: checkpoint has {src.dtype} {tuple(src.shape)}"
                f", the template {dst.dtype} {tuple(dst.shape)}")
        with torch.inference_mode():     # also writes inference tensors
            dst.copy_(src)
    return restore


def _copy_array(key: str, dst: np.ndarray):
    def restore(src: torch.Tensor):
        src = src.numpy()
        if src.dtype != dst.dtype or src.shape != dst.shape:
            raise ValueError(
                f"leaf {key!r}: checkpoint has {src.dtype} {src.shape}, the "
                f"template {dst.dtype} {dst.shape}")
        np.copyto(dst, src)
    return restore


class _Replace:
    """The restore of a leaf that the loaded value replaces (the paged
    cache's free list) instead of being written into."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, value):
        self.fn(value)


def _setter(parent, name):
    if isinstance(parent, (dict, list)):
        return lambda v: parent.__setitem__(name, v)
    return lambda v: setattr(parent, name, v)


def _children(node):
    """(key suffix, child, setter or None) of a container node."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", v, _setter(node, k)) for k, v in node.items()]
    if isinstance(node, (list, tuple)):
        mutable = isinstance(node, list)
        return [(f"[{i}]", v, _setter(node, i) if mutable else None)
                for i, v in enumerate(node)]
    if isinstance(node, nn.Module):
        return [(f".{n}", t, None) for n, t in (*node.named_parameters(),
                                                 *node.named_buffers())]
    if isinstance(node, PagedKVCache):
        def set_free(ids):
            node._free = [int(i) for i in ids]
        return [(".pool", node.pool, None),
                (".page_tables", node.page_tables, None),
                (".lengths", node.lengths, None),
                # The free list's length changes, so it is replaced.
                (".free", np.asarray(node._free, dtype=np.int32),
                 _Replace(set_free))]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        frozen = node.__dataclass_params__.frozen
        return [(f".{f.name}", getattr(node, f.name),
                 None if frozen else _setter(node, f.name))
                for f in dataclasses.fields(node)]
    return None


def _leaves(tree) -> list[_Leaf]:
    out, seen = [], set()

    def walk(node, key, setter):
        if isinstance(node, torch.Tensor):
            if id(node) not in seen:          # a tensor reached twice
                seen.add(id(node))
                out.append(_Leaf(key, node, _copy_tensor(key, node)))
        elif isinstance(node, np.ndarray):
            out.append(_Leaf(key, node, setter if isinstance(setter, _Replace)
                             else _copy_array(key, node)))
        elif isinstance(node, (int, float)) and not isinstance(node, bool):
            if setter is not None:
                out.append(_Leaf(key, node, setter))
        else:
            for suffix, child, child_setter in _children(node) or ():
                walk(child, key + suffix, child_setter)

    walk(tree, "", None)
    keys = [leaf.key for leaf in out]
    dup = sorted(k for k in set(keys) if keys.count(k) > 1)
    if dup:
        raise ValueError(f"duplicate leaf paths: {dup}")
    return out


def save(path, tree, *, metadata: dict | None = None) -> None:
    """Save a tree (parameters, caches, training state) into the
    directory ``path``. Tensors are copied to host memory first."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    tensors, entries, scalars = {}, [], {}
    for leaf in _leaves(tree):
        v = leaf.value
        if isinstance(v, torch.Tensor):
            kind, t = "tensor", v.detach().to("cpu", copy=True)
        elif isinstance(v, np.ndarray):
            kind, t = "numpy", torch.from_numpy(np.array(v, copy=True))
        else:
            kind, t = "number", None
            scalars[leaf.key] = v
        if t is not None:
            tensors[leaf.key] = t
        entries.append({"path": leaf.key, "kind": kind,
                        "dtype": str(t.dtype) if t is not None
                        else type(v).__name__,
                        "shape": list(t.shape) if t is not None else []})
    torch.save(tensors, path / "tensors.pt")
    with open(path / "meta.json", "w") as f:
        json.dump({"format": FORMAT, "num_leaves": len(entries),
                   "leaves": entries, "numbers": scalars,
                   "metadata": metadata or {}}, f)


def load(path, like, *, strict: bool = True):
    """Load a checkpoint written by :func:`save` into ``like``, a template
    tree of the same structure (e.g. a fresh model's ``params()``, caches
    from ``make_caches``, a new ``TrainState``). Each saved leaf is written
    into the template's own tensor, on its device. Returns
    (like, metadata). With ``strict=False`` a path the checkpoint lacks
    keeps the template's value."""
    path = Path(path)
    with open(path / "meta.json") as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"unrecognized checkpoint format at {path} "
                         f"({meta.get('format')!r}; expected {FORMAT!r})")
    tensors = torch.load(path / "tensors.pt", map_location="cpu",
                         weights_only=True, mmap=True)
    numbers = meta["numbers"]
    for leaf in _leaves(like):
        if leaf.key in tensors:
            leaf.restore(tensors[leaf.key])
        elif leaf.key in numbers:
            leaf.restore(numbers[leaf.key])
        elif strict:
            raise KeyError(f"checkpoint at {path} has no leaf {leaf.key!r}")
    return like, meta["metadata"]
