"""Checkpoints of the port (utils/checkpoint.py): round trips of fp32 and
bf16 parameters, INT8, INT4 and biased INT4 weights, INT8 and FP8 KV
caches and a paged cache, every dtype's bits kept; a resumed TrainState
takes the same next step as an uninterrupted run; partial restores; the
refusals. The leaf paths are mfa_tpu's (jax.tree_util.keystr) for the
same trees."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.models import llama as jax_llama
from mfa_tpu.ops.precision import OperandPrecision as JPrec
from mfa_tpu_torch.kernels import quant
from mfa_tpu_torch.models import llama, training
from mfa_tpu_torch.ops.precision import OperandPrecision
from mfa_tpu_torch.serving.paged_kv_cache import PagedKVCache
from mfa_tpu_torch.utils import checkpoint

CFG = llama.LlamaConfig.tiny()


def _model(seed, dtype=torch.float32, **kw):
    return llama.Llama.init(CFG, generator=torch.Generator().manual_seed(seed),
                            dtype=dtype, device="cpu", **kw)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The raw bytes of a tensor, for exact comparison (NaN and -0 too)."""
    return t.detach().contiguous().view(torch.uint8)


def _assert_same_tree(a, b):
    la, lb = checkpoint._leaves(a), checkpoint._leaves(b)
    assert [x.key for x in la] == [x.key for x in lb]
    for x, y in zip(la, lb):
        if isinstance(x.value, torch.Tensor):
            assert x.value.dtype == y.value.dtype, x.key
            assert torch.equal(_bits(x.value), _bits(y.value)), x.key
        else:
            np.testing.assert_array_equal(x.value, y.value, err_msg=x.key)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_params_roundtrip(tmp_path, dtype):
    model = _model(1, dtype)
    checkpoint.save(tmp_path / "p", model.params(), metadata={"step": 7})
    fresh = _model(99, dtype)
    restored, meta = checkpoint.load(tmp_path / "p", fresh.params())
    assert meta == {"step": 7}
    _assert_same_tree(restored, model.params())
    # The fresh model's own tensors now hold the weights.
    tokens = torch.tensor([[1, 2, 3, 4]])
    assert torch.equal(fresh(tokens), model(tokens))


@pytest.mark.parametrize("precision", [OperandPrecision.INT8,
                                       OperandPrecision.INT4])
def test_quantized_params_roundtrip(tmp_path, precision):
    model = _model(2, weight_precision=precision)
    checkpoint.save(tmp_path / "q", model.params(), metadata={"kind": "q"})
    fresh = _model(5, weight_precision=precision)
    restored, meta = checkpoint.load(tmp_path / "q", fresh.params())
    assert meta["kind"] == "q"
    w = restored["layers"][0]["wq"]
    assert isinstance(w, quant.QuantizedWeight)
    assert w.layout == llama._WEIGHT_LAYOUTS[precision]
    _assert_same_tree(restored, model.params())
    tokens = torch.tensor([[5, 6, 7]])
    assert torch.equal(fresh(tokens), model(tokens))


def test_biased_int4_weights_roundtrip(tmp_path):
    """The layout (int8 or uint8 bytes) comes from the template."""
    gen = torch.Generator().manual_seed(3)
    tree = {name: quant.quantize_weight(torch.randn(48, 64, generator=gen),
                                        name)
            for name in ("int4", "int4_biased", "int8")}
    checkpoint.save(tmp_path / "w", tree)
    like = {name: quant.quantize_weight(torch.zeros(48, 64), name)
            for name in tree}
    restored, _ = checkpoint.load(tmp_path / "w", like)
    assert restored["int4_biased"].w.dtype == torch.uint8
    assert restored["int4"].w.dtype == torch.int8
    _assert_same_tree(restored, tree)


@pytest.mark.parametrize("precision", [OperandPrecision.BF16,
                                       OperandPrecision.INT8,
                                       OperandPrecision.FP8_E4M3,
                                       OperandPrecision.FP8_E5M2])
def test_kv_cache_roundtrip(tmp_path, precision):
    model = _model(4)
    caches = model.make_caches(2, 128, precision)
    with torch.inference_mode():
        model(torch.tensor([[1, 2, 3, 4, 5], [6, 7, 8, 9, 10]]),
              caches=caches)
    checkpoint.save(tmp_path / "kv", caches)
    like = model.make_caches(2, 128, precision)
    restored, _ = checkpoint.load(tmp_path / "kv", like)
    assert restored[0].precision is precision
    assert restored[0].k.dtype == precision.dtype
    assert restored[1].lengths.tolist() == [5, 5]
    _assert_same_tree(restored, caches)


def test_paged_cache_roundtrip(tmp_path):
    """Pool, page tables, lengths and the free list (its order too)."""
    gen = torch.Generator().manual_seed(6)
    cache = PagedKVCache(8, 2, 16, 3, 512, OperandPrecision.INT8,
                         device="cpu")
    for seq, n in ((0, 130), (2, 300), (1, 5)):
        cache.append(seq, *torch.randn(2, 2, n, 16, generator=gen))
    cache.free_seq(0)
    cache.append(1, *torch.randn(2, 2, 200, 16, generator=gen))
    checkpoint.save(tmp_path / "paged", cache)
    like = PagedKVCache(8, 2, 16, 3, 512, OperandPrecision.INT8,
                        device="cpu")
    restored, _ = checkpoint.load(tmp_path / "paged", like)
    assert restored._free == cache._free
    assert restored.free_pages == cache.free_pages
    np.testing.assert_array_equal(restored.page_tables, cache.page_tables)
    np.testing.assert_array_equal(restored.lengths, cache.lengths)
    _assert_same_tree(restored.pool, cache.pool)


def test_train_state_resumes(tmp_path):
    """Two steps, save, a third step; against a fresh state restored from
    the checkpoint taking the third step: the same loss, parameters and
    moments, bit for bit."""
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, CFG.vocab_size, (2, 17)))
    opt = training.make_optimizer(lr=1e-2, warmup_steps=1, total_steps=10)
    state = training.create_train_state(_model(7, trainable=True), opt)
    for _ in range(2):
        training.train_step(state, tokens)
    checkpoint.save(tmp_path / "ts", state, metadata={"data_step": 2})
    want = training.train_step(state, tokens)

    fresh = training.create_train_state(_model(8, trainable=True), opt)
    restored, meta = checkpoint.load(tmp_path / "ts", fresh)
    assert restored is fresh and fresh.step == 2 and meta["data_step"] == 2
    got = training.train_step(fresh, tokens)
    assert torch.equal(got["loss"], want["loss"])
    assert torch.equal(got["grad_norm"], want["grad_norm"])
    _assert_same_tree(fresh, state)
    # The state holds its model's parameters twice; they are stored once.
    with open(tmp_path / "ts" / "meta.json") as f:
        paths = [e["path"] for e in json.load(f)["leaves"]]
    assert not any(p.startswith(".params") for p in paths)
    assert ".step" in paths and ".mu[0]" in paths


def test_partial_restore(tmp_path):
    model = _model(9)
    params = model.params()
    partial = {k: v for k, v in params.items() if k != "lm_head"}
    checkpoint.save(tmp_path / "part", partial)
    fresh = _model(10)
    head = fresh.lm_head.detach().clone()
    with pytest.raises(KeyError, match="lm_head"):
        checkpoint.load(tmp_path / "part", _model(10).params())
    restored, _ = checkpoint.load(tmp_path / "part", fresh.params(),
                                  strict=False)
    assert torch.equal(restored["lm_head"], head)
    assert torch.equal(restored["embed"], params["embed"])


def test_refusals(tmp_path):
    d = tmp_path / "bad"
    d.mkdir()
    (d / "meta.json").write_text(json.dumps({"format": "v1"}))
    with pytest.raises(ValueError, match="unrecognized checkpoint format"):
        checkpoint.load(d, like={})
    # Another dtype or shape than the template's is refused, never cast.
    checkpoint.save(tmp_path / "p", _model(1).params())
    with pytest.raises(ValueError, match="bfloat16"):
        checkpoint.load(tmp_path / "p", _model(1, torch.bfloat16).params())
    small = llama.Llama.init(dataclasses.replace(CFG, vocab_size=128),
                             generator=torch.Generator().manual_seed(1),
                             dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="embed"):
        checkpoint.load(tmp_path / "p", small.params())


@pytest.mark.parametrize("weights", [None, "INT8"])
def test_leaf_paths_are_mfa_tpus(weights):
    """The port keys its leaves as mfa_tpu's checkpoint does
    (jax.tree_util.keystr) for the same parameter tree and caches."""
    cfg_j = jax_llama.LlamaConfig.tiny()
    params_j = jax_llama.init_params(jax.random.key(0), cfg_j, jnp.float32)
    kw = {}
    if weights:
        params_j = jax_llama.quantize_params(params_j, getattr(JPrec, weights))
        kw["weight_precision"] = getattr(OperandPrecision, weights)
    caches_j = jax_llama.make_caches(cfg_j, 2, 128, JPrec.INT8)

    def keys(tree):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        return sorted(jax.tree_util.keystr(p) for p, _ in flat)

    model = _model(0, **kw)
    ours = sorted(x.key for x in checkpoint._leaves(model.params()))
    assert ours == keys(params_j)
    ours = sorted(x.key for x in checkpoint._leaves(
        model.make_caches(2, 128, OperandPrecision.INT8)))
    assert ours == keys(caches_j)


@dataclasses.dataclass
class _Holder:
    """A mutable dataclass with a numpy field."""

    arr: np.ndarray


def _numpy_trees(values):
    """The same numpy leaf in a dict, a list and a mutable dataclass."""
    return {"dict": {"a": values}, "list": [values],
            "dataclass": _Holder(values)}


def _numpy_leaf(tree, where):
    return {"dict": lambda t: t["a"], "list": lambda t: t[0],
            "dataclass": lambda t: t.arr}[where](tree)


@pytest.mark.parametrize("where", ["dict", "list", "dataclass"])
def test_numpy_leaf_is_written_into_the_template(tmp_path, where):
    """A numpy leaf comes back as the template's own array (the same
    object, still numpy) holding the saved values."""
    saved = np.arange(4, dtype=np.float32) * 1.5
    checkpoint.save(tmp_path / where, _numpy_trees(saved)[where])
    like = _numpy_trees(np.zeros(4, np.float32))[where]
    target = _numpy_leaf(like, where)
    restored, _ = checkpoint.load(tmp_path / where, like)
    got = _numpy_leaf(restored, where)
    assert got is target and isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, saved)


@pytest.mark.parametrize("where", ["dict", "list", "dataclass"])
@pytest.mark.parametrize("template", [np.zeros(4, np.float64),
                                      np.zeros(7, np.float32)],
                         ids=["dtype", "shape"])
def test_numpy_leaf_mismatch_is_refused(tmp_path, where, template):
    """A numpy leaf of another dtype or shape than the template's is
    refused wherever it sits, and the template is left as it was."""
    checkpoint.save(tmp_path / where,
                    _numpy_trees(np.arange(4, dtype=np.float32))[where])
    like = _numpy_trees(template)[where]
    with pytest.raises(ValueError, match="template"):
        checkpoint.load(tmp_path / where, like)
    assert _numpy_leaf(like, where) is template
    assert not template.any()


def test_paged_free_list_takes_another_length(tmp_path):
    """The paged cache's free list is replaced, not written into: a
    template whose free list is longer (a fresh cache) takes the saved,
    shorter one."""
    gen = torch.Generator().manual_seed(11)
    cache = PagedKVCache(6, 1, 8, 2, 64, OperandPrecision.BF16,
                         device="cpu")
    cache.append(0, *torch.randn(2, 1, 40, 8, generator=gen))
    checkpoint.save(tmp_path / "free", cache)
    like = PagedKVCache(6, 1, 8, 2, 64, OperandPrecision.BF16, device="cpu")
    assert len(like._free) > len(cache._free)
    restored, _ = checkpoint.load(tmp_path / "free", like)
    assert restored._free == cache._free
    assert all(isinstance(i, int) for i in restored._free)
