"""Port PagedScheduler against mfa_tpu's, same parameters and requests,
greedy decoding: identical tokens, statistics and page tables step by
step; pages recycled, admission deferred under a tight pool, INT8 pages
near the full-precision argmax, and the same tokens as the port's
contiguous scheduler (with and without a sliding window)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.models import llama as jax_llama
from mfa_tpu.serving.paged_scheduler import PagedScheduler as JaxPaged
from mfa_tpu.serving.scheduler import Request as JaxRequest
from mfa_tpu_torch.models import llama
from mfa_tpu_torch.models.from_jax import params_from_numpy
from mfa_tpu_torch.ops.precision import OperandPrecision
from mfa_tpu_torch.serving.paged_scheduler import PagedScheduler
from mfa_tpu_torch.serving.scheduler import ContinuousBatchingScheduler, Request

# (prompt length, new tokens): more requests than slots.
SHAPES = [(3, 4), (6, 3), (2, 5), (4, 2), (7, 4)]


@pytest.fixture(scope="module")
def setup():
    cfg_j = jax_llama.LlamaConfig.tiny()
    params = jax_llama.init_params(jax.random.key(1), cfg_j, jnp.float32)
    model = params_from_numpy(jax.tree.map(np.asarray, params),
                              llama.LlamaConfig.tiny(), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg_j.vocab_size, ln).tolist()
               for ln, _ in SHAPES]
    return cfg_j, params, model, prompts


def _run(sched, prompts, shapes=SHAPES):
    reqs = [Request(prompt=p, max_new_tokens=n)
            for p, (_, n) in zip(prompts, shapes)]
    for r in reqs:
        sched.submit(r)
    done = {c.request.id: c.tokens for c in sched.run()}
    return [done[r.id] for r in reqs]


def test_paged_schedulers_agree_step_by_step(setup):
    cfg_j, params, model, prompts = setup
    kw = dict(num_slots=2, num_pages=8, max_len=256, prompt_buckets=(8, 16))
    jsched = JaxPaged(params, cfg_j, **kw)
    sched = PagedScheduler(model, device="cpu", **kw)
    jreqs = [JaxRequest(prompt=p, max_new_tokens=n)
             for p, (_, n) in zip(prompts, SHAPES)]
    reqs = [Request(prompt=p, max_new_tokens=n)
            for p, (_, n) in zip(prompts, SHAPES)]
    for jr, r in zip(jreqs, reqs):
        jsched.submit(jr)
        sched.submit(r)
    start_free = sched.free_pages
    assert start_free == jsched.free_pages == 7
    while True:
        progressed = jsched.step()
        assert sched.step() == progressed
        # The port keeps one allocator for all layers: its table is every
        # mfa_tpu layer's table.
        for c in jsched.caches:
            np.testing.assert_array_equal(sched.cache.page_tables,
                                          c.page_tables)
            np.testing.assert_array_equal(sched.cache.lengths, c.lengths)
        if not progressed and not jsched.queue:
            break
    jsched._retire()
    sched._retire()
    jdone = {c.request.id: c.tokens for c in jsched.finished}
    done = {c.request.id: c.tokens for c in sched.finished}
    assert sched.stats == jsched.stats
    assert sched.stats["prefills"] == len(reqs)
    for jr, r, (_, n) in zip(jreqs, reqs, SHAPES):
        assert len(done[r.id]) == n
        assert done[r.id] == jdone[jr.id], f"request {r.id} diverged"
    # Every page is back in the pool.
    assert sched.free_pages == start_free
    assert not sched.cache.page_tables.any()


def test_admission_deferred_under_memory_pressure(setup):
    """Two pages (one the null page): one request at a time."""
    model = setup[2]
    sched = PagedScheduler(model, num_slots=2, num_pages=2, max_len=256,
                           prompt_buckets=(8,), device="cpu")
    toks = _run(sched, [[1, 2, 3], [4, 5, 6]], shapes=[(3, 2), (3, 2)])
    assert [len(t) for t in toks] == [2, 2]
    assert sched.stats["oom_deferred"] >= 1
    assert sched.free_pages == 1


def test_paged_int8_kv_stays_near_argmax(setup):
    """INT8 pages perturb the logits by the quantization budget, so a
    greedy near-tie may flip against full precision; each chosen token
    must stay near the argmax of the full-precision model along the
    generated history (a corrupted page gives large deficits)."""
    model = setup[2]
    sched = PagedScheduler(model, num_slots=1, num_pages=16, max_len=256,
                           prompt_buckets=(8,),
                           kv_precision=OperandPrecision.INT8, device="cpu")
    prompt = [5, 17, 42, 7]
    (toks,) = _run(sched, [prompt], shapes=[(4, 4)])
    assert len(toks) == 4
    hist = list(prompt)
    for tok in toks:
        row = model(torch.tensor([hist]))[0, -1]
        deficit = float(row.max() - row[tok])
        assert deficit < 0.05, (tok, deficit)
        hist.append(tok)


@pytest.mark.parametrize("window", [None, 8])
def test_paged_equals_contiguous_scheduler(setup, window):
    """fp32 weights, bf16 KV: the paged step appends first and attends over
    the lengths after the append (a window counts back from there); the
    contiguous step attends with the fused kernel, whose window starts at
    the pre-append length + 1. Same keys, same tokens."""
    model = setup[2]
    if window is not None:
        model = llama.Llama(
            dataclasses.replace(model.cfg, sliding_window=window),
            _params(model), device="cpu")
    rng = np.random.default_rng(1)
    shapes = [(12, 6), (3, 9), (10, 4)]
    prompts = [rng.integers(1, model.cfg.vocab_size, ln).tolist()
               for ln, _ in shapes]
    kw = dict(num_slots=2, max_len=64, prompt_buckets=(16,), device="cpu")
    paged = _run(PagedScheduler(model, num_pages=4, **kw), prompts, shapes)
    contiguous = _run(ContinuousBatchingScheduler(model, **kw), prompts,
                      shapes)
    assert paged == contiguous


def _params(model):
    """A Llama's tensors in the dict layout Llama() takes."""
    out = {"embed": model.embed.data, "final_norm": model.final_norm.data,
           "layers": [{n: p.data for n, p in layer.named_parameters()}
                      for layer in model.layers]}
    if model.lm_head is not None:
        out["lm_head"] = model.lm_head.data
    return out
