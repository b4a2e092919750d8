"""Port continuous-batching scheduler against mfa_tpu's, same parameters
and requests, greedy decoding: identical tokens, and each completion
equal to the port's own straight-line generation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.models import llama as jax_llama
from mfa_tpu.serving.scheduler import ContinuousBatchingScheduler as JaxSched
from mfa_tpu.serving.scheduler import Request as JaxRequest
from mfa_tpu_torch.models import llama
from mfa_tpu_torch.models.from_jax import params_from_numpy
from mfa_tpu_torch.serving.sampling import sample
from mfa_tpu_torch.serving.scheduler import (
    ContinuousBatchingScheduler,
    Request,
    _bucket,
)

# (prompt length, new tokens): more requests than slots.
SHAPES = [(3, 4), (5, 2), (2, 6), (4, 3), (6, 5)]


@pytest.fixture(scope="module")
def setup():
    cfg_j = jax_llama.LlamaConfig.tiny()
    params = jax_llama.init_params(jax.random.key(1), cfg_j, jnp.float32)
    cfg = llama.LlamaConfig.tiny()
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, ln).tolist()
               for ln, _ in SHAPES]
    return cfg_j, params, cfg, model, prompts


def _straight_line(model, prompt, n_new):
    toks = list(prompt)
    for _ in range(n_new):
        logits = model(torch.tensor([toks]))
        toks.append(int(logits[0, -1].argmax()))
    return toks[len(prompt):]


def test_schedulers_agree_token_for_token(setup):
    cfg_j, params, cfg, model, prompts = setup
    jsched = JaxSched(params, cfg_j, num_slots=2, max_len=64,
                      prompt_buckets=(8, 16))
    jreqs = [JaxRequest(prompt=p, max_new_tokens=n)
             for p, (_, n) in zip(prompts, SHAPES)]
    for r in jreqs:
        jsched.submit(r)
    jdone = {c.request.id: c.tokens for c in jsched.run()}

    sched = ContinuousBatchingScheduler(model, num_slots=2, max_len=64,
                                        prompt_buckets=(8, 16), device="cpu")
    reqs = [Request(prompt=p, max_new_tokens=n)
            for p, (_, n) in zip(prompts, SHAPES)]
    for r in reqs:
        sched.submit(r)
    done = {c.request.id: c.tokens for c in sched.run()}

    assert sched.stats["prefills"] == len(reqs)
    assert sched.stats == jsched.stats
    for jr, r, (_, n) in zip(jreqs, reqs, SHAPES):
        assert len(done[r.id]) == n
        assert done[r.id] == jdone[jr.id], f"request {r.id} diverged"
        assert done[r.id] == _straight_line(model, r.prompt, n)


def test_eos_and_bucket_limits(setup):
    _, _, cfg, model, prompts = setup
    ref = _straight_line(model, prompts[0], 6)
    sched = ContinuousBatchingScheduler(model, num_slots=1, max_len=64,
                                        prompt_buckets=(8,), device="cpu")
    sched.submit(Request(prompt=prompts[0], max_new_tokens=6,
                         eos_token=ref[1]))
    assert sched.run()[0].tokens == ref[:ref.index(ref[1]) + 1]
    assert _bucket(5, (8, 16)) == 8
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        _bucket(17, (8, 16))


def test_sampling_modes():
    gen = torch.Generator().manual_seed(0)
    logits = torch.tensor([[0.0, 5.0, 1.0, -2.0], [3.0, 0.0, 0.0, 0.0]])
    assert sample(logits).tolist() == [1, 0]
    # top_k=1 and a tiny nucleus both reduce to greedy.
    assert sample(logits, gen, temperature=1.0, top_k=1).tolist() == [1, 0]
    assert sample(logits, gen, temperature=1.0, top_p=1e-3).tolist() == [1, 0]
    draws = torch.stack([sample(logits, gen, temperature=1.0)
                         for _ in range(200)])
    assert draws.dtype == torch.int32
    assert set(draws[:, 0].tolist()) <= {0, 1, 2, 3}
    with pytest.raises(ValueError, match="Generator"):
        sample(logits, temperature=1.0)
