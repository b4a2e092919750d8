"""Multi-rank dry run of the parallel layer.

Twin of ``__graft_entry__.py::dryrun_multichip``: one SGD train step of a
tiny Llama over a (dp, tp) mesh (dp = 2 when the world is even, tp = the
rest), causal ring attention over sp = the whole world, a pp = 2
pipelined forward (dp on the other ranks), the dp scaling harness from
dp 1 to min(4, world), and one admit → decode → retire cycle of the
sharded scheduler over (dp, min(tp, 2)) with an INT8 cache. It spawns
its ranks (``parallel/mesh.py::spawn``, with a timeout): on the card rank
r drives card r over NCCL; with ``device="cpu"`` they are gloo processes.

``--parity`` runs :func:`parity_checks` and :func:`parity_checks_part2`
instead: the parallel layer over the world's ranks against one rank's
own computation of the same thing (the ring bit for bit against its
one-process schedule, Ulysses against full-sequence attention, a tp =
world Llama against the unsharded one; a pp = world pipelined forward
against one card's forward and bit for bit against its one-process
schedule; a (dp 2, tp world/2) sharded scheduler against the one-card
scheduler), with times beside one card's, and dp scaling efficiency
(on the card: Llama-3-8B's attention over 32768 tokens, its widths at 2
layers for tp, its full depth for pp and serving, 4 layers for dp
scaling; on the CPU: 256 tokens and small configs).

    python -m mfa_tpu_torch.parallel.dryrun --world 4 --device cpu
    python -m mfa_tpu_torch.parallel.dryrun --world 4 --device cuda --parity
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import gc
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from dataclasses import replace

from mfa_tpu_torch.models import llama
from mfa_tpu_torch.models import training
from mfa_tpu_torch.models.from_jax import params_from_numpy
from mfa_tpu_torch.ops.attention import flash_attention
from mfa_tpu_torch.ops.precision import OperandPrecision
from mfa_tpu_torch.parallel import collectives
from mfa_tpu_torch.parallel import mesh as mesh_mod
from mfa_tpu_torch.parallel import multihost, pipeline, sharding
from mfa_tpu_torch.parallel.ring_attention import (
    make_ring_attention,
    ring_flash_attention,
    ring_schedule,
)
from mfa_tpu_torch.parallel.ulysses import ulysses_attention
from mfa_tpu_torch.serving import distributed
from mfa_tpu_torch.serving.scheduler import (
    ContinuousBatchingScheduler,
    Request,
)
from mfa_tpu_torch.utils import roofline
from mfa_tpu_torch.utils.device import resolve_device
from mfa_tpu_torch.utils.testing import KERNEL_BUDGETS, budget_share


def mesh_shape(world: int) -> tuple[int, int]:
    """(dp, tp) of the train step, as ``dryrun_multichip`` picks them."""
    dp = 2 if world % 2 == 0 else 1
    return dp, world // dp


def dryrun_config(tp: int) -> llama.LlamaConfig:
    return llama.LlamaConfig(vocab_size=512, dim=256, n_layers=2,
                             n_heads=max(4, tp), n_kv_heads=max(2, tp),
                             ffn_hidden=512)


def sgd_step(model: llama.Llama, tokens, lr: float = 1e-3, *,
             dp_group=None) -> torch.Tensor:
    """``dryrun_multichip``'s step: the mean next-token NLL of tokens
    [B, T+1] and p -= lr * grad in place (dp-averaged gradients); returns
    the loss."""
    loss = training.loss_and_grads(model, tokens, dp_group=dp_group)
    with torch.no_grad():
        for p in model.parameters():
            p.sub_(lr * p.grad.to(p.dtype))
    return loss


def sgd_dryrun(mesh, device, jax_params=None, tokens=None) -> dict:
    """The (dp, tp) train step on ``mesh``: ``jax_params`` (``mfa_tpu``'s
    parameter tree as numpy arrays) and ``tokens`` [dp * 2, 33] replace
    the seeded random ones. Returns the loss, this rank's dp and tp
    coordinates and its updated parameter shards (numpy)."""
    dp, tp = (mesh_mod.axis_size(mesh, a) for a in ("dp", "tp"))
    cfg = dryrun_config(tp)
    if jax_params is None:
        full = llama.init_params(
            cfg, torch.Generator(device=device).manual_seed(0),
            torch.float32)
    else:
        full = params_from_numpy(jax_params, cfg, device=device).params()
    if tokens is None:
        tokens = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (dp * 2, 33))
    model = llama.Llama(cfg, sharding.shard_params(full, mesh, cfg),
                        device=device, trainable=True,
                        tp_group=mesh.get_group("tp"))
    toks = mesh_mod.batch_sharded(torch.as_tensor(tokens, device=device),
                                  mesh)
    loss = sgd_step(model, toks, dp_group=mesh.get_group("dp"))
    return {"loss": float(loss), "dp": mesh.get_local_rank("dp"),
            "tp": mesh.get_local_rank("tp"),
            "params": {n: p.detach().cpu().numpy()
                       for n, p in model.named_parameters()}}


def ring_dryrun(world: int, device) -> bool:
    """Causal ring attention over sp = the world on seeded [1, 2,
    64 * world, 64] inputs; whether this rank's O is finite."""
    sp_mesh = mesh_mod.make_mesh(sp=world, device=device)
    rng = np.random.default_rng(0)
    q, k, v = (mesh_mod.local_shard(torch.as_tensor(
        rng.standard_normal((1, 2, 64 * world, 64)), dtype=torch.float32,
        device=device), sp_mesh, {"sp": 2}).contiguous() for _ in range(3))
    o = make_ring_attention(sp_mesh, causal=True, device=device)(q, k, v)
    return bool(torch.isfinite(o).all())


def pipeline_dryrun(world: int, device) -> bool:
    """A pp = 2 pipelined forward of a 2-layer Llama (dp = world / 2 on
    the other ranks; 2 microbatches, each cut over dp); whether the
    logits are finite."""
    dp = world // 2
    mesh = mesh_mod.make_mesh(dp=dp, pp=2, device=device)
    cfg = llama.LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=4,
                            n_kv_heads=2, ffn_hidden=512)
    model = llama.Llama.init(
        cfg, generator=torch.Generator(device=device).manual_seed(1),
        dtype=torch.float32, device=device)
    stacked = pipeline.shard_stacked(
        llama.stack_layer_params(model.params(), 2), mesh)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2 * dp, 32)), device=device)
    with torch.inference_mode():
        logits = llama.forward_pipelined(model, tokens, mesh=mesh,
                                         num_microbatches=2,
                                         stacked_layers=stacked)
    return bool(torch.isfinite(logits).all())


def _seeded_step_inputs(mesh, cfg, device, batch, seq, seed, trainable):
    """A seeded Llama of ``cfg`` (bf16 on the card, fp32 on the CPU), a
    seeded [dp * batch, seq] batch and this rank's dp rows of it."""
    dp = mesh_mod.axis_size(mesh, "dp")
    model = llama.Llama.init(
        cfg, generator=torch.Generator(device=device).manual_seed(seed),
        dtype=torch.bfloat16 if device.type == "cuda" else torch.float32,
        device=device, trainable=trainable)
    tokens = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (dp * batch, seq)), device=device)
    return model, tokens, mesh_mod.batch_sharded(tokens, mesh)


def make_loss_step(mesh, cfg, device, *, batch: int, seq: int,
                   seed: int = 2):
    """``dryrun_multichip``'s forward-loss step on ``mesh``: the mean
    next-token NLL of a seeded [dp * batch, seq] batch, each dp rank on
    its rows, the mean over dp. Returns ``make_step``'s triple."""
    model, tokens, local = _seeded_step_inputs(mesh, cfg, device, batch,
                                               seq, seed, False)
    group, dp = mesh.get_group("dp"), mesh_mod.axis_size(mesh, "dp")

    def step():
        with torch.inference_mode():
            loss = training.cross_entropy_loss(model(local[:, :-1]),
                                               local[:, 1:])
            return collectives.all_reduce(loss, group) / dp

    return step, (), tokens.numel()


def make_train_step(mesh, cfg, device, *, batch: int, seq: int,
                    seed: int = 2):
    """``models/training.py::train_step`` with the mesh's ``dp_group`` on
    a seeded [dp * batch, seq] batch: ``make_step``'s triple."""
    model, tokens, local = _seeded_step_inputs(mesh, cfg, device, batch,
                                               seq, seed, True)
    state = training.create_train_state(model, training.make_optimizer())
    group = mesh.get_group("dp")

    def step():
        return training.train_step(state, local, dp_group=group)

    return step, (), tokens.numel()


def scaling_dryrun(world: int, device) -> dict:
    """``dryrun_multichip``'s dp scaling harness on its 2-layer config:
    the forward-loss step from dp 1 to min(4, world)."""
    cfg = llama.LlamaConfig(vocab_size=512, dim=128, n_layers=2, n_heads=4,
                            n_kv_heads=2, ffn_hidden=256)
    return multihost.dp_scaling_efficiency(
        lambda mesh: make_loss_step(mesh, cfg, device, batch=2, seq=32),
        dp_sizes=(1, min(4, world)), device=device)


def serving_dryrun(world: int, device) -> dict:
    """One admit → decode → retire cycle of the sharded scheduler over
    (dp, min(tp, 2)) with an INT8 cache: three requests of 4 tokens."""
    dp, tp = mesh_shape(world)
    tp = min(tp, 2)
    mesh = mesh_mod.make_mesh(dp=dp, tp=tp, device=device)
    if mesh.get_coordinate() is None:
        return {}
    model = llama.Llama.init(
        dryrun_config(tp),
        generator=torch.Generator(device=device).manual_seed(3),
        dtype=torch.float32, device=device)
    sched = distributed.ShardedScheduler(
        model, mesh=mesh, num_slots=2 * dp, max_len=128,
        kv_precision=OperandPrecision.INT8, prompt_buckets=(16,),
        device=device)
    for p in ([1, 2, 3, 4], [5, 6, 7], [9, 10, 11, 12, 13]):
        sched.submit(Request(prompt=p, max_new_tokens=4))
    done = sched.run(max_steps=32)
    return {"dp": dp, "tp": tp, "completions": len(done),
            "new_tokens": [len(c.tokens) for c in done], **sched.stats}


def run_rank(rank: int, world: int, init_method: str,
             device: str = "cuda") -> dict:
    """One rank of the dry run (:func:`sgd_dryrun`, :func:`ring_dryrun`,
    :func:`pipeline_dryrun`, :func:`scaling_dryrun`,
    :func:`serving_dryrun`); rank r of a CUDA run drives card r."""
    dev = (torch.device("cuda", rank) if device == "cuda"
           else resolve_device(device))
    dp, tp = mesh_shape(world)
    mesh = mesh_mod.make_mesh(dp=dp, tp=tp, device=dev,
                              init_method=init_method, rank=rank,
                              world_size=world)
    out = sgd_dryrun(mesh, dev)
    out["ring_finite"] = ring_dryrun(world, dev)
    if world % 2 == 0:
        out["pipeline_finite"] = pipeline_dryrun(world, dev)
    out["scaling"] = scaling_dryrun(world, dev)
    out["serving"] = serving_dryrun(world, dev)
    dist.destroy_process_group()
    return out


def _same_bits(a, b) -> bool:
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


def _attention_parity(group, world, rank, device, seq) -> dict:
    """Ring and Ulysses over ``group`` on Llama-3-8B's attention (Hq 32,
    Hkv 8, D 128, bf16, ``seq`` tokens), forward and backward."""
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v, do = (torch.randn((1, h, seq, 128), generator=gen,
                               device=device).bfloat16()
                   for h in (32, 8, 8, 32))

    def local(x):
        return x.chunk(world, dim=2)[rank].contiguous()

    def run(attn, causal):
        leaves = [local(x).requires_grad_() for x in (q, k, v)]
        o = attn(*leaves, group=group, causal=causal, device=device)
        o.backward(local(do))
        return [o.detach()] + [t.grad for t in leaves]

    def full(causal):
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        o = flash_attention(*leaves, causal=causal, device=device)
        o.backward(do)
        return [o.detach()] + [t.grad for t in leaves]

    out, timed = {}, device.type == "cuda"
    for causal in (False, True):
        name = "causal" if causal else "noncausal"
        got = run(ring_flash_attention, causal)
        want = ring_schedule(q, k, v, do, n=world, causal=causal,
                             device=device)
        out[f"ring_{name}_bit_equal"] = all(
            _same_bits(a, local(b)) for a, b in zip(got, want))
        got = run(ulysses_attention, causal)
        want = [local(x) for x in full(causal)]
        out[f"ulysses_{name}_bit_equal"] = all(
            _same_bits(a, b) for a, b in zip(got, want))
        out[f"ulysses_{name}_shares"] = {
            n: budget_share(a, b, *KERNEL_BUDGETS[
                "flash_fwd_o_bf16" if n == "o" else f"flash_bwd_{n}_bf16"])
            for n, a, b in zip(("o", "dq", "dk", "dv"), got, want)}
        if timed:
            for label, fn in (
                    ("ring", lambda: run(ring_flash_attention, causal)),
                    ("ulysses", lambda: run(ulysses_attention, causal)),
                    ("full_sequence", lambda: full(causal))):
                out[f"{label}_{name}_fwd_bwd_ms"] = roofline.cuda_ms(
                    fn, iters=5, warmup=2)
    return out


def _mixed_share(a, b) -> float:
    """max |a - b| over the bf16 mixed budget, 5e-2 times the larger of 1
    and the largest |b| (chip_smoke.py's in-context logits check)."""
    scale = max(1.0, float(b.float().abs().max()))
    return float((a.float() - b.float()).abs().max()) / (5e-2 * scale)


def _tp_parity(mesh, world, device, cfg) -> dict:
    """A tp = ``world`` Llama of ``cfg`` (bf16) against the unsharded one
    from the same weights: forward logits and three decode steps' (the
    unsharded model's greedy tokens fed to both), within the bf16 mixed
    budget as chip_smoke.py holds logits in context: 5e-2 times the
    larger of 1 and the largest |logit|."""
    full = llama.init_params(
        cfg, torch.Generator(device=device).manual_seed(1), torch.bfloat16)
    model = llama.Llama(cfg, full, device=device)
    tp_model = llama.Llama(cfg, sharding.shard_params(full, mesh, cfg),
                           device=device, tp_group=mesh.get_group("tp"))
    tokens = torch.randint(1, cfg.vocab_size, (2, 256), device=device,
                           generator=torch.Generator(
                               device=device).manual_seed(2))

    shares = []
    with torch.inference_mode():
        shares.append(_mixed_share(tp_model(tokens), model(tokens)))
        caches = [m.make_caches(2, 264) for m in (model, tp_model)]
        want, caches[0] = model(tokens, caches=caches[0])
        got, caches[1] = tp_model(tokens, caches=caches[1])
        tok = want[:, -1].argmax(-1)
        for _ in range(3):
            want, caches[0] = model.decode_step(tok, caches[0])
            got, caches[1] = tp_model.decode_step(tok, caches[1])
            shares.append(_mixed_share(got, want))
            tok = want.argmax(-1)
    return {"tp": world, "layers": cfg.n_layers, "logit_shares": shares,
            "kv_heads_a_rank": caches[1][0].k.shape[1]}


def _wall_ms(fn, device, iters: int = 3) -> float:
    """Host-clock ms of fn() after a warm-up, the card synchronised."""
    fn()
    multihost.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    multihost.synchronize(device)
    return (time.perf_counter() - t0) / iters * 1e3


def _gib(device) -> float | None:
    return (torch.cuda.memory_allocated(device) / 2**30
            if device.type == "cuda" else None)


def _pipeline_parity(world, device, cfg, seq) -> dict:
    """A pp = ``world`` Llama of ``cfg`` (bf16), 4 microbatches of one
    sequence: ``forward_pipelined`` with this rank's stage only, against
    one card's ``forward`` (the bf16 mixed budget) and bit for bit
    against ``forward_pipeline_schedule`` (every stage in this process),
    with both times."""
    mesh = mesh_mod.make_mesh(pp=world, device=device)
    full = llama.Llama.init(
        cfg, generator=torch.Generator(device=device).manual_seed(4),
        dtype=torch.bfloat16, device=device)
    tokens = torch.randint(1, cfg.vocab_size, (4, seq), device=device,
                           generator=torch.Generator(
                               device=device).manual_seed(5))
    with torch.inference_mode():
        want = full(tokens)
        one_card_ms = _wall_ms(lambda: full(tokens), device)
        sched = llama.forward_pipeline_schedule(
            full, tokens, n_stages=world, num_microbatches=4)
        stage = pipeline.shard_stacked(
            llama.stack_layer_params(full.params(), world), mesh)
        head = llama.Llama(cfg, {k: v for k, v in full.params().items()
                                 if k != "layers"} | {"layers": []},
                           device=device)
    del full
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    held = _gib(device)

    def run():
        return llama.forward_pipelined(head, tokens, mesh=mesh,
                                       num_microbatches=4,
                                       stacked_layers=stage)

    with torch.inference_mode():
        got = run()
        pp_ms = _wall_ms(run, device)
    share = _mixed_share(got, want)
    bit_equal = _same_bits(got, sched)
    return {"pp": world, "layers_a_rank": len(
        next(iter(stage.values()))), "pp_logit_share": share,
        "pp_bit_equal_schedule": bit_equal, "pp_gib_held": held,
        "pp_ms": pp_ms, "one_card_forward_ms": one_card_ms,
        "pp_ok": share <= 1 and bit_equal}


def _serve(sched, prompts, new_tokens: int, device) -> dict:
    """Greedy requests through ``sched``: their tokens, the median ms of
    a step that only decoded, the scheduler's stats."""
    reqs = [Request(prompt=p, max_new_tokens=new_tokens) for p in prompts]
    for r in reqs:
        sched.submit(r)
    decode_ms = []
    for _ in range(10_000):
        pre = sched.stats["prefills"]
        t0 = time.perf_counter()
        progressed = sched.step()
        multihost.synchronize(device)
        if not progressed and not sched.queue:
            break
        if sched.stats["prefills"] == pre:
            decode_ms.append((time.perf_counter() - t0) * 1e3)
    else:
        raise RuntimeError("serving: no end after 10000 steps")
    sched._retire()
    done = {c.request.id: c.tokens for c in sched.finished}
    return {**sched.stats, "answers": [done.get(r.id) for r in reqs],
            "decode_ms": float(np.median(decode_ms)) if decode_ms else None}


def _serving_parity(world, device, cfg, seq, prompt_lens, new_tokens,
                    max_len, buckets) -> dict:
    """A (dp 2, tp world/2) Llama of ``cfg`` (bf16): the sharded prefill
    of four ``seq``-token prompts and three decode steps' logits against
    one card's (bf16 mixed budget), then ``ShardedScheduler`` against
    the one-card ``ContinuousBatchingScheduler`` on the same requests
    over bf16 and INT8 caches: completions, greedy tokens equal, decode
    ms a step."""
    dp, tp = 2, world // 2
    mesh = mesh_mod.make_mesh(dp=dp, tp=tp, device=device)
    full = llama.Llama.init(
        cfg, generator=torch.Generator(device=device).manual_seed(6),
        dtype=torch.bfloat16, device=device)
    gen = torch.Generator(device=device).manual_seed(7)
    prompts = torch.randint(1, cfg.vocab_size, (4, seq), device=device,
                            generator=gen)
    length = prompts.shape[1] + 8
    tp_model = sharding.shard_model(full, mesh)
    step = distributed.make_decode_step(tp_model, mesh)
    shares = []
    with torch.inference_mode():
        ref_caches = full.make_caches(4, length)
        want, ref_caches = full(prompts, caches=ref_caches)
        caches = tp_model.make_caches(4 // dp, length)
        got, caches = tp_model(mesh_mod.batch_sharded(prompts, mesh),
                               caches=caches)
        shares.append(_mixed_share(got, mesh_mod.batch_sharded(want, mesh)))
        tok = want[:, -1].argmax(-1)
        for _ in range(3):
            want, ref_caches = full.decode_step(tok, ref_caches)
            got, caches = step(tok, caches)
            shares.append(_mixed_share(got, want))
            tok = want.argmax(-1)
    del tp_model, caches, ref_caches
    rng = np.random.default_rng(8)
    texts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in prompt_lens]
    out = {"dp": dp, "tp": tp, "serve_logit_shares": shares}
    ok = all(x <= 1 for x in shares)
    for prec in (OperandPrecision.BF16, OperandPrecision.INT8):
        kw = dict(num_slots=4, max_len=max_len, kv_precision=prec,
                  prompt_buckets=buckets, device=device)
        one = _serve(ContinuousBatchingScheduler(full, **kw), texts,
                     new_tokens, device)
        multi = _serve(distributed.ShardedScheduler(full, mesh=mesh, **kw),
                       texts, new_tokens, device)
        pairs = list(zip(multi["answers"], one["answers"]))
        complete = all(t is not None and len(t) == new_tokens
                       for t, _ in pairs)
        out[prec.value] = {
            "completions": sum(t is not None for t, _ in pairs),
            "tokens_equal": sum(a == b for t, o in pairs
                                for a, b in zip(t or [], o or [])),
            "tokens": sum(len(t or []) for t, _ in pairs),
            "requests_equal": sum(t == o for t, o in pairs),
            "decode_ms": multi["decode_ms"],
            "one_card_decode_ms": one["decode_ms"],
            "decode_steps": multi["decode_steps"]}
        ok = ok and complete
        gc.collect()
    out["serve_ok"] = ok
    return out


def _scaling_parity(world, device, cfg, seq) -> dict:
    """dp scaling efficiency from dp 1 to ``world``, one sequence of
    ``seq`` tokens a rank: ``dryrun_multichip``'s forward-loss step and
    ``models/training.py::train_step``."""
    out = {}
    for name, maker in (("loss_step", make_loss_step),
                        ("train_step", make_train_step)):
        out[name] = multihost.dp_scaling_efficiency(
            lambda mesh: maker(mesh, cfg, device, batch=1, seq=seq + 1),
            dp_sizes=(1, world), device=device)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def parity_checks_part2(world: int, device, cfgs: dict, sizes: dict
                        ) -> dict:
    """Part 2 on this rank of an initialised world: the pipeline
    (``cfgs["pipeline"]``, ``sizes["pipeline_seq"]`` tokens), sharded
    serving (``cfgs["serving"]``; ``sizes["serving_seq"]`` tokens for the
    logits; requests of ``sizes["prompts"]`` tokens,
    ``sizes["new_tokens"]`` new, ``sizes["max_len"]``,
    ``sizes["buckets"]``) and dp scaling (``cfgs["scaling"]``,
    ``sizes["scaling_seq"]`` tokens a rank). "ok" says whether the
    pipeline and serving checks held."""
    device = resolve_device(device)
    with watchdog("pipeline", 300):
        out = _pipeline_parity(world, device, cfgs["pipeline"],
                               sizes["pipeline_seq"])
    gc.collect()
    with watchdog("sharded serving", 600):
        out.update(_serving_parity(
            world, device, cfgs["serving"], sizes["serving_seq"],
            sizes["prompts"],
            sizes["new_tokens"], sizes["max_len"], sizes["buckets"]))
    gc.collect()
    with watchdog("dp scaling", 300):
        out["scaling"] = _scaling_parity(world, device, cfgs["scaling"],
                                         sizes["scaling_seq"])
    out["ok"] = out["pp_ok"] and out["serve_ok"]
    return out


@contextlib.contextmanager
def watchdog(label: str, seconds: float):
    """Print every thread's Python stack to stderr if the block outlasts
    ``seconds`` (a rank stuck outside a collective, which NCCL's timeout
    does not name); the block then goes on."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    print(f"[rank {rank}] {label}: watchdog {seconds:.0f} s",
          file=sys.stderr, flush=True)
    with contextlib.ExitStack() as stack:
        faulthandler.dump_traceback_later(seconds, exit=False)
        stack.callback(faulthandler.cancel_dump_traceback_later)
        yield


def parity_checks(world: int, device, seq: int, cfg) -> dict:
    """On this rank of an initialised world: ring and Ulysses over sp =
    ``world`` against one rank's own computation (the ring's O and
    gradients equal to its one-process schedule bit for bit, Ulysses'
    within KERNEL_BUDGETS of full-sequence flash_attention, their bits
    compared too), and a tp = ``world`` Llama of ``cfg`` against the
    unsharded one. "ok" says whether every check held."""
    device = resolve_device(device)
    rank = dist.get_rank()
    sp_mesh = mesh_mod.make_mesh(sp=world, device=device)
    # The first phase builds the kernel library (one rank compiles, the
    # others wait on its file lock); the tp phase takes seconds, and its
    # watchdog fires before NCCL's 120 s timeout.
    with watchdog("ring and Ulysses", 400):
        out = {"rank": rank, **_attention_parity(
            sp_mesh.get_group("sp"), world, rank, device, seq)}
    tp_mesh = mesh_mod.make_mesh(tp=world, device=device)
    with watchdog("tp Llama", 60):
        out.update(_tp_parity(tp_mesh, world, device, cfg))
    out["ok"] = (all(v for k, v in out.items() if k.endswith("bit_equal")
                     and k.startswith("ring"))
                 and all(x <= 1 for k, v in out.items()
                         if k.startswith("ulysses") and k.endswith("shares")
                         for x in v.values())
                 and all(x <= 1 for x in out["logit_shares"]))
    return out


def parity_rank(rank: int, world: int, init_method: str,
                device: str = "cuda") -> dict:
    """One rank of :func:`parity_checks`: on the card at S 32768 and
    Llama-3-8B's widths cut to 2 layers, on the CPU at S 256 and
    :func:`dryrun_config`."""
    on_card = device == "cuda"
    dev = torch.device("cuda", rank) if on_card else resolve_device(device)
    # A collective that a rank never joins fails in two minutes, not ten.
    mesh_mod.make_mesh(device=dev, init_method=init_method, rank=rank,
                       world_size=world, timeout_s=120)
    cfg = (replace(llama.LlamaConfig.llama3_8b(), n_layers=2) if on_card
           else dryrun_config(world))
    out = parity_checks(world, dev, 32768 if on_card else 256, cfg)
    gc.collect()
    part2 = parity_checks_part2(world, dev, *part2_sizes(world, on_card))
    out.update({k: v for k, v in part2.items() if k != "ok"})
    out["ok"] = out["ok"] and part2["ok"]
    dist.destroy_process_group()
    return out


def part2_sizes(world: int, on_card: bool) -> tuple[dict, dict]:
    """(configs, sizes) of :func:`parity_checks_part2`: on the card
    Llama-3-8B at full width and depth for the pipeline and serving and
    cut to 4 layers for dp scaling (chip_smoke.py's six serving prompts);
    on the CPU small configs."""
    if on_card:
        cfg = llama.LlamaConfig.llama3_8b()
        return ({"pipeline": cfg, "serving": cfg,
                 "scaling": replace(cfg, n_layers=4)},
                {"pipeline_seq": 512, "serving_seq": 256,
                 "scaling_seq": 2048,
                 "prompts": (50, 120, 250, 500, 1000, 1900),
                 "new_tokens": 16, "max_len": 2048,
                 "buckets": (64, 128, 256, 512, 1024, 2048)})
    return ({"pipeline": replace(dryrun_config(world), n_layers=world),
             "serving": dryrun_config(2),
             "scaling": llama.LlamaConfig(vocab_size=512, dim=128,
                                          n_layers=2, n_heads=4,
                                          n_kv_heads=2, ffn_hidden=256)},
            {"pipeline_seq": 16, "serving_seq": 8, "scaling_seq": 32,
             "prompts": (3, 5, 7, 4, 6, 2), "new_tokens": 4,
             "max_len": 64, "buckets": (8, 16)})


def dryrun(world: int = 4, device: str = "cuda",
           timeout_s: float = 300.0) -> list[dict]:
    """Run :func:`run_rank` on ``world`` ranks; their results in rank
    order."""
    return mesh_mod.spawn(run_rank, world, device, timeout_s=timeout_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--parity", action="store_true")
    args = ap.parse_args(argv)
    if args.parity:
        results = mesh_mod.spawn(parity_rank, args.world, args.device,
                                 timeout_s=1200)
        for r in results:
            print(json.dumps(r), flush=True)
        return 0 if all(r["ok"] for r in results) else 1
    results = dryrun(args.world, args.device)
    dp, tp = mesh_shape(args.world)
    summary = {"dp": dp, "tp": tp, "loss": [r["loss"] for r in results],
               "ring_finite": all(r["ring_finite"] for r in results),
               "pipeline_finite": all(r.get("pipeline_finite", True)
                                      for r in results),
               "scaling": results[0]["scaling"],
               "serving": results[0]["serving"]}
    print(json.dumps(summary))
    ok = (summary["ring_finite"] and summary["pipeline_finite"]
          and summary["scaling"]["efficiency"] > 0
          and summary["serving"]["completions"] == 3
          and all(n == 4 for n in summary["serving"]["new_tokens"]))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
