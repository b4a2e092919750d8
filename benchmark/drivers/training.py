"""Training: ``models/training.py::train_step`` driven one step after another.

Set-up makes the weights from the seed, builds the trainable model and
its optimizer state once, and drives that one object through the first
three steps, the checked ones (they warm every shape too). After the
first step it reads the first gradient as the optimizer got it, from the
first moment (m = (1 - b1) g after one step); after the third it copies
the parameters to the host. The window then runs whole steps until
``seconds`` have passed, each on a sequence of its own, and ends each in
the loss's copy to the host.

After the window the program is freed, and the plain reference follows
the same three steps in float32 from fresh weights of the same seed. The
numbers compared, each against a limit of the cell's:

- ``loss_gap``: the largest |loss - reference loss| / reference loss of
  the three steps;
- ``first_grad_gap``: over the leaves, the largest gap between the
  program's and the reference's first-gradient norms, over the larger of
  the reference leaf's norm and the median leaf's;
- ``change_gap``: the same of the parameters' change after three steps,
  leaving out leaves whose reference gradient is under a thousandth of
  the median leaf's (they move by round-off alone).
"""

from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch

from benchmark import arith, correctness, trace, weights
from benchmark.drivers.paged_serving import llama_config
from mfa_tpu_torch.models import training
from mfa_tpu_torch.models.llama import Llama

CHECKED = 3


def batch(ctx, shape, step: int):
    """Sequence ``step`` of the run: tokens [batch, seq_len + 1], uniform
    over the vocabulary, a stream of its own a step."""
    cell = ctx.cell
    rng = np.random.default_rng([ctx.seed, 5, step])
    toks = rng.integers(0, shape.vocab, (cell["batch"], cell["seq_len"] + 1))
    return torch.from_numpy(toks).to(ctx.device)


def _gap(program: dict, ref: dict, names) -> float:
    """The worst leaf's |program - reference| over the larger of the
    reference leaf's value and the median leaf's."""
    med = statistics.median(ref[n] for n in names)
    return max(abs(program[n] - ref[n]) / max(ref[n], med) for n in names)


def run(ctx) -> dict:
    cell, config, dev = ctx.cell, ctx.config, ctx.device
    shape = arith.Shape.from_config(config)
    params = weights.make_params(shape, ctx.seed, dev)
    model = Llama(llama_config(shape, config), params, device=dev,
                  trainable=True)
    del params
    opt = training.make_optimizer(**cell["optimizer"])
    state = training.create_train_state(model, opt)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    ctx.sync()
    ctx.log("model and optimizer state made")

    losses, first = [], None
    for step in range(CHECKED):
        out = training.train_step(state, batch(ctx, shape, step))
        losses.append(float(out["loss"]))
        if step == 0:
            first = {n: float(mu.float().norm()) / (1.0 - opt.b1)
                     for n, mu in zip(names, state.mu)}
    after = {n: p.detach().to("cpu", copy=True)
             for n, p in zip(names, state.params)}
    ctx.log(f"checked steps: losses {losses}")

    steps = []
    n = CHECKED

    def one(profiled):
        nonlocal n
        t_a = time.perf_counter()
        with trace.span("train_step"):
            float(training.train_step(state, batch(ctx, shape, n))["loss"])
        steps.append({"t0": t_a, "t1": time.perf_counter(),
                      "profiled": profiled})
        n += 1

    gc.collect()
    gc.freeze()
    # A traced run profiles trace_seconds more after the rest, timed from
    # the profiler's start.
    t0 = time.perf_counter()
    ctx.t_window = t0
    t_prof = t0 + ctx.seconds - (cell["trace_seconds"] if ctx.trace else 0)
    while time.perf_counter() < t_prof:
        one(False)
    host_end, summary = steps[-1]["t1"] if steps else t0, None
    if ctx.trace:
        with trace.profiler(dev) as prof:
            t_end = time.perf_counter() + cell["trace_seconds"]
            while time.perf_counter() < t_end:
                one(True)
        if dev.type == "cuda":
            summary = trace.summarize(prof)
        del prof
    t1 = steps[-1]["t1"]
    ctx.log(f"window: {len(steps)} steps in {t1 - t0:.2f} s")
    memory_peak = ctx.memory_peak()
    tokens = cell["batch"] * cell["seq_len"]
    e2e = {"train_tokens_per_s": tokens * len(steps) / (t1 - t0)}
    rec = {"shape": shape, "cell": cell, "steps": steps, "t0": t0,
           "t1": t1, "host_end": host_end, "trace": summary}
    del state, model, out
    gc.collect()
    ctx.free()

    prog = (losses, first, program_change(ctx, shape, after))
    ref = reference_steps(ctx, shape)
    readings = compare(prog, ref)
    ctx.log("readings " + ", ".join(f"{k} {v!r}" for k, v in
                                    readings.items()))
    checks = {k: {"value": readings[k], "limit": v}
              for k, v in cell["limits"].items()}
    return {"e2e": e2e, "rec": rec, "checks": checks, "attempted": len(steps),
            "failed": 0, "memory_peak": memory_peak, "readings": readings,
            "ref": ref}


def program_change(ctx, shape, after: dict) -> dict:
    """Norms of the program's change over the checked steps, by leaf."""
    p0 = correctness.flat_params(weights.make_params(shape, ctx.seed,
                                                     ctx.device))
    change = {n: float((after[n].to(ctx.device).float() - p0[n].float())
                       .norm()) for n in after}
    del p0
    ctx.free()
    return change


def reference_steps(ctx, shape, fp8=False):
    """(losses, first-gradient norms, change norms) of the reference over
    the checked steps, from fresh float32 weights of the seed."""
    ref = correctness.reference(ctx.config)
    opt = dict(ctx.cell["optimizer"])
    p = weights.make_params(shape, ctx.seed, ctx.device)
    storage = {n: t.dtype for n, t in correctness.flat_params(p).items()}
    for layer in [p] + p["layers"]:
        for k, t in list(layer.items()):
            if k != "layers":
                layer[k] = t.float()
    losses, first = ref.train(ctx.config, p, [batch(ctx, shape, i)[0]
                                              for i in range(CHECKED)],
                              opt, storage, fp8=fp8)
    p0 = correctness.flat_params(weights.make_params(shape, ctx.seed,
                                                     ctx.device))
    after = ref.flat(p)
    change = {n: float((after[n] - p0[n].float()).norm()) for n in after}
    del p, p0, after
    ctx.free()
    return losses, first, change


def compare(prog, ref) -> dict:
    """The three numbers of one run against the reference's readings."""
    (pl, pf, pc), (rl, rf, rc) = prog, ref
    med = statistics.median(rf.values())
    moved = [n for n in rf if rf[n] >= 1e-3 * med]
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(pl, rl)),
            "first_grad_gap": _gap(pf, rf, list(rf)),
            "change_gap": _gap(pc, rc, moved)}
