"""Paged serving: ``PagedScheduler.step()`` driven by a closed loop.

Set-up makes the weights from the seed, builds the model and the
scheduler as the cell states, runs one request at each prompt bucket the
traffic uses (so every shape is warm), and admits every client's first
request (round 0) in one tick. The window then calls ``step()`` until
``seconds`` have passed. Each tick is timed on the host; it ends in the
sampled tokens' copy to the host, so the card has finished its work.

What a tick did is read from public state only: ``stats`` (prefills,
decode steps, tokens) and the FIFO order of ``submit``. The k-th prefill
is the k-th request submitted; an admitted request gets its first token
from the prefill and its second from the same tick's decode, and one
token in each later tick, all delivered when the tick returns. A request
whose last token came in a tick is complete, and its client submits the
next one at that tick's end. ``finished`` is checked against this count.

After the window, ticks go on without new requests until every request
submitted in the window has its first token. Then the peak memory is
read, the program is freed, and a sample of the requests finished in the
window is judged against the plain reference (``correctness.py``).
"""

from __future__ import annotations

import collections
import gc
import time

import torch

from benchmark import arith, correctness, trace, traffic, weights
from mfa_tpu_torch.models.llama import Llama, LlamaConfig
from mfa_tpu_torch.ops.precision import OperandPrecision
from mfa_tpu_torch.serving.paged_scheduler import PagedScheduler
from mfa_tpu_torch.serving.scheduler import Request

# KV storage named in a cell → (the program's precision, bytes a value,
# whether each row carries a scale).
STORAGE = {"bf16": (OperandPrecision.BF16, 2, False),
           "int8": (OperandPrecision.INT8, 1, True),
           "fp8_e4m3": (OperandPrecision.FP8_E4M3, 1, True)}


def llama_config(s: arith.Shape, config: dict) -> LlamaConfig:
    return LlamaConfig(vocab_size=s.vocab, dim=s.dim, n_layers=s.layers,
                       n_heads=s.heads, n_kv_heads=s.kv_heads,
                       ffn_hidden=s.ffn, rope_theta=float(config["rope_theta"]),
                       norm_eps=float(config["rms_norm_eps"]),
                       tie_embeddings=s.tied, sliding_window=s.window,
                       qkv_bias=s.qkv_bias)


class _Req:
    __slots__ = ("client", "round", "prompt", "n_out", "submit", "t_admit",
                 "times", "done", "in_window")

    def __init__(self, client, round_, prompt, n_out):
        self.client, self.round = client, round_
        self.prompt, self.n_out = prompt, n_out
        self.submit = self.t_admit = self.done = None
        self.times = []
        self.in_window = False


class _Loop:
    """The closed loop's bookkeeping around the scheduler."""

    def __init__(self, sched: PagedScheduler, plan: traffic.ClosedLoop,
                 buckets):
        self.sched, self.plan, self.buckets = sched, plan, buckets
        self.pending = collections.deque()
        self.active: list[_Req] = []
        self.by_id: dict[int, _Req] = {}
        self.ticks: list[dict] = []
        self.submitting = True
        self.mismatch = 0

    def submit(self, r: _Req, t: float, in_window: bool):
        req = Request(prompt=r.prompt, max_new_tokens=r.n_out)
        r.submit, r.in_window = t, in_window
        self.by_id[req.id] = r
        self.pending.append(r)
        self.sched.submit(req)

    def tick(self, in_window: bool, profiled: bool = False):
        sched = self.sched
        before = dict(sched.stats)
        t_a = time.perf_counter()
        with trace.span("tick_admit" if self.pending else "tick_decode"):
            sched.step()
        t_b = time.perf_counter()
        d = {k: sched.stats[k] - before[k]
             for k in ("prefills", "decode_steps", "tokens")}
        admitted = [self.pending.popleft() for _ in range(d["prefills"])]
        for r in admitted:
            r.t_admit = t_a
            r.times.append(t_b)               # the prefill's token
        self.active.extend(admitted)
        contexts, emitted = [], len(admitted)
        for r in self.active:                 # one decoded token each
            contexts.append(len(r.prompt) + len(r.times))
            r.times.append(t_b)
            emitted += 1
        if emitted != d["tokens"] or d["decode_steps"] != 1:
            self.mismatch += 1
        self.ticks.append({
            "t0": t_a, "t1": t_b, "in_window": in_window,
            "profiled": profiled, "stats": d, "contexts": contexts,
            "prefills": [(len(r.prompt), self._bucket(len(r.prompt)))
                         for r in admitted]})
        still = []
        for r in self.active:
            if len(r.times) >= r.n_out:
                r.done = t_b
                if self.submitting:
                    nxt = _Req(r.client, r.round + 1,
                               *self.plan.request(r.client, r.round + 1))
                    self.submit(nxt, t_b, in_window)
            else:
                still.append(r)
        self.active = still

    def _bucket(self, t: int) -> int:
        return next(b for b in self.buckets if t <= b)


def _served(loop: _Loop, reqs, t0: float, t1: float) -> dict:
    """The end-to-end readings of the window [t0, t1]: tokens delivered
    by its ticks, the first-token times of the requests submitted in it
    (late ones included), and the gaps between tokens delivered in it."""
    window = [t for t in loop.ticks if t["in_window"]]
    tokens = sum(t["stats"]["tokens"] for t in window)
    ttft = [r.times[0] - r.submit for r in reqs if r.times]
    gaps = []
    for r in loop.by_id.values():
        ts = [x for x in r.times if t0 <= x <= t1]
        gaps.extend(b - a for a, b in zip(ts, ts[1:]))
    e2e = {"serve_tokens_per_s": tokens / (t1 - t0)}
    if ttft:
        e2e["ttft_p95_ms"] = arith.tail(ttft) * 1e3
    if gaps:
        e2e["itl_p95_ms"] = arith.tail(gaps) * 1e3
    return e2e


def run(ctx) -> dict:
    cell, config, dev = ctx.cell, ctx.config, ctx.device
    shape = arith.Shape.from_config(config)
    precision, kv_bytes, scaled = STORAGE[cell["kv_storage"]]
    buckets = tuple(cell["prompt_buckets"])
    params = weights.make_params(shape, ctx.seed, dev)
    model = Llama(llama_config(shape, config), params, device=dev)
    ctx.sync()
    ctx.log("weights made")
    sched = PagedScheduler(
        model, num_slots=cell["slots"],
        num_pages=cell["slots"] * cell["pages_per_slot"] + 1,
        max_len=cell["max_len"], kv_precision=precision,
        prompt_buckets=buckets, temperature=0.0,
        page_size=cell["page_size"], device=dev)
    plan = traffic.ClosedLoop(cell, ctx.seed, shape.vocab)
    loop = _Loop(sched, plan, buckets)

    # Set-up: one request a prompt bucket, then every client's round 0.
    for b in plan.buckets_used(buckets):
        sched.submit(Request(prompt=plan.warm_prompt(b), max_new_tokens=3))
    sched.run()
    ctx.log(f"warm: buckets {plan.buckets_used(buckets)}")
    t = time.perf_counter()
    for c in range(plan.clients):
        loop.submit(_Req(c, 0, *plan.request(c, 0)), t, False)
    loop.tick(in_window=False)
    ctx.sync()
    gc.collect()
    gc.freeze()
    ctx.log(f"filled {plan.clients} clients in {loop.ticks[-1]['t1'] - t:.2f} s")

    # The window. A traced run profiles trace_seconds more after the
    # rest, timed from the profiler's start (whose own start-up, seconds
    # on a first start, counts in neither part).
    t0 = time.perf_counter()
    ctx.t_window = t0
    t_prof = t0 + ctx.seconds - (cell["trace_seconds"] if ctx.trace else 0)
    while time.perf_counter() < t_prof:
        loop.tick(in_window=True)
    host_end, summary = loop.ticks[-1]["t1"], None
    if ctx.trace:
        with trace.profiler(dev) as prof:
            t_end = time.perf_counter() + cell["trace_seconds"]
            while time.perf_counter() < t_end:
                loop.tick(in_window=True, profiled=True)
        if dev.type == "cuda":
            summary = trace.summarize(prof)
        del prof
    t1 = loop.ticks[-1]["t1"]
    ctx.log(f"window: {sum(1 for t in loop.ticks if t['in_window'])} ticks "
            f"in {t1 - t0:.2f} s")
    reqs = [r for r in loop.by_id.values() if r.in_window]

    # Every request submitted in the window gets its first token; the
    # last completions retire.
    loop.submitting = False
    for _ in range(4 * len(cell["prompt_buckets"]) + 4):
        loop.tick(in_window=False)
        if all(r.times for r in reqs):
            break
    memory_peak = ctx.memory_peak()
    e2e = _served(loop, reqs, t0, t1)

    done = [r for r in loop.by_id.values()
            if r.done is not None and t0 <= r.done <= t1]
    served = {}
    for comp in sched.finished:
        r = loop.by_id.get(comp.request.id)
        if r is not None:
            served[id(r)] = list(comp.tokens)
    wrong_count = sum(1 for r in done
                      if len(served.get(id(r), ())) != r.n_out)
    sample = correctness.sample_requests(
        [(r.prompt, served.get(id(r), [])) for r in done],
        cell["check_requests"], ctx.seed)
    failed = sum(1 for r in reqs if not r.times) + wrong_count
    rec = {"shape": shape, "cell": cell, "kv_bytes": kv_bytes,
           "kv_scaled": scaled, "ticks": loop.ticks, "t0": t0, "t1": t1,
           "host_end": host_end,
           "requests": [{"submit": r.submit, "admit": r.t_admit,
                         "first": r.times[0] if r.times else None,
                         "in_window": r.in_window}
                        for r in loop.by_id.values()],
           "trace": summary}
    mismatch = loop.mismatch
    del loop, sched, model, params
    gc.collect()
    ctx.free()

    # Judge the sample against the plain reference, with fresh weights
    # from the seed (nothing the program held is read).
    ctx.log(f"program freed; reference over {len(sample)} requests, "
            f"{sum(len(x[1]) for x in sample)} served tokens")
    rows = correctness.reference_rows(ctx, shape, sample, cell["kv_storage"])
    ctx.log("reference done")
    read = correctness.readings(rows, [t for _, t in sample])
    ctx.log("readings " + ", ".join(f"{k} {v!r}" for k, v in read.items()))
    checks = {k: {"value": read[k], "limit": v}
              for k, v in cell["limits"].items()}
    checks["tick_mismatches"] = {"value": mismatch, "limit": 0}
    checks["count_mismatches"] = {"value": wrong_count, "limit": 0}
    return {"e2e": e2e, "rec": rec, "checks": checks,
            "attempted": len(reqs), "failed": failed,
            "memory_peak": memory_peak, "sample": sample, "rows": rows,
            "readings": read}
