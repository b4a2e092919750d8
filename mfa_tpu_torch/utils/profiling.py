"""Where the serving and training time goes on the card.

Runs Llama prefill, batched decode steps (contiguous and paged) and
training steps under ``torch.profiler`` and reports, per phase: wall time
per call (host clock around the profiled calls, ended by a synchronize,
so it includes the profiler's own cost per op), device-busy time of the
same calls (sum of kernel times; one stream, so kernels do not overlap),
the idle share 1 - busy / wall, and device time by kernel group (K1
flash_fwd, K2 decode_fused_append, K3 flash_bwd_q, K4 flash_bwd_kv, K5
decode_attend, K6 paged_decode, K7 gemm, K8 int4_matmul, the indexed
writes of the paged append with the step's one embedding gather, the
library's matrix products, the rest). The top kernels go to
``<out>/profile_<phase>.txt``.

Serving runs Llama-3-8B at full depth; training runs its widths at 16
of 32 layers (the AdamW state of all 32 would not fit 80 GB). The paged
phase times whole ``PagedScheduler.step()`` calls (host allocator, table
upload, decode, sampling) with 8 slots, beside the contiguous decode
step at the same batch. The int4 phase serves Llama-3-8B with INT4
weight-only projections (K8) and an FP8-e4m3 KV cache: a 2048-token
prefill and decode steps at 4 slots.

``--model openllama_3b`` serves OpenLLaMA-3B instead (26 layers, width
3200, 32 heads of head dim 100, MHA: K1 on its wgmma row with the copying
producer; K2 over bf16, INT8 and FP8 caches and K6 over bf16 and INT8
pages on the tensor-core pair, rows padded to 128 values), for the
serving and paged phases, and trains it at its full depth (K1, K3 and K4
on their wgmma rows with the copying producers).

Run on a GPU from the repository root:

    python -m mfa_tpu_torch.utils.profiling [--out build/profiles]
        [--phases serving,paged,training,int4]
        [--model llama3_8b|openllama_3b]

``mfa_tpu/utils/profiling.py``'s tools, :func:`trace` (a Chrome trace),
:class:`Metrics` and its module-level ``metrics``, live in
``utils/tracing.py`` and are imported back here.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from mfa_tpu_torch.kernels import flash_bwd as k34
from mfa_tpu_torch.models import training
from mfa_tpu_torch.models.llama import Llama, LlamaConfig
from mfa_tpu_torch.ops.precision import OperandPrecision
from mfa_tpu_torch.serving.paged_scheduler import PagedScheduler
from mfa_tpu_torch.serving.scheduler import Request
from mfa_tpu_torch.utils.tracing import (  # noqa: F401
    TRACE_DIR,
    Metrics,
    metrics,
    trace,
)

# The served configurations: Llama-3-8B, and OpenLLaMA-3B as its
# published config.json reads (openlm-research/open_llama_3b).
MODELS = {
    "llama3_8b": LlamaConfig.llama3_8b(),
    "openllama_3b": LlamaConfig(vocab_size=32000, dim=3200, n_layers=26,
                                n_heads=32, n_kv_heads=32, ffn_hidden=8640,
                                rope_theta=10000.0, norm_eps=1e-6),
}


# The depth training runs each model at: Llama-3-8B's widths at 16 of
# its 32 layers (see the module note), OpenLLaMA-3B whole (3.43 B
# parameters, 8 bytes each with grads and AdamW's moments: ~27 GiB).
TRAIN_LAYERS = {"llama3_8b": 16, "openllama_3b": 26}

_GROUPS = (("flash_fwd", ("flash_fwd",)),
           ("flash_bwd_q", ("flash_bwd_q",)),
           ("flash_bwd_kv", ("flash_bwd_kv",)),
           # K2, K5 and K6 are one template, told apart by its row
           # functor, which all their kernels (decode_score, decode_attend,
           # K2's decode_pmax) carry.
           ("decode_fused_append", ("FusedRows",)),
           ("paged_decode", ("PagedRows",)),
           ("decode_attend", ("ContiguousRows",)),
           ("scatter_append", ("index_elementwise", "index_put",
                               "scatter_gather")),
           # K7 and K8 before "matmul": its patterns would swallow
           # "mfa_gemm", and the first match wins.
           ("gemm_kernel", ("mfa_gemm",)),
           ("int4_matmul", ("qmm_int4",)),
           ("matmul", ("gemm", "gemv", "cutlass", "xmma", "nvjet", "sm90_")))


def _device_us(evt) -> float:
    t = getattr(evt, "self_device_time_total", None)
    return float(t if t is not None else evt.self_cuda_time_total)


def _summarize(prof, wall_ms: float, calls: int, name: str, out: Path):
    # Kernels only: an operator's row repeats the device time of the
    # kernels it launched.
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and _device_us(e) > 0]
    groups = {g: 0.0 for g, _ in _GROUPS}
    groups["other"] = 0.0
    for e in events:
        key = next((g for g, pats in _GROUPS
                    if any(p in e.key for p in pats)), "other")
        groups[key] += _device_us(e) / 1e3 / calls
    busy = sum(groups.values())
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=30)
    (out / f"profile_{name}.txt").write_text(table)
    return {"phase": name, "wall_ms": wall_ms, "busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms if wall_ms > 0 else None,
            "device_ms_by_group": groups}


def _profiled(fn, calls: int):
    """Profile ``calls`` calls of fn; return the profile and the wall ms
    per call of those same calls."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    return prof, wall_ms


def profile_serving(cfg: LlamaConfig, *, out: Path, batch: int = 4,
                    fill: int = 1024, prompts=(512, 2048), steps: int = 8,
                    seed: int = 0) -> list[dict]:
    """Prefill (bf16 cache) at each prompt length, then batched decode
    steps over a cache filled to ``fill`` for each KV format."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = Llama.init(cfg, generator=gen, dtype=torch.bfloat16,
                       device="cuda")
    rng = np.random.default_rng(seed)
    results = []

    for n in prompts:
        toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (1, n))).cuda()

        def prefill():
            model(toks, caches=model.make_caches(1, 2048))

        prefill()
        prof, wall = _profiled(prefill, 1)
        results.append(_summarize(prof, wall, 1, f"prefill_{n}", out))

    fill_tokens = torch.from_numpy(
        rng.integers(1, cfg.vocab_size, (batch, fill))).cuda()
    last = torch.from_numpy(rng.integers(1, cfg.vocab_size, batch)).cuda()
    for kv in (OperandPrecision.BF16, OperandPrecision.INT8,
               OperandPrecision.FP8_E4M3):
        caches = model.make_caches(batch, 2048, kv)
        model(fill_tokens, caches=caches)

        def decode():
            model.decode_step(last, caches)

        decode()
        prof, wall = _profiled(decode, steps)
        results.append(_summarize(
            prof, wall, steps, f"decode_b{batch}_ctx{fill}_{kv.value}", out))
        del caches
    return results


def profile_paged(cfg: LlamaConfig, *, out: Path, slots: int = 8,
                  fill: int = 1024, steps: int = 8, page_size: int = 512,
                  seed: int = 0) -> list[dict]:
    """Whole paged-scheduler steps with every slot holding a ``fill``-token
    prompt, for each KV format; then the contiguous decode step at the
    same batch and context (bf16 KV) for comparison."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = Llama.init(cfg, generator=gen, dtype=torch.bfloat16,
                       device="cuda")
    rng = np.random.default_rng(seed)
    prompts = rng.integers(1, cfg.vocab_size, (slots, fill))
    # Pages for every slot's prompt and the steps' tokens, and the null
    # page; no request finishes inside the profiled window.
    pages = slots * -(-(fill + steps + 4) // page_size) + 1
    results = []
    for kv in (OperandPrecision.BF16, OperandPrecision.INT8,
               OperandPrecision.FP8_E4M3):
        sched = PagedScheduler(model, num_slots=slots, num_pages=pages,
                               page_size=page_size, max_len=2048,
                               kv_precision=kv, device="cuda")
        for p in prompts:
            sched.submit(Request(prompt=p.tolist(),
                                 max_new_tokens=steps + 4))
        sched.step()            # admits every slot and decodes once
        sched.step()
        prof, wall = _profiled(sched.step, steps)
        results.append(_summarize(
            prof, wall, steps, f"paged_step_s{slots}_ctx{fill}_{kv.value}",
            out))
        del sched

    caches = model.make_caches(slots, 2048)
    model(torch.from_numpy(prompts).cuda(), caches=caches)
    last = torch.from_numpy(rng.integers(1, cfg.vocab_size, slots)).cuda()

    def decode():
        model.decode_step(last, caches)

    decode()
    prof, wall = _profiled(decode, steps)
    results.append(_summarize(prof, wall, steps,
                              f"decode_b{slots}_ctx{fill}_bf16", out))
    return results


def profile_int4(cfg: LlamaConfig, *, out: Path, batch: int = 4,
                 fill: int = 1024, prompt: int = 2048, steps: int = 8,
                 seed: int = 0) -> list[dict]:
    """The INT4-weight model (random weights, quantized as drawn): one
    prompt-length prefill, then batched decode steps over an FP8-e4m3
    cache filled to ``fill``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = Llama.init(cfg, generator=gen, dtype=torch.bfloat16,
                       device="cuda", weight_precision=OperandPrecision.INT4)
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                         (1, prompt))).cuda()

    def prefill():
        model(toks, caches=model.make_caches(1, 2048,
                                             OperandPrecision.FP8_E4M3))

    prefill()
    prof, wall = _profiled(prefill, 1)
    results = [_summarize(prof, wall, 1, f"int4_prefill_{prompt}", out)]
    caches = model.make_caches(batch, 2048, OperandPrecision.FP8_E4M3)
    model(torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                        (batch, fill))).cuda(), caches=caches)
    last = torch.from_numpy(rng.integers(1, cfg.vocab_size, batch)).cuda()

    def decode():
        model.decode_step(last, caches)

    decode()
    prof, wall = _profiled(decode, steps)
    results.append(_summarize(prof, wall, steps,
                              f"int4_decode_b{batch}_ctx{fill}_fp8_e4m3",
                              out))
    return results


def profile_training(cfg: LlamaConfig, *, out: Path, seq_len: int = 2048,
                     steps: int = 3, seed: int = 0) -> list[dict]:
    """Training steps (bf16 weights, AdamW) on one random batch of
    1 x (seq_len + 1) tokens; the first step is a warm-up. The row
    carries the rows K3 and K4 ran (``k34_rows``: row_label, launches)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = Llama.init(cfg, generator=gen, dtype=torch.bfloat16,
                       device="cuda", trainable=True)
    state = training.create_train_state(
        model, training.make_optimizer(lr=1e-3, warmup_steps=1,
                                       total_steps=100))
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(
        rng.integers(1, cfg.vocab_size, (1, seq_len + 1))).cuda()

    def step():
        training.train_step(state, toks)

    before = {name: dict(c) for name, c in k34.launches_by_row.items()}
    step()
    prof, wall = _profiled(step, steps)
    rows = {name: {label: n - was.get(label, 0)
                   for label, n in k34.launches_by_row[name].items()
                   if n != was.get(label, 0)}
            for name, was in before.items()}
    return [dict(_summarize(prof, wall, steps,
                            f"train_step_L{cfg.n_layers}_T{seq_len}", out),
                 k34_rows=rows)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profiles",
                    help="directory for the per-phase kernel tables")
    ap.add_argument("--phases", default="serving,paged,training,int4",
                    help="comma-separated: serving, paged, training, int4")
    ap.add_argument("--model", default="llama3_8b", choices=tuple(MODELS),
                    help="the served configuration")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA device")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    print(torch.cuda.get_device_name(0), flush=True)
    cfg = MODELS[args.model]
    runs = {"serving": lambda: profile_serving(cfg, out=out),
            "paged": lambda: profile_paged(cfg, out=out),
            "training": lambda: profile_training(
                dataclasses.replace(cfg, n_layers=TRAIN_LAYERS[args.model]),
                out=out),
            "int4": lambda: profile_int4(cfg, out=out)}
    for phase in args.phases.split(","):
        for row in runs[phase]():
            print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
