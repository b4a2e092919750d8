#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``mfa_tpu_torch``) on one GPU.

Phases, each printing one JSON line (any failure exits non-zero; no
phase's failure is caught):

1. device  — the card (nvidia-smi name and power limit), torch and CUDA
             versions; TF32 off for fp32 products.
2. build   — nvcc builds the kernel library from mfa_tpu_torch/csrc.
3. k1      — flash forward kernel against its plain version at Llama-3-8B
             prefill shapes (Hq=32, Hkv=8, D=128, N=2048): causal,
             non-causal, sliding window 512, soft-cap 50, R != C, fp32.
4. k2      — fused decode + append kernel against its plain version for
             bf16, INT8 and FP8-e4m3 caches (B=4, Hkv=8, G=4, D=128,
             max_len 2048 and 8192, lengths including 0 and max_len):
             O, appended rows, scales, and lengths after a step.
             O and L are held elementwise to
             mfa_tpu_torch.utils.testing.KERNEL_BUDGETS.
5. serving — Llama-3-8B at full width and depth with random bf16 weights
             behind the continuous-batching scheduler (4 slots, max_len
             2048), six greedy requests, once per KV format; launch
             counters prove K1 carried every prefill and K2 every decode.
6. kernels — one JSON line per the port's kernel table.

The last line is {"ok": true, "device": {...}}. Run from the repository
root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOPS = 989e12            # dense bf16 tensor cores
FP32_FLOPS = 67e12             # fp32 outside the tensor cores


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _bits(torch, t):
    """The raw bits of a 1- or 2-byte tensor, for exact comparison."""
    return t.view(torch.uint8 if t.element_size() == 1 else torch.int16)


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return smi


def phase_build():
    from mfa_tpu_torch.kernels import build

    lib = build.library()
    ptxas = [ln.strip() for ln in lib.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": round(lib.build_seconds, 3),
          "library": str(lib.path.name), "ptxas": ptxas[:24]})


def _k1_inputs(torch, gen, r, c, dtype, hq=32, hkv=8, d=128):
    def rnd(h, s):
        return torch.randn((1, h, s, d), generator=gen, device="cuda").to(dtype)
    return rnd(hq, r), rnd(hkv, c), rnd(hkv, c)


def phase_k1(torch):
    import torch.nn.functional as F

    from mfa_tpu_torch.kernels import flash_fwd as k1
    from mfa_tpu_torch.ops import params as params_mod
    from mfa_tpu_torch.ops.descriptors import (
        AttentionDescriptor,
        AttentionKernelType,
    )
    from mfa_tpu_torch.utils.testing import KERNEL_BUDGETS, budget_share

    gen = torch.Generator(device="cuda").manual_seed(1)
    dev = params_mod.detect_device(torch.device("cuda", 0))
    n = 2048
    cases = [
        ("causal", n, n, torch.bfloat16, dict(causal=True)),
        ("noncausal", n, n, torch.bfloat16, dict()),
        ("window512", n, n, torch.bfloat16, dict(sliding_window=512)),
        ("softcap50", n, n, torch.bfloat16,
         dict(causal=True, logit_soft_cap=50.0)),
        ("causal_r512_c2048", 512, n, torch.bfloat16, dict(causal=True)),
        ("fp32_causal", n, n, torch.float32, dict(causal=True)),
    ]
    results = {}
    for name, r, c, dtype, opts in cases:
        q, k, v = _k1_inputs(torch, gen, r, c, dtype)
        desc = AttentionDescriptor(
            batch=1, num_q_heads=32, num_kv_heads=8, seq_len_q=r,
            seq_len_kv=c, head_dim=128, low_precision_inputs=dtype != torch.float32,
            low_precision_intermediates=dtype != torch.float32, **opts)
        kd = desc.kernel_descriptor(AttentionKernelType.FORWARD, dev)
        q3, k3, v3 = (t.reshape(-1, t.shape[2], 128).contiguous()
                      for t in (q, k, v))
        kw = dict(group=4, scale=desc.softmax_scale, o_dtype=dtype)
        o_k, l_k = k1.flash_fwd(q3, k3, v3, kd, **kw)
        torch.cuda.synchronize()
        o_p, l_p = k1.flash_fwd_plain(q3, k3, v3, kd, **kw)
        # Elementwise budgets against the plain version (not the looser
        # budgets the CPU tests hold the port to against mfa_tpu).
        budget_o = KERNEL_BUDGETS["flash_fwd_o_" + (
            "bf16" if dtype == torch.bfloat16 else "fp32")]
        budget_l = KERNEL_BUDGETS["flash_fwd_l"]
        err_o, err_l = max_err(o_k, o_p), max_err(l_k, l_p)
        share_o = budget_share(o_k, o_p, *budget_o)
        share_l = budget_share(l_k, l_p, *budget_l)
        o_rms = float(o_p.float().square().mean().sqrt())
        ok = (torch.isfinite(o_k.float()).all().item() and share_o <= 1
              and share_l <= 1)
        ms = cuda_ms(torch, lambda: k1.flash_fwd(q3, k3, v3, kd, **kw))
        plain_ms = cuda_ms(torch, lambda: k1.flash_fwd_plain(
            q3, k3, v3, kd, **kw), iters=3, warmup=1)
        # Visible (row, key) pairs of this problem = the work K1 must do.
        vis = k1.visible_mask(r, c, kd.causal, kd.sliding_window, "cuda")
        pairs = int(vis.sum()) * 32
        flops = 4 * 128 * pairs
        nbytes = (q3.numel() + k3.numel() + v3.numel() + q3.numel()) \
            * q3.element_size() + 4 * 32 * r
        peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
        t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        # Yardstick only: one PyTorch call for the same function where
        # there is one (no soft-cap in SDPA).
        library_ms = None
        if "logit_soft_cap" not in opts:
            plain_causal = kd.causal and r == c and not kd.sliding_window
            mask = (None if plain_causal or not (kd.causal or kd.sliding_window)
                    else vis)
            library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=plain_causal,
                scale=desc.softmax_scale, enable_gqa=True), iters=10)
        results[name] = dict(
            max_abs_err=err_o, lse_err=err_l, ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=library_ms)
        emit({"phase": "k1", "case": name, "R": r, "C": c,
              "dtype": str(dtype).split(".")[-1], "err_o": err_o,
              "o_rms": o_rms, "budget_o": budget_o, "share_o": share_o,
              "err_l": err_l, "budget_l": budget_l, "share_l": share_l,
              "ok": bool(ok),
              **{k_: v_ for k_, v_ in results[name].items()
                 if k_ not in ("max_abs_err",)}})
        if not ok:
            raise SystemExit(f"k1 {name}: kernel disagrees with its plain "
                             f"version (O uses {share_o} of |d| <= "
                             f"{budget_o[0]} + {budget_o[1]}|O|, L uses "
                             f"{share_l} of {budget_l[0]})")
    return results["causal"]


def phase_k2(torch):
    from mfa_tpu_torch.kernels import decode as k2
    from mfa_tpu_torch.ops.decode import decode_attention_append
    from mfa_tpu_torch.ops.precision import OperandPrecision
    from mfa_tpu_torch.serving import kv_cache
    from mfa_tpu_torch.utils.testing import KERNEL_BUDGETS, budget_share

    gen = torch.Generator(device="cuda").manual_seed(2)
    b, hkv, g, d = 4, 8, 4, 128
    bh = b * hkv
    budget = KERNEL_BUDGETS["decode_o"]
    formats = [("bf16", OperandPrecision.BF16),
               ("int8", OperandPrecision.INT8),
               ("fp8_e4m3", OperandPrecision.FP8_E4M3)]
    results = {}
    for max_len in (2048, 8192):
        for name, prec in formats:
            cache = kv_cache.create(b, hkv, max_len, d, prec, device="cuda")
            fill = torch.randn((b, hkv, max_len, d), generator=gen,
                               device="cuda")
            kv_cache.update(cache, fill, torch.randn(
                (b, hkv, max_len, d), generator=gen, device="cuda"))
            lens = [0, 777, max_len - 1, max_len]
            cache.lengths = torch.tensor(lens, dtype=torch.int32,
                                         device="cuda")
            q3 = (torch.randn((bh, g, d), generator=gen, device="cuda")
                  * (math.log2(math.e) / math.sqrt(d))).bfloat16()
            kn = (torch.randn((bh, d), generator=gen, device="cuda") * 0.5
                  ).bfloat16()
            vn = (torch.randn((bh, d), generator=gen, device="cuda") * 0.5
                  ).bfloat16()

            def views(c):
                return (c.k.view(bh, max_len, d), c.v.view(bh, max_len, d),
                        c.k_scale.view(bh, max_len),
                        c.v_scale.view(bh, max_len))

            plain_cache = kv_cache.KVCache(
                cache.k.clone(), cache.v.clone(), cache.k_scale.clone(),
                cache.v_scale.clone(), cache.lengths.clone(), prec)
            o_k = k2.decode_fused_append(q3, *views(cache), kn, vn,
                                         cache.lengths, num_kv_heads=hkv)
            torch.cuda.synchronize()
            o_p = k2.decode_fused_append_plain(
                q3, *views(plain_cache), kn, vn, plain_cache.lengths,
                num_kv_heads=hkv)
            err = max_err(o_k, o_p)
            share = budget_share(o_k, o_p, *budget)
            o_rms = float(o_p.float().square().mean().sqrt())
            same_rows = all(torch.equal(_bits(torch, getattr(cache, f)),
                                        _bits(torch, getattr(plain_cache, f)))
                            for f in ("k", "v"))
            scale_err = max(
                float(((getattr(cache, f) - getattr(plain_cache, f)).abs()
                       / getattr(plain_cache, f).abs()).max())
                for f in ("k_scale", "v_scale"))
            ms = cuda_ms(torch, lambda: k2.decode_fused_append(
                q3, *views(cache), kn, vn, cache.lengths, num_kv_heads=hkv),
                iters=50)
            plain_ms = cuda_ms(torch, lambda: k2.decode_fused_append_plain(
                q3, *views(plain_cache), kn, vn, plain_cache.lengths,
                num_kv_heads=hkv), iters=5, warmup=1)
            # Lengths after a step through the entry point: each
            # advances by one, capped at max_len.
            decode_attention_append(
                q3.reshape(b, hkv * g, d), kn.view(b, hkv, d),
                vn.view(b, hkv, d), cache, device="cuda")
            lengths_after = cache.lengths.tolist()
            lengths_ok = lengths_after == [min(x + 1, max_len) for x in lens]
            ok = (bool(torch.isfinite(o_k.float()).all()) and share <= 1
                  and same_rows and scale_err <= 1e-6 and lengths_ok)
            # Bytes K2 must move for these lengths: the live K and V rows
            # (with their scales for a quantized cache; a bf16 cache's
            # scales are never read), q, k_new, v_new, O, and the appended
            # rows.
            live = sum(min(x, max_len) for x in lens) * hkv
            itemsize = cache.k.element_size()
            row_bytes = d * itemsize + (4 if itemsize == 1 else 0)
            appended = sum(1 for x in lens if x < max_len) * hkv
            nbytes = (2 * live * row_bytes + 2 * bh * g * d * 2
                      + 2 * bh * d * 2 + 2 * appended * row_bytes)
            flops = 4 * g * d * (live + bh)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / BF16_FLOPS * 1e3
            key = f"{name}_L{max_len}"
            results[key] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)
            emit({"phase": "k2", "case": key, "lengths": lens, "err_o": err,
                  "o_rms": o_rms, "budget_o": budget, "share_o": share,
                  "appended_rows_equal": same_rows,
                  "lengths_after": lengths_after,
                  "scale_rel_err": scale_err, "ok": ok,
                  **{k_: v_ for k_, v_ in results[key].items()
                     if k_ != "max_abs_err"}})
            if not ok:
                raise SystemExit(f"k2 {key}: kernel disagrees with its plain "
                                 f"version (O uses {share} of |d| <= "
                                 f"{budget[0]} + {budget[1]}|O|, rows equal "
                                 f"{same_rows}, scale err {scale_err}, "
                                 f"lengths after {lengths_after})")
            del cache, plain_cache, fill
    return results["bf16_L2048"]


def _plain_attention(torch):
    """flash_attention computed through K1's plain version (for the
    in-context check)."""
    from mfa_tpu_torch.kernels import flash_fwd as k1
    from mfa_tpu_torch.ops.descriptors import (
        AttentionDescriptor,
        AttentionKernelType,
    )

    def attention(q, k, v, *, causal, sliding_window, device):
        b, hq, r, d = q.shape
        hkv, c = k.shape[1], k.shape[2]
        desc = AttentionDescriptor(
            batch=b, num_q_heads=hq, num_kv_heads=hkv, seq_len_q=r,
            seq_len_kv=c, head_dim=d, causal=causal,
            sliding_window=sliding_window, low_precision_inputs=True,
            low_precision_intermediates=True)
        kd = desc.kernel_descriptor(AttentionKernelType.FORWARD)
        o, _ = k1.flash_fwd_plain(
            q.reshape(b * hq, r, d), k.reshape(b * hkv, c, d),
            v.reshape(b * hkv, c, d), kd, group=hq // hkv,
            scale=desc.softmax_scale, o_dtype=q.dtype)
        return o.reshape(b, hq, r, d)

    return attention


def phase_serving(torch):
    import numpy as np

    from mfa_tpu_torch.kernels import decode as k2
    from mfa_tpu_torch.kernels import flash_fwd as k1
    from mfa_tpu_torch.models import llama
    from mfa_tpu_torch.ops.precision import OperandPrecision
    from mfa_tpu_torch.serving.scheduler import (
        ContinuousBatchingScheduler,
        Request,
    )

    cfg = llama.LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    model = llama.Llama.init(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    emit({"phase": "serving_init", "seconds": time.perf_counter() - t0,
          "params": sum(p.numel() for p in model.parameters()),
          "gib": torch.cuda.memory_allocated() / 2**30})

    rng = np.random.default_rng(0)
    prompt_lens = (50, 120, 250, 500, 1000, 1900)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in prompt_lens]

    # Prefill time per bucket (bf16 cache), outside the counted runs.
    prefill_ms = {}
    for bucket in (64, 128, 256, 512, 1024, 2048):
        toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, bucket)).cuda()

        def run():
            model(toks[None, :], caches=model.make_caches(1, 2048))

        t_ms = cuda_ms(torch, run, iters=3, warmup=1)
        prefill_ms[bucket] = t_ms
    emit({"phase": "prefill", "ms_per_bucket": prefill_ms})

    # In-context check of K1: last-position logits of the 1900-token prompt
    # through K1 and through its plain version.
    toks = torch.tensor(prompts[-1], device="cuda")[None, :]
    logits_k = model(toks)[0, -1]
    real_attention = llama.flash_attention
    llama.flash_attention = _plain_attention(torch)
    logits_p = model(toks)[0, -1]
    llama.flash_attention = real_attention
    scale = float(logits_p.abs().max())
    err = max_err(logits_k, logits_p)
    budget = 5e-2 * max(1.0, scale)      # bf16 mixed budget, relative
    emit({"phase": "k1_in_context", "max_abs_err": err, "budget": budget,
          "max_abs_logit": scale,
          "argmax_equal": bool(logits_k.argmax() == logits_p.argmax())})
    if not err <= budget:
        raise SystemExit(f"k1 in context: logits differ by {err} > {budget}")

    launches = {"flash_fwd": 0, "decode_fused_append": 0}
    summary = {}
    for name, prec in (("bf16", OperandPrecision.BF16),
                       ("int8", OperandPrecision.INT8),
                       ("fp8_e4m3", OperandPrecision.FP8_E4M3)):
        sched = ContinuousBatchingScheduler(
            model, num_slots=4, max_len=2048, kv_precision=prec,
            device="cuda")
        reqs = [Request(prompt=p, max_new_tokens=16) for p in prompts]
        for r in reqs:
            sched.submit(r)
        torch.cuda.synchronize()
        k1.flash_fwd.launches = 0
        k2.decode_fused_append.launches = 0
        step_ms, decode_only = [], []
        t_run = time.perf_counter()
        while True:
            pre = sched.stats["prefills"]
            t_s = time.perf_counter()
            progressed = sched.step()
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t_s) * 1e3
            if not progressed and not sched.queue:
                break
            step_ms.append(dt)
            if sched.stats["prefills"] == pre:
                decode_only.append(dt)
        sched._retire()
        run_s = time.perf_counter() - t_run
        n1, n2 = k1.flash_fwd.launches, k2.decode_fused_append.launches
        done = {c.request.id: c for c in sched.finished}
        stats = dict(sched.stats)
        ok = (len(done) == len(reqs)
              and all(len(done[r.id].tokens) == 16 for r in reqs)
              and n1 == cfg.n_layers * stats["prefills"]
              and n2 == cfg.n_layers * stats["decode_steps"]
              and stats["prefills"] == len(reqs))
        launches["flash_fwd"] += n1
        launches["decode_fused_append"] += n2
        decode_ms = float(np.median(decode_only)) if decode_only else None
        summary[name] = dict(
            completions=len(done), tokens=stats["tokens"],
            prefills=stats["prefills"], decode_steps=stats["decode_steps"],
            k1_launches=n1, k2_launches=n2, run_s=run_s,
            decode_ms_per_step=decode_ms,
            tokens_per_s=stats["tokens"] / run_s,
            first_tokens=done[reqs[0].id].tokens[:4])
        emit({"phase": "serving", "kv": name, "ok": ok, **summary[name]})
        if not ok:
            raise SystemExit(f"serving {name}: completions or launch counts "
                             f"wrong ({summary[name]})")
        del sched
        torch.cuda.empty_cache()
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "mfa_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: mfa_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))

    phase_device(torch)
    phase_build()
    k1_row = phase_k1(torch)
    k2_row = phase_k2(torch)
    launches = phase_serving(torch)
    kernels = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "mfa_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "mfa_tpu/kernels/flash_fwd.py:349",
         "launches": launches["flash_fwd"],
         **{k: v for k, v in k1_row.items() if k != "lse_err"}},
        {"name": "decode_fused_append", "route": "cuda",
         "source": "mfa_tpu_torch/csrc/decode.cu",
         "replaces": "mfa_tpu/kernels/decode.py:431",
         "launches": launches["decode_fused_append"], **k2_row},
    ]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
