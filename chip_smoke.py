#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``mfa_tpu_torch``) on one GPU.

Phases, each printing one JSON line (any failure exits non-zero; no
phase's failure is caught):

1. device  — the card (nvidia-smi name and power limit), torch and CUDA
             versions; TF32 off for fp32 products.
2. build   — nvcc builds the kernel library from mfa_tpu_torch/csrc.
3. k1      — flash forward kernel against its plain version at Llama-3-8B
             prefill shapes (Hq=32, Hkv=8, D=128, N=2048): causal,
             non-causal, sliding window 512, soft-cap 50, R != C, fp32,
             and causal at the prefill buckets R = C = 64 and 512; then
             Qwen2-7B's heads (Hq 28, Hkv 4) causal at N 2048 and
             Mistral-7B's causal window of 4096 at N 8192; then
             OpenLLaMA-3B's attention (D 100, Hq = Hkv 32: rows TMA
             cannot map, the wgmma kernel's cp.async producer) causal at
             N 2048 and 512 and non-causal at 2048, K1 at each of
             HEAD_DIM_CASES (N 2048, causal, Hkv 8), Llama-3-8B's
             shape with q's base 8, 4 and 2 bytes off 16, and the
             mma.sync row past D 128 (D 250 with q 2 bytes off 16, odd
             D 251; H 8, N 1024, causal); each line
             names the parameter row that ran (row_label, checked: bf16
             wgmma, "/copy" where the copying producer ran), its ring
             depth and ping-pong, with ms, bound and SDPA's ms and
             backend, outputs prefilled with NaN, a second launch bit
             for bit equal to the first.
4. k2      — fused decode + append kernel against its plain version for
             bf16, INT8, FP8-e4m3 and FP8-e5m2 caches (B=4, Hkv=8, G=4,
             D=128, max_len 2048 and 8192, lengths including 0 and
             max_len), INT8 at G=16 (two query chunks) under a
             window of 512, Qwen2-7B's G=7 (B 4, Hkv 4) in bf16 and
             FP8-e4m3 at 2048, and a window of 4096 at 8192 in bf16
             (Mistral-7B): O, appended rows, scales, and lengths after a
             step. O is held elementwise to
             mfa_tpu_torch.utils.testing.KERNEL_BUDGETS. Each line
             carries the split-KV launch, as in k5. Then the head dims
             past 8 * 2^k (HEAD_DIM_CASES: D 80, 96, 100, 250, 384, 192,
             256, 512 and 300 with G 4, 8, 1, 4, 8, 8, 4, 1, 4) over the
             four storage types at L 2048, D 100 under a window of 512,
             odd D 99 (bf16 and int8, G 1) and 385 (all four, G 8): each
             line with its launch count, bound and (bf16) SDPA's ms and
             backend, and the path its launch took (the wrapper's
             launches_by_path, held to ops/params.py::decode_path and to
             REQUIRED_PATHS: the tensor-core pair at D 80-512 over every
             storage type where rows and bases share 4 bytes, FMA at odd
             D and D 250 over 1-byte storage); every case
             then launches twice more into NaN-filled outputs, the first
             held to its plain version, the second bit-equal to it.
             Then K2's output bits over int8 on fixed inputs (k2_bits)
             against K2_INT8_DIGESTS, those of the FMA pair, each case
             on the tensor-core pair.
5. k5      — unfused decode kernel through its entry point
             ops.decode.decode_attention, after kv_cache.update, against
             the same call with its plain version, for the four storage
             types at max_len 2048 and 8192 (lengths 0, 777, L-1, L) and
             one window-512 case; SDPA timed as a yardstick for bf16. Each
             line carries the split-KV launch: rows a split R, splits S,
             CTAs a pass and those with live rows. Then K5's output
             bits on fixed inputs (k5_bits) against K5_DIGESTS (fp32 q:
             those of the K5 before K2 shared its body; bf16 q: those of
             the tensor-core pair) and each case's path (bf16 q on the
             pair, fp32 q on FMA). The head-dim cases as in
             k2, and D 100 with the cache 4 bytes off 16 (the
             tensor-core pair's copy granule 4).
6. k6      — paged decode kernel against its plain version: 8 sequences
             (lengths 0-2048) over a pool with shuffled page ids, pages of
             128 and 512 tokens, the four storage types and a window; bit
             for bit equal to K5 on the same rows, its time beside K5's;
             the split-KV launch as in k5. The head-dim cases as in k2,
             on 512-token pages.
7. k7     — GEMM kernel through its entry point ops.gemm.gemm against
             the same call with its plain version, elementwise: bf16
             4096^3, fp32 1536^3 with C0, the four transpose states and
             C0 at 1536^3 bf16, batched 3 x [200 x 129 x 127], ragged 7,
             127, 129, 200, a strided slice; each line names the tile
             that ran and its path (wgmma, or mma.sync where TMA cannot
             map the operands) and its TFLOP/s; torch.matmul as a
             yardstick.
8. k8     — INT4 matmul kernel, signed and biased, against its plain
             version at Llama-3-8B's four projection shapes (K -> N
             4096 -> 4096, 1024, 14336 and 14336 -> 4096), M = 4 and 16
             (decode, the split-K tiles: each line carries its split of K
             and its CTAs) and 2048 (prefill, the wgmma tile) in bf16,
             plus one fp32 case, and signed at Qwen2-7B's four (3584 ->
             3584, 512, 18944 and 18944 -> 3584) at M = 4 and 2048;
             F.linear on the dequantized bf16 weight as a yardstick.
9. serving — Llama-3-8B at full width and depth with random bf16 weights
             behind the continuous-batching scheduler (4 slots, max_len
             2048), six greedy requests, once per KV format; launch
             counters prove K1 carried every prefill and K2 every decode;
             the 1900-token prompt's last logits through K1 (each launch
             held to its plain version at KERNEL_BUDGETS) against the
             same forward through the plain version. Then the bf16 run
             once more under MFA_AUTOTUNE (serving_autotune): one search
             of K1's candidate rows a prefill bucket, the memo after
             that, every K1 and K2 launch outside the searches held to
             its plain version, K1 on every prefill and K2 on every
             decode step, the winners and whether the tokens equal the
             untuned run's (they need not: another row rounds
             differently); the autotune is off again after it.
10. paged_serving — the same model behind the paged scheduler (8 slots,
             512-token pages, a pool too small for all requests at once),
             the six prompts twice, 16 greedy tokens each, once per KV
             format; counters prove K1 carried every prefill and K6 every
             decode (K2 none); pages all return; one step's logits through
             K6 against the same step through its plain version.
10b. parallel — the parallel layer on one card (mfa_tpu_torch/parallel):
             a world-1 NCCL mesh (make_mesh, file rendezvous under
             build/); the served Llama-3-8B sharded at tp = 1 (its own
             tensors, no second copy), a 512-token forward and a 2 x 256
             prefill with four greedy decode steps through the NCCL group,
             bit-equal to the same calls with tp_group=None; the sp = 4
             ring schedule at Llama-3-8B's attention width (Hq 32, Hkv 8,
             D 128, bf16, S 32768 in chunks of 8192), causal and not,
             every (rank, step) in this process through the module's
             per-step functions, forward and backward: O, dQ, dK, dV
             against the same schedule over the plain versions at
             KERNEL_BUDGETS and against full-sequence flash_attention and
             its backward within 5e-2 (relative above 1);
             make_ring_attention at sp = 1
             through the NCCL group bit-equal to flash_attention (with_lse
             O, and the gradients); ms of a ring step and of the
             full-sequence K1, NCCL init seconds; counters prove K1's
             non-causal mode, K3, K4 and K2 ran.
11. int4_serving — the same model quantized (quantize_params) to INT4
             weight-only projections, behind the continuous-batching
             scheduler (4 slots, max_len 2048, FP8-e4m3 KV), six greedy
             requests of 16 tokens; counters prove K8 carried all 7
             projections of every layer in every prefill and decode step;
             a prefill and one decode step with every K1, K2 and K8
             launch held to its plain version at KERNEL_BUDGETS, the
             step's logits against the same step through the plain
             versions; one short request with INT8 weights (the plain
             INT8 branch).
12. bwd    — backward kernels K3 (dQ, D-term) and K4 (dK, dV) against
             their plain versions at Llama-3-8B attention shapes: causal,
             non-causal, sliding window 512, soft-cap 50, R=512 with
             C=2048, window 512 with R=512 and C=2048 (keys no query
             sees), fp32 causal; then where TMA cannot map a row (the
             wgmma kernels' copying producers): OpenLLaMA-3B's attention
             (D 100, Hq = Hkv 32, N 2048) causal and non-causal, D 250
             (H 8, N 1024) causal on one CTA of the head-dim-split
             kernels, and D 100 with q 2 bytes off 16 (the mma.sync
             rows); elementwise at KERNEL_BUDGETS, outputs prefilled with
             NaN, K4 bit-reproducible; the backward of torch's
             scaled_dot_product_attention timed as a yardstick; each line
             names the parameter row K3 and K4 ran (row_label, checked:
             wgmma, "/copy" where the copying producer ran, mma.sync;
             ops/params.py) with ms and bound.
13. large_d — K1, K3 and K4 past D = 128 (ops/params.py: the
             head-dim-split kernels, wgmma_dblk, where TMA maps a bf16 row
             up to D = 512: one CTA up to D = 256, clusters of two CTAs
             past it; the rest on the D-blocked first cut) at the JAX
             package's large-D class (bf16, B 1, Hq 8, N 4096): D 384 and
             512, causal and non-causal, GQA (Hkv 2), window 512 with
             soft-cap 50 (K1 only); the tails D 320 (a part-empty last
             panel), D 300 and D 250 (no TMA-mappable rows: the first
             cut, D-blocked past 256; K1, K3 and K4 on one CTA with their
             cp.async producers at 250) and fp32 at D 384,
             N 1024; D 256 causal and non-causal and D 192 causal at N
             4096, and D 256 as Gemma-2-9B runs it (causal, soft-cap 50,
             Hq / Hkv = 2; K1 only); each held elementwise to its plain
             version at
             KERNEL_BUDGETS, outputs prefilled with NaN, a second launch
             bit-equal, keys no query sees zero; each line names the
             rows that ran (checked against large_d_rows), with ms,
             bound and SDPA's time (and the backend that ran), and K3 +
             K4 ms beside SDPA's backward and their bound. Then
             flash_attention's forward and backward at D 384 (causal, N
             4096) against the same call through the plain versions,
             launch counters proving K1, K3 and K4 ran once each, all
             three on wgmma_dblk.
14. training— Llama-3-8B widths at 16 of 32 layers (AdamW state of all 32
             does not fit 80 GB), random bf16 weights, trainable: one
             step's loss and grads through K1/K3/K4 against the same with
             their plain versions, then six train_steps on one 1 x 2049
             batch from TokenDataset; finite, falling loss, and K1, K3, K4
             each launched n_layers times per step.
14b. openllama_training — OpenLLaMA-3B at full width and depth (26
             layers, width 3200, 32 heads of D 100, MHA; ~3.43 B
             parameters) from its published fields and random HF-named
             weights (seed 41) through params_from_hf(trainable=True),
             trained as phase 14 on one card: the in-context check, six
             steps with losses, grad norms, step ms, tokens/s and peak
             GiB; every K1, K3 and K4 launch on its wgmma row with the
             copying producer ("wgmma/copy", launches_by_row).
15. qwen2_serving — Qwen2-7B at full width and depth (28 layers, QKV
             bias, GQA group 7): its published config.json fields read by
             models/convert.config_from_hf as a namespace (equal to
             LlamaConfig.qwen2_7b()), random bf16 weights under Hugging
             Face's key names through params_from_hf; six greedy requests
             behind the continuous-batching scheduler (4 slots, max_len
             2048) over bf16 and FP8-e4m3 caches, then with INT4 weights
             over FP8 (K8 at Qwen2's projection shapes); counters prove K1
             carried every prefill, K2 every decode step and K8 all 7
             projections; before each run over bf16 and INT4, a prefill
             and one decode step with every K1, K2 and K8 launch held to
             its plain version at KERNEL_BUDGETS, and the step's logits
             against the same step through the plain versions.
16. checkpoint — that Qwen2 model cut to its first 4 layers (a depth
             cut), in bf16 and INT4, and an FP8-e4m3 cache after one
             prefill: utils/checkpoint.py saves them under build/, loads
             them into fresh templates, every tensor bit-equal; one greedy
             request from each restored model gives the tokens it gave
             before; bytes and seconds.
17. mistral_serving — Mistral-7B at full width and depth (32 layers,
             window 4096) from its published fields and random HF-named
             weights: the 6000-token prompt's last-position logits through
             K1 (each launch held to its plain version) against the plain
             version, one decode step past the window through K2 likewise,
             four greedy requests (200, 1000, 4500 and 6000 tokens; prompt
             buckets to 8192) over a bf16 cache of 8192.
18. evaluate — on that Mistral model, utils/evaluate.py's perplexity_full
             and kv_quantization_ppl_delta for INT8 and FP8-e4m3 caches
             (batch 2, 256 tokens, max_len 384), held to
             tests/test_aux.py's conditions; K1 and K2 launches counted.
19. openllama_serving — OpenLLaMA-3B at full width and depth (26
             layers, width 3200, 32 heads of head dim 100, MHA) from its
             published fields and random HF-named weights (seed 40): a
             prefill and one decode step in context (every K1, K2 launch
             held to its plain version), prefill ms at 512 and 2048, six
             greedy requests behind the continuous-batching scheduler
             (4 slots, max_len 2048) over bf16, INT8 and FP8-e4m3 caches
             (K1 every prefill, each launch's row noted: all on the
             wgmma kernel with its cp.async producer; K2 every decode
             step, each launch's path noted: the tensor-core pair over
             all three), then the paged flow of phase 10 over bf16 and
             INT8 (K6 every decode step, on the pair over both); decode
             ms a step, tokens/s, weight and cache GiB.
20. autotune — the C++ host config core (ops/native.py): its g++ build,
             the core equal to ops/params.py on every table with this
             card's device model and on K7's tile over a grid, the host
             bench's ns a call; the MFA_AUTOTUNE hooks: gemm at bf16
             1536^3 and 4096^3 and flash_attention's forward at
             Llama-3-8B's (Hq 32, Hkv 8, D 128) and OpenLLaMA-3B's (Hq =
             Hkv 32, D 100: the copying producer) prefill attention (N
             2048, causal), each searched once on its first call (its
             candidates timed, K7's launches counted), the memo's winner
             launched once by the second, bit-equal to the first and
             held to the plain version at KERNEL_BUDGETS, the winner
             beside the table row and torch.matmul; utils/autotune.py's
             tune_forward and tune_backward (both kernels) at Llama-3-8B's
             attention and tune_gemm at 1536^3, every candidate held to
             its plain version, the table row's ms beside the winner's.
             The autotune is off again after it.
21. kernels — one JSON line per the port's kernel table, the launches of
             phases 9-19 added up; K1, K2, K5 and K6 carry their head-dim
             rows, K3 and K4 theirs from phase 12 where TMA cannot map.

The last line is {"ok": true, "device": {...}}. Run from the repository
root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _bits(torch, t):
    """The raw bytes of a tensor, for exact comparison."""
    return t.detach().contiguous().view(torch.uint8)


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
    # ptxas's "wgmma.mma_async instructions are serialized" warnings: a
    # kernel whose products cannot overlap anything.
    serialized = sorted({ln.split("function '")[-1].rstrip("'")
                         for ln in lib.build_log.splitlines()
                         if "Performance Loss" in ln})
    # Registers and spills of each flash instance past D = 256 and of the
    # head-dim-split kernels: the D-blocked first cut and the cluster
    # kernels (last template argument, DBLK or CL, true), K3's and K4's
    # split kernels and K1's wgmma kernel (CL 0 or 1: one CTA up to D =
    # 256), as kernel<template arguments>.
    dblk, name = {}, None
    for ln in lib.build_log.splitlines():
        if "Compiling entry function" in ln:
            m = (re.search(r"\d(flash_[a-z_]+?_(?:bf16|f32|wgmma))I(\w*?)"
                           r"Lb1EEEv", ln)
                 or re.search(r"\d(flash_bwd_(?:kv|q)_split|flash_fwd_wgmma)"
                              r"I(\w*?)EEv", ln))
            args = re.findall(r"L[ib](\d+)E", m.group(2) + "E") if m else []
            name = f"{m.group(1)}<{','.join(args)}>" if m else None
        elif name and ("registers" in ln or "spill" in ln):
            dblk.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    emit({"phase": "build", "seconds": round(lib.build_seconds, 3),
          "library": str(lib.path.name), "ptxas": ptxas[:24],
          "ptxas_d_blocked": dblk, "wgmma_serialized": serialized,
          "ptxas_decode_512": decode_wide_ptxas(lib.build_log)})


def decode_wide_ptxas(log: str) -> dict:
    """Registers and spills of the decode kernels' 512-wide tensor-core
    instances (decode_score_mma / decode_attend_mma at DD 512, past D
    256), from nvcc's -Xptxas -v lines, as kernel<KVF,GC,Rows>: "regs
    N, spill S B" (S the bytes of spill stores and loads)."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"(decode_(?:score|attend)_mma)ILi(\d+)ELi(\d+)"
                          r"ELi512ELi\d+E\w*?(Contiguous|Fused|Paged)Rows",
                          ln)
            name = (f"{m.group(1)}<{m.group(2)},{m.group(3)},"
                    f"{m.group(4)}>" if m else None)
        elif name and "spill stores" in ln:
            n = [int(x) for x in re.findall(r"(\d+) bytes spill", ln)]
            out[name] = f"spill {sum(n)} B"
        elif name and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln)
            out[name] = (f"regs {regs.group(1) if regs else '?'}, "
                         + out.get(name, ""))
            name = None
    return out


def _k1_inputs(torch, gen, r, c, dtype, hq=32, hkv=8, d=128):
    def rnd(h, s):
        return torch.randn((1, h, s, d), generator=gen, device="cuda").to(dtype)
    return rnd(hq, r), rnd(hkv, c), rnd(hkv, c)


def k1_row(d: int, shift: int = 0) -> str:
    """The launch row (row_label) phase_k1 expects of a bf16 K1 launch at
    head dim d, its q base ``shift`` bytes off 16: TMA on the wgmma kernel
    (wgmma_dblk past D 128) where D % 8 == 0 and nothing is shifted; the
    same kernel with its cp.async producer where the rows and bases share
    4 bytes (D even, shifts of 4 or 8) and one CTA holds D (D <= 256);
    else the mma.sync rows (odd D, 2-byte shifts; mma_dblk past 256)."""
    kernel = "wgmma" if d <= 128 else "wgmma_dblk"
    if d % 8 == 0 and shift == 0:
        return kernel
    if d % 2 == 0 and shift % 4 == 0 and d <= 256:
        return f"{kernel}/copy"
    return "mma" if d <= 256 else "mma_dblk"


def _k1_case(torch, gen, name, r, c, dtype, opts, hq, hkv, d=128, shift=0,
             want_row=None):
    """One K1 case against its plain version: outputs prefilled with NaN,
    a second launch bit for bit equal, O and L at KERNEL_BUDGETS, the row
    that ran named (row_label) and checked against ``want_row``; ms,
    plain ms, bound and SDPA's ms and backend. q's base is ``shift`` bytes
    off its storage's. Fails on any disagreement; returns the timings."""
    import torch.nn.functional as F

    from mfa_tpu_torch.kernels import flash_fwd as k1
    from mfa_tpu_torch.ops import params as params_mod
    from mfa_tpu_torch.ops.descriptors import (
        AttentionDescriptor,
        AttentionKernelType,
        launch_row,
        row_label,
    )
    from mfa_tpu_torch.utils import roofline
    from mfa_tpu_torch.utils.testing import (
        KERNEL_BUDGETS,
        budget_share,
        nan_canary,
    )

    dev = params_mod.detect_device(torch.device("cuda", 0))
    q, k, v = _k1_inputs(torch, gen, r, c, dtype, hq, hkv, d)
    desc = AttentionDescriptor(
        batch=1, num_q_heads=hq, num_kv_heads=hkv, seq_len_q=r,
        seq_len_kv=c, head_dim=d,
        low_precision_inputs=dtype != torch.float32,
        low_precision_intermediates=dtype != torch.float32, **opts)
    kd = desc.kernel_descriptor(AttentionKernelType.FORWARD, dev)
    q3, k3, v3 = (t.reshape(-1, t.shape[2], d).contiguous()
                  for t in (q, k, v))
    if shift:
        buf = torch.empty(q3.numel() + 8, dtype=dtype, device="cuda")
        at = shift // q3.element_size()
        q3 = buf[at:at + q3.numel()].view(q3.shape)
        q3.copy_(q.reshape(q3.shape))
    kw = dict(group=hq // hkv, scale=desc.softmax_scale, o_dtype=dtype)
    # The parameter row the launch runs (ops/params.py), the tiles of its
    # K and V rings and ping-pong.
    row = launch_row(kd, d, (q3, k3, v3))
    wgmma = row.kernel in ("wgmma", "wgmma_dblk")
    row_info = dict(dataclasses.asdict(row), label=row_label(row), rings=(
        params_mod.fwd_rings(row) if wgmma else None),
        pingpong=params_mod.FWD_PINGPONG if wgmma else None)
    o_k, l_k = k1.flash_fwd(q3, k3, v3, kd, **kw, out=(
        nan_canary(q3.shape, dtype, device="cuda"),
        nan_canary(q3.shape[:2], device="cuda")))
    o_k2, l_k2 = k1.flash_fwd(q3, k3, v3, kd, **kw)
    deterministic = bool(torch.equal(o_k, o_k2) and torch.equal(l_k, l_k2))
    del o_k2, l_k2
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
    if want_row is None:
        want_row = k1_row(d, shift) if dtype == torch.bfloat16 else ""
    ok = (torch.isfinite(o_k.float()).all().item()
          and torch.isfinite(l_k).all().item() and deterministic
          and share_o <= 1
          and share_l <= 1
          and row_info["label"] == want_row)
    del o_k, l_k, o_p, l_p
    ms = roofline.cuda_ms(lambda: k1.flash_fwd(q3, k3, v3, kd, **kw))
    plain_ms = roofline.cuda_ms(lambda: k1.flash_fwd_plain(
        q3, k3, v3, kd, **kw), iters=3, warmup=1)
    # Visible (row, key) pairs of this problem = the work K1 must do.
    vis = k1.visible_mask(r, c, kd.causal, kd.sliding_window, "cuda")
    pairs = int(vis.sum()) * hq
    nbytes = (q3.numel() + k3.numel() + v3.numel() + q3.numel()) \
        * q3.element_size() + 4 * hq * r
    peak = (roofline.BF16_FLOPS if dtype == torch.bfloat16
            else roofline.FP32_FLOPS)
    bound_ms, bound_by = roofline.bound(4 * d * pairs, nbytes, peak)
    # Yardstick only: one PyTorch call for the same function where there
    # is one (no soft-cap in SDPA), and the backend that ran it.
    library_ms = backend = None
    if "logit_soft_cap" not in opts:
        plain_causal = kd.causal and r == c and not kd.sliding_window
        mask = (None if plain_causal or not (kd.causal or kd.sliding_window)
                else vis)

        def sdpa():
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=plain_causal,
                scale=desc.softmax_scale, enable_gqa=True)

        backend = _sdpa_backend(torch, sdpa)
        library_ms = roofline.cuda_ms(sdpa, iters=10)
    result = dict(
        max_abs_err=err_o, lse_err=err_l, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    emit({"phase": "k1", "case": name, "R": r, "C": c, "Hq": hq,
          "Hkv": hkv, "D": d, "q_shift_bytes": shift,
          "dtype": str(dtype).split(".")[-1], "row": row_info,
          "tflops": 4 * d * pairs / ms / 1e9, "err_o": err_o,
          "o_rms": o_rms, "budget_o": budget_o, "share_o": share_o,
          "deterministic": deterministic,
          "err_l": err_l, "budget_l": budget_l, "share_l": share_l,
          "sdpa_backend": backend, "ok": bool(ok),
          **{k_: v_ for k_, v_ in result.items()
             if k_ not in ("max_abs_err",)}})
    if not ok:
        raise SystemExit(f"k1 {name}: kernel disagrees with its plain "
                         f"version (O uses {share_o} of |d| <= "
                         f"{budget_o[0]} + {budget_o[1]}|O|, L uses "
                         f"{share_l} of {budget_l[0]}), ran row "
                         f"{row_info} (wanted {want_row}), deterministic "
                         f"{deterministic}")
    del q, k, v, q3, k3, v3, vis
    torch.cuda.empty_cache()
    return dict(result, row=row_info["label"])


# K1 at OpenLLaMA-3B's attention (head dim 100, 32 heads, MHA: rows TMA
# cannot map, the wgmma kernel's cp.async producer) at its prefill
# buckets, (name, N, options); then at each of HEAD_DIM_CASES (N 2048,
# causal, Hkv 8, Hq 8 G); Llama-3-8B's shape with q's base 8, 4 and 2
# bytes off 16 (the copying producer at 8 and 4, mma.sync at 2); and the
# mma.sync row past D 128 (B 1, H 8, N 1024, causal), (D, q shift in
# bytes): D 250 with q 2 bytes off 16, and odd D 251.
OPENLLAMA_K1_CASES = (("openllama_causal_n2048", 2048, dict(causal=True)),
                      ("openllama_causal_n512", 512, dict(causal=True)),
                      ("openllama_noncausal_n2048", 2048, dict()))
K1_SHIFTS = (8, 4, 2)
K1_MMA_PAST_128 = ((250, 2), (251, 0))


def phase_k1(torch):
    gen = torch.Generator(device="cuda").manual_seed(1)
    n = 2048
    bf16 = torch.bfloat16
    # (name, R, C, dtype, options, Hq, Hkv): Llama-3-8B's heads, then
    # Qwen2-7B's (a GQA group of 7) and Mistral-7B's window over an
    # 8192-token prompt.
    cases = [
        ("causal", n, n, bf16, dict(causal=True), 32, 8),
        ("noncausal", n, n, bf16, dict(), 32, 8),
        ("window512", n, n, bf16, dict(sliding_window=512), 32, 8),
        ("softcap50", n, n, bf16, dict(causal=True, logit_soft_cap=50.0),
         32, 8),
        ("causal_r512_c2048", 512, n, bf16, dict(causal=True), 32, 8),
        ("fp32_causal", n, n, torch.float32, dict(causal=True), 32, 8),
        # The server's smaller prefill buckets (serving/scheduler.py).
        ("causal_r64", 64, 64, bf16, dict(causal=True), 32, 8),
        ("causal_r512", 512, 512, bf16, dict(causal=True), 32, 8),
        ("qwen2_causal_hq28_hkv4", n, n, bf16, dict(causal=True), 28, 4),
        ("mistral_causal_window4096_n8192", 8192, 8192, bf16,
         dict(causal=True, sliding_window=4096), 32, 8),
    ]
    results = {}
    for name, r, c, dtype, opts, hq, hkv in cases:
        results[name] = _k1_case(torch, gen, name, r, c, dtype, opts, hq,
                                 hkv)
    head_dims = {}
    for name, m, opts in OPENLLAMA_K1_CASES:
        head_dims[name] = _k1_case(torch, gen, name, m, m, bf16, opts, 32,
                                   32, d=100)
    for d, g in HEAD_DIM_CASES:
        name = f"causal_d{d}_g{g}"
        head_dims[name] = _k1_case(torch, gen, name, n, n, bf16,
                                   dict(causal=True), 8 * g, 8, d=d)
    for shift in K1_SHIFTS:
        name = f"causal_q_shift{shift}"
        head_dims[name] = _k1_case(torch, gen, name, n, n, bf16,
                                   dict(causal=True), 32, 8, shift=shift)
    for d, shift in K1_MMA_PAST_128:
        name = f"causal_d{d}_q_shift{shift}_n1024"
        head_dims[name] = _k1_case(torch, gen, name, 1024, 1024, bf16,
                                   dict(causal=True), 8, 8, d=d, shift=shift,
                                   want_row="mma")
    return results["causal"], results["noncausal"], head_dims


def _kv_formats():
    """(name, OperandPrecision) of the four KV storage types."""
    from mfa_tpu_torch.ops.precision import OperandPrecision

    return [("bf16", OperandPrecision.BF16),
            ("int8", OperandPrecision.INT8),
            ("fp8_e4m3", OperandPrecision.FP8_E4M3),
            ("fp8_e5m2", OperandPrecision.FP8_E5M2)]


def _decode_bytes(live_rows, storage, d, q_rows):
    """Bytes one-token decode must move: each live K and V row once (with
    its two fp32 scales for quantized storage; a bf16 cache's scales are
    never read), q read and O written in bf16."""
    import torch

    itemsize = torch.empty((), dtype=storage).element_size()
    row = 2 * d * itemsize + (8 if storage != torch.bfloat16 else 0)
    return live_rows * row + 2 * q_rows * d * 2


def _split_shape(torch, n, group, capacity, lens, window=None,
                 fused=False):
    """K2/K5/K6's split of this shape (ops/params.py's rule, the same for
    all three): rows a split R, splits S, CTAs a pass, and the CTAs that
    hold live rows of these lengths (K2, ``fused``: a window of W keeps
    W - 1 cached rows beside the new token)."""
    from mfa_tpu_torch.ops import params as params_mod

    dev = params_mod.detect_device(torch.device("cuda", 0))
    rows = params_mod.decode_split_rows(n, group, capacity, dev)
    splits = max(1, -(-capacity // rows))
    chunks = -(-group // params_mod.decode_group_chunk(group))
    live = 0
    for x in lens:
        x = min(x, capacity)
        lo = max(0, x + int(fused) - window) if window else 0
        live += (x - 1) // rows - lo // rows + 1 if x > lo else 0
    return {"R": rows, "S": splits, "ctas": n * chunks * splits,
            "live_ctas": live * (n // len(lens)) * chunks}


# The decode kernels' head dims past D = 8 * 2^k, each with a GQA group:
# OpenLLaMA-3B's 100 (MHA), Phi-2's 80 and Phi-3-mini's 96 (kernel cases
# here), 192 and 256 (the 256-wide tensor-core pair), a tail of 250 (rows
# 4-byte aligned in bf16, 2-byte in int8 and fp8), 384 and 512 (the
# 512-wide pair) and a tail of 300 (rows 8-byte aligned in bf16, 4-byte
# in int8 and fp8). (D, G); each over the four storage types at L 2048,
# and D 100 in bf16 under a window of 512.
HEAD_DIM_CASES = ((80, 4), (96, 8), (100, 1), (250, 4), (384, 8), (192, 8),
                  (256, 4), (512, 1), (300, 4))


def _head_dim_cases():
    """(max_len, name, prec, Hkv, G, window, D) of the head-dim cases."""
    formats = dict(_kv_formats())
    cases = [(2048, name, prec, 8, g, None, d)
             for d, g in HEAD_DIM_CASES
             for name, prec in _kv_formats()]
    cases.append((2048, "bf16", formats["bf16"], 8, 1, 512, 100))
    return cases


def _odd_d_cases():
    """Odd head dims, which must stay on FMA (D 99, G 1: rows of 198 bytes
    in bf16, 2-byte aligned, and of 99 in int8; D 385, G 8, past D 256
    over every storage type: the FMA loop's two chunks a lane over 2- and
    1-byte rows): cases in _head_dim_cases' form, bf16 first."""
    formats = dict(_kv_formats())
    return [(2048, name, formats[name], 8, 1, None, 99)
            for name in ("bf16", "int8")] + [
        (2048, name, prec, 8, 8, None, 385) for name, prec in _kv_formats()]


def _small_d_cases():
    """D 4 and 8 with query chunks of 8 (G 8), whose CTAs take 128 threads
    (ops/params.py::decode_threads), over bf16 and int8: cases in
    _head_dim_cases' form."""
    formats = dict(_kv_formats())
    return [(2048, name, formats[name], 8, 8, None, d)
            for d in (4, 8) for name in ("bf16", "int8")]


def _attend_fp64(torch, q3, k, v, k_scale, v_scale, live,
                 magnitudes=False):
    """K5's one-token decode (K6's over its gathered rows) in fp64 over the
    live rows, dequantized, nothing rounded; with ``magnitudes`` over |v|:
    sum P |v| / l, the size of O's terms. q3 [N, G, D] in log2 units, k,
    v [N, L, D] storage, live [N, L]. A row with no live key gives 0;
    rows that are not live are never read, whatever they hold (K6's pool
    poisons its dead pages with NaN)."""
    kf, vf = k.double(), v.double()
    if k.dtype != torch.bfloat16:
        kf = kf * k_scale.double()[..., None]
        vf = vf * v_scale.double()[..., None]
    kf, vf = (torch.where(live[..., None], x, 0.0) for x in (kf, vf))
    if magnitudes:
        vf = vf.abs()
    s = torch.einsum("bgd,bld->bgl", q3.double(), kf)
    s = torch.where(live[:, None, :], s, -1e300)
    p = torch.where(live[:, None, :],
                    torch.exp2(s - s.amax(-1, keepdim=True)), 0.0)
    return (torch.einsum("bgl,bld->bgd", p, vf)
            / p.sum(-1, keepdim=True).clamp_min(1e-300))


def _held_by_terms(torch, o_k, o_p, exact, terms, budget) -> dict:
    """How the head-dim cases hold a decode kernel: O against its plain
    version at ``budget`` with the relative term taken of sum P |v| / l
    (``terms``), and the kernel no more than one bf16 step of it further
    from fp64 than the plain version anywhere (``excess_steps``), as
    _in_context holds K2. Against |O| alone a case fails where O cancels
    to near 0 from large terms and one P v term rounds to the other side
    in the kernel's order of S than in the plain version's (D 512, G 1:
    0.0009766 at |O| 0.04, the kernel and its plain version equally far
    from fp64); that share is reported as share_of_abs_o."""
    from mfa_tpu_torch.utils.testing import budget_share, rounding_steps

    steps_k, steps_p = (rounding_steps(o, exact, terms, budget[0])
                        for o in (o_k, o_p))
    return {"share_o": budget_share(o_k, o_p, *budget, scale=terms),
            "share_of_abs_o": budget_share(o_k, o_p, *budget),
            "steps_from_fp64": float(steps_k.max()),
            "plain_steps_from_fp64": float(steps_p.max()),
            "excess_steps": float((steps_k - steps_p).max())}


def _sdpa_ms(torch, q, k, v, lengths, window, scale):
    """Yardstick only: ms of one SDPA call over a bf16 cache k, v [B, Hkv,
    L, D] with q [B, Hq, D] and the live columns as a boolean mask, and
    the backend that ran."""
    import torch.nn.functional as F

    from mfa_tpu_torch.utils import roofline

    col = torch.arange(k.shape[2], device="cuda")
    lt = lengths.long()[:, None]
    mask = col < lt
    if window:
        mask &= col >= (lt - window).clamp_min(0)
    qs = q[:, :, None, :]

    def run():
        return F.scaled_dot_product_attention(
            qs, k, v, attn_mask=mask[:, None, None, :], scale=scale,
            enable_gqa=True)

    return roofline.cuda_ms(run, iters=20), _sdpa_backend(torch, run)


# What this port requires of the decode cases' paths, beyond agreeing with
# ops/params.py::decode_path (each case holds its launch to that): K2, K5
# and K6 on the tensor-core pair at bf16 D 80, 96, 100, 128, 192, 250,
# 256, 300, 384 and 512, over int8 and both fp8 formats at D 100, 128,
# 192, 256, 300, 384 and 512, and K5 with its cache 4 bytes off 16; FMA
# at odd D (99 in bf16 and int8, 385 over every storage type), at D 250
# over 1-byte storage and at D 4 and 8. (kernel, storage, D, base shift
# in bytes) -> path. (fp32 q stays on FMA: k5_bits' fp32 cases are held
# to it.)
REQUIRED_PATHS = {
    **{(k, "bf16", d, 0): p for k in ("k2", "k5", "k6")
       for d, p in ((80, "mma/g16"), (96, "mma/g16"), (100, "mma/g8"),
                    (128, "mma/g16"), (99, "fma"), (192, "mma/g16"),
                    (250, "mma/g4"), (256, "mma/g16"), (4, "fma"),
                    (8, "fma/exact"))},
    **{(k, f, d, 0): p for k in ("k2", "k5", "k6")
       for f in ("int8", "fp8_e4m3", "fp8_e5m2")
       for d, p in ((100, "mma/g4"), (128, "mma/g16"), (192, "mma/g16"),
                    (256, "mma/g16"), (250, "fma"), (300, "mma/g4"),
                    (385, "fma"))},
    **{(k, f, d, 0): "mma/g16" for k in ("k2", "k5", "k6")
       for f in ("bf16", "int8", "fp8_e4m3", "fp8_e5m2") for d in (384, 512)},
    **{(k, "bf16", d, 0): p for k in ("k2", "k5", "k6")
       for d, p in ((300, "mma/g8"), (385, "fma"))},
    **{(k, "int8", d, 0): p for k in ("k2", "k5", "k6")
       for d, p in ((99, "fma"), (4, "fma"), (8, "fma/exact"))},
    ("k5", "bf16", 100, 4): "mma/g4",
}


def _launch_paths(torch, counter, launch):
    """launch() and the paths its kernel launches took, by the wrapper's
    launches_by_path (``counter``): (result, sorted labels)."""
    before = dict(counter)
    out = launch()
    torch.cuda.synchronize()
    return out, sorted(k for k in counter if counter[k] != before.get(k, 0))


def _want_path(kernel, name, d, storage, k, v) -> str:
    """The path ops/params.py names for a launch of ``kernel`` ("k2",
    "k5", "k6") over caches k, v (their rows and bases give the copy
    granule); fails where REQUIRED_PATHS asks another."""
    from mfa_tpu_torch.ops import params as params_mod

    granule = params_mod.decode_granule(d, k.element_size(), k.data_ptr(),
                                        v.data_ptr())
    path = params_mod.decode_path(d, storage, True, granule)
    shift = k.data_ptr() % 16
    need = REQUIRED_PATHS.get((kernel, name, d, shift), path)
    if need != path:
        raise SystemExit(f"{kernel} {name} D {d} off {shift}: "
                         f"ops/params.py names {path}, {need} required")
    return path


def _nan_and_again(torch, launch, want, budget, terms=None) -> dict:
    """Two more launches, each into an output filled with NaN: the first
    must write every element finite and stay within ``budget`` of its
    plain version's ``want`` elementwise (the relative term of ``terms``
    where given), the second give the same bits."""
    from mfa_tpu_torch.utils.testing import budget_share, nan_canary

    o1 = launch(nan_canary(want.shape, want.dtype, device="cuda"))
    o2 = launch(nan_canary(want.shape, want.dtype, device="cuda"))
    torch.cuda.synchronize()
    return {"nan_filled_written": bool(torch.isfinite(o1.float()).all()),
            "nan_filled_share": budget_share(o1, want, *budget,
                                             scale=terms),
            "again_bit_equal": bool(torch.equal(_bits(torch, o1),
                                                _bits(torch, o2)))}


def _again_ok(again: dict) -> bool:
    return (again["nan_filled_written"] and again["nan_filled_share"] <= 1
            and again["again_bit_equal"])


def _k2_case(torch, gen, max_len, name, prec, hkv, g, window, d=128,
             shift=0):
    """K2 against its plain version on one cache shape (its k and v
    ``shift`` bytes off 16): O, appended rows, scales and lengths after a
    step, the path the launch took, two more launches into NaN-filled
    outputs; ms, plain ms, bound. Returns (key, kernel-table row)."""
    from mfa_tpu_torch.kernels import decode as k2
    from mfa_tpu_torch.ops.decode import decode_attention_append
    from mfa_tpu_torch.serving import kv_cache
    from mfa_tpu_torch.utils import roofline
    from mfa_tpu_torch.utils.testing import (
        KERNEL_BUDGETS,
        budget_share,
        decode_fp64,
        shifted_copy,
    )

    b = 4
    budget = KERNEL_BUDGETS["decode_o"]
    bh = b * hkv
    cache = kv_cache.create(b, hkv, max_len, d, prec, device="cuda")
    fill = torch.randn((b, hkv, max_len, d), generator=gen, device="cuda")
    kv_cache.update(cache, fill, torch.randn(
        (b, hkv, max_len, d), generator=gen, device="cuda"))
    if shift:
        cache.k, cache.v = (shifted_copy(t, shift) for t in (cache.k,
                                                              cache.v))
    lens = [0, 777, max_len - 1, max_len]
    cache.lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q3 = (torch.randn((bh, g, d), generator=gen, device="cuda")
          * (math.log2(math.e) / math.sqrt(d))).bfloat16()
    kn = (torch.randn((bh, d), generator=gen, device="cuda") * 0.5
          ).bfloat16()
    vn = (torch.randn((bh, d), generator=gen, device="cuda") * 0.5
          ).bfloat16()
    kw = dict(num_kv_heads=hkv, sliding_window=window)

    def views(c):
        return (c.k.view(bh, max_len, d), c.v.view(bh, max_len, d),
                c.k_scale.view(bh, max_len), c.v_scale.view(bh, max_len))

    plain_cache = kv_cache.KVCache(
        cache.k.clone(), cache.v.clone(), cache.k_scale.clone(),
        cache.v_scale.clone(), cache.lengths.clone(), prec)
    want_path = _want_path("k2", name, d, prec.dtype, cache.k, cache.v)
    n2 = k2.decode_fused_append.launches
    o_k, paths = _launch_paths(
        torch, k2.decode_fused_append.launches_by_path,
        lambda: k2.decode_fused_append(q3, *views(cache), kn, vn,
                                       cache.lengths, **kw))
    n2 = k2.decode_fused_append.launches - n2
    o_p = k2.decode_fused_append_plain(
        q3, *views(plain_cache), kn, vn, plain_cache.lengths, **kw)
    err = max_err(o_k, o_p)
    share = budget_share(o_k, o_p, *budget)
    held, terms = {}, None
    if d != 128:
        exact, terms = (decode_fp64(q3, *views(plain_cache), kn, vn,
                                    plain_cache.lengths, magnitudes=mag,
                                    **kw) for mag in (False, True))
        held = _held_by_terms(torch, o_k, o_p, exact, terms, budget)
        share = held["share_o"]
    again = _nan_and_again(torch, lambda out: k2.decode_fused_append(
        q3, *views(cache), kn, vn, cache.lengths, **kw, out=out), o_p,
        budget, terms)
    o_rms = float(o_p.float().square().mean().sqrt())
    same_rows = all(torch.equal(_bits(torch, getattr(cache, f)),
                                _bits(torch, getattr(plain_cache, f)))
                    for f in ("k", "v"))
    scale_err = max(
        float(((getattr(cache, f) - getattr(plain_cache, f)).abs()
               / getattr(plain_cache, f).abs()).max())
        for f in ("k_scale", "v_scale"))
    ms = roofline.cuda_ms(lambda: k2.decode_fused_append(
        q3, *views(cache), kn, vn, cache.lengths, **kw), iters=50)
    plain_ms = roofline.cuda_ms(lambda: k2.decode_fused_append_plain(
        q3, *views(plain_cache), kn, vn, plain_cache.lengths, **kw),
        iters=5, warmup=1)
    # Lengths after a step through the entry point: each advances by
    # one, capped at max_len.
    decode_attention_append(
        q3.reshape(b, hkv * g, d), kn.view(b, hkv, d),
        vn.view(b, hkv, d), cache, sliding_window=window, device="cuda")
    lengths_after = cache.lengths.tolist()
    lengths_ok = lengths_after == [min(x + 1, max_len) for x in lens]
    ok = (bool(torch.isfinite(o_k.float()).all()) and share <= 1
          and held.get("excess_steps", 0) <= 1 and same_rows
          and scale_err <= 1e-6 and lengths_ok and n2 == 1
          and paths == [want_path] and _again_ok(again))
    # Bytes K2 must move for these lengths: the live K and V rows (with
    # their scales for a quantized cache; a bf16 cache's scales are
    # never read; a window of W keeps W - 1 cached rows), q, k_new,
    # v_new, O, and the appended rows.
    live = sum(min(x, max_len, (window or max_len + 1) - 1)
               for x in lens) * hkv
    itemsize = cache.k.element_size()
    row_bytes = d * itemsize + (4 if itemsize == 1 else 0)
    appended = sum(1 for x in lens if x < max_len) * hkv
    nbytes = (2 * live * row_bytes + 2 * bh * g * d * 2
              + 2 * bh * d * 2 + 2 * appended * row_bytes)
    bound_ms, bound_by = roofline.bound(4 * g * d * (live + bh), nbytes)
    sdpa = {}
    if d != 128 and name == "bf16":
        # Yardstick only (attention over the cached rows, no append).
        lens_t = torch.tensor(lens, device="cuda")
        sdpa_ms, backend = _sdpa_ms(torch, q3.reshape(b, hkv * g, d),
                                    plain_cache.k, plain_cache.v, lens_t,
                                    window, 1.0)
        sdpa = {"sdpa_ms": sdpa_ms, "sdpa_backend": backend}
    key = ((f"D{d}_" if d != 128 else "") + f"{name}_L{max_len}"
           + (f"_G{g}" if g != 4 else "") + (f"_w{window}" if window else "")
           + (f"_off{shift}" if shift else ""))
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=None)
    emit({"phase": "k2", "case": key, "D": d, "Hkv": hkv, "G": g,
          "window": window, "lengths": lens, "path": paths,
          "want_path": want_path, "err_o": err,
          "o_rms": o_rms, "budget_o": budget, "share_o": share, **held,
          **again, "appended_rows_equal": same_rows,
          "lengths_after": lengths_after, "scale_rel_err": scale_err,
          "launches": n2, "ok": ok, **sdpa,
          **_split_shape(torch, bh, g, max_len, lens, window, fused=True),
          **{k_: v_ for k_, v_ in row.items() if k_ != "max_abs_err"}})
    if not ok:
        raise SystemExit(f"k2 {key}: kernel disagrees with its plain "
                         f"version (O uses {share} of |d| <= "
                         f"{budget[0]} + {budget[1]}|O|, rows equal "
                         f"{same_rows}, scale err {scale_err}, "
                         f"lengths after {lengths_after}, launches {n2}, "
                         f"path {paths} (want {want_path}), NaN-filled and "
                         f"again {again}, against fp64 {held})")
    return key, row


def phase_k2(torch):
    """K2 at Llama-3-8B's, Qwen2-7B's and Mistral-7B's decode shapes (D
    128), then at HEAD_DIM_CASES. Returns (the kernel-table row, the
    head-dim rows)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    # (max_len, format, Hkv, G, window): Llama-3-8B's heads (Hkv 8, G 4)
    # over each format, then a group of 16 (two query chunks) under a
    # sliding window, Qwen2-7B's heads (Hkv 4, G 7: each chunk of 8 rows
    # has a dead row) and Mistral-7B's window of 4096 over 8192 positions.
    formats = dict(_kv_formats())
    cases = [(max_len, name, prec, 8, 4, None) for max_len in (2048, 8192)
             for name, prec in _kv_formats()]
    cases.append((2048, "int8", formats["int8"], 2, 16, 512))
    cases += [(2048, name, formats[name], 4, 7, None)
              for name in ("bf16", "fp8_e4m3")]
    cases.append((8192, "bf16", formats["bf16"], 8, 4, 4096))
    results = {}
    for case in cases:
        key, row = _k2_case(torch, gen, *case)
        results[key] = row
    head_dims = {}
    for case in _head_dim_cases() + _odd_d_cases() + _small_d_cases():
        key, row = _k2_case(torch, gen, *case)
        head_dims[key] = row
    paths = {}
    digests = k2_bits(torch, paths)
    same = digests == K2_INT8_DIGESTS
    on_pair = all(v == ["mma/g4" if "D100" in key or "D300" in key
                        else "mma/g16"]
                  for key, v in paths.items())
    emit({"phase": "k2_bits", "digests": digests, "paths": paths,
          "as_recorded": same})
    if not (same and on_pair):
        raise SystemExit(f"k2: K2's output bits over int8 differ from "
                         f"K2_INT8_DIGESTS (the FMA pair's), or its paths "
                         f"{paths} are not the tensor-core pair's")
    return results["bf16_L2048"], head_dims


# K2's output bits over an int8 cache on the fixed inputs of k2_bits, as
# the FMA pair gave them on an H100 before K2's int8 launches at 64 <= D
# <= 128 moved onto the tensor-core pair (D 192 and 256: before those at
# 128 < D <= 256 moved; D 300, 384 and 512: before those at 256 < D <=
# 512 moved). Over int8, K2 requantizes q and P to s8: its
# products and their sums a split are integers below 2^24, exact in any
# order, and what is not (the scales' products, P's row sum) the pair
# computes in the FMA pair's order. So these bits hold on either pair,
# and a change to them is a fault in the pair, not a re-recording.
K2_INT8_DIGESTS = {
    "int8_bfloat16_D128_G4": "7470e953fb772dc9",
    "int8_bfloat16_D100_G1": "e30a87ac480ad740",
    "int8_bfloat16_D128_G4_pm127": "731492cad7ffec0b",
    "int8_bfloat16_D192_G8": "d904b3ea8d668dd6",
    "int8_bfloat16_D256_G4": "8d59b379f91a6474",
    "int8_bfloat16_D300_G4": "745f25b21fdacff8",
    "int8_bfloat16_D384_G8": "8a744e9dad5d85b2",
    "int8_bfloat16_D512_G1": "0be2b57e817119ed",
}


def k2_bits(torch, paths=None) -> dict:
    """sha256 (16 hex digits) of K2's output over an int8 cache for each
    case: bf16 q at D 128 and G 4, at D 100 and G 1, and at D 128 and G 4
    with every K and V value at +-127 and constant scales (every live
    row's P at the same s8 value 127, the largest integer sums), then at
    D 192 and G 8, at D 256 and G 4, at D 300 and G 4, at D 384 and G 8
    and at D 512 and G 1; 4 sequences x 8 kv heads, max_len 2048, lengths
    0, 777, 2047, 2048.
    Inputs come from numpy (seed 21) on the host, so every tree and run
    sees the same bits. ``paths``, where given, takes each case's launch
    paths (the wrapper's launches_by_path)."""
    import hashlib

    import numpy as np

    from mfa_tpu_torch.kernels import decode as k2

    rng = np.random.default_rng(21)
    b, hkv, max_len = 4, 8, 2048
    bh = b * hkv
    lengths = torch.tensor([0, 777, max_len - 1, max_len],
                           dtype=torch.int32).cuda()
    digests = {}
    for d, g, extreme in ((128, 4, False), (100, 1, False), (128, 4, True),
                          (192, 8, False), (256, 4, False), (300, 4, False),
                          (384, 8, False), (512, 1, False)):
        if extreme:
            k = np.full((bh, max_len, d), 127, dtype=np.int8)
            v = np.where(np.arange(d) % 2 == 0, 127, -127).astype(np.int8)
            k, v = torch.from_numpy(k), torch.from_numpy(
                np.ascontiguousarray(np.broadcast_to(v, (bh, max_len, d))))
            ks, vs = (torch.full((bh, max_len), 0.01) for _ in range(2))
        else:
            k, v = (torch.from_numpy(rng.integers(
                -127, 128, (bh, max_len, d), dtype=np.int8))
                for _ in range(2))
            ks, vs = (torch.from_numpy(rng.uniform(
                0.005, 0.02, (bh, max_len)).astype(np.float32))
                for _ in range(2))
        q3 = torch.from_numpy((rng.standard_normal(
            (bh, g, d), dtype=np.float32)
            * np.float32(math.log2(math.e) / math.sqrt(d)))).bfloat16()
        kn, vn = (torch.from_numpy(rng.standard_normal(
            (bh, d), dtype=np.float32) * np.float32(0.5)).bfloat16()
            for _ in range(2))
        counter = k2.decode_fused_append.launches_by_path
        before = dict(counter)
        o = k2.decode_fused_append(q3.cuda(), k.cuda(), v.cuda(), ks.cuda(),
                                   vs.cuda(), kn.cuda(), vn.cuda(), lengths,
                                   num_kv_heads=hkv)
        raw = o.cpu().contiguous().view(torch.uint8).numpy().tobytes()
        key = (f"int8_bfloat16_D{d}_G{g}" + ("_pm127" if extreme else ""))
        digests[key] = hashlib.sha256(raw).hexdigest()[:16]
        if paths is not None:
            paths[key] = sorted(x for x in counter
                                if counter[x] != before.get(x, 0))
    return digests


# K5's output bits on the fixed inputs of k5_bits, as K5 gave them on an
# H100: over bf16 storage and at fp32 q, those of the K5 before K2 came
# to share its body (csrc/decode_split.cuh); over int8 and fp8 at bf16 q,
# those of the tensor-core pair. A change to that body must leave K5 (and
# K6, which k6 holds equal to K5) bit for bit as they are; one that means
# to change them records the digests that k5_bits prints.
K5_DIGESTS = {
    "bf16_bfloat16_D128_G4": "ca8420caa9826b79",
    "bf16_bfloat16_D64_G8_w300": "b2b0944c01d1f4e4",
    "bf16_float32_D128_G4": "a768d339f3faf371",
    "int8_bfloat16_D128_G4": "1df8011ae0e4f432",
    "int8_bfloat16_D64_G8_w300": "ae554ea6799aef28",
    "int8_float32_D128_G4": "0eb02a07645b4391",
    "fp8_e4m3_bfloat16_D128_G4": "4b6280e2641826bb",
    "fp8_e4m3_bfloat16_D64_G8_w300": "5cfc1fa4f7492fa3",
    "fp8_e4m3_float32_D128_G4": "5859fd1c9054d5a3",
    "fp8_e5m2_bfloat16_D128_G4": "b8d68a98be3947c2",
    "fp8_e5m2_bfloat16_D64_G8_w300": "95af9158cba7cdd3",
    "fp8_e5m2_float32_D128_G4": "075cb32aaa48ee89",
}


def k5_bits(torch, paths=None) -> dict:
    """sha256 (16 hex digits) of K5's output for each case: the four
    storage formats, each with bf16 q at D 128 and G 4, bf16 q at D 64
    and G 8 under a window of 300, and fp32 q at D 128 and G 4 (the
    tensor-core, wide-chunk and FMA instances); 4 sequences x 8 kv heads,
    max_len 2048, lengths 0, 777, 2047, 2048. Inputs come from numpy
    (seed 55) on the host, so every tree and run sees the same bits.
    ``paths``, where given, takes each case's launch paths (the wrapper's
    launches_by_path)."""
    import hashlib

    import numpy as np

    from mfa_tpu_torch.kernels import decode as k5

    rng = np.random.default_rng(55)
    b, hkv, max_len = 4, 8, 2048
    bh = b * hkv
    lengths = torch.tensor([0, 777, max_len - 1, max_len],
                           dtype=torch.int32).cuda()
    digests = {}
    for fmt, storage in (("bf16", torch.bfloat16), ("int8", torch.int8),
                         ("fp8_e4m3", torch.float8_e4m3fn),
                         ("fp8_e5m2", torch.float8_e5m2)):
        for q_dtype, d, g, window in ((torch.bfloat16, 128, 4, None),
                                      (torch.bfloat16, 64, 8, 300),
                                      (torch.float32, 128, 4, None)):
            if storage == torch.int8:
                k, v = (torch.from_numpy(rng.integers(
                    -127, 128, (bh, max_len, d), dtype=np.int8))
                    for _ in range(2))
            else:
                k, v = (torch.from_numpy(rng.standard_normal(
                    (bh, max_len, d), dtype=np.float32)).to(storage)
                    for _ in range(2))
            ks, vs = (torch.from_numpy(rng.uniform(
                0.005, 0.02, (bh, max_len)).astype(np.float32))
                for _ in range(2))
            q3 = torch.from_numpy((rng.standard_normal(
                (bh, g, d), dtype=np.float32)
                * np.float32(math.log2(math.e) / math.sqrt(d)))).to(q_dtype)
            counter = k5.decode_attend.launches_by_path
            before = dict(counter)
            o = k5.decode_attend(q3.cuda(), k.cuda(), v.cuda(), ks.cuda(),
                                 vs.cuda(), lengths, num_kv_heads=hkv,
                                 sliding_window=window)
            raw = o.cpu().contiguous().view(torch.uint8).numpy().tobytes()
            key = (f"{fmt}_{str(q_dtype).split('.')[-1]}_D{d}_G{g}"
                   + (f"_w{window}" if window else ""))
            digests[key] = hashlib.sha256(raw).hexdigest()[:16]
            if paths is not None:
                paths[key] = sorted(x for x in counter
                                    if counter[x] != before.get(x, 0))
    return digests


def _k5_case(torch, gen, max_len, name, prec, hkv, g, window, d=128,
             shift=0):
    """K5 through its entry point, decode_attention, against the same call
    with its plain version swapped in (B 4, lengths 0, 777, L - 1, L; k
    and v ``shift`` bytes off 16), the path the launch took, then two
    launches of the wrapper into NaN-filled outputs; ms, plain ms, bound
    and (bf16) SDPA's ms. Returns (key, kernel-table row, launches through
    the entry point)."""
    from mfa_tpu_torch.kernels import decode as k5
    from mfa_tpu_torch.kernels.flash_fwd import LOG2E
    from mfa_tpu_torch.ops.decode import decode_attention
    from mfa_tpu_torch.serving import kv_cache
    from mfa_tpu_torch.utils import roofline
    from mfa_tpu_torch.utils.testing import (
        KERNEL_BUDGETS,
        budget_share,
        shifted_copy,
    )

    b = 4
    bh, scale = b * hkv, 1.0 / math.sqrt(d)
    budget = KERNEL_BUDGETS["decode_attend_o"]
    cache = kv_cache.create(b, hkv, max_len, d, prec, device="cuda")
    kv_cache.update(cache, *torch.randn((2, b, hkv, max_len, d),
                                        generator=gen, device="cuda"))
    if shift:
        cache.k, cache.v = (shifted_copy(t, shift) for t in (cache.k,
                                                              cache.v))
    lens = [0, 777, max_len - 1, max_len]
    cache.lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = torch.randn((b, hkv * g, d), generator=gen,
                    device="cuda").bfloat16()
    torch.cuda.synchronize()
    want_path = _want_path("k5", name, d, prec.dtype, cache.k, cache.v)
    k5.decode_attend.launches = 0
    o_k, paths = _launch_paths(
        torch, k5.decode_attend.launches_by_path,
        lambda: decode_attention(q, cache, sliding_window=window))
    n5 = k5.decode_attend.launches
    with plain_kernels():
        o_p = decode_attention(q, cache, sliding_window=window)
    err = max_err(o_k, o_p)
    share = budget_share(o_k, o_p, *budget)
    q3 = (q.float() * (scale * LOG2E)).bfloat16().reshape(bh, g, d)
    args = (cache.k.view(bh, max_len, d), cache.v.view(bh, max_len, d),
            cache.k_scale.view(bh, max_len),
            cache.v_scale.view(bh, max_len), cache.lengths)
    kw = dict(num_kv_heads=hkv, sliding_window=window)
    held, terms = {}, None
    if d != 128:
        live = k5.live_rows(cache.lengths, max_len, hkv, window)
        exact, terms = (_attend_fp64(torch, q3, *args[:4], live, mag)
                        for mag in (False, True))
        held = _held_by_terms(torch, o_k.reshape(bh, g, d),
                              o_p.reshape(bh, g, d), exact, terms, budget)
        share = held["share_o"]
    again = _nan_and_again(
        torch, lambda out: k5.decode_attend(q3, *args, **kw, out=out),
        k5.decode_attend_plain(q3, *args, **kw), budget, terms)
    o_rms = float(o_p.float().square().mean().sqrt())
    empty_zero = not bool(o_k[0].any())        # length 0 gives zeros
    ok = (bool(torch.isfinite(o_k.float()).all()) and share <= 1
          and held.get("excess_steps", 0) <= 1 and n5 == 1 and empty_zero
          and paths == [want_path] and _again_ok(again))
    ms = roofline.cuda_ms(lambda: k5.decode_attend(q3, *args, **kw),
                          iters=50)
    plain_ms = roofline.cuda_ms(lambda: k5.decode_attend_plain(
        q3, *args, **kw), iters=5, warmup=1)
    live = sum(min(x, window or x) for x in lens) * hkv
    bound_ms, bound_by = roofline.bound(
        4 * g * d * live, _decode_bytes(live, cache.k.dtype, d, bh * g))
    library_ms, sdpa = None, {}
    if name == "bf16":
        # Yardstick only: one SDPA call over the same cache, with the
        # live columns as a boolean mask.
        library_ms, backend = _sdpa_ms(torch, q, cache.k, cache.v,
                                       cache.lengths, window, scale)
        sdpa = {"sdpa_backend": backend}
    key = ((f"D{d}_" if d != 128 else "") + f"{name}_L{max_len}"
           + (f"_G{g}" if g != 4 else "") + (f"_w{window}" if window else "")
           + (f"_off{shift}" if shift else ""))
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=library_ms)
    emit({"phase": "k5", "case": key, "D": d, "G": g, "lengths": lens,
          "path": paths, "want_path": want_path,
          "err_o": err, "o_rms": o_rms, "budget_o": budget,
          "share_o": share, **held, **again, "launches": n5,
          "empty_slot_zero": empty_zero,
          "ok": ok, **sdpa,
          **_split_shape(torch, bh, g, max_len, lens, window),
          **{k_: v_ for k_, v_ in row.items() if k_ != "max_abs_err"}})
    if not ok:
        raise SystemExit(f"k5 {key}: kernel disagrees with its plain "
                         f"version (O uses {share} of |d| <= "
                         f"{budget[0]} + {budget[1]}|O|, launches {n5}, "
                         f"empty slot zero {empty_zero}, path {paths} "
                         f"(want {want_path}), NaN-filled and again "
                         f"{again}, against fp64 {held})")
    return key, row, n5


def phase_k5(torch):
    """K5 through its entry point, against the same call with the plain
    version swapped in: Llama-3-8B's heads (D 128), then HEAD_DIM_CASES.
    Returns (kernel-table row, head-dim rows, launches through the
    entry point)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = [(max_len, name, prec, 8, 4, None) for max_len in (2048, 8192)
             for name, prec in _kv_formats()]
    cases.append((2048, "bf16", dict(_kv_formats())["bf16"], 8, 4, 512))
    results, head_dims, launches = {}, {}, 0
    for case in cases:
        key, results[key], n5 = _k5_case(torch, gen, *case)
        launches += n5
    for case in _head_dim_cases() + _odd_d_cases() + _small_d_cases():
        key, head_dims[key], n5 = _k5_case(torch, gen, *case)
        launches += n5
    # OpenLLaMA-3B's width with the cache 4 bytes off 16: copy granule 4.
    key, head_dims[key], n5 = _k5_case(torch, gen, *_odd_d_cases()[0][:6],
                                       100, shift=4)
    launches += n5
    paths = {}
    digests = k5_bits(torch, paths)
    same = digests == K5_DIGESTS
    # bf16 q on the tensor-core pair over every storage type, fp32 q on
    # the FMA pair's exact layout.
    held = all(v == (["fma/exact"] if "float32" in key else ["mma/g16"])
               for key, v in paths.items())
    emit({"phase": "k5_bits", "digests": digests, "paths": paths,
          "as_recorded": same, "paths_held": held})
    if not (same and held):
        raise SystemExit(f"k5: K5's output bits differ from K5_DIGESTS (the "
                         f"split-KV body K2, K5 and K6 share changed them), "
                         f"or its paths {paths} are not the rule's")
    emit({"phase": "k5_done", "seconds": time.perf_counter() - t0,
          "launches": launches})
    return results["bf16_L2048"], head_dims, launches


def _k6_case(torch, gen, ps, name, prec, window, g=4, d=128):
    """K6 against its plain version and against K5 on the same rows (8
    sequences of 0-2048 tokens, Hkv 8, a pool with shuffled page ids), the
    path the launch took, two more launches into NaN-filled outputs; ms
    beside K5's, plain ms, bound and (bf16) SDPA's ms over the same rows.
    Returns (key, kernel-table row)."""
    from mfa_tpu_torch.kernels import decode as k5
    from mfa_tpu_torch.kernels import paged_decode as k6
    from mfa_tpu_torch.utils import roofline
    from mfa_tpu_torch.utils.testing import (
        KERNEL_BUDGETS,
        budget_share,
        shuffled_page_pool,
    )

    s, hkv, max_len = 8, 8, 2048
    lens = [0, 1, 511, 512, 513, 777, 2047, 2048]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    budget = KERNEL_BUDGETS["paged_decode_o"]
    max_pages = max_len // ps
    operands = (*shuffled_page_pool(prec.dtype, lens, hkv, d, ps,
                                    max_pages, generator=gen,
                                    device="cuda"), lengths)
    q3 = (torch.randn((s * hkv, g, d), generator=gen, device="cuda")
          * (math.log2(math.e) / math.sqrt(d))).bfloat16()
    want_path = _want_path("k6", name, d, prec.dtype, *operands[:2])
    n6 = k6.paged_decode.launches
    o_k, paths = _launch_paths(
        torch, k6.paged_decode.launches_by_path,
        lambda: k6.paged_decode(q3, *operands, sliding_window=window))
    n6 = k6.paged_decode.launches - n6
    o_p = k6.paged_decode_plain(q3, *operands, sliding_window=window)
    err = max_err(o_k, o_p)
    share = budget_share(o_k, o_p, *budget)
    o_rms = float(o_p.float().square().mean().sqrt())
    # K5 over the same rows gathered into a contiguous cache.
    rows = [k6.gather_rows(t, operands[4]).contiguous()
            for t in operands[:4]]
    held, terms = {}, None
    if d != 128:
        live = k5.live_rows(lengths, max_pages * ps, hkv, window)
        exact, terms = (_attend_fp64(torch, q3, *rows, live, mag)
                        for mag in (False, True))
        held = _held_by_terms(torch, o_k, o_p, exact, terms, budget)
        share = held["share_o"]
    again = _nan_and_again(torch, lambda out: k6.paged_decode(
        q3, *operands, sliding_window=window, out=out), o_p, budget, terms)
    o_c = k5.decode_attend(q3, *rows, lengths, num_kv_heads=hkv,
                           sliding_window=window)
    same_as_k5 = bool(torch.equal(o_k, o_c))
    empty_zero = not bool(o_k[:hkv].any())    # length 0 gives zeros
    ok = (bool(torch.isfinite(o_k.float()).all()) and share <= 1
          and held.get("excess_steps", 0) <= 1 and same_as_k5
          and empty_zero and n6 == 1 and paths == [want_path]
          and _again_ok(again))
    ms = roofline.cuda_ms(lambda: k6.paged_decode(
        q3, *operands, sliding_window=window), iters=50)
    k5_ms = roofline.cuda_ms(lambda: k5.decode_attend(
        q3, *rows, lengths, num_kv_heads=hkv,
        sliding_window=window), iters=50)
    plain_ms = roofline.cuda_ms(lambda: k6.paged_decode_plain(
        q3, *operands, sliding_window=window), iters=5, warmup=1)
    live = sum(min(x, window or x) for x in lens) * hkv
    nbytes = (_decode_bytes(live, prec.dtype, d, s * hkv * g)
              + 4 * (s * max_pages + s))
    bound_ms, bound_by = roofline.bound(4 * g * d * live, nbytes)
    sdpa = {}
    if d != 128 and name == "bf16":
        # Yardstick only: SDPA over the same rows made contiguous.
        sdpa_ms, backend = _sdpa_ms(
            torch, q3.reshape(s, hkv * g, d), rows[0].view(s, hkv, -1, d),
            rows[1].view(s, hkv, -1, d), lengths, window, 1.0)
        sdpa = {"sdpa_ms": sdpa_ms, "sdpa_backend": backend}
    key = ((f"D{d}_" if d != 128 else "") + f"{name}_page{ps}"
           + (f"_G{g}" if g != 4 else "") + (f"_w{window}" if window else ""))
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=None)
    emit({"phase": "k6", "case": key, "D": d, "G": g, "lengths": lens,
          "path": paths, "want_path": want_path,
          "err_o": err, "o_rms": o_rms, "budget_o": budget,
          "share_o": share, **held, **again, "equal_to_k5": same_as_k5,
          "k5_ms_same_rows": k5_ms, "paged_over_contiguous": ms / k5_ms,
          "launches": n6, "empty_slot_zero": empty_zero, "ok": ok, **sdpa,
          **_split_shape(torch, s * hkv, g, max_len, lens, window),
          **{k_: v_ for k_, v_ in row.items() if k_ != "max_abs_err"}})
    if not ok:
        raise SystemExit(f"k6 {key}: kernel disagrees with its plain "
                         f"version (O uses {share} of |d| <= "
                         f"{budget[0]} + {budget[1]}|O|, equal to "
                         f"K5 {same_as_k5}, empty slot zero "
                         f"{empty_zero}, launches {n6}, path {paths} "
                         f"(want {want_path}), NaN-filled and again "
                         f"{again}, against fp64 {held})")
    return key, row


def phase_k6(torch):
    """K6 against its plain version, and against K5 on the same rows, at
    pages of 128 and 512 tokens (D 128), then at HEAD_DIM_CASES on 512.
    Returns (the kernel-table row at 512-token pages, the serving path's;
    the head-dim rows)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(6)
    results, head_dims = {}, {}
    for ps in (128, 512):
        cases = [(name, prec, None) for name, prec in _kv_formats()]
        cases.append(("bf16", dict(_kv_formats())["bf16"], 512))
        for name, prec, window in cases:
            key, results[key] = _k6_case(torch, gen, ps, name, prec, window)
    for _, name, prec, _, g, window, d in (_head_dim_cases()
                                           + _odd_d_cases()
                                           + _small_d_cases()):
        key, head_dims[key] = _k6_case(torch, gen, 512, name, prec, window,
                                       g, d)
    emit({"phase": "k6_done", "seconds": time.perf_counter() - t0})
    return results["bf16_page512"], head_dims


def phase_k7(torch):
    """K7 through its entry point, against the same call with its plain
    version swapped in. Returns (kernel-table row, launches through the
    entry point)."""
    from mfa_tpu_torch.kernels import gemm_kernel as k7
    from mfa_tpu_torch.ops import params as params_mod
    from mfa_tpu_torch.ops.descriptors import GEMMDescriptor
    from mfa_tpu_torch.ops.gemm import gemm
    from mfa_tpu_torch.ops.precision import OperandPrecision as P
    from mfa_tpu_torch.utils import roofline
    from mfa_tpu_torch.utils.testing import KERNEL_BUDGETS, budget_share

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(7)
    dev = params_mod.detect_device(torch.device("cuda", 0))
    bf16, fp32 = torch.bfloat16, torch.float32
    # (name, A type, B type, batch, M, N, K, transpose_a, transpose_b, C0,
    # extra rows and columns of the buffers the operands are sliced from)
    cases = [("bf16_4096", bf16, bf16, 1, 4096, 4096, 4096, False, False,
              False, 0),
             ("fp32_1536_c0", fp32, fp32, 1, 1536, 1536, 1536, False, False,
              True, 0)]
    cases += [(f"bf16_1536_{'T' if ta else 'N'}{'T' if tb else 'N'}", bf16,
               bf16, 1, 1536, 1536, 1536, ta, tb, False, 0)
              for ta in (False, True) for tb in (False, True)]
    cases.append(("bf16_1536_c0", bf16, bf16, 1, 1536, 1536, 1536, False,
                  False, True, 0))
    cases.append(("bf16_batched_3x200x129x127", bf16, bf16, 3, 200, 129, 127,
                  False, False, False, 0))
    cases += [(f"bf16_ragged_{n}", bf16, bf16, 1, n, n, n, False, False,
               False, 0) for n in (7, 127, 129, 200)]
    cases.append(("bf16_1536_strided", bf16, bf16, 1, 1536, 1536, 1536,
                  False, True, True, 64))
    results, launches = {}, 0
    for name, adt, bdt, batch, m, n, k, ta, tb, with_c0, pad in cases:
        def operand(rows, cols, dt):
            big = torch.randn((batch, rows + pad, cols + pad), generator=gen,
                              device="cuda").to(dt)
            return big[:, :rows, :cols]

        a = operand(k, m, adt) if ta else operand(m, k, adt)
        b = operand(n, k, bdt) if tb else operand(k, n, bdt)
        c0 = operand(m, n, fp32) if with_c0 else None
        if batch == 1:
            a, b = a[0], b[0]
            c0 = None if c0 is None else c0[0]
        kw = dict(transpose_a=ta, transpose_b=tb)
        torch.cuda.synchronize()
        k7.gemm_kernel.launches = 0
        c = gemm(a, b, c0, **kw)
        torch.cuda.synchronize()
        n7 = k7.gemm_kernel.launches
        launches += n7
        with plain_kernels():
            c_p = gemm(a, b, c0, **kw)
        tag = ("fp32" if c.dtype == fp32 and fp32 in (adt, bdt)
               else "bf16")
        budget = list(KERNEL_BUDGETS[f"gemm_{tag}"])
        budget[0] *= max(1.0, k / 4096)
        err = max_err(c, c_p)
        share = budget_share(c, c_p, *budget)
        # The bf16 cases whose rows are whole 16 bytes (4096^3, 1536^3 with
        # its strided slice and C0, ragged 200) run the wgmma kernel; the
        # others (batched 127 and ragged 7, 127, 129: odd strides; fp32)
        # the first cut.
        want_wgmma = (name.startswith(("bf16_4096", "bf16_1536"))
                      or name == "bf16_ragged_200")
        kd = GEMMDescriptor(
            m=m, n=n, k=k, a_precision=P.from_dtype(adt),
            b_precision=P.from_dtype(bdt), c_precision=P.from_dtype(c.dtype),
            transpose_a=ta, transpose_b=tb, batch=batch,
            load_previous_c=with_c0).kernel_descriptor(dev)
        tile = k7.launch_tile(kd, a if a.dim() == 3 else a[None],
                              b if b.dim() == 3 else b[None])
        ok = (bool(torch.isfinite(c.float()).all()) and share <= 1
              and n7 == 1 and (tile.path == "wgmma") == want_wgmma)
        ms = roofline.cuda_ms(lambda: gemm(a, b, c0, **kw))
        with plain_kernels():
            plain_ms = roofline.cuda_ms(lambda: gemm(a, b, c0, **kw), iters=3,
                               warmup=1)
        # Yardstick: one PyTorch call for the same product.
        aa = a.transpose(-1, -2) if ta else a
        bb = b.transpose(-1, -2) if tb else b
        if adt != bdt:
            library_ms = None
        elif c0 is None:
            library_ms = roofline.cuda_ms(lambda: torch.matmul(aa, bb))
        else:
            c0l = c0.to(c.dtype)
            library_ms = roofline.cuda_ms(lambda: torch.addmm(c0l, aa, bb))
        nbytes = (a.numel() * a.element_size() + b.numel() * b.element_size()
                  + c.numel() * c.element_size() * (2 if with_c0 else 1))
        peak = (roofline.BF16_FLOPS if adt == bdt == bf16
                else roofline.FP32_FLOPS)
        bound_ms, bound_by = roofline.bound(2 * batch * m * n * k, nbytes,
                                            peak)
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=library_ms)
        emit({"phase": "k7", "case": name, "batch": batch, "M": m, "N": n,
              "K": k, "tile": tile.name, "path": tile.path,
              "tflops": 2 * batch * m * n * k / (ms * 1e-3) / 1e12,
              "err": err, "budget": budget, "share": share, "launches": n7,
              "ok": ok, **{k_: v_ for k_, v_ in results[name].items()
                           if k_ != "max_abs_err"}})
        if not ok:
            raise SystemExit(f"k7 {name}: kernel disagrees with its plain "
                             f"version (uses {share} of |d| <= {budget[0]} "
                             f"+ {budget[1]}|C|, launches {n7}, tile "
                             f"{tile.name})")
        del a, b, c0, c, c_p
    torch.cuda.empty_cache()
    emit({"phase": "k7_done", "seconds": time.perf_counter() - t0,
          "launches": launches})
    return results["bf16_4096"], launches


# Llama-3-8B's projections as (K, N): wq and wo, wk and wv, w_gate and
# w_up, w_down.
LLAMA3_8B_PROJECTIONS = ((4096, 4096), (4096, 1024), (4096, 14336),
                         (14336, 4096))
# Qwen2-7B's: wq and wo, wk and wv (4 kv heads), w_gate and w_up, w_down.
QWEN2_7B_PROJECTIONS = ((3584, 3584), (3584, 512), (3584, 18944),
                        (18944, 3584))


def phase_k8(torch):
    """K8 against its plain version at Llama-3-8B's projection shapes, and
    signed at Qwen2-7B's; then where the wrapper re-splits the packed
    weights before the kernel (kernels/quant_matmul.py::repack_halves):
    K 4080 (K % 32 != 0) at N 4096, M 4 and 2048, signed and biased, and
    packed weights 8 bytes off 16 at 4096 -> 4096, each with the re-split's
    own ms. Returns (the kernel-table row (decode, 4096 -> 14336, signed),
    the re-split rows)."""
    import torch.nn.functional as F

    from mfa_tpu_torch.kernels import quant
    from mfa_tpu_torch.kernels import quant_matmul as k8
    from mfa_tpu_torch.ops import params as params_mod
    from mfa_tpu_torch.utils import roofline
    from mfa_tpu_torch.utils.testing import (
        KERNEL_BUDGETS,
        budget_share,
        shifted_copy,
    )

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(8)
    dev = params_mod.detect_device(torch.device("cuda", 0))
    cases = [(k, n, m, layout, torch.bfloat16, 0)
             for k, n in LLAMA3_8B_PROJECTIONS for m in (4, 16, 2048)
             for layout in ("int4", "int4_biased")]
    cases.append((4096, 1024, 4, "int4", torch.float32, 0))
    cases += [(k, n, m, "int4", torch.bfloat16, 0)
              for k, n in QWEN2_7B_PROJECTIONS for m in (4, 2048)]
    cases += [(4080, 4096, m, layout, torch.bfloat16, 0) for m in (4, 2048)
              for layout in ("int4", "int4_biased")]
    cases += [(4096, 4096, 4, "int4", torch.bfloat16, 8),
              (4096, 4096, 2048, "int4_biased", torch.bfloat16, 8)]
    results, resplit = {}, {}
    for k, n, m, layout, dt, shift in cases:
        w = torch.randn((n, k), generator=gen, device="cuda") / math.sqrt(k)
        qw = quant.quantize_weight(w, layout)
        del w
        packed = shifted_copy(qw.w, shift) if shift else qw.w
        x = torch.randn((m, k), generator=gen, device="cuda").to(dt)
        args = (x, packed, qw.scale)
        n8 = k8.int4_matmul.launches
        y = k8.int4_matmul(*args, layout=layout)
        torch.cuda.synchronize()
        n8 = k8.int4_matmul.launches - n8
        y_p = k8.int4_matmul_plain(*args, layout=layout)
        budget = KERNEL_BUDGETS["int4_matmul_" + (
            "biased" if layout == "int4_biased" else "signed")]
        err = max_err(y, y_p)
        share = budget_share(y, y_p, *budget)
        ok = (bool(torch.isfinite(y.float()).all()) and share <= 1
              and n8 == 1)
        ms = roofline.cuda_ms(lambda: k8.int4_matmul(*args, layout=layout),
                     iters=50)
        resplits = k % 32 != 0 or packed.data_ptr() % 16 != 0
        # The re-split alone (inside ms, where the wrapper takes it).
        repack = ({"repack_ms": roofline.cuda_ms(
            lambda: k8.repack_halves(x, packed), iters=50)}
            if resplits else {})
        plain_ms = roofline.cuda_ms(lambda: k8.int4_matmul_plain(
            *args, layout=layout), iters=3, warmup=1)
        # Yardstick: F.linear over the dequantized weight, the same product
        # over a representation 4x (bf16) or 8x (fp32) as large.
        w_deq = qw.dequantize(dt)
        library_ms = roofline.cuda_ms(lambda: F.linear(x, w_deq), iters=50)
        del w_deq
        nbytes = (qw.w.numel() + 4 * n + x.numel() * x.element_size()
                  + m * n * x.element_size())
        bound_ms, bound_by = roofline.bound(
            2 * m * n * k, nbytes,
            roofline.BF16_FLOPS if dt == torch.bfloat16
            else roofline.FP32_FLOPS)
        tile = k8.int4_tile(m, n, dt, dev)
        ctas = -(-m // tile.block_m) * -(-n // tile.block_n)
        split = {}
        if tile.path == "splitk":
            # The decode tiles' split of K (ops/params.py's rule), over
            # the re-split K where the wrapper takes it.
            kp = -(-k // 32) * 32
            cols = params_mod.qmm_split_cols(n, kp, tile, dev)
            splits = -(-(kp // 2) // cols)
            ctas *= splits
            split = {"split_cols": cols, "splits": splits}
        key = (f"{layout}_{str(dt).split('.')[-1]}_M{m}_K{k}_N{n}"
               + (f"_off{shift}" if shift else ""))
        results[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=library_ms, **repack)
        if resplits:
            resplit[key] = results[key]
        emit({"phase": "k8", "case": key, "tile": tile.name,
              "path": tile.path, **split, "ctas": ctas, "launches": n8,
              "sms_busy": min(ctas, dev.sm_count),
              "tflops": 2 * m * n * k / (ms * 1e-3) / 1e12, "err": err,
              "budget": budget,
              "share": share, "ok": ok,
              "gb_per_s": nbytes / (ms * 1e-3) / 1e9,
              **{k_: v_ for k_, v_ in results[key].items()
                 if k_ != "max_abs_err"}})
        if not ok:
            raise SystemExit(f"k8 {key}: kernel disagrees with its plain "
                             f"version (uses {share} of |d| <= {budget[0]} "
                             f"+ {budget[1]}|y|, launches {n8})")
        del qw, packed, x, y, y_p
    torch.cuda.empty_cache()
    emit({"phase": "k8_done", "seconds": time.perf_counter() - t0})
    return results["int4_bfloat16_M4_K4096_N14336"], resplit


@contextlib.contextmanager
def plain_kernels():
    """K1-K8 swapped for their plain versions, for the in-context checks:
    ops/attention.py, ops/decode.py, ops/gemm.py and models/llama.py look
    the kernel functions up in their modules at each call."""
    from mfa_tpu_torch.kernels import decode as k5
    from mfa_tpu_torch.kernels import flash_bwd as k34
    from mfa_tpu_torch.kernels import flash_fwd as k1
    from mfa_tpu_torch.kernels import gemm_kernel as k7
    from mfa_tpu_torch.kernels import paged_decode as k6
    from mfa_tpu_torch.kernels import quant_matmul as k8

    def int4_plain(x, packed, scale, *, layout, device="cuda"):
        return k8.int4_matmul_plain(x, packed, scale, layout=layout)

    swaps = [(k1, "flash_fwd", k1.flash_fwd_plain),
             (k34, "flash_bwd_q", k34.flash_bwd_q_plain),
             (k34, "flash_bwd_kv", k34.flash_bwd_kv_plain),
             (k5, "decode_fused_append", k5.decode_fused_append_plain),
             (k5, "decode_attend", k5.decode_attend_plain),
             (k6, "paged_decode", k6.paged_decode_plain),
             (k7, "gemm_kernel", k7.gemm_kernel_plain),
             (k8, "int4_matmul", int4_plain)]
    real = [getattr(mod, attr) for mod, attr, _ in swaps]
    for mod, attr, plain in swaps:
        setattr(mod, attr, plain)
    yield
    for (mod, attr, _), fn in zip(swaps, real):
        setattr(mod, attr, fn)


def phase_serving(torch):
    import numpy as np

    from mfa_tpu_torch.models import llama
    from mfa_tpu_torch.ops.precision import OperandPrecision
    from mfa_tpu_torch.utils import roofline

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

        t_ms = roofline.cuda_ms(run, iters=3, warmup=1)
        prefill_ms[bucket] = t_ms
    emit({"phase": "prefill", "ms_per_bucket": prefill_ms})

    # In-context check of K1: the 1900-token prompt's last-position logits
    # through K1 and through its plain version.
    _in_context(torch, model, torch.tensor([prompts[-1]], device="cuda"),
                "k1", decode=False)

    launches, served = {}, {}
    for prec in (OperandPrecision.BF16, OperandPrecision.INT8,
                 OperandPrecision.FP8_E4M3):
        summary, n, toks = _serve(torch, model, prompts, prec, max_len=2048)
        _add(launches, n)
        emit({"phase": "serving", **summary})
        served[prec] = (toks, summary["decode_ms_per_step"])
    _serve_autotuned(torch, model, prompts, served[OperandPrecision.BF16][0])
    return launches, model, prompts, served


def _serve_autotuned(torch, model, prompts, untuned_tokens) -> None:
    """The six requests over the bf16 cache once more with the
    dispatch-path autotune on (ops/gemm.py::set_autotune): each prefill
    bucket's first K1 call searches its candidate rows once, every later
    layer launches the winner from the memo. Every K1 (and K2) launch
    outside the searches is held to its plain version
    (kernels_held_to_plain); K1 must carry every prefill and K2 every
    decode step. Greedy tokens may differ from the untuned run's (another
    row rounds differently). The autotune is off again after it."""
    from mfa_tpu_torch.ops.cache import attention_cache
    from mfa_tpu_torch.ops.gemm import SEARCH_LAUNCHES, set_autotune
    from mfa_tpu_torch.ops.precision import OperandPrecision

    memo = attention_cache.tuned
    attention_cache.clear()
    set_autotune(True)
    with kernels_held_to_plain(torch, pass_through=memo.searching) as (
            shares, k2, k1):
        summary, _, toks = _serve(
            torch, model, prompts, OperandPrecision.BF16, max_len=2048,
            k1_searched=lambda: sum(memo.timed.values()) * SEARCH_LAUNCHES)
    set_autotune(None)
    # The classes are the prefill buckets (R = C = bucket, batch 1).
    by_bucket = {key[1].seq_len_q: key for key in memo.searches}
    searches = {n: memo.searches[key] for n, key in sorted(by_bucket.items())}
    notes = {n: memo.notes.get(by_bucket[n], {}) for n in searches}
    attention_cache.clear()
    buckets = sorted({min(b for b in (64, 128, 256, 512, 1024, 2048)
                          if b >= len(p)) for p in prompts})
    ok = (summary["ok"] and list(searches) == buckets
          and all(v == 1 for v in searches.values())
          and all(x <= 1 for x in shares.values())
          and k2.get("rows_equal", True) and k2.get("excess_steps", 0) <= 1
          and k1.get("excess_steps", 0) <= 1)
    emit({"phase": "serving_autotune", **summary,
          "searches": searches,
          "candidates_timed": {n: len(v.get("candidates", ()))
                               for n, v in notes.items()},
          "winners": {n: [v.get("winner"), v.get("winner_row")]
                      for n, v in notes.items()},
          "winner_ms": {n: v.get("winner_ms") for n, v in notes.items()},
          "search_s": {n: v.get("search_s") for n, v in notes.items()},
          "table_ms": {n: v.get("table_ms") for n, v in notes.items()},
          "shares": shares, "decode": k2, "prefill": k1,
          "tokens_equal_untuned": toks == untuned_tokens,
          "tokens_note": "greedy tokens need not equal the untuned run's: "
                         "another K1 row rounds differently",
          "ok": ok})
    if not ok:
        raise SystemExit(f"serving under MFA_AUTOTUNE: searches {searches} "
                         f"(want one per bucket of {buckets}), shares "
                         f"{shares}, decode {k2}, prefill {k1}")


# Pages in the paged-serving pool, the null page included. The reckoning,
# for 512-token pages and the six prompts (50, 120, 250, 500, 1000, 1900
# tokens) queued twice in that order: admission asks for the pages of
# prompt + 1 tokens, 1, 1, 1, 1, 2 and 4 pages, and a 16-token answer
# grows only the 500-token prompt, into a second page. With 9 usable pages
# the first five requests take 6, the 1900-token prompt (4) is deferred
# (oom_deferred), and growth leaves 2 free; then 1900, 50, 120, 250 and
# 500 take 8, the 1000-token prompt (2) is deferred, and growth takes the
# last page; then 1000 and 1900 take 6. So the requests never fit at
# once, yet decode growth never exhausts the pool (admission counts only
# prompt pages, so a tighter pool would raise MemoryError mid-decode).
# Bytes: 10 pages x 32 layers x K and V x 8 kv heads x 512 x 128, 640 MiB
# in bf16.
PAGED_POOL_PAGES = 10


def phase_paged_serving(torch, model, prompts, contiguous_tokens,
                        formats=3, label="paged_serving", paths=None):
    """The paged scheduler at full width and depth, per KV format (the
    first ``formats`` of bf16, INT8 and FP8-e4m3). Returns K1's and K6's
    launches on this path; lines carry ``label`` and K6's launches by
    path, which also go into ``paths`` (format name -> {path: launches})
    where given."""
    import numpy as np

    from mfa_tpu_torch.kernels import decode as k2
    from mfa_tpu_torch.kernels import flash_fwd as k1
    from mfa_tpu_torch.kernels import paged_decode as k6
    from mfa_tpu_torch.serving.paged_scheduler import PagedScheduler
    from mfa_tpu_torch.serving.scheduler import Request

    t0 = time.perf_counter()
    cfg = model.cfg
    kw = dict(num_slots=8, num_pages=PAGED_POOL_PAGES, page_size=512,
              max_len=2048, device="cuda")

    # In-context check of K6: one decode step's logits through K6 and
    # through its plain version, from the same state (the step's append
    # writes the same rows both times).
    sched = PagedScheduler(model, **kw)
    for p in prompts:
        sched.submit(Request(prompt=p, max_new_tokens=16))
    sched.step()
    sched._ensure_decode_capacity()
    with torch.inference_mode():
        inputs = sched._step_inputs()
        active = [i for i, x in enumerate(sched.slots) if x is not None]
        logits_k = sched._decode_step(*inputs)[active]
        with plain_kernels():
            logits_p = sched._decode_step(*inputs)[active]
    scale = float(logits_p.abs().max())
    err = max_err(logits_k, logits_p)
    budget = 5e-2 * max(1.0, scale)
    argmax_equal = bool(torch.equal(logits_k.argmax(-1), logits_p.argmax(-1)))
    emit({"phase": "k6_in_context", "of": label, "active_slots": len(active),
          "max_abs_err": err, "budget": budget, "max_abs_logit": scale,
          "argmax_equal": argmax_equal})
    if not (err <= budget and argmax_equal):
        raise SystemExit(f"k6 in context: logits differ by {err} (budget "
                         f"{budget}), argmax equal {argmax_equal}")
    del sched
    torch.cuda.empty_cache()

    k1_launches = k6_launches = 0
    for name, prec in _kv_formats()[:formats]:
        sched = PagedScheduler(model, kv_precision=prec, **kw)
        start_free = sched.free_pages
        reqs = [Request(prompt=p, max_new_tokens=16) for p in prompts * 2]
        for r in reqs:
            sched.submit(r)
        torch.cuda.synchronize()
        for f in (k1.flash_fwd, k2.decode_fused_append, k6.paged_decode):
            f.launches = 0
        k6.paged_decode.launches_by_path.clear()
        decode_only = []
        t_run = time.perf_counter()
        for _ in range(2000):
            pre = sched.stats["prefills"]
            t_s = time.perf_counter()
            progressed = sched.step()
            torch.cuda.synchronize()
            if not progressed and not sched.queue:
                break
            if sched.stats["prefills"] == pre:
                decode_only.append((time.perf_counter() - t_s) * 1e3)
        else:
            raise SystemExit(f"paged serving {name}: no end after 2000 steps")
        sched._retire()
        run_s = time.perf_counter() - t_run
        n1, n2, n6 = (k1.flash_fwd.launches, k2.decode_fused_append.launches,
                      k6.paged_decode.launches)
        k6_paths = dict(k6.paged_decode.launches_by_path)
        if paths is not None:
            paths[name] = k6_paths
        k1_launches += n1
        k6_launches += n6
        done = {c.request.id: c for c in sched.finished}
        stats = dict(sched.stats)
        toks = [done[r.id].tokens for r in reqs if r.id in done]
        same = sum(a == b for t, ref in zip(toks, contiguous_tokens * 2)
                   for a, b in zip(t, ref))
        summary = dict(
            completions=len(done), tokens=stats["tokens"],
            prefills=stats["prefills"], decode_steps=stats["decode_steps"],
            oom_deferred=stats["oom_deferred"], k1_launches=n1,
            k2_launches=n2, k6_launches=n6, k6_paths=k6_paths,
            free_pages=sched.free_pages,
            start_free_pages=start_free, run_s=run_s,
            decode_ms_per_step=(float(np.median(decode_only))
                                if decode_only else None),
            tokens_per_s=stats["tokens"] / run_s,
            share_equal_to_contiguous_bf16=same / (16 * len(reqs)))
        ok = (len(done) == len(reqs)
              and all(len(done[r.id].tokens) == 16 for r in reqs)
              and stats["prefills"] == len(reqs)
              and n1 == cfg.n_layers * stats["prefills"]
              and n6 == cfg.n_layers * stats["decode_steps"] and n2 == 0
              and sum(k6_paths.values()) == n6
              and sched.free_pages == start_free
              and stats["oom_deferred"] >= 1)
        emit({"phase": label, "kv": name, "ok": ok, **summary})
        if not ok:
            raise SystemExit(f"paged serving {name}: completions, launch "
                             f"counts or pages wrong ({summary})")
        del sched
        torch.cuda.empty_cache()
    emit({"phase": f"{label}_done", "seconds": time.perf_counter() - t0,
          "k1_launches": k1_launches, "k6_launches": k6_launches})
    return k1_launches, k6_launches


# The ring schedule's shapes: Llama-3-8B's attention (Hq 32, Hkv 8, D 128,
# bf16) over 32768 tokens cut into sp = 4 chunks of 8192.
RING_SEQ, RING_SP = 32768, 4


def _ring_bound_ms(roofline, hq, hkv, t, d, diagonal, backward):
    """Least ms of one ring step's attention on t x t chunks (bf16): 4 d
    operations a visible (row, key) pair of every query head forward (K1),
    14 d backward (K3 6, K4 8); or its bytes if more: forward Q, K, V read
    and O and L written, backward Q, K, V, O, dO and L read and dQ, dK,
    dV written."""
    pairs = hq * (t * (t + 1) // 2 if diagonal else t * t)
    q_bytes, kv_bytes = 2 * hq * t * d, 2 * hkv * t * d
    if backward:
        return roofline.bound(14 * d * pairs,
                              4 * q_bytes + 4 * kv_bytes + 4 * hq * t)
    return roofline.bound(4 * d * pairs,
                          2 * q_bytes + 2 * kv_bytes + 4 * hq * t)


def phase_parallel(torch, model, smi, serve_prompts, served):
    """The parallel layer on one card: a world-1 NCCL mesh, the tp path
    on the served Llama-3-8B (no second copy), the sp = 4 ring schedule at
    full attention width, make_ring_attention at sp = 1, then part 2
    (:func:`parallel_part2`: sharded serving, the pipeline, the
    multi-host bootstrap). Returns the launches of K1 (and of them
    non-causal), K2, K3 and K4 on these paths."""
    import os

    import torch.distributed as dist

    from mfa_tpu_torch.kernels import decode as k2
    from mfa_tpu_torch.kernels import flash_bwd as k34
    from mfa_tpu_torch.kernels import flash_fwd as k1
    from mfa_tpu_torch.models import llama
    from mfa_tpu_torch.ops.attention import flash_attention
    from mfa_tpu_torch.parallel import mesh as mesh_mod
    from mfa_tpu_torch.parallel import ring_attention as ring
    from mfa_tpu_torch.parallel import sharding
    from mfa_tpu_torch.utils import roofline
    from mfa_tpu_torch.utils.testing import KERNEL_BUDGETS, budget_share

    rdv = Path(__file__).resolve().parent / "build" / (
        f"nccl_rendezvous_{os.getpid()}")
    rdv.parent.mkdir(exist_ok=True)
    rdv.unlink(missing_ok=True)
    t0 = time.perf_counter()
    mesh = mesh_mod.make_mesh(device="cuda", init_method=f"file://{rdv}",
                              rank=0, world_size=1)
    warm = torch.ones(1, device="cuda")
    for axis in mesh_mod.AXES:
        dist.all_reduce(warm, group=mesh.get_group(axis))
    torch.cuda.synchronize()
    nccl_init_s = time.perf_counter() - t0
    emit({"phase": "parallel_mesh", "card": smi, "backend":
          dist.get_backend(), "world": dist.get_world_size(),
          "mesh": dict(zip(mesh_mod.AXES, mesh.mesh.shape)),
          "nccl_init_s": nccl_init_s})

    # The tp path: the served model's own tensors under tp = 1, through
    # the NCCL group, against the same calls with tp_group=None.
    cfg = model.cfg
    gib = torch.cuda.memory_allocated() / 2**30
    tp_model = sharding.shard_model(model, mesh)
    no_copy = torch.cuda.memory_allocated() / 2**30 - gib
    gen = torch.Generator(device="cuda").manual_seed(12)
    bucket = torch.randint(1, cfg.vocab_size, (1, 512), generator=gen,
                           device="cuda")
    prompts = torch.randint(1, cfg.vocab_size, (2, 256), generator=gen,
                            device="cuda")
    steps = 4

    def serve(m, group):
        with torch.inference_mode():
            logits = llama.forward(m, bucket, tp_group=group)
            caches = m.make_caches(2, 512)
            pre, caches = llama.forward(m, prompts, caches=caches,
                                        tp_group=group)
            toks, outs = pre[:, -1].argmax(-1), [pre[:, -1]]
            for _ in range(steps):
                lg, caches = llama.decode_step(m, toks, caches,
                                               tp_group=group)
                toks = lg.argmax(-1)
                outs.append(lg)
        torch.cuda.synchronize()
        return logits, torch.stack(outs), caches[0].lengths

    want = serve(model, None)
    counters = (k1.flash_fwd, k2.decode_fused_append, k34.flash_bwd_q,
                k34.flash_bwd_kv)
    for f in counters:
        f.launches = 0
    k1.flash_fwd.noncausal_launches = 0
    tp_group = mesh.get_group("tp")
    got = serve(tp_model, tp_group)
    tp_equal = all(torch.equal(_bits(torch, a), _bits(torch, b))
                   for a, b in zip(got, want))
    emit({"phase": "parallel_tp", "tp": 1, "prefill_bucket": 512,
          "decode_steps": steps, "extra_gib": no_copy,
          "logits_bit_equal": tp_equal,
          "tokens": got[1].argmax(-1).tolist(), "ok": tp_equal})
    if not tp_equal or no_copy > 0.01:
        raise SystemExit(f"parallel tp: logits not bit-equal to the "
                         f"unsharded model ({tp_equal}) or a second copy "
                         f"({no_copy} GiB)")
    del tp_model, got, want

    # The sp = 4 ring at full attention width, every (rank, step) in this
    # process through the module's per-step functions.
    hq, hkv, d = 32, 8, 128
    q, k, v, do = (torch.randn((1, h, RING_SEQ, d), generator=gen,
                               device="cuda").bfloat16()
                   for h in (hq, hkv, hkv, hq))
    ring_out = {c: ring.ring_schedule(q, k, v, do, n=RING_SP, causal=c,
                                    device="cuda")
                for c in (False, True)}
    # make_ring_attention at sp = 1 through the NCCL group: one step, the
    # merge of one partial, must be flash_attention's O and gradients.
    sp1 = {}
    for c in (False, True):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o = ring.make_ring_attention(mesh, causal=c,
                                     device="cuda")(*leaves)
        o.backward(do)
        sp1[c] = (o.detach(), *(t.grad for t in leaves))
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in counters}
    launches["flash_fwd_noncausal"] = k1.flash_fwd.noncausal_launches

    rows = {}
    for c in (False, True):
        got = ring_out[c]
        # The same schedule over the plain versions, one KV head (and its
        # 4 query heads) at a time: heads are independent, and a whole
        # chunk's fp32 scores would need ~40 GB.
        with plain_kernels():
            plain = [torch.cat(parts, dim=1) for parts in zip(*(
                ring.ring_schedule(q[:, 4 * h:4 * h + 4], k[:, h:h + 1],
                                   v[:, h:h + 1], do[:, 4 * h:4 * h + 4],
                                   n=RING_SP, causal=c, device="cuda")
                for h in range(hkv)))]
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        full_o = flash_attention(*leaves, causal=c, device="cuda")
        full_o.backward(do)
        full = (full_o.detach(), *(t.grad for t in leaves))
        # Against full-sequence attention: the bf16 mixed budget, 5e-2,
        # relative above 1 (as the in-context logits): dV reaches ~10 on
        # these inputs (the first keys), where one bf16 step is 0.0625 and
        # the ring's bf16 travel rounds its accumulators at every hop.
        shares, full_err, full_share = {}, {}, {}
        for name, a, b_, p_ in zip(("o", "dq", "dk", "dv"), got, full,
                                   plain):
            key = ("flash_fwd_o_bf16" if name == "o"
                   else f"flash_bwd_{name}_bf16")
            shares[name] = budget_share(a, p_, *KERNEL_BUDGETS[key])
            full_err[name] = max_err(a, b_)
            full_share[name] = budget_share(
                a, b_, 0.0, 5e-2, scale=b_.float().abs().clamp_min(1.0))
        o1, _ = flash_attention(q, k, v, causal=c, with_lse=True,
                                device="cuda")
        sp1_equal = torch.equal(_bits(torch, sp1[c][0]), _bits(torch, o1))
        sp1_grads_equal = all(torch.equal(_bits(torch, a), _bits(torch, b_))
                              for a, b_ in zip(sp1[c][1:], full[1:]))
        finite = all(bool(torch.isfinite(t.float()).all()) for t in got)
        ok = (finite and all(x <= 1 for x in shares.values())
              and all(x <= 1 for x in full_share.values())
              and sp1_equal and sp1_grads_equal)
        name = "causal" if c else "noncausal"
        rows[name] = dict(shares=shares, full_share=full_share)
        emit({"phase": "parallel_ring", "case": name, "S": RING_SEQ,
              "sp": RING_SP, "Hq": hq, "Hkv": hkv, "D": d,
              "share_of_kernel_budgets_vs_plain_schedule": shares,
              "max_abs_err_vs_full_sequence": full_err,
              "share_of_mixed_5e-2_vs_full_sequence": full_share,
              "sp1_o_bit_equal": sp1_equal,
              "sp1_grads_bit_equal": sp1_grads_equal, "finite": finite,
              "ok": ok})
        if not ok:
            raise SystemExit(f"parallel ring {name}: shares {shares}, "
                             f"full-sequence shares {full_share}, sp = 1 "
                             f"equal {sp1_equal}/{sp1_grads_equal}")
        del plain, full, full_o, leaves, o1
        torch.cuda.empty_cache()

    # Times: one ring step (a full chunk: K1's non-causal mode; the
    # diagonal chunk: its causal grid), forward and backward, and the
    # full-sequence K1 at the same S.
    t = RING_SEQ // RING_SP
    qc, kc, vc, doc = (x[:, :, :t].contiguous() for x in (q, k, v, do))
    o_acc, lse_acc = ring.init_partials(qc)
    times = {}
    for label, my in (("full", 1), ("diagonal", 0)):
        kw = dict(my=my, src=0, causal=True, device="cuda")
        times[f"fwd_step_{label}"] = roofline.cuda_ms(
            lambda: ring.forward_step(qc, kc, vc, o_acc, lse_acc, **kw),
            iters=10)
        o_s, l_s = ring.forward_step(qc, kc, vc, o_acc, lse_acc, **kw)
        o_s = o_s.bfloat16()
        times[f"bwd_step_{label}"] = roofline.cuda_ms(
            lambda: ring.chunk_grads(qc, kc, vc, o_s, doc, l_s, **kw),
            iters=10)
        for way in ("fwd", "bwd"):
            times[f"bound_{way}_step_{label}"] = _ring_bound_ms(
                roofline, hq, hkv, t, d, label == "diagonal", way == "bwd")
    for c in (False, True):
        times["full_sequence_k1_" + ("causal" if c else "noncausal")] = \
            roofline.cuda_ms(lambda: flash_attention(
                q, k, v, causal=c, device="cuda"), iters=5)
    emit({"phase": "parallel_times", "card": smi, "ms": times,
          "nccl_init_s": nccl_init_s})
    ok = (launches["flash_fwd_noncausal"] > 0 and launches["flash_bwd_q"] > 0
          and launches["flash_bwd_kv"] > 0
          and launches["decode_fused_append"] == cfg.n_layers * steps)
    emit({"phase": "parallel", "launches": launches, "ring": rows,
          "ok": ok})
    if not ok:
        raise SystemExit(f"parallel: launches {launches}")
    del q, k, v, do, ring_out, sp1
    torch.cuda.empty_cache()
    _add(launches, parallel_part2(torch, model, mesh, serve_prompts, served,
                                  smi))
    dist.destroy_process_group()
    rdv.unlink(missing_ok=True)
    return launches


# The pipeline's batch: four sequences of 512 tokens, one a microbatch.
PIPELINE_BATCH, PIPELINE_SEQ, PIPELINE_STAGES = 4, 512, 4


def parallel_part2(torch, model, mesh, prompts, served, smi) -> dict:
    """The parallel layer's part 2 on the world-1 NCCL mesh: the
    served Llama-3-8B behind ShardedScheduler (dp 1, tp 1: its own
    tensors) over bf16 and INT8 caches, six requests, greedy tokens
    bit-equal to the single-card scheduler's (``served``, from the serving
    phase) and decode ms a step beside its; pipeline_schedule over 4
    stages of 8 layers and 4 microbatches against forward (the bf16
    mixed budget), forward_pipelined over the mesh's pp = 1 bit-equal to
    pipeline_schedule over one stage; multihost.initialize_distributed a
    no-op. Counters are set to 0 just before each path and read just
    after; returns the K1 and K2 launches."""
    from mfa_tpu_torch.kernels import decode as k2
    from mfa_tpu_torch.kernels import flash_fwd as k1
    from mfa_tpu_torch.models import llama
    from mfa_tpu_torch.ops.precision import OperandPrecision
    from mfa_tpu_torch.parallel import multihost
    from mfa_tpu_torch.serving.distributed import ShardedScheduler
    from mfa_tpu_torch.utils import roofline

    info = multihost.initialize_distributed()
    launches = {}
    rows = {}
    for prec in (OperandPrecision.BF16, OperandPrecision.INT8):
        summary, n, toks = _serve(torch, model, prompts, prec, max_len=2048,
                                  scheduler=ShardedScheduler, mesh=mesh)
        _add(launches, n)
        want, single_ms = served[prec]
        equal = toks == want
        rows[prec.value] = dict(
            tokens_bit_equal_single_card=equal,
            decode_ms_per_step=summary["decode_ms_per_step"],
            single_card_decode_ms_per_step=single_ms)
        emit({"phase": "parallel_sharded_serving", "dp": 1, "tp": 1,
              **summary, "tokens_bit_equal_single_card": equal,
              "single_card_decode_ms_per_step": single_ms})
        if not equal:
            raise SystemExit(f"sharded serving ({prec.value}): greedy tokens "
                             f"differ from the single-card scheduler's")

    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(13)
    tokens = torch.randint(1, cfg.vocab_size, (PIPELINE_BATCH, PIPELINE_SEQ),
                           generator=gen, device="cuda")
    m = PIPELINE_BATCH
    with torch.inference_mode():
        want = model(tokens)
        forward_ms = roofline.cuda_ms(lambda: model(tokens), iters=2,
                                      warmup=1)
        torch.cuda.synchronize()
        for f in (k1.flash_fwd, k2.decode_fused_append):
            f.launches = 0
        got = llama.forward_pipeline_schedule(
            model, tokens, n_stages=PIPELINE_STAGES, num_microbatches=m)
        one_stage = llama.forward_pipeline_schedule(
            model, tokens, n_stages=1, num_microbatches=m)
        piped = llama.forward_pipelined(model, tokens, mesh=mesh,
                                        num_microbatches=m)
        torch.cuda.synchronize()
        pipe_launches = k1.flash_fwd.launches
        schedule_ms = roofline.cuda_ms(lambda: llama.forward_pipeline_schedule(
            model, tokens, n_stages=PIPELINE_STAGES, num_microbatches=m),
            iters=2, warmup=1)
    scale = float(want.float().abs().max())
    share = max_err(got, want) / (5e-2 * max(1.0, scale))
    piped_share = max_err(piped, want) / (5e-2 * max(1.0, scale))
    bit_equal = torch.equal(_bits(torch, got), _bits(torch, want))
    piped_equal = torch.equal(_bits(torch, piped), _bits(torch, one_stage))
    finite = bool(torch.isfinite(got).all() and torch.isfinite(piped).all())
    steps = m + PIPELINE_STAGES - 1
    # Every stage computes at every step (empty slots on zeros, as in
    # mfa_tpu): the 4-stage schedule and the two one-stage runs.
    want_k1 = cfg.n_layers * (steps + 2 * m)
    ok = (finite and share <= 1 and piped_share <= 1 and piped_equal
          and pipe_launches == want_k1 and info["process_count"] == 1)
    emit({"phase": "parallel_pipeline", "card": smi,
          "stages": PIPELINE_STAGES, "layers_a_stage":
          cfg.n_layers // PIPELINE_STAGES, "microbatches": m,
          "seq": PIPELINE_SEQ, "share_of_mixed_5e-2_vs_forward": share,
          "bit_equal_forward": bit_equal,
          "pipelined_pp1_share_vs_forward": piped_share,
          "pipelined_pp1_bit_equal_one_stage_schedule": piped_equal,
          "k1_launches": pipe_launches, "want_k1_launches": want_k1,
          "schedule_ms": schedule_ms, "forward_ms": forward_ms,
          "multihost": info, "sharded_serving": rows, "ok": ok})
    if not ok:
        raise SystemExit(f"parallel pipeline: share {share}, pp = 1 share "
                         f"{piped_share} (bit-equal {piped_equal}), K1 "
                         f"launches {pipe_launches} of {want_k1}, "
                         f"multihost {info}")
    launches["flash_fwd"] = launches.get("flash_fwd", 0) + pipe_launches
    del want, got, one_stage, piped
    torch.cuda.empty_cache()
    return {k: launches[k] for k in ("flash_fwd", "decode_fused_append")}


def _weight_gib(model) -> float:
    """Device bytes of a model's weights (parameters and the quantized
    projections' buffers), GiB."""
    return sum(t.numel() * t.element_size()
               for t in (*model.parameters(), *model.buffers())) / 2**30


def phase_int4_serving(torch, int4_model, int8_model, prompts, bf16_gib,
                       bf16_tokens):
    """Llama-3-8B with INT4 weight-only projections (K8) and an FP8-e4m3
    KV cache behind the continuous-batching scheduler; one short INT8
    request. Returns the launches of K1, K2 and K8 on this path."""
    import numpy as np

    from mfa_tpu_torch.kernels import quant_matmul as k8
    from mfa_tpu_torch.ops.precision import OperandPrecision
    from mfa_tpu_torch.serving.scheduler import (
        ContinuousBatchingScheduler,
        Request,
    )

    t0 = time.perf_counter()
    cfg = int4_model.cfg
    fp8 = OperandPrecision.FP8_E4M3
    int4_gib = _weight_gib(int4_model)
    emit({"phase": "int4_init", "weights_gib": int4_gib,
          "bf16_weights_gib": bf16_gib,
          "int4_projection_gib": sum(
              b.numel() * b.element_size() for b in int4_model.buffers())
          / 2**30, "device_gib": torch.cuda.memory_allocated() / 2**30})

    # In-context check of K8: a prefill and one decode step's logits
    # through K8 (and K1, K2) against the same step through their plain
    # versions, from the same state.
    rng = np.random.default_rng(8)
    _in_context(torch, int4_model, torch.from_numpy(
        rng.integers(1, cfg.vocab_size, (4, 256))).cuda(), "k8",
        kv_precision=fp8, max_len=2048)
    torch.cuda.empty_cache()

    summary, launches, toks = _serve(torch, int4_model, prompts, fp8,
                                     max_len=2048, int4_weights=True)
    same = sum(a == b for t, ref in zip(toks, bf16_tokens)
               for a, b in zip(t, ref))
    emit({"phase": "int4_serving", **summary,
          "share_equal_to_bf16": same / (16 * len(toks)),
          "weights_gib": int4_gib, "bf16_weights_gib": bf16_gib})

    # One short request with INT8 weights: the plain INT8 branch.
    sched = ContinuousBatchingScheduler(int8_model, num_slots=1,
                                        max_len=2048, kv_precision=fp8,
                                        device="cuda")
    sched.submit(Request(prompt=prompts[0], max_new_tokens=4))
    k8.int4_matmul.launches = 0
    t_s = time.perf_counter()
    done8 = sched.run()
    torch.cuda.synchronize()
    int8_ok = (len(done8) == 1 and len(done8[0].tokens) == 4
               and k8.int4_matmul.launches == 0)
    emit({"phase": "int8_request", "ok": int8_ok, "tokens": done8[0].tokens,
          "seconds": time.perf_counter() - t_s,
          "weights_gib": _weight_gib(int8_model)})
    if not int8_ok:
        raise SystemExit("int8 request: did not complete through the plain "
                         "INT8 branch")
    del sched
    torch.cuda.empty_cache()
    emit({"phase": "int4_serving_done", "seconds": time.perf_counter() - t0,
          "k8_launches": launches["int4_matmul"]})
    return launches


def _sdpa_backward_ms(torch, F, q, k, v, do, mask, is_causal, scale):
    """Device ms of the backward of one scaled_dot_product_attention call
    (dQ, dK and dV together), as forward+backward minus forward."""
    from mfa_tpu_torch.utils import roofline

    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=is_causal, scale=scale,
            enable_gqa=True)

    fwd_ms = roofline.cuda_ms(fwd, iters=10)
    both_ms = roofline.cuda_ms(lambda: torch.autograd.grad(fwd(), (q, k, v),
                                                         do), iters=10)
    return both_ms - fwd_ms


# phase_bwd's cases, (name, R, C, dtype, options, Hq, Hkv, D, q's base
# shift in bytes): Llama-3-8B's attention (Hq 32, Hkv 8, D 128, N 2048),
# then rows TMA cannot map: OpenLLaMA-3B's (D 100, Hq = Hkv 32, N 2048;
# the wgmma kernels' copying producers) causal and not, and D 250 at B 1,
# H 8, N 1024 causal (one CTA of the head-dim-split kernels, copying);
# OpenLLaMA-3B's causal again and D 250 again with q 2 bytes off 16 (no
# 4-byte granule: the mma.sync rows, block_d 128 and 256). BWD_HEAD_DIM_
# CASES carry their own lines in the kernels line.
BWD_CASES = (
    ("causal", 2048, 2048, "bf16", dict(causal=True), 32, 8, 128, 0),
    ("noncausal", 2048, 2048, "bf16", dict(), 32, 8, 128, 0),
    ("window512", 2048, 2048, "bf16", dict(sliding_window=512), 32, 8, 128,
     0),
    ("softcap50", 2048, 2048, "bf16", dict(causal=True, logit_soft_cap=50.0),
     32, 8, 128, 0),
    ("causal_r512_c2048", 512, 2048, "bf16", dict(causal=True), 32, 8, 128,
     0),
    ("window512_r512_c2048", 512, 2048, "bf16", dict(sliding_window=512), 32,
     8, 128, 0),
    ("fp32_causal", 2048, 2048, "fp32", dict(causal=True), 32, 8, 128, 0),
    ("openllama_causal_d100", 2048, 2048, "bf16", dict(causal=True), 32, 32,
     100, 0),
    ("openllama_noncausal_d100", 2048, 2048, "bf16", dict(), 32, 32, 100, 0),
    ("causal_d250_n1024", 1024, 1024, "bf16", dict(causal=True), 8, 8, 250,
     0),
    ("openllama_causal_d100_q_shift2", 2048, 2048, "bf16",
     dict(causal=True), 32, 32, 100, 2),
    ("causal_d250_q_shift2_n1024", 1024, 1024, "bf16", dict(causal=True), 8,
     8, 250, 2),
)
BWD_HEAD_DIM_CASES = ("openllama_causal_d100", "openllama_noncausal_d100",
                      "causal_d250_n1024", "openllama_causal_d100_q_shift2",
                      "causal_d250_q_shift2_n1024")


def phase_bwd(torch):
    """K3 and K4 at BWD_CASES against their plain versions; returns the
    causal case's figures and those of BWD_HEAD_DIM_CASES."""
    import torch.nn.functional as F

    from mfa_tpu_torch.kernels import flash_bwd as k34
    from mfa_tpu_torch.kernels import flash_fwd as k1
    from mfa_tpu_torch.ops.descriptors import (
        AttentionDescriptor,
        AttentionKernelType,
        row_label,
    )
    from mfa_tpu_torch.utils import roofline
    from mfa_tpu_torch.utils.testing import (
        KERNEL_BUDGETS,
        budget_share,
        nan_canary,
    )

    gen = torch.Generator(device="cuda").manual_seed(3)
    results = {}
    for name, r, c, tag, opts, hq, hkv, d, shift in BWD_CASES:
        dtype = torch.bfloat16 if tag == "bf16" else torch.float32
        q, k, v = _k1_inputs(torch, gen, r, c, dtype, hq, hkv, d)
        do = torch.randn((1, hq, r, d), generator=gen, device="cuda").to(dtype)
        desc = AttentionDescriptor(
            batch=1, num_q_heads=hq, num_kv_heads=hkv, seq_len_q=r,
            seq_len_kv=c, head_dim=d,
            low_precision_inputs=dtype != torch.float32,
            low_precision_intermediates=dtype != torch.float32, **opts)
        kd_f, kd_q, kd_kv = (desc.kernel_descriptor(t)
                             for t in AttentionKernelType)
        q3, k3, v3, do3 = (t.reshape(-1, t.shape[2], d).contiguous()
                           for t in (q, k, v, do))
        if shift:
            buf = torch.empty(q3.numel() + 8, dtype=dtype, device="cuda")
            at = shift // q3.element_size()
            q3 = buf[at:at + q3.numel()].view(q3.shape)
            q3.copy_(q.reshape(q3.shape))
        kw = dict(group=hq // hkv, scale=desc.softmax_scale)
        o3, lse = k1.flash_fwd(q3, k3, v3, kd_f, o_dtype=dtype, **kw)
        # The rows K3 and K4 run (row_label; k1_row's rule holds for all
        # three kernels).
        rows = {key: dict(dataclasses.asdict(row), label=row_label(row))
                for key, row in (
                    (key, k34.launch_row(kd, d, (q3, k3, v3, do3)))
                    for key, kd in (("k3", kd_q), ("k4", kd_kv)))}
        want_row = k1_row(d, shift) if tag == "bf16" else ""
        rows_ok = all(r_["label"] == want_row for r_ in rows.values())
        dq, dterm = k34.flash_bwd_q(
            q3, k3, v3, o3, do3, lse, kd_q, **kw,
            out=(nan_canary(q3.shape, device="cuda"),
                 nan_canary(lse.shape, device="cuda")))
        dk, dv = k34.flash_bwd_kv(
            q3, k3, v3, do3, lse, dterm, kd_kv, **kw,
            out=(nan_canary(k3.shape, device="cuda"),
                 nan_canary(k3.shape, device="cuda")))
        torch.cuda.synchronize()
        dk2, dv2 = k34.flash_bwd_kv(q3, k3, v3, do3, lse, dterm, kd_kv, **kw)
        deterministic = bool(torch.equal(dk, dk2) and torch.equal(dv, dv2))
        del dk2, dv2
        dq_p, dterm_p = k34.flash_bwd_q_plain(q3, k3, v3, o3, do3, lse, kd_q,
                                              **kw)
        dk_p, dv_p = k34.flash_bwd_kv_plain(q3, k3, v3, do3, lse, dterm,
                                            kd_kv, **kw)
        shares, errs = {}, {}
        for key, got, want, budget in (
                ("dq", dq, dq_p, f"flash_bwd_dq_{tag}"),
                ("dk", dk, dk_p, f"flash_bwd_dk_{tag}"),
                ("dv", dv, dv_p, f"flash_bwd_dv_{tag}"),
                ("dterm", dterm, dterm_p, "flash_bwd_dterm")):
            shares[key] = budget_share(got, want, *KERNEL_BUDGETS[budget])
            errs[key] = max_err(got, want)
        finite = all(bool(torch.isfinite(t).all()) for t in (dq, dterm, dk,
                                                            dv))
        vis = k1.visible_mask(r, c, kd_q.causal, kd_q.sliding_window, "cuda")
        unseen = ~vis.any(dim=0)              # keys that no query sees
        unseen_zero = bool((dk[:, unseen] == 0).all()
                           and (dv[:, unseen] == 0).all())
        del dq_p, dterm_p, dk_p, dv_p
        ms_q = roofline.cuda_ms(lambda: k34.flash_bwd_q(
            q3, k3, v3, o3, do3, lse, kd_q, **kw))
        ms_kv = roofline.cuda_ms(lambda: k34.flash_bwd_kv(
            q3, k3, v3, do3, lse, dterm, kd_kv, **kw))
        plain_q = roofline.cuda_ms(lambda: k34.flash_bwd_q_plain(
            q3, k3, v3, o3, do3, lse, kd_q, **kw), iters=3, warmup=1)
        plain_kv = roofline.cuda_ms(lambda: k34.flash_bwd_kv_plain(
            q3, k3, v3, do3, lse, dterm, kd_kv, **kw), iters=3, warmup=1)
        # Work of these inputs: the visible (row, key) pairs of every
        # query head; each input read once, each output written once.
        pairs = int(vis.sum()) * hq
        esz = q3.element_size()
        in_q = (2 * q3.numel() + 2 * k3.numel()) * esz
        peak = (roofline.BF16_FLOPS if dtype == torch.bfloat16
                else roofline.FP32_FLOPS)
        bound_q, by_q = roofline.bound(
            6 * d * pairs, in_q + o3.numel() * o3.element_size()
            + 4 * lse.numel() + 4 * dq.numel() + 4 * dterm.numel(), peak)
        bound_kv, by_kv = roofline.bound(
            8 * d * pairs, in_q + 8 * lse.numel() + 8 * dk.numel(), peak)
        library_ms = None
        if "logit_soft_cap" not in opts:
            plain_causal = kd_q.causal and r == c and not kd_q.sliding_window
            mask = (None if plain_causal
                    or not (kd_q.causal or kd_q.sliding_window) else vis)
            library_ms = _sdpa_backward_ms(torch, F, q, k, v, do, mask,
                                           plain_causal, desc.softmax_scale)
        ok = (finite and deterministic and unseen_zero and rows_ok
              and all(x <= 1 for x in shares.values()))
        results[name] = dict(
            q=dict(max_abs_err=errs["dq"], ms=ms_q, plain_ms=plain_q,
                   bound_ms=bound_q, bound_by=by_q, library_ms=library_ms),
            kv=dict(max_abs_err=max(errs["dk"], errs["dv"]), ms=ms_kv,
                    plain_ms=plain_kv, bound_ms=bound_kv, bound_by=by_kv,
                    library_ms=library_ms))
        emit({"phase": "bwd", "case": name, "R": r, "C": c, "Hq": hq,
              "Hkv": hkv, "D": d, "q_shift_bytes": shift, "dtype": tag,
              "rows": rows, "want_row": want_row, "share": shares,
              "err": errs, "ms_k3": ms_q,
              "ms_k4": ms_kv,
              "plain_ms_k3": plain_q, "plain_ms_k4": plain_kv,
              "bound_ms_k3": bound_q, "bound_by_k3": by_q,
              "bound_ms_k4": bound_kv, "bound_by_k4": by_kv,
              "sdpa_backward_ms": library_ms, "deterministic_k4":
              deterministic, "unseen_keys": int(unseen.sum()),
              "unseen_keys_zero": unseen_zero, "finite": finite, "ok": ok})
        if not ok:
            raise SystemExit(f"bwd {name}: kernels disagree with their plain "
                             f"versions (shares {shares}, finite {finite}, "
                             f"deterministic {deterministic}, unseen keys "
                             f"zero {unseen_zero}) or ran rows {rows} "
                             f"(wanted {want_row})")
        del q, k, v, do, q3, k3, v3, do3, o3, lse, dq, dterm, dk, dv
        torch.cuda.empty_cache()
    return results["causal"], {case: results[case]
                               for case in BWD_HEAD_DIM_CASES}


def _sdpa_backend(torch, fn) -> str:
    """Which of torch's scaled_dot_product_attention backends ran fn():
    read from the names of the CUDA kernels one call launches."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = " ".join(e.key.lower() for e in prof.key_averages())
    for key, backend in (("flash", "flash"), ("cudnn", "cudnn"),
                         ("fmha", "efficient"), ("efficient", "efficient"),
                         ("cutlass", "efficient")):
        if key in names:
            return backend
    return "math"


# The large-D class of the JAX package (README.md: bf16, B 1, H 8, N
# 4096, D 384 and 512): (name, dtype, D, N, Hkv, options). Hq 8 always;
# the tails (D 320, D 300 and D 250 where TMA could not map a row: the
# D-blocked first cut past 256, the mma.sync rows of K1, K3 and K4 at
# 129-256) and fp32 at N 1024; D 256 and 192 (K1, K3 and K4 on one CTA of
# the head-dim-split kernels) at N 4096, D 256 also with Gemma-2-9B's
# attention (google/gemma-2-9b config.json: head dim 256, 16 query heads
# to 8 kv heads, attn_logit_softcapping 50; its 4096 window covers N).
# K3 and K4 run every case but the soft-cap ones.
LARGE_D_CASES = (
    ("noncausal_d384", "bf16", 384, 4096, 8, dict()),
    ("causal_d384", "bf16", 384, 4096, 8, dict(causal=True)),
    ("noncausal_d512", "bf16", 512, 4096, 8, dict()),
    ("causal_d512", "bf16", 512, 4096, 8, dict(causal=True)),
    ("gqa_causal_d384_hkv2", "bf16", 384, 4096, 2, dict(causal=True)),
    ("window512_softcap50_d384", "bf16", 384, 4096, 8,
     dict(sliding_window=512, logit_soft_cap=50.0)),
    ("noncausal_d320_n1024", "bf16", 320, 1024, 8, dict()),
    ("causal_d300_n1024", "bf16", 300, 1024, 8, dict(causal=True)),
    ("causal_d250_n1024", "bf16", 250, 1024, 8, dict(causal=True)),
    ("noncausal_d250_n1024", "bf16", 250, 1024, 8, dict()),
    ("fp32_causal_d384_n1024", "fp32", 384, 1024, 8, dict(causal=True)),
    ("causal_d256", "bf16", 256, 4096, 8, dict(causal=True)),
    ("causal_d192", "bf16", 192, 4096, 8, dict(causal=True)),
    ("noncausal_d256", "bf16", 256, 4096, 8, dict()),
    ("gqa_softcap50_d256", "bf16", 256, 4096, 4,
     dict(causal=True, logit_soft_cap=50.0)),
)


def large_d_rows(tag: str, d: int) -> dict:
    """The rows (row_label) phase_large_d expects of K1, K3 and K4 past D
    = 128: the head-dim-split kernels (wgmma_dblk; one CTA up to D = 256)
    where TMA maps a row (bf16, D % 8 == 0) up to D = 512; their one CTA
    with its cp.async producer at the other even D up to 256; else the
    first cut (mma.sync up to D = 256, D-blocked past it)."""
    if tag == "fp32":
        return {"k1": "fma_dblk", "k3": "fma_dblk", "k4": "fma_dblk"}
    row = ("wgmma_dblk" if d % 8 == 0 and d <= 512
           else "wgmma_dblk/copy" if d <= 256 and d % 2 == 0
           else "mma" if d <= 256 else "mma_dblk")
    return {"k1": row, "k3": row, "k4": row}


def phase_large_d(torch):
    """K1, K3 and K4 past D = 256 (the head-dim-split kernels and the
    D-blocked rows) and at D 256 and 192 (one CTA of the head-dim-split
    kernels) against their plain versions, then flash_attention's forward
    and backward end to end at D 384 (B 1, H 8, N 4096, causal): each
    held to the same call through the plain versions, the launch counters
    read around it."""
    import torch.nn.functional as F

    from mfa_tpu_torch.kernels import flash_bwd as k34
    from mfa_tpu_torch.kernels import flash_fwd as k1
    from mfa_tpu_torch.ops import params as params_mod
    from mfa_tpu_torch.ops.attention import flash_attention
    from mfa_tpu_torch.ops.descriptors import (
        AttentionDescriptor,
        AttentionKernelType,
        head_dim_panels,
        launch_row,
        row_label,
    )
    from mfa_tpu_torch.utils import roofline
    from mfa_tpu_torch.utils.testing import (
        KERNEL_BUDGETS,
        budget_share,
        nan_canary,
    )

    gen = torch.Generator(device="cuda").manual_seed(11)
    dev = params_mod.detect_device(torch.device("cuda", 0))
    hq = 8
    results = {}
    for name, tag, d, n, hkv, opts in LARGE_D_CASES:
        dtype = torch.bfloat16 if tag == "bf16" else torch.float32
        q, k, v = _k1_inputs(torch, gen, n, n, dtype, hq, hkv, d)
        do = torch.randn((1, hq, n, d), generator=gen, device="cuda").to(dtype)
        desc = AttentionDescriptor(
            batch=1, num_q_heads=hq, num_kv_heads=hkv, seq_len_q=n,
            seq_len_kv=n, head_dim=d, low_precision_inputs=tag == "bf16",
            low_precision_intermediates=tag == "bf16", **opts)
        kd_f, kd_q, kd_kv = (desc.kernel_descriptor(t, dev)
                             for t in AttentionKernelType)
        q3, k3, v3, do3 = (t.reshape(-1, n, d).contiguous()
                           for t in (q, k, v, do))
        kw = dict(group=hq // hkv, scale=desc.softmax_scale)
        rows = {}
        for key, kd in (("k1", kd_f), ("k3", kd_q), ("k4", kd_kv)):
            row = launch_row(kd, d, (q3, k3, v3, do3))
            rows[key] = dict(dataclasses.asdict(row), label=row_label(row),
                             panels=head_dim_panels(row, d))
        want = large_d_rows(tag, d)
        # Up to D = 256 every launch covers the head dim in one CTA.
        dblk = all(rows[key]["label"] == want[key]
                   and (d > 256 or rows[key]["panels"] == 1)
                   for key in rows)
        vis = k1.visible_mask(n, n, kd_f.causal, kd_f.sliding_window, "cuda")
        pairs = int(vis.sum()) * hq
        esz = q3.element_size()
        peak = (roofline.BF16_FLOPS if dtype == torch.bfloat16
                else roofline.FP32_FLOPS)
        plain_causal = kd_f.causal and not kd_f.sliding_window
        mask = (None if plain_causal or not (kd_f.causal
                                             or kd_f.sliding_window) else vis)

        def sdpa():
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=plain_causal,
                scale=desc.softmax_scale, enable_gqa=True)

        # K1: NaN-prefilled outputs, a second launch bit-equal.
        o, lse = k1.flash_fwd(q3, k3, v3, kd_f, o_dtype=dtype, **kw, out=(
            nan_canary(q3.shape, dtype, device="cuda"),
            nan_canary(q3.shape[:2], device="cuda")))
        o2, lse2 = k1.flash_fwd(q3, k3, v3, kd_f, o_dtype=dtype, **kw)
        same = {"k1": bool(torch.equal(o, o2) and torch.equal(lse, lse2))}
        del o2, lse2
        torch.cuda.synchronize()
        o_p, l_p = k1.flash_fwd_plain(q3, k3, v3, kd_f, o_dtype=dtype, **kw)
        shares = {"o": budget_share(o, o_p,
                                    *KERNEL_BUDGETS[f"flash_fwd_o_{tag}"]),
                  "l": budget_share(lse, l_p, *KERNEL_BUDGETS["flash_fwd_l"])}
        errs = {"o": max_err(o, o_p), "l": max_err(lse, l_p)}
        del o_p, l_p
        fwd_bytes = 2 * (q3.numel() + k3.numel()) * esz + 4 * lse.numel()
        bound = roofline.bound(roofline.attention_flops("forward", 1, 1, d)
                               * pairs, fwd_bytes, peak)
        lib = None
        backend = None
        if kd_f.logit_soft_cap is None:
            backend = _sdpa_backend(torch, sdpa)
            lib = roofline.cuda_ms(sdpa, iters=10)
        timed = {"k1": dict(
            ms=roofline.cuda_ms(lambda: k1.flash_fwd(q3, k3, v3, kd_f,
                                                     o_dtype=dtype, **kw)),
            plain_ms=roofline.cuda_ms(lambda: k1.flash_fwd_plain(
                q3, k3, v3, kd_f, o_dtype=dtype, **kw), iters=3, warmup=1),
            bound_ms=bound[0], bound_by=bound[1], library_ms=lib,
            max_abs_err=errs["o"])}
        if kd_f.logit_soft_cap is None:
            # K3 and K4 on K1's O and L, NaN-prefilled; K4 twice.
            dq, dterm = k34.flash_bwd_q(
                q3, k3, v3, o, do3, lse, kd_q, **kw,
                out=(nan_canary(q3.shape, device="cuda"),
                     nan_canary(lse.shape, device="cuda")))
            dk, dv = k34.flash_bwd_kv(
                q3, k3, v3, do3, lse, dterm, kd_kv, **kw,
                out=(nan_canary(k3.shape, device="cuda"),
                     nan_canary(k3.shape, device="cuda")))
            dq2, dterm2 = k34.flash_bwd_q(q3, k3, v3, o, do3, lse, kd_q, **kw)
            dk2, dv2 = k34.flash_bwd_kv(q3, k3, v3, do3, lse, dterm, kd_kv,
                                        **kw)
            same["k3"] = bool(torch.equal(dq, dq2)
                              and torch.equal(dterm, dterm2))
            same["k4"] = bool(torch.equal(dk, dk2) and torch.equal(dv, dv2))
            del dq2, dterm2, dk2, dv2
            torch.cuda.synchronize()
            dq_p, dterm_p = k34.flash_bwd_q_plain(q3, k3, v3, o, do3, lse,
                                                  kd_q, **kw)
            dk_p, dv_p = k34.flash_bwd_kv_plain(q3, k3, v3, do3, lse, dterm,
                                                kd_kv, **kw)
            for key, got, want, budget in (
                    ("dq", dq, dq_p, f"flash_bwd_dq_{tag}"),
                    ("dk", dk, dk_p, f"flash_bwd_dk_{tag}"),
                    ("dv", dv, dv_p, f"flash_bwd_dv_{tag}"),
                    ("dterm", dterm, dterm_p, "flash_bwd_dterm")):
                shares[key] = budget_share(got, want,
                                           *KERNEL_BUDGETS[budget])
                errs[key] = max_err(got, want)
            unseen = ~vis.any(dim=0)          # keys that no query sees
            same["unseen_keys_zero"] = bool((dk[:, unseen] == 0).all()
                                            and (dv[:, unseen] == 0).all())
            del dq_p, dterm_p, dk_p, dv_p
            in_bytes = 2 * (q3.numel() + k3.numel()) * esz
            b3 = roofline.bound(
                roofline.attention_flops("backward_query", 1, 1, d) * pairs,
                in_bytes + o.numel() * o.element_size() + 4 * lse.numel()
                + 4 * dq.numel() + 4 * dterm.numel(), peak)
            b4 = roofline.bound(
                roofline.attention_flops("backward_key_value", 1, 1, d)
                * pairs, in_bytes + 8 * lse.numel() + 8 * dk.numel(), peak)
            lib_bwd = _sdpa_backward_ms(torch, F, q, k, v, do, mask,
                                        plain_causal, desc.softmax_scale)
            timed["k3"] = dict(
                ms=roofline.cuda_ms(lambda: k34.flash_bwd_q(
                    q3, k3, v3, o, do3, lse, kd_q, **kw), iters=10),
                plain_ms=roofline.cuda_ms(lambda: k34.flash_bwd_q_plain(
                    q3, k3, v3, o, do3, lse, kd_q, **kw), iters=3, warmup=1),
                bound_ms=b3[0], bound_by=b3[1], library_ms=lib_bwd,
                max_abs_err=errs["dq"])
            timed["k4"] = dict(
                ms=roofline.cuda_ms(lambda: k34.flash_bwd_kv(
                    q3, k3, v3, do3, lse, dterm, kd_kv, **kw), iters=10),
                plain_ms=roofline.cuda_ms(lambda: k34.flash_bwd_kv_plain(
                    q3, k3, v3, do3, lse, dterm, kd_kv, **kw), iters=3,
                    warmup=1),
                bound_ms=b4[0], bound_by=b4[1], library_ms=lib_bwd,
                max_abs_err=max(errs["dk"], errs["dv"]))
            del dq, dterm, dk, dv
        finite = bool(torch.isfinite(o.float()).all()
                      and torch.isfinite(lse).all())
        ok = (finite and dblk and all(same.values())
              and all(x <= 1 for x in shares.values()))
        results[name] = timed
        # The backward as a whole: K3 + K4 beside SDPA's backward (all
        # three gradients) and the sum of their bounds.
        backward = ({"k34_ms": timed["k3"]["ms"] + timed["k4"]["ms"],
                     "k34_bound_ms": (timed["k3"]["bound_ms"]
                                      + timed["k4"]["bound_ms"]),
                     "sdpa_backward_ms": timed["k3"]["library_ms"]}
                    if "k3" in timed else {})
        emit({"phase": "large_d", "case": name, "dtype": tag, "D": d,
              "N": n, "Hq": hq, "Hkv": hkv, "rows": rows, "share": shares,
              "err": errs, "deterministic": same, "sdpa_backend": backend,
              **{f"{kk}_{key}": val for kk, t in timed.items()
                 for key, val in t.items() if key != "max_abs_err"},
              **backward, "ok": ok})
        if not ok:
            raise SystemExit(f"large_d {name}: kernels disagree with their "
                             f"plain versions or ran another row (shares "
                             f"{shares}, rows {rows}, bit-equal {same}, "
                             f"finite {finite})")
        del q, k, v, do, q3, k3, v3, do3, o, lse, vis
        torch.cuda.empty_cache()

    # The entry point end to end: forward and backward through K1, K3, K4
    # against the same call through their plain versions.
    d, n = 384, 4096
    q, k, v, do = (torch.randn((1, hq, n, d), generator=gen, device="cuda")
                   .bfloat16() for _ in range(4))
    seen = []

    def step():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_attention(*leaves, causal=True)
        out.backward(do)
        return out.detach(), [t.grad for t in leaves]

    real = (k1.flash_fwd, k34.flash_bwd_q, k34.flash_bwd_kv)

    def recorded(fn, at):
        """fn, noting the row kernel of its descriptor (argument ``at``).
        While it stands in the module, fn's launch count lands on it."""
        def call(*args, **kwargs):
            seen.append((fn.__name__, args[at].kernel))
            return fn(*args, **kwargs)
        call.launches = call.noncausal_launches = 0
        return call

    wrapped = [recorded(f, at) for f, at in zip(real, (3, 6, 6))]
    k1.flash_fwd, k34.flash_bwd_q, k34.flash_bwd_kv = wrapped
    o_k, grads_k = step()
    torch.cuda.synchronize()
    k1.flash_fwd, k34.flash_bwd_q, k34.flash_bwd_kv = real
    launches = {f.__name__: w.launches for f, w in zip(real, wrapped)}
    with plain_kernels():
        o_p, grads_p = step()
    share_o = budget_share(o_k, o_p, *KERNEL_BUDGETS["flash_fwd_o_bf16"])
    rel = {key: _rel_l2(g, w) for key, g, w in zip(("dq", "dk", "dv"),
                                                   grads_k, grads_p)}
    on_rows = sorted(set(seen))
    want = large_d_rows("bf16", d)
    want_rows = sorted({("flash_fwd", want["k1"]), ("flash_bwd_q", want["k3"]),
                        ("flash_bwd_kv", want["k4"])})
    ok = (share_o <= 1 and max(rel.values()) <= 5e-2
          and all(x == 1 for x in launches.values())
          and on_rows == want_rows
          and all(bool(torch.isfinite(g.float()).all()) for g in grads_k))
    emit({"phase": "large_d_entry_point", "B": 1, "H": hq, "N": n, "D": d,
          "causal": True, "share_o": share_o, "grad_rel_l2": rel,
          "grad_rel_l2_budget": 5e-2, "launches": launches,
          "rows": on_rows, "ok": ok})
    if not ok:
        raise SystemExit(f"large_d entry point: O share {share_o}, grad rel "
                         f"L2 {rel}, launches {launches}, rows {on_rows}")
    del q, k, v, do, o_k, grads_k, o_p, grads_p
    gc.collect()
    torch.cuda.empty_cache()
    return results, launches


def _rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm()
                 .clamp_min(1e-30))


def _train(torch, phase: str, cfg, model, tokens, steps: int = 6) -> dict:
    """One step's loss and grads through K1/K3/K4 against the same step
    with the three swapped for their plain versions (loss within 1e-2
    relative, every grad within 5e-2 relative L2), then ``steps``
    train_steps (AdamW, lr 1e-3) on ``tokens``: finite, falling losses, K1,
    K3 and K4 each launched n_layers times a step. Emits ``<phase>_in_
    context`` and ``<phase>`` (losses, grad norms, step ms and their
    median past the first, tokens/s, peak GiB, launches and K1's, K3's and
    K4's launches by row); returns (launches, launches by row)."""
    import numpy as np

    from mfa_tpu_torch.kernels import flash_bwd as k34
    from mfa_tpu_torch.kernels import flash_fwd as k1
    from mfa_tpu_torch.models import training

    loss_k = float(training.loss_and_grads(model, tokens))
    grads_k = {n: p.grad.clone() for n, p in model.named_parameters()}
    with plain_kernels():
        loss_p = float(training.loss_and_grads(model, tokens))
    rel = {n: _rel_l2(grads_k[n], p.grad)
           for n, p in model.named_parameters()}
    worst = max(rel, key=rel.get)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    in_context_ok = loss_rel <= 1e-2 and rel[worst] <= 5e-2
    emit({"phase": f"{phase}_in_context", "loss_kernels": loss_k,
          "loss_plain": loss_p, "loss_rel_err": loss_rel,
          "grad_rel_l2_max": rel[worst], "grad_rel_l2_worst_param": worst,
          "grad_rel_l2_budget": 5e-2, "ok": in_context_ok})
    if not in_context_ok:
        raise SystemExit(f"{phase} in context: loss rel err {loss_rel}, "
                         f"grad rel L2 {rel[worst]} at {worst}")
    del grads_k
    for p in model.parameters():
        p.grad = None
    gc.collect()
    torch.cuda.empty_cache()

    state = training.create_train_state(
        model, training.make_optimizer(lr=1e-3, warmup_steps=1,
                                       total_steps=100))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = (k1.flash_fwd, k34.flash_bwd_q, k34.flash_bwd_kv)
    by_row = (k1.launches_by_row, k34.launches_by_row["flash_bwd_q"],
              k34.launches_by_row["flash_bwd_kv"])
    for f in counters:
        f.launches = 0
    before = [dict(c) for c in by_row]
    losses, norms, step_ms = [], [], []
    for _ in range(steps):
        t_s = time.perf_counter()
        metrics = training.train_step(state, tokens)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t_s) * 1e3)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    launches = {f.__name__: f.launches for f in counters}
    rows = {f.__name__: {label: n - b.get(label, 0) for label, n in c.items()
                         if n != b.get(label, 0)}
            for f, c, b in zip(counters, by_row, before)}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    median_ms = float(np.median(step_ms[1:]))
    ok = (all(math.isfinite(x) for x in losses + norms)
          and losses[-1] < losses[0]
          and all(n_ == cfg.n_layers * steps for n_ in launches.values()))
    emit({"phase": phase, "n_layers": cfg.n_layers, "steps": steps,
          "losses": losses, "grad_norms": norms, "step_ms": step_ms,
          "median_step_ms": median_ms,
          "tokens_per_s": tokens.shape[0] * (tokens.shape[1] - 1)
          / (median_ms / 1e3),
          "peak_gib": peak_gib, "launches": launches,
          "launches_by_row": rows, "ok": ok})
    if not ok:
        raise SystemExit(f"{phase}: losses {losses}, norms {norms}, "
                         f"launches {launches}")
    del state
    return launches, rows


def _train_tokens(torch, vocab_size: int, seed: int):
    """One 1 x 2049 batch from TokenDataset over a seeded stream."""
    import numpy as np

    from mfa_tpu_torch.utils.data import TokenDataset

    stream = np.random.default_rng(seed).integers(0, vocab_size, 2049)
    batch = next(TokenDataset(stream, seq_len=2048, batch_size=1,
                              seed=seed).epoch(0))
    return torch.from_numpy(batch).long().cuda()


def phase_training(torch):
    from mfa_tpu_torch.models import llama

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), n_layers=16)
    t0 = time.perf_counter()
    model = llama.Llama.init(
        cfg, generator=torch.Generator(device="cuda").manual_seed(4),
        dtype=torch.bfloat16, device="cuda", trainable=True)
    tokens = _train_tokens(torch, cfg.vocab_size, 4)
    torch.cuda.synchronize()
    emit({"phase": "training_init", "seconds": time.perf_counter() - t0,
          "n_layers": cfg.n_layers,
          "params": sum(p.numel() for p in model.parameters()),
          "tokens": list(tokens.shape)})
    launches, _ = _train(torch, "training", cfg, model, tokens)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_openllama_training(torch):
    """OpenLLaMA-3B trained on one card at full width and depth (26
    layers, width 3200, 32 heads of D 100, MHA; ~3.43 B parameters with
    bf16 grads and AdamW moments: ~27 GiB) from random Hugging Face-named
    weights (seed 41) through models/convert.params_from_hf, as
    phase_training trains Llama-3-8B's widths. K1, K3 and K4 run D 100,
    rows TMA cannot map: each must launch on its wgmma row with the
    copying producer ("wgmma/copy"), every launch."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, model = _random_hf_model(torch, OPENLLAMA_3B_CONFIG, seed=41,
                                  trainable=True)
    tokens = _train_tokens(torch, cfg.vocab_size, 41)
    torch.cuda.synchronize()
    emit({"phase": "openllama_training_init",
          "seconds": time.perf_counter() - t0, "n_layers": cfg.n_layers,
          "dim": cfg.dim, "head_dim": cfg.head_dim,
          "params": sum(p.numel() for p in model.parameters()),
          "tokens": list(tokens.shape)})
    launches, rows = _train(torch, "openllama_training", cfg, model, tokens)
    want = {name: {"wgmma/copy": cfg.n_layers * 6} for name in rows}
    if rows != want:
        raise SystemExit(f"openllama_training: K1, K3, K4 ran rows {rows}, "
                         f"wanted {want}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# The published config.json fields that describe each model's shape, as
# Hugging Face hosts them (Qwen/Qwen2-7B and mistralai/Mistral-7B-v0.1,
# config.json), read by models/convert.config_from_hf as a namespace: the
# card has no transformers. Qwen2-7B's window of 131072 is off
# (use_sliding_window false).
QWEN2_7B_CONFIG = dict(
    architectures=["Qwen2ForCausalLM"], model_type="qwen2",
    hidden_act="silu", hidden_size=3584, intermediate_size=18944,
    num_hidden_layers=28, num_attention_heads=28, num_key_value_heads=4,
    max_position_embeddings=131072, max_window_layers=28,
    rms_norm_eps=1e-6, rope_theta=1000000.0, sliding_window=131072,
    use_sliding_window=False, tie_word_embeddings=False,
    vocab_size=152064, torch_dtype="bfloat16")
MISTRAL_7B_CONFIG = dict(
    architectures=["MistralForCausalLM"], model_type="mistral",
    hidden_act="silu", hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    max_position_embeddings=32768, rms_norm_eps=1e-5, rope_theta=10000.0,
    sliding_window=4096, tie_word_embeddings=False, vocab_size=32000,
    torch_dtype="bfloat16")

# OpenLLaMA-3B's published config.json fields (openlm-research/
# open_llama_3b), typed in: a LlamaForCausalLM of 32 heads over width
# 3200 (head dim 100, not a multiple of 8) with no num_key_value_heads
# (MHA) and no rope_theta.
OPENLLAMA_3B_CONFIG = dict(
    architectures=["LlamaForCausalLM"], model_type="llama",
    hidden_act="silu", hidden_size=3200, intermediate_size=8640,
    num_hidden_layers=26, num_attention_heads=32,
    max_position_embeddings=2048, rms_norm_eps=1e-6,
    tie_word_embeddings=False, vocab_size=32000, torch_dtype="float16")


def _random_hf_model(torch, fields: dict, seed: int, trainable=False):
    """(LlamaConfig read from ``fields`` as a namespace, the Llama that
    models/convert.params_from_hf builds from random bf16 weights under
    Hugging Face's key names; every parameter requiring grad when
    ``trainable``). Weights come from a seeded generator on the card:
    projections N(0, 1/d_in), the embedding N(0, 1) * 0.02, QKV biases
    N(0, 0.25) where the config has them, norms ones."""
    from types import SimpleNamespace

    from mfa_tpu_torch.models import convert

    cfg = convert.config_from_hf(SimpleNamespace(**fields))
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(scale, *shape):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).bfloat16()

    def ones(n):
        return torch.ones((n,), dtype=torch.bfloat16, device="cuda")

    hd = cfg.head_dim
    sd = {"model.embed_tokens.weight": rand(0.02, cfg.vocab_size, cfg.dim),
          "model.norm.weight": ones(cfg.dim)}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        for name, d_out, d_in in (
                ("self_attn.q_proj", cfg.n_heads * hd, cfg.dim),
                ("self_attn.k_proj", cfg.n_kv_heads * hd, cfg.dim),
                ("self_attn.v_proj", cfg.n_kv_heads * hd, cfg.dim),
                ("self_attn.o_proj", cfg.dim, cfg.n_heads * hd),
                ("mlp.gate_proj", cfg.ffn_hidden, cfg.dim),
                ("mlp.up_proj", cfg.ffn_hidden, cfg.dim),
                ("mlp.down_proj", cfg.dim, cfg.ffn_hidden)):
            sd[p + name + ".weight"] = rand(d_in ** -0.5, d_out, d_in)
            if cfg.qkv_bias and name[-6:] in ("q_proj", "k_proj", "v_proj"):
                sd[p + name + ".bias"] = rand(0.5, d_out)
        sd[p + "input_layernorm.weight"] = ones(cfg.dim)
        sd[p + "post_attention_layernorm.weight"] = ones(cfg.dim)
    sd["lm_head.weight"] = rand(cfg.dim ** -0.5, cfg.vocab_size, cfg.dim)
    model = convert.params_from_hf(sd, cfg, torch.bfloat16, device="cuda",
                                   trainable=trainable)
    return cfg, model


@contextlib.contextmanager
def kernels_held_to_plain(torch, pass_through=None):
    """K1, K2 and K8 wrapped so that every launch in the block is also
    computed by its plain version on the same inputs (K2's on copies of
    the cache it appends to) and held to KERNEL_BUDGETS elementwise.
    Yields (shares, k2, k1): {budget: the largest share of it used}, for
    K1's bf16 launches the same distances from an fp64 attention
    (utils/testing.py::attention_fp64) as K2's below, and for
    K2's launches "rows_equal" (its appended rows bit-equal to the plain
    version's), "share_of_abs_o" (decode_o with its relative term taken
    of |O|, reported only), and K2's and the plain version's largest
    distance from an fp64 decode of the same operands in bf16 steps of
    sum P |v| / l (utils/testing.py::rounding_steps), with "excess_steps",
    the most by which K2's exceeds the plain version's at one element.
    K2 is held at decode_o with the relative term taken of sum P |v| / l,
    since on real activations O can cancel to near 0 from large terms,
    and then one bf16 step of a rounded P v term, which K2 and its plain
    version both take at the same point, exceeds 2^-6 |O|
    (`decode_tuning rounding`); the fp64 distances show whether K2 is any further from the
    exact O than its plain version there. K1's bf16 O is held the same
    way, flash_fwd_o_bf16 with the relative term taken of sum P |v| / l:
    on concentrated inputs K1 reached 3.16 of that budget against |O|
    and 0.53 against the terms, as far from fp64 as its plain version
    (`decode_tuning rounding`). The kernels' own counters do not move
    while they are wrapped (their increments land on the
    wrappers), so these launches count on no path. A K1 launch made while
    ``pass_through()`` is true (the autotune timing its candidates) runs
    the kernel alone."""
    from mfa_tpu_torch.kernels import decode as k2
    from mfa_tpu_torch.kernels import flash_fwd as k1
    from mfa_tpu_torch.kernels import quant_matmul as k8
    from mfa_tpu_torch.utils.testing import (
        KERNEL_BUDGETS,
        attention_fp64,
        budget_share,
        decode_fp64,
        rounding_steps,
    )

    shares, k2_found, k1_found = {}, {}, {}

    def note(found, key, value):
        found[key] = max(found.get(key, value), value)

    def held(budget, got, want, scale=None):
        note(shares, budget,
             budget_share(got, want, *KERNEL_BUDGETS[budget], scale=scale))

    real_k1, real_k2, real_k8 = (k1.flash_fwd, k2.decode_fused_append,
                                 k8.int4_matmul)

    def k1_held(q3, k3, v3, kd, *, group, scale, o_dtype, out=None):
        o, lse = real_k1(q3, k3, v3, kd, group=group, scale=scale,
                         o_dtype=o_dtype, out=out)
        if pass_through is not None and pass_through():
            return o, lse
        o_p, l_p = k1.flash_fwd_plain(q3, k3, v3, kd, group=group,
                                      scale=scale, o_dtype=o_dtype)
        held("flash_fwd_l", lse, l_p)
        if o_dtype != torch.bfloat16:
            held("flash_fwd_o_fp32", o, o_p)
            return o, lse
        exact, terms = (attention_fp64(
            q3, k3, v3, group=group, scale=scale, causal=kd.causal,
            sliding_window=kd.sliding_window,
            logit_soft_cap=kd.logit_soft_cap, magnitudes=mag)
            for mag in (False, True))
        held("flash_fwd_o_bf16", o, o_p, scale=terms)
        atol = KERNEL_BUDGETS["flash_fwd_o_bf16"][0]
        note(k1_found, "share_of_abs_o",
             budget_share(o, o_p, *KERNEL_BUDGETS["flash_fwd_o_bf16"]))
        steps_k, steps_p = (rounding_steps(x, exact, terms, atol)
                            for x in (o, o_p))
        note(k1_found, "k1_steps_from_fp64", float(steps_k.max()))
        note(k1_found, "plain_steps_from_fp64", float(steps_p.max()))
        note(k1_found, "excess_steps", float((steps_k - steps_p).max()))
        return o, lse

    def k2_held(q3, k, v, k_scale, v_scale, k_new, v_new, lengths, **kw):
        exact, terms = (decode_fp64(q3, k, v, k_scale, v_scale, k_new,
                                    v_new, lengths, magnitudes=mag, **kw)
                        for mag in (False, True))
        cache_p = [t.clone() for t in (k, v, k_scale, v_scale)]
        o_p = k2.decode_fused_append_plain(q3, *cache_p, k_new, v_new,
                                           lengths.clone(), **kw)
        o = real_k2(q3, k, v, k_scale, v_scale, k_new, v_new, lengths, **kw)
        held("decode_o", o, o_p, scale=terms)
        atol = KERNEL_BUDGETS["decode_o"][0]
        note(k2_found, "share_of_abs_o",
             budget_share(o, o_p, *KERNEL_BUDGETS["decode_o"]))
        steps_k, steps_p = (rounding_steps(x, exact, terms, atol)
                            for x in (o, o_p))
        note(k2_found, "k2_steps_from_fp64", float(steps_k.max()))
        note(k2_found, "plain_steps_from_fp64", float(steps_p.max()))
        note(k2_found, "excess_steps", float((steps_k - steps_p).max()))
        k2_found["rows_equal"] = k2_found.get("rows_equal", True) and all(
            torch.equal(_bits(torch, a), _bits(torch, b))
            for a, b in zip((k, v), cache_p))
        return o

    def k8_held(x, packed, scale, *, layout, device="cuda"):
        y = real_k8(x, packed, scale, layout=layout, device=device)
        y_p = k8.int4_matmul_plain(x, packed, scale, layout=layout)
        held("int4_matmul_" + ("biased" if layout == "int4_biased"
                               else "signed"), y, y_p)
        return y

    swaps = [(k1, "flash_fwd", k1_held),
             (k2, "decode_fused_append", k2_held),
             (k8, "int4_matmul", k8_held)]
    for mod, attr, fn in swaps:
        fn.launches = fn.noncausal_launches = 0
        setattr(mod, attr, fn)
    yield shares, k2_found, k1_found
    for (mod, attr, _), fn in zip(swaps, (real_k1, real_k2, real_k8)):
        setattr(mod, attr, fn)


def _in_context(torch, model, tokens, name: str, *, decode: bool = True,
                kv_precision=None, max_len: int = 0, **info) -> None:
    """The model through the kernels, every K1, K2 and K8 launch held to
    its plain version at KERNEL_BUDGETS (kernels_held_to_plain), then
    through the plain versions (plain_kernels). With ``decode``: tokens
    [B, T] prefilled into caches of ``max_len`` and one decode step, the
    step's logits taken from the same state both times; without: the
    last-position logits of a forward over tokens [B, T]. The logits agree
    within the bf16 mixed budget, relative, and K2 and K1 are nowhere more
    than one bf16 step of sum P |v| / l further from an fp64 decode or
    attention than their plain versions. Fails otherwise."""
    with torch.inference_mode():
        if decode:
            caches = model.make_caches(tokens.shape[0], max_len, kv_precision)
        with kernels_held_to_plain(torch) as (shares, k2, k1):
            if decode:
                model(tokens, caches=caches)
                lengths = [c.lengths for c in caches]
                logits_k, _ = model.decode_step(tokens[:, -1], caches)
            else:
                logits_k = model(tokens)[:, -1]
        if decode:
            for c, ln in zip(caches, lengths):
                c.lengths = ln
        with plain_kernels():
            logits_p = (model.decode_step(tokens[:, -1], caches)[0]
                        if decode else model(tokens)[:, -1])
    scale = float(logits_p.abs().max())
    err = max_err(logits_k, logits_p)
    budget = 5e-2 * max(1.0, scale)
    ok = (err <= budget and all(x <= 1 for x in shares.values())
          and k2.get("rows_equal", True) and k2.get("excess_steps", 0) <= 1
          and k1.get("excess_steps", 0) <= 1)
    if decode:
        info.update(max_len=max_len, kv=kv_precision.value)
    emit({"phase": f"{name}_in_context", "batch": tokens.shape[0],
          "prompt": tokens.shape[1], **info, "shares": shares,
          "decode": k2, "prefill": k1, "max_abs_err": err,
          "budget": budget,
          "max_abs_logit": scale,
          "argmax_equal": bool(torch.equal(logits_k.argmax(-1),
                                            logits_p.argmax(-1))),
          "ok": ok})
    if not ok:
        raise SystemExit(f"{name} in context: logits differ by {err} "
                         f"(budget {budget}), a kernel left its budget "
                         f"({shares}) or K2 or K1 left its plain "
                         f"version's distance from fp64 ({k2}, {k1})")


def _serve(torch, model, prompts, kv_precision, *, max_len: int,
           int4_weights: bool = False, scheduler=None, k1_searched=None,
           **sched_kw):
    """Greedy requests of 16 tokens behind ContinuousBatchingScheduler (4
    slots; or ``scheduler``, built as it is with ``sched_kw``). K1, K2 and
    K8's counters are set to 0 just before and read just after; K1 must
    carry every prefill, K2 every decode step and K8 (INT4 weights) all 7
    projections of every layer in both. ``k1_searched()``: the K1 launches
    of the run that timed autotune candidates, not counted. Returns
    (summary, launches, the requests' tokens); fails on a wrong count."""
    import numpy as np

    from mfa_tpu_torch.kernels import decode as k2
    from mfa_tpu_torch.kernels import flash_fwd as k1
    from mfa_tpu_torch.kernels import quant_matmul as k8
    from mfa_tpu_torch.serving.scheduler import (
        ContinuousBatchingScheduler,
        Request,
    )

    cfg = model.cfg
    sched = (scheduler or ContinuousBatchingScheduler)(
        model, num_slots=4, max_len=max_len, kv_precision=kv_precision,
        device="cuda", **sched_kw)
    reqs = [Request(prompt=p, max_new_tokens=16) for p in prompts]
    for r in reqs:
        sched.submit(r)
    torch.cuda.synchronize()
    counters = (k1.flash_fwd, k2.decode_fused_append, k8.int4_matmul)
    for f in counters:
        f.launches = 0
    decode_only = []
    t_run = time.perf_counter()
    for _ in range(2000):
        pre = sched.stats["prefills"]
        t_s = time.perf_counter()
        progressed = sched.step()
        torch.cuda.synchronize()
        if not progressed and not sched.queue:
            break
        if sched.stats["prefills"] == pre:
            decode_only.append((time.perf_counter() - t_s) * 1e3)
    else:
        raise SystemExit("serving: no end after 2000 steps")
    sched._retire()
    run_s = time.perf_counter() - t_run
    # By the kernels' names: a stand-in (kernels_held_to_plain) has its own.
    launches = {name: f.launches for name, f in zip(
        ("flash_fwd", "decode_fused_append", "int4_matmul"), counters)}
    searched = k1_searched() if k1_searched else 0
    launches["flash_fwd"] -= searched
    done = {c.request.id: c for c in sched.finished}
    stats = dict(sched.stats)
    layers = cfg.n_layers
    want_k8 = 7 * layers * (stats["prefills"] + stats["decode_steps"])
    ok = (len(done) == len(reqs)
          and all(len(done[r.id].tokens) == 16 for r in reqs)
          and stats["prefills"] == len(reqs)
          and launches["flash_fwd"] == layers * stats["prefills"]
          and launches["decode_fused_append"]
          == layers * stats["decode_steps"]
          and launches["int4_matmul"] == (want_k8 if int4_weights else 0))
    summary = dict(
        ok=ok, kv=kv_precision.value, int4_weights=int4_weights,
        completions=len(done), prompts=[len(p) for p in prompts],
        tokens=stats["tokens"], prefills=stats["prefills"],
        decode_steps=stats["decode_steps"], launches=launches,
        **({"k1_search_launches": searched} if k1_searched else {}),
        run_s=run_s, decode_ms_per_step=(float(np.median(decode_only))
                                         if decode_only else None),
        tokens_per_s=stats["tokens"] / run_s,
        first_tokens=done[reqs[0].id].tokens[:4] if reqs[0].id in done
        else None)
    if not ok:
        raise SystemExit(f"serving: completions or launch counts wrong "
                         f"({summary})")
    del sched
    torch.cuda.empty_cache()
    return summary, launches, [done[r.id].tokens for r in reqs]


def _prefill_ms(torch, model, buckets, max_len: int) -> dict:
    """Device ms of one batch-1 prefill (bf16 cache) per prompt bucket."""
    from mfa_tpu_torch.utils import roofline

    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    for n in buckets:
        toks = torch.randint(1, model.cfg.vocab_size, (1, n), generator=gen,
                             device="cuda")

        def run():
            with torch.inference_mode():
                model(toks, caches=model.make_caches(1, max_len))

        out[n] = roofline.cuda_ms(run, iters=2, warmup=1)
    return out


def _add(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def phase_qwen2_serving(torch):
    """Qwen2-7B at full width and depth: its config read from its
    published fields, random HF-named weights with QKV biases through
    params_from_hf, served over bf16 and FP8-e4m3 caches and again with
    INT4 weights over FP8. Returns (the bf16 model, K1/K2/K8 launches)."""
    import numpy as np

    from mfa_tpu_torch.models.llama import LlamaConfig
    from mfa_tpu_torch.ops.precision import OperandPrecision

    t0 = time.perf_counter()
    cfg, model = _random_hf_model(torch, QWEN2_7B_CONFIG, seed=20)
    if cfg != LlamaConfig.qwen2_7b():
        raise SystemExit(f"qwen2: config_from_hf gave {cfg}")
    torch.cuda.synchronize()
    emit({"phase": "qwen2_init", "seconds": time.perf_counter() - t0,
          "config": dataclasses.asdict(cfg),
          "params": sum(p.numel() for p in model.parameters()),
          "weights_gib": _weight_gib(model)})

    rng = np.random.default_rng(20)
    fp8 = OperandPrecision.FP8_E4M3
    batch = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                          (4, 256))).cuda()
    _in_context(torch, model, batch, "qwen2",
                kv_precision=OperandPrecision.BF16, max_len=2048)
    emit({"phase": "qwen2_prefill", "ms_per_bucket": _prefill_ms(
        torch, model, (512, 2048), 2048)})
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (50, 120, 250, 500, 1000, 1900)]
    launches = {}
    for kv in (OperandPrecision.BF16, fp8):
        summary, n, _ = _serve(torch, model, prompts, kv, max_len=2048)
        _add(launches, n)
        emit({"phase": "qwen2_serving", **summary})

    int4_model = model.quantized(OperandPrecision.INT4)
    emit({"phase": "qwen2_int4_init", "weights_gib": _weight_gib(int4_model),
          "device_gib": torch.cuda.memory_allocated() / 2**30})
    _in_context(torch, int4_model, batch, "qwen2_int4", kv_precision=fp8,
                max_len=2048)
    summary, n, _ = _serve(torch, int4_model, prompts, fp8, max_len=2048,
                           int4_weights=True)
    _add(launches, n)
    emit({"phase": "qwen2_serving", **summary})
    del int4_model
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "qwen2_serving_done",
          "seconds": time.perf_counter() - t0, "launches": launches})
    return model, launches


def _cache_gib(model, kv_precision, *, slots: int = 4,
               max_len: int = 2048) -> float:
    """Device bytes of the contiguous caches a scheduler of ``slots`` x
    ``max_len`` holds (rows, scales and lengths), GiB."""
    caches = model.make_caches(slots, max_len, kv_precision)
    return sum(t.numel() * t.element_size() for c in caches
               for t in (c.k, c.v, c.k_scale, c.v_scale, c.lengths)) / 2**30


def phase_openllama_serving(torch):
    """OpenLLaMA-3B at full width and depth (26 layers, width 3200, 32
    heads of head dim 100, MHA): its config read from its published
    fields, random HF-named weights, served over bf16, INT8 and FP8-e4m3
    contiguous caches (K1 every prefill on its wgmma row with the cp.async
    producer at D 100, K2 every decode step) and over bf16 and INT8 paged
    caches of 512-token pages (K6): every K2 and K6 launch, over each
    storage type, on the tensor-core pair (``mma/*`` by the wrappers'
    launches_by_path). Returns (K1, K2 launches; K1, K6 launches of the
    paged runs)."""
    import numpy as np

    from mfa_tpu_torch.kernels import decode as k2
    from mfa_tpu_torch.kernels import flash_fwd as k1
    from mfa_tpu_torch.ops import params as params_mod
    from mfa_tpu_torch.ops.precision import OperandPrecision

    t0 = time.perf_counter()
    cfg, model = _random_hf_model(torch, OPENLLAMA_3B_CONFIG, seed=40)
    if (cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.dim, cfg.n_layers) \
            != (100, 32, 32, 3200, 26):
        raise SystemExit(f"openllama: config_from_hf gave {cfg}")
    torch.cuda.synchronize()
    emit({"phase": "openllama_init", "seconds": time.perf_counter() - t0,
          "config": dataclasses.asdict(cfg), "head_dim": cfg.head_dim,
          "params": sum(p.numel() for p in model.parameters()),
          "weights_gib": _weight_gib(model),
          "prefill_row": str(params_mod.select_row(
              params_mod.parameter_table(
                  "flash_fwd", params_mod.flash_bf16_table_precision(100)),
              100))})

    rng = np.random.default_rng(40)
    batch = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                          (4, 256))).cuda()
    _in_context(torch, model, batch, "openllama",
                kv_precision=OperandPrecision.BF16, max_len=2048)
    emit({"phase": "openllama_prefill", "ms_per_bucket": _prefill_ms(
        torch, model, (512, 2048), 2048)})
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (50, 120, 250, 500, 1000, 1900)]
    # The row of every K1 launch of the serving runs, as the wrapper
    # counts them.
    k1.launches_by_row.clear()
    launches, bf16_tokens, k2_paths, k6_paths = {}, None, {}, {}
    for kv in (OperandPrecision.BF16, OperandPrecision.INT8,
               OperandPrecision.FP8_E4M3):
        cache_gib = _cache_gib(model, kv)
        torch.cuda.empty_cache()
        k2.decode_fused_append.launches_by_path.clear()
        summary, n, tokens = _serve(torch, model, prompts, kv, max_len=2048)
        k2_paths[kv.value] = dict(k2.decode_fused_append.launches_by_path)
        _add(launches, n)
        bf16_tokens = bf16_tokens or tokens
        emit({"phase": "openllama_serving", "cache_gib": cache_gib,
              "weights_gib": _weight_gib(model),
              "k2_paths": k2_paths[kv.value], **summary})
        if not (sum(k2_paths[kv.value].values())
                == n["decode_fused_append"] > 0
                and all(p.startswith("mma/") for p in k2_paths[kv.value])):
            raise SystemExit(f"openllama {kv.value}: K2 ran paths "
                             f"{k2_paths[kv.value]}, not all mma/*")
    paged_k1, paged_k6 = phase_paged_serving(
        torch, model, prompts, bf16_tokens, formats=2,
        label="openllama_paged_serving", paths=k6_paths)
    k1_rows = dict(k1.launches_by_row)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    # The rows also count the K1 launches of the paged phase's logits
    # check, which no launch counter takes.
    k6_ok = (set(k6_paths) == {"bf16", "int8"}
             and all(p.startswith("mma/") for paths in k6_paths.values()
                     for p in paths))
    ok = (list(k1_rows) == ["wgmma/copy"] and paged_k1 > 0
          and k1_rows["wgmma/copy"] >= launches["flash_fwd"] + paged_k1
          and k6_ok)
    emit({"phase": "openllama_serving_done",
          "seconds": time.perf_counter() - t0, "launches": launches,
          "paged_k1_launches": paged_k1, "paged_k6_launches": paged_k6,
          "k1_rows": k1_rows, "k2_paths": k2_paths, "k6_paths": k6_paths,
          "ok": ok})
    if not ok:
        raise SystemExit(f"openllama: K1 ran rows {k1_rows}, not only "
                         f"wgmma/copy, or K6 paths {k6_paths}")
    return launches, paged_k1, paged_k6


def _same_bits(torch, a: dict, b: dict) -> bool:
    """Every tensor of two name → tensor dicts equal in dtype, shape and
    raw bytes."""
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and torch.equal(_bits(torch, a[k]), _bits(torch, b[k])) for k in a)


def _cache_tensors(caches) -> dict:
    return {f"{i}.{f}": getattr(c, f) for i, c in enumerate(caches)
            for f in ("k", "v", "k_scale", "v_scale", "lengths")}


def phase_checkpoint(torch, model):
    """Qwen2-7B at full width cut to its first 4 layers, in bf16 and with
    INT4 weights, and an FP8-e4m3 cache after one prefill: saved, loaded
    into fresh templates, every tensor bit-equal, and one greedy request
    from each restored model giving the tokens it gave before. Returns
    the K1/K2/K8 launches of those requests."""
    import shutil
    import tempfile

    import numpy as np

    from mfa_tpu_torch.models.llama import Llama
    from mfa_tpu_torch.ops.precision import OperandPrecision
    from mfa_tpu_torch.utils import checkpoint

    t0 = time.perf_counter()
    cfg = dataclasses.replace(model.cfg, n_layers=4)
    params = model.params()
    params["layers"] = params["layers"][:4]
    bf16 = Llama(cfg, params, device="cuda")          # the model's tensors
    int4 = bf16.quantized(OperandPrecision.INT4)
    fp8 = OperandPrecision.FP8_E4M3
    rng = np.random.default_rng(21)
    prompt = rng.integers(1, cfg.vocab_size, 300).tolist()
    caches = int4.make_caches(1, 2048, fp8)
    with torch.inference_mode():
        int4(torch.tensor([prompt], device="cuda"), caches=caches)
    launches = {}
    before = {}
    for name, m, kv in (("bf16", bf16, OperandPrecision.BF16),
                        ("int4", int4, fp8)):
        _, n, toks = _serve(torch, m, [prompt], kv, max_len=2048,
                            int4_weights=name == "int4")
        _add(launches, n)
        before[name] = toks[0]

    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="checkpoint_", dir=root))
    t_save = time.perf_counter()
    checkpoint.save(tmp / "bf16", bf16.params(), metadata={"model": "qwen2"})
    checkpoint.save(tmp / "int4", int4.params())
    checkpoint.save(tmp / "kv_fp8", caches, metadata={"prompt": 300})
    save_s = time.perf_counter() - t_save
    nbytes = {d.name: sum(f.stat().st_size for f in d.iterdir())
              for d in tmp.iterdir()}

    gen = torch.Generator(device="cuda").manual_seed(99)
    fresh = Llama.init(cfg, generator=gen, dtype=torch.bfloat16,
                       device="cuda")
    fresh_int4 = Llama.init(cfg, generator=gen, dtype=torch.bfloat16,
                            device="cuda",
                            weight_precision=OperandPrecision.INT4)
    fresh_caches = fresh_int4.make_caches(1, 2048, fp8)
    t_load = time.perf_counter()
    _, meta = checkpoint.load(tmp / "bf16", fresh.params())
    checkpoint.load(tmp / "int4", fresh_int4.params())
    checkpoint.load(tmp / "kv_fp8", fresh_caches)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t_load
    shutil.rmtree(tmp)
    equal = {"bf16": _same_bits(torch, bf16.state_dict(),
                                fresh.state_dict()),
             "int4": _same_bits(torch, int4.state_dict(),
                                fresh_int4.state_dict()),
             "kv_fp8": _same_bits(torch, _cache_tensors(caches),
                                  _cache_tensors(fresh_caches))}
    after = {}
    for name, m, kv in (("bf16", fresh, OperandPrecision.BF16),
                        ("int4", fresh_int4, fp8)):
        _, n, toks = _serve(torch, m, [prompt], kv, max_len=2048,
                            int4_weights=name == "int4")
        _add(launches, n)
        after[name] = toks[0]
    ok = (all(equal.values()) and after == before
          and meta == {"model": "qwen2"})
    emit({"phase": "checkpoint", "n_layers": cfg.n_layers, "bytes": nbytes,
          "save_s": save_s, "load_s": load_s, "bits_equal": equal,
          "tokens_equal": after == before, "tokens": after, "ok": ok,
          "seconds": time.perf_counter() - t0, "launches": launches})
    if not ok:
        raise SystemExit(f"checkpoint: bits equal {equal}, tokens before "
                         f"{before}, after {after}")
    del bf16, int4, fresh, fresh_int4, caches, fresh_caches
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# The Mistral server's prompt buckets: the default ones, then 4096 and
# 8192 for prompts longer than the window.
MISTRAL_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096, 8192)


def phase_mistral_serving(torch):
    """Mistral-7B at full width and depth, its 4096-token window over
    prompts longer than it: config from its published fields, random
    HF-named weights, the 6000-token prefill's last logits through K1
    against its plain version, one decode step past the window through K2
    against its plain version, four requests (two of ~4500 and 6000
    tokens) over a bf16 cache of 8192. Returns (model, launches)."""
    import numpy as np

    from mfa_tpu_torch.models.llama import LlamaConfig
    from mfa_tpu_torch.ops.precision import OperandPrecision

    t0 = time.perf_counter()
    cfg, model = _random_hf_model(torch, MISTRAL_7B_CONFIG, seed=30)
    if cfg != LlamaConfig.mistral_7b():
        raise SystemExit(f"mistral: config_from_hf gave {cfg}")
    torch.cuda.synchronize()
    emit({"phase": "mistral_init", "seconds": time.perf_counter() - t0,
          "config": dataclasses.asdict(cfg),
          "params": sum(p.numel() for p in model.parameters()),
          "weights_gib": _weight_gib(model)})

    rng = np.random.default_rng(30)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (200, 1000, 4500, 6000)]
    toks = torch.tensor([prompts[-1]], device="cuda")
    _in_context(torch, model, toks, "mistral_k1", decode=False,
                window=cfg.sliding_window)
    _in_context(torch, model, toks, "mistral_k2",
                kv_precision=OperandPrecision.BF16, max_len=8192)
    emit({"phase": "mistral_prefill", "ms_per_bucket": _prefill_ms(
        torch, model, (4096, 8192), 8192)})
    summary, launches, _ = _serve(torch, model, prompts,
                                  OperandPrecision.BF16, max_len=8192,
                                  prompt_buckets=MISTRAL_BUCKETS)
    emit({"phase": "mistral_serving", **summary})
    emit({"phase": "mistral_serving_done",
          "seconds": time.perf_counter() - t0, "launches": launches})
    return model, launches


def phase_evaluate(torch, model):
    """Perplexity of the Mistral model through the causal forward (K1) and
    through the decode path (K2) over bf16, INT8 and FP8-e4m3 caches:
    batch 2, 256 tokens, max_len 384, held to tests/test_aux.py's
    conditions. Returns K1's and K2's launches."""
    import numpy as np

    from mfa_tpu_torch.kernels import decode as k2
    from mfa_tpu_torch.kernels import flash_fwd as k1
    from mfa_tpu_torch.ops.precision import OperandPrecision
    from mfa_tpu_torch.utils import evaluate

    t0 = time.perf_counter()
    cfg = model.cfg
    b, t, max_len = 2, 256, 384
    tokens = torch.from_numpy(np.random.default_rng(40).integers(
        1, cfg.vocab_size, (b, t))).cuda()
    torch.cuda.synchronize()
    for f in (k1.flash_fwd, k2.decode_fused_append):
        f.launches = 0
    p_full = evaluate.perplexity_full(model, tokens)
    rows, ok = {}, True
    for name, prec in (("int8", OperandPrecision.INT8),
                       ("fp8_e4m3", OperandPrecision.FP8_E4M3)):
        t_q = time.perf_counter()
        p_bf16, p_q, delta = evaluate.kv_quantization_ppl_delta(
            model, tokens, prec, max_len=max_len)
        row_ok = (0.5 * p_full < p_bf16 < 2.0 * p_full
                  and delta / p_bf16 < 0.02)
        ok = ok and row_ok
        rows[name] = dict(ppl_bf16_kv=p_bf16, ppl_quant_kv=p_q,
                          delta=delta, delta_over_ppl=delta / p_bf16,
                          ok=row_ok, seconds=time.perf_counter() - t_q)
    torch.cuda.synchronize()
    launches = {"flash_fwd": k1.flash_fwd.launches,
                "decode_fused_append": k2.decode_fused_append.launches}
    # One full forward and four decode runs (bf16 and quantized, twice),
    # each a one-token prefill and t - 1 decode steps.
    want = {"flash_fwd": cfg.n_layers * 5,
            "decode_fused_append": cfg.n_layers * 4 * (t - 1)}
    ok = ok and launches == want
    emit({"phase": "evaluate", "batch": b, "tokens": t, "max_len": max_len,
          "ppl_full": p_full, **rows, "launches": launches,
          "expected_launches": want, "ok": ok,
          "seconds": time.perf_counter() - t0})
    if not ok:
        raise SystemExit(f"evaluate: perplexities or launches wrong "
                         f"(full {p_full}, {rows}, launches {launches})")
    return launches


def _autotune_native(torch) -> None:
    """The C++ host config core (ops/native.py): g++'s build, the core
    equal to the Python on every table with this card's device model
    (parse, the shared-memory check of every row, the first row of every
    head dim) and on K7's tile over a grid of problems, and the host
    bench's ns."""
    from mfa_tpu_torch.ops import native, params
    from mfa_tpu_torch.ops.descriptors import GEMMDescriptor
    from mfa_tpu_torch.ops.precision import OperandPrecision as P

    dev = params.detect_device(torch.device("cuda", 0))
    lib = native.load()
    rows = problems = 0
    for (kernel, prec), text in params._TABLES[dev.name].items():
        table = params.parameter_table(kernel, prec, dev)
        same = native.parameter_table(kernel, prec, dev) == table and all(
            native.select_row(table, d) == params.select_row(table, d)
            for d in range(1, 1025))
        in_bytes = 2 if prec.startswith("bf16") else 4
        same = same and all(native.smem_bytes(kernel, r, in_bytes)
                            == params.smem_bytes(kernel, r, in_bytes)
                            for r in table)
        if not same:
            raise SystemExit(f"host core differs from params on {kernel} "
                             f"{prec}")
        rows += len(table)
    sides = (1, 16, 17, 127, 200, 1000, 1536, 2048, 4096, 14336)
    for m in sides:
        for n in sides:
            for a, b in ((P.BF16, P.BF16), (P.FP16, P.FP16),
                         (P.FP32, P.FP32)):
                desc = GEMMDescriptor(m=m, n=n, k=4096, a_precision=a,
                                      b_precision=b, c_precision=a)
                kd = desc.kernel_descriptor(dev)
                want = (kd.tile.name,
                        kd.mma_tile.name if kd.mma_tile else None)
                if native.gemm_tile(desc, dev) != want:
                    raise SystemExit(f"host core's K7 tile differs at {desc}")
                problems += 1
    out = native.host_bench()
    ns = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"\] (.+?): ([\d.]+) ns/call", out)}
    emit({"phase": "autotune_native", "build_seconds": lib.build_seconds,
          "compiled": lib.compiled, "device": dev.name,
          "sm_count": dev.sm_count, "smem_per_block": dev.smem_per_block,
          "tables": len(params._TABLES[dev.name]), "rows": rows,
          "gemm_problems": problems, "equal": True, "host_bench_ns": ns,
          "budget_ok": out.rstrip().endswith("host-path budget OK")})


def _autotune_gemm(torch) -> None:
    """The GEMM hook at bf16 1536^3 and 4096^3: the first call searches
    (at least two candidates timed), the second searches nothing and
    launches the winner once, bit-equal to the first call's output, held
    to the same call through the plain version at KERNEL_BUDGETS; the
    winning tile and band, and torch.matmul as a yardstick."""
    from mfa_tpu_torch.kernels import gemm_kernel as k7
    from mfa_tpu_torch.ops.cache import gemm_cache
    from mfa_tpu_torch.ops.gemm import SEARCH_LAUNCHES, gemm
    from mfa_tpu_torch.utils.testing import KERNEL_BUDGETS, budget_share

    memo = gemm_cache.tuned
    gen = torch.Generator(device="cuda").manual_seed(20)
    for n in (1536, 4096):
        a, b = (torch.randn((n, n), generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        launched = []
        for _ in range(2):
            torch.cuda.synchronize()
            k7.gemm_kernel.launches = 0
            c = gemm(a, b)
            torch.cuda.synchronize()
            launched.append((k7.gemm_kernel.launches, c,
                             sum(memo.searches.values()),
                             sum(memo.timed.values())))
        (key,) = [k for k in memo.searches if k[0] == n]
        with plain_kernels():
            c_p = gemm(a, b)
        share = budget_share(launched[1][1], c_p, *KERNEL_BUDGETS["gemm_bf16"])
        note = memo.notes[key]
        timed = memo.timed[key]
        ok = (memo.searches[key] == 1 and timed >= 2
              and launched[0][0] == timed * SEARCH_LAUNCHES + 1
              and launched[1][0] == 1 and launched[1][2:] == launched[0][2:]
              and torch.equal(launched[0][1], launched[1][1]) and share <= 1)
        emit({"phase": "autotune_gemm", "case": f"bf16_{n}^3",
              "searches": memo.searches[key], "candidates_timed": timed,
              "second_call_timed": launched[1][3] - launched[0][3],
              "launches": [launched[0][0], launched[1][0]],
              "search_s": note["search_s"],
              "winner": note["winner"], "winner_ms": note["winner_ms"],
              "heuristic_ms": note["heuristic_ms"],
              "matmul_ms": note["matmul_ms"],
              "candidates": note["candidates"], "share": share, "ok": ok})
        if not ok:
            raise SystemExit(f"gemm autotune at {n}^3: {note}, launches "
                             f"{[x[0] for x in launched]}, share {share}")
        del a, b, c, c_p, launched


# The attention hook's cases: (name, Hq, Hkv, D) at B 1, N 2048, causal.
AUTOTUNE_ATTENTION = (("llama3_8b", 32, 8, 128), ("openllama_3b", 32, 32, 100))


def _autotune_attention(torch) -> None:
    """The attention hook on K1's forward at Llama-3-8B's and
    OpenLLaMA-3B's prefill attention (the latter on rows TMA cannot map:
    the copying producer): one search, then the memo; the winner's row,
    a second call bit-equal to the first, held to the plain version."""
    from mfa_tpu_torch.kernels import flash_fwd as k1
    from mfa_tpu_torch.ops.attention import flash_attention
    from mfa_tpu_torch.ops.cache import attention_cache
    from mfa_tpu_torch.ops.gemm import SEARCH_LAUNCHES
    from mfa_tpu_torch.utils.testing import KERNEL_BUDGETS, budget_share

    memo = attention_cache.tuned
    gen = torch.Generator(device="cuda").manual_seed(21)
    for name, hq, hkv, d in AUTOTUNE_ATTENTION:
        q, k, v = _k1_inputs(torch, gen, 2048, 2048, torch.bfloat16, hq, hkv,
                             d)
        launched = []
        for _ in range(2):
            torch.cuda.synchronize()
            k1.flash_fwd.launches = 0
            rows = dict(k1.launches_by_row)
            o = flash_attention(q, k, v, causal=True)
            torch.cuda.synchronize()
            launched.append((k1.flash_fwd.launches, o, {
                r: c - rows.get(r, 0) for r, c in k1.launches_by_row.items()
                if c != rows.get(r, 0)}))
        (key,) = [x for x in memo.searches if x[1].head_dim == d]
        with plain_kernels():
            o_p = flash_attention(q, k, v, causal=True)
        share = budget_share(launched[1][1], o_p,
                             *KERNEL_BUDGETS["flash_fwd_o_bf16"])
        note = memo.notes[key]
        timed = memo.timed[key]
        table_row = note["candidates"][0][0]
        ok = (memo.searches[key] == 1 and timed >= 2
              and launched[0][0] == timed * SEARCH_LAUNCHES + 1
              and launched[1][0] == 1
              and launched[1][2] == {note["winner_row"]: 1}
              and table_row == ("wgmma/copy" if d % 8 else "wgmma")
              and torch.equal(launched[0][1], launched[1][1]) and share <= 1)
        emit({"phase": "autotune_attention", "case": name, "Hq": hq,
              "Hkv": hkv, "D": d, "N": 2048, "causal": True,
              "searches": memo.searches[key], "candidates_timed": timed,
              "launches": [launched[0][0], launched[1][0]],
              "search_s": note["search_s"],
              "winner": note["winner"], "winner_row": note["winner_row"],
              "winner_ms": note["winner_ms"], "table_row": table_row,
              "table_ms": note["table_ms"], "candidates": note["candidates"],
              "share": share, "ok": ok})
        if not ok:
            raise SystemExit(f"attention autotune {name}: {note}, launches "
                             f"{[x[0] for x in launched]} "
                             f"{launched[1][2]}, share {share}")
        del q, k, v, o, o_p, launched


def _autotune_offline(torch) -> None:
    """utils/autotune.py's tuners: K1, K3 and K4 at Llama-3-8B's attention
    (Hq 32, Hkv 8, D 128, N 2048, causal) and K7 at bf16 1536^3, each
    candidate held to its plain version first; the table row's ms beside
    the winner's (and torch.matmul's for K7)."""
    from mfa_tpu_torch.ops.descriptors import (
        AttentionDescriptor,
        AttentionKernelType,
    )
    from mfa_tpu_torch.utils import autotune, roofline

    desc = AttentionDescriptor(
        batch=1, num_q_heads=32, num_kv_heads=8, seq_len_q=2048,
        seq_len_kv=2048, head_dim=128, causal=True,
        low_precision_inputs=True, low_precision_intermediates=True)
    lines = []
    for kernel, kind in (("forward", AttentionKernelType.FORWARD),
                         ("backward_query",
                          AttentionKernelType.BACKWARD_QUERY),
                         ("backward_key_value",
                          AttentionKernelType.BACKWARD_KEY_VALUE)):
        kw = dict(kv_heads=8, causal=True, verbose=lines.append)
        results = (autotune.tune_forward(128, 2048, 32, **kw)
                   if kernel == "forward"
                   else autotune.tune_backward(kernel, 128, 2048, 32, **kw))
        flops = roofline.attention_flops(kernel, 2048, 2048, 128,
                                         batch_heads=32, causal=True)
        ms = {(kd.block_q, kd.block_kv, kd.block_d, kd.kernel):
              flops / tf / 1e9 for tf, kd in results}
        table = desc.kernel_descriptor(kind)
        table = (table.block_q, table.block_kv, table.block_d, table.kernel)
        best = results[0][1]
        emit({"phase": "autotune_offline", "kernel": kernel, "D": 128,
              "N": 2048, "Hq": 32, "Hkv": 8, "causal": True,
              "candidates": [[list(r), t] for r, t in ms.items()],
              "table_row": table, "table_ms": ms[table],
              "winner_row": f"128 | {best.block_q} | {best.block_kv} | "
                            f"{best.block_d} | {best.kernel}",
              "winner_ms": flops / results[0][0] / 1e9})
        torch.cuda.empty_cache()
    results, matmul_tflops = autotune.tune_gemm(1536, 1536, 1536,
                                                verbose=lines.append)
    flops = 2.0 * 1536 ** 3
    ms = {f"{tile}/{band}": flops / tf / 1e9 for tf, (tile, band) in results}
    emit({"phase": "autotune_offline", "kernel": "gemm", "M": 1536,
          "N": 1536, "K": 1536, "candidates": ms,
          "table_ms": ms["{}/{}".format(
              *autotune.gemm_candidates(1536, 1536, 1536, 2)[0])],
          "winner": list(results[0][1]),
          "winner_ms": flops / results[0][0] / 1e9,
          "matmul_ms": flops / matmul_tflops / 1e9})


def phase_autotune(torch) -> None:
    """The MFA_AUTOTUNE dispatch hooks and the offline tuners of
    utils/autotune.py, and the C++ host config core (ops/native.py). The
    autotune is switched on for the hooks and off at the end, so that
    what follows launches the table rows."""
    from mfa_tpu_torch.ops.cache import attention_cache, gemm_cache
    from mfa_tpu_torch.ops.gemm import set_autotune

    t0 = time.perf_counter()
    _autotune_native(torch)
    gemm_cache.clear()
    attention_cache.clear()
    set_autotune(True)
    _autotune_gemm(torch)
    _autotune_attention(torch)
    set_autotune(None)
    gemm_cache.clear()
    attention_cache.clear()
    _autotune_offline(torch)
    torch.cuda.empty_cache()
    emit({"phase": "autotune_done", "seconds": time.perf_counter() - t0})


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
    from mfa_tpu_torch.ops.precision import OperandPrecision

    smi = phase_device(torch)
    phase_build()
    k1_row, k1_noncausal_row, k1_head_dims = phase_k1(torch)
    k2_row, k2_head_dims = phase_k2(torch)
    k5_row, k5_head_dims, k5_launches = phase_k5(torch)
    k6_row, k6_head_dims = phase_k6(torch)
    k7_row, k7_launches = phase_k7(torch)
    k8_row, k8_resplit = phase_k8(torch)
    launches, model, prompts, served = phase_serving(torch)
    bf16_tokens = served[OperandPrecision.BF16][0]
    paged_k1, k6_launches = phase_paged_serving(torch, model, prompts,
                                                bf16_tokens)
    par = phase_parallel(torch, model, smi, prompts, served)
    # Quantize the served bf16 model before it goes (embedding, norms and
    # lm_head stay shared with it).
    bf16_gib = _weight_gib(model)
    int4_model = model.quantized(OperandPrecision.INT4)
    int8_model = model.quantized(OperandPrecision.INT8)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    int4_launches = phase_int4_serving(torch, int4_model, int8_model,
                                       prompts, bf16_gib, bf16_tokens)
    del int4_model, int8_model
    gc.collect()
    torch.cuda.empty_cache()
    bwd_row, bwd_head_dims = phase_bwd(torch)
    large_d, large_d_launches = phase_large_d(torch)
    train_launches = phase_training(torch)
    openllama_train = phase_openllama_training(torch)
    qwen2_model, qwen2_launches = phase_qwen2_serving(torch)
    ckpt_launches = phase_checkpoint(torch, qwen2_model)
    del qwen2_model
    gc.collect()
    torch.cuda.empty_cache()
    mistral_model, mistral_launches = phase_mistral_serving(torch)
    eval_launches = phase_evaluate(torch, mistral_model)
    del mistral_model
    gc.collect()
    torch.cuda.empty_cache()
    openllama_launches, openllama_k1, openllama_k6 = (
        phase_openllama_serving(torch))
    phase_autotune(torch)
    new = {}
    for n in (qwen2_launches, ckpt_launches, mistral_launches,
              eval_launches, openllama_launches):
        _add(new, n)
    # K1 runs on the three Llama-3-8B serving runs, both trainings
    # (Llama-3-8B's widths and OpenLLaMA-3B), the entry point past D =
    # 256 (large_d), the parallel phase and the new phases' paths; K3 and
    # K4 on both trainings, large_d and the parallel phase; K2 on the
    # contiguous serving runs, the tp decode steps and the new paths; K8
    # on the INT4 serving runs. K1's non-causal mode (the twin of
    # _fwd_kernel) runs only on the ring's off-diagonal chunks (parallel);
    # its row carries the k1 phase's non-causal case. K1, K3 and K4 also
    # carry their times past D = 128 (large_d) beside the D = 128
    # figures; K3 and K4 theirs where TMA cannot map (BWD_HEAD_DIM_CASES:
    # head_dims); K2, K5 and K6 theirs at HEAD_DIM_CASES (head_dims). K6
    # runs on both paged serving runs (Llama-3-8B's and OpenLLaMA-3B's).
    def large(key, cases):
        return {"large_d": {case: large_d[case][key] for case in cases}}

    fwd_cases = ("noncausal_d384", "causal_d384", "noncausal_d512",
                 "causal_d512", "causal_d256", "causal_d192",
                 "noncausal_d256")
    copy_cases = ("causal_d250_n1024", "noncausal_d250_n1024")
    kernels = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "mfa_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "mfa_tpu/kernels/flash_fwd.py:349",
         "launches": (launches["flash_fwd"] + paged_k1 + openllama_k1
                      + int4_launches["flash_fwd"]
                      + train_launches["flash_fwd"]
                      + openllama_train["flash_fwd"]
                      + large_d_launches["flash_fwd"] + new["flash_fwd"]
                      + par["flash_fwd"] - par["flash_fwd_noncausal"]),
         **{k: v for k, v in k1_row.items()
            if k not in ("lse_err", "row")},
         **large("k1", fwd_cases + ("gqa_softcap50_d256",) + copy_cases),
         "head_dims": {case: {k: v for k, v in t.items() if k != "lse_err"}
                       for case, t in k1_head_dims.items()}},
        {"name": "flash_fwd_noncausal", "route": "cuda",
         "source": "mfa_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "mfa_tpu/kernels/flash_fwd.py:49",
         "launches": par["flash_fwd_noncausal"],
         **{k: v for k, v in k1_noncausal_row.items()
            if k not in ("lse_err", "row")}},
        {"name": "decode_fused_append", "route": "cuda",
         "source": "mfa_tpu_torch/csrc/decode.cu",
         "replaces": "mfa_tpu/kernels/decode.py:431",
         "launches": (launches["decode_fused_append"]
                      + int4_launches["decode_fused_append"]
                      + new["decode_fused_append"]
                      + par["decode_fused_append"]), **k2_row,
         "head_dims": k2_head_dims},
        {"name": "flash_bwd_q", "route": "cuda",
         "source": "mfa_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "mfa_tpu/kernels/flash_bwd.py:59",
         "launches": (train_launches["flash_bwd_q"]
                      + openllama_train["flash_bwd_q"]
                      + large_d_launches["flash_bwd_q"]
                      + par["flash_bwd_q"]),
         **bwd_row["q"], **large("k3", fwd_cases + copy_cases),
         "head_dims": {case: t["q"] for case, t in bwd_head_dims.items()}},
        {"name": "flash_bwd_kv", "route": "cuda",
         "source": "mfa_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "mfa_tpu/kernels/flash_bwd.py:427",
         "launches": (train_launches["flash_bwd_kv"]
                      + openllama_train["flash_bwd_kv"]
                      + large_d_launches["flash_bwd_kv"]
                      + par["flash_bwd_kv"]),
         **bwd_row["kv"], **large("k4", fwd_cases + copy_cases),
         "head_dims": {case: t["kv"] for case, t in bwd_head_dims.items()}},
        # K5's path is its entry point, decode_attention, driven in k5.
        {"name": "decode_attend", "route": "cuda",
         "source": "mfa_tpu_torch/csrc/decode_attend.cu",
         "replaces": "mfa_tpu/kernels/decode.py:101 and :208",
         "launches": k5_launches, **k5_row, "head_dims": k5_head_dims},
        {"name": "paged_decode", "route": "cuda",
         "source": "mfa_tpu_torch/csrc/paged_decode.cu",
         "replaces": "mfa_tpu/kernels/paged_decode.py:43",
         "launches": k6_launches + openllama_k6, **k6_row,
         "head_dims": k6_head_dims},
        # K7's path is its entry point, gemm, driven in k7.
        {"name": "gemm", "route": "cuda",
         "source": "mfa_tpu_torch/csrc/gemm.cu",
         "replaces": "mfa_tpu/kernels/gemm_kernel.py:34",
         "launches": k7_launches, **k7_row},
        {"name": "int4_matmul", "route": "cuda",
         "source": "mfa_tpu_torch/csrc/quant_matmul.cu",
         "replaces": "mfa_tpu/kernels/quant_matmul.py:27 and :54",
         "launches": int4_launches["int4_matmul"] + new["int4_matmul"],
         **k8_row, "resplit": k8_resplit},
    ]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
