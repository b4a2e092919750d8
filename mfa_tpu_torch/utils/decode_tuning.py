"""Launch-shape sweep and two-tree comparison of the split-KV decode
kernels (K2 ``decode_fused_append``, K5 ``decode_attend``, K6
``paged_decode``), and the other kernels' phases in turns, on one GPU.

``sweep`` times K5 and K6 at ``chip_smoke.py``'s table shapes, and K6 at
the profiler's paged serving step (8 slots at ~1030 tokens), for every
split size R in 64..1024 and CTA size in 128 and 256 threads; each
configuration is first held to its plain version at
``KERNEL_BUDGETS``; ``sweep --wide`` runs K2, K5 and K6 past D 256 (the
512-wide tensor-core pair) at every split size R. ``kernels`` splits a
call's device time between its kernels (torch.profiler). ``turns`` runs
``chip_smoke.py``'s k5 and k6 phases (``--what kernels``), its serving
and paged serving phases (``serving``), a host-time probe of the K6, K2
and K8 wrappers (``host``), its
forward kernel phase (``k1``), its fused decode phase (``k2``), its
backward kernel phase (``bwd``, K3 and K4; ``k34_rows``: K3 and K4
alone at Llama-3-8B's D 128, OpenLLaMA-3B's D 100 and D 250, each on the
row its tree routes it to), its GEMM phase (``k7``), its
INT4 matmul phase (``k8``; ``k8d``: the decode tile alone at M 4 and
16), its training phase (``training``; ``openllama_train``: the profiler's
train step of OpenLLaMA-3B at its full depth), the profiler's serving
phase
(``profile``: prefills and decode steps over bf16, INT8 and FP8 caches;
``openllama_profile``: OpenLLaMA-3B's, with its paged steps;
``openllama_prefill``: its
prefills timed without the profiler), its INT4 phase (``int4``) or K1
alone on its copying and TMA rows (``k1_rows``), or K2, K5 and K6 at D 64
to 512 over bf16, int8 and fp8 caches (``decode_dims``) from two trees in
turns
(A, B, B, A), each
in a process of its own that builds and loads its own tree's kernels.
``rounding`` holds K2, K5, K6 and K1 (alone and inside the ring's merge)
and their plain versions against fp64 where attention concentrates and O
cancels (``ROUNDING_CASES``). ``sass`` compares the machine code
(``cuobjdump -sass``) of every kernel of the decode sources in two trees
and names those that differ.

Run on a GPU from the repository root:

    python -m mfa_tpu_torch.utils.decode_tuning sweep [--wide] \
        [--out chiprun_out]
    python -m mfa_tpu_torch.utils.decode_tuning kernels
    python -m mfa_tpu_torch.utils.decode_tuning rounding
    python -m mfa_tpu_torch.utils.decode_tuning sass --a build/parent --b .
    python -m mfa_tpu_torch.utils.decode_tuning turns --a build/parent --b . \
        [--what kernels|serving|host|k1|k1_rows|k2|bwd|k7|k8|k8d|training|
                profile|openllama_profile|openllama_prefill|int4|
                decode_dims|k34_rows|openllama_train]
"""

from __future__ import annotations

import argparse
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from mfa_tpu_torch.kernels import decode as k5
from mfa_tpu_torch.kernels import paged_decode as k6
from mfa_tpu_torch.ops import params as params_mod
from mfa_tpu_torch.ops.precision import OperandPrecision
from mfa_tpu_torch.serving import kv_cache
from mfa_tpu_torch.utils import roofline
from mfa_tpu_torch.utils.testing import (
    KERNEL_BUDGETS,
    attention_fp64,
    budget_share,
    decode_fp64,
    rounding_steps,
    shuffled_page_pool,
)

SPLIT_ROWS = (64, 128, 256, 512, 1024)
THREADS = (128, 256)
_STORAGE = {"bf16": torch.bfloat16, "int8": torch.int8,
            "fp8_e4m3": torch.float8_e4m3fn}


def _contiguous(gen, fmt: str, max_len: int, d: int, g: int):
    """chip_smoke.phase_k5's cache: B = 4, Hkv = 8, lengths 0, 777, L - 1,
    L; q [32, g, d] pre-scaled. Returns (q3, k, v, k_scale, v_scale,
    lengths) as the kernels take them."""
    b, hkv = 4, 8
    prec = {"bf16": OperandPrecision.BF16, "int8": OperandPrecision.INT8,
            "fp8_e4m3": OperandPrecision.FP8_E4M3}[fmt]
    cache = kv_cache.create(b, hkv, max_len, d, prec, device="cuda")
    kv_cache.update(cache, *torch.randn((2, b, hkv, max_len, d),
                                        generator=gen, device="cuda"))
    lengths = torch.tensor([0, 777, max_len - 1, max_len], dtype=torch.int32,
                           device="cuda")
    q3 = (torch.randn((b * hkv, g, d), generator=gen, device="cuda")
          * (math.log2(math.e) / math.sqrt(d))).bfloat16()
    bh = b * hkv
    return (q3, cache.k.view(bh, max_len, d), cache.v.view(bh, max_len, d),
            cache.k_scale.view(bh, max_len), cache.v_scale.view(bh, max_len),
            lengths)


def _k5_case(gen, fmt: str, max_len: int, d: int = 128, g: int = 4):
    """K5 over chip_smoke.phase_k5's cache (D 128, G 4 by default)."""
    args = _contiguous(gen, fmt, max_len, d, g)
    return (lambda: k5.decode_attend(*args, num_kv_heads=8),
            lambda: k5.decode_attend_plain(*args, num_kv_heads=8),
            "decode_attend_o")


def _k2_case(gen, fmt: str, max_len: int, d: int, g: int):
    """K2 over the same cache, with the step's new K and V (it appends to
    the rows past each length, which the kernel never reads)."""
    args = _contiguous(gen, fmt, max_len, d, g)
    kn, vn = (torch.randn((32, d), generator=gen, device="cuda").bfloat16()
              for _ in range(2))
    return (lambda: k5.decode_fused_append(*args[:5], kn, vn, args[5],
                                           num_kv_heads=8),
            lambda: k5.decode_fused_append_plain(*args[:5], kn, vn, args[5],
                                                 num_kv_heads=8),
            "decode_o")


def _k6_case(gen, fmt: str, lens, d: int = 128, g: int = 4):
    """chip_smoke.phase_k6's shape: Hkv = 8, G = 4, D = 128 by default,
    512-token pages, capacity 2048, shuffled page ids."""
    hkv, ps = 8, 512
    operands = (*shuffled_page_pool(_STORAGE[fmt], lens, hkv, d, ps, 4,
                                    generator=gen, device="cuda"),
                torch.tensor(lens, dtype=torch.int32, device="cuda"))
    q3 = (torch.randn((len(lens) * hkv, g, d), generator=gen, device="cuda")
          * (math.log2(math.e) / math.sqrt(d))).bfloat16()
    return (lambda: k6.paged_decode(q3, *operands),
            lambda: k6.paged_decode_plain(q3, *operands), "paged_decode_o")


def _wide_cases(gen) -> dict:
    """K2, K5 and K6 past D 256 (the 512-wide tensor-core pair) at
    decode_dims' shapes: D 300 (G 4), 384 (G 8) and 512 (G 1) over bf16
    and int8."""
    cases = {}
    for d, g in ((300, 4), (384, 8), (512, 1)):
        for fmt in ("bf16", "int8"):
            cases[f"k5_{fmt}_D{d}"] = _k5_case(gen, fmt, 2048, d, g)
            cases[f"k2_{fmt}_D{d}"] = _k2_case(gen, fmt, 2048, d, g)
            cases[f"k6_{fmt}_D{d}"] = _k6_case(
                gen, fmt, [0, 1, 511, 512, 513, 777, 2047, 2048], d, g)
    return cases


def sweep(out: Path, wide: bool = False) -> None:
    """Each case at every split size of SPLIT_ROWS and CTA size of
    THREADS (DECODE_ATTEND_THREADS), held to its plain version first,
    then timed; then each at the rule's launch. ``wide``: the cases of
    :func:`_wide_cases` at every split size alone (their CTAs take 128
    threads whatever DECODE_ATTEND_THREADS says)."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    if wide:
        cases, threads = _wide_cases(gen), (params_mod.DECODE_ATTEND_THREADS,)
    else:
        cases = {f"k5_{fmt}_L{n}": _k5_case(gen, fmt, n)
                 for fmt in ("bf16", "int8") for n in (2048, 8192)}
        cases["k6_bf16_page512"] = _k6_case(
            gen, "bf16", [0, 1, 511, 512, 513, 777, 2047, 2048])
        cases["k6_bf16_serving_8x1030"] = _k6_case(gen, "bf16", [1030] * 8)
        threads = THREADS
    rule_rows, rule_threads = (params_mod.decode_split_rows,
                               params_mod.DECODE_ATTEND_THREADS)
    rows = []
    for t in threads:
        for r in SPLIT_ROWS:
            params_mod.decode_split_rows = lambda *a, _r=r, **k: _r
            params_mod.DECODE_ATTEND_THREADS = t
            for name, (kernel, plain, budget) in cases.items():
                share = budget_share(kernel(), plain(),
                                     *KERNEL_BUDGETS[budget])
                row = {"case": name, "R": r, "threads": t,
                       "ms": roofline.cuda_ms(kernel, iters=50),
                       "share": share}
                if not share <= 1:
                    raise SystemExit(f"sweep: {row} exceeds its budget")
                rows.append(row)
                print(json.dumps(row), flush=True)
    params_mod.decode_split_rows = rule_rows
    params_mod.DECODE_ATTEND_THREADS = rule_threads
    for name, (kernel, _, _) in cases.items():
        print(json.dumps({"case": name, "rule": True,
                          "ms": roofline.cuda_ms(kernel, iters=50)}),
              flush=True)
    out.mkdir(parents=True, exist_ok=True)
    (out / ("decode_sweep_wide.jsonl" if wide else "decode_sweep.jsonl")
     ).write_text("".join(json.dumps(r) + "\n" for r in rows))


def kernels(calls: int = 20) -> None:
    """Device ms of each of a call's kernels (decode_score, K2's
    decode_pmax over int8, decode_attend) by torch.profiler, at the rule's
    launch: K5 at L 2048 and 8192 and K6 at the serving step over bf16,
    then K2, K5 and K6 at decode_dims' D 100 (G 1), D 128 (G 4), D 384
    (G 8) and D 512 (G 1) over bf16, int8 and fp8-e4m3. A kernel's time
    runs from its start, which a programmatic dependent reaches before
    its predecessor ends, so the parts overlap and sum past the call's
    time."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    cases = {f"k5_bf16_L{n}": _k5_case(gen, "bf16", n) for n in (2048, 8192)}
    cases["k6_bf16_serving_8x1030"] = _k6_case(gen, "bf16", [1030] * 8)
    for d, g in ((100, 1), (128, 4), (384, 8), (512, 1)):
        for fmt in _STORAGE:
            cases[f"k2_{fmt}_D{d}"] = _k2_case(gen, fmt, 2048, d, g)
            cases[f"k5_{fmt}_D{d}"] = _k5_case(gen, fmt, 2048, d, g)
            cases[f"k6_{fmt}_D{d}"] = _k6_case(
                gen, fmt, [0, 1, 511, 512, 513, 777, 2047, 2048], d, g)
    activities = [torch.profiler.ProfilerActivity.CUDA]
    for name, (kernel, _, _) in cases.items():
        kernel()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(calls):
                kernel()
            torch.cuda.synchronize()
        per = {}
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", None)
            t = float(t if t is not None else e.self_cuda_time_total)
            for part in ("decode_score", "decode_pmax", "decode_attend"):
                if part in e.key and "Rows" in e.key:
                    per[part] = per.get(part, 0.0) + t / 1e3 / calls
        print(json.dumps({"case": name, "device_ms": per}), flush=True)


# Concentrated attention for ``rounding``: (cache format, Hkv, G,
# lengths, q scale, k and v scale). Larger scores concentrate P on a
# few rows, whose values then cancel in O.
ROUNDING_CASES = (
    ("fp8_e4m3", 4, 7, (256,) * 4, 1, 4),
    ("fp8_e4m3", 4, 7, (257,) * 4, 1, 1),
    ("bf16", 8, 4, (256,) * 4, 4, 1),
    ("bf16", 4, 7, (256,) * 4, 1, 1),
    ("bf16", 8, 4, (1000,) * 4, 8, 1),
    ("fp8_e4m3", 8, 4, (1000,) * 4, 8, 1),
)


def _share_row(prefix, got, plain, budget, terms, steps):
    """Shares of ``budget`` (relative term of |O| and of sum P |v| / l)
    and both sides' distance from fp64 in bf16 steps."""
    atol, rtol = KERNEL_BUDGETS[budget]
    return {f"{prefix}_share_of_abs_o": budget_share(got, plain, atol, rtol),
            f"{prefix}_share_of_terms": budget_share(got, plain, atol, rtol,
                                                     scale=terms),
            f"{prefix}_bf16_steps_from_fp64": steps(got),
            f"{prefix}_plain_bf16_steps_from_fp64": steps(plain)}


def _paged(cache_t, page: int = 128):
    """A contiguous cache tensor [B, Hkv, L, ...] as a page pool [1 + B *
    L / page, Hkv, page, ...] (page 0 null) and its tables [B, L /
    page]: sequence b's page j is pool page 1 + b * L / page + j."""
    b, hkv, n = cache_t.shape[:3]
    per = n // page
    pages = cache_t.reshape(b, hkv, per, page, *cache_t.shape[3:]) \
        .movedim(2, 1).reshape(b * per, hkv, page, *cache_t.shape[3:])
    pool = pages.new_zeros((1 + b * per, *pages.shape[1:]))
    pool[1:] = pages
    tables = (1 + torch.arange(b * per, dtype=torch.int32,
                               device=cache_t.device)).reshape(b, per)
    return pool, tables


def _k1_rounding(gen, hq, hkv, n, q_mul, kv_mul):
    """K1 (flash_attention, causal) and K1 inside the sp = 4 ring's merge
    against their plain versions and an fp64 attention, on [1, H, N, 128]
    bf16 inputs scaled as the decode case's."""
    from mfa_tpu_torch.kernels import flash_fwd as k1
    from mfa_tpu_torch.ops.attention import flash_attention
    from mfa_tpu_torch.parallel.ring_attention import ring_schedule

    d = 128
    q = (torch.randn((1, hq, n, d), generator=gen, device="cuda")
         * q_mul).bfloat16()
    k, v = ((torch.randn((1, hkv, n, d), generator=gen, device="cuda")
             * kv_mul).bfloat16() for _ in range(2))
    exact, terms = (attention_fp64(
        q[0], k[0], v[0], group=hq // hkv, scale=d ** -0.5, causal=True,
        magnitudes=mag)[None] for mag in (False, True))
    atol = KERNEL_BUDGETS["flash_fwd_o_bf16"][0]

    def steps(o):
        return float(rounding_steps(o, exact, terms, atol).max())

    def run(fn):
        kernel = fn()
        real, k1.flash_fwd = k1.flash_fwd, k1.flash_fwd_plain
        plain = fn()
        k1.flash_fwd = real
        return kernel, plain

    row = _share_row("k1", *run(lambda: flash_attention(
        q, k, v, causal=True, device="cuda")), "flash_fwd_o_bf16", terms,
        steps)
    if n % 4 == 0:
        row.update(_share_row("ring_k1", *run(lambda: ring_schedule(
            q, k, v, n=4, causal=True, device="cuda")), "flash_fwd_o_bf16",
            terms, steps))
    return row


def rounding(trials: int = 3, seed: int = 0) -> list[dict]:
    """K2, K5 (decode_attend), K6 (paged_decode) and K1 (causal, and
    inside the sp = 4 ring's merge) and their plain versions against fp64
    on ROUNDING_CASES (decode: B 4, D 128, max_len 2048; K1: one sequence
    of the case's length, its heads): each kernel's share of its budget
    (decode_o, decode_attend_o, paged_decode_o, flash_fwd_o_bf16) with
    the relative term taken of |O| and of sum P |v| / l, and each side's
    distance from fp64 in bf16 steps (2^-7) of sum P |v| / l (the
    rounding both take where P v is rounded to bf16)."""
    atol, rtol = KERNEL_BUDGETS["decode_o"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows, d, b, max_len = [], 128, 4, 2048
    for fmt, hkv, g, lens, q_mul, kv_mul in ROUNDING_CASES:
        for trial in range(trials):
            bh = b * hkv
            cache = kv_cache.create(b, hkv, max_len, d, OperandPrecision(fmt),
                                    device="cuda")
            kv_cache.update(cache, *(torch.randn(
                (2, b, hkv, max_len, d), generator=gen, device="cuda")
                * kv_mul))
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            q3 = (torch.randn((bh, g, d), generator=gen, device="cuda")
                  * (q_mul * math.log2(math.e) / math.sqrt(d))).bfloat16()
            kn, vn = ((torch.randn((bh, d), generator=gen, device="cuda")
                       * kv_mul).bfloat16() for _ in range(2))

            def operands():
                return [t.clone() for t in (
                    cache.k.view(bh, max_len, d), cache.v.view(bh, max_len, d),
                    cache.k_scale.view(bh, max_len),
                    cache.v_scale.view(bh, max_len))]

            kw = dict(num_kv_heads=hkv)
            exact, terms = (decode_fp64(q3, *operands(), kn, vn, lengths,
                                        magnitudes=mag, **kw)
                            for mag in (False, True))
            o_p = k5.decode_fused_append_plain(q3, *operands(), kn, vn,
                                               lengths.clone(), **kw)
            o_k = k5.decode_fused_append(q3, *operands(), kn, vn,
                                         lengths.clone(), **kw)

            def steps(o):
                return float(rounding_steps(o, exact, terms, atol).max())

            row = {
                "kv": fmt, "hkv": hkv, "G": g, "lengths": list(lens),
                "q_scale": q_mul, "kv_scale": kv_mul, "trial": trial,
                "k2_share_of_abs_o": budget_share(o_k, o_p, atol, rtol),
                "k2_share_of_terms": budget_share(o_k, o_p, atol, rtol,
                                                  scale=terms),
                "k2_bf16_steps_from_fp64": steps(o_k),
                "plain_bf16_steps_from_fp64": steps(o_p)}
            # K5 and K6 over the same cache without the new token: its
            # fp64 is decode_fp64 over length - 1 rows with the last live
            # row (dequantized) as the new one.
            ops = operands()
            last = (lengths.long() - 1).repeat_interleave(hkv)
            idx = torch.arange(bh, device="cuda")
            k_last, v_last = (x[idx, last].double() * s_[idx, last, None]
                              for x, s_ in ((ops[0], ops[2]),
                                            (ops[1], ops[3])))
            exact, terms = (decode_fp64(q3, *ops, k_last, v_last,
                                        lengths - 1, magnitudes=mag, **kw)
                            for mag in (False, True))
            row.update(_share_row(
                "k5", k5.decode_attend(q3, *ops, lengths, **kw),
                k5.decode_attend_plain(q3, *ops, lengths, **kw),
                "decode_attend_o", terms, steps))
            (kp, tables), (vp, _), (ksp, _), (vsp, _) = (
                _paged(t) for t in (cache.k, cache.v, cache.k_scale,
                                    cache.v_scale))
            paged = (q3, kp, vp, ksp, vsp, tables, lengths)
            row.update(_share_row(
                "k6", k6.paged_decode(*paged), k6.paged_decode_plain(*paged),
                "paged_decode_o", terms, steps))
            row.update(_k1_rounding(gen, hkv * g, hkv, lens[0], q_mul,
                                    kv_mul))
            rows.append(row)
    return rows


# What ``turns`` runs in each tree (the tree's own chip_smoke.py and
# package, from its root): the kernel checks, the contiguous and paged
# serving runs, or the host time of one wrapper call (its launches queued
# behind a device spin): K6 at the profiler's paged step (8 x 1030 tokens,
# 512-token pages), K2 at the INT4 decode step's (4 slots x 8 kv heads,
# G 4, an FP8-e4m3 cache of 2048) and K8 at M 4 on two of its
# projections.
_TURNS = {
    "kernels": "c.phase_k5(torch); c.phase_k6(torch)",
    # K1's phase, then causal K1 alone at the server's prefill buckets
    # through the wrapper both trees have (R = C = 64, 512, 2048).
    "k1": """c.phase_k1(torch)
import json
from mfa_tpu_torch.kernels import flash_fwd as k1
from mfa_tpu_torch.ops.descriptors import (AttentionDescriptor,
                                           AttentionKernelType)
gen = torch.Generator(device="cuda").manual_seed(1)
for n in (64, 512, 2048):
    q, k, v = (torch.randn((h, n, 128), generator=gen, device="cuda")
               .bfloat16() for h in (32, 8, 8))
    desc = AttentionDescriptor(
        batch=1, num_q_heads=32, num_kv_heads=8, seq_len_q=n, seq_len_kv=n,
        head_dim=128, causal=True, low_precision_inputs=True,
        low_precision_intermediates=True)
    kd = desc.kernel_descriptor(AttentionKernelType.FORWARD)
    ms = roofline.cuda_ms(lambda: k1.flash_fwd(
        q, k, v, kd, group=4, scale=desc.softmax_scale,
        o_dtype=torch.bfloat16), iters=50)
    print(json.dumps({"phase": "k1_bucket", "N": n,
                      "row": [kd.block_q, kd.block_kv, kd.kernel],
                      "ms": ms}))
""",
    # K1 through the wrapper both trees have, at OpenLLaMA-3B's attention
    # (D 100, Hq = Hkv 32; N 2048 causal and not, N 512 causal), at D 250
    # (H 8, N 1024, causal and not), and on TMA rows: D 64 and 128
    # (Llama-3-8B's heads, N 2048) and D 256 (H 8, N 4096), causal and
    # not; each line names the row the tree's launch took.
    "k1_rows": """
import json
from mfa_tpu_torch.kernels import flash_fwd as k1
from mfa_tpu_torch.ops import descriptors
gen = torch.Generator(device="cuda").manual_seed(18)
shapes = [(100, 2048, 32, 32), (100, 512, 32, 32), (250, 1024, 8, 8),
          (64, 2048, 32, 8), (128, 2048, 32, 8), (256, 4096, 8, 8)]
for d, n, hq, hkv, causal in [(*s, c) for s in shapes for c in (True, False)
                              if c or s[1] != 512]:
    q, k, v = (torch.randn((h, n, d), generator=gen, device="cuda")
               .bfloat16() for h in (hq, hkv, hkv))
    desc = descriptors.AttentionDescriptor(
        batch=1, num_q_heads=hq, num_kv_heads=hkv, seq_len_q=n, seq_len_kv=n,
        head_dim=d, causal=causal, low_precision_inputs=True,
        low_precision_intermediates=True)
    kd = desc.kernel_descriptor(descriptors.AttentionKernelType.FORWARD)
    row = descriptors.launch_row(kd, d, (q, k, v))
    label = getattr(descriptors, "row_label", lambda r: r.kernel)(row)
    ms = roofline.cuda_ms(lambda: k1.flash_fwd(
        q, k, v, kd, group=hq // hkv, scale=desc.softmax_scale,
        o_dtype=torch.bfloat16), iters=50)
    print(json.dumps({"phase": "k1_rows", "D": d, "N": n, "Hq": hq,
                      "Hkv": hkv, "causal": causal, "row": label,
                      "ms": ms}))
""",
    # K2, K5 and K6 at the kernel table's shapes (K2, K5: 4 sequences x
    # Hkv 8, L 2048, lengths 0, 777, 2047, 2048; K6: 8 sequences of 0-2048
    # tokens on 512-token pages) at D 64, 80, 96, 100, 128, 192, 250, 256,
    # 300, 384 and 512 (G 4, 4, 8, 1, 4, 8, 4, 4, 4, 8, 1: chip_smoke's
    # HEAD_DIM_CASES) over bf16, int8 and fp8-e4m3 caches, through the
    # wrappers both trees have; each line names the path the tree's launch
    # took where the tree counts paths.
    "decode_dims": """
import json, math
from mfa_tpu_torch.kernels import decode as k5, paged_decode as k6
from mfa_tpu_torch.serving import kv_cache
from mfa_tpu_torch.ops.precision import OperandPrecision
from mfa_tpu_torch.utils.testing import shuffled_page_pool
gen = torch.Generator(device="cuda").manual_seed(19)
precs = {"bf16": OperandPrecision.BF16, "int8": OperandPrecision.INT8,
         "fp8_e4m3": OperandPrecision.FP8_E4M3}
def path_of(fn, run):
    by = getattr(fn, "launches_by_path", None)
    before = dict(by) if by is not None else None
    run()
    torch.cuda.synchronize()
    if by is None:
        return None
    return [k for k in by if by[k] != before.get(k, 0)]
for d, g in ((64, 4), (80, 4), (96, 8), (100, 1), (128, 4), (192, 8),
             (250, 4), (256, 4), (300, 4), (384, 8), (512, 1)):
    for fmt, prec in precs.items():
        b, hkv, L = 4, 8, 2048
        bh = b * hkv
        cache = kv_cache.create(b, hkv, L, d, prec, device="cuda")
        kv_cache.update(cache, *torch.randn((2, b, hkv, L, d),
                                            generator=gen, device="cuda"))
        lens = torch.tensor([0, 777, L - 1, L], dtype=torch.int32,
                            device="cuda")
        q3 = (torch.randn((bh, g, d), generator=gen, device="cuda")
              * (math.log2(math.e) / math.sqrt(d))).bfloat16()
        kn, vn = (torch.randn((bh, d), generator=gen, device="cuda")
                  .bfloat16() for _ in range(2))
        args = (cache.k.view(bh, L, d), cache.v.view(bh, L, d),
                cache.k_scale.view(bh, L), cache.v_scale.view(bh, L))
        k2_run = lambda: k5.decode_fused_append(q3, *args, kn, vn, lens,
                                                num_kv_heads=hkv)
        k5_run = lambda: k5.decode_attend(q3, *args, lens, num_kv_heads=hkv)
        s6 = [0, 1, 511, 512, 513, 777, 2047, 2048]
        ops6 = (*shuffled_page_pool(prec.dtype, s6, hkv, d, 512, 4,
                                    generator=gen, device="cuda"),
                torch.tensor(s6, dtype=torch.int32, device="cuda"))
        q6 = (torch.randn((8 * hkv, g, d), generator=gen, device="cuda")
              * (math.log2(math.e) / math.sqrt(d))).bfloat16()
        k6_run = lambda: k6.paged_decode(q6, *ops6)
        for name, fn, run in (("k2", k5.decode_fused_append, k2_run),
                              ("k5", k5.decode_attend, k5_run),
                              ("k6", k6.paged_decode, k6_run)):
            path = path_of(fn, run)
            ms = roofline.cuda_ms(run, iters=50)
            print(json.dumps({"phase": "decode_dims", "kernel": name,
                              "fmt": fmt, "D": d, "G": g, "path": path,
                              "ms": ms}))
""",
    # The profiler's serving and paged phases for OpenLLaMA-3B: prefills
    # of 512 and 2048 tokens, decode steps and whole paged-scheduler
    # steps, device time by kernel group.
    "openllama_profile": """
import json
from pathlib import Path
from mfa_tpu_torch.utils import profiling
out = Path("build/profiles")
out.mkdir(parents=True, exist_ok=True)
cfg = profiling.MODELS["openllama_3b"]
for row in (profiling.profile_serving(cfg, out=out)
            + profiling.profile_paged(cfg, out=out)):
    print(json.dumps(row))
""",
    # OpenLLaMA-3B's prefills without the profiler, on chip_smoke.py's
    # model (random weights, seed 40): the openllama phase's device ms a
    # bucket (CUDA events, queued behind a device spin), then the host
    # wall of single prefills of 512 and 2048 tokens, each after a
    # synchronize (time to first token; 12 a bucket, after 2 untimed).
    "openllama_prefill": """
import json, time
cfg, model = c._random_hf_model(torch, c.OPENLLAMA_3B_CONFIG, seed=40)
print(json.dumps({"phase": "openllama_prefill", "ms_per_bucket":
                  c._prefill_ms(torch, model, (512, 2048), 2048)}))
gen = torch.Generator(device="cuda").manual_seed(11)
for n in (512, 2048):
    toks = torch.randint(1, cfg.vocab_size, (1, n), generator=gen,
                         device="cuda")
    walls = []
    for rep in range(14):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            model(toks, caches=model.make_caches(1, 2048))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({"phase": "openllama_prefill_wall", "N": n,
                      "wall_ms": walls[2:]}))
""",
    "bwd": "c.phase_bwd(torch)",
    # K3 and K4 alone through the wrappers both trees have, at
    # Llama-3-8B's attention (D 128, Hq 32, Hkv 8, N 2048: TMA), at
    # OpenLLaMA-3B's (D 100, Hq = Hkv 32, N 2048) and at D 250 (H 8, N
    # 1024), causal and not: each tree's row (row_label) and device ms.
    "k34_rows": """
import json
from mfa_tpu_torch.kernels import flash_bwd as k34, flash_fwd as k1
from mfa_tpu_torch.ops.descriptors import (AttentionDescriptor,
                                           AttentionKernelType, row_label)
gen = torch.Generator(device="cuda").manual_seed(3)
for d, n, hq, hkv, causal in ((128, 2048, 32, 8, True),
                              (128, 2048, 32, 8, False),
                              (100, 2048, 32, 32, True),
                              (100, 2048, 32, 32, False),
                              (250, 1024, 8, 8, True)):
    q, k, v = c._k1_inputs(torch, gen, n, n, torch.bfloat16, hq, hkv, d)
    do = torch.randn((1, hq, n, d), generator=gen, device="cuda").bfloat16()
    desc = AttentionDescriptor(
        batch=1, num_q_heads=hq, num_kv_heads=hkv, seq_len_q=n,
        seq_len_kv=n, head_dim=d, causal=causal, low_precision_inputs=True,
        low_precision_intermediates=True)
    kd_f, kd_q, kd_kv = (desc.kernel_descriptor(t)
                         for t in AttentionKernelType)
    q3, k3, v3, do3 = (t.reshape(-1, n, d).contiguous()
                       for t in (q, k, v, do))
    kw = dict(group=hq // hkv, scale=desc.softmax_scale)
    o3, lse = k1.flash_fwd(q3, k3, v3, kd_f, o_dtype=torch.bfloat16, **kw)
    dq, dterm = k34.flash_bwd_q(q3, k3, v3, o3, do3, lse, kd_q, **kw)
    rows = [row_label(k34.launch_row(kd, d, (q3, k3, v3, do3)))
            for kd in (kd_q, kd_kv)]
    ms_q = roofline.cuda_ms(lambda: k34.flash_bwd_q(
        q3, k3, v3, o3, do3, lse, kd_q, **kw), iters=50)
    ms_kv = roofline.cuda_ms(lambda: k34.flash_bwd_kv(
        q3, k3, v3, do3, lse, dterm, kd_kv, **kw), iters=50)
    print(json.dumps({"phase": "k34_rows", "D": d, "N": n, "Hq": hq,
                      "Hkv": hkv, "causal": causal, "rows": rows,
                      "ms_k3": ms_q, "ms_k4": ms_kv}))
    del q, k, v, do, q3, k3, v3, do3, o3, lse, dq, dterm
    torch.cuda.empty_cache()
""",
    # OpenLLaMA-3B's train step at all 26 layers (bf16 weights, AdamW, one
    # 1 x 2049 batch), K3 and K4 on the rows each tree routes D 100 to:
    # six steps on the host clock, each ended by a synchronize (the step
    # ms of chip_smoke.py's training phases), then the profiler's step
    # (wall and device ms by kernel group) on a model of its own.
    "openllama_train": """
import dataclasses, json, time
from pathlib import Path
import numpy as np
from mfa_tpu_torch.models import training
from mfa_tpu_torch.models.llama import Llama
from mfa_tpu_torch.utils import profiling
cfg = dataclasses.replace(profiling.MODELS["openllama_3b"], n_layers=26)
gen = torch.Generator(device="cuda").manual_seed(0)
model = Llama.init(cfg, generator=gen, dtype=torch.bfloat16, device="cuda",
                   trainable=True)
state = training.create_train_state(model, training.make_optimizer(
    lr=1e-3, warmup_steps=1, total_steps=100))
toks = torch.from_numpy(np.random.default_rng(0).integers(
    1, cfg.vocab_size, (1, 2049))).cuda()
step_ms = []
for _ in range(6):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    training.train_step(state, toks)
    torch.cuda.synchronize()
    step_ms.append((time.perf_counter() - t0) * 1e3)
print(json.dumps({"phase": "openllama_train_steps", "step_ms": step_ms,
                  "median_ms_2_6": sorted(step_ms[1:])[2],
                  "peak_gib": torch.cuda.max_memory_allocated() / 2**30}))
del model, state
torch.cuda.empty_cache()
out = Path("build/profiles")
out.mkdir(parents=True, exist_ok=True)
for row in profiling.profile_training(cfg, out=out):
    print(json.dumps(row))
""",
    "k2": "c.phase_k2(torch)",
    "k7": "c.phase_k7(torch)",
    "k8": "c.phase_k8(torch)",
    # K8 at decode alone through the entry point both trees have: the four
    # projections at M 4 and 16, signed and biased, F.linear on the
    # dequantized weight beside it.
    "k8d": """
import json, math
import torch.nn.functional as F
from mfa_tpu_torch.kernels import quant, quant_matmul as k8
gen = torch.Generator(device="cuda").manual_seed(8)
for k, n in c.LLAMA3_8B_PROJECTIONS:
    for layout in ("int4", "int4_biased"):
        w = torch.randn((n, k), generator=gen, device="cuda") / math.sqrt(k)
        qw = quant.quantize_weight(w, layout)
        w_deq = qw.dequantize(torch.bfloat16)
        for m in (4, 16):
            x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
            ms = roofline.cuda_ms(lambda: k8.int4_matmul(
                x, qw.w, qw.scale, layout=layout), iters=50)
            lib = roofline.cuda_ms(lambda: F.linear(x, w_deq), iters=50)
            print(json.dumps({"phase": "k8d", "layout": layout, "M": m,
                              "K": k, "N": n, "ms": ms, "library_ms": lib}))
""",
    # The profiler's INT4 phase: a 2048-token prefill and decode steps of
    # Llama-3-8B with INT4 weights, device time by kernel group.
    "int4": """
import json
from pathlib import Path
from mfa_tpu_torch.models.llama import LlamaConfig
from mfa_tpu_torch.utils import profiling
out = Path("build/profiles")
out.mkdir(parents=True, exist_ok=True)
for row in profiling.profile_int4(LlamaConfig.llama3_8b(), out=out):
    print(json.dumps(row))
""",
    "training": "c.phase_training(torch)",
    # The profiler's serving phase: prefills, then decode steps of
    # Llama-3-8B over bf16, INT8 and FP8-e4m3 caches, device time by
    # kernel group.
    "profile": """
import json
from pathlib import Path
from mfa_tpu_torch.models.llama import LlamaConfig
from mfa_tpu_torch.utils import profiling
out = Path("build/profiles")
out.mkdir(parents=True, exist_ok=True)
for row in profiling.profile_serving(LlamaConfig.llama3_8b(), out=out):
    print(json.dumps(row))
""",
    "serving": ("_, m, prompts, toks = c.phase_serving(torch); "
                "c.phase_paged_serving(torch, m, prompts, toks)"),
    "host": """
import json, math, time
from mfa_tpu_torch.kernels import decode as k5, paged_decode as k6
from mfa_tpu_torch.kernels import quant, quant_matmul as k8
from mfa_tpu_torch.utils.testing import shuffled_page_pool
gen = torch.Generator(device="cuda").manual_seed(0)
lens = [1030] * 8
ops = (*shuffled_page_pool(torch.bfloat16, lens, 8, 128, 512, 4,
                           generator=gen, device="cuda"),
       torch.tensor(lens, dtype=torch.int32, device="cuda"))
q3 = torch.randn((64, 4, 128), generator=gen, device="cuda").bfloat16()
calls = {"k6_bf16_8x1030": lambda: k6.paged_decode(q3, *ops)}
kc, vc = (torch.randn((32, 2048, 128), generator=gen, device="cuda")
          .to(torch.float8_e4m3fn) for _ in range(2))
ks, vs = (torch.rand((32, 2048), generator=gen, device="cuda")
          for _ in range(2))
q2 = torch.randn((32, 4, 128), generator=gen, device="cuda").bfloat16()
kn, vn = (torch.randn((32, 128), generator=gen, device="cuda").bfloat16()
          for _ in range(2))
lens2 = torch.tensor([1030] * 4, dtype=torch.int32, device="cuda")
calls["k2_fp8_4x8x2048"] = lambda: k5.decode_fused_append(
    q2, kc, vc, ks, vs, kn, vn, lens2, num_kv_heads=8)
for k, n in ((4096, 1024), (4096, 14336)):
    qw = quant.quantize_weight(torch.randn((n, k), generator=gen,
                                           device="cuda") / math.sqrt(k),
                               "int4")
    x = torch.randn((4, k), generator=gen, device="cuda").bfloat16()
    calls[f"k8_M4_{k}x{n}"] = (lambda x=x, qw=qw: k8.int4_matmul(
        x, qw.w, qw.scale, layout="int4"))
for name, fn in calls.items():
    for rep in range(5):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(300_000_000)
        t0 = time.perf_counter()
        for _ in range(100):
            fn()
        us = (time.perf_counter() - t0) / 100 * 1e6
        torch.cuda.synchronize()
        print(json.dumps({"phase": "host", "call": name, "rep": rep,
                          "us_per_call": us}))
""",
}


# Each tree's process first: its chip_smoke as c, and roofline.cuda_ms,
# which a tree older than utils/roofline.py has as chip_smoke.cuda_ms(torch,
# fn, ...), so that a tree can be compared with its parent.
_TURNS_PREAMBLE = """import importlib.util, sys, types, torch
sys.path.insert(0, '.')
import chip_smoke as c
if importlib.util.find_spec('mfa_tpu_torch.utils.roofline'):
    from mfa_tpu_torch.utils import roofline
else:
    roofline = types.SimpleNamespace(
        cuda_ms=lambda fn, **kw: c.cuda_ms(torch, fn, **kw))
c.phase_device(torch)
"""


# The decode sources whose kernels ``sass`` compares.
DECODE_OBJECTS = ("decode_attend.o", "paged_decode.o", "decode.o")
# A decode kernel's name and template arguments in its mangled name (the
# kernels sit in an anonymous namespace, whose mangling differs by tree).
_DECODE_KERNEL = re.compile(r"(decode_[a-z_]+?)I(.*)")
_DECODE_ARG = re.compile(r"L[ib]\d+E|ContiguousRows|FusedRows|PagedRows")


def _decode_key(name: str) -> str:
    m = _DECODE_KERNEL.search(name)
    if m is None:
        return name
    return f"{m.group(1)}<{','.join(_DECODE_ARG.findall(m.group(2)))}>"


def _decode_sass(tree: Path) -> dict:
    """{(object, kernel's mangled name): SASS lines, labels renumbered}
    of every kernel in ``tree``'s build of the decode sources (built
    first, in a process of its own)."""
    from mfa_tpu_torch.kernels import build
    from mfa_tpu_torch.utils.bwd_tuning import _renumber_labels

    subprocess.run([sys.executable, "-c", "from mfa_tpu_torch.kernels "
                    "import build; build.library()"], cwd=tree, check=True)
    cuobjdump = shutil.which("cuobjdump") or str(
        Path(build._nvcc()).with_name("cuobjdump"))
    funcs = {}
    for name in DECODE_OBJECTS:
        obj = tree / "build" / "mfa_tpu_torch" / name
        text = subprocess.run([cuobjdump, "-sass", str(obj)], check=True,
                              capture_output=True, text=True).stdout
        key = None
        for line in text.splitlines():
            if "Function : " in line:
                key = (name, _decode_key(line.split("Function : ")[1]))
                funcs[key] = []
            elif key is not None and line.strip():
                funcs[key].append(line.strip())
    return {k: _renumber_labels(v) for k, v in funcs.items()}


def compare_sass(a: Path, b: Path) -> bool:
    """Whether every kernel of tree a's decode sources has the same
    instructions in tree b (one JSON line a kernel that differs or is
    missing, then the counts and the kernels only b has)."""
    fa, fb = _decode_sass(a), _decode_sass(b)
    same = 0
    for key in sorted(fa):
        got = fb.get(key)
        same += got == fa[key]
        if got != fa[key]:
            diff = [(x, y) for x, y in zip(fa[key], got or ()) if x != y]
            print(json.dumps({"object": key[0], "kernel": key[1],
                              "in_b": got is not None,
                              "lines_a": len(fa[key]),
                              "lines_b": len(got or ()),
                              "lines_differing": len(diff),
                              "first_differing": diff[:2]}), flush=True)
    print(json.dumps({"kernels_a": len(fa), "same": same,
                      "kernels_b": len(fb),
                      "only_b": sorted(k[1] for k in set(fb) - set(fa))}),
          flush=True)
    return same == len(fa)


def turns(a: Path, b: Path, what: str) -> None:
    """One of _TURNS from tree a, b, b, a, each in a process of its own."""
    code = _TURNS_PREAMBLE + _TURNS[what]
    for label, tree in (("A", a), ("B", b), ("B", b), ("A", a)):
        run = subprocess.run([sys.executable, "-c", code], cwd=tree,
                             capture_output=True, text=True, timeout=1200)
        for line in run.stdout.splitlines():
            print(f"{label} {line}", flush=True)
        if run.returncode != 0:
            raise SystemExit(f"tree {tree} failed:\n{run.stderr[-4000:]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("sweep", "kernels", "turns",
                                     "rounding", "sass"))
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--wide", action="store_true",
                    help="sweep: K2, K5 and K6 past D 256")
    ap.add_argument("--a", default="build/parent",
                    help="turns: the first tree (e.g. the parent commit)")
    ap.add_argument("--b", default=".", help="turns: the second tree")
    ap.add_argument("--what", default="kernels", choices=tuple(_TURNS),
                    help="turns: what each tree runs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_tuning needs a CUDA device")
    if args.mode == "sweep":
        sweep(Path(args.out), args.wide)
    elif args.mode == "kernels":
        kernels()
    elif args.mode == "rounding":
        for row in rounding():
            print(json.dumps(row), flush=True)
    elif args.mode == "sass":
        return 0 if compare_sass(Path(args.a).resolve(),
                                 Path(args.b).resolve()) else 1
    else:
        turns(Path(args.a), Path(args.b), args.what)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
