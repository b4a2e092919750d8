"""Tile sweep of the flash kernels (K1 ``flash_fwd``, K3 ``flash_bwd_q``,
K4 ``flash_bwd_kv``) and of the matrix-product kernels (K7 ``gemm``, K8
``int4_matmul``) on one GPU.

``sweep`` runs each candidate parameter row at ``chip_smoke.py``'s
shapes (N = 2048, Hq 32, Hkv 8, bf16) for D = 128 and D = 64: K1 causal
and non-causal, each wgmma candidate a (block_kv, ring tiles, ping-pong)
triple (``params.FWD_RING_STAGES`` and ``params.FWD_PINGPONG`` set for
the run); K3 and K4 causal. Then the rows past D = 256 of K1, K3 and
K4, causal and non-causal: the D-blocked first cut's two candidates a
table, the mma rows at D <= 256 and the head-dim-split kernels
(:data:`DBLK_ROWS`; K1's one-CTA ones in each launch variant of
:data:`K1_SPLIT_VARIANTS`), at the shapes of ``chip_smoke.py``'s
``large_d`` phase and at D 192 and 256 (:data:`DBLK_SHAPES`; ``--only
dblk`` runs these alone, ``--only fwd`` runs K1's). Then K1, K3 and K4
where TMA cannot map a row (:func:`sweep_copy`, ``--only copy`` alone):
their copying producers' ring depths at OpenLLaMA-3B's D 100 and at D
250, each beside the mma.sync row it replaces (K3's and K4's depths are
compile-time: each other depth runs on a library whose
``csrc/flash_bwd.cu`` is built again with it). Each row is
first held to its plain version at ``KERNEL_BUDGETS`` (and the
D-blocked ones to a second run, bit for bit), then timed
(CUDA events, launches queued behind a device spin). One JSON line per
row; the mma.sync row of each head dim is timed beside the wgmma
candidates. Two trees are compared in turns by ``python -m
mfa_tpu_torch.utils.decode_tuning turns --what k1`` (or ``bwd``,
``training``).

``sweep --only matmul`` runs K7's wgmma tiles (128 x 256 and 128 x 128)
at each ring depth that fits and tile-walk bands of 1, 4, 8 and 16 tile
rows, bf16 at 4096^3, at 1536^3 in the four transpose states and at
three shapes that one round of 128 x 128 tiles covers, beside the
mma.sync tile; and K8's wgmma tiles (128 channels at ring depths 2-4,
256 at 2-3, the same bands) at M = 17-2048 on 4096 -> 14336, 4096 and
1024, both layouts, each line naming the tile the rule picks. Each
candidate is first held to its plain version at ``KERNEL_BUDGETS``.

``sweep --only qmm_decode`` runs K8's split-K decode tiles at Llama-3-8B's
four projections (4096 -> 4096, 1024, 14336 and 14336 -> 4096), M = 4
and 16, both layouts, for ring depths 2-4 and split rules aiming at 2, 4
and 8 CTAs an SM (``params.QMM_SPLIT_CTAS_PER_SM``), each held to its
plain version first.

``curve`` runs ``chip_smoke.py``'s six training steps (Llama-3-8B
widths at 16 layers, random bf16 weights from seed 4, one 1 x 2049
batch, AdamW at lr 1e-3) with none, K1, K3 and K4, or all three of the
flash kernels swapped for their plain versions, and prints each run's
losses and grad norms: how far the loss curve moves with the attention
kernels' last bits.

``sass --a TREE --b TREE`` compares the machine code (``cuobjdump
-sass``) of K3's and K4's wgmma and head-dim-split TMA instances in two
trees' builds of ``csrc/flash_bwd.cu`` (each built first), the
instances of one tree named as the other's (a producer template argument
of 0, TMA, dropped), and prints for each whether its instructions are
the same.

Run on a GPU from the repository root:

    python -m mfa_tpu_torch.utils.bwd_tuning sweep \
        [--only fwd|copy|bwd|dblk|matmul|qmm_decode]
    python -m mfa_tpu_torch.utils.bwd_tuning curve [--plain none k1 k34 k1,k34]
    python -m mfa_tpu_torch.utils.bwd_tuning sass --a build/parent --b .
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from mfa_tpu_torch.kernels import build
from mfa_tpu_torch.kernels import flash_bwd as k34
from mfa_tpu_torch.kernels import flash_fwd as k1
from mfa_tpu_torch.kernels import gemm_kernel as k7
from mfa_tpu_torch.kernels import quant
from mfa_tpu_torch.kernels import quant_matmul as k8
from mfa_tpu_torch.ops import params
from mfa_tpu_torch.ops.params import (
    DBLK_ROWS,
    K1_ROWS,
    K3_ROWS,
    K4_ROWS,
    panel_range,
)
from mfa_tpu_torch.ops.descriptors import (
    AttentionDescriptor,
    AttentionKernelType,
    GEMMDescriptor,
    launch_row,
    row_label,
)
from mfa_tpu_torch.ops.precision import OperandPrecision
from mfa_tpu_torch.utils import roofline
from mfa_tpu_torch.utils.testing import KERNEL_BUDGETS, budget_share

# The candidate rows (K1_ROWS, K3_ROWS, K4_ROWS, DBLK_ROWS, panel_range)
# live in ops/params.py, where the autotune of utils/autotune.py reads
# them too.
# (input type, D, N) at B 1, H 8: the JAX package's large-D class (bf16,
# N 4096, D 384 and 512), head dims TMA cannot map (the bf16_mma table's
# 384 and inf rows) and fp32, at chip_smoke.py's large_d sizes; and D
# 256 and 192 at N 4096, where the candidates are the mma rows and the
# one-CTA and two-CTA rows of K1, K3 and K4.
DBLK_SHAPES = (("bf16", 384, 4096), ("bf16", 512, 4096),
               ("bf16", 300, 1024), ("bf16", 500, 1024),
               ("fp32", 384, 1024), ("fp32", 512, 1024),
               ("bf16", 256, 4096), ("bf16", 192, 4096))


# K1's one-CTA candidates past D = 128 are each timed in these launch
# variants, (name, most tiles a ring, ping-pong, K ring deeper): the
# rule (params.fwd_rings, FWD_RING_STAGES = 3: the V ring takes the odd
# tile), rings of two tiles each (the four tiles a ring of paired K and V
# stages held at D 256), up to four tiles a ring, the odd tile given to
# the K ring, and no ping-pong.
K1_SPLIT_VARIANTS = (("rule", 3, True, False), ("rings2", 2, True, False),
                     ("rings4", 4, True, False), ("k_deeper", 3, True, True),
                     ("no_pingpong", 3, False, False))


# K1, K3 and K4 where TMA cannot map a row, (D, N, Hq, Hkv, causal):
# OpenLLaMA-3B's attention (head dim 100, 32 heads, MHA) at its prefill
# buckets 2048 (causal and not) and 512, and D 250 at chip_smoke.py's
# large_d tail (B 1, H 8, N 1024). Their candidates, the most tiles a
# ring of the wgmma kernels with the cp.async producer on the table's
# rows (K1: block_kv 128 on the 128-wide panel at D 100, 64 on the
# 256-wide one at D 250), each beside the mma.sync row it replaces: the
# ring depths tried a kernel, with the params constant each sets. (K1's
# block_kv 64 at D 100, 32 at D 250, and a producer of 1-D bulk copies
# repacked lost here and were dropped: ops/params.py.)
COPY_SHAPES = ((100, 2048, 32, 32, True), (100, 2048, 32, 32, False),
               (100, 512, 32, 32, True), (250, 1024, 8, 8, True),
               (250, 1024, 8, 8, False))
COPY_RING_STAGES = {"flash_fwd": ("FWD_COPY_RING_STAGES", (2, 3)),
                    "flash_bwd_q": ("BWD_Q_COPY_RING_STAGES", (2, 3, 4)),
                    "flash_bwd_kv": ("BWD_KV_COPY_RING_STAGES", (2, 3, 4))}
# The csrc/flash_bwd.cu macros that set K3's and K4's copying depths at
# compile time (K1's is read at each launch).
COPY_DEPTH_MACROS = {"flash_bwd_q": "MFA_BWD_Q_COPY_STAGES",
                     "flash_bwd_kv": "MFA_BWD_KV_COPY_STAGES"}


def dblk_candidates(name: str, dt: str, d: int, table_row) -> list:
    """The candidates of kernel ``name`` at head dim ``d``: past D = 256
    every D-blocked one; the head-dim-split kernels where their CTAs
    cover D (:func:`panel_range`), TMA maps a row and D > 128; at D <= 256
    the mma row; else the table's row ``table_row``."""
    cands = []
    for bq, bkv, bd, kernel in DBLK_ROWS[name][dt]:
        panels = -(-d // bd)
        if kernel == "wgmma_dblk":
            least, most = panel_range(name, bd, bkv)
            ok = d % 8 == 0 and d > 128 and least <= panels <= most
        elif kernel == "mma":
            ok = d <= bd
        else:
            ok = d > 256
        if ok:
            cands.append((bq, bkv, bd, kernel))
    if not cands:
        cands.append((table_row.block_q, table_row.block_kv,
                      table_row.block_d, table_row.kernel))
    return cands


def _inputs(d: int, n: int = 2048, hq: int = 32, hkv: int = 8,
            causal: bool = True, dtype: torch.dtype = torch.bfloat16):
    gen = torch.Generator(device="cuda").manual_seed(3)

    def rnd(h):
        return torch.randn((h, n, d), generator=gen, device="cuda").to(dtype)

    q, k, v, do = rnd(hq), rnd(hkv), rnd(hkv), rnd(hq)
    low = dtype == torch.bfloat16
    desc = AttentionDescriptor(
        batch=1, num_q_heads=hq, num_kv_heads=hkv, seq_len_q=n, seq_len_kv=n,
        head_dim=d, causal=causal, low_precision_inputs=low,
        low_precision_intermediates=low)
    kd_f, kd_q, kd_kv = (desc.kernel_descriptor(t)
                         for t in AttentionKernelType)
    kw = dict(group=hq // hkv, scale=desc.softmax_scale)
    o, lse = k1.flash_fwd(q, k, v, kd_f, o_dtype=dtype, **kw)
    return (q, k, v, o, do, lse), kd_q, kd_kv, kw, kd_f


def sweep_dblk(kernels) -> None:
    """The candidates of ``kernels`` (names of DBLK_ROWS) past D = 256 and
    at D = 256 (:func:`dblk_candidates`) at DBLK_SHAPES, causal and
    non-causal: each held to its plain version and to a second run, bit
    for bit, then timed."""
    for dt, d, n in DBLK_SHAPES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        for causal in (True, False):
            (q, k, v, o, do, lse), kd_q, kd_kv, kw, kd_f = _inputs(
                d, n, 8, 8, causal, dtype)
            base = {"flash_fwd": kd_f, "flash_bwd_q": kd_q,
                    "flash_bwd_kv": kd_kv}
            dterm = k34.flash_bwd_q(q, k, v, o, do, lse, kd_q, **kw)[1]
            for name in kernels:
                if name == "flash_fwd":
                    run = lambda kd: k1.flash_fwd(  # noqa: E731
                        q, k, v, kd, o_dtype=dtype, **kw)
                    want = k1.flash_fwd_plain(q, k, v, kd_f, o_dtype=dtype,
                                              **kw)
                    keys = (f"flash_fwd_o_{dt}", "flash_fwd_l")
                elif name == "flash_bwd_q":
                    run = lambda kd: k34.flash_bwd_q(  # noqa: E731
                        q, k, v, o, do, lse, kd, **kw)
                    want = k34.flash_bwd_q_plain(q, k, v, o, do, lse, kd_q,
                                                 **kw)
                    keys = (f"flash_bwd_dq_{dt}", "flash_bwd_dterm")
                else:
                    run = lambda kd: k34.flash_bwd_kv(  # noqa: E731
                        q, k, v, do, lse, dterm, kd, **kw)
                    want = k34.flash_bwd_kv_plain(q, k, v, do, lse, dterm,
                                                  kd_kv, **kw)
                    keys = (f"flash_bwd_dk_{dt}", f"flash_bwd_dv_{dt}")
                for bq, bkv, bd, kernel in dblk_candidates(
                        name, dt, d, base[name]):
                    kd = dataclasses.replace(base[name], block_q=bq,
                                             block_kv=bkv, block_d=bd,
                                             kernel=kernel)
                    one_cta = (name == "flash_fwd" and kernel == "wgmma_dblk"
                               and d <= bd)
                    for variant in (K1_SPLIT_VARIANTS if one_cta
                                    else (None,)):
                        with _k1_launch(variant):
                            got, again = run(kd), run(kd)
                            ms = roofline.cuda_ms(lambda: run(kd), iters=10)
                            rings = (params.fwd_rings(params.ParameterRow(
                                d, bq, bkv, bd, kernel)) if one_cta
                                else None)
                        same = all(torch.equal(a, b)
                                   for a, b in zip(got, again))
                        shares = {key: budget_share(g, w,
                                                    *KERNEL_BUDGETS[key])
                                  for key, g, w in zip(keys, got, want)}
                        print(json.dumps({
                            "kernel": name, "dtype": dt, "D": d, "N": n,
                            "causal": causal, "block_q": bq,
                            "block_kv": bkv, "block_d": bd,
                            "row_kernel": kd.kernel,
                            "variant": variant and variant[0],
                            "rings": rings, "share": shares,
                            "deterministic": same, "ms": ms}), flush=True)
                        if max(shares.values()) > 1 or not same:
                            raise SystemExit(
                                f"{name} row {bq}/{bkv}/{bd} {variant} at "
                                f"{dt} D={d}: shares {shares}, "
                                f"deterministic {same}")
                        del got, again
                del want
            del q, k, v, o, do, lse, dterm
            torch.cuda.empty_cache()


def _k1_launch(variant) -> contextlib.ExitStack:
    """K1's launch in one of K1_SPLIT_VARIANTS (None: as it stands), as a
    context that restores the module's settings."""
    stack = contextlib.ExitStack()
    if variant is None:
        return stack
    _, most, pingpong, k_deeper = variant
    rule = params.fwd_rings
    stack.enter_context(mock.patch.object(params, "FWD_RING_STAGES", most))
    stack.enter_context(mock.patch.object(params, "FWD_PINGPONG", pingpong))
    if k_deeper:
        stack.enter_context(mock.patch.object(
            params, "fwd_rings", lambda row: tuple(reversed(rule(row)))))
    return stack


def _shares(got, want, keys):
    return {key: budget_share(g, w, *KERNEL_BUDGETS[f"flash_bwd_{key}"])
            for key, g, w in zip(keys, got, want)}


def sweep_fwd() -> None:
    rule = (params.FWD_RING_STAGES, params.FWD_PINGPONG)
    for d in (128, 64):
        for causal in (True, False):
            (q, k, v, _, _, _), _, _, kw, _ = _inputs(d)
            desc = AttentionDescriptor(
                batch=1, num_q_heads=32, num_kv_heads=8, seq_len_q=2048,
                seq_len_kv=2048, head_dim=d, causal=causal,
                low_precision_inputs=True, low_precision_intermediates=True)
            kd_f = desc.kernel_descriptor(AttentionKernelType.FORWARD)
            kw = dict(kw, o_dtype=torch.bfloat16)
            o_p, l_p = k1.flash_fwd_plain(q, k, v, kd_f, **kw)
            cands = [(bkv, most, pp, "wgmma", 128)
                     for bkv, most, pp in K1_ROWS]
            cands.append((64, *rule, "mma", 64))
            for bkv, most, pp, kernel, bq in cands:
                params.FWD_RING_STAGES, params.FWD_PINGPONG = most, pp
                kd = dataclasses.replace(kd_f, block_q=bq, block_kv=bkv,
                                         kernel=kernel)
                o, lse = k1.flash_fwd(q, k, v, kd, **kw)
                shares = {
                    "o": budget_share(o, o_p,
                                      *KERNEL_BUDGETS["flash_fwd_o_bf16"]),
                    "l": budget_share(lse, l_p,
                                      *KERNEL_BUDGETS["flash_fwd_l"])}
                ms = roofline.cuda_ms(
                    lambda: k1.flash_fwd(q, k, v, kd, **kw), iters=50)
                row = params.ParameterRow(d, bq, bkv, d, kernel)
                print(json.dumps({
                    "kernel": "flash_fwd", "D": d, "causal": causal,
                    "block_q": bq, "block_kv": bkv, "row_kernel": kernel,
                    "rings": (params.fwd_rings(row)
                              if kernel == "wgmma" else None),
                    "pingpong": pp if kernel == "wgmma" else None,
                    "share": shares, "ms": ms}), flush=True)
                params.FWD_RING_STAGES, params.FWD_PINGPONG = rule
                if max(shares.values()) > 1:
                    raise SystemExit(f"K1 row {bkv}/{most}/{pp}/{kernel} at "
                                     f"D={d}: shares {shares}")
            del q, k, v, o_p, l_p, o, lse
            torch.cuda.empty_cache()
    sweep_dblk(("flash_fwd",))


def copy_depth_libraries() -> dict:
    """{(kernel, depth): library} for K3's and K4's copying depths of
    COPY_RING_STAGES other than the source's: csrc/flash_bwd.cu built
    again at -D<COPY_DEPTH_MACROS>=depth (one nvcc a depth, all started
    together) into a folder of its own under the build, keyed by the
    sources' digest, and linked with the default build's other objects."""
    build.library()   # the default build, whose objects are linked
    objs = [build.BUILD_DIR / (src.stem + ".o") for src in build._sources()]
    todo, procs, digest = {}, [], build._digest()
    for name, macro in COPY_DEPTH_MACROS.items():
        attr, depths = COPY_RING_STAGES[name]
        for depth in depths:
            if depth == getattr(params, attr):
                continue
            out = build.BUILD_DIR / f"{macro.lower()}_{depth}_{digest}"
            out.mkdir(parents=True, exist_ok=True)
            todo[name, depth] = out / build.LIB_NAME
            if todo[name, depth].exists():
                continue
            cmd = [build._nvcc(), *build.NVCC_FLAGS, f"-D{macro}={depth}",
                   "-c", str(build.CSRC / "flash_bwd.cu"), "-o",
                   str(out / "flash_bwd.o")]
            procs.append((out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    for out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {out.name}:\n{log}")
        link = subprocess.run(
            [build._nvcc(), "-shared", "-o", str(out / build.LIB_NAME),
             *(str(out / o.name if o.name == "flash_bwd.o" else o)
               for o in objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise SystemExit(f"link failed for {out.name}:\n{link.stdout}")
    return {key: build.KernelLibrary(ctypes.CDLL(str(path)), path, 0.0, "")
            for key, path in todo.items()}


def sweep_copy() -> None:
    """K1's, K3's and K4's copying producers at each depth of
    COPY_RING_STAGES at COPY_SHAPES beside the mma.sync row: each
    candidate's launch row checked, held to the plain version at
    KERNEL_BUDGETS and to a second launch bit for bit, then timed."""
    libs = copy_depth_libraries()
    for d, n, hq, hkv, causal in COPY_SHAPES:
        (q, k, v, o, do, lse), kd_q, kd_kv, kw, kd_f = _inputs(d, n, hq, hkv,
                                                              causal)
        kw_f = dict(kw, o_dtype=torch.bfloat16)
        want_q = k34.flash_bwd_q_plain(q, k, v, o, do, lse, kd_q, **kw)
        dterm = want_q[1]
        kernels = (
            ("flash_fwd", kd_f, (q, k, v),
             lambda kd: k1.flash_fwd(q, k, v, kd, **kw_f),
             k1.flash_fwd_plain(q, k, v, kd_f, **kw_f),
             ("flash_fwd_o_bf16", "flash_fwd_l")),
            ("flash_bwd_q", kd_q, (q, k, v, do),
             lambda kd: k34.flash_bwd_q(q, k, v, o, do, lse, kd, **kw),
             want_q, ("flash_bwd_dq_bf16", "flash_bwd_dterm")),
            ("flash_bwd_kv", kd_kv, (q, k, v, do),
             lambda kd: k34.flash_bwd_kv(q, k, v, do, lse, dterm, kd, **kw),
             k34.flash_bwd_kv_plain(q, k, v, do, lse, dterm, kd_kv, **kw),
             ("flash_bwd_dk_bf16", "flash_bwd_dv_bf16")))
        for name, kd_t, tensors, run, want, keys in kernels:
            _copy_candidates(name, kd_t, d, dict(N=n, Hq=hq, Hkv=hkv,
                                                 causal=causal),
                             tensors, run, want, keys, libs)
        del q, k, v, o, do, lse, dterm, want_q
        torch.cuda.empty_cache()


def _copy_candidates(name, kd_t, d, shape, tensors, run, want, keys, libs):
    """Kernel ``name``'s copying producer at each ring depth of
    COPY_RING_STAGES (a depth the shared memory caps to one already run is
    skipped; K3's and K4's on ``libs``' build of it), then the mma.sync
    row of its head dim."""
    attr, depths = COPY_RING_STAGES[name]
    mma = params.select_row(params.parameter_table(name, "bf16_mma"), d)
    cands = [(most, "copy", kd_t) for most in depths]
    cands.append((getattr(params, attr), "", dataclasses.replace(
        kd_t, block_q=mma.block_q, block_kv=mma.block_kv,
        block_d=mma.block_d, kernel=mma.kernel)))
    seen = set()
    for most, prod, kd in cands:
        lib = libs.get((name, most)) if prod else None
        with mock.patch.object(params, attr, most), (
                mock.patch.object(build, "_library", lib) if lib
                else contextlib.nullcontext()):
            row = launch_row(kd, d, tensors)
            rings = (None if not row.producer else params.fwd_rings(row)
                     if name == "flash_fwd"
                     else params.bwd_copy_stages(name, row))
            if row.producer and rings in seen:
                continue
            seen.add(rings)
            got, again = run(kd), run(kd)
            ms = roofline.cuda_ms(lambda: run(kd), iters=20)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        shares = {key: budget_share(g, w, *KERNEL_BUDGETS[key])
                  for key, g, w in zip(keys, got, want)}
        print(json.dumps({
            "kernel": name, "D": d, **shape, "block_q": kd.block_q,
            "block_kv": kd.block_kv, "row": row_label(row), "rings": rings,
            "share": shares, "deterministic": same, "ms": ms}), flush=True)
        if max(shares.values()) > 1 or not same or row.producer != prod:
            raise SystemExit(f"{name} {row_label(row)} {kd.block_kv}/{most} "
                             f"at D {d}: shares {shares}, deterministic "
                             f"{same}, wanted producer {prod!r}")
        del got, again


def sweep_bwd() -> None:
    for d in (128, 64):
        (q, k, v, o, do, lse), kd_q, kd_kv, kw, _ = _inputs(d)
        dq_p, dterm = k34.flash_bwd_q_plain(q, k, v, o, do, lse, kd_q, **kw)
        dk_p, dv_p = k34.flash_bwd_kv_plain(q, k, v, do, lse, dterm, kd_kv,
                                            **kw)
        for bq, bkv, kernel in K3_ROWS:
            kd = dataclasses.replace(kd_q, block_q=bq, block_kv=bkv,
                                     kernel=kernel)
            dq, dt = k34.flash_bwd_q(q, k, v, o, do, lse, kd, **kw)
            dq2, dt2 = k34.flash_bwd_q(q, k, v, o, do, lse, kd, **kw)
            same = bool(torch.equal(dq, dq2) and torch.equal(dt, dt2))
            shares = _shares((dq, dt), (dq_p, dterm), ("dq_bf16", "dterm"))
            ms = roofline.cuda_ms(lambda: k34.flash_bwd_q(
                q, k, v, o, do, lse, kd, **kw), iters=50)
            print(json.dumps({"kernel": "flash_bwd_q", "D": d, "block_q": bq,
                              "block_kv": bkv, "row_kernel": kernel,
                              "share": shares, "deterministic": same,
                              "ms": ms}), flush=True)
            if max(shares.values()) > 1 or not same:
                raise SystemExit(f"K3 row {bq}/{bkv}/{kernel} at D={d}: "
                                 f"shares {shares}, deterministic {same}")
        for bq, bkv, kernel in K4_ROWS:
            kd = dataclasses.replace(kd_kv, block_q=bq, block_kv=bkv,
                                     kernel=kernel)
            dk, dv = k34.flash_bwd_kv(q, k, v, do, lse, dterm, kd, **kw)
            dk2, dv2 = k34.flash_bwd_kv(q, k, v, do, lse, dterm, kd, **kw)
            same = bool(torch.equal(dk, dk2) and torch.equal(dv, dv2))
            shares = _shares((dk, dv), (dk_p, dv_p), ("dk_bf16", "dv_bf16"))
            ms = roofline.cuda_ms(lambda: k34.flash_bwd_kv(
                q, k, v, do, lse, dterm, kd, **kw), iters=50)
            print(json.dumps({"kernel": "flash_bwd_kv", "D": d,
                              "block_q": bq, "block_kv": bkv,
                              "row_kernel": kernel, "share": shares,
                              "deterministic": same, "ms": ms}), flush=True)
            if max(shares.values()) > 1 or not same:
                raise SystemExit(f"K4 row {bq}/{bkv}/{kernel} at D={d}: "
                                 f"shares {shares}, deterministic {same}")
        del q, k, v, o, do, lse, dq_p, dterm, dk_p, dv_p
        torch.cuda.empty_cache()
    sweep_dblk(("flash_bwd_q", "flash_bwd_kv"))


# K7's and K8's wgmma candidates (tile, ring stages); the tile-walk bands
# tried for both.
K7_ROWS = (("w256", 4), ("w256", 3), ("w128", 7), ("w128", 6), ("w128", 4))
K8_ROWS = (("w256", 3), ("w256", 2), ("w128", 4), ("w128", 3), ("w128", 2))
GROUPS = params.GEMM_TILE_GROUPS


def _k7_cases():
    """chip_smoke's bf16 4096^3 and 1536^3 cases, and three shapes that one
    round of 128 x 128 tiles covers: a projection of a 2048-token prefill
    (4096 -> 1024, B stored [N, K]), 512 x 512 x 4096 and the card tests'
    1000 x 1032 x 1048."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = [(4096, 4096, 4096, False, False)]
    cases += [(1536, 1536, 1536, ta, tb) for ta in (False, True)
              for tb in (False, True)]
    cases += [(2048, 1024, 4096, False, True), (512, 512, 4096, False, False),
              (1000, 1032, 1048, False, False)]
    for m, n, k, ta, tb in cases:
        a = torch.randn((1, k, m) if ta else (1, m, k), generator=gen,
                        device="cuda").bfloat16()
        b = torch.randn((1, n, k) if tb else (1, k, n), generator=gen,
                        device="cuda").bfloat16()
        yield (f"bf16_{m}x{n}x{k}_{'T' if ta else 'N'}{'T' if tb else 'N'}",
               a, b, GEMMDescriptor(
                   m=m, n=n, k=k, a_precision=OperandPrecision.BF16,
                   b_precision=OperandPrecision.BF16,
                   c_precision=OperandPrecision.BF16, transpose_a=ta,
                   transpose_b=tb).kernel_descriptor())


def sweep_matmul() -> None:
    group = params.GEMM_TILE_GROUP
    budget = KERNEL_BUDGETS["gemm_bf16"]
    for name, a, b, kd in _k7_cases():
        want = k7.gemm_kernel_plain(a, b, None, kd, out_dtype=torch.bfloat16)
        cands = [(params.GEMM_TILES[t], s_, g) for t, s_ in K7_ROWS
                 for g in GROUPS]
        cands.append((kd.mma_tile, kd.mma_tile.stages, group))
        for tile, stages, g in cands:
            kd_c = dataclasses.replace(
                kd, tile=dataclasses.replace(tile, stages=stages))
            params.GEMM_TILE_GROUP = g
            run = lambda: k7.gemm_kernel(a, b, None, kd_c,  # noqa: E731
                                         out_dtype=torch.bfloat16)
            share = budget_share(run(), want, *budget)
            row = {"kernel": "gemm", "case": name, "tile": tile.name,
                   "stages": stages, "group": g, "share": share,
                   "ms": roofline.cuda_ms(run, iters=20)}
            print(json.dumps(row), flush=True)
            params.GEMM_TILE_GROUP = group
            if share > 1:
                raise SystemExit(f"K7 candidate {row} misses its budget")
        del a, b, want
        torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(8)
    rule_tile = k8.int4_tile
    for k, n in ((4096, 14336), (4096, 4096), (4096, 1024)):
        for layout in ("int4", "int4_biased"):
            w = torch.randn((n, k), generator=gen, device="cuda") / k ** 0.5
            qw = quant.quantize_weight(w, layout)
            bkey = "biased" if layout == "int4_biased" else "signed"
            for m in (17, 100, 512, 1000, 2048):
                x = torch.randn((m, k), generator=gen,
                                device="cuda").bfloat16()
                want = k8.int4_matmul_plain(x, qw.w, qw.scale, layout=layout)
                for name, stages in K8_ROWS:
                    tile = dataclasses.replace(params.QMM_TILES[name],
                                               stages=stages)
                    for g in GROUPS:
                        k8.int4_tile = lambda *a, _t=tile: _t
                        params.GEMM_TILE_GROUP = g
                        run = lambda: k8.int4_matmul(  # noqa: E731
                            x, qw.w, qw.scale, layout=layout)
                        share = budget_share(run(), want, *KERNEL_BUDGETS[
                            f"int4_matmul_{bkey}"])
                        row = {"kernel": "int4_matmul", "layout": layout,
                               "M": m, "K": k, "N": n, "tile": name,
                               "stages": stages, "group": g, "share": share,
                               "rule": rule_tile(m, n, torch.bfloat16).name,
                               "ms": roofline.cuda_ms(run, iters=20)}
                        print(json.dumps(row), flush=True)
                        k8.int4_tile = rule_tile
                        params.GEMM_TILE_GROUP = group
                        if share > 1:
                            raise SystemExit(f"K8 candidate {row} misses "
                                             f"its budget")
            del w, qw
            torch.cuda.empty_cache()


# K8's decode tiles: ring depths and the split rule's CTAs an SM.
QMM_DECODE_STAGES = (2, 3, 4)
QMM_DECODE_CTAS = (2, 4, 8)


def sweep_qmm_decode() -> None:
    tiles, ctas = dict(params.QMM_TILES), params.QMM_SPLIT_CTAS_PER_SM
    gen = torch.Generator(device="cuda").manual_seed(8)
    for k, n in ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)):
        for layout in ("int4", "int4_biased"):
            w = torch.randn((n, k), generator=gen, device="cuda") / k ** 0.5
            qw = quant.quantize_weight(w, layout)
            bkey = "biased" if layout == "int4_biased" else "signed"
            for m in (4, 16):
                x = torch.randn((m, k), generator=gen,
                                device="cuda").bfloat16()
                want = k8.int4_matmul_plain(x, qw.w, qw.scale, layout=layout)
                for stages in QMM_DECODE_STAGES:
                    for c in QMM_DECODE_CTAS:
                        for name in ("d8", "d16"):
                            params.QMM_TILES[name] = dataclasses.replace(
                                tiles[name], stages=stages)
                        params.QMM_SPLIT_CTAS_PER_SM = c
                        tile = k8.int4_tile(m, n, torch.bfloat16)
                        run = lambda: k8.int4_matmul(  # noqa: E731
                            x, qw.w, qw.scale, layout=layout)
                        share = budget_share(run(), want, *KERNEL_BUDGETS[
                            f"int4_matmul_{bkey}"])
                        row = {"kernel": "int4_matmul_decode",
                               "layout": layout, "M": m, "K": k, "N": n,
                               "tile": tile.name, "stages": stages,
                               "ctas_per_sm": c,
                               "split_cols": params.qmm_split_cols(n, k,
                                                                   tile),
                               "rule": (stages == tiles[tile.name].stages
                                        and c == ctas),
                               "share": share,
                               "ms": roofline.cuda_ms(run, iters=50)}
                        print(json.dumps(row), flush=True)
                        params.QMM_TILES.update(tiles)
                        params.QMM_SPLIT_CTAS_PER_SM = ctas
                        if share > 1:
                            raise SystemExit(f"K8 decode candidate {row} "
                                             f"misses its budget")
            del w, qw
            torch.cuda.empty_cache()


def curve(plain: list[str], steps: int = 6) -> None:
    from mfa_tpu_torch.models import llama, training
    from mfa_tpu_torch.utils.data import TokenDataset

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), n_layers=16)
    stream = np.random.default_rng(4).integers(0, cfg.vocab_size, 2049)
    tokens = torch.from_numpy(next(TokenDataset(
        stream, seq_len=2048, batch_size=1, seed=4).epoch(0))).long().cuda()
    swaps = {"k1": [(k1, "flash_fwd", k1.flash_fwd_plain)],
             "k34": [(k34, "flash_bwd_q", k34.flash_bwd_q_plain),
                     (k34, "flash_bwd_kv", k34.flash_bwd_kv_plain)]}
    for which in plain:
        chosen = [s_ for key in which.split(",") if key != "none"
                  for s_ in swaps[key]]
        real = [getattr(mod, attr) for mod, attr, _ in chosen]
        for mod, attr, fn in chosen:
            setattr(mod, attr, fn)
        model = llama.Llama.init(
            cfg, generator=torch.Generator(device="cuda").manual_seed(4),
            dtype=torch.bfloat16, device="cuda", trainable=True)
        state = training.create_train_state(
            model, training.make_optimizer(lr=1e-3, warmup_steps=1,
                                           total_steps=100))
        losses, norms = [], []
        for _ in range(steps):
            metrics = training.train_step(state, tokens)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
        print(json.dumps({"plain": which, "losses": losses,
                          "grad_norms": norms}), flush=True)
        for (mod, attr, _), fn in zip(chosen, real):
            setattr(mod, attr, fn)
        del state, model
        torch.cuda.empty_cache()


# K3's and K4's wgmma kernels and their template arguments in a mangled
# name (the kernels sit in an anonymous namespace, whose mangling differs
# by file), and how many of those arguments a tree without the producer
# argument gives each.
_K34_WGMMA = re.compile(r"flash_bwd_(q|kv)_(wgmma|split)I((?:L[ib]\d+E)+)")
_ARGS_BEFORE_PROD = {"wgmma": 2, "split": 3}


def _sass_key(name: str):
    """A K3 or K4 wgmma kernel's name and template arguments, its TMA
    producer argument (0) dropped; None for other kernels."""
    m = _K34_WGMMA.search(name)
    if m is None:
        return None
    args = re.findall(r"L[ib]\d+E", m.group(3))
    if len(args) > _ARGS_BEFORE_PROD[m.group(2)] and args[-1] == "Li0E":
        args = args[:-1]
    return f"flash_bwd_{m.group(1)}_{m.group(2)}<{''.join(args)}>"


def _sass_by_function(tree: Path) -> dict:
    """{K3 or K4 wgmma kernel: SASS lines} of ``tree``'s build of
    csrc/flash_bwd.cu (built first, in a process of its own)."""
    subprocess.run([sys.executable, "-c", "from mfa_tpu_torch.kernels "
                    "import build; build.library()"], cwd=tree, check=True)
    cuobjdump = shutil.which("cuobjdump") or str(
        Path(build._nvcc()).with_name("cuobjdump"))
    obj = tree / "build" / "mfa_tpu_torch" / "flash_bwd.o"
    text = subprocess.run([cuobjdump, "-sass", str(obj)], check=True,
                          capture_output=True, text=True).stdout
    funcs, key = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            key = _sass_key(line.split("Function : ")[1])
            if key is not None:
                funcs[key] = []
        elif key is not None and line.strip():
            funcs[key].append(line.strip())
    if not funcs:
        raise SystemExit(f"no K3/K4 wgmma kernel in {obj}'s SASS:\n"
                         f"{text[:2000]}")
    return {key: _renumber_labels(lines) for key, lines in funcs.items()}


def _renumber_labels(lines: list) -> list:
    """A kernel's SASS with its branch labels (.L_x_N, numbered across
    the whole file) renumbered from 0 in order of appearance, and each
    run of blanks made one (cuobjdump pads the columns to the file's
    widest instruction)."""
    names = {}

    def label(m):
        return f".L_k_{names.setdefault(m.group(0), len(names))}"

    return [re.sub(r"\.L_x_\d+", label, " ".join(line.split()))
            for line in lines]


def compare_sass(a: Path, b: Path) -> bool:
    """Whether every K3 and K4 wgmma and head-dim-split kernel of tree a
    has the same instructions in tree b (one JSON line a kernel, then the
    count)."""
    fa, fb = _sass_by_function(a), _sass_by_function(b)
    same = 0
    for key in sorted(fa):
        got = fb.get(key)
        same += got == fa[key]
        diff = [(x, y) for x, y in zip(fa[key], got or ()) if x != y]
        print(json.dumps({"kernel": key, "in_b": got is not None,
                          "lines_a": len(fa[key]),
                          "lines_b": len(got or ()),
                          "same": got == fa[key], "lines_differing":
                          len(diff), "first_differing": diff[:2]}),
              flush=True)
    print(json.dumps({"kernels_a": len(fa), "same": same,
                      "only_b": sorted(set(fb) - set(fa))}), flush=True)
    return same == len(fa)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("sweep", "curve", "sass"))
    ap.add_argument("--a", default="build/parent",
                    help="sass: the first tree (e.g. the parent commit)")
    ap.add_argument("--b", default=".", help="sass: the second tree")
    ap.add_argument("--only", choices=("fwd", "copy", "bwd", "dblk",
                                       "matmul", "qmm_decode"),
                    default=None, help="sweep one group of kernels only "
                    "(dblk: K1, K3 and K4 past D = 256 and at D 192, 256; "
                    "copy: K1's, K3's and K4's copying producers)")
    ap.add_argument("--plain", nargs="*",
                    default=["none", "k1", "k34", "k1,k34"],
                    help="curve: kernels swapped for their plain versions, "
                    "one run each")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bwd_tuning needs a CUDA device")
    if args.mode == "curve":
        curve(args.plain)
        return 0
    if args.mode == "sass":
        return 0 if compare_sass(Path(args.a).resolve(),
                                 Path(args.b).resolve()) else 1
    if args.only in (None, "fwd"):
        sweep_fwd()
    if args.only in (None, "fwd", "copy"):
        sweep_copy()
    if args.only in (None, "bwd"):
        sweep_bwd()
    if args.only == "dblk":
        sweep_dblk(("flash_fwd", "flash_bwd_q", "flash_bwd_kv"))
    if args.only in (None, "matmul"):
        sweep_matmul()
    if args.only in (None, "qmm_decode"):
        sweep_qmm_decode()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
