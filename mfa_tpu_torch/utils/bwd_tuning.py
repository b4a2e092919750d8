"""Tile sweep of the flash kernels (K1 ``flash_fwd``, K3 ``flash_bwd_q``,
K4 ``flash_bwd_kv``) on one GPU.

``sweep`` runs each candidate parameter row at ``chip_smoke.py``'s
shapes (N = 2048, Hq 32, Hkv 8, bf16) for D = 128 and D = 64: K1 causal
and non-causal, each wgmma candidate a (block_kv, ring stages, ping-pong)
triple (``params.FWD_RING_STAGES`` and ``params.FWD_PINGPONG`` set for
the run); K3 and K4 causal. Each row is first held to its plain version
at ``KERNEL_BUDGETS`` (and K4 to a second run, bit for bit), then timed
(CUDA events, launches queued behind a device spin). One JSON line per
row; the mma.sync row of each head dim is timed beside the wgmma
candidates. Two trees are compared in turns by ``python -m
mfa_tpu_torch.utils.decode_tuning turns --what k1`` (or ``bwd``,
``training``).

``curve`` runs ``chip_smoke.py``'s six training steps (Llama-3-8B
widths at 16 layers, random bf16 weights from seed 4, one 1 x 2049
batch, AdamW at lr 1e-3) with none, K1, K3 and K4, or all three of the
flash kernels swapped for their plain versions, and prints each run's
losses and grad norms: how far the loss curve moves with the attention
kernels' last bits.

Run on a GPU from the repository root:

    python -m mfa_tpu_torch.utils.bwd_tuning sweep [--only fwd|bwd]
    python -m mfa_tpu_torch.utils.bwd_tuning curve [--plain none k1 k34 k1,k34]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from mfa_tpu_torch.kernels import flash_bwd as k34
from mfa_tpu_torch.kernels import flash_fwd as k1
from mfa_tpu_torch.ops import params
from mfa_tpu_torch.ops.descriptors import (
    AttentionDescriptor,
    AttentionKernelType,
)
from mfa_tpu_torch.utils.decode_tuning import _cuda_ms
from mfa_tpu_torch.utils.testing import KERNEL_BUDGETS, budget_share

# K1's candidates: (block_kv, most ring stages, ping-pong) of the wgmma
# row (block_q 128), and the mma.sync row (block_q 64, block_kv 64).
K1_ROWS = ((128, 3, True), (128, 2, True), (128, 3, False),
           (64, 4, True), (64, 2, True), (64, 4, False))
# (block_q, block_kv, kernel) candidates per kernel; block_d is the head
# dim's.
K3_ROWS = ((128, 64, "wgmma"), (64, 64, "mma"))
K4_ROWS = ((64, 64, "wgmma"), (32, 64, "wgmma"), (32, 64, "mma"))


def _inputs(d: int, n: int = 2048, hq: int = 32, hkv: int = 8):
    gen = torch.Generator(device="cuda").manual_seed(3)

    def rnd(h):
        return torch.randn((h, n, d), generator=gen,
                           device="cuda").bfloat16()

    q, k, v, do = rnd(hq), rnd(hkv), rnd(hkv), rnd(hq)
    desc = AttentionDescriptor(
        batch=1, num_q_heads=hq, num_kv_heads=hkv, seq_len_q=n, seq_len_kv=n,
        head_dim=d, causal=True, low_precision_inputs=True,
        low_precision_intermediates=True)
    kd_f, kd_q, kd_kv = (desc.kernel_descriptor(t)
                         for t in AttentionKernelType)
    kw = dict(group=hq // hkv, scale=desc.softmax_scale)
    o, lse = k1.flash_fwd(q, k, v, kd_f, o_dtype=torch.bfloat16, **kw)
    return (q, k, v, o, do, lse), kd_q, kd_kv, kw


def _shares(got, want, keys):
    return {key: budget_share(g, w, *KERNEL_BUDGETS[f"flash_bwd_{key}"])
            for key, g, w in zip(keys, got, want)}


def sweep_fwd() -> None:
    rule = (params.FWD_RING_STAGES, params.FWD_PINGPONG)
    for d in (128, 64):
        for causal in (True, False):
            (q, k, v, _, _, _), _, _, kw = _inputs(d)
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
                ms = _cuda_ms(lambda: k1.flash_fwd(q, k, v, kd, **kw))
                row = params.ParameterRow(d, bq, bkv, d, kernel)
                print(json.dumps({
                    "kernel": "flash_fwd", "D": d, "causal": causal,
                    "block_q": bq, "block_kv": bkv, "row_kernel": kernel,
                    "ring_stages": (params.fwd_stages(row)
                                    if kernel == "wgmma" else None),
                    "pingpong": pp if kernel == "wgmma" else None,
                    "share": shares, "ms": ms}), flush=True)
                params.FWD_RING_STAGES, params.FWD_PINGPONG = rule
                if max(shares.values()) > 1:
                    raise SystemExit(f"K1 row {bkv}/{most}/{pp}/{kernel} at "
                                     f"D={d}: shares {shares}")
            del q, k, v, o_p, l_p, o, lse
            torch.cuda.empty_cache()


def sweep_bwd() -> None:
    for d in (128, 64):
        (q, k, v, o, do, lse), kd_q, kd_kv, kw = _inputs(d)
        dq_p, dterm = k34.flash_bwd_q_plain(q, k, v, o, do, lse, kd_q, **kw)
        dk_p, dv_p = k34.flash_bwd_kv_plain(q, k, v, do, lse, dterm, kd_kv,
                                            **kw)
        for bq, bkv, kernel in K3_ROWS:
            kd = dataclasses.replace(kd_q, block_q=bq, block_kv=bkv,
                                     kernel=kernel)
            dq, dt = k34.flash_bwd_q(q, k, v, o, do, lse, kd, **kw)
            shares = _shares((dq, dt), (dq_p, dterm), ("dq_bf16", "dterm"))
            ms = _cuda_ms(lambda: k34.flash_bwd_q(q, k, v, o, do, lse, kd,
                                                  **kw))
            print(json.dumps({"kernel": "flash_bwd_q", "D": d, "block_q": bq,
                              "block_kv": bkv, "row_kernel": kernel,
                              "share": shares, "ms": ms}), flush=True)
            if max(shares.values()) > 1:
                raise SystemExit(f"K3 row {bq}/{bkv}/{kernel} at D={d} "
                                 f"misses its budget: {shares}")
        for bq, bkv, kernel in K4_ROWS:
            kd = dataclasses.replace(kd_kv, block_q=bq, block_kv=bkv,
                                     kernel=kernel)
            dk, dv = k34.flash_bwd_kv(q, k, v, do, lse, dterm, kd, **kw)
            dk2, dv2 = k34.flash_bwd_kv(q, k, v, do, lse, dterm, kd, **kw)
            same = bool(torch.equal(dk, dk2) and torch.equal(dv, dv2))
            shares = _shares((dk, dv), (dk_p, dv_p), ("dk_bf16", "dv_bf16"))
            ms = _cuda_ms(lambda: k34.flash_bwd_kv(q, k, v, do, lse, dterm,
                                                   kd, **kw))
            print(json.dumps({"kernel": "flash_bwd_kv", "D": d,
                              "block_q": bq, "block_kv": bkv,
                              "row_kernel": kernel, "share": shares,
                              "deterministic": same, "ms": ms}), flush=True)
            if max(shares.values()) > 1 or not same:
                raise SystemExit(f"K4 row {bq}/{bkv}/{kernel} at D={d}: "
                                 f"shares {shares}, deterministic {same}")
        del q, k, v, o, do, lse, dq_p, dterm, dk_p, dv_p
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("sweep", "curve"))
    ap.add_argument("--only", choices=("fwd", "bwd"), default=None,
                    help="sweep one direction's kernels only")
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
    if args.only != "bwd":
        sweep_fwd()
    if args.only != "fwd":
        sweep_bwd()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
