"""Tile sweep of the backward kernels (K3 ``flash_bwd_q``, K4
``flash_bwd_kv``) on one GPU.

``sweep`` runs each candidate parameter row at ``chip_smoke.py``'s bwd
"causal" shape (N = 2048, Hq 32, Hkv 8, causal, bf16) for D = 128 and
D = 64: the row is first held to its plain version at ``KERNEL_BUDGETS``
(and K4 to a second run, bit for bit), then timed (CUDA events, launches
queued behind a device spin). One JSON line per row; the mma.sync row of
each head dim is timed beside the wgmma candidates. Two trees are
compared in turns by ``python -m mfa_tpu_torch.utils.decode_tuning turns
--what bwd`` (or ``training``).

Run on a GPU from the repository root:

    python -m mfa_tpu_torch.utils.bwd_tuning sweep
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from mfa_tpu_torch.kernels import flash_bwd as k34
from mfa_tpu_torch.kernels import flash_fwd as k1
from mfa_tpu_torch.ops.descriptors import (
    AttentionDescriptor,
    AttentionKernelType,
)
from mfa_tpu_torch.utils.decode_tuning import _cuda_ms
from mfa_tpu_torch.utils.testing import KERNEL_BUDGETS, budget_share

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


def sweep() -> None:
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("sweep",))
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bwd_tuning needs a CUDA device")
    sweep()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
