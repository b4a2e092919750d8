"""Kernel parameter tables for Hopper, in ``mfa_tpu``'s pipe mini-DSL.

Port of ``mfa_tpu/ops/params.py``: the row parser (:func:`parse_table`)
and the first-row-with-D<=max_d rule (:func:`select_row`) are kept; the
rows are keyed on a Hopper device model (:class:`HopperDevice`, from
``torch.cuda.get_device_properties``) instead of a TPU generation. The
flash kernels have rows: their blocks change with the head dim and the
input type. The fused decode kernel has one launch shape for every head
dim. The split-KV decode kernels (K2, K5, K6) split the cache by a rule
on the device's SM count (:func:`decode_split_rows`), K8's decode tiles
split K by another (:func:`qmm_split_cols`).
The matrix-product kernels (K7 ``gemm``, K8
``int4_matmul``) choose among a few compiled tiles (:data:`GEMM_TILES`,
:data:`QMM_TILES`) by the problem's shape instead of a head dim.

Columns: ``max_d | block_q | block_kv | block_d [| kernel]``.
``block_q`` rows of Q per CTA (K4: per step of its q walk), ``block_kv``
K/V rows per step of the in-CTA loop (K4: per CTA), ``block_d`` the head
dim the CTA's shared-memory tiles are padded to (one compiled
instantiation per ``block_d``); in a D-blocked row (``mma_dblk``,
``fma_dblk``, ``wgmma_dblk``) it is the head-dim panel, smaller than D
(the ``wgmma_dblk`` rows up to D = 256: as wide as D or wider),
and each CTA owns one panel of the output: the first cut streams Q, K, V
(and dO) in panels of ``block_d`` columns, so any head dim runs; the
head-dim-split kernels (``wgmma_dblk``) give each panel a CTA of one
thread-block cluster, up to :func:`dblk_max_panels` of them. The optional
``kernel`` names the kernel a row runs where a table has more than one
(:data:`ROW_KERNELS`).

Rows marked "not tuned" are first-cut values chosen so that every tile
fits the shared memory and register file of one SM (227 KB, 255
registers a thread); the backward's bf16 ``wgmma`` rows were measured on
the H100. No TPU block size is carried over.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class HopperDevice:
    """What the tables and the launch code need to know about the card."""

    name: str
    sm_count: int
    smem_per_block: int         # bytes a block may opt in to
    compute_capability: tuple


# The shape the tables are written for; also the model the CPU rung
# validates rows against (the CPU runs no kernel).
H100 = HopperDevice("sm90", 132, 232_448, (9, 0))


@functools.cache
def detect_device(device: torch.device | None = None) -> HopperDevice:
    """The Hopper model of ``device`` (a CUDA device), else :data:`H100`;
    cached, since the split-KV decode wrappers ask at every call."""
    if device is None or device.type != "cuda":
        return H100
    props = torch.cuda.get_device_properties(device)
    smem = getattr(props, "shared_memory_per_block_optin", H100.smem_per_block)
    return HopperDevice(f"sm{props.major}{props.minor}",
                        props.multi_processor_count, int(smem),
                        (props.major, props.minor))


@dataclass(frozen=True)
class ParameterRow:
    """One row: applies to head dims <= ``max_d`` (0 = unbounded).
    ``producer`` names how a flash kernel's wgmma kernel fills its tiles
    at launch (:data:`PRODUCERS`; set by ``descriptors.launch_row``, never
    by a table)."""

    max_d: int
    block_q: int
    block_kv: int
    block_d: int
    kernel: str = ""
    producer: str = ""


# The kernels a row may name: "wgmma" the warp-specialised TMA + wgmma
# kernels, "mma" the first-cut mma.sync ones (bf16), "mma_dblk" and
# "fma_dblk" the head-dim-blocked mma.sync (bf16) and FMA (fp32) kernels
# for D > 256, "wgmma_dblk" the head-dim-split cluster kernels (bf16, past
# D = 128): one CTA of a thread-block cluster per block_d panel, S (and
# dP) summed across the cluster (up to D = 256: one CTA holding the whole
# head dim, nothing to sum).
ROW_KERNELS = ("mma", "wgmma", "mma_dblk", "fma_dblk", "wgmma_dblk")
DBLK_KERNELS = ("mma_dblk", "fma_dblk", "wgmma_dblk")


def dblk_max_panels(block_d: int) -> int:
    """The most head-dim panels (CTAs of a cluster) of a ``wgmma_dblk``
    row of panel width ``block_d``: K1's exchange slots are sized for them
    (csrc/flash_fwd.cu ``dblk_max_panels``); K3's and K4's rows are 192 or
    256 wide, one CTA or clusters of two (their exchange slots hold one
    other CTA's partials). One CTA needs no slots."""
    return 4 if block_d == 128 else 2


def parse_table(text: str) -> list[ParameterRow]:
    """Parse a pipe-delimited table.

    Format per line:  max_d | block_q | block_kv | block_d [| kernel]
    Lines starting with '#' and blank lines are ignored; 'inf' max_d means
    unbounded (stored as 0) and must be the last row; ``kernel`` is one of
    :data:`ROW_KERNELS`.
    """
    rows = []
    for line in text.strip().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = [p.strip() for p in line.split("|")]
        if len(parts) not in (4, 5) or (len(parts) == 5
                                        and parts[4] not in ROW_KERNELS):
            raise ValueError(f"malformed parameter row: {line!r}")
        max_d = 0 if parts[0] in ("inf", "-") else int(parts[0])
        rows.append(ParameterRow(max_d=max_d, block_q=int(parts[1]),
                                 block_kv=int(parts[2]),
                                 block_d=int(parts[3]),
                                 kernel=parts[4] if len(parts) == 5 else ""))
    if not rows:
        raise ValueError("empty parameter table")
    if rows[-1].max_d != 0:
        raise ValueError(
            "last row of a parameter table must be unbounded (max_d=inf)")
    return rows


def select_row(rows: list[ParameterRow], head_dim: int) -> ParameterRow:
    """First row with head_dim <= max_d."""
    for row in rows:
        if row.max_d == 0 or head_dim <= row.max_d:
            return row
    raise AssertionError("unreachable: last row is unbounded")


# K1 bf16 at D <= 128 (csrc/flash_fwd.cu, flash_fwd_wgmma): 128 query
# rows a CTA (64 a consumer warpgroup), K and V streamed block_kv rows a
# step through a K ring and a V ring of at most FWD_RING_STAGES tiles each
# (as many as fit). Measured by utils/bwd_tuning.py sweep on the H100 at
# chip_smoke.py's k1 shape (N = 2048, Hq 32, Hkv 8), when K and V shared
# one ring of stages: block_kv 128 with 3 stages takes 0.09378 ms causal
# and 0.14148 non-causal at D = 128, 0.07185 and 0.11528 at D = 64;
# block_kv 64 (4 stages) 0.11584 / 0.18133 and 0.08545 / 0.1469; the
# mma.sync rows 0.30866 / 0.53608 and 0.17279 / 0.31978. The separate
# rings (a K tile freed once S has read it), in turns with the shared ring
# on one card (NVIDIA H100 80GB HBM3, 700 W): 0.0983 / 0.1458 -> 0.0960 /
# 0.1421 at D = 128, 0.0738 / 0.1164 -> 0.0710 / 0.1108 at D = 64.
# Where TMA cannot map the operands but one CTA holds D and the rows and
# bases share 4 bytes (D even up to 256: flash_bf16_table_precision,
# descriptors.launch_row), the rows up to D 256 run with the cp.async
# producer (rings of FWD_COPY_RING_STAGES); by utils/bwd_tuning.py sweep
# --only copy (NVIDIA H100 80GB HBM3, 700 W), ms causal / non-causal:
# - OpenLLaMA-3B's D 100 (Hq = Hkv 32, N 2048) on the 128-wide panel:
#   block_kv 128 0.1256 / 0.1923 (N 512 causal 0.0226); the mma.sync row
#   0.4680 / 1.012.
# - D 250 (H 8, N 1024) on the 256-wide panel: block_kv 64 0.0700 /
#   0.0697; the mma.sync row 0.2092 / 0.2096.
# Candidates that lost there and were dropped with their instances:
# block_kv 64 at D 100, 0.1424 / 0.2247; block_kv 32 at D 250, 0.1085 /
# 0.1094; each K / V tile by one 1-D bulk copy into a staging slot,
# repacked into the swizzled tile by the producer warpgroup, 0.1555 /
# 0.2485 at D 100 and 0.1150 / 0.1154 at D 250.
# Odd D and bases only 2-byte aligned take _FWD_BF16_MMA.
# Above D = 128 up to D = 512 (rows wgmma_dblk, csrc/flash_fwd.cu
# flash_fwd_wgmma on a block_d-wide head-dim panel): one CTA holding the
# whole head dim up to D = 256 (a 192- or 256-wide panel; O at 64 x 256
# fp32 is 128 registers a thread), past it a cluster of two CTAs, one a
# panel of Q, K, V and O, S summed across the cluster; beyond D = 512
# the mma.sync D-blocked kernel (mma_dblk: one CTA per block_d panel of
# O, S summed over panels of Q and K streamed through shared memory).
# Measured by utils/bwd_tuning.py sweep --only fwd on the H100 (NVIDIA
# H100 80GB HBM3, 700 W) at B 1, H 8, N 4096, causal / non-causal (ms):
# - D = 192: one CTA on a 192-wide panel, block_kv 64, 0.1098 / 0.1910;
#   on a 256-wide one 0.1378 / 0.2317; block_kv 32 0.1583 / 0.2831 (192)
#   and 0.1940 / 0.3387 (256); two CTAs of 128-wide panels 0.4995 /
#   0.9238; the mma.sync row 0.6187 / 1.249.
# - D = 256: one CTA, block_kv 64, 0.1316 / 0.2274; block_kv 32 0.1871 /
#   0.3347; two CTAs of 128-wide panels 0.4869 / 0.9085, of 192-wide ones
#   0.5352 / 0.9717; the mma.sync row 0.7132 / 1.408.
# - The one-CTA rows in bwd_tuning's K1_SPLIT_VARIANTS (rings of 2 + 2
#   tiles, the odd tile in K's ring, up to 4 tiles a ring, no ping-pong)
#   all within 1.1% of the rule's 2 K + 3 V tiles at block_kv 64.
# - D = 384: two CTAs of 192-wide panels 0.5039 / 0.9229, of 256-wide
#   ones 0.5822 / 1.040, three of 128-wide ones 1.076 / 2.078, mma_dblk
#   2.681 / 5.222 (128-wide panels, 64-wide kv steps) and 3.146 / 6.208
#   (256, 32).
# - D = 512: two CTAs of 256-wide panels 0.5415 / 1.016, four of 128
#   1.584 / 3.117, mma_dblk 3.503 / 6.990 (256, 32) and 4.224 / 8.363.
# - The clusters' separate rings against the shared ring, in turns on one
#   card: D = 384 0.5140 / 0.9504 -> 0.5018 / 0.9210, D = 512 0.6064 /
#   1.145 -> 0.5427 / 1.014 (the same tiles; K freed a step earlier).
_FWD_BF16 = """
# max_d | block_q | block_kv | block_d | kernel
   64   |  128    |   128    |   64    | wgmma
  128   |  128    |   128    |  128    | wgmma
  192   |  128    |    64    |  192    | wgmma_dblk
  256   |  128    |    64    |  256    | wgmma_dblk
  384   |  128    |    64    |  192    | wgmma_dblk
  512   |  128    |    64    |  256    | wgmma_dblk
  inf   |   64    |    32    |  256    | mma_dblk
"""

# K1 bf16 where neither TMA nor the wgmma kernel's copying producer can
# take the operands: odd D (rows of an odd number of 2-byte values), a
# base only 2-byte aligned, or D % 8 != 0 past D 256 (the cluster rows
# take TMA only): the mma.sync kernel for every head dim; at D 129-256
# four warps of 16 rows, the kv step halved so the fp32 O accumulator
# (128 registers a thread at D 256) fits (not tuned on the H100; as the
# bf16 table's D 256 row before the one-CTA wgmma_dblk rows it took
# 0.7210 / 1.406 ms at B 1, H 8, N 4096, causal / non-causal; before the
# copying producer it ran OpenLLaMA-3B's D 100, times above). The
# D-blocked rows by the same sweep at N 1024: D = 300, 0.642 + 1.281 ms
# (causal + non-causal) against 1.075 + 1.143; D = 500, 1.421 + 1.461
# against 1.010 + 1.944.
_FWD_BF16_MMA = """
   64   |   64    |    64    |   64    | mma
  128   |   64    |    64    |  128    | mma
  256   |   64    |    32    |  256    | mma
  384   |   64    |    64    |  128    | mma_dblk
  inf   |   64    |    32    |  256    | mma_dblk
"""

# fp32: plain FMA (the fp32 budget of 2e-5 rules out TF32 tensor cores).
# (Not tuned on the H100.) Above D = 256 the head-dim-blocked FMA kernel
# (fma_dblk), by the same sweep at N 1024 (causal / non-causal): D = 384,
# 128-wide panels 2.244 / 4.447 ms against 2.706 / 5.320; D = 512,
# 256-wide 3.198 / 6.263 against 3.831 / 7.583.
_FWD_FP32 = """
   64   |   16    |    32    |   64
  128   |   16    |    32    |  128
  256   |   16    |    32    |  256
  384   |   16    |    32    |  128    | fma_dblk
  inf   |   16    |    32    |  256    | fma_dblk
"""

# K3 bf16 at D <= 128 (csrc/flash_bwd.cu, flash_bwd_q_wgmma): 128 query
# rows a CTA (64 a consumer warpgroup), K and V streamed block_kv rows a
# stage. Measured by utils/bwd_tuning.py sweep on the H100 at
# chip_smoke.py's causal shape: 0.2108 ms at D = 128 and 0.1730 at D = 64
# (the mma.sync rows 0.7636 and 0.4284); block_kv 128 was within 1.5%
# with a ring of two stages and leaves no room for more. The head-dim-split
# kernel of the rows past D = 128 on one CTA (block_kv 64, a sweep
# candidate) took 0.1764 ms at D = 128 against this kernel's 0.1767, and
# 0.1522 at D = 64 against 0.1456 (same sweep, one run, NVIDIA H100 80GB
# HBM3, 700 W). Even head dims TMA cannot map keep these rows with the
# copying producer (BWD_Q_COPY_RING_STAGES); odd ones take
# _BWD_Q_BF16_MMA.
# Above D = 128 up to D = 512 (rows wgmma_dblk, csrc/flash_bwd.cu
# flash_bwd_q_split): the head-dim-split kernel, 128 query rows a CTA, one
# CTA on a 192- or 256-wide panel up to D = 256, a cluster of two past it,
# S and dP summed across the cluster; dQ's product deferred a step.
# Measured by utils/bwd_tuning.py sweep --only dblk on the H100 (NVIDIA
# H100 80GB HBM3, 700 W) at B 1, H 8, N 4096 (causal / non-causal): D =
# 192, one CTA on a 192-wide panel 0.2024 / 0.3164 ms, on a 256-wide one
# 0.2476 / 0.4275, the mma.sync row 2.021 / 3.095 (64-wide kv steps,
# 0.2056 / 0.3399, not kept); D = 256, one CTA 0.2421 / 0.4135, two on
# 192-wide panels 0.9209 / 1.686, the mma.sync row 2.138 / 3.519; D =
# 384, two CTAs on 192-wide panels 0.9376 / 1.708, on 256-wide 1.011 /
# 1.856; D = 512, two on 256-wide panels 0.9992 / 1.850.
# Beyond D = 512 (mma_dblk): one CTA per block_d panel of dQ, S and dP
# summed over panels of Q, dO, K and V. By the same sweep: 128-wide
# panels with 64-wide kv steps 4.499 / 7.433 ms at D = 384 and 6.993 /
# 12.25 at D = 512, 256-wide ones with 32-wide steps 7.403 / 12.65 and
# 8.065 / 14.16 (D % 8 != 0 at N 1024, the bf16_mma rows: 1.119 / 1.703
# against 1.654 / 1.964 at D = 300, 2.325 / 2.905 against 2.724 / 3.287
# at D = 500).
_BWD_Q_BF16 = """
# max_d | block_q | block_kv | block_d | kernel
   64   |  128    |    64    |   64    | wgmma
  128   |  128    |    64    |  128    | wgmma
  192   |  128    |    32    |  192    | wgmma_dblk
  256   |  128    |    32    |  256    | wgmma_dblk
  384   |  128    |    32    |  192    | wgmma_dblk
  512   |  128    |    32    |  256    | wgmma_dblk
  inf   |   64    |    64    |  128    | mma_dblk
"""

# K3 bf16 where neither TMA nor the copying producer can take the
# operands (odd D, a base only 2-byte aligned, D % 8 != 0 past D 256):
# the mma.sync kernel for every head dim; at D 129-256 four warps of 16
# query rows, registers holding the fp32 dQ accumulator plus S and dP
# for one kv step, so the step halves. (Not tuned on the H100.)
_BWD_Q_BF16_MMA = """
   64   |   64    |    64    |   64    | mma
  128   |   64    |    64    |  128    | mma
  256   |   64    |    32    |  256    | mma
  384   |   64    |    64    |  128    | mma_dblk
  inf   |   64    |    64    |  128    | mma_dblk
"""

# K3 fp32: plain FMA, 16 query rows per CTA, 32-wide kv steps.
# (Not tuned on the H100.) Above D = 256, fma_dblk: 128-wide panels take
# 3.877 / 6.384 ms (causal / non-causal, N 1024) at D = 384 and 6.325 /
# 11.043 at D = 512, 256-wide ones 9.296 / 16.182 and 11.173 / 19.456.
_BWD_Q_FP32 = """
   64   |   16    |    32    |   64
  128   |   16    |    32    |  128
  256   |   16    |    32    |  256
  384   |   16    |    32    |  128    | fma_dblk
  inf   |   16    |    32    |  128    | fma_dblk
"""

# K4 bf16 at D <= 128 (flash_bwd_kv_wgmma): 64 kv rows a CTA, Q, dO, L
# and the D-term streamed block_q rows a step, the two consumer
# warpgroups taking alternate steps. block_q at D = 128: 64 took 0.2081
# ms against this row's 32 at 0.2116 (chip_smoke.py's autotune phase,
# utils/autotune.py tune_backward at its causal shape; NVIDIA H100 80GB
# HBM3, 700 W; the row stays: within 2%, and the block_q 64 instance's
# wgmmas ptxas serialises); at D = 64,
# 64 (0.1530 ms) beats 32 (0.1952 ms) by the sweep; the mma.sync rows
# take 1.7789 and 1.1472 ms. Even head dims TMA cannot map keep these
# rows with the copying producer (BWD_KV_COPY_RING_STAGES); odd ones take
# _BWD_KV_BF16_MMA. Above D = 128 up to D = 512 the head-dim-split kernel
# (wgmma_dblk, csrc/flash_bwd.cu flash_bwd_kv_split), its warpgroups
# owning dV and dK: one CTA on a 192- or 256-wide panel up to D = 256,
# clusters of two past it; beyond D = 512 mma_dblk: one CTA per block_d
# panel of dK and dV (at block_d 256 its eight warps split the panel),
# S^T and dP^T summed over panels of K, V, Q and dO. By
# utils/bwd_tuning.py sweep --only dblk on the H100 (NVIDIA H100 80GB
# HBM3, 700 W) at B 1, H 8, N 4096 (causal / non-causal): D = 192, one CTA
# on a 192-wide panel 0.4580 / 0.8455 ms, on a 256-wide one 0.5128 /
# 0.9607, the mma.sync row 2.419 / 3.928; D = 256, one CTA 0.5277 /
# 0.9781, two on 192-wide panels 1.454 / 2.786, the mma.sync row 2.526 /
# 4.360 (two CTAs of 128-wide panels, 1.334 / 2.571 at D = 256 and 1.323
# / 2.596 at 192, not kept); D = 384, two CTAs on 192-wide panels 1.446 /
# 2.797, on 256-wide 1.579 / 3.055, mma_dblk 7.625 / 12.87 (128-wide
# panels) and 7.893 / 14.58 (256); D = 512, two CTAs on 256-wide panels
# 1.592 / 3.080, mma_dblk 8.864 / 16.68 (256) and 11.09 / 20.85 (128).
# One CTA as a plain launch without the exchange slots (a fourth ring
# stage at D = 256), in a later run of the same sweep beside the launch
# as a cluster of one: D = 192 0.4407 / 0.8215 against 0.4599 / 0.8524,
# D = 256 0.5097 / 0.9457 against 0.5250 / 0.9741.
_BWD_KV_BF16 = """
# max_d | block_q | block_kv | block_d | kernel
   64   |   64    |    64    |   64    | wgmma
  128   |   32    |    64    |  128    | wgmma
  192   |   32    |    64    |  192    | wgmma_dblk
  256   |   32    |    64    |  256    | wgmma_dblk
  384   |   32    |    64    |  192    | wgmma_dblk
  512   |   32    |    64    |  256    | wgmma_dblk
  inf   |   32    |    64    |  256    | mma_dblk
"""

# K4 bf16 where neither TMA nor the copying producer can take the
# operands (as for K3); at D 129-256 64 kv rows per CTA in eight warps
# that split the head dim, 32-row q steps.
# (Not tuned on the H100 up to D = 256.) The D-blocked rows at N 1024:
# 256-wide panels take 1.495 / 1.889 ms (causal / non-causal) at D = 300
# and 1.826 / 2.283 at D = 500, 128-wide ones 1.797 / 2.857 and 3.202 /
# 4.142.
_BWD_KV_BF16_MMA = """
   64   |   32    |    64    |   64    | mma
  128   |   32    |    64    |  128    | mma
  256   |   32    |    64    |  256    | mma
  384   |   32    |    64    |  256    | mma_dblk
  inf   |   32    |    64    |  256    | mma_dblk
"""

# K4 fp32: plain FMA, 16 kv rows per CTA, 32-wide q steps.
# (Not tuned on the H100.) Above D = 256, fma_dblk: D = 384, 128-wide
# panels 4.384 / 7.878 ms (causal / non-causal, N 1024) against 5.065 /
# 10.106; D = 512, 256-wide 5.706 / 11.388 against 6.700 / 13.286.
_BWD_KV_FP32 = """
   64   |   32    |    16    |   64
  128   |   32    |    16    |  128
  256   |   32    |    16    |  256
  384   |   32    |    16    |  128    | fma_dblk
  inf   |   32    |    16    |  256    | fma_dblk
"""

# Rows per device model (by name); only Hopper (sm90) so far.
_TABLES = {
    "sm90": {
        ("flash_fwd", "bf16"): _FWD_BF16,
        ("flash_fwd", "bf16_mma"): _FWD_BF16_MMA,
        ("flash_fwd", "fp32"): _FWD_FP32,
        ("flash_bwd_q", "bf16"): _BWD_Q_BF16,
        ("flash_bwd_q", "bf16_mma"): _BWD_Q_BF16_MMA,
        ("flash_bwd_q", "fp32"): _BWD_Q_FP32,
        ("flash_bwd_kv", "bf16"): _BWD_KV_BF16,
        ("flash_bwd_kv", "bf16_mma"): _BWD_KV_BF16_MMA,
        ("flash_bwd_kv", "fp32"): _BWD_KV_FP32,
    },
}

# The decode kernels (K2, K5, K6) take any head dim up to this (a warp's
# 32 lanes take at most two 8-value chunks of a row each:
# decode_row_layout); the flash kernels take any head dim (the D-blocked
# rows above 256).
DECODE_MAX_HEAD_DIM = 512

_PARSED: dict = {}


def parameter_table(kernel: str, precision: str,
                    device: HopperDevice = H100) -> list[ParameterRow]:
    """The rows for (kernel, precision class) on ``device``; every row must
    fit the device's shared memory per block."""
    tables = _TABLES.get(device.name)
    if tables is None:
        raise ValueError(f"no parameter rows for {device.name}: the port's "
                         "kernels are built for Hopper (sm90)")
    key = (device.name, device.smem_per_block, kernel, precision)
    if key not in _PARSED:
        rows = parse_table(tables[(kernel, precision)])
        in_bytes = 2 if precision.startswith("bf16") else 4
        for row in rows:
            if smem_bytes(kernel, row, in_bytes) > device.smem_per_block:
                raise ValueError(f"{kernel} row {row} exceeds the "
                                 f"{device.smem_per_block} bytes of "
                                 f"shared memory on {device.name}")
        _PARSED[key] = rows
    return _PARSED[key]


def smem_bytes(kernel: str, row: ParameterRow, in_bytes: int) -> int:
    """Shared memory of one CTA of ``kernel`` at ``row`` (as the launch
    code in ``csrc/`` computes it)."""
    return _SMEM[kernel](row, in_bytes)


# The wgmma kernels (csrc/flash_fwd.cu, csrc/flash_bwd.cu) size their
# rings of tiles to the H100's shared memory per block: as many stages as
# fit, up to a most: K1's (a K ring and a V ring, read by both consumer
# warpgroups; each at most FWD_RING_STAGES), K3's (K and V, up to 4) and
# K4's, an even number up to 4 (Q, dO, L and the D-term; stage s feeds
# warpgroup s % 2).
_SMEM_OPTIN = H100.smem_per_block
# Slack to align the dynamic shared memory to the 1024-byte swizzle atom.
_SMEM_ALIGN = 1024
# K1's wgmma launch, read at each call (the row sweep of
# utils/bwd_tuning.py varies both): the most tiles of its K ring and of
# its V ring, and whether its two consumer warpgroups take turns issuing
# their products (ping-pong), so that one's softmax runs under the
# other's products. Measured by the same sweep at D = 128, block_kv 128,
# when one ring held K and V together: 3 stages (all that fit) against
# 2, 0.09378 against 0.10547 ms causal; ping-pong on against off,
# 0.09378 against 0.09877 causal and 0.14148 against 0.14654 non-causal.
# With separate rings 2 tiles a ring take 0.0937 against 3's 0.0943
# causal at D = 128, and at D 192 and 256 every depth that fits and
# ping-pong off are within 1.1% of these settings.
FWD_RING_STAGES = 3
FWD_PINGPONG = True
# How the flash kernels' wgmma kernels (K1, K3, K4) fill their tiles (the
# C entries' producer codes, csrc/hopper.cuh Producer): "" by TMA where
# TMA maps the operands; else, for one CTA (D <= 256) of rows and bases
# that share 4 bytes, "copy" (cp.async of that granule straight into the
# swizzled tiles).
PRODUCERS = {"": 0, "copy": 1}
# The most tiles a ring of K1's copying producer (FWD_RING_STAGES for
# TMA's), read at each call. By utils/bwd_tuning.py sweep --only copy on
# the H100 (NVIDIA H100 80GB HBM3, 700 W), cp.async at OpenLLaMA-3B's D
# 100 (Hq = Hkv 32, N 2048, block_kv 128): 2 + 2 tiles 0.1281 ms causal
# and 0.1957 non-causal against 3 + 3's 0.1429 and 0.2238; at D 250 (H 8,
# N 1024, block_kv 64) 2 + 2 tiles 0.07086 / 0.0705 against 2 + 3's
# 0.08306 / 0.08556: a deeper ring only lets the producer's copies
# compete longer with the consumers' softmax for issue slots.
FWD_COPY_RING_STAGES = 2
# K3's and K4's copying producers, compile-time in csrc/flash_bwd.cu
# (kQCopyStages, kKvCopyStages; these mirror them, and the sweep builds
# the library again for other depths; TMA's rings take as many stages as
# fit, up to 4): the most tiles of K3's K and V ring
# (or of each of its one-CTA head-dim-split kernel's two), and the most
# stages of K4's Q, dO, L and D-term ring that each consumer warpgroup
# cycles through: twice as many in the ring of its wgmma kernel, whose
# warpgroups take alternate steps, as many in its head-dim-split
# kernel's, whose warpgroups both read every step. A warpgroup needs two:
# a step's stage is freed by its deferred product, in its next step. By
# utils/bwd_tuning.py sweep --only copy (NVIDIA H100 80GB HBM3, 700 W),
# ms causal / non-causal, the mma.sync rows they replace last:
# - K3 at OpenLLaMA-3B's D 100 (Hq = Hkv 32, N 2048), 2 / 3 / 4 tiles:
#   0.2483 / 0.2223 / 0.2240 and 0.3867 / 0.3139 / 0.3116 (mma.sync
#   1.418 / 2.089); at N 512 causal 0.03596 / 0.03618 / 0.03679; at D
#   250 (H 8, N 1024), 2 / 3 tiles a ring (4 do not fit): 0.1419 /
#   0.1304 and 0.1432 / 0.1310 (mma.sync 0.3775 / 0.3844).
# - K4 at D 100, 2 / 3 / 4 stages a warpgroup (rings of 4 / 6 / 8):
#   0.4211 / 0.4232 / 0.4306 and 0.7282 / 0.7323 / 0.7410 (mma.sync
#   1.500 / 2.442); at N 512 causal 0.05014 / 0.05134 / 0.05308; at D
#   250 (rings of 2 / 3 / 4): 0.1391 / 0.1149 / 0.1180 and 0.1546 /
#   0.1289 / 0.1321 (mma.sync 0.3634 / 0.3904).
BWD_Q_COPY_RING_STAGES = 3
BWD_KV_COPY_RING_STAGES = 3
# The (block_q, block_kv, block_d) of each flash kernel's instances with
# the copying producer (csrc/flash_fwd.cu launch_copying, csrc/flash_bwd.cu
# launch_q_copying and launch_kv_copying): one a bf16 table row up to D
# 256.
COPY_ROWS = {
    "flash_fwd": ((128, 128, 64), (128, 128, 128), (128, 64, 192),
                  (128, 64, 256)),
    "flash_bwd_q": ((128, 64, 64), (128, 64, 128), (128, 32, 192),
                    (128, 32, 256)),
    "flash_bwd_kv": ((64, 64, 64), (32, 64, 128), (32, 64, 192),
                     (32, 64, 256)),
}


def _ring_stages(fixed: int, per_stage: int, most: int, mult: int) -> int:
    """csrc/flash_bwd.cu's ring_stages."""
    return min((_SMEM_OPTIN - fixed) // per_stage, most) // mult * mult


def row_panels(row: ParameterRow) -> int:
    """The head-dim panels of a ``wgmma_dblk`` row at its largest head dim
    (the tables' rows never straddle D = block_d: up to 256 one panel,
    past it two, K1's 128-wide sweep candidates up to four)."""
    if not row.max_d:
        return dblk_max_panels(row.block_d)
    return -(-row.max_d // row.block_d)


def bwd_q_stages(row: ParameterRow) -> int:
    """Stages of K3's wgmma ring at ``row`` (Q and dO resident, L and the
    D-term beside it): as many as fit, up to 4, or with the copying
    producer up to BWD_Q_COPY_RING_STAGES (csrc/flash_bwd.cu
    QWgmmaSmem)."""
    d, bq, bkv = row.block_d, row.block_q, row.block_kv
    most = BWD_Q_COPY_RING_STAGES if row.producer else 4
    return _ring_stages(2 * 2 * bq * d + 8 * bq + 8 + _SMEM_ALIGN,
                        2 * 2 * bkv * d + 16, most, 1)


def bwd_q_split_stages(row: ParameterRow) -> tuple[int, int]:
    """Stages of the K and V rings of K3's head-dim-split kernel at
    ``row`` (csrc/flash_bwd.cu QSplitSmem): the K and V tiles that fit
    beside Q, dO, L, the D-term and, as a cluster, the exchange slots with
    their four mbarriers, each tile with two mbarriers; K gets up to 4 of
    them keeping one for V, V the rest, up to 4. With the copying producer
    (one CTA) each ring takes half the tiles, up to
    BWD_Q_COPY_RING_STAGES (csrc/flash_bwd.cu QSplitSmem)."""
    d, bq, bkv = row.block_d, row.block_q, row.block_kv
    x = exchange_bytes("flash_bwd_q", row)
    tiles = ((_SMEM_OPTIN - 2 * 2 * bq * d - x - 8 * bq
              - 8 * (1 + (4 if x else 0)) - _SMEM_ALIGN)
             // (2 * bkv * d + 16))
    if row.producer:
        n = min(tiles // 2, BWD_Q_COPY_RING_STAGES)
        return n, n
    sv = min(max(tiles - 4, 1), 4)
    return min(tiles - sv, 4), sv


def exchange_bytes(kernel: str, row: ParameterRow) -> int:
    """A ``wgmma_dblk`` row's exchange buffers: K1's, as a cluster, for
    each of the two consumer warpgroups one slot for each other CTA of the
    largest cluster (:func:`dblk_max_panels`) of its partial S (64 x
    block_kv fp32); K3's, as a cluster of two, one slot a warpgroup of its
    partial S and dP (two of 64 x block_kv fp32); K4's (warpgroup 1
    forming S^T and warpgroup 0 dP^T), as a cluster of two, a slot of 64 x
    block_q fp32 for each warpgroup. 0 for one CTA and for the other
    rows."""
    if row.kernel != "wgmma_dblk" or row_panels(row) == 1:
        return 0
    if kernel == "flash_fwd":
        return 2 * (dblk_max_panels(row.block_d) - 1) * 64 * row.block_kv * 4
    if kernel == "flash_bwd_q":
        return 2 * 2 * 64 * row.block_kv * 4
    return 2 * 64 * row.block_q * 4


def bwd_kv_stages(row: ParameterRow) -> int:
    """Stages of K4's wgmma ring at ``row``: an even number, up to 4, on
    the kernel whose warpgroups take alternate steps; up to 4 on the
    head-dim-split kernel (both warpgroups read every stage; it keeps one
    scaled-Q tile and the two S^T hand-off buffers, four more mbarriers,
    and as a cluster its exchange slots and four more). With the copying
    producer, up to BWD_KV_COPY_RING_STAGES a warpgroup: as many on the
    head-dim-split kernel, twice as many on the other (csrc/flash_bwd.cu
    KvSplitSmem, KvWgmmaSmem)."""
    d, bq, bkv = row.block_d, row.block_q, row.block_kv
    most = BWD_KV_COPY_RING_STAGES if row.producer else 4
    if row.kernel == "wgmma_dblk":
        x = exchange_bytes("flash_bwd_kv", row)
        return _ring_stages(2 * 2 * bkv * d + 2 * bq * d + x
                            + 2 * 64 * bq * 4 + 8 * (5 + (4 if x else 0))
                            + _SMEM_ALIGN, 2 * 2 * bq * d + 8 * bq + 16, most,
                            1)
    return _ring_stages(2 * 2 * bkv * d + 2 * 2 * bq * d + 8 + _SMEM_ALIGN,
                        2 * 2 * bq * d + 8 * bq + 16,
                        2 * most if row.producer else most, 2)


def bwd_copy_stages(kernel: str, row: ParameterRow) -> int:
    """The ring depth of K3's (``flash_bwd_q``) or K4's (``flash_bwd_kv``)
    instance at ``row`` with the copying producer, as csrc/flash_bwd.cu's
    layouts compile it (each ring's, on K3's head-dim-split kernel); 0
    for every other row."""
    if not row.producer:
        return 0
    if kernel == "flash_bwd_kv":
        return bwd_kv_stages(row)
    if row.kernel == "wgmma_dblk":
        return bwd_q_split_stages(row)[0]
    return bwd_q_stages(row)


def fwd_rings(row: ParameterRow) -> tuple[int, int]:
    """Tiles of K1's K ring and V ring at a ``wgmma`` or ``wgmma_dblk``
    row (the launch passes both; read at call time: the row sweep varies
    FWD_RING_STAGES): the K and V tiles that fit beside Q (and, as a
    cluster, the exchange slots with their four mbarriers), each tile
    with two mbarriers. A K tile is freed once S has read it, a V tile a
    step later, once the deferred PV has: the V ring takes the odd tile.
    Each ring holds at most FWD_RING_STAGES (with a copying producer,
    FWD_COPY_RING_STAGES)."""
    d, bq, bkv = row.block_d, row.block_q, row.block_kv
    x = exchange_bytes("flash_fwd", row)
    tiles = ((_SMEM_OPTIN - 2 * bq * d - x - 8 * (1 + (4 if x else 0))
              - _SMEM_ALIGN) // (2 * bkv * d + 16))
    most = FWD_COPY_RING_STAGES if row.producer else FWD_RING_STAGES
    v = min(-(-tiles // 2), most)
    return min(tiles - v, most), v


def flash_bf16_table_precision(head_dim: int) -> str:
    """The bf16 table of K1, K3 and K4 for a head dim: ``"bf16"`` where
    TMA maps a row (D % 8 == 0) and, up to D = 256, wherever a row is a
    multiple of 4 bytes (D even: the wgmma kernels' copying producers);
    else the mma.sync rows."""
    if head_dim % 2 == 0 and head_dim <= 256:
        return "bf16"
    return bf16_table_precision(head_dim)


def bf16_table_precision(head_dim: int) -> str:
    """The table of the rows TMA maps for a head dim: ``"bf16"`` (whose
    rows up to D = 128 run the wgmma kernels) when a TMA tensor map can
    hold a row, i.e. D bf16 values are a multiple of 16 bytes; else the
    mma.sync rows (``"bf16_mma"``)."""
    return "bf16" if head_dim % 8 == 0 else "bf16_mma"


def flash_fwd_smem_bytes(row: ParameterRow, in_bytes: int) -> int:
    """K1: the wgmma kernel keeps Q resident, a ring of K tiles and a ring
    of V tiles (:func:`fwd_rings`) with two mbarriers a tile (full, free)
    and one for Q, and as a cluster its exchange slots and four mbarriers
    (the copying producer keeps the TMA layout, D padded to block_d); the
    mma.sync kernel Q and K tiles plus the transposed V
    tile, each row padded by 8 elements (bank spread); the fp32 kernel
    unpadded Q rows and K/V rows padded by one. The D-blocked kernels
    hold the same tiles, block_d columns wide, at any head dim."""
    d, bq, bkv = row.block_d, row.block_q, row.block_kv
    if row.kernel in ("wgmma", "wgmma_dblk"):
        tiles = sum(fwd_rings(row))
        x = exchange_bytes("flash_fwd", row)
        return (2 * bq * d + x + tiles * 2 * bkv * d
                + 8 * (1 + 2 * tiles + (4 if x else 0)) + _SMEM_ALIGN)
    if in_bytes == 2:
        return in_bytes * (bq * (d + 8) + bkv * (d + 8) + d * (bkv + 8))
    return 4 * (bq * d + 2 * bkv * (d + 1))


def flash_bwd_q_smem_bytes(row: ParameterRow, in_bytes: int) -> int:
    """K3: the wgmma kernels keep Q (scaled in place) and dO resident and
    a ring of K and V tiles, L and the D-term per row (fp32) and one
    mbarrier per stage plus one (the head-dim-split kernel: separate K and
    V rings, two mbarriers a tile, and as a cluster its exchange slots and
    four mbarriers); the mma.sync kernel pre-scaled Q, dO, K and V tiles
    (rows padded by 8) and the transposed K tile, plus L and the D-term
    per row; the fp32 kernel unpadded Q/dO and K/V rows padded
    by one. The D-blocked kernels hold the same tiles, block_d columns
    wide; the FMA one also K's panel of its dQ columns."""
    d, bq, bkv = row.block_d, row.block_q, row.block_kv
    if row.kernel == "wgmma":
        stages = bwd_q_stages(row)
        return (2 * 2 * bq * d + stages * 2 * 2 * bkv * d + 4 * 2 * bq
                + 8 * (1 + 2 * stages) + _SMEM_ALIGN)
    if row.kernel == "wgmma_dblk":
        tiles = sum(bwd_q_split_stages(row))
        x = exchange_bytes("flash_bwd_q", row)
        return (2 * 2 * bq * d + x + tiles * 2 * bkv * d + 4 * 2 * bq
                + 8 * (1 + 2 * tiles + (4 if x else 0)) + _SMEM_ALIGN)
    if in_bytes == 2:
        return (2 * (2 * bq * (d + 8) + 2 * bkv * (d + 8) + d * (bkv + 8))
                + 4 * 2 * bq)
    k_tiles = 3 if row.kernel == "fma_dblk" else 2
    return 4 * (2 * bq * d + k_tiles * bkv * (d + 1) + 2 * bq)


def flash_bwd_kv_smem_bytes(row: ParameterRow, in_bytes: int) -> int:
    """K4: the wgmma kernel keeps K and V resident, a ring of Q, dO, L and
    D-term tiles, one scaled-Q tile per consumer warpgroup and one
    mbarrier per stage plus one; the mma.sync kernel K and V tiles, the
    pre-scaled Q and dO tiles (rows padded by 8) and the transposed raw Q
    and dO tiles, plus L and the D-term per query row; the fp32 kernel
    unpadded K/V and Q/dO rows padded by one. The D-blocked kernels hold
    the same tiles, block_d columns wide; the FMA one also Q's and dO's
    panels of its dK / dV columns."""
    d, bq, bkv = row.block_d, row.block_q, row.block_kv
    if row.kernel in ("wgmma", "wgmma_dblk"):
        stages = bwd_kv_stages(row)
        if row.kernel == "wgmma_dblk":
            # One scaled-Q tile, the S^T hand-off buffers, four more
            # mbarriers; as a cluster the exchange slots and four more.
            x = exchange_bytes("flash_bwd_kv", row)
            return (2 * 2 * bkv * d + 2 * bq * d + x + 2 * 64 * bq * 4
                    + stages * 2 * 2 * bq * d + stages * 4 * 2 * bq
                    + 8 * (1 + 2 * stages + 4 + (4 if x else 0))
                    + _SMEM_ALIGN)
        return (2 * 2 * bkv * d + (2 * stages + 2) * 2 * bq * d
                + stages * 4 * 2 * bq + 8 * (1 + 2 * stages) + _SMEM_ALIGN)
    if in_bytes == 2:
        return (2 * (2 * bkv * (d + 8) + 2 * bq * (d + 8) + 2 * d * (bq + 8))
                + 4 * 2 * bq)
    q_tiles = 4 if row.kernel == "fma_dblk" else 2
    return 4 * (2 * bkv * d + q_tiles * bq * (d + 1) + 2 * bq)


_SMEM = {
    "flash_fwd": flash_fwd_smem_bytes,
    "flash_bwd_q": flash_bwd_q_smem_bytes,
    "flash_bwd_kv": flash_bwd_kv_smem_bytes,
}


# ---------------------------------------------------------------------------
# Candidate rows of the flash kernels (the row sweep of utils/bwd_tuning.py,
# the offline tuners and the dispatch-path autotune of utils/autotune.py)
# ---------------------------------------------------------------------------

# K1's candidates: (block_kv, most ring stages, ping-pong) of the wgmma
# row (block_q 128), and the mma.sync row (block_q 64, block_kv 64).
K1_ROWS = ((128, 3, True), (128, 2, True), (128, 3, False),
           (64, 4, True), (64, 2, True), (64, 4, False))
# (block_q, block_kv, kernel) candidates per kernel at D <= 128; block_d is
# the head dim's. K3's wgmma_dblk candidate is the head-dim-split kernel of
# the rows past D = 128 on one CTA of a 64- or 128-wide panel.
K3_ROWS = ((128, 64, "wgmma"), (128, 64, "wgmma_dblk"), (64, 64, "mma"))
K4_ROWS = ((64, 64, "wgmma"), (32, 64, "wgmma"), (32, 64, "mma"))

# The candidates past D = 128, (block_q, block_kv, block_d, kernel) per
# kernel and input type: the compiled instances of csrc/flash_fwd.cu and
# csrc/flash_bwd.cu; the mma row at D <= 256. The D-blocked first cut
# (mma_dblk, fma_dblk: a 256-wide panel, S once per two panels of 512, or
# a 128-wide one with twice the kv (K1, K3) step) and the head-dim-split
# kernels (wgmma_dblk): K1 on one CTA of a 192- or 256-wide panel (64- or
# 32-wide kv steps), on clusters of two such CTAs (64-wide steps) or of
# up to four on 128-wide panels; K3 and K4 on one CTA of a 192- or
# 256-wide panel or two of them. A wgmma_dblk candidate runs only where
# its CTAs cover D (panel_range) and TMA maps a row (bf16, D % 8 == 0).
DBLK_ROWS = {
    "flash_fwd": {"bf16": ((64, 32, 256, "mma"),
                           (64, 32, 256, "mma_dblk"),
                           (64, 64, 128, "mma_dblk"),
                           (128, 64, 128, "wgmma_dblk"),
                           (128, 64, 192, "wgmma_dblk"),
                           (128, 64, 256, "wgmma_dblk"),
                           (128, 32, 192, "wgmma_dblk"),
                           (128, 32, 256, "wgmma_dblk")),
                  "fp32": ((16, 32, 256, "fma_dblk"),
                           (16, 32, 128, "fma_dblk"))},
    "flash_bwd_q": {"bf16": ((64, 32, 256, "mma"),
                             (64, 32, 256, "mma_dblk"),
                             (64, 64, 128, "mma_dblk"),
                             (128, 32, 192, "wgmma_dblk"),
                             (128, 32, 256, "wgmma_dblk")),
                    "fp32": ((16, 32, 256, "fma_dblk"),
                             (16, 32, 128, "fma_dblk"))},
    "flash_bwd_kv": {"bf16": ((32, 64, 256, "mma"),
                              (32, 64, 256, "mma_dblk"),
                              (32, 64, 128, "mma_dblk"),
                              (32, 64, 192, "wgmma_dblk"),
                              (32, 64, 256, "wgmma_dblk")),
                     "fp32": ((32, 16, 256, "fma_dblk"),
                              (32, 16, 128, "fma_dblk"))},
}

# The tile-walk bands (tile rows) that the matmul sweep and K7's
# autotune try beside GEMM_TILE_GROUP.
GEMM_TILE_GROUPS = (1, 4, 8, 16)


def panel_range(name: str, bd: int, bkv: int = 64) -> tuple[int, int]:
    """The fewest and most CTAs a ``wgmma_dblk`` candidate of kernel
    ``name`` on ``bd``-wide panels with ``bkv``-wide kv steps runs on: one
    CTA, or a cluster of up to dblk_max_panels (their exchange slots hold
    the others' partials); K1's clusters are compiled for 64-wide kv steps
    only."""
    if name == "flash_fwd" and bkv != 64:
        return 1, 1
    return 1, dblk_max_panels(bd)


def flash_candidate_rows(kernel: str, head_dim: int,
                         in_bytes: int) -> list[ParameterRow]:
    """The rows of the flash kernel ``kernel`` (``flash_fwd``,
    ``flash_bwd_q``, ``flash_bwd_kv``) that the kernel library compiles
    for ``head_dim`` and inputs of ``in_bytes`` (2 bf16, 4 fp32), from the
    rows the sweep runs: the tables' rows, K1_ROWS / K3_ROWS / K4_ROWS on
    the 64- and 128-wide panels, and DBLK_ROWS. A row is kept where it
    covers D: one panel (``wgmma``, ``mma``, the fp32 kernel) as wide as D
    or wider; ``wgmma_dblk`` past D = 128 (K3 also at D <= 128, its
    K3_ROWS candidate) on as many CTAs as panel_range allows; the
    D-blocked first cut past D = 256. The table row for head_dim comes
    first, then the rows that differ from it in one of block_q, block_kv,
    block_d and kernel, then the others; every row has max_d head_dim. Whether TMA maps the operands
    (descriptors.launch_row) and the shared memory of a device are for
    the caller to check."""
    table = "fp32" if in_bytes == 4 else flash_bf16_table_precision(head_dim)
    first = select_row(parameter_table(kernel, table), head_dim)
    dt = "bf16" if in_bytes == 2 else "fp32"
    quads = [(r.block_q, r.block_kv, r.block_d, r.kernel)
             for p in (("bf16", "bf16_mma") if in_bytes == 2 else ("fp32",))
             for r in parameter_table(kernel, p)]
    quads += list(DBLK_ROWS[kernel][dt])
    if in_bytes == 2:
        short = {"flash_fwd": [(128, bkv, "wgmma") for bkv, _, _ in K1_ROWS],
                 "flash_bwd_q": K3_ROWS, "flash_bwd_kv": K4_ROWS}[kernel]
        quads += [(bq, bkv, bd, kern) for bq, bkv, kern in short
                  for bd in (64, 128)]
    rows = [ParameterRow(head_dim, first.block_q, first.block_kv,
                         first.block_d, first.kernel)]
    for bq, bkv, bd, kern in quads:
        row = ParameterRow(head_dim, bq, bkv, bd, kern)
        if row in rows:
            continue
        if kern == "wgmma_dblk":
            least, most = panel_range(kernel, bd, bkv)
            panels = -(-head_dim // bd)
            ok = (least <= panels <= most and head_dim % 8 == 0
                  and (head_dim > 128 or (kernel == "flash_bwd_q"
                                          and head_dim <= bd <= 128)))
        elif kern in ("mma_dblk", "fma_dblk"):
            ok = head_dim > 256
        else:
            ok = head_dim <= bd
        if ok:
            rows.append(row)
    # The table row, then the rows one axis from it, then the others.
    def axes(r):
        return (r.block_q, r.block_kv, r.block_d, r.kernel)

    return [rows[0]] + sorted(rows[1:], key=lambda r: sum(
        a != b for a, b in zip(axes(r), axes(first))) > 1)


# ---------------------------------------------------------------------------
# Split-KV decode (K5 decode_attend, K6 paged_decode)
# ---------------------------------------------------------------------------

# A K5/K6 CTA takes R consecutive cache positions (a split) of one
# (sequence, kv head) and a chunk of its query rows. R cuts a full cache
# into SPLITS splits (a power of two in [MIN, MAX]), halved while the grid
# would not give each SM one CTA. Measured on the H100 by
# utils/decode_tuning.py's sweep (R 64-1024, 128 or 256 threads): the
# fastest R at chip_smoke.py's k5 and k6 shapes (L = 2048 and 8192 at 4
# sequences, 2048 at 8) cut their caches into 8 splits; fewer splits leave
# SMs idle, more pay each CTA's fixed latency more often.
DECODE_SPLITS = 8
DECODE_SPLIT_MIN_ROWS = 64
DECODE_SPLIT_MAX_ROWS = 1024
# Threads of a K5/K6 CTA, a multiple of 32: at most 32 lanes share a
# cache row (256 beat 128 in the same sweep). decode_threads halves them
# where the FMA pair's scores would not fit.
DECODE_ATTEND_THREADS = 256
# The split-KV body's ring (csrc/decode_split.cuh): kStages tiles, kUnroll
# rows a lane group a tile (half past D = 256, two chunks a lane).
DECODE_STAGES = 3
DECODE_UNROLL = 8


@dataclass(frozen=True)
class DecodeRowLayout:
    """decode_split.cuh::RowLayout, the FMA passes' rows for a head dim
    over a storage type: ``lanes`` (W) adjacent lanes take a row of
    ``chunks`` 8-value chunks, ``chunks_per_lane`` each; a warp's
    ``run_rows`` row groups take a run of as many consecutive rows, which
    the warp copies as whole 16-byte granules into a slot of
    ``run_bytes``, the run's first byte at its cache offset mod 16; a
    chunk sits in shared memory at ``align`` bytes. At D = 8 * W
    (``exact``: D = 8 * 2^k <= 256) the kernels keep the layout before
    any D was taken: each thread copies and reads its own chunk."""

    row_bytes: int
    chunks: int
    lanes: int
    run_rows: int
    row_groups: int
    run_bytes: int
    align: int
    exact: bool

    @property
    def aligned(self) -> bool:
        return self.row_bytes % 16 == 0


    @property
    def chunks_per_lane(self) -> int:
        return -(-self.chunks // self.lanes)

    @property
    def unroll(self) -> int:
        return DECODE_UNROLL if self.chunks_per_lane == 1 else (
            DECODE_UNROLL // 2)


def decode_row_layout(head_dim: int, itemsize: int,
                      threads: int | None = None) -> DecodeRowLayout:
    """The row layout of K2/K5/K6's FMA passes at ``head_dim`` over
    storage of ``itemsize`` bytes a value (2 bf16, 1 int8 / fp8)."""
    threads = threads or DECODE_ATTEND_THREADS
    rb = head_dim * itemsize
    chunks = -(-head_dim // 8)
    lanes = 1
    while lanes < chunks and lanes < 32:
        lanes *= 2
    run_rows = 32 // lanes
    exact = head_dim == 8 * lanes
    run = (32 * 8 * itemsize if exact
           else -(-run_rows * rb // 16) * 16 + (0 if rb % 16 == 0 else 32))
    align = 16
    while rb % align:
        align //= 2
    return DecodeRowLayout(rb, chunks, lanes, run_rows, threads // lanes,
                           run, min(align, 8 * itemsize), exact)


def _decode_ring_bytes(chunk_bytes: int, unroll: int, row_groups: int,
                       group_chunk: int, scores: bool) -> int:
    """decode_split.cuh::Ring::bytes."""
    return DECODE_STAGES * unroll * (
        chunk_bytes + (row_groups * group_chunk * 4 if scores else 0)
        + row_groups * 4)


def decode_attend_union_bytes(head_dim: int, itemsize: int,
                              group_chunk: int,
                              threads: int | None = None) -> int:
    """decode_split.cuh::attend_union_bytes: the FMA attend pass's ring,
    which the warps' partial O [nw][GC][D] fp32 reuses."""
    threads = threads or DECODE_ATTEND_THREADS
    lay = decode_row_layout(head_dim, itemsize, threads)
    ring = _decode_ring_bytes(threads // 32 * lay.run_bytes, lay.unroll,
                              lay.row_groups, group_chunk, True)
    return max(ring, threads // 32 * group_chunk * head_dim * 4)


# The paths a K2/K5/K6 launch takes, by the code its wrapper hands the C
# launch (decode_split.cuh::launch_passes refuses a launch whose own
# choice is another): the FMA pair in RowLayout's general rows or in its
# exact layout, or the tensor-core pair at its copy granule.
DECODE_PATHS = {"fma": 0, "fma/exact": 1, "mma/g4": 4, "mma/g8": 8,
                "mma/g16": 16}


def decode_granule(head_dim: int, itemsize: int, *addresses: int) -> int:
    """decode_split.cuh::mma_granule: the largest of 16, 8 and 4 bytes
    dividing a cache row's bytes (D * itemsize) and every base address
    given (k and v; K6: the page pools), which every row start then
    shares; 0 where rows or bases are only 2- or 1-byte aligned."""
    a = head_dim * itemsize
    for x in addresses:
        a |= x
    return 16 if a % 16 == 0 else 8 if a % 8 == 0 else 4 if a % 4 == 0 \
        else 0


def decode_mma_width(head_dim: int, granule: int = 16) -> int:
    """DD, the values a row holds in the tensor-core pair's shared memory:
    D 64 and 128 at granule 16 have instances of their own; every other
    head dim the pair takes is padded with zeros to 128, past D 128 to
    256 and past D 256 to 512."""
    if granule == 16 and head_dim in (64, 128):
        return head_dim
    return 128 if head_dim <= 128 else 256 if head_dim <= 256 else 512


def decode_mma_chunks(width: int) -> int:
    """decode_split.cuh::mma_cpt: the 8-value chunks a thread takes of a
    row ``width`` (DD) values wide, one up to 128 and DD / 128 past it."""
    return width // 128 if width > 128 else 1


def _decode_mma_ring(head_dim: int, itemsize: int, group_chunk: int,
                     threads: int, granule: int, scores: bool) -> int:
    """decode_split.cuh::mma_ring_bytes: the ring of each thread's chunks
    of DD-wide rows (:func:`decode_mma_chunks` a thread, MmaRows) and,
    over 1-byte storage, the widened bf16 tile."""
    width = decode_mma_width(head_dim, granule)
    slots = threads * decode_mma_chunks(width)
    ring = _decode_ring_bytes(slots * 8 * itemsize, DECODE_UNROLL,
                              slots // (width // 8), group_chunk, scores)
    return ring + (DECODE_UNROLL * slots * 16 if itemsize == 1 else 0)


def decode_mma_union_bytes(head_dim: int, itemsize: int, group_chunk: int,
                           threads: int | None = None,
                           granule: int | None = None) -> int:
    """decode_split.cuh::mma_union_bytes (the tensor-core pair): the ring
    of each thread's chunks of DD-wide rows (and, fp8, the widened bf16
    tile), which the partial O of the D live columns reuses. ``granule``
    defaults to that of the row bytes alone (aligned bases)."""
    threads = threads or DECODE_ATTEND_THREADS
    if granule is None:
        granule = decode_granule(head_dim, itemsize)
    ring = _decode_mma_ring(head_dim, itemsize, group_chunk, threads,
                            granule, True)
    return max(ring, threads // 32 * group_chunk * head_dim * 4)


def decode_tensor_cores(head_dim: int, storage: torch.dtype, q_bf16: bool,
                        granule: int | None = None) -> bool:
    """Whether a launch takes the tensor-core pair (launch_passes): bf16 q
    at 64 <= D <= 512 over any storage type (bf16; int8, fp8-e4m3 and
    fp8-e5m2 widened to bf16), for K2, K5 and K6 alike, whose rows and
    bases share a copy granule of 4 bytes or more
    (:func:`decode_granule`; ``granule`` defaults to that of the row
    bytes alone, as for 16-byte aligned bases: D 250 and 302 take 4 in
    bf16 and none in int8 and fp8, D 300 8 in bf16 and 4 in int8 and
    fp8). fp32 q stays on FMA: its 2e-5 budget rules out rounding q to
    bf16."""
    if granule is None:
        granule = decode_granule(
            head_dim, torch.empty((), dtype=storage).element_size())
    return q_bf16 and 64 <= head_dim <= 512 and granule >= 4


def decode_path(head_dim: int, storage: torch.dtype, q_bf16: bool,
                granule: int | None = None) -> str:
    """The label of the path a K2, K5 or K6 launch takes, a key of
    DECODE_PATHS: "mma/g16", "mma/g8" or "mma/g4" on the tensor-core
    pair, "fma/exact" on the FMA pair at D = 8 * 2^k <= 256, "fma"
    otherwise."""
    itemsize = torch.empty((), dtype=storage).element_size()
    if granule is None:
        granule = decode_granule(head_dim, itemsize)
    if decode_tensor_cores(head_dim, storage, q_bf16, granule):
        return f"mma/g{granule}"
    return ("fma/exact" if decode_row_layout(head_dim, itemsize).exact
            else "fma")


def decode_smem_bytes(head_dim: int, storage: torch.dtype, group_chunk: int,
                      *, fused: bool = False, q_bf16: bool = True,
                      table_ints: int = 0, threads: int | None = None,
                      granule: int | None = None) -> tuple[int, int]:
    """Shared memory of the score and the attend pass of one K2/K5/K6
    call, as decode_split.cuh::launch_passes computes it (table_ints: K6's
    page ids a split, split rows / page + 2; ``granule``: as for
    :func:`decode_tensor_cores`, whose passes hold, over 1-byte storage,
    a widened bf16 tile beside their rings; ``threads`` defaults to the
    wrappers' :func:`decode_threads`)."""
    itemsize = torch.empty((), dtype=storage).element_size()
    if granule is None:
        granule = decode_granule(head_dim, itemsize)
    pair = decode_tensor_cores(head_dim, storage, q_bf16, granule)
    threads = threads or decode_threads(head_dim, group_chunk,
                                        "mma" if pair else "fma")
    nw = threads // 32
    if pair:
        ring = _decode_mma_ring(head_dim, itemsize, group_chunk, threads,
                                granule, False)
        union = decode_mma_union_bytes(head_dim, itemsize, group_chunk,
                                       threads, granule)
    else:
        lay = decode_row_layout(head_dim, itemsize, threads)
        ring = _decode_ring_bytes(nw * lay.run_bytes, lay.unroll,
                                  lay.row_groups, group_chunk, False)
        union = decode_attend_union_bytes(head_dim, itemsize, group_chunk,
                                          threads)
    table = 4 * table_ints
    score = ring + 4 * nw * group_chunk + table
    attend = (union + 4 * (group_chunk + nw * group_chunk) + 4 + table
              + (8 * group_chunk if fused else 0))
    return score, attend


def decode_group_chunk(group: int) -> int:
    """Query rows of one GQA group a K5/K6 CTA keeps in registers (the
    kernel has instances for 4 and 8)."""
    return 4 if group <= 4 else 8


def decode_threads(head_dim: int, group_chunk: int,
                   path: str = "fma") -> int:
    """Threads of a K2/K5/K6 CTA on ``path`` (a key of DECODE_PATHS):
    DECODE_ATTEND_THREADS, but 128 on the 256- and 512-wide tensor-core
    pair (D > 128: threads hold DD / 128 chunks of a row, a ring of ~100
    KB at DD 256, two CTAs an SM, and ~200 KB at DD 512, one; the C
    launch takes no other count there) and at most 128 at D <= 8 with
    query chunks of 8, where the FMA pair gives one lane a row and the
    scores of 256 row groups x 8 query rows would overflow shared memory
    (128 row groups fit)."""
    if path.startswith("mma") and head_dim > 128:
        return 128
    if head_dim <= 8 and group_chunk == 8:
        return min(DECODE_ATTEND_THREADS, 128)
    return DECODE_ATTEND_THREADS


def decode_split_rows(n: int, group: int, capacity: int,
                      device: HopperDevice = H100) -> int:
    """R, the cache positions one K5/K6 split covers, for ``n`` (sequence,
    kv head) pairs of ``group`` query rows over a cache of ``capacity``
    positions. It reads only these shapes, never the lengths, so K5 and K6
    split alike and the host never waits on the card."""
    chunks = -(-group // decode_group_chunk(group))
    rows = DECODE_SPLIT_MIN_ROWS
    while rows < DECODE_SPLIT_MAX_ROWS and rows * DECODE_SPLITS < capacity:
        rows *= 2
    while (rows > DECODE_SPLIT_MIN_ROWS
           and n * chunks * -(-capacity // rows) < device.sm_count):
        rows //= 2
    return rows


# ---------------------------------------------------------------------------
# Matrix-product tiles (K7 gemm, K8 int4_matmul)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MatmulTile:
    """One compiled tile of a matrix-product kernel: a CTA computes a
    block_m x block_n block of C with warps_m x warps_n warps, stepping K
    by block_k (K8: block_k packed bytes, i.e. 2 * block_k values of K) in
    a ring of ``stages`` shared-memory buffers. ``path`` "mma" runs
    mma.sync on 16-bit operands, "splitk" the same with the product
    transposed (K8's decode: output channels on the mma's 16-row side,
    warps_n groups of 32 channels, four warps each) and K split across
    CTAs (:func:`qmm_split_cols`), the weight streamed through a TMA ring
    of ``stages`` boxes of block_k packed bytes; "ffma" fp32 FMA,
    "wgmma" the warp-specialised persistent kernel (a producer warpgroup
    streaming a TMA ring of ``stages`` stages to warps_m consumer
    warpgroups: K7's own 64 rows of C each, K8's block_n / 2 output
    channels each, the product transposed, by block_m tokens)."""

    name: str
    block_m: int
    block_n: int
    block_k: int
    warps_m: int
    warps_n: int
    stages: int
    path: str = "mma"


# K7. Two bf16 operands that TMA can map, M > 16: the wgmma tiles, 128 x
# 256 in a 4-stage ring (192 KB) or 128 x 128 in a 6-stage ring, chosen by
# GEMMDescriptor.kernel_descriptor. fp16, bf16 operands TMA cannot map
# (kernels/gemm_kernel.py::tma_mappable) and a decode-sized M (4-16 rows)
# keep mma.sync m16n8k16: a 128 x 128 tile for problems that fill the
# card, 64 x 64 where 128-tiles would leave SMs idle, a 16-row tile.
# fp32 and mixed operands: one FMA tile, 256 threads of 4 x 4 outputs.
# (The mma.sync and FMA tiles are not tuned on the H100.)
GEMM_TILES = {
    "w256": MatmulTile("w256", 128, 256, 64, 2, 1, 4, "wgmma"),
    "w128": MatmulTile("w128", 128, 128, 64, 2, 1, 6, "wgmma"),
    "m128": MatmulTile("m128", 128, 128, 32, 2, 4, 3),
    "m64": MatmulTile("m64", 64, 64, 32, 2, 2, 3),
    "m16": MatmulTile("m16", 16, 64, 64, 1, 4, 3),
    "ffma": MatmulTile("ffma", 64, 64, 16, 4, 2, 1, "ffma"),
}
# The wgmma kernels' persistent CTAs walk output tiles in bands of this
# many tile rows (K8: channel tiles), column by column within a band, so
# that the CTAs in flight share their operand tiles in L2. Read at each
# call.
GEMM_TILE_GROUP = 8

# K8, bf16 activations. Decode (M = slots <= 8 or 16): the transposed
# product over 64 output channels a CTA (eight warps: two groups of 32
# channels, four warps each taking a quarter of every stage), K split across
# CTAs by qmm_split_cols, the weight streamed 128 packed bytes (256 values
# of K) a channel per stage through a 2-stage TMA ring. Prefill (M > 16): the
# wgmma tiles, 128 tokens by 128 channels (a 4-stage ring) or by 256 (a
# 3-stage ring; it reads 40% fewer operand bytes a product, 10-12% faster
# wherever its tiles fill the card), 64 packed bytes a step, chosen by
# kernels/quant_matmul.py::int4_tile; fewer stages measured no faster,
# and the wgmma tile beat a 64 x 128 mma.sync tile at every M from 17 to
# 2048 on the H100. fp32 activations: the FMA tile (not tuned on the
# H100).
QMM_TILES = {
    "d8": MatmulTile("d8", 8, 64, 128, 1, 2, 2, "splitk"),
    "d16": MatmulTile("d16", 16, 64, 128, 1, 2, 2, "splitk"),
    "w128": MatmulTile("w128", 128, 128, 64, 2, 1, 4, "wgmma"),
    "w256": MatmulTile("w256", 128, 256, 64, 2, 1, 3, "wgmma"),
    "ffma": MatmulTile("ffma", 64, 64, 16, 4, 2, 1, "ffma"),
}


# K8's decode tiles split K/2 packed columns into splits of a multiple of
# block_k, at most QMM_SPLIT_MAX_COLS (x's two slices of a split stay in
# shared memory), so that the grid (channel tiles x splits) holds about
# QMM_SPLIT_CTAS_PER_SM CTAs an SM where K allows. Read at each call.
# Measured on the H100 by utils/bwd_tuning.py sweep --only qmm_decode:
# with the tiles' 2-stage ring, 4 CTAs an SM takes a Llama-3-8B layer's
# seven projections within 1.2% of the fastest of ring depths 2-4 and 2,
# 4 or 8 CTAs an SM, at M 4 and 16, both layouts (deeper rings leave room
# for fewer CTAs an SM and ran slower).
QMM_SPLIT_CTAS_PER_SM = 4
QMM_SPLIT_MAX_COLS = 1024


def qmm_split_cols(n: int, k: int, tile: MatmulTile,
                   device: HopperDevice = H100) -> int:
    """Packed columns (of K/2) that one split of K8's decode tile covers,
    for N output channels and K inputs; from these shapes and the SM
    count alone. The splits are ceil(K / 2 / cols)."""
    steps = -(-(k // 2) // tile.block_k)
    tiles = -(-n // tile.block_n)
    want = -(-QMM_SPLIT_CTAS_PER_SM * device.sm_count // tiles)
    splits = max(-(-steps // (QMM_SPLIT_MAX_COLS // tile.block_k)),
                 min(steps, want))
    return -(-steps // splits) * tile.block_k


def persistent_rounds(tiles: int, tile_area: int,
                      device: HopperDevice) -> int:
    """Rounds of one tile an SM that a persistent walk over ``tiles``
    tiles takes, times the tile's area: proportional to its time. K7's
    and K8's wgmma tiles are chosen by the least (ties to the larger tile,
    which reads each operand fewer times)."""
    return -(-tiles // device.sm_count) * tile_area


def gemm_smem_bytes(tile: MatmulTile, transpose_a: bool = False,
                    transpose_b: bool = False) -> int:
    """Shared memory of one K7 CTA (as csrc/gemm.cu lays it out). wgmma:
    per stage the A and B tiles as unpadded swizzled panels and a full and
    an empty mbarrier, plus the slack that aligns the ring to the
    1024-byte swizzle atom. mma.sync: per stage the A and B tiles in their
    stored orientation, the contiguous dimension padded by 8 elements
    (bank spread)."""
    bm, bn, bk = tile.block_m, tile.block_n, tile.block_k
    if tile.path == "ffma":
        return ffma_smem_bytes(tile)
    if tile.path == "wgmma":
        return tile.stages * ((bm + bn) * bk * 2 + 16) + _SMEM_ALIGN
    a = bk * (bm + 8) if transpose_a else bm * (bk + 8)
    b = bn * (bk + 8) if transpose_b else bk * (bn + 8)
    return 2 * tile.stages * (a + b)


def qmm_smem_bytes(tile: MatmulTile, split_cols: int = QMM_SPLIT_MAX_COLS,
                   rows: int | None = None) -> int:
    """Shared memory of one K8 CTA (csrc/quant_matmul.cu). wgmma: per
    stage x's two K slices [block_m, block_k] bf16 and the packed tile
    [block_n, block_k] bytes, unpadded and swizzled, and a full and an
    empty mbarrier; the epilogue's staging tile [block_m, block_n + 8]
    bf16; the slack that aligns the ring to the 1024-byte swizzle atom.
    splitk (a split of ``split_cols`` packed columns, ``rows`` tokens,
    at most block_m): per stage the packed box [block_n, block_k] bytes
    and its mbarrier, x's two slices [rows, 2 * split_cols + 16] bf16,
    each k-quarter's row sums [4, block_m] fp32, a flag, and the same
    slack."""
    if tile.path == "ffma":
        return ffma_smem_bytes(tile)
    bm, bn, bk = tile.block_m, tile.block_n, tile.block_k
    if tile.path == "wgmma":
        return (tile.stages * (2 * bm * bk * 2 + bn * bk + 16)
                + bm * (bn + 8) * 2 + _SMEM_ALIGN)
    return (_SMEM_ALIGN + tile.stages * (bn * bk + 8)
            + (rows or bm) * (2 * split_cols + 16) * 2 + 16 * bm + 4)


def ffma_smem_bytes(tile: MatmulTile) -> int:
    """The FMA tile (csrc/matmul.cuh): fp32 A and B tiles, k-major, A's
    rows padded by 4; the next step waits in registers."""
    return 4 * tile.block_k * (tile.block_m + 4 + tile.block_n)


def check_tile_fits(smem: int, tile: MatmulTile,
                    device: HopperDevice) -> None:
    if smem > device.smem_per_block:
        raise ValueError(f"tile {tile} needs {smem} bytes of shared memory, "
                         f"{device.name} gives {device.smem_per_block}")
