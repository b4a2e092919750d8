"""The backward kernels' (K3 ``flash_bwd_q``, K4 ``flash_bwd_kv``)
parameter rows and dispatch on the CPU: the rows parse and fit one SM,
descriptors and :func:`launch_row` pick the kernel the source says, and
the wrappers hand the kernel library a launch for any number of heads
(recorded by a stand-in library over meta tensors; no kernel runs
here)."""

import dataclasses
import pathlib
import re
import types

import pytest
import torch

from mfa_tpu_torch.kernels import build
from mfa_tpu_torch.kernels import flash_bwd as k34
from mfa_tpu_torch.ops import params
from mfa_tpu_torch.utils import bwd_tuning
from mfa_tpu_torch.ops.descriptors import (
    KERNEL_CODES,
    AttentionDescriptor,
    AttentionKernelType,
    head_dim_panels,
)

_BWD = (AttentionKernelType.BACKWARD_QUERY,
        AttentionKernelType.BACKWARD_KEY_VALUE)


def _kd(kind, d, bf16=True, hq=4, hkv=2, n=64):
    return AttentionDescriptor(
        batch=1, num_q_heads=hq, num_kv_heads=hkv, seq_len_q=n,
        seq_len_kv=n, head_dim=d, causal=True, low_precision_inputs=bf16,
        low_precision_intermediates=bf16).kernel_descriptor(kind)


@pytest.mark.parametrize("kernel", ["flash_bwd_q", "flash_bwd_kv"])
@pytest.mark.parametrize("precision", ["bf16", "bf16_mma", "fp32"])
def test_rows_parse_and_fit_one_sm(kernel, precision):
    rows = params.parameter_table(kernel, precision)
    in_bytes = 4 if precision == "fp32" else 2
    for row in rows:
        assert row.kernel in (("", "fma_dblk") if precision == "fp32"
                              else params.ROW_KERNELS)
        assert params.smem_bytes(kernel, row, in_bytes) \
            <= params.H100.smem_per_block
    if precision == "bf16_mma":
        assert {r.kernel for r in rows} == {"mma", "mma_dblk"}


def test_wgmma_rows_cover_d_up_to_128_and_mma_the_rest():
    """bf16 rows TMA can map (D % 8 == 0) up to D = 128 run wgmma; from
    D 136 to 256 the head-dim-split kernel on one CTA (a 192-wide panel
    up to D = 192, a 256-wide one up to 256); the head dims TMA cannot
    map keep mma.sync (the bf16_mma table)."""
    for kernel in ("flash_bwd_q", "flash_bwd_kv"):
        rows = params.parameter_table(kernel, "bf16")
        for d in (8, 32, 64, 96, 128):
            row = params.select_row(rows, d)
            assert row.kernel == "wgmma" and row.block_d in (64, 128)
            assert d <= row.block_d
        for d in (136, 160, 192, 200, 256):
            row = params.select_row(rows, d)
            assert row.kernel == "wgmma_dblk"
            assert row.block_d == (192 if d <= 192 else 256)
            assert head_dim_panels(row, d) == 1
        for d in (136, 256):
            assert params.select_row(params.parameter_table(
                kernel, "bf16_mma"), d).kernel == "mma"
    for d in (4, 36, 100, 130):
        assert params.bf16_table_precision(d) == "bf16_mma"
    for d in (8, 64, 96, 128, 256):
        assert params.bf16_table_precision(d) == "bf16"
    # K3's wgmma CTA is two consumer warpgroups of 64 query rows; K4's
    # owns 64 kv rows.
    for row in params.parameter_table("flash_bwd_q", "bf16")[:2]:
        assert row.kernel == "wgmma" and row.block_q == 128
    for row in params.parameter_table("flash_bwd_kv", "bf16")[:2]:
        assert row.kernel == "wgmma" and row.block_kv == 64
        assert row.block_q in (32, 64)


def test_smem_reckons_the_launch_code():
    """csrc/flash_bwd.cu's QWgmmaSmem / KvWgmmaSmem at D = 128: rings as
    deep as the H100's shared memory allows, up to 4."""
    q = params.ParameterRow(128, 128, 64, 128, "wgmma")
    assert params.bwd_q_stages(q) == 4
    # Q and dO (128 x 128 bf16), 4 stages of K and V (64 x 128), L and D
    # (128 fp32 each), 9 mbarriers, 1024 bytes of alignment slack.
    assert params.flash_bwd_q_smem_bytes(q, 2) == (
        2 * 32768 + 4 * 2 * 16384 + 2 * 512 + 9 * 8 + 1024)
    kv = params.ParameterRow(128, 32, 64, 128, "wgmma")
    assert params.bwd_kv_stages(kv) == 4
    # K and V (64 x 128), 4 stages of Q and dO (32 x 128), two scaled-Q
    # tiles, 4 stages of L and D (32 fp32 each), 9 mbarriers, slack.
    assert params.flash_bwd_kv_smem_bytes(kv, 2) == (
        2 * 16384 + (2 * 4 + 2) * 8192 + 4 * 2 * 128 + 9 * 8 + 1024)
    assert params.bwd_kv_stages(params.ParameterRow(128, 64, 64, 128,
                                                    "wgmma")) == 4
    for kernel in ("flash_bwd_q", "flash_bwd_kv"):
        for row in params.parameter_table(kernel, "bf16"):
            if row.kernel == "wgmma":
                stages = (params.bwd_q_stages(row) if kernel == "flash_bwd_q"
                          else params.bwd_kv_stages(row))
                assert stages >= 2


def test_parse_takes_a_kernel_column_and_refuses_others():
    rows = params.parse_table("64 | 1 | 2 | 64 | wgmma\ninf | 4 | 5 | 6")
    assert [r.kernel for r in rows] == ["wgmma", ""]
    with pytest.raises(ValueError, match="malformed"):
        params.parse_table("inf | 4 | 5 | 6 | tma")


@pytest.mark.parametrize("d, kernel", [
    (32, "wgmma"), (64, "wgmma"), (96, "wgmma"), (128, "wgmma"),
    (160, "wgmma_dblk"), (192, "wgmma_dblk"), (256, "wgmma_dblk"),
    (36, "wgmma"), (40 + 2, "wgmma"), (100, "wgmma"), (250, "wgmma_dblk"),
    (264, "wgmma_dblk"), (384, "wgmma_dblk"), (512, "wgmma_dblk"),
    (300, "mma_dblk"), (1024, "mma_dblk"), (37, "mma"), (101, "mma")])
def test_descriptors_dispatch_as_the_source_says(d, kernel):
    """bf16 at D <= 128 runs the wgmma kernels, from D 136 to 512 the
    head-dim-split kernels (K3 and K4 alike: one CTA up to D = 256, a
    cluster of two past it); up to D = 256 that includes the even D whose
    rows TMA cannot map (D % 8 != 0), which launch on the same kernels
    with the copying producer (as K1); odd D runs the mma.sync kernel,
    and a D % 8 != 0 past 256 the D-blocked one, as every D past 512."""
    for kind in _BWD:
        kd = _kd(kind, d)
        assert kd.kernel == kernel
        assert k34.launch_row(kd, d, ()).kernel == kernel
        assert d <= kd.block_d * head_dim_panels(kd, d)
        if kernel == "wgmma_dblk":
            assert head_dim_panels(kd, d) == (1 if d <= 256 else 2)
    assert _kd(_BWD[0], 100).block_d == 128     # the wgmma row of its D
    assert _kd(_BWD[1], 36).block_q == 64       # K4's wgmma row to D 64
    assert _kd(_BWD[1], 37).block_q == 32       # K4's mma row


# The rows each D <= 256 selects: (block_q, block_kv, block_d, kernel)
# of the row it falls in (bf16 past D = 128: the head-dim-split rows).
ROWS_UP_TO_256 = {
    ("flash_bwd_q", "bf16"): {64: (128, 64, 64, "wgmma"),
                              128: (128, 64, 128, "wgmma"),
                              192: (128, 32, 192, "wgmma_dblk"),
                              256: (128, 32, 256, "wgmma_dblk")},
    ("flash_bwd_q", "bf16_mma"): {36: (64, 64, 64, "mma"),
                                  100: (64, 64, 128, "mma"),
                                  250: (64, 32, 256, "mma")},
    ("flash_bwd_q", "fp32"): {64: (16, 32, 64, ""), 200: (16, 32, 256, "")},
    ("flash_bwd_kv", "bf16"): {64: (64, 64, 64, "wgmma"),
                               128: (32, 64, 128, "wgmma"),
                               192: (32, 64, 192, "wgmma_dblk"),
                               256: (32, 64, 256, "wgmma_dblk")},
    ("flash_bwd_kv", "bf16_mma"): {36: (32, 64, 64, "mma"),
                                   100: (32, 64, 128, "mma"),
                                   250: (32, 64, 256, "mma")},
    ("flash_bwd_kv", "fp32"): {64: (32, 16, 64, ""),
                               200: (32, 16, 256, "")},
}


@pytest.mark.parametrize("kernel, precision", sorted(ROWS_UP_TO_256))
def test_head_dims_past_256_take_the_d_blocked_rows(kernel, precision):
    """D 384, 512 and 1024 (and the tails 300, 320) select a D-blocked
    row whose block_d panel is smaller than D (bf16 up to D = 512: the
    head-dim-split rows, K3's and K4's alike); every D <= 256 selects its
    row of ROWS_UP_TO_256; the smem of each D-blocked row is the launch
    code's (csrc/flash_bwd.cu launch_q_* / launch_kv_*: the first-cut
    kernel's tiles at block_d, plus, on FMA, K's panel of the dQ columns
    (K3) or Q's and dO's of the dK / dV columns (K4); the split kernels'
    QSplitSmem / KvSplitSmem) and fits one SM whatever the head dim."""
    rows = params.parameter_table(kernel, precision)
    for d in (264, 300, 320, 384, 512, 1024):
        row = params.select_row(rows, d)
        want_kernel = ("fma_dblk" if precision == "fp32"
                       else "wgmma_dblk" if (precision, d <= 512)
                       == ("bf16", True) else "mma_dblk")
        assert row.kernel == want_kernel and row.block_d < d
        assert (row.max_d == 384) == (d <= 384)
        bq, bkv, bd = row.block_q, row.block_kv, row.block_d
        if row.kernel == "wgmma_dblk":
            want = (_split_q_smem(row) if kernel == "flash_bwd_q"
                    else _cluster_kv_smem(row))
            got = params.smem_bytes(kernel, row, 2)
        elif precision == "fp32":
            want = 4 * (2 * bq * bd + 3 * bkv * (bd + 1) + 2 * bq
                        if kernel == "flash_bwd_q"
                        else 2 * bkv * bd + 4 * bq * (bd + 1) + 2 * bq)
            got = params.smem_bytes(kernel, row, 4)
        else:
            want = 4 * 2 * bq + 2 * (
                2 * bq * (bd + 8) + 2 * bkv * (bd + 8) + bd * (bkv + 8)
                if kernel == "flash_bwd_q"
                else 2 * bkv * (bd + 8) + 2 * bq * (bd + 8)
                + 2 * bd * (bq + 8))
            got = params.smem_bytes(kernel, row, 2)
        assert got == want <= params.H100.smem_per_block
    for d, want in ROWS_UP_TO_256[(kernel, precision)].items():
        row = params.select_row(rows, d)
        assert (row.block_q, row.block_kv, row.block_d, row.kernel) == want


@pytest.mark.parametrize("d", [384, 512, 1024, 264, 320, 160, 192, 256])
def test_wrappers_pass_the_d_blocked_launch(library, d):
    """Above D = 128 both wrappers launch over ceil(D / block_d) head-dim
    panels: the head-dim-split kernel (code 3, a CTA a panel: one up to D
    = 256, a cluster of two past it) up to D = 512, the D-blocked one
    (code 2) beyond."""
    q3, o3, do3 = (_meta(4, 32, d) for _ in range(3))
    kv = _meta(2, 32, d)
    lse = _meta(4, 32, dtype=torch.float32)
    kw = dict(group=2, scale=0.125)
    kd_q, kd_kv = (_kd(kind, d, n=32) for kind in _BWD)
    dq, dterm = k34.flash_bwd_q(q3, kv, kv, o3, do3, lse, kd_q, **kw)
    dk, dv = k34.flash_bwd_kv(q3, kv, kv, do3, lse, dterm, kd_kv, **kw)
    assert dq.shape == (4, 32, d) and dk.shape == dv.shape == (2, 32, d)
    (_, args3), (_, args4) = library.calls
    kernel = "wgmma_dblk" if d <= 512 else "mma_dblk"
    for args, kd in ((args3, kd_q), (args4, kd_kv)):
        assert kd.kernel == kernel
        assert args[12:14] == (d, -(-d // kd.block_d))
        assert args[-6:-1] == (KERNEL_CODES[kernel], kd.block_q,
                               kd.block_kv, kd.block_d, 0)
    panels = 1 if d <= 256 else 2
    assert (args3[13], args4[13]) == ((panels, panels) if d <= 512
                                      else (8, 4))


def test_fp32_and_forward_rows_name_no_kernel():
    """fp32 rows of every flash kernel, the forward's included, name no
    kernel (the forward's bf16 rows do: tests/test_torch_flash_fwd_rows.py)."""
    for kind in AttentionKernelType:
        assert _kd(kind, 64, bf16=False).kernel == ""


def test_misaligned_operand_takes_the_mma_row():
    """TMA needs 16-byte-aligned bases: a view two bytes into its storage
    runs the mma.sync row of its head dim."""
    buf = torch.zeros(4 * 64 * 64 + 1, dtype=torch.bfloat16)
    aligned = buf[:-1].view(4, 64, 64)
    shifted = buf[1:].view(4, 64, 64)
    for kind in _BWD:
        kd = _kd(kind, 64)
        assert k34.launch_row(kd, 64, (aligned, aligned)).kernel == "wgmma"
        row = k34.launch_row(kd, 64, (aligned, shifted))
        table = ("flash_bwd_q" if kind is AttentionKernelType.BACKWARD_QUERY
                 else "flash_bwd_kv")
        assert row == params.select_row(
            params.parameter_table(table, "bf16_mma"), 64)


class _Library:
    """Records the calls a wrapper makes instead of launching."""

    def __init__(self):
        self.calls = []

    def call(self, name, *args):
        self.calls.append((name, args))


@pytest.fixture
def library(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(build, "library", lambda: lib)
    # Meta tensors stand in for CUDA tensors past the device check.
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    return lib


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("heads", [1, 65_535, 65_536, 70_000, 200_000])
def test_wrappers_take_any_number_of_heads(library, heads):
    """Blocks and heads share grid.x: no 65535 limit on batch * heads."""
    n, d = 16, 64
    q3, o3, do3 = (_meta(heads, n, d) for _ in range(3))
    kv = _meta(heads, n, d)
    lse = _meta(heads, n, dtype=torch.float32)
    kw = dict(group=1, scale=0.125)
    kd_q = _kd(_BWD[0], d, hq=heads, hkv=heads, n=n)
    kd_kv = _kd(_BWD[1], d, hq=heads, hkv=heads, n=n)
    n3, n4 = k34.flash_bwd_q.launches, k34.flash_bwd_kv.launches
    dq, dterm = k34.flash_bwd_q(q3, kv, kv, o3, do3, lse, kd_q, **kw)
    dk, dv = k34.flash_bwd_kv(q3, kv, kv, do3, lse, dterm, kd_kv, **kw)
    assert (k34.flash_bwd_q.launches, k34.flash_bwd_kv.launches) == (n3 + 1,
                                                                     n4 + 1)
    assert dq.shape == (heads, n, d) and dk.shape == (heads, n, d)
    (name3, args3), (name4, args4) = library.calls
    assert (name3, name4) == ("mfa_flash_bwd_q", "mfa_flash_bwd_kv")
    # (kernel code, block_q, block_kv, block_d, producer) before the
    # stream: TMA's.
    assert args3[-6:-1] == (1, 128, 64, 64, 0)
    assert args4[-6:-1] == (1, 64, 64, 64, 0)
    assert args3[8] == heads and args4[8] == heads


@pytest.mark.parametrize("d", [64, 128])
def test_k3_split_candidate_at_d_up_to_128_passes_one_panel(library, d):
    """The sweep's head-dim-split candidate at D <= 128 (bwd_tuning.K3_ROWS:
    flash_bwd_q_split<64, d, CL false>) reaches the library as kernel code
    3 on one panel of d columns, and its layout fits one SM with a K ring
    of at least two stages."""
    n = 256
    q3, o3, do3, k3 = (_meta(4, n, d) for _ in range(4))
    lse = _meta(4, n, dtype=torch.float32)
    kd = dataclasses.replace(_kd(_BWD[0], d, hq=4, hkv=4, n=n),
                             kernel="wgmma_dblk")
    assert (128, 64, "wgmma_dblk") in bwd_tuning.K3_ROWS
    assert (kd.block_q, kd.block_kv, kd.block_d) == (128, 64, d)
    k34.flash_bwd_q(q3, k3, k3, o3, do3, lse, kd, group=1, scale=0.125)
    ((name, args),) = library.calls
    assert name == "mfa_flash_bwd_q"
    assert args[12:14] == (d, 1)
    assert args[-6:-1] == (3, 128, 64, d, 0)
    row = params.ParameterRow(d, 128, 64, d, "wgmma_dblk")
    assert params.exchange_bytes("flash_bwd_q", row) == 0
    assert params.smem_bytes("flash_bwd_q", row, 2) == _split_q_smem(row) \
        <= params.H100.smem_per_block


def _cluster_kv_smem(row):
    """csrc/flash_bwd.cu's KvSplitSmem, K4's head-dim-split kernel at a
    bf16 row: K and V, one scaled-Q tile, two S^T buffers of 64 x block_q
    fp32 and, as a cluster of two, one exchange slot a warpgroup of the
    same size; up to 4 stages of Q, dO, L and the D-term; 1 + 2 stages + 4
    (+ 4 in a cluster) mbarriers, alignment slack."""
    bq, bkv, bd = row.block_q, row.block_kv, row.block_d
    cluster = params.row_panels(row) > 1
    tile_q = bq * bd * 2
    x = 2 * 64 * bq * 4 if cluster else 0
    bars = 1 + 4 + (4 if cluster else 0)
    fixed = 2 * bkv * bd * 2 + tile_q + x + 2 * 64 * bq * 4
    stages = min((params.H100.smem_per_block - fixed - 8 * bars - 1024)
                 // (2 * tile_q + 8 * bq + 16), 4)
    assert params.bwd_kv_stages(row) == stages >= 2
    assert params.exchange_bytes("flash_bwd_kv", row) == x
    return (fixed + stages * (2 * tile_q + 8 * bq)
            + 8 * (2 * stages + bars) + 1024)


@pytest.mark.parametrize("block_d", [192, 256])
def test_cluster_smem_reckons_the_launch_code(block_d):
    """K4's compiled cluster instances (block_q 32, a 192- or 256-wide
    panel, clusters of two): shared memory, exchange buffers included, is
    the launch code's and fits the H100."""
    row = params.ParameterRow(2 * block_d, 32, 64, block_d, "wgmma_dblk")
    assert params.dblk_max_panels(block_d) == 2
    assert params.smem_bytes("flash_bwd_kv", row, 2) == _cluster_kv_smem(row)
    assert params.smem_bytes("flash_bwd_kv", row, 2) \
        <= params.H100.smem_per_block


@pytest.mark.parametrize("block_d", [192, 256])
def test_one_cta_kv_smem_reckons_the_launch_code(block_d):
    """K4's compiled one-CTA instances (flash_bwd_kv_split<32, block_d,
    CL false>: no exchange slots and none of their mbarriers): shared
    memory is the launch code's, fits the H100 and holds a ring of 4
    stages, one more at D 256 than the same row's cluster CTA."""
    row = params.ParameterRow(block_d, 32, 64, block_d, "wgmma_dblk")
    assert params.row_panels(row) == 1
    assert params.exchange_bytes("flash_bwd_kv", row) == 0
    assert params.smem_bytes("flash_bwd_kv", row, 2) == _cluster_kv_smem(row)
    assert params.smem_bytes("flash_bwd_kv", row, 2) \
        <= params.H100.smem_per_block
    assert params.bwd_kv_stages(row) == 4
    cluster = params.ParameterRow(2 * block_d, 32, 64, block_d, "wgmma_dblk")
    assert params.bwd_kv_stages(cluster) == (3 if block_d == 256 else 4)


def _split_q_smem(row):
    """csrc/flash_bwd.cu's QSplitSmem, K3's head-dim-split kernel at a bf16
    row: Q and dO (128 x block_d), as a cluster of two one exchange slot
    a warpgroup of its partial S and dP (two 64 x block_kv fp32), L and
    the D-term, then as many K and V tiles as fit (two mbarriers each) in
    a K ring of up to 4 that leaves V one, and a V ring of the rest up to
    4; 1 (+ 4 in a cluster) more mbarriers, alignment slack."""
    bq, bkv, bd = row.block_q, row.block_kv, row.block_d
    cluster = -(-row.max_d // bd) > 1
    x = 2 * 2 * 64 * bkv * 4 if cluster else 0
    bars = 4 if cluster else 0
    fixed = 2 * bq * bd * 2 + x + 8 * bq
    tile = bkv * bd * 2
    tiles = (params.H100.smem_per_block - fixed - 8 * (1 + bars)
             - 1024) // (tile + 16)
    sv = min(max(tiles - 4, 1), 4)
    sk = min(tiles - sv, 4)
    assert params.bwd_q_split_stages(row) == (sk, sv) and sk >= 2
    return fixed + (sk + sv) * (tile + 16) + 8 * (1 + bars) + 1024


@pytest.mark.parametrize("block_d, panels, rings", [
    (192, 1, (4, 4)), (192, 2, (4, 4)), (256, 1, (4, 2)), (256, 2, (3, 1))])
def test_k3_split_smem_reckons_the_launch_code(block_d, panels, rings):
    """K3's compiled head-dim-split instances (flash_bwd_q_split<32,
    block_d, CL>: one CTA, or CL a cluster of two with its exchange
    slots): shared memory is the launch code's and fits the H100, with
    the K and V rings ``rings`` deep (K's at least two: a step's tile
    stays until the next step's deferred dQ product has read it)."""
    row = params.ParameterRow(panels * block_d, 128, 32, block_d,
                              "wgmma_dblk")
    assert params.row_panels(row) == panels
    assert params.exchange_bytes("flash_bwd_q", row) == (
        0 if panels == 1 else 4 * 64 * 32 * 4)
    assert params.smem_bytes("flash_bwd_q", row, 2) == _split_q_smem(row)
    assert params.smem_bytes("flash_bwd_q", row, 2) \
        <= params.H100.smem_per_block
    assert params.bwd_q_split_stages(row) == rings


def test_k3_keeps_the_d_blocked_rows_past_256():
    """K3 and K4 name the same head-dim-split rows in the bf16 tables: one
    CTA on a 192- or 256-wide panel at max_d 192 and 256, clusters of two
    at 384 and 512, the D-blocked first cut past D = 512; the bf16_mma
    (operands TMA cannot map) and fp32 tables keep the first cut
    (mma_dblk, fma_dblk) past D = 256."""
    for kernel in ("flash_bwd_q", "flash_bwd_kv"):
        rows = params.parameter_table(kernel, "bf16")
        split = [r for r in rows if r.kernel == "wgmma_dblk"]
        assert [(r.max_d, r.block_d, params.row_panels(r))
                for r in split] == [(192, 192, 1), (256, 256, 1),
                                    (384, 192, 2), (512, 256, 2)]
        assert rows[-1].kernel == "mma_dblk" and rows[-1].max_d == 0
        for precision in ("bf16_mma", "fp32"):
            past = [r for r in params.parameter_table(kernel, precision)
                    if r.max_d == 0 or r.max_d > 256]
            assert {r.kernel for r in past} == {
                "mma_dblk" if precision == "bf16_mma" else "fma_dblk"}
    for row in params.parameter_table("flash_bwd_q", "bf16"):
        if row.kernel == "wgmma_dblk":
            assert row.block_q == 128 and row.block_kv == 32


@pytest.mark.parametrize("d", [384, 512, 192, 256])
def test_misaligned_cluster_operand_takes_the_mma_dblk_row(library, d):
    """K3 and K4 at D 384 and 512 (and at 192 and 256) with a dO TMA
    cannot map (a view two bytes into its storage) launch the bf16_mma
    table's row of their head dim: the D-blocked kernel (code 2) over
    that row's panels (the mma.sync kernel, code 0, one panel, up to D =
    256)."""
    class Shifted(torch.Tensor):
        def data_ptr(self):
            return super().data_ptr() + 2

    shifted = _meta(4, 32, d).as_subclass(Shifted)
    q3, kv = _meta(4, 32, d), _meta(2, 32, d)
    lse = _meta(4, 32, dtype=torch.float32)
    kd_q, kd_kv = (_kd(kind, d, n=32) for kind in _BWD)
    for kd in (kd_q, kd_kv):
        assert kd.kernel == "wgmma_dblk"
        assert k34.launch_row(kd, d, (q3, kv, kv, shifted)).kernel == (
            "mma_dblk" if d > 256 else "mma")
    k34.flash_bwd_q(q3, kv, kv, q3, shifted, lse, kd_q, group=2,
                    scale=0.125)
    k34.flash_bwd_kv(q3, kv, kv, shifted, lse, lse, kd_kv, group=2,
                     scale=0.125)
    for (_, args), table in zip(library.calls,
                                ("flash_bwd_q", "flash_bwd_kv")):
        row = params.select_row(params.parameter_table(table, "bf16_mma"), d)
        assert args[12:14] == (d, -(-d // row.block_d) if d > 256 else 1)
        assert args[-6:-1] == (2 if d > 256 else 0, row.block_q,
                               row.block_kv, row.block_d, 0)


# ---------------------------------------------------------------------------
# The copying producer (rows TMA cannot map: D % 8 != 0, bases off 16)
# ---------------------------------------------------------------------------

def _copying_instances(kernel):
    """(block_q, block_kv, block_d) of every instance with the copying
    producer that csrc/flash_bwd.cu compiles (launch_q_copying,
    launch_kv_copying)."""
    src = (pathlib.Path(__file__).resolve().parents[1] / "mfa_tpu_torch"
           / "csrc" / "flash_bwd.cu").read_text()
    if kernel == "flash_bwd_q":
        return {(128, int(a), int(b)) for a, b in re.findall(
            r"launch_q_(?:wgmma|split)<(\d+), (\d+),(?: false,)? kCopy>",
            src)}
    return {(int(a), 64, int(b)) for a, b in re.findall(
        r"launch_kv_(?:wgmma|split)<(\d+), (\d+),(?: false,)? kCopy>", src)}


@pytest.mark.parametrize("kernel", ["flash_bwd_q", "flash_bwd_kv"])
def test_copying_rows_have_a_compiled_instance(kernel):
    """The C entries compile one copying instance for each bf16 table row
    up to D 256, and params.COPY_ROWS names exactly those."""
    table = {(r.block_q, r.block_kv, r.block_d)
             for r in params.parameter_table(kernel, "bf16")
             if 0 < r.max_d <= 256}
    assert _copying_instances(kernel) == table == set(
        params.COPY_ROWS[kernel])


def _copy_smem(kernel, row, stages):
    """csrc/flash_bwd.cu's layouts at the copying producer's ring depth
    ``stages`` (the TMA layouts at that depth): K3's
    QWgmmaSmem (Q, dO, L, D-term, then ``stages`` K + V tiles, an mbarrier
    pair a stage) and one-CTA QSplitSmem (the K and V rings ``stages``
    tiles each, a pair a tile); K4's KvWgmmaSmem (K, V, then ``stages`` Q
    + dO tiles with their L and D-term, two scaled-Q tiles, a pair a
    stage) and one-CTA KvSplitSmem (K, V, one scaled-Q tile, two S^T
    buffers, the ring, a pair a stage and four more); one more mbarrier
    and the alignment slack each."""
    bq, bkv, bd = row.block_q, row.block_kv, row.block_d
    tq, tkv = bq * bd * 2, bkv * bd * 2
    if kernel == "flash_bwd_q":
        fixed = 2 * tq + 8 * bq
        bars = 1 + (2 if row.kernel == "wgmma" else 4) * stages
        return fixed + 2 * stages * tkv + 8 * bars + 1024
    if row.kernel == "wgmma":
        return (2 * tkv + (2 * stages + 2) * tq + stages * 8 * bq
                + 8 * (1 + 2 * stages) + 1024)
    return (2 * tkv + tq + 2 * 64 * bq * 4 + stages * (2 * tq + 8 * bq)
            + 8 * (2 * stages + 5) + 1024)


@pytest.mark.parametrize("kernel", ["flash_bwd_q", "flash_bwd_kv"])
@pytest.mark.parametrize("most", [2, 3, 4])
def test_copy_smem_reckons_the_launch_code(monkeypatch, kernel, most):
    """Every compiled copying instance, at each depth the sweep builds:
    the ring depth it compiles to (params.bwd_copy_stages: at most
    BWD_Q_COPY_RING_STAGES, or
    BWD_KV_COPY_RING_STAGES a consumer warpgroup, as many as fit; on K4's
    wgmma kernel, whose warpgroups take alternate steps, an even number,
    4 or more; elsewhere two or more) and the shared memory the launch
    code lays out at that depth, within the H100."""
    attr = ("BWD_Q_COPY_RING_STAGES" if kernel == "flash_bwd_q"
            else "BWD_KV_COPY_RING_STAGES")
    monkeypatch.setattr(params, attr, most)
    for bq, bkv, bd in params.COPY_ROWS[kernel]:
        kind = "wgmma" if bd <= 128 else "wgmma_dblk"
        row = params.ParameterRow(bd - 6, bq, bkv, bd, kind, "copy")
        stages = params.bwd_copy_stages(kernel, row)
        alternate = kernel == "flash_bwd_kv" and kind == "wgmma"
        assert 2 <= stages <= most * (2 if alternate else 1)
        if alternate:
            assert stages % 2 == 0 and stages >= 4
        got = params.smem_bytes(kernel, row, 2)
        assert got == _copy_smem(kernel, row, stages) \
            <= params.H100.smem_per_block
        # As deep as the most allows, unless a deeper ring would not fit.
        deeper = stages + (2 if alternate else 1)
        assert deeper > most * (2 if alternate else 1) or _copy_smem(
            kernel, row, deeper) > params.H100.smem_per_block
        if kernel == "flash_bwd_kv" and kind == "wgmma":
            # Warpgroup 1's dK and dV pass through K's tile onward.
            assert _copy_smem(kernel, row, stages) - 8 * bq * stages \
                - 8 * (1 + 2 * stages) - 1024 >= 2 * 64 * bd * 4
    tma = params.ParameterRow(128, *params.COPY_ROWS[kernel][1], "wgmma")
    assert params.bwd_copy_stages(kernel, tma) == 0


def test_copy_ring_depths_mirror_the_source():
    """params.BWD_Q_COPY_RING_STAGES and BWD_KV_COPY_RING_STAGES are the
    depths csrc/flash_bwd.cu compiles its copying instances with (the
    defaults of MFA_BWD_Q_COPY_STAGES and MFA_BWD_KV_COPY_STAGES), and
    runtime/host_config.cpp holds the same; the sweep's candidates
    include them."""
    pkg = pathlib.Path(__file__).resolve().parents[1] / "mfa_tpu_torch"
    src = (pkg / "csrc" / "flash_bwd.cu").read_text()
    host = (pkg / "runtime" / "host_config.cpp").read_text()
    for macro, host_name, attr in (
            ("MFA_BWD_Q_COPY_STAGES", "kBwdQCopyRingStages",
             "BWD_Q_COPY_RING_STAGES"),
            ("MFA_BWD_KV_COPY_STAGES", "kBwdKvCopyRingStages",
             "BWD_KV_COPY_RING_STAGES")):
        (value,) = re.findall(rf"#define {macro} (\d+)", src)
        (mirror,) = re.findall(rf"{host_name} = (\d+);", host)
        assert int(value) == int(mirror) == getattr(params, attr)
        assert bwd_tuning.COPY_RING_STAGES[
            "flash_bwd_q" if "_Q_" in macro else "flash_bwd_kv"] == (
                attr, (2, 3, 4))


@pytest.mark.parametrize("d", [100, 250, 36, 162])
def test_wrappers_pass_the_copying_producer(library, monkeypatch, d):
    """At D 100, 250, 36 and 162 (aligned operands) both wrappers launch
    their table row (the wgmma kernel, code 1, or its one-CTA panel, code
    3) with the copying producer's code and ring depth, and count the
    launch under that row, also behind a stand-in for the wrapper (as
    chip_smoke.py's checks install); a dO two bytes off 16 takes the
    mma.sync row with TMA's codes (no depth)."""
    for name in ("flash_bwd_q", "flash_bwd_kv"):
        def stand_in(*args, _real=getattr(k34, name), **kwargs):
            return _real(*args, **kwargs)

        stand_in.launches = 0
        monkeypatch.setattr(k34, name, stand_in)
    q3, o3, do3 = (_meta(4, 64, d) for _ in range(3))
    kv = _meta(2, 64, d)
    lse = _meta(4, 64, dtype=torch.float32)
    kw = dict(group=2, scale=0.125)
    kd_q, kd_kv = (_kd(kind, d) for kind in _BWD)
    label = ("wgmma" if d <= 128 else "wgmma_dblk") + "/copy"
    before = (k34.launches_by_row["flash_bwd_q"][label],
              k34.launches_by_row["flash_bwd_kv"][label])
    k34.flash_bwd_q(q3, kv, kv, o3, do3, lse, kd_q, **kw)
    k34.flash_bwd_kv(q3, kv, kv, do3, lse, lse, kd_kv, **kw)
    assert (k34.launches_by_row["flash_bwd_q"][label],
            k34.launches_by_row["flash_bwd_kv"][label]) == (before[0] + 1,
                                                         before[1] + 1)
    for (_, args), kd, name in zip(library.calls, (kd_q, kd_kv),
                                   ("flash_bwd_q", "flash_bwd_kv")):
        row = k34.launch_row(kd, d, (q3, kv, kv, do3))
        assert row.producer == "copy"
        assert (row.block_q, row.block_kv, row.block_d) in \
            params.COPY_ROWS[name]
        assert args[12:14] == (d, 1)
        assert args[-6:-1] == (KERNEL_CODES[kd.kernel], kd.block_q,
                               kd.block_kv, kd.block_d,
                               params.PRODUCERS["copy"])

    class Shifted(torch.Tensor):
        def data_ptr(self):
            return super().data_ptr() + 2

    shifted = _meta(4, 64, d).as_subclass(Shifted)
    library.calls.clear()
    k34.flash_bwd_q(q3, kv, kv, o3, shifted, lse, kd_q, **kw)
    k34.flash_bwd_kv(q3, kv, kv, shifted, lse, lse, kd_kv, **kw)
    for (_, args), name in zip(library.calls, ("flash_bwd_q",
                                               "flash_bwd_kv")):
        row = params.select_row(params.parameter_table(name, "bf16_mma"), d)
        assert args[-6:-1] == (0, row.block_q, row.block_kv, row.block_d,
                               0)
