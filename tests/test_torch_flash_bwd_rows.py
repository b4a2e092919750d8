"""The backward kernels' (K3 ``flash_bwd_q``, K4 ``flash_bwd_kv``)
parameter rows and dispatch on the CPU: the rows parse and fit one SM,
descriptors and :func:`launch_row` pick the kernel the source says, and
the wrappers hand the kernel library a launch for any number of heads
(recorded by a stand-in library over meta tensors; no kernel runs
here)."""

import types

import pytest
import torch

from mfa_tpu_torch.kernels import build
from mfa_tpu_torch.kernels import flash_bwd as k34
from mfa_tpu_torch.ops import params
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
    """bf16 rows TMA can map (D % 8 == 0) up to D = 128 run wgmma; D = 256
    and the other head dims keep mma.sync."""
    for kernel in ("flash_bwd_q", "flash_bwd_kv"):
        rows = params.parameter_table(kernel, "bf16")
        for d in (8, 32, 64, 96, 128):
            row = params.select_row(rows, d)
            assert row.kernel == "wgmma" and row.block_d in (64, 128)
            assert d <= row.block_d
        assert params.select_row(rows, 256).kernel == "mma"
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
    (256, "mma"), (36, "mma"), (40 + 2, "mma"), (100, "mma"),
    (264, "wgmma_dblk"), (384, "wgmma_dblk"), (512, "wgmma_dblk"),
    (300, "mma_dblk"), (1024, "mma_dblk")])
def test_descriptors_dispatch_as_the_source_says(d, kernel):
    """bf16 at D % 8 == 0 and D <= 128 runs the wgmma kernels; D = 256
    and a D whose rows TMA cannot map (D % 8 != 0) the mma.sync kernel;
    past D = 256, K4 (``kernel``) the cluster kernel up to D = 512 where
    TMA maps a row, else the D-blocked mma.sync kernel, and K3 the
    D-blocked mma.sync kernel."""
    for kind in _BWD:
        kd = _kd(kind, d)
        want = ("mma_dblk" if d > 256 and kind is _BWD[0] else kernel)
        assert kd.kernel == want
        assert k34.launch_row(kd, d, ()).kernel == want
        assert d <= kd.block_d * head_dim_panels(kd, d)
    assert _kd(_BWD[0], 100).block_d == 128     # the mma row of its D
    assert _kd(_BWD[1], 36).block_q == 32


# The rows the parent tree selected at D <= 256: (block_q, block_kv,
# block_d, kernel) of the row each D fell in.
PARENT_ROWS = {
    ("flash_bwd_q", "bf16"): {64: (128, 64, 64, "wgmma"),
                              128: (128, 64, 128, "wgmma"),
                              256: (64, 32, 256, "mma")},
    ("flash_bwd_q", "bf16_mma"): {36: (64, 64, 64, "mma"),
                                  100: (64, 64, 128, "mma"),
                                  250: (64, 32, 256, "mma")},
    ("flash_bwd_q", "fp32"): {64: (16, 32, 64, ""), 200: (16, 32, 256, "")},
    ("flash_bwd_kv", "bf16"): {64: (64, 64, 64, "wgmma"),
                               128: (32, 64, 128, "wgmma"),
                               256: (32, 64, 256, "mma")},
    ("flash_bwd_kv", "bf16_mma"): {36: (32, 64, 64, "mma"),
                                   100: (32, 64, 128, "mma"),
                                   250: (32, 64, 256, "mma")},
    ("flash_bwd_kv", "fp32"): {64: (32, 16, 64, ""),
                               200: (32, 16, 256, "")},
}


@pytest.mark.parametrize("kernel, precision", sorted(PARENT_ROWS))
def test_head_dims_past_256_take_the_d_blocked_rows(kernel, precision):
    """D 384, 512 and 1024 (and the tails 300, 320) select a D-blocked
    row whose block_d panel is smaller than D; every D <= 256 selects
    the row it selected before; the smem of each D-blocked row is the
    launch code's (csrc/flash_bwd.cu launch_q_* / launch_kv_*: the
    first-cut kernel's tiles at block_d, plus, on FMA, K's panel of the
    dQ columns (K3) or Q's and dO's of the dK / dV columns (K4)) and
    fits one SM whatever the head dim."""
    rows = params.parameter_table(kernel, precision)
    for d in (264, 300, 320, 384, 512, 1024):
        row = params.select_row(rows, d)
        want_kernel = ("fma_dblk" if precision == "fp32"
                       else "wgmma_dblk" if (kernel, precision, d <= 512)
                       == ("flash_bwd_kv", "bf16", True) else "mma_dblk")
        assert row.kernel == want_kernel and row.block_d < d
        assert (row.max_d == 384) == (d <= 384)
        bq, bkv, bd = row.block_q, row.block_kv, row.block_d
        if row.kernel == "wgmma_dblk":
            want = _cluster_kv_smem(row)
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
    for d, want in PARENT_ROWS[(kernel, precision)].items():
        row = params.select_row(rows, d)
        assert (row.block_q, row.block_kv, row.block_d, row.kernel) == want


@pytest.mark.parametrize("d", [384, 512, 1024, 264, 320])
def test_wrappers_pass_the_d_blocked_launch(library, d):
    """Above D = 256 both wrappers launch over ceil(D / block_d) head-dim
    panels: K3 the D-blocked kernel (code 2), K4 the cluster kernel (code
    3, a CTA of the cluster a panel) up to D = 512, the D-blocked one
    beyond."""
    q3, o3, do3 = (_meta(4, 32, d) for _ in range(3))
    kv = _meta(2, 32, d)
    lse = _meta(4, 32, dtype=torch.float32)
    kw = dict(group=2, scale=0.125)
    kd_q, kd_kv = (_kd(kind, d, n=32) for kind in _BWD)
    dq, dterm = k34.flash_bwd_q(q3, kv, kv, o3, do3, lse, kd_q, **kw)
    dk, dv = k34.flash_bwd_kv(q3, kv, kv, do3, lse, dterm, kd_kv, **kw)
    assert dq.shape == (4, 32, d) and dk.shape == dv.shape == (2, 32, d)
    (_, args3), (_, args4) = library.calls
    for args, kd, kernel in ((args3, kd_q, "mma_dblk"),
                             (args4, kd_kv, "wgmma_dblk" if d <= 512
                              else "mma_dblk")):
        assert kd.kernel == kernel
        assert args[12:14] == (d, -(-d // kd.block_d))
        assert args[-5:-1] == (KERNEL_CODES[kernel], kd.block_q,
                               kd.block_kv, kd.block_d)
    assert args4[13] == (2 if d <= 512 else 4)


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
    # (kernel code, block_q, block_kv, block_d) before the stream.
    assert args3[-5:-1] == (1, 128, 64, 64)
    assert args4[-5:-1] == (1, 64, 64, 64)
    assert args3[8] == heads and args4[8] == heads


def _cluster_kv_smem(row):
    """csrc/flash_bwd.cu's KvSplitSmem, K4's cluster kernel at a bf16 row:
    K and V, one scaled-Q tile, one exchange slot a warpgroup and two S^T
    buffers of 64 x block_q fp32, up to 4 stages of Q, dO, L and the
    D-term, 1 + 2 stages + 8 mbarriers, alignment slack."""
    bq, bkv, bd = row.block_q, row.block_kv, row.block_d
    tile_q = bq * bd * 2
    fixed = 2 * bkv * bd * 2 + tile_q + 4 * 64 * bq * 4
    stages = min((params.H100.smem_per_block - fixed - 72 - 1024)
                 // (2 * tile_q + 8 * bq + 16), 4)
    assert params.bwd_kv_stages(row) == stages >= 2
    return (fixed + stages * (2 * tile_q + 8 * bq)
            + 8 * (1 + 2 * stages + 8) + 1024)


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


def test_k3_keeps_the_d_blocked_rows_past_256():
    """K3 has no cluster row: every K3 table names mma_dblk (bf16) or
    fma_dblk (fp32) past D = 256, and K4's bf16 cluster rows cover D up
    to 512 in clusters of two."""
    for precision in ("bf16", "bf16_mma", "fp32"):
        rows = params.parameter_table("flash_bwd_q", precision)
        assert all(r.kernel != "wgmma_dblk" for r in rows)
    cluster = [r for r in params.parameter_table("flash_bwd_kv", "bf16")
               if r.kernel == "wgmma_dblk"]
    assert [(r.max_d, -(-r.max_d // r.block_d)) for r in cluster] == [
        (384, 2), (512, 2)]


@pytest.mark.parametrize("d", [384, 512])
def test_misaligned_cluster_operand_takes_the_mma_dblk_row(library, d):
    """K4 at D 384 and 512 with a dO TMA cannot map (a view two bytes into
    its storage) launches the bf16_mma table's row of its head dim, the
    D-blocked kernel (code 2) over that row's panels."""
    class Shifted(torch.Tensor):
        def data_ptr(self):
            return super().data_ptr() + 2

    shifted = _meta(4, 32, d).as_subclass(Shifted)
    q3, kv = _meta(4, 32, d), _meta(2, 32, d)
    lse = _meta(4, 32, dtype=torch.float32)
    kd = _kd(_BWD[1], d, n=32)
    assert kd.kernel == "wgmma_dblk"
    assert k34.launch_row(kd, d, (q3, kv, kv, shifted)).kernel == "mma_dblk"
    k34.flash_bwd_kv(q3, kv, kv, shifted, lse, lse, kd, group=2,
                     scale=0.125)
    ((_, args),) = library.calls
    row = params.select_row(params.parameter_table("flash_bwd_kv",
                                                   "bf16_mma"), d)
    assert args[12:14] == (d, -(-d // row.block_d))
    assert args[-5:-1] == (2, row.block_q, row.block_kv, row.block_d)
