"""The forward kernel's (K1 ``flash_fwd``) parameter rows and dispatch on
the CPU: the rows parse and fit one SM as the launch code reckons it,
descriptors and ``launch_row`` pick the kernel the source says, and the
wrapper hands the kernel library a launch with its kernel code for any
number of heads (recorded by a stand-in library over meta tensors; no
kernel runs here)."""

import dataclasses
import pathlib
import re
import types

import pytest
import torch

from mfa_tpu_torch.kernels import build
from mfa_tpu_torch.kernels import flash_fwd as k1
from mfa_tpu_torch.ops import params
from mfa_tpu_torch.ops.descriptors import (
    KERNEL_CODES,
    AttentionDescriptor,
    AttentionKernelType,
    copy_granule,
    head_dim_panels,
    launch_row,
    row_label,
)


def _kd(d, bf16=True, hq=4, hkv=2, n=64, causal=True, **opts):
    return AttentionDescriptor(
        batch=1, num_q_heads=hq, num_kv_heads=hkv, seq_len_q=n,
        seq_len_kv=n, head_dim=d, causal=causal, low_precision_inputs=bf16,
        low_precision_intermediates=bf16,
        **opts).kernel_descriptor(AttentionKernelType.FORWARD)


@pytest.mark.parametrize("precision", ["bf16", "bf16_mma", "fp32"])
def test_rows_parse_and_fit_one_sm(precision):
    rows = params.parameter_table("flash_fwd", precision)
    in_bytes = 4 if precision == "fp32" else 2
    for row in rows:
        assert row.kernel in (("", "fma_dblk") if precision == "fp32"
                              else params.ROW_KERNELS)
        assert params.smem_bytes("flash_fwd", row, in_bytes) \
            <= params.H100.smem_per_block
        if row.kernel == "wgmma":
            assert row.block_q == 128 and row.block_kv in (64, 128)
            assert row.block_d in (64, 128)
            assert min(params.fwd_rings(row)) >= 2
    if precision == "bf16_mma":
        assert {r.kernel for r in rows} == {"mma", "mma_dblk"}


# The rows D <= 256 selects (block_q | block_kv | block_d | kernel of
# the row each D falls in): bf16 past D = 128 one CTA of the head-dim-split
# kernel on a 192- or 256-wide panel.
ROWS_TO_256 = {
    "bf16": {32: (128, 128, 64, "wgmma"), 64: (128, 128, 64, "wgmma"),
             96: (128, 128, 128, "wgmma"), 128: (128, 128, 128, "wgmma"),
             136: (128, 64, 192, "wgmma_dblk"),
             192: (128, 64, 192, "wgmma_dblk"),
             200: (128, 64, 256, "wgmma_dblk"),
             256: (128, 64, 256, "wgmma_dblk")},
    "bf16_mma": {36: (64, 64, 64, "mma"), 100: (64, 64, 128, "mma"),
                 250: (64, 32, 256, "mma")},
    "fp32": {64: (16, 32, 64, ""), 100: (16, 32, 128, ""),
             256: (16, 32, 256, "")},
}


def _past_256_kernel(precision, d):
    """The kernel a row past D = 256 names: the cluster kernel in the bf16
    table up to D = 512, the D-blocked first cut beyond it and in the
    other tables."""
    if precision == "fp32":
        return "fma_dblk"
    return "wgmma_dblk" if precision == "bf16" and d <= 512 else "mma_dblk"


@pytest.mark.parametrize("precision", ["bf16", "bf16_mma", "fp32"])
def test_head_dims_past_256_take_the_d_blocked_rows(precision):
    """D 384, 512 and 1024 (and the tails 300, 320) select a D-blocked
    row whose block_d panel is smaller than D (bf16 up to D = 512: the
    head-dim-split cluster kernel); every D <= 256 selects the row
    ROWS_TO_256 names."""
    rows = params.parameter_table("flash_fwd", precision)
    for d in (264, 300, 320, 384, 512, 1024):
        row = params.select_row(rows, d)
        assert row.kernel == _past_256_kernel(precision, d)
        assert row.block_d < d
        assert (row.max_d == 384) == (d <= 384)
    for d, want in ROWS_TO_256[precision].items():
        row = params.select_row(rows, d)
        assert (row.block_q, row.block_kv, row.block_d, row.kernel) == want


@pytest.mark.parametrize("d", [264, 384, 512, 1024, 4096])
def test_descriptors_take_any_head_dim(d):
    """kernel_descriptor no longer refuses a head dim: bf16 and fp32 both
    take their D-blocked rows, each covering D in ceil(D / block_d)
    panels."""
    for bf16, precision in ((True, "bf16"), (False, "fp32")):
        kd = _kd(d, bf16=bf16)
        kernel = _past_256_kernel(precision, d)
        assert kd.kernel == kernel and kd.head_dim == d
        assert head_dim_panels(kd, d) == -(-d // kd.block_d) >= 2
        assert launch_row(kd, d, ()).kernel == kernel


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_d_blocked_smem_reckons_the_launch_code(precision):
    """csrc/flash_fwd.cu's launch_bf16 / launch_f32 at a D-blocked row:
    one panel of Q and K (rows padded by 8) and of V transposed (bf16),
    or Q and K / V rows padded by one (fp32), whatever the head dim; the
    cluster rows (bf16 D 384 and 512) as fwd_layout reckons them; each
    fits one SM at D 1024 as at D 384."""
    rows = params.parameter_table("flash_fwd", precision)
    for d in (384, 512, 1024):
        row = params.select_row(rows, d)
        bq, bkv, bd = row.block_q, row.block_kv, row.block_d
        if row.kernel == "wgmma_dblk":
            want = _cluster_fwd_smem(row)
        elif precision == "bf16":
            want = 2 * (bq * (bd + 8) + bkv * (bd + 8) + bd * (bkv + 8))
        else:
            want = 4 * (bq * bd + 2 * bkv * (bd + 1))
        got = params.smem_bytes("flash_fwd", row, 2 if precision == "bf16"
                                else 4)
        assert got == want <= params.H100.smem_per_block


def test_decode_keeps_its_own_head_dim_limit(monkeypatch):
    """The decode kernels (K2, K5, K6) take any D up to 512 (OpenLLaMA-3B's
    100 among them), the flash kernels' limit aside; past it they raise."""
    from mfa_tpu_torch.kernels import decode

    assert params.DECODE_MAX_HEAD_DIM == 512
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    for d, ok in ((100, True), (128, True), (384, True), (512, True),
                  (520, False)):
        q3, kv = _meta(4, 1, d), _meta(1, 2, 64, d)
        if ok:
            decode.check_launch("decode", q3, kv, kv)
        else:
            with pytest.raises(ValueError, match=f"head dim {d}"):
                decode.check_launch("decode", q3, kv, kv)


@pytest.mark.parametrize("most, block_kv, stages", [
    (3, 128, 3), (2, 128, 2), (4, 128, 3), (4, 64, 4), (8, 64, 6)])
def test_smem_reckons_the_launch_code(monkeypatch, most, block_kv, stages):
    """csrc/flash_fwd.cu's fwd_layout at D = 128 with the rings
    params.fwd_rings passes: Q (128 x 128 bf16), `stages` K tiles and
    `stages` V tiles (block_kv x 128), 1 + 2 mbarriers a tile and 1024
    bytes of alignment slack; as many tiles as fit, at most
    FWD_RING_STAGES a ring (an even number fits at D = 128, so the rings
    are equal)."""
    monkeypatch.setattr(params, "FWD_RING_STAGES", most)
    row = params.ParameterRow(128, 128, block_kv, 128, "wgmma")
    assert params.fwd_rings(row) == (stages, stages)
    assert params.flash_fwd_smem_bytes(row, 2) == (
        32768 + stages * 2 * block_kv * 256 + 8 * (1 + 4 * stages) + 1024)
    assert params.flash_fwd_smem_bytes(row, 2) <= params.H100.smem_per_block


@pytest.mark.parametrize("d, kernel", [
    (32, "wgmma"), (64, "wgmma"), (96, "wgmma"), (128, "wgmma"),
    (256, "wgmma_dblk"), (36, "wgmma"), (42, "wgmma"), (264, "wgmma_dblk"),
    (384, "wgmma_dblk"), (512, "wgmma_dblk"), (300, "mma_dblk"),
    (1024, "mma_dblk"), (136, "wgmma_dblk"), (192, "wgmma_dblk"),
    (250, "wgmma_dblk"), (200, "wgmma_dblk"), (100, "wgmma"),
    (162, "wgmma_dblk"), (37, "mma"), (101, "mma"), (255, "mma")])
def test_descriptors_dispatch_as_the_source_says(d, kernel):
    """bf16 at D <= 128 runs the wgmma kernel, past it the head-dim-split
    kernel up to D = 512 (one CTA up to D = 256); where TMA cannot map a
    row (D % 8 != 0) but D is even, up to D = 256, the same kernel with
    its copying producer; odd D the mma.sync kernel, and D % 8 != 0 past
    D = 256 the D-blocked one; fp32 the FMA kernels."""
    kd = _kd(d)
    assert kd.kernel == kernel
    assert launch_row(kd, d, ()).kernel == kernel
    assert launch_row(kd, d, ()).producer == (
        "copy" if d % 8 and kernel.startswith("wgmma") else "")
    assert d <= kd.block_d * head_dim_panels(kd, d)
    assert _kd(d, bf16=False).kernel == ("" if d <= 256 else "fma_dblk")
    if kernel in ("wgmma", "wgmma_dblk"):
        assert kd.block_q == 128
    else:
        assert kd.block_q == 64


def test_misaligned_operand_takes_the_mma_row():
    """TMA needs 16-byte-aligned bases: a view two bytes into its storage
    (an operand, or the O buffer) runs the mma.sync row of its head dim."""
    buf = torch.zeros(4 * 64 * 64 + 1, dtype=torch.bfloat16)
    aligned = buf[:-1].view(4, 64, 64)
    shifted = buf[1:].view(4, 64, 64)
    kd = _kd(64)
    assert launch_row(kd, 64, (aligned, aligned)).kernel == "wgmma"
    row = launch_row(kd, 64, (aligned, shifted))
    assert row == params.select_row(
        params.parameter_table("flash_fwd", "bf16_mma"), 64)
    assert row.kernel == "mma" and row.block_q == 64


def _views(d, shift_bytes, rows=64):
    """An aligned [2, rows, d] bf16 view and one ``shift_bytes`` into the
    same storage."""
    buf = torch.zeros(2 * rows * d + 8, dtype=torch.bfloat16)
    return (buf[:2 * rows * d].view(2, rows, d),
            buf[shift_bytes // 2:shift_bytes // 2 + 2 * rows * d]
            .view(2, rows, d))


@pytest.mark.parametrize("d, shift, want", [
    (100, 0, "wgmma/copy"), (250, 0, "wgmma_dblk/copy"),
    (100, 4, "wgmma/copy"), (100, 8, "wgmma/copy"),
    (128, 4, "wgmma/copy"), (128, 8, "wgmma/copy"),
    (256, 4, "wgmma_dblk/copy"), (162, 0, "wgmma_dblk/copy"),
    (36, 0, "wgmma/copy"), (128, 0, "wgmma"), (100, 2, "mma"),
    (128, 2, "mma"), (250, 2, "mma"), (37, 0, "mma"), (101, 0, "mma"),
    (264, 4, "mma_dblk"), (300, 0, "mma_dblk")])
def test_launch_row_takes_the_copying_producer(d, shift, want):
    """K1's launch row where TMA cannot map (D % 8 != 0, or a base 4 or 8
    bytes off 16): the wgmma or one-CTA wgmma_dblk row with the cp.async
    producer when the rows and every base share 4 bytes and one CTA holds
    D; else the mma.sync row: 2-byte shifts, odd D, the clusters past D
    256. K3 and K4 take the same rows by the same rule, each on its own
    table row."""
    aligned, shifted = _views(d, shift)
    kd = _kd(d)
    row = launch_row(kd, d, (aligned, shifted))
    assert row_label(row) == want
    if row.producer:
        assert row.block_q == 128 and d <= row.block_d
        assert (row.block_kv, row.block_d) == (kd.block_kv, kd.block_d)
    for kind in (AttentionKernelType.BACKWARD_QUERY,
                 AttentionKernelType.BACKWARD_KEY_VALUE):
        kd34 = AttentionDescriptor(
            batch=1, num_q_heads=4, num_kv_heads=2, seq_len_q=64,
            seq_len_kv=64, head_dim=d, causal=True, low_precision_inputs=True,
            low_precision_intermediates=True).kernel_descriptor(kind)
        row34 = launch_row(kd34, d, (aligned, shifted))
        assert row_label(row34) == want
        if row34.producer:
            assert d <= row34.block_d
            assert (row34.block_q, row34.block_kv, row34.block_d) == (
                kd34.block_q, kd34.block_kv, kd34.block_d)


@pytest.mark.parametrize("d, shift, granule", [
    (128, 0, 16), (100, 0, 8), (250, 0, 4), (128, 4, 4), (128, 8, 8),
    (100, 2, 2), (37, 0, 2), (42, 0, 4)])
def test_copy_granule_is_the_launch_codes(d, shift, granule):
    """copy_granule, as csrc/flash_fwd.cu reckons p.gran: the largest of
    16, 8, 4 and 2 bytes dividing the 2 D bytes of a row and every
    base."""
    assert copy_granule(d, _views(d, shift)) == granule


@pytest.mark.parametrize("d, rows, shift", [
    (100, 300, 0), (250, 132, 0), (100, 301, 0), (250, 130, 0),
    (100, 300, 8)])
def test_copying_producer_takes_any_row_count(d, rows, shift):
    """The cp.async producer copies granules of rows, not spans of a
    tensor: any number of rows, and a base 8 bytes off 16, keep it."""
    aligned, shifted = _views(d, shift, rows)
    assert launch_row(_kd(d), d, (aligned, shifted)).producer == "copy"


def _copying_instances():
    """(block_kv, block_d) of every wgmma instance with the copying
    producer that csrc/flash_fwd.cu compiles (launch_copying)."""
    src = (pathlib.Path(__file__).resolve().parents[1] / "mfa_tpu_torch"
           / "csrc" / "flash_fwd.cu").read_text()
    return {(int(a), int(b)) for a, b in re.findall(
        r"launch_wgmma<(\d+), (\d+), false, kCopy>", src)}


@pytest.mark.parametrize("d, shift", [
    (36, 0), (100, 0), (128, 4), (162, 0), (250, 0)])
def test_copying_rows_have_a_compiled_instance(d, shift):
    """Every row a launch takes with the copying producer (the table's
    rows up to D 256) is an instance the C entry compiles, and the C entry
    compiles no other."""
    row = launch_row(_kd(d), d, _views(d, shift))
    assert row.producer == "copy"
    assert (row.block_kv, row.block_d) in _copying_instances()
    table = {(r.block_kv, r.block_d) for r in params.parameter_table(
        "flash_fwd", "bf16") if 0 < r.max_d <= 256}
    assert _copying_instances() == table


@pytest.mark.parametrize("block_kv, block_d, rings", [
    (128, 128, (2, 2)), (128, 64, (2, 2)), (64, 192, (2, 2)),
    (64, 256, (2, 2))])
def test_copying_smem_reckons_the_launch_code(block_kv, block_d, rings):
    """Every compiled instance of the copying producer (csrc/flash_fwd.cu
    launch_copying): the TMA layout of fwd_layout (the head dim padded to
    block_d, its padding zeroed in place); the rings params.fwd_rings
    passes (at most FWD_COPY_RING_STAGES a ring), within the H100."""
    kernel = "wgmma" if block_d <= 128 else "wgmma_dblk"
    row = params.ParameterRow(block_d - 6, 128, block_kv, block_d, kernel,
                              "copy")
    assert params.fwd_rings(row) == rings
    tile = block_kv * block_d * 2
    tiles = sum(rings)
    want = (128 * block_d * 2 + tiles * tile + 8 * (1 + 2 * tiles) + 1024)
    assert params.smem_bytes("flash_fwd", row, 2) == want \
        <= params.H100.smem_per_block
    # Every tile that fits is used, up to FWD_COPY_RING_STAGES a ring.
    room = (params.H100.smem_per_block - want) // (tile + 16)
    assert room == 0 or min(rings) == params.FWD_COPY_RING_STAGES


@pytest.mark.parametrize("most, rings", [(2, (2, 2)), (3, (3, 3)),
                                         (1, (1, 1))])
def test_copying_rings_follow_their_own_most(monkeypatch, most, rings):
    """A copying producer's rings take FWD_COPY_RING_STAGES, the TMA rows
    FWD_RING_STAGES (OpenLLaMA-3B's D 100 row against D 128's)."""
    monkeypatch.setattr(params, "FWD_COPY_RING_STAGES", most)
    row = params.ParameterRow(100, 128, 128, 128, "wgmma", "copy")
    assert params.fwd_rings(row) == rings
    tma = dataclasses.replace(row, max_d=128, producer="")
    assert params.fwd_rings(tma) == (params.FWD_RING_STAGES,) * 2


@pytest.mark.parametrize("d", [100, 250, 36, 162])
def test_wrapper_passes_the_producer(library, d):
    """The wrapper launches the row launch_row gives: at D 100, 250, 36
    and 162 the wgmma kernel (code 1, or 3 on its one-CTA panel) with the
    copying producer's code and the rings of its layout, and counts the
    launch under that row."""
    q3, kv = _meta(4, 64, d), _meta(2, 64, d)
    kd = _kd(d, n=64)
    row = launch_row(kd, d, ())
    label = row_label(row)
    before = k1.launches_by_row[label]
    k1.flash_fwd(q3, kv, kv, kd, group=2, scale=0.125,
                 o_dtype=torch.bfloat16)
    ((_, args),) = library.calls
    assert row.producer == "copy" and label.endswith("/copy")
    assert k1.launches_by_row[label] == before + 1
    assert args[-10:-1] == (1, KERNEL_CODES[kd.kernel], 128, kd.block_kv,
                            kd.block_d, *params.fwd_rings(row),
                            int(params.FWD_PINGPONG),
                            params.PRODUCERS["copy"])
    assert args[9:11] == (d, 1)


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
def test_wrapper_takes_any_number_of_heads(library, heads):
    """Blocks and heads share grid.x: no 65535 limit on batch * heads; the
    launch carries the wgmma kernel's code, row, ring depth and
    ping-pong."""
    n, d = 16, 64
    q3, kv = _meta(heads, n, d), _meta(heads, n, d)
    kd = _kd(d, hq=heads, hkv=heads, n=n)
    before = k1.flash_fwd.launches
    o, lse = k1.flash_fwd(q3, kv, kv, kd, group=1, scale=0.125,
                          o_dtype=torch.bfloat16)
    assert k1.flash_fwd.launches == before + 1
    assert o.shape == (heads, n, d) and lse.shape == (heads, n)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ((name, args),) = library.calls
    assert name == "mfa_flash_fwd"
    assert args[5] == heads
    # (dtype, kernel code, block_q, block_kv, block_d, K and V ring tiles,
    # ping-pong, producer) before the stream.
    row = params.ParameterRow(64, 128, 128, 64, "wgmma")
    assert args[-10:-1] == (1, KERNEL_CODES["wgmma"], 128, 128, 64,
                            *params.fwd_rings(row), int(params.FWD_PINGPONG),
                            params.PRODUCERS[""])


@pytest.mark.parametrize("dtype, o_dtype, d, code", [
    (torch.bfloat16, torch.float32, 128, (2, 1, 128, 0)),
    (torch.bfloat16, torch.bfloat16, 256, (1, 3, 128, 0)),
    (torch.float32, torch.float32, 64, (0, 0, 16, 0)),
    (torch.bfloat16, torch.float32, 192, (2, 3, 128, 0)),
    (torch.bfloat16, torch.bfloat16, 250, (1, 3, 128, 1)),
    (torch.bfloat16, torch.bfloat16, 100, (1, 1, 128, 1)),
    (torch.bfloat16, torch.float32, 100, (2, 1, 128, 1)),
    (torch.bfloat16, torch.bfloat16, 101, (1, 0, 64, 0))])
def test_wrapper_passes_dtype_and_kernel_codes(library, dtype, o_dtype, d,
                                               code):
    """bf16 with an fp32 O takes dtype code 2 on the wgmma kernel; D 192
    and 256 the head-dim-split kernel (code 3); D 250 and 100 (rows TMA
    cannot map, D even) the same kernels with the cp.async producer
    (producer code 1), odd D 101 the mma.sync kernel; fp32 inputs the FMA
    kernel. (dtype, kernel code, block_q, producer code)."""
    q3, kv = _meta(4, 32, d, dtype=dtype), _meta(2, 32, d, dtype=dtype)
    kd = _kd(d, bf16=dtype == torch.bfloat16, n=32)
    o, _ = k1.flash_fwd(q3, kv, kv, kd, group=2, scale=0.125,
                        o_dtype=o_dtype)
    assert o.dtype == o_dtype
    ((_, args),) = library.calls
    assert (*args[-10:-7], args[-2]) == code


def test_out_buffers_are_checked_and_written(library):
    """``out`` gives the buffers the launch writes; a buffer of the wrong
    type is refused before any launch."""
    q3, kv = _meta(4, 32, 64), _meta(2, 32, 64)
    kd = _kd(64, n=32)
    out = (_meta(4, 32, 64), _meta(4, 32, dtype=torch.float32))
    o, lse = k1.flash_fwd(q3, kv, kv, kd, group=2, scale=0.125,
                          o_dtype=torch.bfloat16, out=out)
    assert o is out[0] and lse is out[1]
    with pytest.raises(ValueError, match="out buffer"):
        k1.flash_fwd(q3, kv, kv, kd, group=2, scale=0.125,
                     o_dtype=torch.float32, out=out)
    assert len(library.calls) == 1


def test_cpu_out_buffers_take_the_plain_version():
    torch.manual_seed(0)
    q3, kv = torch.randn(4, 32, 64), torch.randn(2, 32, 64)
    kd = _kd(64, bf16=False, n=32)
    kw = dict(group=2, scale=0.125, o_dtype=torch.float32)
    out = (torch.full((4, 32, 64), float("nan")),
           torch.full((4, 32), float("nan")))
    o, lse = k1.flash_fwd(q3, kv, kv, kd, **kw, out=out)
    o_p, lse_p = k1.flash_fwd_plain(q3, kv, kv, kd, **kw)
    assert o is out[0] and torch.equal(o, o_p) and torch.equal(lse, lse_p)


@pytest.mark.parametrize("dtype, d, panels", [
    (torch.bfloat16, 384, 2), (torch.bfloat16, 300, 3),
    (torch.bfloat16, 1024, 4), (torch.float32, 512, 2),
    (torch.bfloat16, 264, 2), (torch.bfloat16, 320, 2),
    (torch.bfloat16, 512, 2), (torch.bfloat16, 136, 1),
    (torch.bfloat16, 192, 1), (torch.bfloat16, 256, 1)])
def test_wrapper_passes_the_d_blocked_launch(library, dtype, d, panels):
    """Past D = 128 the wrapper launches over ceil(D / block_d) panels:
    bf16 up to D = 512 where TMA maps a row the head-dim-split kernel
    (code 3: one CTA up to D = 256, past it a CTA of the cluster a
    panel), else past D = 256 the D-blocked kernel (code 2), for a head
    dim TMA could map and for one it could not (D % 8 != 0)."""
    q3, kv = _meta(4, 32, d, dtype=dtype), _meta(2, 32, d, dtype=dtype)
    kd = _kd(d, bf16=dtype == torch.bfloat16, n=32)
    o, lse = k1.flash_fwd(q3, kv, kv, kd, group=2, scale=0.125,
                          o_dtype=dtype)
    assert o.shape == (4, 32, d) and lse.shape == (4, 32)
    ((_, args),) = library.calls
    assert args[9:11] == (d, panels)
    assert args[-10:-6] == (0 if dtype == torch.float32 else 1,
                            KERNEL_CODES[kd.kernel], kd.block_q, kd.block_kv)
    if panels == 1:
        assert args[-5:-3] == params.fwd_rings(launch_row(kd, d, ()))
    cluster = dtype == torch.bfloat16 and d % 8 == 0 and d <= 512
    assert KERNEL_CODES[kd.kernel] == (3 if cluster else 2)
    assert d <= kd.block_d * panels


@pytest.mark.parametrize("opts, noncausal", [
    (dict(causal=False), 1), (dict(), 0),
    (dict(causal=False, sliding_window=8), 0)])
def test_wrapper_counts_its_noncausal_launches(library, opts, noncausal):
    """The non-causal mode (mfa_tpu's _fwd_kernel) is counted apart from
    the causal and windowed one (_fwd_tablegrid_kernel)."""
    q3, kv = _meta(4, 32, 64), _meta(2, 32, 64)
    kd = _kd(64, n=32, **opts)
    before = (k1.flash_fwd.launches, k1.flash_fwd.noncausal_launches)
    k1.flash_fwd(q3, kv, kv, kd, group=2, scale=0.125,
                 o_dtype=torch.bfloat16)
    assert (k1.flash_fwd.launches, k1.flash_fwd.noncausal_launches) == (
        before[0] + 1, before[1] + noncausal)
    assert len(library.calls) == 1


def _cluster_fwd_smem(row):
    """csrc/flash_fwd.cu's fwd_layout of the cluster kernel: Q (128 x
    block_d bf16), the exchange slots (two warpgroups x one slot for each
    other CTA of the largest cluster, 64 x block_kv fp32), the K and V
    rings, 1 + 2 mbarriers a tile + 4, and the alignment slack; as many
    tiles as fit, the V ring taking an odd one, at most FWD_RING_STAGES a
    ring. Each cluster instance keeps the tiles its ring of K and V
    stages held: an even number fits."""
    bd, bkv = row.block_d, row.block_kv
    peers = {128: 3, 192: 1, 256: 1}[bd]
    fixed = 128 * bd * 2 + 2 * peers * 64 * bkv * 4
    tiles = ((params.H100.smem_per_block - fixed - 8 - 32 - 1024)
             // (bkv * bd * 2 + 16))
    stages = min(tiles // 2, params.FWD_RING_STAGES)
    assert tiles % 2 == 0
    assert params.fwd_rings(row) == (stages, stages) and stages >= 2
    return fixed + stages * 2 * bkv * bd * 2 + 8 * (1 + 4 * stages + 4) + 1024


@pytest.mark.parametrize("block_d, max_panels", [(128, 4), (192, 2),
                                                 (256, 2)])
def test_cluster_smem_reckons_the_launch_code(block_d, max_panels):
    """Every compiled cluster instance (block_kv 64, a 128-, 192- or
    256-wide panel): its shared memory, exchange slots included, is the
    launch code's and fits the H100; its cluster holds at most
    max_panels CTAs (csrc/flash_fwd.cu dblk_max_panels)."""
    row = params.ParameterRow(max_panels * block_d, 128, 64, block_d,
                              "wgmma_dblk")
    assert params.dblk_max_panels(block_d) == max_panels
    assert params.exchange_bytes("flash_fwd", row) == (
        2 * (max_panels - 1) * 64 * 64 * 4)
    assert params.smem_bytes("flash_fwd", row, 2) == _cluster_fwd_smem(row)
    assert params.smem_bytes("flash_fwd", row, 2) \
        <= params.H100.smem_per_block


def test_cluster_rows_fit_and_cover_their_head_dims():
    """The bf16 table's head-dim-split rows fit one SM and cover every
    head dim they take: up to D = 256 one CTA (block_d >= D), past it
    clusters of ceil(D / block_d) CTAs, 2 to the most the exchange slots
    hold."""
    rows = params.parameter_table("flash_fwd", "bf16")
    split = [r for r in rows if r.kernel == "wgmma_dblk"]
    assert [r.max_d for r in split] == [192, 256, 384, 512]
    for row in split:
        assert params.smem_bytes("flash_fwd", row, 2) \
            <= params.H100.smem_per_block
        assert row.block_q == 128 and row.block_d in (192, 256)
        panels = -(-row.max_d // row.block_d)
        assert params.row_panels(row) == panels
        if row.max_d <= 256:
            assert panels == 1 and row.block_kv in (32, 64)
        else:
            assert row.block_kv == 64
            assert 2 <= panels <= params.dblk_max_panels(row.block_d)


@pytest.mark.parametrize("block_kv, block_d, rings", [
    (64, 256, (2, 3)), (64, 192, (3, 3)), (32, 256, (3, 3)),
    (32, 192, (3, 3))])
def test_one_cta_smem_reckons_the_launch_code(block_kv, block_d, rings):
    """Every compiled one-CTA instance of the head-dim-split kernel
    (flash_fwd_wgmma<block_kv, block_d, false>, a plain launch): no
    exchange slots or their mbarriers; the K and V tiles that fit beside
    Q, the V ring taking the odd one (3 V + 2 K at D 256), each ring at
    most FWD_RING_STAGES; Q, the rings, 1 + 2 mbarriers a tile and the
    alignment slack within the H100's shared memory, as fwd_layout
    reckons them."""
    for d in (block_d - 56, block_d):
        row = params.ParameterRow(d, 128, block_kv, block_d, "wgmma_dblk")
        assert params.row_panels(row) == 1
        assert params.exchange_bytes("flash_fwd", row) == 0
        assert params.fwd_rings(row) == rings
        tiles = sum(rings)
        want = (128 * block_d * 2 + tiles * block_kv * block_d * 2
                + 8 * (1 + 2 * tiles) + 1024)
        assert params.smem_bytes("flash_fwd", row, 2) == want \
            <= params.H100.smem_per_block
        # Every tile that fits is used, up to FWD_RING_STAGES a ring.
        room = ((params.H100.smem_per_block - want)
                // (block_kv * block_d * 2 + 16))
        assert room == 0 or min(rings) == params.FWD_RING_STAGES


@pytest.mark.parametrize("most, rings", [(2, (2, 2)), (3, (2, 3)),
                                         (4, (2, 3))])
def test_one_cta_rings_at_d256_follow_the_most(monkeypatch, most, rings):
    """At D 256, block_kv 64 five K/V tiles fit beside Q: FWD_RING_STAGES
    2 keeps two a ring (the four tiles that paired K and V stages held),
    3 or more gives the V ring, which the deferred PV holds a step longer,
    the fifth."""
    monkeypatch.setattr(params, "FWD_RING_STAGES", most)
    row = params.ParameterRow(256, 128, 64, 256, "wgmma_dblk")
    assert params.fwd_rings(row) == rings
    assert params.smem_bytes("flash_fwd", row, 2) \
        <= params.H100.smem_per_block


@pytest.mark.parametrize("d, block_d, panels", [
    (264, 192, 2), (320, 192, 2), (384, 192, 2), (512, 256, 2),
    (384, 128, 3), (512, 128, 4), (256, 128, 2), (513, 256, None),
    (640, 128, None)])
def test_head_dim_panels_of_the_cluster_rows(d, block_d, panels):
    """head_dim_panels of a cluster row is its cluster's size,
    ceil(D / block_d); a head dim that needs more CTAs than the exchange
    slots hold is refused. The cluster kernel's code is 3."""
    kd = dataclasses.replace(_kd(384), block_d=block_d)
    assert kd.kernel == "wgmma_dblk" and KERNEL_CODES[kd.kernel] == 3
    if panels is None:
        with pytest.raises(ValueError, match="cluster kernel"):
            head_dim_panels(kd, d)
    else:
        assert head_dim_panels(kd, d) == panels


@pytest.mark.parametrize("d", [384, 512])
def test_misaligned_cluster_operand_takes_the_mma_dblk_row(d):
    """At D 384 and 512 a base TMA cannot map (a view two bytes into its
    storage) moves the cluster row to the bf16_mma table's row of its
    head dim, the D-blocked mma.sync kernel; so does a head dim whose rows
    are no multiple of 16 bytes."""
    buf = torch.zeros(2 * 64 * d + 1, dtype=torch.bfloat16)
    aligned = buf[:-1].view(2, 64, d)
    shifted = buf[1:].view(2, 64, d)
    kd = _kd(d)
    assert launch_row(kd, d, (aligned, aligned)).kernel == "wgmma_dblk"
    row = launch_row(kd, d, (aligned, shifted))
    assert row == params.select_row(
        params.parameter_table("flash_fwd", "bf16_mma"), d)
    assert row.kernel == "mma_dblk" and row.block_q == 64
    assert launch_row(kd, d - 2, ()).kernel == "mma_dblk"


def test_wrapper_moves_a_misaligned_cluster_launch_to_mma_dblk(library):
    """Through the wrapper at D 384: a misaligned O buffer launches the
    D-blocked kernel (code 2) over its own row's panels (3 of 128), not
    the cluster row's 2."""
    d = 384
    q3, kv = _meta(4, 32, d), _meta(2, 32, d)
    kd = _kd(d, n=32)
    assert kd.kernel == "wgmma_dblk"

    class Shifted(torch.Tensor):
        def data_ptr(self):
            return super().data_ptr() + 2

    o = _meta(4, 32, d).as_subclass(Shifted)
    out = (o, _meta(4, 32, dtype=torch.float32))
    k1.flash_fwd(q3, kv, kv, kd, group=2, scale=0.125,
                 o_dtype=torch.bfloat16, out=out)
    ((_, args),) = library.calls
    assert args[9:11] == (d, 3)
    assert args[-10:-6] == (1, KERNEL_CODES["mma_dblk"], 64, 64)


@pytest.mark.parametrize("d", [136, 192, 256])
def test_misaligned_one_cta_operand_takes_the_mma_row(d):
    """At D 136, 192 and 256 a base TMA cannot map two bytes into its
    storage (no 4-byte granule for the copying producer) moves the
    one-CTA row to the bf16_mma table's row of its head dim, the mma.sync
    kernel; so does odd D 251. D 250 (rows no multiple of 16 bytes, but
    of 4) keeps the one-CTA row with the cp.async producer."""
    buf = torch.zeros(2 * 64 * d + 1, dtype=torch.bfloat16)
    aligned = buf[:-1].view(2, 64, d)
    shifted = buf[1:].view(2, 64, d)
    kd = _kd(d)
    assert launch_row(kd, d, (aligned, aligned)).kernel == "wgmma_dblk"
    assert head_dim_panels(kd, d) == 1
    row = launch_row(kd, d, (shifted, aligned))
    assert row == params.select_row(
        params.parameter_table("flash_fwd", "bf16_mma"), d)
    assert (row.kernel, row.block_q, row.block_kv, row.block_d) == (
        "mma", 64, 32, 256)
    assert launch_row(_kd(251), 251, ()).kernel == "mma"
    assert row_label(launch_row(_kd(250), 250, ())) == "wgmma_dblk/copy"
