"""K7's (``gemm``) and K8's (``int4_matmul``) tiles and dispatch on the
CPU: every tile fits one SM as the launch code reckons it, the
heuristics pick the wgmma tiles where the source says, the TMA-mappable
predicate tells which stored operands the wgmma kernel can read, K7's
wrapper hands the kernel library the tile, ring depth and tile-walk band
(recorded by a stand-in library over meta tensors; no kernel runs here),
and the biased layout's precomputed rowsum(x) leaves the plain version
as it was."""

import types

import numpy as np
import pytest
import torch

from mfa_tpu_torch.kernels import build, quant
from mfa_tpu_torch.kernels import gemm_kernel as k7
from mfa_tpu_torch.kernels import quant_matmul as k8
from mfa_tpu_torch.kernels.quant import unpack_int4_halves
from mfa_tpu_torch.ops import params
from mfa_tpu_torch.ops.descriptors import GEMMDescriptor
from mfa_tpu_torch.ops.precision import OperandPrecision

BF16, FP16, FP32 = (OperandPrecision.BF16, OperandPrecision.FP16,
                    OperandPrecision.FP32)


def _kd(m, n, k, prec=BF16, b_prec=None, batch=1, ta=False, tb=False):
    return GEMMDescriptor(m=m, n=n, k=k, a_precision=prec,
                          b_precision=b_prec or prec, c_precision=prec,
                          transpose_a=ta, transpose_b=tb,
                          batch=batch).kernel_descriptor()


@pytest.mark.parametrize("name", list(params.GEMM_TILES))
@pytest.mark.parametrize("ta, tb", [(False, False), (True, True)])
def test_gemm_tiles_fit_one_sm(name, ta, tb):
    tile = params.GEMM_TILES[name]
    assert params.gemm_smem_bytes(tile, ta, tb) <= params.H100.smem_per_block
    if tile.path == "wgmma":
        assert tile.block_m == 128 and tile.block_k == 64
        assert tile.block_n in (128, 256) and tile.stages >= 2


@pytest.mark.parametrize("name", list(params.QMM_TILES))
def test_qmm_tiles_fit_one_sm(name):
    tile = params.QMM_TILES[name]
    assert params.qmm_smem_bytes(tile) <= params.H100.smem_per_block


def test_smem_reckons_the_launch_code():
    """csrc/gemm.cu's wg_smem_bytes and csrc/quant_matmul.cu's
    qw_smem_bytes: per stage the unpadded swizzled tiles and two 8-byte
    mbarriers, K8's staging tile [128 x (channels + 8)] bf16, 1024 bytes
    of alignment slack."""
    w256, w128 = params.GEMM_TILES["w256"], params.GEMM_TILES["w128"]
    assert params.gemm_smem_bytes(w256) == 4 * ((128 + 256) * 128 + 16) + 1024
    assert params.gemm_smem_bytes(w128) == 6 * ((128 + 128) * 128 + 16) + 1024
    q = params.QMM_TILES["w128"]
    assert params.qmm_smem_bytes(q) == (4 * (2 * 128 * 128 + 128 * 64 + 16)
                                        + 128 * 136 * 2 + 1024)
    q = params.QMM_TILES["w256"]
    assert params.qmm_smem_bytes(q) == (3 * (2 * 128 * 128 + 256 * 64 + 16)
                                        + 128 * 264 * 2 + 1024)


@pytest.mark.parametrize("n, ta, tb", [(4096, False, False)] + [
    (1536, ta, tb) for ta in (False, True) for tb in (False, True)])
def test_gemm_heuristic_picks_wgmma(n, ta, tb):
    kd = _kd(n, n, n, ta=ta, tb=tb)
    assert kd.tile.path == "wgmma" and kd.mma_tile.path == "mma"
    assert kd.tile.name == "w256" and kd.mma_tile.name == "m128"


def test_gemm_heuristic_keeps_the_other_tiles():
    assert _kd(4, 4096, 4096).tile.name == "m16"
    assert _kd(16, 4096, 4096, ta=True).tile.name == "m16"
    assert _kd(17, 4096, 4096).tile.path == "wgmma"
    assert _kd(1536, 1536, 1536, FP32).tile.name == "ffma"
    assert _kd(1536, 1536, 1536, BF16, FP32).tile.name == "ffma"
    kd = _kd(4096, 4096, 4096, FP16)
    assert kd.tile.name == "m128" and kd.mma_tile is None
    # 128 x 128 tiles fill 132 SMs in fewer rounds than 128 x 256 here.
    assert _kd(1000, 1032, 1048).tile.name == "w128"


@pytest.mark.parametrize("m, n, name", [
    (2048, 4096, "w256"), (2048, 14336, "w256"), (1000, 4096, "w256"),
    (2040, 4000, "w256"), (2048, 1024, "w128"), (100, 14336, "w128"),
    (1000, 14336, "w128"), (17, 4096, "w128"), (16, 4096, "d16"),
    (8, 14336, "d8"), (4, 1024, "d8")])
def test_int4_tile_picks_by_rounds(m, n, name):
    """Above decode sizes the wgmma tile whose walk takes the fewer rounds
    times tile area, ties to 256 channels: the choice the H100 measured
    best at every shape of the sweep (utils/bwd_tuning.py)."""
    assert k8.int4_tile(m, n, torch.bfloat16).name == name
    assert k8.int4_tile(m, n, torch.float32).name == "ffma"


def _meta(*shape):
    return torch.empty(shape, dtype=torch.bfloat16, device="meta")


def _sliced(batch, rows, cols, pad, offset=0):
    """[batch, rows, cols] sliced from a [batch, rows + pad, cols + pad]
    buffer, ``offset`` elements into its storage."""
    buf = torch.zeros(batch * (rows + pad) * (cols + pad) + offset,
                      dtype=torch.bfloat16)
    big = buf[offset:].view(batch, rows + pad, cols + pad)
    return big[:, :rows, :cols]


@pytest.mark.parametrize("rows, cols", [(2048, 4096), (4096, 4096),
                                        (1024, 4096), (14336, 4096),
                                        (4096, 14336)])
def test_tma_maps_the_llama_shapes(rows, cols):
    assert k7.tma_mappable(_meta(1, rows, cols))
    assert k7.tma_mappable(_meta(3, rows, cols), _meta(3, cols, rows))


def test_tma_maps_aligned_slices():
    assert k7.tma_mappable(_sliced(1, 200, 200, 0))      # ragged_200
    assert k7.tma_mappable(_sliced(3, 64, 40, 8))        # pad of 16 bytes
    assert k7.tma_mappable(_sliced(1, 96, 96, 64, offset=8))


@pytest.mark.parametrize("name, t", [
    ("ragged_7", _sliced(1, 7, 7, 0)),
    ("ragged_127", _sliced(1, 127, 127, 0)),
    ("ragged_129", _sliced(1, 129, 129, 0)),
    ("batched_3x200x129x127", _sliced(3, 200, 127, 0)),
    ("strided_pad_3", _sliced(1, 7, 129, 3)),
    ("misaligned_view", _sliced(1, 64, 64, 0, offset=1)),
    ("column_major_view", _sliced(1, 64, 64, 0).transpose(1, 2)),
    ("fp32", torch.zeros(1, 64, 64)),
    ("batch_stride_not_16_bytes", torch.zeros(
        200, dtype=torch.bfloat16).as_strided((2, 8, 8), (68, 8, 1))),
    ("overlapping_batches", torch.zeros(64, 64,
                                        dtype=torch.bfloat16).expand(
                                            2, 64, 64)),
])
def test_tma_refuses_what_it_cannot_map(name, t):
    assert not k7.tma_mappable(t), name


def test_launch_tile_falls_to_the_mma_tile():
    kd = _kd(64, 64, 64)
    ok, shifted = _sliced(1, 64, 64, 0), _sliced(1, 64, 64, 0, offset=1)
    assert k7.launch_tile(kd, ok, ok) is kd.tile
    assert k7.launch_tile(kd, shifted, ok) is kd.mma_tile
    assert k7.launch_tile(kd, ok, _sliced(1, 64, 63, 0)) is kd.mma_tile
    assert k7.launch_tile(kd, ok, _sliced(1, 64, 64, 0)[:, :, :63]) \
        is kd.tile                       # a row stride of 64 maps


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


@pytest.mark.parametrize("ta, tb", [(False, False), (True, True)])
def test_gemm_wrapper_passes_tile_stages_and_band(library, ta, tb):
    a = _meta(2, 4096, 4096)
    kd = _kd(4096, 4096, 4096, batch=2, ta=ta, tb=tb)
    c = k7.gemm_kernel(a, a, None, kd, out_dtype=torch.bfloat16)
    assert c.shape == (2, 4096, 4096)
    ((name, args),) = library.calls
    assert name == "mfa_gemm"
    # (ta, tb, tile code, stages, band) before the stream.
    assert args[-6:-1] == (int(ta), int(tb), 4,
                           params.GEMM_TILES["w256"].stages,
                           params.GEMM_TILE_GROUP)


# Llama-3-8B's projections (K, N) and a ragged one.
QMM_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
              (96, 100)]


@pytest.mark.parametrize("k, n", QMM_SHAPES)
@pytest.mark.parametrize("m", [1, 4, 8, 16])
def test_qmm_split_rule(m, k, n):
    """K8's decode split of K: whole 128-byte steps, no empty split, x's
    slices within one SM's shared memory as the launch code reckons it,
    and as many CTAs as the H100 has SMs wherever K has the steps."""
    tile = k8.int4_tile(m, n, torch.bfloat16)
    assert tile.path == "splitk" and tile.block_m >= m
    cols = params.qmm_split_cols(n, k, tile)
    assert cols == params.qmm_split_cols(n, k, tile, params.H100)
    assert cols % tile.block_k == 0
    assert tile.block_k <= cols <= params.QMM_SPLIT_MAX_COLS
    splits = -(-(k // 2) // cols)
    assert (splits - 1) * cols < k // 2
    assert params.qmm_smem_bytes(tile, cols) <= params.qmm_smem_bytes(tile)
    ctas = -(-n // tile.block_n) * splits
    steps = -(-(k // 2) // tile.block_k)
    assert ctas >= params.H100.sm_count or splits == steps


def test_qmm_decode_grid_fills_the_card_at_4096_to_1024():
    """The k and v projections at M 4: 16 channel tiles, split 16 ways
    (the decode tile before held 32 CTAs on 132 SMs)."""
    tile = k8.int4_tile(4, 1024, torch.bfloat16)
    cols = params.qmm_split_cols(1024, 4096, tile, params.H100)
    assert -(-1024 // tile.block_n) * -(-2048 // cols) >= 132


def test_qmm_splitk_smem_reckons_the_launch_code():
    """csrc/quant_matmul.cu's qd_smem_bytes: the ring of 64 x 128-byte
    boxes and their mbarriers, x's slices [M][2 cols + 16] bf16 (at most
    the tile's 16 rows), each k-quarter's row sums, a flag and 1024 bytes
    of alignment slack."""
    d16 = params.QMM_TILES["d16"]
    ring = 1024 + d16.stages * (64 * 128 + 8)
    assert params.qmm_smem_bytes(d16, 256) == (ring + 16 * (2 * 256 + 16) * 2
                                               + 4 * 16 * 4 + 4)
    assert params.qmm_smem_bytes(d16, 256, rows=9) == (
        ring + 9 * (2 * 256 + 16) * 2 + 4 * 16 * 4 + 4)


@pytest.mark.parametrize("layout", ["int4", "int4_biased"])
@pytest.mark.parametrize("m, k, n", [(4, 4096, 1024), (16, 4096, 14336),
                                     (1, 14336, 4096), (8, 96, 100)])
def test_k8_wrapper_passes_the_split(library, monkeypatch, layout, m, k, n):
    """The decode tiles' launch: tile code, ring depth and split columns
    from the rule, a workspace and counters only with more than one
    split, one counted call."""
    monkeypatch.setattr(k8, "resolve_device",
                        lambda device: torch.device("meta"))
    dtype = torch.int8 if layout == "int4" else torch.uint8
    packed = torch.empty((n, k // 2), dtype=dtype, device="meta")
    scale = torch.empty((n,), dtype=torch.float32, device="meta")
    before = k8.int4_matmul.launches
    y = k8.int4_matmul(_meta(m, k), packed, scale, layout=layout)
    assert y.shape == (m, n) and k8.int4_matmul.launches == before + 1
    ((name, args),) = library.calls
    assert name == "mfa_int4_matmul"
    tile = k8.int4_tile(m, n, torch.bfloat16)
    cols = params.qmm_split_cols(n, k, tile)
    # M N K x_bf16 biased tile stages group split_cols, then the stream.
    assert args[7:16] == (m, n, k, 1, int(layout == "int4_biased"),
                          {"d8": 0, "d16": 1}[tile.name], tile.stages,
                          params.GEMM_TILE_GROUP, cols)
    one_split = -(-(k // 2) // cols) == 1
    assert args[3] is None                   # no rowsum(x) before launch
    assert (args[4] is None) == (args[5] is None) == one_split


@pytest.mark.parametrize("layout", ["int4", "int4_biased"])
@pytest.mark.parametrize("m, k, n", [(4, 40, 64), (64, 100, 64),
                                     (4, 4080, 4096), (2048, 4080, 4096),
                                     (4, 4096, 1024), (2048, 4096, 4096)])
def test_k8_wrapper_resplits_what_tma_cannot_copy(library, monkeypatch,
                                                  layout, m, k, n):
    """K % 32 != 0 (and packed weights not contiguous): the launch gets K'
    = K rounded up to 32 and new [N, K'/2] packed bytes; K % 32 == 0 over
    contiguous packed weights: K and the caller's packed tensor, as
    before. The biased wgmma tile's row sum is that of x as given."""
    monkeypatch.setattr(k8, "resolve_device",
                        lambda device: torch.device("meta"))
    dtype = torch.int8 if layout == "int4" else torch.uint8
    wide = torch.empty((n, k // 2 + 16), dtype=dtype, device="meta")
    for packed in (wide[:, :k // 2].contiguous(), wide[:, :k // 2]):
        library.calls.clear()
        scale = torch.empty((n,), dtype=torch.float32, device="meta")
        y = k8.int4_matmul(_meta(m, k), packed, scale, layout=layout)
        assert y.shape == (m, n)
        ((name, args),) = library.calls
        resplit = k % 32 != 0 or not packed.is_contiguous()
        kp = -(-k // 32) * 32
        assert args[9] == (kp if resplit else k)
        if not resplit:
            assert args[1] == packed.data_ptr()
        tile = k8.int4_tile(m, n, torch.bfloat16)
        biased_wgmma = layout == "int4_biased" and tile.path == "wgmma"
        assert (args[3] is not None) == biased_wgmma
        if tile.path == "splitk":
            assert args[15] == params.qmm_split_cols(n, args[9], tile)


@pytest.mark.parametrize("m, k, n", [(4, 4096, 1024), (16, 4096, 14336),
                                     (16, 14336, 4096)])
def test_k8_split_scratch_holds_the_partials_and_is_kept(m, k, n):
    """The split-K scratch of one (device, stream) holds what the kernel
    carves, [tiles, splits, M, block_n + 1] fp32 and a counter a channel
    tile, and the next call on that stream gets the same tensors back: no
    allocation at each call."""
    tile = k8.int4_tile(m, n, torch.bfloat16)
    device = torch.device("meta")
    cols, part, counters = k8.split_launch(m, n, k, tile, device, 7)
    splits, tiles = -(-(k // 2) // cols), -(-n // tile.block_n)
    assert splits > 1
    assert part.dtype == torch.float32 and counters.dtype == torch.int32
    assert part.numel() >= tiles * splits * m * (tile.block_n + 1)
    assert counters.numel() >= tiles
    again = k8.split_launch(m, n, k, tile, device, 7)
    assert again[1] is part and again[2] is counters
    other = k8.split_launch(m, n, k, tile, device, 8)
    assert other[1] is not part and other[2] is not counters


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_biased_plain_with_precomputed_rowsum_is_unchanged(dtype):
    """The plain version subtracts 8 times the precomputed rowsum(x) that
    the wgmma tile takes; it gives the bits of the version before it,
    which widened x to fp32 and summed its rows inline."""
    rng = np.random.default_rng(11)
    w = torch.from_numpy(rng.standard_normal((24, 96)).astype(np.float32))
    qb = quant.quantize_weight(w, "int4_biased")
    x = torch.from_numpy(rng.standard_normal((3, 5, 96)).astype(
        np.float32)).to(dtype)
    got = k8.int4_matmul_plain(x, qb.w, qb.scale, layout="int4_biased")
    # The earlier plain version, written out.
    p32 = qb.w.to(torch.int32)
    lo, hi = p32 & 0x0F, p32 >> 4
    xf = x.reshape(-1, 96).float()
    acc = xf[:, :48] @ lo.float().t() + xf[:, 48:] @ hi.float().t()
    acc = acc - 8.0 * xf.sum(dim=1, keepdim=True)
    want = (acc * qb.scale).to(dtype).reshape(3, 5, 24)
    assert torch.equal(got, want)
    assert torch.equal(k8.rowsum(x.reshape(-1, 96)), xf.sum(dim=1))
    # The signed layout needs no row sums.
    qs = quant.quantize_weight(w, "int4")
    lo_s, hi_s = unpack_int4_halves(qs.w)
    want_s = ((xf[:, :48] @ lo_s.float().t() + xf[:, 48:] @ hi_s.float().t())
              * qs.scale).to(dtype).reshape(3, 5, 24)
    assert torch.equal(k8.int4_matmul_plain(x, qs.w, qs.scale,
                                            layout="int4"), want_s)
