"""The split rule of the split-KV decode kernels (K2
``decode_fused_append``, K5 ``decode_attend``, K6 ``paged_decode``) on the
CPU: ``ops/params.py::decode_split_rows``, and the launch arguments the
wrappers hand the kernel library, recorded by a stand-in library over meta
tensors (no kernel runs here)."""

import types

import pytest
import torch

from mfa_tpu_torch.kernels import build
from mfa_tpu_torch.kernels import decode as k5
from mfa_tpu_torch.kernels import paged_decode as k6
from mfa_tpu_torch.ops import params

SHAPES = [(n, g, cap) for n in (1, 2, 14, 32, 64, 256, 2048)
          for g in (1, 4, 7, 8, 12, 16)
          for cap in (1, 100, 256, 2048, 4096, 8192, 131072)]


def _ctas(n, group, capacity, rows):
    chunks = -(-group // params.decode_group_chunk(group))
    return n * chunks * max(1, -(-capacity // rows))


def test_split_rows_are_a_power_of_two_and_deterministic():
    for n, g, cap in SHAPES:
        rows = params.decode_split_rows(n, g, cap)
        assert rows >= 1 and rows & (rows - 1) == 0, (n, g, cap, rows)
        assert (params.DECODE_SPLIT_MIN_ROWS <= rows
                <= params.DECODE_SPLIT_MAX_ROWS)
        assert rows == params.decode_split_rows(n, g, cap)
        # SPLITS splits of a full cache (within [MIN, MAX]), more only
        # while the grid would leave an SM without a CTA.
        whole = params.DECODE_SPLIT_MIN_ROWS
        while (whole < params.DECODE_SPLIT_MAX_ROWS
               and whole * params.DECODE_SPLITS < cap):
            whole *= 2
        assert rows <= whole
        if rows < whole:
            assert _ctas(n, g, cap, 2 * rows) < params.H100.sm_count


@pytest.mark.parametrize("n, group, capacity, rows", [
    (32, 4, 2048, 256),     # chip_smoke k5: B = 4, Hkv = 8, L = 2048
    (32, 4, 8192, 1024),    # and L = 8192
    (64, 4, 2048, 256),     # k6 and paged serving: 8 sequences x Hkv 8
])
def test_split_rows_fill_the_card_at_the_table_shapes(n, group, capacity,
                                                      rows):
    """The measured best R at these shapes (utils/decode_tuning.py sweep
    on an H100), about two CTAs an SM (~2 x 132) or more."""
    assert params.decode_split_rows(n, group, capacity, params.H100) == rows
    assert _ctas(n, group, capacity, rows) >= 256


def test_k2_split_fills_the_card_at_chip_smokes_shape():
    """K2 takes K5's rule: at chip_smoke's k2 shape (4 sequences x Hkv 8,
    G 4, L 2048) its grid holds more CTAs than the H100 has SMs (the
    kernel before held one a (sequence, kv head): 32)."""
    rows = params.decode_split_rows(32, 4, 2048, params.H100)
    assert _ctas(32, 4, 2048, rows) >= params.H100.sm_count


def test_split_rows_for_one_short_sequence():
    """A grid of a few (sequence, kv head) pairs still fills the SMs."""
    rows = params.decode_split_rows(2, 4, 8192, params.H100)
    assert rows == params.DECODE_SPLIT_MIN_ROWS
    assert _ctas(2, 4, 8192, rows) >= params.H100.sm_count
    assert params.decode_split_rows(2048, 4, 100, params.H100) == 64


def test_split_rows_follow_the_sm_count():
    half = params.HopperDevice("sm90", 66, params.H100.smem_per_block,
                               (9, 0))
    for n, g, cap in SHAPES:
        assert (params.decode_split_rows(n, g, cap, half)
                >= params.decode_split_rows(n, g, cap, params.H100))


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
    monkeypatch.setattr(k5, "check_launch", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    return lib


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("seqs, hkv, group, page, max_pages, d", [
    (4, 8, 4, 512, 4, 128), (4, 8, 4, 512, 16, 128), (8, 8, 4, 512, 4, 128),
    (7, 2, 12, 128, 32, 128), (3, 1, 16, 256, 3, 64), (1, 4, 1, 128, 1, 8),
])
def test_k5_and_k6_split_alike_and_count_one_launch(library, seqs, hkv,
                                                    group, page, max_pages,
                                                    d):
    n, cap = seqs * hkv, page * max_pages
    q3 = _meta(n, group, d, dtype=torch.bfloat16)
    lengths = _meta(seqs, dtype=torch.int32)
    n5, n6 = k5.decode_attend.launches, k6.paged_decode.launches
    path = params.decode_path(d, torch.bfloat16, True, False)
    p5 = k5.decode_attend.launches_by_path[path]
    p6 = k6.paged_decode.launches_by_path[path]
    k5.decode_attend(q3, _meta(n, cap, d, dtype=torch.bfloat16),
                     _meta(n, cap, d, dtype=torch.bfloat16), _meta(n, cap),
                     _meta(n, cap), lengths, num_kv_heads=hkv)
    pages = _meta(5, hkv, page, d, dtype=torch.bfloat16)
    k6.paged_decode(q3, pages, pages, _meta(5, hkv, page),
                    _meta(5, hkv, page),
                    _meta(seqs, max_pages, dtype=torch.int32), lengths)
    assert (k5.decode_attend.launches, k6.paged_decode.launches) == (n5 + 1,
                                                                     n6 + 1)
    assert (k5.decode_attend.launches_by_path[path],
            k6.paged_decode.launches_by_path[path]) == (p5 + 1, p6 + 1)
    (name5, args5), (name6, args6) = library.calls
    assert (name5, name6) == ("mfa_decode_attend", "mfa_paged_decode")
    # split rows, query rows a CTA, threads, then the path's code: the
    # same for both.
    rows = params.decode_split_rows(n, group, cap)
    assert args5[-5:-1] == args6[-5:-1] == (
        rows, params.decode_group_chunk(group),
        params.DECODE_ATTEND_THREADS, params.DECODE_PATHS[path])


def test_workspace_holds_what_the_kernel_carves():
    for n, g, cap in SHAPES[::7]:
        for d in (8, 128, 256):
            rows, chunk, ws = k5.split_launch(n, g, cap, d,
                                              torch.device("meta"))
            splits, chunks = max(1, -(-cap // rows)), -(-g // chunk)
            # scores (a chunk's query rows each), split maxes and sums,
            # partial O, one counter a chunk
            need = (n * chunks * cap * chunk
                    + n * g * (2 * splits + splits * d) + n * chunks)
            assert ws.dtype == torch.float32 and ws.numel() >= need
            assert chunk in (4, 8) and chunk >= min(g, 8)


def test_k2_workspace_holds_each_splits_p_scale_too():
    """K2's workspace: K5's, then each split's max |P vs| (an int8
    cache's P scale) after the counters."""
    for n, g, cap in SHAPES[::7]:
        for d in (8, 128, 256):
            rows, chunk, ws = k5.split_launch(n, g, cap, d,
                                              torch.device("meta"),
                                              fused=True)
            splits, chunks = max(1, -(-cap // rows)), -(-g // chunk)
            need = (n * chunks * cap * chunk
                    + n * g * (3 * splits + splits * d) + n * chunks)
            assert ws.dtype == torch.float32 and ws.numel() >= need


@pytest.mark.parametrize("seqs, hkv, group, cap, d, window", [
    (4, 8, 4, 2048, 128, None), (4, 8, 4, 8192, 128, 512),
    (4, 2, 16, 2048, 128, 512), (3, 1, 12, 300, 64, None),
    (1, 4, 1, 128, 8, 1), (2, 1, 33, 1024, 256, None),
])
def test_k2_takes_the_split_and_counts_one_launch(library, monkeypatch,
                                                  seqs, hkv, group, cap, d,
                                                  window):
    """Through the entry point: one counted K2 call a step, K5's split
    rows, query chunk and CTA size, any group (no limit of 8 rows)."""
    from mfa_tpu_torch.ops import decode as ops_decode
    from mfa_tpu_torch.ops.precision import OperandPrecision
    from mfa_tpu_torch.serving.kv_cache import KVCache

    monkeypatch.setattr(ops_decode, "resolve_device",
                        lambda device: torch.device("meta"))
    n = seqs * hkv
    storage = _meta(seqs, hkv, cap, d, dtype=torch.int8)
    cache = KVCache(storage, storage, _meta(seqs, hkv, cap),
                    _meta(seqs, hkv, cap), _meta(seqs, dtype=torch.int32),
                    OperandPrecision.INT8)
    q = _meta(seqs, hkv * group, d, dtype=torch.bfloat16)
    kn = _meta(seqs, hkv, d, dtype=torch.bfloat16)
    before = k5.decode_fused_append.launches
    o, cache = ops_decode.decode_attention_append(
        q, kn, kn, cache, sliding_window=window, device="cuda")
    assert o.shape == q.shape
    assert k5.decode_fused_append.launches == before + 1
    ((name, args),) = library.calls
    assert name == "mfa_decode_fused_append"
    # bh hkv group L D window q_bf16 format, then split rows, query rows a
    # CTA and threads before the stream.
    assert args[10:18] == (n, hkv, group, cap, d, window or 0, 1,
                           k5.KV_FORMATS[torch.int8])
    assert args[18:21] == (params.decode_split_rows(n, group, cap),
                           params.decode_group_chunk(group),
                           params.DECODE_ATTEND_THREADS)
    # The path's code: int8 runs FMA, here in the exact layout (every
    # case's D is 8 * 2^k).
    assert args[21] == params.DECODE_PATHS["fma/exact"]


def test_k5_bit_guard_covers_every_recorded_case(monkeypatch):
    """chip_smoke.py's guard on K5's bits: k5_bits gives one digest for
    each case of K5_DIGESTS, and the same digests at a second call (its
    inputs come from a seed alone). On the CPU K5 is its plain version,
    so the digests themselves are the card's only there."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_k5", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setattr(torch.Tensor, "cuda", lambda self: self)
    first = smoke.k5_bits(torch)
    assert sorted(first) == sorted(smoke.K5_DIGESTS)
    assert all(len(v) == 16 for v in smoke.K5_DIGESTS.values())
    assert smoke.k5_bits(torch) == first
