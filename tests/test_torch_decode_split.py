"""The split rule of the split-KV decode kernels (K5 ``decode_attend``, K6
``paged_decode``) on the CPU: ``ops/params.py::decode_split_rows``, and the
launch arguments both wrappers hand the kernel library, recorded by a
stand-in library over meta tensors (no kernel runs here)."""

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
    k5.decode_attend(q3, _meta(n, cap, d, dtype=torch.bfloat16),
                     _meta(n, cap, d, dtype=torch.bfloat16), _meta(n, cap),
                     _meta(n, cap), lengths, num_kv_heads=hkv)
    pages = _meta(5, hkv, page, d, dtype=torch.bfloat16)
    k6.paged_decode(q3, pages, pages, _meta(5, hkv, page),
                    _meta(5, hkv, page),
                    _meta(seqs, max_pages, dtype=torch.int32), lengths)
    assert (k5.decode_attend.launches, k6.paged_decode.launches) == (n5 + 1,
                                                                     n6 + 1)
    (name5, args5), (name6, args6) = library.calls
    assert (name5, name6) == ("mfa_decode_attend", "mfa_paged_decode")
    # split rows, query rows a CTA, threads: the same for both.
    rows = params.decode_split_rows(n, group, cap)
    assert args5[-4:-1] == args6[-4:-1] == (
        rows, params.decode_group_chunk(group),
        params.DECODE_ATTEND_THREADS)


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
