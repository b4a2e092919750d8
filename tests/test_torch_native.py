"""The port's C++ host config core (``mfa_tpu_torch/runtime/``, bridged by
``mfa_tpu_torch/ops/native.py``) against the port's Python, as
``tests/test_native.py`` holds ``runtime/`` against ``mfa_tpu``: the
table parser and row select on every table (and the same errors), the
shared memory of every row and every autotune candidate in bf16 and
fp32, K7's tile heuristic over a grid of problems, the key hash equal to
``mfa_tpu``'s, the two-level cache's counts equal to the Python cache's,
the host bench within its budget, and one build for processes started
together. g++ builds the library here as on the card."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from mfa_tpu.ops import native as jax_native
from mfa_tpu_torch.ops import native, params
from mfa_tpu_torch.ops.cache import TwoLevelCache
from mfa_tpu_torch.ops.descriptors import GEMMDescriptor
from mfa_tpu_torch.ops.precision import OperandPrecision as P

ROOT = Path(__file__).resolve().parents[1]
TABLES = sorted(params._TABLES["sm90"])


@pytest.mark.parametrize("key", TABLES, ids=["-".join(k) for k in TABLES])
def test_parse_and_select_match_python(key):
    text = params._TABLES["sm90"][key]
    rows = params.parse_table(text)
    assert native.parse_table(text) == rows
    for d in range(1, 1100, 3):
        assert native.select_row(rows, d) == params.select_row(rows, d)
    assert native.parameter_table(*key) == params.parameter_table(*key)


@pytest.mark.parametrize("text", [
    "inf | 4 | 5 | 6 | Q, K",            # a fifth column naming no kernel
    "64 | 1 | 2",                         # three columns
    "# max_d | block_q\n\n",              # no row
    "64 | 1 | 2 | 3\n128 | 1 | 2 | 3",   # a bounded last row
    "64 | x | 2 | 3\ninf | 1 | 2 | 3",   # not an integer
])
def test_malformed_tables_raise_as_python(text):
    with pytest.raises(ValueError) as want:
        params.parse_table(text)
    with pytest.raises(ValueError) as got:
        native.parse_table(text)
    assert str(got.value) == str(want.value)


def test_parameter_table_refuses_as_python():
    small = params.HopperDevice("sm90", 132, 48 * 1024, (9, 0))
    ampere = params.HopperDevice("sm80", 108, 166_912, (8, 0))
    for device in (small, ampere):
        for fn in (params.parameter_table, native.parameter_table):
            with pytest.raises(ValueError, match="shared memory|sm80"):
                fn("flash_fwd", "bf16", device)


def _smem_rows():
    """Every table row, every autotune candidate (params.
    flash_candidate_rows) at head dims from 1 to 600, K1's rows with the
    copying producer, and some rows of no table."""
    rows = set()
    for (kernel, _), text in params._TABLES["sm90"].items():
        rows |= {(kernel, r) for r in params.parse_table(text)}
    for kernel in ("flash_fwd", "flash_bwd_q", "flash_bwd_kv"):
        for d in (1, 32, 64, 80, 96, 100, 128, 136, 160, 192, 200, 250, 256,
                  300, 320, 384, 500, 512, 600):
            for in_bytes in (2, 4):
                rows |= {(kernel, r) for r in
                         params.flash_candidate_rows(kernel, d, in_bytes)}
    rows |= {(kernel, params.ParameterRow(d, bq, bkv, bd, k, "copy"))
             for kernel, instances in params.COPY_ROWS.items()
             for bq, bkv, bd in instances
             for d, k in ((bd, "wgmma"), (bd, "wgmma_dblk"))}
    rows |= {(kernel, params.ParameterRow(0, 128, 64, bd, "wgmma_dblk"))
             for kernel in ("flash_fwd", "flash_bwd_q", "flash_bwd_kv")
             for bd in (128, 192, 256)}
    return sorted(rows, key=repr)


def test_smem_bytes_match_python_for_every_row_and_candidate():
    rows = _smem_rows()
    assert len(rows) > 200
    for kernel, row in rows:
        for in_bytes in (2, 4):
            assert native.smem_bytes(kernel, row, in_bytes) == \
                params.smem_bytes(kernel, row, in_bytes), (kernel, row)


PRECISIONS = [(P.BF16, P.BF16), (P.FP16, P.FP16), (P.FP32, P.FP32),
              (P.BF16, P.FP32), (P.FP16, P.BF16), (P.INT8, P.INT8)]
SIDES = (1, 7, 16, 17, 64, 100, 127, 129, 200, 1000, 1032, 1536, 2048, 4096)


@pytest.mark.parametrize("a_prec, b_prec", PRECISIONS,
                         ids=[f"{a.value}-{b.value}" for a, b in PRECISIONS])
def test_gemm_tile_matches_python(a_prec, b_prec):
    for m in SIDES:
        for n in SIDES:
            for k, batch in ((1536, 1), (4096, 3)):
                for ta, tb in ((False, False), (True, False), (False, True),
                               (True, True)):
                    desc = GEMMDescriptor(
                        m=m, n=n, k=k, a_precision=a_prec,
                        b_precision=b_prec, c_precision=a_prec,
                        transpose_a=ta, transpose_b=tb, batch=batch)
                    kd = desc.kernel_descriptor()
                    want = (kd.tile.name,
                            kd.mma_tile.name if kd.mma_tile else None)
                    assert native.gemm_tile(desc) == want, desc


def test_gemm_tile_refuses_as_python():
    small = params.HopperDevice("sm90", 132, 64 * 1024, (9, 0))
    desc = GEMMDescriptor(m=4096, n=4096, k=4096, a_precision=P.BF16,
                          b_precision=P.BF16)
    with pytest.raises(ValueError, match="shared memory"):
        desc.kernel_descriptor(small)
    with pytest.raises(ValueError, match="shared memory"):
        native.gemm_tile(desc, small)
    few = params.HopperDevice("sm90", 16, params.H100.smem_per_block, (9, 0))
    kd = desc.kernel_descriptor(few)
    assert native.gemm_tile(desc, few) == (kd.tile.name, kd.mma_tile.name)


def test_hash_matches_mfa_tpu():
    assert jax_native.load() is not None
    for n in range(0, 41):
        data = bytes((7 * i + n) % 256 for i in range(n))
        assert native.hash_bytes(data) == jax_native.hash_bytes(data), n
    assert native.hash_bytes(b"attention-kernel-key") != \
        native.hash_bytes(b"attention-kernel-kez")


def test_cache_counts_match_python():
    keys = [(3, 1), (4, 1), (3, 1), (5, 2), (4, 1), (6, 2), (5, 2), (7, 3),
            (3, 1), (8, 1)]
    py = TwoLevelCache("python")
    with native.HostCache() as cc:
        for problem, kernel in keys:
            got = [c.get_pipeline(
                str(problem).encode() if c is cc else problem,
                str(kernel).encode() if c is cc else kernel,
                lambda kernel=kernel: ("kernel", kernel),
                lambda kern, problem=problem: (kern, problem))
                for c in (py, cc)]
            assert got[0] == got[1]
        assert cc.stats == py.stats
        assert (cc.stats.pipeline_hits, cc.stats.library_hits) == (4, 3)
        cc.clear()
        py.clear()
        assert cc.stats == py.stats


def test_host_bench_meets_its_budget():
    out = native.host_bench()
    assert out.rstrip().endswith("host-path budget OK")
    assert "w256 (mma.sync m128)" in out
    assert out.count("ns/call") == 5


def test_host_library_builds_once_for_processes_started_together(tmp_path):
    """Six processes ask for the host library at once: one runs g++, the
    others wait on the build's file lock and load that build."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from mfa_tpu_torch.ops import native\n"
        "native.BUILD_DIR = Path(sys.argv[1])\n"
        "lib = native.load()\n"
        "print('compiled' if lib.compiled else 'loaded', "
        "native.hash_bytes(b'x'))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=180) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    words = sorted(o[0].split()[0] for o in outs)
    assert words == ["compiled"] + ["loaded"] * 5
    assert len({o[0].split()[1] for o in outs}) == 1
    assert (tmp_path / native.LIB_NAME).exists()
    assert (tmp_path / native.BENCH_NAME).exists()
