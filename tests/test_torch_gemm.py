"""Port gemm (plain kernel version on the CPU) against mfa_tpu's gemm
(Pallas interpret mode) on the same numpy inputs, mirroring
tests/test_gemm.py: block-straddling sizes, the four transpose states,
C0, batched, bf16 and the mixed-precision fuzz over embedded slices, at
that file's tolerances. Also the Hopper tile heuristic and the cache."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.ops.gemm import gemm as jax_gemm
from mfa_tpu_torch.ops import params
from mfa_tpu_torch.ops.cache import gemm_cache
from mfa_tpu_torch.ops.descriptors import GEMMDescriptor
from mfa_tpu_torch.ops.gemm import gemm
from mfa_tpu_torch.ops.precision import OperandPrecision
from mfa_tpu_torch.utils.testing import assert_close

_TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _pair(x: np.ndarray, dt):
    """The same values for both sides: rounded to dt once, in numpy."""
    j = jnp.asarray(x, dt)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(_TORCH[dt])
    return j, t


def _both(a, b, c0=None, **kw):
    jkw = dict(kw)
    tkw = dict(kw)
    if "out_dtype" in kw:
        tkw["out_dtype"] = _TORCH[kw["out_dtype"]]
    got = gemm(a[1], b[1], None if c0 is None else c0[1], device="cpu",
               **tkw)
    want = jax_gemm(a[0], b[0], None if c0 is None else c0[0], **jkw)
    return got, np.asarray(jnp.asarray(want, jnp.float32))


SIZES = [7, 64, 127, 128, 129, 200]


@pytest.mark.parametrize("n", SIZES)
def test_square(rng, n):
    a = _pair(rng.standard_normal((n, n)), jnp.float32)
    b = _pair(rng.standard_normal((n, n)), jnp.float32)
    got, want = _both(a, b)
    assert got.dtype == torch.float32 and got.shape == (n, n)
    assert_close(got, want, 1e-4 * max(1, n / 64), f"C {n}^2")


@pytest.mark.parametrize("ta", [False, True])
@pytest.mark.parametrize("tb", [False, True])
def test_transpose_states(rng, ta, tb):
    m, k, n = 65, 130, 33
    a = _pair(rng.standard_normal((k, m) if ta else (m, k)), jnp.float32)
    b = _pair(rng.standard_normal((n, k) if tb else (k, n)), jnp.float32)
    got, want = _both(a, b, transpose_a=ta, transpose_b=tb)
    assert_close(got, want, 5e-4, f"C T{ta}{tb}")


def test_accumulate(rng):
    m, k, n = 40, 50, 60
    a = _pair(rng.standard_normal((m, k)), jnp.float32)
    b = _pair(rng.standard_normal((k, n)), jnp.float32)
    c0 = _pair(rng.standard_normal((m, n)), jnp.float32)
    got, want = _both(a, b, c0)
    assert_close(got, want, 5e-4, "C +=")


def test_batched(rng):
    a = _pair(rng.standard_normal((3, 17, 29)), jnp.float32)
    b = _pair(rng.standard_normal((3, 29, 23)), jnp.float32)
    got, want = _both(a, b)
    assert got.shape == (3, 17, 23)
    assert_close(got, want, 5e-4, "C batched")


def test_bf16(rng):
    m = 96
    a = _pair(rng.standard_normal((m, m)), jnp.bfloat16)
    b = _pair(rng.standard_normal((m, m)), jnp.bfloat16)
    got, want = _both(a, b, out_dtype=jnp.float32)
    assert_close(got, want, 0.5, "C bf16")
    # Default output type: the promotion of the operands, bf16 here.
    assert gemm(a[1], b[1], device="cpu").dtype == torch.bfloat16


def test_fuzz(rng):
    for _ in range(6):
        m, n, k = (int(rng.uniform(0, 1) ** 3 * 200) + 1 for _ in range(3))
        ta, tb = bool(rng.integers(2)), bool(rng.integers(2))
        acc = bool(rng.integers(2))
        a = _pair(rng.standard_normal((k, m) if ta else (m, k)), jnp.float32)
        b = _pair(rng.standard_normal((n, k) if tb else (k, n)), jnp.float32)
        c0 = (_pair(rng.standard_normal((m, n)), jnp.float32) if acc
              else None)
        got, want = _both(a, b, c0, transpose_a=ta, transpose_b=tb)
        assert_close(got, want, 1e-3,
                     f"fuzz m={m} n={n} k={k} ta={ta} tb={tb} acc={acc}")


_DTYPES = [jnp.float32, jnp.bfloat16]


def _tolerance(dtypes, k):
    base = 2e-5 if all(dt == jnp.float32 for dt in dtypes) else 5e-2
    return base * max(1.0, k / 256.0) * 3.0


def _cubed_dim(r, lo=1, hi=384):
    return int(lo + (hi - lo) * r.uniform() ** 3)


@pytest.mark.parametrize("trial", range(12))
def test_adversarial_fuzz(trial):
    """Random shapes, per-operand precisions, transposes and C0, operands
    sliced out of over-sized buffers (strided, never copied on the card)."""
    rng = np.random.default_rng(100 + trial)
    m, n, k = (_cubed_dim(rng) for _ in range(3))
    ta, tb = bool(rng.integers(2)), bool(rng.integers(2))
    with_c0 = bool(rng.integers(2))
    a_dt = _DTYPES[rng.integers(len(_DTYPES))]
    b_dt = _DTYPES[rng.integers(len(_DTYPES))]

    def embedded(shape, dt):
        big = rng.standard_normal((shape[0] + int(rng.integers(1, 9)),
                                   shape[1] + int(rng.integers(1, 9))))
        j, t = _pair(big, dt)
        return j[:shape[0], :shape[1]], t[:shape[0], :shape[1]]

    a = embedded((k, m) if ta else (m, k), a_dt)
    b = embedded((n, k) if tb else (k, n), b_dt)
    c0 = embedded((m, n), jnp.float32) if with_c0 else None
    assert not a[1].is_contiguous() or a[1].shape[0] == 1
    got, want = _both(a, b, c0, transpose_a=ta, transpose_b=tb,
                      out_dtype=jnp.float32)
    assert_close(got, want, _tolerance((a_dt, b_dt), k),
                 f"fuzz[{trial}] m={m} n={n} k={k} ta={ta} tb={tb} "
                 f"c0={with_c0} {a_dt.__name__}/{b_dt.__name__}")


def test_refusals():
    a = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="K mismatch"):
        gemm(a, a, device="cpu")
    with pytest.raises(ValueError, match="batch mismatch"):
        gemm(torch.zeros(2, 4, 8), torch.zeros(3, 8, 4), device="cpu")
    with pytest.raises(ValueError, match="2-D or 3-D"):
        gemm(a, torch.zeros(1, 8, 4), device="cpu")
    with pytest.raises(ValueError, match="c0 must be"):
        gemm(a, a.t(), torch.zeros(4, 5), device="cpu")
    with pytest.raises(TypeError, match="fp32, bf16 or fp16"):
        gemm(a.double(), a.t().double(), device="cpu")


def _kd(m, n, k, prec=OperandPrecision.BF16, b_prec=None, batch=1, **kw):
    return GEMMDescriptor(m=m, n=n, k=k, a_precision=prec,
                          b_precision=b_prec or prec, c_precision=prec,
                          batch=batch, **kw).kernel_descriptor()


def test_tile_heuristic():
    """block_m follows M: decode-sized M takes the 16-row tile; above it
    bf16 takes a wgmma tile, with the mma.sync tile for operands TMA
    cannot map beside it (128 x 128 for problems that fill the card,
    64 x 64 below), and fp16 that mma.sync tile; fp32 and mixed operands
    the FMA tile. Every tile fits one SM's shared memory."""
    assert _kd(4, 4096, 4096).tile.block_m == 16
    assert _kd(16, 14336, 4096).tile.block_m == 16
    kd = _kd(4096, 4096, 4096)
    assert (kd.tile.name, kd.mma_tile.name) == ("w256", "m128")
    kd = _kd(200, 129, 127)                               # 4 tiles of 128
    assert (kd.tile.name, kd.mma_tile.name) == ("w128", "m64")
    kd = _kd(256, 256, 64, batch=40)
    assert (kd.tile.name, kd.mma_tile.name) == ("w256", "m128")
    assert _kd(4096, 4096, 4096, OperandPrecision.FP16).tile.name == "m128"
    assert _kd(200, 129, 127, OperandPrecision.FP16).tile.name == "m64"
    assert _kd(64, 64, 64, OperandPrecision.FP32).tile.path == "ffma"
    assert _kd(64, 64, 64, OperandPrecision.BF16,
               OperandPrecision.FP32).tile.path == "ffma"
    assert _kd(64, 64, 64, OperandPrecision.FP16,
               OperandPrecision.BF16).tile.path == "ffma"
    kd = _kd(8, 8, 8, transpose_a=True, load_previous_c=True)
    assert kd.transpose_a and kd.load_previous_c and not kd.transpose_b
    small = params.HopperDevice("sm90", 132, 32 * 1024, (9, 0))
    with pytest.raises(ValueError, match="shared memory"):
        GEMMDescriptor(m=4096, n=4096, k=4096,
                       a_precision=OperandPrecision.BF16,
                       b_precision=OperandPrecision.BF16).kernel_descriptor(
                           small)


def test_cache_hit_skips_descriptor(monkeypatch, rng):
    a = torch.from_numpy(rng.standard_normal((9, 11)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((11, 13)).astype(np.float32))
    gemm_cache.clear()
    gemm(a, b, device="cpu")
    assert gemm_cache.stats.pipeline_misses == 1

    def no_descriptor(*_, **__):
        raise AssertionError("descriptor built on a cache hit")

    monkeypatch.setattr(GEMMDescriptor, "kernel_descriptor", no_descriptor)
    gemm(a, b, device="cpu")
    assert gemm_cache.stats.pipeline_hits == 1
