"""Port INT4 weight packing and int4_matmul (plain kernel version on the
CPU) against mfa_tpu's quant primitives and its int4_matmul in Pallas
interpret mode, on the same numpy inputs: packing bit for bit, products
signed and biased in fp32 (rel 1e-5) and bf16 (one bf16 ulp of |y|) with
ragged M and N, and the explicit layout tag."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.kernels import quant as jquant
from mfa_tpu.kernels.quant_matmul import int4_matmul as jax_int4_matmul
from mfa_tpu_torch.kernels import quant
from mfa_tpu_torch.kernels.quant_matmul import (
    int4_matmul,
    int4_matmul_plain,
    int4_tile,
)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _w(rng, k, n):
    return (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)


@pytest.mark.parametrize("shape", [(64, 48), (2, 3), (130, 7)])
def test_half_split_packing_bit_equal(rng, shape):
    w = _w(rng, *shape)
    for jfn, tfn in ((jquant.pack_int4_halves, quant.pack_int4_halves),
                     (jquant.pack_int4_biased, quant.pack_int4_biased)):
        jp, js = jfn(jnp.asarray(w))
        tp, ts = tfn(torch.from_numpy(w))
        assert tp.dtype == {jnp.int8: torch.int8, jnp.uint8: torch.uint8}[
            jp.dtype.type]
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jp, _ = jquant.pack_int4_halves(jnp.asarray(w))
    for got, want in zip(quant.unpack_int4_halves(_t(jp)),
                         jquant.unpack_int4_halves(jp)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jb, _ = jquant.pack_int4_biased(jnp.asarray(w))
    for got, want in zip(quant.unpack_int4_biased(_t(jb)),
                         jquant.unpack_int4_biased(jb)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_interleaved_int4_bit_equal(rng):
    x = rng.standard_normal((5, 3, 16)).astype(np.float32)
    for axis in (-1, 0):
        jp, js = jquant.quantize_int4(jnp.asarray(x), axis=axis)
        tp, ts = quant.quantize_int4(torch.from_numpy(x), axis=axis)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(quant.unpack_int4(tp).numpy(),
                                      np.asarray(jquant.unpack_int4(jp)))
        np.testing.assert_array_equal(
            quant.dequantize_int4(tp, ts).numpy(),
            np.asarray(jquant.dequantize_int4(jp, js)))
    with pytest.raises(ValueError, match="even"):
        quant.quantize_int4(torch.zeros(2, 3))
    with pytest.raises(ValueError, match="even"):
        quant.pack_int4_halves(torch.zeros(3, 2))


def test_quantize_weight_is_the_transposed_pack(rng):
    """The port's [N, K/2] layout holds mfa_tpu's [K/2, N] bytes."""
    w = _w(rng, 96, 40)
    jp, js = jquant.pack_int4_halves(jnp.asarray(w))
    qw = quant.quantize_weight(torch.from_numpy(w.T.copy()), "int4")
    np.testing.assert_array_equal(qw.w.numpy(), np.asarray(jp).T)
    np.testing.assert_array_equal(qw.scale.numpy(), np.asarray(js)[0])
    jb, _ = jquant.pack_int4_biased(jnp.asarray(w))
    qb = quant.quantize_weight(torch.from_numpy(w.T.copy()), "int4_biased")
    np.testing.assert_array_equal(qb.w.numpy(), np.asarray(jb).T)
    assert qb.w.shape == (40, 48) and qb.scale.shape == (40,)
    # Dequantized: the same weight from both layouts.
    assert torch.equal(qw.dequantize(), qb.dequantize())


# (layout, dtype, M, N, K): ragged M and N against mfa_tpu's blocks.
CASES = [(layout, dt, m, n, k)
         for layout in ("int4", "int4_biased")
         for dt in ("fp32", "bf16")
         for m, n, k in ((1, 64, 64), (13, 100, 128), (70, 33, 96))]


@pytest.mark.parametrize("case", CASES,
                         ids=[f"{c[0]}-{c[1]}-M{c[2]}-N{c[3]}-K{c[4]}"
                              for c in CASES])
def test_int4_matmul_matches_mfa_tpu(rng, case):
    layout, dt, m, n, k = case
    w = _w(rng, k, n)
    pack = (jquant.pack_int4_biased if layout == "int4_biased"
            else jquant.pack_int4_halves)
    jp, js = pack(jnp.asarray(w))
    jdt = jnp.float32 if dt == "fp32" else jnp.bfloat16
    xj = jnp.asarray(rng.standard_normal((2, m, k)), jdt)
    want = np.asarray(jnp.asarray(
        jax_int4_matmul(xj, jp, js, interpret=True), jnp.float32))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.float32 if dt == "fp32" else torch.bfloat16)
    got = int4_matmul(xt, _t(jp).t().contiguous(), _t(js)[0], layout=layout,
                      device="cpu")
    assert got.dtype == xt.dtype and got.shape == (2, m, n)
    g = got.float().numpy()
    if dt == "fp32":
        np.testing.assert_allclose(g, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    else:
        # One bf16 ulp of |y|: the sums differ in order, then round.
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want),
                                                  1e-30))) - 7)
        assert (np.abs(g - want) <= ulp).all(), np.abs(g - want).max()


def test_layout_must_match_bytes(rng):
    qw = quant.quantize_weight(torch.from_numpy(_w(rng, 64, 8).T.copy()),
                               "int4")
    x = torch.zeros(2, 64)
    with pytest.raises(TypeError, match="int4_biased"):
        int4_matmul(x, qw.w, qw.scale, layout="int4_biased", device="cpu")
    with pytest.raises(TypeError, match="'int4'"):
        int4_matmul(x, qw.w.view(torch.uint8), qw.scale, layout="int4",
                    device="cpu")
    with pytest.raises(ValueError, match="layout"):
        int4_matmul(x, qw.w, qw.scale, layout="int8", device="cpu")
    with pytest.raises(ValueError, match="K/2"):
        int4_matmul(torch.zeros(2, 66), qw.w, qw.scale, layout="int4",
                    device="cpu")
    with pytest.raises(ValueError, match="scale"):
        int4_matmul(x, qw.w, qw.scale[None], layout="int4", device="cpu")
    with pytest.raises(TypeError, match="layout"):
        quant.QuantizedWeight(qw.w, qw.scale, "int4_biased")
    with pytest.raises(ValueError, match="unknown"):
        quant.QuantizedWeight(qw.w, qw.scale, "int3")


def test_plain_version_handles_leading_dims_and_tiles(rng):
    qw = quant.quantize_weight(torch.from_numpy(_w(rng, 64, 8).T.copy()),
                               "int4_biased")
    x = torch.randn(3, 5, 64)
    y = int4_matmul_plain(x, qw.w, qw.scale, layout="int4_biased")
    assert torch.equal(y[1], int4_matmul_plain(x[1], qw.w, qw.scale,
                                               layout="int4_biased"))
    torch.testing.assert_close(y, x @ qw.dequantize().t(), rtol=1e-5,
                               atol=1e-5)
    assert int4_tile(4, 14336, torch.bfloat16).name == "d8"
    assert int4_tile(16, 14336, torch.bfloat16).name == "d16"
    assert int4_tile(17, 14336, torch.bfloat16).name == "w128"
    assert int4_tile(2048, 14336, torch.bfloat16).name == "w256"
    assert int4_tile(4, 14336, torch.float32).path == "ffma"


# K % 32 != 0 (K/2 bytes a packed row not a multiple of 16) and packed
# weights shifted off 16 bytes: (layout, x type, M, K), N 64. On the card
# the wrapper re-splits these (quant_matmul.repack_halves) before K8.
REPACK_CASES = [(layout, dt, m, k)
                for layout in ("int4", "int4_biased")
                for dt in ("fp32", "bf16")
                for m in (4, 64)
                for k in (40, 100, 4080)]


@pytest.mark.parametrize("case", REPACK_CASES,
                         ids=[f"{c[0]}-{c[1]}-M{c[2]}-K{c[3]}"
                              for c in REPACK_CASES])
def test_int4_matmul_at_any_even_k_matches_mfa_tpu(rng, case):
    """int4_matmul at K % 32 != 0 on packed weights 8 or 3 bytes off 16,
    and the same product over the re-split operands (K' = K rounded up to
    32: the packed rows padded with zero bytes past K/2, x's halves each
    padded with zeros), against mfa_tpu's int4_matmul, which pads K
    itself; and the re-split product equal to the unpadded one wherever
    the sums are exact (integer x)."""
    from mfa_tpu_torch.kernels.quant_matmul import repack_halves
    from mfa_tpu_torch.utils.testing import shifted_copy

    layout, dt, m, k = case
    n = 64
    w = _w(rng, k, n)
    pack = (jquant.pack_int4_biased if layout == "int4_biased"
            else jquant.pack_int4_halves)
    jp, js = pack(jnp.asarray(w))
    jdt = jnp.float32 if dt == "fp32" else jnp.bfloat16
    xj = jnp.asarray(rng.standard_normal((m, k)), jdt)
    want = np.asarray(jnp.asarray(
        jax_int4_matmul(xj, jp, js, interpret=True), jnp.float32))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.float32 if dt == "fp32" else torch.bfloat16)
    packed = shifted_copy(_t(jp).t().contiguous(), 8 if m == 4 else 3)
    assert packed.data_ptr() % 16 in (3, 8)
    scale = _t(js)[0]
    xp, wp = repack_halves(xt, packed)
    kp = -(-k // 32) * 32
    assert xp.shape == (m, kp) and wp.shape == (n, kp // 2)
    assert wp.is_contiguous() and wp.dtype == packed.dtype
    assert not wp[:, k // 2:].any() and torch.equal(wp[:, :k // 2], packed)
    assert torch.equal(xp[:, :k // 2], xt[:, :k // 2])
    assert torch.equal(xp[:, kp // 2:kp // 2 + k // 2], xt[:, k // 2:])
    assert not xp[:, k // 2:kp // 2].any() and not xp[:, -(kp - k) // 2:].any()
    for got in (int4_matmul(xt, packed, scale, layout=layout, device="cpu"),
                int4_matmul_plain(xp, wp, scale, layout=layout)):
        assert got.dtype == xt.dtype and got.shape == (m, n)
        g = got.float().numpy()
        if dt == "fp32":
            np.testing.assert_allclose(g, want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max())
        else:
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want),
                                                      1e-30))) - 7)
            assert (np.abs(g - want) <= ulp).all(), np.abs(g - want).max()
    xi = torch.from_numpy(rng.integers(-3, 4, (m, k)).astype(np.float32))
    xi = xi.to(xt.dtype)
    xip, _ = repack_halves(xi, packed)
    assert torch.equal(int4_matmul_plain(xip, wp, torch.ones(n),
                                         layout=layout),
                       int4_matmul_plain(xi, packed, torch.ones(n),
                                         layout=layout))
