"""Port backward (plain versions of K3/K4 on the CPU, through the autograd
function) against mfa_tpu's flash_attention gradients (Pallas backward
kernels in interpret mode), same numpy inputs; the plain kernels against
the port's analytic oracle; and central differences of the port's
phi_loss against its autograd gradients.

Tolerances as in tests/test_attention_bwd.py: fp32 3e-5 (5e-5 with a
soft-cap), bf16 5e-2 (the mixed-precision budget).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.ops.attention import attention_chunk_grads as jax_chunk_grads
from mfa_tpu.ops.attention import flash_attention as jax_flash
from mfa_tpu_torch.kernels import flash_bwd
from mfa_tpu_torch.ops.attention import attention_chunk_grads, flash_attention
from mfa_tpu_torch.ops.descriptors import (
    AttentionDescriptor,
    AttentionKernelType,
)
from mfa_tpu_torch.ops.reference import attention_grads_reference, phi_loss
from mfa_tpu_torch.utils.testing import assert_close, assert_fully_written


def _np_inputs(seed, hq, hkv, r, c, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, hq, r, d)).astype(np.float32)
    k = rng.standard_normal((1, hkv, c, d)).astype(np.float32)
    v = rng.standard_normal((1, hkv, c, d)).astype(np.float32)
    do = rng.standard_normal((1, hq, r, d)).astype(np.float32)
    return q, k, v, do


def _jax_grads(q, k, v, do, dtype, **kw):
    qj, kj, vj, doj = (jnp.asarray(x, dtype) for x in (q, k, v, do))

    def loss(q_, k_, v_):
        o = jax_flash(q_, k_, v_, **kw)
        return jnp.sum(doj.astype(jnp.float32) * o.astype(jnp.float32))

    return [np.asarray(g, np.float32)
            for g in jax.grad(loss, argnums=(0, 1, 2))(qj, kj, vj)]


def _port_grads(q, k, v, do, dtype, **kw):
    qt, kt, vt = (torch.from_numpy(x).to(dtype).requires_grad_()
                  for x in (q, k, v))
    dot = torch.from_numpy(do).to(dtype)
    o = flash_attention(qt, kt, vt, device="cpu", **kw)
    (dot.float() * o.float()).sum().backward()
    for g, x in zip((qt.grad, kt.grad, vt.grad), (qt, kt, vt)):
        assert g.dtype == x.dtype and g.shape == x.shape
        assert_fully_written(g, "grad")
    return qt.grad, kt.grad, vt.grad


# (name, Hq, Hkv, R, C, D, dtype, options, tolerance)
CASES = [
    ("fp32-64-64-32", 1, 1, 64, 64, 32, "fp32", {}, 3e-5),
    ("fp32-100-120-32", 1, 1, 100, 120, 32, "fp32", {}, 3e-5),
    ("causal-gqa", 4, 2, 96, 160, 32, "fp32", dict(causal=True), 3e-5),
    ("bf16-128-128-64", 1, 1, 128, 128, 64, "bf16", {}, 5e-2),
    ("softcap8", 2, 1, 64, 96, 32, "fp32", dict(logit_soft_cap=8.0), 5e-5),
    ("window", 2, 2, 80, 80, 32, "fp32",
     dict(causal=True, sliding_window=17), 3e-5),
    ("r-gt-c", 2, 1, 120, 72, 32, "fp32", dict(causal=True), 3e-5),
    ("r-lt-c", 2, 1, 40, 136, 32, "fp32", dict(causal=True), 3e-5),
    ("bf16-gqa-window", 4, 1, 70, 90, 64, "bf16",
     dict(sliding_window=24, logit_soft_cap=20.0), 5e-2),
    ("bf16-fp32-o", 2, 1, 64, 80, 32, "bf16",
     dict(causal=True, low_precision_intermediates=False), 5e-2),
    # Head dims past 256 (the D-blocked rows): mfa_tpu's own large-D
    # backward case (tests/test_attention_bwd.py, D 384 at 5e-5), and
    # bf16 at D 384 and 512.
    ("fp32-d384", 1, 1, 48, 64, 384, "fp32", {}, 5e-5),
    ("bf16-d512-causal", 2, 1, 64, 64, 512, "bf16", dict(causal=True),
     5e-2),
    ("bf16-d384-gqa-causal", 4, 2, 40, 72, 384, "bf16", dict(causal=True),
     5e-2),
    # Head dims 129-256 (the head-dim-split rows of one CTA on the card):
    # GQA, causal, and a window with a soft-cap at R != C.
    ("bf16-d192-gqa", 4, 2, 48, 80, 192, "bf16", {}, 5e-2),
    ("bf16-d256-causal", 2, 1, 64, 64, 256, "bf16", dict(causal=True),
     5e-2),
    ("bf16-d256-window-softcap", 2, 1, 40, 72, 256, "bf16",
     dict(sliding_window=24, logit_soft_cap=20.0), 5e-2),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_grads_match_mfa_tpu(case):
    name, hq, hkv, r, c, d, dt, opts, tol = case
    q, k, v, do = _np_inputs(hq + r + c + d, hq, hkv, r, c, d)
    jdt, tdt = ((jnp.float32, torch.float32) if dt == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    want = _jax_grads(q, k, v, do, jdt, **opts)
    got = _port_grads(q, k, v, do, tdt, **opts)
    for label, g, w in zip(("dQ", "dK", "dV"), got, want):
        assert_close(g, w, tol, f"{label} {name}")


def test_chunk_grads_match_mfa_tpu_and_sum_to_full():
    """A global softmax over two kv chunks: each chunk's contribution
    matches mfa_tpu's, and the two sum to the full gradients."""
    q, k, v, do = _np_inputs(11, 4, 2, 48, 96, 32)
    o_j, lse_j = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           with_lse=True)
    o, lse = np.asarray(o_j), np.asarray(lse_j)
    half = 48
    parts = []
    for sl in (slice(0, half), slice(half, 96)):
        want = jax_chunk_grads(*(jnp.asarray(x) for x in (
            q, k[:, :, sl], v[:, :, sl], o, do, lse)))
        got = attention_chunk_grads(*(torch.from_numpy(np.array(x))
                                      for x in (q, k[:, :, sl], v[:, :, sl],
                                                o, do, lse)), device="cpu")
        for label, g, w in zip(("dQ", "dK", "dV"), got, want):
            assert_close(g, np.asarray(w), 3e-5, f"chunk {label}")
        parts.append(got)
    full = _port_grads(q, k, v, do, torch.float32)
    assert_close(parts[0][0] + parts[1][0], full[0], 3e-5, "dQ sum")
    assert_close(torch.cat([parts[0][1], parts[1][1]], 2), full[1], 3e-5,
                 "dK chunks")
    assert_close(torch.cat([parts[0][2], parts[1][2]], 2), full[2], 3e-5,
                 "dV chunks")


@pytest.mark.parametrize("opts", [dict(), dict(causal=True),
                                  dict(sliding_window=9, logit_soft_cap=6.0)],
                         ids=["plain", "causal", "window-softcap"])
def test_plain_kernels_match_oracle(opts):
    """K3/K4's plain versions (with the D-term) against the port's float64
    analytic gradients, GQA group 2."""
    q, k, v, do = (torch.from_numpy(x) for x in _np_inputs(5, 4, 2, 45, 61,
                                                           16))
    o, lse = flash_attention(q, k, v, with_lse=True, device="cpu", **opts)
    kd_q, kd_kv = (AttentionDescriptor(
        batch=1, num_q_heads=4, num_kv_heads=2, seq_len_q=45, seq_len_kv=61,
        head_dim=16, **opts).kernel_descriptor(t)
        for t in (AttentionKernelType.BACKWARD_QUERY,
                  AttentionKernelType.BACKWARD_KEY_VALUE))
    q3, k3, v3, o3, do3 = (x.reshape(-1, x.shape[2], 16)
                           for x in (q, k, v, o, do))
    l3 = lse.reshape(-1, 45)
    kw = dict(group=2, scale=0.25)
    dq, dterm = flash_bwd.flash_bwd_q(q3, k3, v3, o3, do3, l3, kd_q, **kw)
    dk, dv = flash_bwd.flash_bwd_kv(q3, k3, v3, do3, l3, dterm, kd_kv, **kw)
    wq, wk, wv, wd = attention_grads_reference(
        q.double(), k.double(), v.double(), do.double(), **opts)
    assert_close(dq, wq.reshape(dq.shape), 3e-5, "dQ")
    assert_close(dk, wk.reshape(dk.shape), 3e-5, "dK")
    assert_close(dv, wv.reshape(dv.shape), 3e-5, "dV")
    assert_close(dterm, wd.reshape(dterm.shape), 3e-5, "D-term")


def test_unseen_kv_rows_get_zero_grads():
    """Window 8 with R < C: the first keys are seen by no query, so their
    dK and dV are exactly 0 (mfa_tpu's fully-masked kv runs agree)."""
    r, c, w = 24, 80, 8
    q, k, v, do = _np_inputs(3, 2, 1, r, c, 32)
    dq, dk, dv = _port_grads(q, k, v, do, torch.float32, causal=True,
                             sliding_window=w)
    unseen = c - r - (w - 1)          # keys before the first window
    assert unseen > 0
    assert torch.all(dk[:, :, :unseen] == 0)
    assert torch.all(dv[:, :, :unseen] == 0)
    assert torch.any(dk[:, :, unseen:] != 0)
    want = _jax_grads(q, k, v, do, jnp.float32, causal=True,
                      sliding_window=w)
    assert np.all(want[1][:, :, :unseen] == 0)
    for label, g, wv in zip(("dQ", "dK", "dV"), (dq, dk, dv), want):
        assert_close(g, wv, 3e-5, label)


def test_transpose_flags_match_canonical_layout():
    q, k, v, do = (torch.from_numpy(x) for x in _np_inputs(9, 2, 1, 20, 28,
                                                           16))

    def grads(flags):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        ins = [x.transpose(-1, -2) if f else x
               for x, f in zip(xs, flags[:3])]
        o = flash_attention(*ins, causal=True, device="cpu",
                            transpose_q=flags[0], transpose_k=flags[1],
                            transpose_v=flags[2], transpose_o=flags[3])
        if flags[3]:
            o = o.transpose(-1, -2)
        (o * do).sum().backward()
        return [o.detach()] + [x.grad for x in xs]

    base = grads((False, False, False, False))
    for flags in ((True, False, False, False), (False, True, True, True)):
        for a, b in zip(grads(flags), base):
            assert torch.equal(a, b)


def test_with_lse_refuses_grad_inputs():
    q, k, v, _ = (torch.from_numpy(x) for x in _np_inputs(1, 2, 1, 8, 8, 16))
    with pytest.raises(NotImplementedError, match="with_lse"):
        flash_attention(q.requires_grad_(), k, v, with_lse=True,
                        device="cpu")
    with torch.no_grad():
        o, lse = flash_attention(q, k, v, with_lse=True, device="cpu")
    assert lse.shape == (1, 2, 8)


def _directional_check(rng, q, k, v, do, kw, n_dirs=4, eps=2e-3,
                       rtol=2e-2):
    """Central differences of phi_loss (the port's oracle forward) along
    random unit directions against <autograd grad, u>, relative to the
    gradient norm (as tests/test_finite_diff.py)."""
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    o = flash_attention(*xs, device="cpu", **kw)
    (o * do).sum().backward()
    grads = [x.grad for x in xs]
    scale = float(sum((g ** 2).sum() for g in grads)) ** 0.5
    for _ in range(n_dirs):
        dirs = [rng.standard_normal(x.shape).astype(np.float32)
                for x in (q, k, v)]
        norm = sum(float((u ** 2).sum()) for u in dirs) ** 0.5
        dirs = [torch.from_numpy(u / norm) for u in dirs]
        plus = phi_loss(*(x + eps * u for x, u in zip((q, k, v), dirs)), do,
                        **kw)
        minus = phi_loss(*(x - eps * u for x, u in zip((q, k, v), dirs)),
                         do, **kw)
        fd = (float(plus) - float(minus)) / (2.0 * eps)
        analytic = float(sum((g * u).sum() for g, u in zip(grads, dirs)))
        assert abs(fd - analytic) <= rtol * max(scale, 1e-6), (
            f"fd={fd:.6g} analytic={analytic:.6g} (grad scale {scale:.3g})")


@pytest.mark.parametrize("kw", [
    {},
    {"causal": True},
    {"logit_soft_cap": 8.0},
    {"sliding_window": 16, "causal": True},
], ids=["plain", "causal", "softcap", "window"])
def test_finite_difference_fp32(kw):
    rng = np.random.default_rng(0)
    b, hq, hkv, r, c, d = 1, 2, 1, 24, 32, 32
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for s in ((b, hq, r, d), (b, hkv, c, d), (b, hkv, c, d),
                             (b, hq, r, d)))
    _directional_check(rng, q, k, v, do, kw)
