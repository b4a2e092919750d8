"""Port flash forward (plain version of K1 on the CPU) against mfa_tpu's
flash_attention (Pallas kernels in interpret mode), same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.ops.attention import flash_attention as jax_flash
from mfa_tpu_torch.ops import attention as port_attention
from mfa_tpu_torch.ops.attention import flash_attention, mha
from mfa_tpu_torch.ops.precision import (
    AttentionOperand,
    make_precision_policy,
    tolerance_for,
)
from mfa_tpu_torch.ops.reference import attention_reference
from mfa_tpu_torch.utils.testing import (
    assert_close,
    assert_fully_written,
    make_attention_inputs,
)

HQ, HKV = 4, 2

# (dtype, D, R, C, options)
CASES = [
    ("fp32", 64, 128, 128, dict(causal=True)),
    ("fp32", 32, 77, 150, dict()),
    ("fp32", 128, 150, 96, dict(causal=True)),          # R > C: empty rows
    ("fp32", 64, 160, 160, dict(sliding_window=33)),
    ("fp32", 64, 96, 96, dict(causal=True, logit_soft_cap=10.0)),
    ("bf16", 128, 192, 192, dict(causal=True)),
    ("bf16", 64, 100, 180, dict()),
    ("bf16", 32, 130, 70, dict(causal=True)),           # R > C: empty rows
    ("bf16", 64, 128, 128, dict(sliding_window=40, logit_soft_cap=20.0)),
    # Head dims past 256 (the D-blocked rows), mfa_tpu's large-D class
    # (tests/test_attention_fwd.py): 3 and 4 block_d slices there.
    ("fp32", 384, 160, 96, dict()),
    ("fp32", 512, 128, 160, dict()),
    ("bf16", 384, 128, 128, dict(causal=True)),         # GQA 4 / 2
    # D 129-256 (one CTA of the head-dim-split kernel on the card):
    # GQA 4 / 2 causal, R != C, soft-cap 50 with a window.
    ("bf16", 256, 160, 160, dict(causal=True)),
    ("bf16", 192, 96, 176, dict()),
    ("bf16", 256, 128, 128, dict(sliding_window=48, logit_soft_cap=50.0)),
    # Rows TMA cannot map, on the wgmma kernel's copying producer on the
    # card: OpenLLaMA-3B's D 100 causal, D 250 R != C.
    ("bf16", 100, 160, 160, dict(causal=True)),
    ("bf16", 250, 96, 144, dict()),
]


def _inputs(seed, r, c, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, HQ, r, d)).astype(np.float32)
    k = rng.standard_normal((1, HKV, c, d)).astype(np.float32)
    v = rng.standard_normal((1, HKV, c, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("dt,d,r,c,opts", CASES,
                         ids=[f"{c[0]}-D{c[1]}-R{c[2]}-C{c[3]}-{i}"
                              for i, c in enumerate(CASES)])
def test_flash_fwd_matches_mfa_tpu(dt, d, r, c, opts):
    q, k, v = _inputs(d + r + c, r, c, d)
    jdt, tdt = ((jnp.float32, torch.float32) if dt == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    o_j, l_j = jax_flash(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                         jnp.asarray(v, jdt), with_lse=True, **opts)
    o_t, l_t = flash_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), with_lse=True, device="cpu", **opts)
    assert o_t.dtype == tdt and l_t.dtype == torch.float32
    assert_fully_written(o_t, "O")
    policy = make_precision_policy(dt == "bf16", dt == "bf16")
    assert_close(o_t, np.asarray(o_j, np.float32),
                 tolerance_for(policy, AttentionOperand.O), "O")
    assert_close(l_t, np.asarray(l_j, np.float32),
                 tolerance_for(policy, AttentionOperand.L), "L")
    if opts.get("causal") and r > c:
        dead = r - c          # rows whose diagonal falls before key 0
        assert torch.all(o_t[:, :, :dead] == 0)
        assert torch.all(l_t[:, :, :dead] == 0)


@pytest.mark.parametrize("opts", [dict(), dict(causal=True),
                                  dict(sliding_window=9, logit_soft_cap=4.0)])
def test_flash_fwd_fp32_matches_oracle(opts):
    """The plain version against the port's own oracle (float64)."""
    q, k, v, _ = make_attention_inputs(np.random.default_rng(7), 2, 4, 2,
                                       45, 61, 16)
    o, l = flash_attention(q, k, v, with_lse=True, device="cpu", **opts)
    o_ref, l_ref = attention_reference(q.double(), k.double(), v.double(),
                                       **opts)
    assert_close(o, o_ref, 2e-5, "O")
    assert_close(l, l_ref, 2e-5, "L")


def test_low_precision_intermediates_false_gives_fp32_o():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _inputs(3, 32, 32, 32))
    o = flash_attention(q, k, v, causal=True, device="cpu",
                        low_precision_intermediates=False)
    assert o.dtype == torch.float32


def test_mha_layout_matches_bhsd():
    q, k, v = (torch.from_numpy(x) for x in _inputs(5, 24, 24, 32))
    o = flash_attention(q, k, v, causal=True, device="cpu")
    o2 = mha(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
             causal=True, device="cpu")
    assert torch.equal(o2.transpose(1, 2), o)


def test_refusals():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 8, 8, 32))
    with pytest.raises(NotImplementedError, match="backward"):
        flash_attention(q.requires_grad_(), k, v, with_lse=True,
                        device="cpu")
    q = q.detach()
    # A head dim past 256 answers (the D-blocked rows), as the fp64
    # oracle does.
    big = [torch.from_numpy(x) for x in _inputs(4, 8, 8, 264)]
    o = flash_attention(*big, device="cpu")
    o_ref, _ = attention_reference(*(x.double() for x in big))
    assert_close(o, o_ref, 2e-5, "O D=264")
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(torch.zeros(1, 3, 8, 32), k, v, device="cpu")


def test_kernel_cache_reuses_pipeline(monkeypatch):
    cache = port_attention.attention_cache
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 19, 19, 32))
    o = flash_attention(q, k, v, causal=True, device="cpu")
    hits = cache.stats.pipeline_hits

    def no_descriptor(**_):
        raise AssertionError("a pipeline hit built a descriptor")

    # A hit reuses the bound launch: no descriptor, table row or policy.
    with monkeypatch.context() as m:
        m.setattr(port_attention, "AttentionDescriptor", no_descriptor)
        assert torch.equal(flash_attention(q, k, v, causal=True,
                                           device="cpu"), o)
    assert cache.stats.pipeline_hits == hits + 1
    # Another length in the same shape class reuses the kernel descriptor.
    lib_hits = cache.stats.library_hits
    flash_attention(q[:, :, :11], k, v, causal=True, device="cpu")
    assert cache.stats.library_hits == lib_hits + 1


@pytest.mark.parametrize("opts", [dict(causal=True), dict(),
                                  dict(sliding_window=33),
                                  dict(causal=True, logit_soft_cap=10.0)],
                         ids=["causal", "full", "window", "softcap"])
def test_attention_fp64_matches_the_fp32_plain_version(opts):
    """utils/testing.py::attention_fp64, the exact K1 that the rounding
    checks hold K1 to, against K1's fp32 plain version (R > C: empty rows
    give 0), and over |v| the terms' magnitude bounds |O|."""
    from mfa_tpu_torch.kernels.flash_fwd import flash_fwd_plain
    from mfa_tpu_torch.ops.descriptors import (
        AttentionDescriptor,
        AttentionKernelType,
    )
    from mfa_tpu_torch.utils.testing import attention_fp64

    rng = np.random.default_rng(7)
    q, k, v, _ = make_attention_inputs(rng, 1, HQ, HKV, 150, 96, 64)
    q3, k3, v3 = (x[0] for x in (q, k, v))
    kd = AttentionDescriptor(
        batch=1, num_q_heads=HQ, num_kv_heads=HKV, seq_len_q=150,
        seq_len_kv=96, head_dim=64, low_precision_inputs=False,
        low_precision_intermediates=False,
        **opts).kernel_descriptor(AttentionKernelType.FORWARD)
    kw = dict(group=HQ // HKV, scale=0.125)
    want, _ = flash_fwd_plain(q3, k3, v3, kd, o_dtype=torch.float32, **kw)
    masks = dict(causal=kd.causal, sliding_window=kd.sliding_window,
                 logit_soft_cap=kd.logit_soft_cap)
    got = attention_fp64(q3, k3, v3, heads=3, **kw, **masks)
    assert got.dtype == torch.float64
    assert_close(got, want, 2e-5, "fp64 O")
    terms = attention_fp64(q3, k3, v3, magnitudes=True, **kw, **masks)
    assert bool((terms >= got.abs() - 1e-12).all())
