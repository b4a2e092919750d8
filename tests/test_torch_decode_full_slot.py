"""A full slot under the port's decode_attention_append (K2's plain
version on the CPU), at max_len 100 and 128: lengths stay at max_len and
the new row's write is dropped, while the other slot appends as usual.

mfa_tpu fuses only when max_len % 128 == 0 (then it caps the same way);
otherwise it falls back to kv_cache.update + decode_attention
(mfa_tpu/ops/decode.py:214-218), whose update clamps the write start and
overwrites the last row while lengths grow past max_len
(mfa_tpu/serving/kv_cache.py:146-152). The reference's lengths and its
output difference are recorded here (``record_property``), not held
equal; where both take the fused path (max_len 128) they agree."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.ops.decode import decode_attention_append as jax_decode_append
from mfa_tpu.ops.precision import OperandPrecision as JPrec
from mfa_tpu.serving import kv_cache as jax_kv
from mfa_tpu_torch.ops.decode import decode_attention_append
from mfa_tpu_torch.ops.precision import OperandPrecision
from mfa_tpu_torch.serving import kv_cache
from mfa_tpu_torch.utils.testing import assert_close

HQ, HKV, D = 4, 2, 64
STEPS = 3
FORMATS = {"bf16": (JPrec.BF16, OperandPrecision.BF16, 5e-2),
           "int8": (JPrec.INT8, OperandPrecision.INT8, 6e-2)}


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("max_len", [100, 128])
def test_full_slot_keeps_its_length_and_drops_the_write(max_len, fmt,
                                                        record_property):
    jprec, tprec, budget = FORMATS[fmt]
    rng = np.random.default_rng(max_len)
    lengths = [max_len - 2, max_len]     # slot 0 fills on step 2
    fill = rng.standard_normal((2, 2, HKV, max_len, D)).astype(np.float32)
    jc = jax.jit(jax_kv.update)(jax_kv.create(2, HKV, max_len, D, jprec),
                                jnp.asarray(fill[0]), jnp.asarray(fill[1]))
    jc = dataclasses.replace(jc, lengths=jnp.asarray(lengths, jnp.int32))
    tc = kv_cache.update(
        kv_cache.create(2, HKV, max_len, D, tprec, device="cpu"),
        torch.from_numpy(fill[0]), torch.from_numpy(fill[1]))
    tc.lengths = torch.tensor(lengths, dtype=torch.int32)
    ref_lengths, ref_diff = [], []
    for step in range(STEPS):
        q = rng.standard_normal((2, HQ, D)).astype(np.float32)
        kn, vn = rng.standard_normal((2, 2, HKV, D)).astype(np.float32)
        before = [t.clone() for t in (tc.k, tc.v, tc.k_scale, tc.v_scale)]
        prev = tc.lengths.clone()
        o, tc = decode_attention_append(
            torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
            tc, device="cpu")
        assert bool(torch.isfinite(o).all())
        assert tc.lengths.tolist() == [min(int(n) + 1, max_len)
                                       for n in prev]
        after = (tc.k, tc.v, tc.k_scale, tc.v_scale)
        for f, (old, new) in enumerate(zip(before, after)):
            for slot, n in enumerate(prev.tolist()):
                if n == max_len:    # full: nothing written
                    assert torch.equal(old[slot], new[slot])
                    continue
                # row n written (K and V; a bf16 row's scale stays 1), the
                # rest kept
                keep = [i for i in range(max_len) if i != n]
                assert torch.equal(old[slot][:, keep], new[slot][:, keep])
                if f < 2:
                    assert not torch.equal(old[slot][:, n], new[slot][:, n])
        jo, jc = jax_decode_append(jnp.asarray(q), jnp.asarray(kn),
                                   jnp.asarray(vn), jc)
        jo = np.asarray(jo, np.float32)
        ref_lengths.append(np.asarray(jc.lengths).tolist())
        ref_diff.append(float(np.abs(jo - o.numpy()).max()))
        if max_len % 128 == 0:      # the reference fuses and caps too
            assert ref_lengths[-1] == tc.lengths.tolist()
            assert_close(o, torch.from_numpy(jo.copy()), budget,
                         f"step {step}")
    record_property("reference_lengths", ref_lengths)
    record_property("reference_max_abs_diff", ref_diff)
