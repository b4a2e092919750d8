"""The dispatch-path autotune (``MFA_AUTOTUNE``) of the port's GEMM and
attention, held against ``mfa_tpu``'s under the same fake timers, and the
offline tuners of ``mfa_tpu_torch/utils/autotune.py`` on the CPU: the
search probes the heuristic or table row first and memoizes the fake
winner's position, a class is searched once (also by two threads at
once), the switch reads ``MFA_AUTOTUNE`` as ``mfa_tpu``'s does, every
candidate fits one SM and names an instance the kernel library compiles
(through a stand-in library over meta tensors: no kernel runs here), a
memo hit reaches the launch, nothing is timed under graph capture or
torch.compile, and the tuners refuse the CPU."""

import threading
import time
import types

import jax.numpy as jnp
import pytest
import torch

from mfa_tpu.ops import attention as jax_attention
from mfa_tpu.ops import gemm as jax_gemm
from mfa_tpu.ops.descriptors import AttentionDescriptor as JaxAttentionDesc
from mfa_tpu.ops.descriptors import AttentionKernelType as JaxKernelType
from mfa_tpu.ops.descriptors import GEMMDescriptor as JaxGEMMDescriptor
from mfa_tpu.ops.precision import OperandPrecision as JaxPrecision
from mfa_tpu_torch.kernels import build
from mfa_tpu_torch.kernels import flash_fwd as k1
from mfa_tpu_torch.kernels import gemm_kernel as k7
from mfa_tpu_torch.ops import attention as port_attention
from mfa_tpu_torch.ops import gemm as port_gemm
from mfa_tpu_torch.ops import params
from mfa_tpu_torch.ops.cache import attention_cache, gemm_cache
from mfa_tpu_torch.ops.descriptors import (
    KERNEL_CODES,
    AttentionDescriptor,
    AttentionKernelType,
    GEMMDescriptor,
    head_dim_panels,
    launch_row,
)
from mfa_tpu_torch.ops.precision import OperandPrecision
from mfa_tpu_torch.utils import autotune

BF16 = OperandPrecision.BF16
# Fake times, one a candidate in probe order: the fourth candidate wins.
TIMES = [3.0, 2.0, 5.0, 1.0, 4.0] + [9.0] * 16
WINNER = 3


@pytest.fixture(autouse=True)
def fresh_memos(monkeypatch):
    """Empty memos and caches on both sides, and both switches restored."""
    monkeypatch.setattr(jax_gemm, "_tuned_blocks", {})
    monkeypatch.setattr(jax_gemm, "_tuned_inflight", {})
    monkeypatch.setattr(jax_attention, "_attn_tuned", {})
    monkeypatch.setattr(jax_gemm, "_autotune_enabled", None)
    monkeypatch.setattr(port_gemm, "_autotune_enabled", None)
    gemm_cache.clear()
    attention_cache.clear()
    yield
    gemm_cache.clear()
    attention_cache.clear()


def _fake_timer(times, delay=0.0):
    """measure(candidate) giving times[i] at its i-th call."""
    calls = []

    def measure(cand):
        calls.append(cand)
        time.sleep(delay)
        return times[len(calls) - 1]

    measure.calls = calls
    return measure


# ---------------------------------------------------------------------------
# GEMM
# ---------------------------------------------------------------------------


def _jax_gemm_problem(m, n, k):
    desc = JaxGEMMDescriptor(m=m, n=n, k=k, a_precision=JaxPrecision.BF16,
                             b_precision=JaxPrecision.BF16,
                             c_precision=JaxPrecision.BF16)
    a = jnp.zeros((1, m, k), jnp.bfloat16)
    b = jnp.zeros((1, k, n), jnp.bfloat16)
    return desc.kernel_descriptor(), desc, a, b


def _jax_resolve(problem, measure):
    kd, desc, a, b = problem
    got = jax_gemm._autotuned_kd(kd, desc, a, b, None, jnp.bfloat16,
                                 measure=measure)
    return got.block_m, got.block_n, got.block_k


def _jax_blocks(kd):
    return kd.block_m, kd.block_n, kd.block_k


def _port_gemm_problem(m, n, k):
    desc = GEMMDescriptor(m=m, n=n, k=k, a_precision=BF16, b_precision=BF16,
                          c_precision=BF16)
    a = torch.zeros((1, m, k), dtype=torch.bfloat16)
    b = torch.zeros((1, k, n), dtype=torch.bfloat16)
    return desc.kernel_descriptor(), desc, a, b


def _port_resolve(problem, measure):
    kd, desc, a, b = problem
    return port_gemm._autotuned_kd(kd, desc, a, b, None, torch.bfloat16,
                                   measure=measure)


def test_gemm_search_probes_the_heuristic_first_and_takes_the_winner():
    jax_p, port_p = (_jax_gemm_problem(1536, 1536, 1536),
                     _port_gemm_problem(1536, 1536, 1536))
    jax_t, port_t = _fake_timer(TIMES), _fake_timer(TIMES)
    jax_got, port_got = _jax_resolve(jax_p, jax_t), _port_resolve(port_p,
                                                                  port_t)
    jax_cands = jax_gemm._autotune_candidates(jax_p[0], 1536, 1536, 1536)
    port_cands = port_gemm._autotune_candidates(port_p[0], True)
    # Each side timed its candidates in order, the heuristic's first.
    assert [_jax_blocks(c) for c in jax_t.calls] == jax_cands
    assert jax_cands[0] == _jax_blocks(jax_p[0])
    assert port_t.calls == [port_gemm._with_candidate(port_p[0], c)
                            for c in port_cands]
    assert port_t.calls[0].tile == port_p[0].tile
    assert port_t.calls[0].group is None
    # Both memoize the fastest: the same position in the probe order.
    assert jax_got == jax_cands[WINNER]
    assert port_got == port_gemm._with_candidate(port_p[0],
                                                 port_cands[WINNER])
    # The port's heuristic tile and bands: one axis at a time.
    assert port_cands == [("tile", "w256", None), ("tile", "w128", None),
                          ("tile", "w256", 1), ("tile", "w256", 4),
                          ("tile", "w256", 16)]


def test_gemm_second_resolve_measures_nothing_a_new_class_measures():
    for problem, resolve in ((_jax_gemm_problem, _jax_resolve),
                             (_port_gemm_problem, _port_resolve)):
        first = resolve(problem(1536, 1536, 1536), _fake_timer(TIMES))
        again = _fake_timer(TIMES)
        assert resolve(problem(1536, 1536, 1536), again) == first
        assert again.calls == []
        other = _fake_timer(TIMES)
        resolve(problem(512, 1536, 1536), other)
        assert other.calls
    cls = [k for k in gemm_cache.tuned.searches if k[0] == 1536]
    assert [gemm_cache.tuned.searches[k] for k in cls] == [1]
    assert gemm_cache.tuned.timed[cls[0]] == 5


def test_gemm_search_evicts_the_losers_from_the_cache():
    got = _port_resolve(_port_gemm_problem(1536, 1536, 1536),
                        _fake_timer(TIMES))
    kept = [key for key in gemm_cache._pipeline if len(key) == 2]
    assert len(kept) == 1 and gemm_cache._pipeline[kept[0]] == got


def test_gemm_class_of_a_transposed_view_is_the_operand_launched():
    """A view whose innermost stride is not 1 is copied by K7's wrapper
    before the launch: its class is that of the copy (TMA maps it), and
    the hook copies nothing to learn so."""
    kd, desc, a, b = _port_gemm_problem(1536, 1536, 1536)
    view = a.transpose(1, 2).contiguous().transpose(1, 2)
    assert view.stride(2) != 1
    got = port_gemm._autotuned_kd(kd, desc, view, b, None, torch.bfloat16,
                                  measure=_fake_timer(TIMES))
    (key,) = gemm_cache.tuned.searches
    assert key[10] is True and got.tile.path == "wgmma"


@pytest.mark.parametrize("side", ["jax", "port"])
def test_two_threads_on_one_cold_class_run_one_search(side):
    problem, resolve = {
        "jax": (_jax_gemm_problem(1536, 1536, 1536), _jax_resolve),
        "port": (_port_gemm_problem(1536, 1536, 1536), _port_resolve)}[side]
    measure = _fake_timer(TIMES, delay=0.02)
    got = [None, None]

    def worker(i):
        got[i] = resolve(problem, measure)

    threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert got[0] == got[1] is not None
    assert len(measure.calls) == 5
    if side == "port":
        assert list(gemm_cache.tuned.searches.values()) == [1]


@pytest.mark.parametrize("env", [None, "", "0", "false", "1"])
def test_autotune_switch_reads_the_environment_as_mfa_tpu(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("MFA_AUTOTUNE", raising=False)
    else:
        monkeypatch.setenv("MFA_AUTOTUNE", env)
    assert port_gemm.autotune_active() == jax_gemm.autotune_active()
    assert port_gemm.autotune_active() == (env == "1")
    for forced in (True, False):
        port_gemm.set_autotune(forced)
        jax_gemm.set_autotune(forced)
        assert port_gemm.autotune_active() is jax_gemm.autotune_active() \
            is forced
    port_gemm.set_autotune(None)
    jax_gemm.set_autotune(None)
    assert port_gemm.autotune_active() == (env == "1")


# ---------------------------------------------------------------------------
# Attention (K1's forward)
# ---------------------------------------------------------------------------


def _jax_attention_problem(n=256, d=128):
    desc = JaxAttentionDesc(
        batch=1, num_q_heads=4, num_kv_heads=2, seq_len_q=n, seq_len_kv=n,
        head_dim=d, causal=True, low_precision_inputs=True,
        low_precision_intermediates=True)
    q = jnp.zeros((1, 4, n, d), jnp.bfloat16)
    k = jnp.zeros((1, 2, n, d), jnp.bfloat16)
    return desc.kernel_descriptor(JaxKernelType.FORWARD), desc, q, k


def _port_attention_problem(n=256, d=128):
    desc = AttentionDescriptor(
        batch=1, num_q_heads=4, num_kv_heads=2, seq_len_q=n, seq_len_kv=n,
        head_dim=d, causal=True, low_precision_inputs=True,
        low_precision_intermediates=True)
    q3 = torch.zeros((4, n, d), dtype=torch.bfloat16)
    kv = torch.zeros((2, n, d), dtype=torch.bfloat16)
    return (desc.kernel_descriptor(AttentionKernelType.FORWARD), desc, q3,
            kv)


def _timed_dispatch(monkeypatch, module, times):
    """module._measure_dispatch(thunk) runs thunk and gives times[i]."""
    calls = []

    def measure(thunk, *args, **kwargs):
        thunk()
        calls.append(1)
        return times[len(calls) - 1]

    monkeypatch.setattr(module, "_measure_dispatch", measure)
    return calls


def _jax_attn_resolve(problem):
    kd, desc, q, k = problem
    seen = []

    def run_candidate(cand):
        seen.append(cand)
        return jnp.zeros((1,))

    got = jax_attention._attn_autotuned_kd("fwd", kd, desc, q, k,
                                           run_candidate)
    return got, seen


def _port_attn_resolve(problem):
    kd, desc, q3, kv = problem
    seen = []

    def run_candidate(cand):
        seen.append(cand)
        return None

    got = port_attention._attn_autotuned_kd("fwd", kd, desc, q3, kv,
                                            run_candidate, (q3, kv, kv))
    return got, seen


def test_attention_search_probes_the_table_row_first_and_takes_the_winner(
        monkeypatch):
    jax_gemm.set_autotune(True)
    port_gemm.set_autotune(True)
    _timed_dispatch(monkeypatch, jax_gemm, TIMES)
    _timed_dispatch(monkeypatch, port_gemm, TIMES)
    jax_p, port_p = _jax_attention_problem(), _port_attention_problem()
    jax_got, jax_seen = _jax_attn_resolve(jax_p)
    port_got, port_seen = _port_attn_resolve(port_p)
    assert jax_seen[0] == jax_p[0] and port_seen[0] == port_p[0]
    assert jax_got == jax_seen[WINNER]
    assert port_got == port_seen[WINNER]
    # The port's candidates at D 128: the table row, block_kv 64, the
    # mma.sync rows of 128 and 256.
    assert [port_attention._tuned_axes(c) for c in port_seen] == [
        (128, 128, 128, "wgmma"), (128, 64, 128, "wgmma"),
        (64, 64, 128, "mma"), (64, 32, 256, "mma")]
    # A second resolve of either measures nothing and returns the winner.
    for resolve, problem, got in ((_jax_attn_resolve, jax_p, jax_got),
                                  (_port_attn_resolve, port_p, port_got)):
        again, seen = resolve(problem)
        assert again == got and seen == []
    # A new class (another sequence length) is searched again.
    _timed_dispatch(monkeypatch, port_gemm, TIMES)
    _, seen = _port_attn_resolve(_port_attention_problem(n=512))
    assert len(seen) == 4
    assert sorted(attention_cache.tuned.searches.values()) == [1, 1]


def test_attention_hit_applies_only_the_tuned_axes(monkeypatch):
    """The memo holds (block_q, block_kv, block_d, kernel); a hit puts them
    onto the live descriptor and keeps its other fields."""
    port_gemm.set_autotune(True)
    _timed_dispatch(monkeypatch, port_gemm, TIMES)
    kd, desc, q3, kv = problem = _port_attention_problem()
    won, _ = _port_attn_resolve(problem)
    (key,) = attention_cache.tuned.searches
    assert attention_cache.tuned.get(key) == port_attention._tuned_axes(won)
    live = kd.__class__(**{**kd.__dict__, "device": "other"})
    got = port_attention._attn_autotuned_kd("fwd", live, desc, q3, kv,
                                            None, (q3, kv, kv))
    assert got.device == "other"
    assert port_attention._tuned_axes(got) == port_attention._tuned_axes(won)


def test_two_threads_on_one_cold_attention_class_run_one_search(monkeypatch):
    port_gemm.set_autotune(True)
    calls = []

    def measure(thunk, *args, **kwargs):
        calls.append(1)
        time.sleep(0.02)
        return TIMES[len(calls) - 1]

    monkeypatch.setattr(port_gemm, "_measure_dispatch", measure)
    problem = _port_attention_problem()
    got = [None, None]

    def worker(i):
        got[i] = _port_attn_resolve(problem)[0]

    threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert got[0] == got[1] is not None and len(calls) == 4
    assert list(attention_cache.tuned.searches.values()) == [1]


def test_memo_is_cleared_with_the_attention_cache(monkeypatch):
    port_gemm.set_autotune(True)
    _timed_dispatch(monkeypatch, port_gemm, TIMES)
    _port_attn_resolve(_port_attention_problem())
    assert attention_cache.tuned.searches
    attention_cache.clear()
    assert not attention_cache.tuned.searches
    _timed_dispatch(monkeypatch, port_gemm, TIMES)
    _, seen = _port_attn_resolve(_port_attention_problem())
    assert len(seen) == 4


# ---------------------------------------------------------------------------
# Candidates against the instances the library compiles (stand-in library)
# ---------------------------------------------------------------------------

# csrc/flash_fwd.cu mfa_flash_fwd: (kernel code, block_q, block_kv,
# block_d) of the bf16 instances; the copying producer's; fp32's.
K1_TMA = {(1, 128, bkv, bd) for bkv in (64, 128) for bd in (64, 128)} | {
    (3, 128, bkv, bd) for bkv in (64, 32) for bd in (192, 256)} | {
    (3, 128, 64, bd) for bd in (128, 192, 256)}
K1_COPY = {(c, bq, bkv, bd) for c in (1, 3)
           for bq, bkv, bd in params.COPY_ROWS["flash_fwd"]}
K1_MMA = {(2, 64, 32, 256), (2, 64, 64, 128), (0, 64, 64, 64),
          (0, 64, 64, 128), (0, 64, 32, 256)}
K1_FP32 = {(2, 16, 32, 128), (2, 16, 32, 256), (0, 16, 32, 64),
           (0, 16, 32, 128), (0, 16, 32, 256)}
# csrc/gemm.cu's tile codes.
TILE_NAMES = {code: name for name, code in k7._TILE_CODES.items()}


class _CompiledLibrary:
    """Records the calls a wrapper makes instead of launching (as the
    stand-in of tests/test_torch_flash_fwd_rows.py and
    tests/test_torch_matmul_rows.py), and accepts only a launch of an
    instance the C entry compiles."""

    def __init__(self):
        self.calls = []

    def call(self, name, *args):
        if name == "mfa_flash_fwd":
            dtype, code, bq, bkv, bd = args[15:20]
            producer, panels = args[-2], args[10]
            inst = (code, bq, bkv, bd)
            ok = (inst in K1_FP32 if dtype == 0
                  else inst in K1_COPY and panels == 1 if producer
                  else inst in K1_MMA or inst in K1_TMA and (
                      code != 3 or bkv == 64 or panels == 1))
            ok = ok and panels == (-(-args[9] // bd) if code in (2, 3)
                                   else 1)
        else:
            tile, stages, group = args[-4:-1]
            name_ = TILE_NAMES[tile]
            ok = (stages == params.GEMM_TILES[name_].stages
                  and group in params.GEMM_TILE_GROUPS)
        if not ok:
            raise RuntimeError(f"{name}: no compiled instance for {args}")
        self.calls.append((name, args))


@pytest.fixture
def library(monkeypatch):
    lib = _CompiledLibrary()
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    return lib


@pytest.mark.parametrize("d", [64, 96, 100, 128, 192, 250, 256, 384, 512])
@pytest.mark.parametrize("bf16", [True, False])
def test_attention_candidates_fit_and_launch_compiled_instances(library, d,
                                                                bf16):
    dtype = torch.bfloat16 if bf16 else torch.float32
    desc = AttentionDescriptor(
        batch=1, num_q_heads=4, num_kv_heads=2, seq_len_q=64, seq_len_kv=64,
        head_dim=d, causal=True, low_precision_inputs=bf16,
        low_precision_intermediates=bf16)
    q3 = torch.empty((4, 64, d), dtype=dtype, device="meta")
    kv = torch.empty((2, 64, d), dtype=dtype, device="meta")
    kd = desc.kernel_descriptor(AttentionKernelType.FORWARD)
    cands = port_attention._attn_autotune_candidates(kd, desc, (q3, kv, kv))
    assert cands[0] == kd
    for cand in cands:
        row = launch_row(cand, d, (q3, kv, kv))
        assert params.smem_bytes("flash_fwd", row, 2 if bf16 else 4) \
            <= params.H100.smem_per_block
        k1.flash_fwd(q3, kv, kv, cand, group=2, scale=0.125, o_dtype=dtype)
        args = library.calls[-1][1]
        assert args[16] == KERNEL_CODES[cand.kernel]
        assert args[10] == head_dim_panels(row, d)
    assert len(library.calls) == len(cands)


@pytest.mark.parametrize("shift", [4, 8])
def test_attention_candidates_on_misaligned_operands(shift):
    """A base 4 or 8 bytes off 16: K1's TMA rows keep their kernel on the
    copying producer (where it has the instance), the others fall to the
    mma.sync rows, each once."""
    desc = AttentionDescriptor(
        batch=1, num_q_heads=2, num_kv_heads=2, seq_len_q=64, seq_len_kv=64,
        head_dim=128, causal=True, low_precision_inputs=True,
        low_precision_intermediates=True)
    buf = torch.zeros(2 * 64 * 128 + 16, dtype=torch.bfloat16)
    at = (-buf.data_ptr() % 16 + shift) // 2
    q3 = buf[at:at + 2 * 64 * 128].view(2, 64, 128)
    kd = desc.kernel_descriptor(AttentionKernelType.FORWARD)
    cands = port_attention._attn_autotune_candidates(kd, desc, (q3, q3, q3))
    labels = [(launch_row(c, 128, (q3, q3, q3)).producer,
               port_attention._tuned_axes(c)) for c in cands]
    assert labels == [("copy", (128, 128, 128, "wgmma")),
                      ("", (64, 64, 128, "mma")), ("", (64, 32, 256, "mma"))]


@pytest.mark.parametrize("m, n, k, prec, sliced", [
    (1536, 1536, 1536, BF16, False), (4096, 4096, 4096, BF16, False),
    (8, 4096, 4096, BF16, False), (1536, 1536, 1536, BF16, True),
    (1536, 1536, 1536, OperandPrecision.FP16, False),
    (1536, 1536, 1536, OperandPrecision.FP32, False)])
def test_gemm_candidates_fit_and_launch_compiled_instances(library, m, n, k,
                                                           prec, sliced):
    dtype = prec.dtype
    kd = GEMMDescriptor(m=m, n=n, k=k, a_precision=prec, b_precision=prec,
                        c_precision=prec).kernel_descriptor()
    a = torch.empty((1, m, k + (1 if sliced else 0)), dtype=dtype,
                    device="meta")[:, :, :k]
    b = torch.empty((1, k, n), dtype=dtype, device="meta")
    mappable = k7.tma_mappable(a, b)
    assert mappable == (prec is BF16 and not sliced)
    cands = port_gemm._autotune_candidates(kd, mappable)
    want = {"w256": 5, "w128": 1, "m128": 3, "m64": 3, "m16": 3,
            "ffma": 1}
    base = (kd.tile if kd.tile.path != "wgmma" or mappable else kd.mma_tile)
    assert len(cands) == want[base.name] and cands[0][1] == base.name
    for cand in cands:
        kd_c = port_gemm._with_candidate(kd, cand)
        tile = k7.launch_tile(kd_c, a, b)
        assert tile.name == cand[1]
        assert params.gemm_smem_bytes(tile) <= params.H100.smem_per_block
        k7.gemm_kernel(a, b, None, kd_c, out_dtype=dtype)
        args = library.calls[-1][1]
        assert TILE_NAMES[args[-4]] == cand[1]
        assert args[-2] == (cand[2] or params.GEMM_TILE_GROUP)


def test_harness_candidates_are_the_hooks():
    """utils/autotune.py enumerates the hooks' candidates: candidate_rows
    as the attention hook's rows on aligned operands, gemm_candidates as
    the GEMM hook's."""
    for kernel, kind in (("forward", AttentionKernelType.FORWARD),
                         ("backward_query",
                          AttentionKernelType.BACKWARD_QUERY),
                         ("backward_key_value",
                          AttentionKernelType.BACKWARD_KEY_VALUE)):
        for d in (64, 100, 128, 256, 384):
            desc = AttentionDescriptor(
                batch=1, num_q_heads=1, num_kv_heads=1, seq_len_q=1,
                seq_len_kv=1, head_dim=d, low_precision_inputs=True,
                low_precision_intermediates=True)
            kd = desc.kernel_descriptor(kind)
            rows = autotune.candidate_rows(d, 2, kernel)
            assert [(r.block_q, r.block_kv, r.block_d, r.kernel)
                    for r in rows] == [
                port_attention._tuned_axes(c) for c in
                port_attention._attn_autotune_candidates(kd, desc)]
            assert (rows[0].block_q, rows[0].block_kv, rows[0].kernel) == (
                kd.block_q, kd.block_kv, kd.kernel)
    assert autotune.gemm_candidates(1536, 1536, 1536, 2) == [
        ("w256", None), ("w128", None), ("w256", 1), ("w256", 4),
        ("w256", 16)]
    assert autotune.gemm_candidates(1536, 1536, 1536, 4) == [("ffma", None)]


# ---------------------------------------------------------------------------
# Where the hooks run: the launch, capture and compile, the CPU
# ---------------------------------------------------------------------------


def test_memo_hit_reaches_the_launch(monkeypatch):
    """flash_attention on the card launches K1 on the memo's winner, not
    the table row (a stand-in K1 records the descriptor it gets)."""
    port_gemm.set_autotune(True)
    _timed_dispatch(monkeypatch, port_gemm, TIMES)
    monkeypatch.setattr(port_attention, "resolve_device",
                        lambda device: torch.device("cuda", 0))
    monkeypatch.setattr(port_attention, "check_on", lambda dev, **t: None)
    monkeypatch.setattr(params, "detect_device", lambda device=None:
                        params.H100)
    got = []

    def stand_in(q3, k3, v3, kd, *, group, scale, o_dtype, out=None):
        got.append(kd)
        return (torch.zeros(q3.shape, dtype=o_dtype),
                torch.zeros(q3.shape[:2]))

    monkeypatch.setattr(k1, "flash_fwd", stand_in)
    q = torch.zeros((1, 4, 256, 128), dtype=torch.bfloat16)
    kv = torch.zeros((1, 2, 256, 128), dtype=torch.bfloat16)
    port_attention.flash_attention(q, kv, kv, causal=True)
    # The search ran the four candidates, then the launch took the winner.
    assert len(got) == 5
    assert got[-1] == got[WINNER] != got[0]
    port_attention.flash_attention(q, kv, kv, causal=True)
    assert len(got) == 6 and got[-1] == got[WINNER]
    # Off again: the table row.
    port_gemm.set_autotune(False)
    port_attention.flash_attention(q, kv, kv, causal=True)
    assert got[-1] == got[0]


@pytest.mark.parametrize("mode", ["capture", "compile"])
def test_capture_or_compile_measures_nothing(monkeypatch, mode):
    if mode == "capture":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: True)
    else:
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)

    def no_timing(*args, **kwargs):
        raise AssertionError("timed under capture or compile")

    monkeypatch.setattr(port_gemm, "_measure_dispatch", no_timing)
    port_gemm.set_autotune(True)
    kd, desc, a, b = _port_gemm_problem(1536, 1536, 1536)
    assert port_gemm._autotuned_kd(kd, desc, a, b, None,
                                   torch.bfloat16) == kd
    kd_a, desc_a, q3, kv = _port_attention_problem()
    got = port_attention._attn_autotuned_kd("fwd", kd_a, desc_a, q3, kv,
                                            no_timing, (q3, kv, kv))
    assert got == kd_a
    assert not gemm_cache.tuned.searches and not attention_cache.tuned.searches
    assert not gemm_cache.tuned._winners and not attention_cache.tuned._winners


def test_capture_uses_a_memoized_winner(monkeypatch):
    port_gemm.set_autotune(True)
    problem = _port_gemm_problem(1536, 1536, 1536)
    won = _port_resolve(problem, _fake_timer(TIMES))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    kd, desc, a, b = problem
    assert port_gemm._autotuned_kd(kd, desc, a, b, None,
                                   torch.bfloat16) == won


def test_hooks_never_run_for_cpu_tensors(monkeypatch):
    def no_hook(*args, **kwargs):
        raise AssertionError("autotune hook on CPU tensors")

    port_gemm.set_autotune(True)
    monkeypatch.setattr(port_gemm, "_autotuned_kd", no_hook)
    monkeypatch.setattr(port_attention, "_attn_autotuned_kd", no_hook)
    a = torch.randn(2, 5, 7)
    port_gemm.gemm(a, a.transpose(1, 2), device="cpu")
    q = torch.randn(1, 2, 8, 16)
    port_attention.flash_attention(q, q, q, causal=True, device="cpu")


def test_tuners_refuse_the_cpu(monkeypatch):
    for call in (lambda dev: autotune.tune_forward(64, 128, 2, device=dev),
                 lambda dev: autotune.tune_backward(
                     "backward_query", 64, 128, 2, device=dev),
                 lambda dev: autotune.tune_gemm(64, 64, 64, device=dev)):
        with pytest.raises(ValueError, match="refuse the CPU"):
            call("cpu")
        with monkeypatch.context() as mp:
            mp.setattr(torch.cuda, "is_available", lambda: False)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA device"):
        autotune.main(["--kernel", "gemm"])
    with pytest.raises(ValueError, match="unknown backward kernel"):
        autotune.tune_backward("forward", device="cpu")
