"""Hygiene of the PyTorch port: no JAX, explicit devices, kernels or an
exception on CUDA tensors, plain versions only for CPU tensors."""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import mfa_tpu_torch
from mfa_tpu_torch.kernels import build
from mfa_tpu_torch.kernels import decode as k2
from mfa_tpu_torch.kernels import flash_bwd as k34
from mfa_tpu_torch.kernels import flash_fwd as k1
from mfa_tpu_torch.kernels import gemm_kernel as k7
from mfa_tpu_torch.kernels import paged_decode as k6
from mfa_tpu_torch.kernels import quant
from mfa_tpu_torch.kernels import quant_matmul as k8
from mfa_tpu_torch.models import llama
from mfa_tpu_torch.ops.attention import attention_chunk_grads, flash_attention
from mfa_tpu_torch.ops.decode import (
    decode_attention,
    decode_attention_append,
    paged_decode_attention,
)
from mfa_tpu_torch.ops.descriptors import (
    AttentionDescriptor,
    AttentionKernelType,
    GEMMDescriptor,
)
from mfa_tpu_torch.ops.gemm import gemm
from mfa_tpu_torch.ops.precision import OperandPrecision
from mfa_tpu_torch.parallel import dryrun
from mfa_tpu_torch.parallel import mesh as mesh_mod
from mfa_tpu_torch.parallel.ring_attention import (
    ring_flash_attention,
    ring_schedule,
)
from mfa_tpu_torch.parallel.ulysses import choose_cp_mode, ulysses_attention
from mfa_tpu_torch.serving import kv_cache
from mfa_tpu_torch.serving.paged_kv_cache import PagedKVCache, PagePool
from mfa_tpu_torch.serving.paged_scheduler import PagedScheduler
from mfa_tpu_torch.serving.scheduler import ContinuousBatchingScheduler

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "mfa_tpu_torch"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        mfa_tpu_torch.__path__, "mfa_tpu_torch."))


def test_port_imports_no_jax_and_nothing_of_mfa_tpu():
    mods = _modules()
    assert "mfa_tpu_torch.ops.attention" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'mfa_tpu' or m.startswith('mfa_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_top_level_names_load_on_first_access():
    """mfa_tpu's top-level entry points are importable from the port's
    package, which loads their modules only when a name is first used."""
    code = (
        "import sys, mfa_tpu_torch\n"
        "assert 'mfa_tpu_torch.ops.decode' not in sys.modules\n"
        "from mfa_tpu_torch import paged_decode_attention, decode_attention\n"
        "from mfa_tpu_torch.ops import decode\n"
        "assert paged_decode_attention is decode.paged_decode_attention\n"
        "assert mfa_tpu_torch.flash_attention.__module__ =="
        " 'mfa_tpu_torch.ops.attention'\n"
        "assert 'mfa_tpu_torch.ops.gemm' not in sys.modules\n"
        "from mfa_tpu_torch import gemm, AttentionDescriptor, GEMMDescriptor\n"
        "from mfa_tpu_torch.ops import descriptors, gemm as gemm_mod\n"
        "assert gemm is gemm_mod.gemm\n"
        "assert AttentionDescriptor is descriptors.AttentionDescriptor\n"
        "assert GEMMDescriptor is descriptors.GEMMDescriptor\n"
        "assert sorted(mfa_tpu_torch.__all__) == sorted(["
        "'flash_attention', 'mha', 'decode_attention',"
        " 'decode_attention_append', 'paged_decode_attention', 'gemm',"
        " 'AttentionDescriptor', 'GEMMDescriptor'])\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert mfa_tpu_torch.gemm is gemm
    assert mfa_tpu_torch.GEMMDescriptor is GEMMDescriptor
    assert mfa_tpu_torch.AttentionDescriptor is AttentionDescriptor
    with pytest.raises(AttributeError, match="no attribute"):
        mfa_tpu_torch.int4_matmul


def test_entry_points_raise_without_gpu_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = torch.zeros(1, 2, 4, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flash_attention(q, q, q)
    flash_attention(q, q, q, device="cpu")
    lse = torch.zeros(1, 2, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        attention_chunk_grads(q, q, q, q, q, lse)
    attention_chunk_grads(q, q, q, q, q, lse, device="cpu")

    cache = kv_cache.create(1, 2, 8, 16, device="cpu")
    x = torch.zeros(1, 2, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_attention_append(x, x, x, cache)
    decode_attention_append(x, x, x, cache, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_attention(x, cache)
    decode_attention(x, cache, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kv_cache.create(1, 2, 8, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKVCache(4, 2, 16, 1, 256)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagePool.create(4, 2, 16, 128)
    paged = PagedKVCache(4, 2, 16, 1, 256, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paged_decode_attention(x, paged)
    paged_decode_attention(x, paged, device="cpu")

    cfg = llama.LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.Llama.init(cfg, generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.Llama.init(cfg, generator=torch.Generator().manual_seed(0),
                         trainable=True)
    model = llama.Llama.init(cfg, generator=torch.Generator().manual_seed(0),
                             dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatchingScheduler(model)
    ContinuousBatchingScheduler(model, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedScheduler(model)
    PagedScheduler(model, num_pages=4, device="cpu")

    a = torch.zeros(4, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gemm(a, a.t())
    gemm(a, a.t(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.Llama.init(cfg, generator=torch.Generator().manual_seed(0),
                         weight_precision=OperandPrecision.INT4)
    qmodel = llama.Llama.init(cfg, generator=torch.Generator().manual_seed(0),
                              dtype=torch.float32, device="cpu",
                              weight_precision=OperandPrecision.INT4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatchingScheduler(qmodel)
    qw = llama.quantize_params(model.params(), OperandPrecision.INT4)[
        "layers"][0]["wq"]
    x = torch.zeros(2, cfg.dim)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        k8.int4_matmul(x, qw.w, qw.scale, layout="int4")
    k8.int4_matmul(x, qw.w, qw.scale, layout="int4", device="cpu")

    # The parallel layer: NCCL on the card, gloo only when asked.
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_mod.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.run_rank(0, 1, "file:///nonexistent", "cuda")
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ring_flash_attention(q, q, q, group=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ring_schedule(q, q, q, n=2)
    ring_schedule(q, q, q, n=2, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ulysses_attention(q, q, q, group=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        choose_cp_mode(8, 8, 256, 32, 4)
    assert choose_cp_mode(8, 8, 256, 32, 4, hbm_budget_bytes=2**30,
                          device="cpu") == "ulysses"


def _kd(causal=True, kind=AttentionKernelType.FORWARD):
    return AttentionDescriptor(
        batch=1, num_q_heads=2, num_kv_heads=1, seq_len_q=8, seq_len_kv=8,
        head_dim=16, causal=causal).kernel_descriptor(kind)


_KD_Q = dict(kind=AttentionKernelType.BACKWARD_QUERY)
_KD_KV = dict(kind=AttentionKernelType.BACKWARD_KEY_VALUE)


def test_wrappers_take_plain_version_only_for_cpu_tensors(monkeypatch):
    def no_library():
        raise AssertionError("kernel library touched for CPU tensors")

    monkeypatch.setattr(build, "library", no_library)
    counters = (k1.flash_fwd, k2.decode_fused_append, k34.flash_bwd_q,
                k34.flash_bwd_kv, k2.decode_attend, k6.paged_decode,
                k7.gemm_kernel, k8.int4_matmul)
    before = [f.launches for f in counters]
    q3 = torch.randn(2, 8, 16)
    kv = torch.randn(1, 8, 16)
    o, lse = k1.flash_fwd(q3, kv, kv, _kd(), group=2, scale=0.25,
                          o_dtype=torch.float32)
    o_p, lse_p = k1.flash_fwd_plain(q3, kv, kv, _kd(), group=2, scale=0.25,
                                    o_dtype=torch.float32)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    c = kv_cache.create(1, 1, 8, 16, device="cpu")
    x = torch.randn(1, 16)
    k2.decode_fused_append(torch.randn(1, 2, 16), c.k[0], c.v[0],
                           c.k_scale[0], c.v_scale[0], x, x, c.lengths,
                           num_kv_heads=1)
    q1 = torch.randn(1, 2, 16)
    c.lengths = torch.tensor([5], dtype=torch.int32)
    o5 = k2.decode_attend(q1, c.k[0], c.v[0], c.k_scale[0], c.v_scale[0],
                          c.lengths, num_kv_heads=1)
    assert torch.equal(o5, k2.decode_attend_plain(
        q1, c.k[0], c.v[0], c.k_scale[0], c.v_scale[0], c.lengths,
        num_kv_heads=1))
    pool = PagePool.create(2, 1, 16, 128, device="cpu")
    tables = torch.tensor([[1]], dtype=torch.int32)
    pargs = (q1, pool.k_pages, pool.v_pages, pool.k_scale, pool.v_scale,
             tables, c.lengths)
    assert torch.equal(k6.paged_decode(*pargs), k6.paged_decode_plain(*pargs))
    do = torch.randn(2, 8, 16)
    kw = dict(group=2, scale=0.25)
    dq, dterm = k34.flash_bwd_q(q3, kv, kv, o, do, lse, _kd(**_KD_Q), **kw)
    dq_p, dterm_p = k34.flash_bwd_q_plain(q3, kv, kv, o, do, lse,
                                          _kd(**_KD_Q), **kw)
    assert torch.equal(dq, dq_p) and torch.equal(dterm, dterm_p)
    dk, dv = k34.flash_bwd_kv(q3, kv, kv, do, lse, dterm, _kd(**_KD_KV),
                              **kw)
    dk_p, dv_p = k34.flash_bwd_kv_plain(q3, kv, kv, do, lse, dterm,
                                        _kd(**_KD_KV), **kw)
    assert torch.equal(dk, dk_p) and torch.equal(dv, dv_p)
    # Gradients through the autograd function take the same plain path.
    qg = torch.randn(1, 2, 8, 16, requires_grad=True)
    flash_attention(qg, kv[None], kv[None], causal=True,
                    device="cpu").sum().backward()
    assert qg.grad is not None
    a, b = torch.randn(2, 5, 7), torch.randn(2, 9, 7)
    c = gemm(a, b, transpose_b=True, device="cpu")
    kd = GEMMDescriptor(m=5, n=9, k=7, transpose_b=True,
                        batch=2).kernel_descriptor()
    assert torch.equal(c, k7.gemm_kernel_plain(a, b, None, kd,
                                               out_dtype=torch.float32))
    for layout in ("int4", "int4_biased"):
        qw = quant.quantize_weight(torch.randn(6, 64), layout)
        x = torch.randn(3, 64)
        y = k8.int4_matmul(x, qw.w, qw.scale, layout=layout, device="cpu")
        assert torch.equal(y, k8.int4_matmul_plain(x, qw.w, qw.scale,
                                                   layout=layout))
    assert [f.launches for f in counters] == before


def test_wrappers_refuse_other_devices():
    meta = torch.empty(2, 8, 16, device="meta")
    kv = torch.empty(1, 8, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k1.flash_fwd(meta, kv, kv, _kd(), group=2, scale=0.25,
                     o_dtype=torch.float32)
    lse = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k34.flash_bwd_q(meta, kv, kv, meta, meta, lse, _kd(**_KD_Q),
                        group=2, scale=0.25)
    with pytest.raises(ValueError, match="unsupported device"):
        k34.flash_bwd_kv(meta, kv, kv, meta, lse, lse, _kd(**_KD_KV),
                         group=2, scale=0.25)
    scales = torch.empty(2, 8, device="meta")
    lengths = torch.empty(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k2.decode_attend(meta, meta, meta, scales, scales, lengths,
                         num_kv_heads=1)
    pages = torch.empty(2, 1, 128, 16, device="meta")
    pscales = torch.empty(2, 1, 128, device="meta")
    tables = torch.empty(2, 1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k6.paged_decode(meta, pages, pages, pscales, pscales, tables,
                        lengths)
    kd = GEMMDescriptor(m=8, n=8, k=16).kernel_descriptor()
    with pytest.raises(ValueError, match="unsupported device"):
        k7.gemm_kernel(meta, meta.transpose(1, 2), None, kd,
                       out_dtype=torch.float32)
    w = torch.empty(8, 8, dtype=torch.int8, device="meta")
    s8 = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k8.int4_matmul(meta, w, s8, layout="int4", device="cuda")


def test_no_try_except_in_the_port():
    """A CUDA tensor reaches its kernel or an exception: no handler in the
    package could turn a failed build or launch into a fallback."""
    for path in PKG.rglob("*.py"):
        tree = ast.parse(path.read_text(), str(path))
        handlers = [n for n in ast.walk(tree)
                    if isinstance(n, (ast.Try, ast.ExceptHandler))
                    or type(n).__name__ == "TryStar"]
        assert not handlers, f"{path.relative_to(ROOT)}:{handlers[0].lineno}"


def test_decode_wrappers_read_nothing_back_to_the_host():
    """K5's and K6's launch shape comes from the shapes alone: neither
    wrapper reads a tensor (the lengths) back, which would wait on the
    card at every decode step."""
    for name in ("decode.py", "paged_decode.py"):
        text = (PKG / "kernels" / name).read_text()
        for call in (".item(", ".tolist(", ".cpu(", ".numpy("):
            assert call not in text, f"kernels/{name} calls {call}"


def test_cuda_sources_carry_their_notes():
    for name, tpus in (("flash_fwd.cu", ["_fwd_tablegrid_kernel"]),
                       ("decode.cu", ["_decode_fused_kernel"]),
                       ("flash_bwd.cu", ["_bwd_q_kernel", "_bwd_kv_kernel"]),
                       ("decode_attend.cu", ["_decode_kernel_single",
                                             "_decode_kernel",
                                             "_paged_decode_kernel"]),
                       ("gemm.cu", ["_gemm_kernel"]),
                       ("quant_matmul.cu", ["_qmm_kernel",
                                            "_qmm_biased_kernel"])):
        text = (PKG / "csrc" / name).read_text()
        assert all(tpu in text for tpu in tpus)
        assert "bound" in text and "sm_90a" in text
        assert "cudaGetLastError" in text
    for name in build._SIGNATURES:
        assert any(f'"C" int {name}(' in p.read_text()
                   for p in (PKG / "csrc").glob("*.cu")), name


@pytest.mark.parametrize("name", sorted(build._SIGNATURES))
def test_c_entries_take_the_arguments_the_wrappers_pass(name):
    """Each entry's ctypes signature (kernels/build.py) has as many
    arguments as its C declaration in csrc/: a count that differs would
    shift every argument after it, and only on the card."""
    decls = [text[text.index(f'"C" int {name}('):]
             for text in (p.read_text() for p in (PKG / "csrc").glob("*.cu"))
             if f'"C" int {name}(' in text]
    assert len(decls) == 1, name
    params = decls[0][decls[0].index("(") + 1:decls[0].index(")")]
    assert params.count(",") + 1 == len(build._SIGNATURES[name]), name
    # The flash entries take the producer code last before the stream,
    # as an int (K3 and K4 after block_d, K1 after its ping-pong flag).
    names = [a.split()[-1].lstrip("*") for a in params.split(",")]
    if name.startswith("mfa_flash"):
        tail = (["block_d", "producer", "stream"] if "bwd" in name
                else ["pingpong", "producer", "stream"])
        assert names[-3:] == tail, name
        assert build._SIGNATURES[name][-3:-1] == [build._I, build._I]


def test_chip_smoke_refuses_without_gpu(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd is tmp_path:
            shutil.copy(ROOT / "chip_smoke.py", script)
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def test_parameter_tables_fit_one_sm():
    from mfa_tpu_torch.ops import params

    for tile in params.GEMM_TILES.values():
        for ta in (False, True):
            for tb in (False, True):
                assert params.gemm_smem_bytes(tile, ta, tb) \
                    <= params.H100.smem_per_block
    for tile in params.QMM_TILES.values():
        assert params.qmm_smem_bytes(tile) <= params.H100.smem_per_block

    for kernel in ("flash_fwd", "flash_bwd_q", "flash_bwd_kv"):
        for prec, in_bytes in (("bf16", 2), ("fp32", 4)):
            for row in params.parameter_table(kernel, prec):
                assert params.smem_bytes(kernel, row, in_bytes) \
                    <= params.H100.smem_per_block
    rows = params.parse_table("64 | 1 | 2 | 3\ninf | 4 | 5 | 6")
    assert params.select_row(rows, 64).block_q == 1
    assert params.select_row(rows, 65).block_q == 4
    with pytest.raises(ValueError, match="malformed"):
        params.parse_table("inf | 4 | 5 | 6 | Q, K")
    with pytest.raises(ValueError, match="unbounded"):
        params.parse_table("64 | 1 | 2 | 3")
    ampere = params.HopperDevice("sm80", 108, 166_912, (8, 0))
    with pytest.raises(ValueError, match="sm80"):
        params.parameter_table("flash_fwd", "bf16", ampere)
    small = params.HopperDevice("sm90", 132, 48 * 1024, (9, 0))
    with pytest.raises(ValueError, match="shared memory"):
        params.parameter_table("flash_fwd", "bf16", small)


def test_kernel_build_runs_once_for_processes_started_together(tmp_path):
    """The ranks of a multi-process run ask for the kernel library at
    once: one builds it, the others wait on the build's file lock and
    load that build."""
    import torch_ranks

    logs = mesh_mod.spawn(torch_ranks.build_once, 3, str(tmp_path),
                          timeout_s=120)
    assert len((tmp_path / "compiles").read_text().split()) == 1
    assert sorted(logs) == ["(cached build)", "(cached build)", "compiled"]


PART2_MODULES = ("mfa_tpu_torch.parallel.pipeline",
                 "mfa_tpu_torch.parallel.multihost",
                 "mfa_tpu_torch.serving.distributed",
                 "mfa_tpu_torch.utils.overlap")


def test_parallel_part2_modules_are_held_to_the_package_rules():
    """The pipeline, multi-host, sharded-serving and overlap modules are
    among those the no-JAX import check loads (and the no-try/except scan
    reads every file of the package)."""
    mods = _modules()
    for name in PART2_MODULES:
        assert name in mods, name
        tree = ast.parse((ROOT / (name.replace(".", "/") + ".py"))
                         .read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for mod in names:
                top = mod.split(".")[0]
                assert top not in ("jax", "jaxlib", "mfa_tpu"), (name, mod)


def test_parallel_part2_entry_points_raise_without_gpu_unless_cpu(
        monkeypatch):
    from mfa_tpu_torch.parallel import multihost
    from mfa_tpu_torch.serving.distributed import ShardedScheduler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize_distributed()
    assert multihost.initialize_distributed(device="cpu")[
        "process_count"] == 1
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.make_hybrid_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.measure_tokens_per_s(lambda: None, (), 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.dp_scaling_efficiency(lambda mesh: None)
    model = llama.Llama.init(llama.LlamaConfig.tiny(),
                             generator=torch.Generator().manual_seed(0),
                             dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedScheduler(model, mesh=_FakeMesh(), num_slots=2)
    assert not torch.distributed.is_initialized()


class _FakeMesh:
    """A (dp 1, tp 1) mesh without a process group, enough for the checks
    a scheduler makes before it touches a device."""

    mesh_dim_names = mesh_mod.AXES

    def size(self, dim):
        return 1

    def get_local_rank(self, axis):
        return 0

    def get_group(self, axis):
        return None


@pytest.mark.parametrize("name", ["mfa_tpu_torch.utils.autotune",
                                  "mfa_tpu_torch.ops.native"])
def test_autotune_and_native_are_held_to_the_package_rules(monkeypatch,
                                                           name):
    """The autotune harness and the host core's bridge are among the
    modules the no-JAX import check loads and import nothing of JAX or
    mfa_tpu (the no-try/except scan reads every file of the package); the
    tuners time on the card and raise without one, also when asked for
    the CPU."""
    from mfa_tpu_torch.utils import autotune

    assert name in _modules()
    tree = ast.parse((ROOT / (name.replace(".", "/") + ".py")).read_text())
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""]
                 if isinstance(node, ast.ImportFrom) else [])
        for mod in names:
            assert mod.split(".")[0] not in ("jax", "jaxlib", "mfa_tpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tune in (lambda **kw: autotune.tune_forward(64, 128, 2, **kw),
                 lambda **kw: autotune.tune_gemm(64, 64, 64, **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tune()
        with pytest.raises(ValueError, match="refuse the CPU"):
            tune(device="cpu")
