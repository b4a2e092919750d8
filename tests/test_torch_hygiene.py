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
from mfa_tpu_torch.kernels import flash_fwd as k1
from mfa_tpu_torch.models import llama
from mfa_tpu_torch.ops.attention import flash_attention
from mfa_tpu_torch.ops.decode import decode_attention_append
from mfa_tpu_torch.ops.descriptors import (
    AttentionDescriptor,
    AttentionKernelType,
)
from mfa_tpu_torch.serving import kv_cache
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


def test_entry_points_raise_without_gpu_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = torch.zeros(1, 2, 4, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flash_attention(q, q, q)
    flash_attention(q, q, q, device="cpu")

    cache = kv_cache.create(1, 2, 8, 16, device="cpu")
    x = torch.zeros(1, 2, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_attention_append(x, x, x, cache)
    decode_attention_append(x, x, x, cache, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kv_cache.create(1, 2, 8, 16)

    cfg = llama.LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.Llama.init(cfg, generator=torch.Generator().manual_seed(0))
    model = llama.Llama.init(cfg, generator=torch.Generator().manual_seed(0),
                             dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatchingScheduler(model)
    ContinuousBatchingScheduler(model, device="cpu")


def _kd(causal=True):
    return AttentionDescriptor(
        batch=1, num_q_heads=2, num_kv_heads=1, seq_len_q=8, seq_len_kv=8,
        head_dim=16, causal=causal).kernel_descriptor(
            AttentionKernelType.FORWARD)


def test_wrappers_take_plain_version_only_for_cpu_tensors(monkeypatch):
    def no_library():
        raise AssertionError("kernel library touched for CPU tensors")

    monkeypatch.setattr(build, "library", no_library)
    n1, n2 = k1.flash_fwd.launches, k2.decode_fused_append.launches
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
    assert (k1.flash_fwd.launches, k2.decode_fused_append.launches) == (n1, n2)


def test_wrappers_refuse_other_devices():
    meta = torch.empty(2, 8, 16, device="meta")
    kv = torch.empty(1, 8, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k1.flash_fwd(meta, kv, kv, _kd(), group=2, scale=0.25,
                     o_dtype=torch.float32)


def test_no_try_except_in_the_port():
    """A CUDA tensor reaches its kernel or an exception: no handler in the
    package could turn a failed build or launch into a fallback."""
    for path in PKG.rglob("*.py"):
        tree = ast.parse(path.read_text(), str(path))
        handlers = [n for n in ast.walk(tree)
                    if isinstance(n, (ast.Try, ast.ExceptHandler))
                    or type(n).__name__ == "TryStar"]
        assert not handlers, f"{path.relative_to(ROOT)}:{handlers[0].lineno}"


def test_cuda_sources_carry_their_notes():
    for name, tpu in (("flash_fwd.cu", "_fwd_tablegrid_kernel"),
                      ("decode.cu", "_decode_fused_kernel")):
        text = (PKG / "csrc" / name).read_text()
        assert tpu in text and "bound" in text and "sm_90a" in text
        assert "cudaGetLastError" in text


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

    for prec, in_bytes in (("bf16", 2), ("fp32", 4)):
        for row in params.parameter_table("flash_fwd", prec):
            assert params.flash_fwd_smem_bytes(row, in_bytes) \
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
