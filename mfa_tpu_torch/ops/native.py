"""ctypes bridge to the port's C++ host config core (``runtime/``).

Port of ``mfa_tpu/ops/native.py``: the C++ twin of the config layer for
the Hopper rows (``mfa_tpu_torch/runtime/host_config.cpp``). Each
function here gives what its Python twin gives, bit for bit
(``tests/test_torch_native.py``):

- :func:`parse_table` and :func:`select_row` (``params.parse_table``,
  ``params.select_row``; the same errors), :func:`parameter_table`
  (``params.parameter_table``: every row must fit the device);
- :func:`smem_bytes` (``params.smem_bytes``, with the ring reckonings of
  the wgmma kernels), the twin of ``mfa_tpu``'s ``vmem_bytes_estimate``;
- :func:`gemm_tile` (the tiles ``GEMMDescriptor.kernel_descriptor``
  picks), the twin of ``gemm_blocks``;
- :func:`hash_bytes` (the mix of ``runtime/mfa_hash.hpp``) and
  :class:`HostCache` (``ops/cache.py``'s two-level cache);
- :func:`host_bench`, the twin of ``runtime/main.cpp``: descriptor
  derivation within 1 microsecond, row select and cache probes in ns.

At first use g++ builds ``libmfa_host.so`` and ``mfa_host_bench`` into
``build/mfa_tpu_torch/`` under a file lock (processes started together
build once), again when the sources change. A failed build raises with
g++'s output. Nothing on the dispatch path calls this module.

Not carried over from ``mfa_tpu``: its silent fallback to the Python
paths when no library builds (``MFA_NO_NATIVE``), and ``emit_gemm``
(``runtime/gemm_emitter.cpp`` writes StableHLO for XLA; with
``runtime/pjrt_driver.cpp``, which runs it through PJRT, it has no
meaning on CUDA, where K7 is the GEMM).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import subprocess
import threading
import time
from pathlib import Path

from mfa_tpu_torch.ops import params as params_mod
from mfa_tpu_torch.ops.cache import CacheStats
from mfa_tpu_torch.ops.precision import OperandPrecision

_ROOT = Path(__file__).resolve().parents[2]
SRC = _ROOT / "mfa_tpu_torch" / "runtime"
BUILD_DIR = _ROOT / "build" / "mfa_tpu_torch"
LIB_NAME = "libmfa_host.so"
BENCH_NAME = "mfa_host_bench"
CXX = "g++"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall"]
# What each target is built from.
_TARGETS = {LIB_NAME: ["-shared", "c_api.cpp", "host_config.cpp"],
            BENCH_NAME: ["host_bench.cpp", "host_config.cpp"]}
# Operand precisions as the C interface numbers them.
_PRECISIONS = {OperandPrecision.FP32: 0, OperandPrecision.BF16: 1,
               OperandPrecision.FP16: 2}
_TILE_NAMES = tuple(params_mod.GEMM_TILES)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_U = ctypes.c_ulonglong


class MfaRow(ctypes.Structure):
    _fields_ = [
        ("max_d", ctypes.c_int),
        ("block_q", ctypes.c_int),
        ("block_kv", ctypes.c_int),
        ("block_d", ctypes.c_int),
        ("kernel", ctypes.c_char * 16),
        ("producer", ctypes.c_char * 8),
    ]


_RowPtr = ctypes.POINTER(MfaRow)
_SIGNATURES = {
    "mfa_parse_table": (_I, [ctypes.c_char_p, _RowPtr, _I, ctypes.c_char_p,
                             _I]),
    "mfa_select_row": (_I, [_RowPtr, _I, _I]),
    "mfa_smem_bytes": (_L, [ctypes.c_char_p, _RowPtr, _I]),
    "mfa_gemm_tile": (_I, [_L, _L, _L, _L, _I, _I, _I, _I, _I, _L,
                           ctypes.POINTER(_I), ctypes.POINTER(_I)]),
    "mfa_hash_bytes": (_U, [_P, _L]),
    "mfa_cache_new": (_P, []),
    "mfa_cache_free": (None, [_P]),
    "mfa_cache_get_pipeline": (_U, [_P, _U]),
    "mfa_cache_get_library": (_U, [_P, _U]),
    "mfa_cache_put_pipeline": (_U, [_P, _U, _U]),
    "mfa_cache_put_library": (_U, [_P, _U, _U]),
    "mfa_cache_stats": (None, [_P, ctypes.POINTER(_U)]),
    "mfa_cache_clear": (None, [_P]),
}


class HostLibrary:
    """The loaded library, its host bench and how they were built."""

    def __init__(self, lib: ctypes.CDLL, build_dir: Path, seconds: float,
                 compiled: bool):
        self.lib = lib
        self.bench = build_dir / BENCH_NAME
        self.build_seconds = seconds
        self.compiled = compiled
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes


_lock = threading.Lock()
_library: HostLibrary | None = None


def _digest() -> str:
    h = hashlib.sha256(" ".join([CXX, *CXX_FLAGS]).encode())
    for p in sorted(SRC.glob("*.[ch]pp")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(build_dir: Path) -> None:
    """Both targets, one g++ each, started together; raises with g++'s
    output if either fails."""
    procs = []
    for target, args in _TARGETS.items():
        tmp = build_dir / (target + ".tmp")
        cmd = [CXX, *CXX_FLAGS, *(a if a.startswith("-") else str(SRC / a)
                                  for a in args), "-o", str(tmp)]
        procs.append((target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for target, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"== {target}\n{out}")
    if failed:
        raise RuntimeError("g++ failed to build the host config core:\n"
                           + "\n".join(failed))
    for target, tmp, _ in procs:
        tmp.replace(build_dir / target)


def load() -> HostLibrary:
    """The host library, built on first use (thread-safe, and
    process-safe: processes that ask at once wait on a file lock while
    the first builds, then load its build)."""
    global _library
    with _lock:
        if _library is not None:
            return _library
        build_dir = BUILD_DIR
        build_dir.mkdir(parents=True, exist_ok=True)
        digest = _digest()
        stamp = build_dir / (LIB_NAME + ".sha")
        t0 = time.perf_counter()
        compiled = False
        with open(build_dir / (LIB_NAME + ".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not ((build_dir / LIB_NAME).exists()
                    and (build_dir / BENCH_NAME).exists()
                    and stamp.exists() and stamp.read_text() == digest):
                _compile(build_dir)
                stamp.write_text(digest)
                compiled = True
        _library = HostLibrary(ctypes.CDLL(str(build_dir / LIB_NAME)),
                               build_dir, time.perf_counter() - t0, compiled)
        return _library


def _c_row(row: params_mod.ParameterRow) -> MfaRow:
    return MfaRow(row.max_d, row.block_q, row.block_kv, row.block_d,
                  row.kernel.encode(), row.producer.encode())


def _py_row(r: MfaRow) -> params_mod.ParameterRow:
    return params_mod.ParameterRow(r.max_d, r.block_q, r.block_kv,
                                   r.block_d, r.kernel.decode(),
                                   r.producer.decode())


def parse_table(text: str) -> list[params_mod.ParameterRow]:
    """params.parse_table in C++; raises ValueError with its message."""
    lib = load().lib
    err = ctypes.create_string_buffer(512)
    n = lib.mfa_parse_table(text.encode(), None, 0, err, len(err))
    if n < 0:
        raise ValueError(err.value.decode())
    rows = (MfaRow * n)()
    lib.mfa_parse_table(text.encode(), rows, n, err, len(err))
    return [_py_row(r) for r in rows]


def select_row(rows, head_dim: int) -> params_mod.ParameterRow:
    """params.select_row in C++."""
    c_rows = (MfaRow * len(rows))(*(_c_row(r) for r in rows))
    i = load().lib.mfa_select_row(c_rows, len(rows), head_dim)
    if i < 0:
        raise ValueError(f"no row for head dim {head_dim}")
    return rows[i]


def smem_bytes(kernel: str, row: params_mod.ParameterRow,
               in_bytes: int) -> int:
    """params.smem_bytes in C++."""
    n = load().lib.mfa_smem_bytes(kernel.encode(), ctypes.byref(_c_row(row)),
                                  in_bytes)
    if n < 0:
        raise KeyError(kernel)
    return n


def parameter_table(kernel: str, precision: str,
                    device: params_mod.HopperDevice = params_mod.H100):
    """params.parameter_table's rows, parsed and checked against the
    device's shared memory in C++ (the text is params'); raises as it
    does."""
    tables = params_mod._TABLES.get(device.name)
    if tables is None:
        raise ValueError(f"no parameter rows for {device.name}: the port's "
                         "kernels are built for Hopper (sm90)")
    rows = parse_table(tables[(kernel, precision)])
    in_bytes = 2 if precision.startswith("bf16") else 4
    for row in rows:
        if smem_bytes(kernel, row, in_bytes) > device.smem_per_block:
            raise ValueError(f"{kernel} row {row} exceeds the "
                             f"{device.smem_per_block} bytes of shared "
                             f"memory on {device.name}")
    return rows


def gemm_tile(desc, device: params_mod.HopperDevice = params_mod.H100):
    """(tile name, mma.sync tile name or None) that
    ``desc.kernel_descriptor(device)`` picks, in C++; raises ValueError
    where a tile does not fit the device's shared memory."""
    tile, mma_tile = _I(), _I()
    bad = load().lib.mfa_gemm_tile(
        desc.m, desc.n, desc.k, desc.batch,
        _PRECISIONS.get(desc.a_precision, 3),
        _PRECISIONS.get(desc.b_precision, 3), int(desc.transpose_a),
        int(desc.transpose_b), device.sm_count, device.smem_per_block,
        ctypes.byref(tile), ctypes.byref(mma_tile))
    if bad:
        raise ValueError(f"a tile of {desc} needs more than the "
                         f"{device.smem_per_block} bytes of shared memory "
                         f"on {device.name}")
    return (_TILE_NAMES[tile.value],
            _TILE_NAMES[mma_tile.value] if mma_tile.value >= 0 else None)


def hash_bytes(data: bytes) -> int:
    """runtime/mfa_hash.hpp's hash of ``data``, in C++."""
    buf = ctypes.create_string_buffer(data, len(data))
    return load().lib.mfa_hash_bytes(buf, len(data))


class HostCache:
    """The C++ two-level cache behind ``ops/cache.py``'s interface: keys
    are bytes (hashed by :func:`hash_bytes`), payloads the Python objects
    the build functions return (the C++ side holds their tokens)."""

    def __init__(self):
        self._lib = load().lib
        self._handle = self._lib.mfa_cache_new()
        self._objects: list = []

    def close(self):
        if self._handle:
            self._lib.mfa_cache_free(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _token(self, obj) -> int:
        self._objects.append(obj)
        return len(self._objects)

    def get_pipeline(self, problem_key: bytes, kernel_key: bytes,
                     build_kernel, build_pipeline):
        lib, h = self._lib, self._handle
        pk, kk = hash_bytes(problem_key), hash_bytes(kernel_key)
        hit = lib.mfa_cache_get_pipeline(h, pk)
        if hit:
            return self._objects[hit - 1]
        kernel = lib.mfa_cache_get_library(h, kk)
        kernel = (self._objects[kernel - 1] if kernel
                  else self._objects[lib.mfa_cache_put_library(
                      h, kk, self._token(build_kernel())) - 1])
        return self._objects[lib.mfa_cache_put_pipeline(
            h, pk, self._token(build_pipeline(kernel))) - 1]

    @property
    def stats(self) -> CacheStats:
        out = (_U * 4)()
        self._lib.mfa_cache_stats(self._handle, out)
        return CacheStats(*out)

    def clear(self):
        self._lib.mfa_cache_clear(self._handle)
        self._objects.clear()


def host_bench(timeout_s: float = 120.0) -> str:
    """Run the host bench; its output, which ends in "host-path budget
    OK". Raises if it fails a check or its budget."""
    exe = load().bench
    out = subprocess.run([str(exe)], capture_output=True, text=True,
                         timeout=timeout_s)
    if out.returncode != 0:
        raise RuntimeError(f"{exe.name} failed ({out.returncode}):\n"
                           f"{out.stdout}{out.stderr}")
    return out.stdout
