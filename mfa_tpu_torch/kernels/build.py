"""Build and load the port's CUDA kernel library.

At first use, ``nvcc`` compiles every ``mfa_tpu_torch/csrc/*.cu`` for
``sm_90a`` (one compiler process per source, all started together),
links them into ``build/mfa_tpu_torch/libmfa_kernels.so`` under the
repository root, and the library is loaded with ``ctypes``. The sources
have a plain C interface: every pointer and the stream are passed as
``c_void_p``, and every entry returns ``cudaGetLastError()`` right after
its launch. A rebuild happens when the sources' hash changes.

Nothing here runs at import time: the CPU rung has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
CSRC = _ROOT / "mfa_tpu_torch" / "csrc"
BUILD_DIR = _ROOT / "build" / "mfa_tpu_torch"
LIB_NAME = "libmfa_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# C signatures of the library's entries (see csrc/*.cu).
_SIGNATURES = {
    "mfa_flash_fwd": [_P, _P, _P, _P, _P,           # q k v o lse
                      _I, _I, _I, _I, _I, _I,       # bh group R C D panels
                      _I, _I, _F, _F,               # causal window scale2 cap2
                      _I, _I, _I, _I, _I,           # dtype kernel block_q
                                                    # kv d
                      _I, _I, _I, _I,               # stages_k stages_v
                                                    # pingpong producer
                      _P],                          # stream
    "mfa_flash_bwd_q": [_P, _P, _P, _P, _P, _P,     # q k v o do lse
                        _P, _P,                     # dq dterm
                        _I, _I, _I, _I, _I, _I,     # bh group R C D panels
                        _I, _I, _F, _F, _F,         # causal window scale2
                                                    # cap2 scale
                        _I, _I, _I, _I, _I, _I,     # dtype o_f32 kernel
                                                    # block_q kv d
                        _I,                         # producer
                        _P],                        # stream
    "mfa_flash_bwd_kv": [_P, _P, _P, _P, _P, _P,    # q k v do lse dterm
                         _P, _P,                    # dk dv
                         _I, _I, _I, _I, _I, _I,    # bhkv group R C D
                                                    # panels
                         _I, _I, _F, _F, _F,        # causal window scale2
                                                    # cap2 scale
                         _I, _I, _I, _I, _I,        # dtype kernel block_q
                                                    # kv d
                         _I,                        # producer
                         _P],                       # stream
    "mfa_decode_fused_append": [_P, _P, _P, _P, _P,  # q k v ks vs
                                _P, _P, _P,          # k_new v_new lengths
                                _P, _P,              # o workspace
                                _I, _I, _I, _I, _I,  # bh hkv group L D
                                _I, _I, _I,          # window qdt kvfmt
                                _I, _I, _I, _I,      # split_rows chunk
                                                     # threads path
                                _P],                 # stream
    "mfa_decode_attend": [_P, _P, _P, _P, _P,       # q k v ks vs
                          _P, _P, _P,               # lengths o workspace
                          _I, _I, _I, _I, _I,       # bh hkv group L D
                          _I, _I, _I,               # window qdt kvfmt
                          _I, _I, _I, _I,           # split_rows chunk threads
                                                    # path
                          _P],                      # stream
    "mfa_paged_decode": [_P, _P, _P, _P, _P,        # q k v ks vs (pages)
                         _P, _P, _P, _P,            # tables lengths o
                                                    # workspace
                         _I, _I, _I, _I, _I, _I,    # n hkv group max_pages
                                                    # page_size D
                         _I, _I, _I,                # window qdt kvfmt
                         _I, _I, _I, _I,            # split_rows chunk threads
                                                    # path
                         _P],                       # stream
    "mfa_gemm": [_P, _P, _P, _P,                    # a b c0 c
                 _I, _I, _I, _I,                    # batch M N K
                 _L, _L, _L, _L,                    # lda a_batch ldb b_batch
                 _I, _I, _I, _I, _I, _I,            # a_type b_type c_type
                                                    # ta tb tile
                 _I, _I,                            # stages group
                 _P],                               # stream
    "mfa_int4_matmul": [_P, _P, _P, _P,             # x w scale rs
                        _P, _P, _P,                 # part counters y
                        _I, _I, _I,                 # M N K
                        _I, _I, _I,                 # x_bf16 biased tile
                        _I, _I, _I,                 # stages group
                                                    # split_cols
                        _P],                        # stream
}


class KernelLibrary:
    """The loaded shared library plus how it was built."""

    def __init__(self, lib: ctypes.CDLL, path: Path, seconds: float,
                 log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = seconds
        self.build_log = log
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def call(self, name: str, *args) -> None:
        """Call a C entry; raise if the launch reported an error."""
        err = getattr(self.lib, name)(*args)
        if err != 0:
            raise RuntimeError(f"{name} failed with CUDA error {err}")


_lock = threading.Lock()
_library: KernelLibrary | None = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(srcs, lib_path: Path) -> str:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in srcs:
        obj = BUILD_DIR / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs))
    tmp = lib_path.with_suffix(".tmp.so")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, lib_path)
    return "\n".join(logs)


def library() -> KernelLibrary:
    """The kernel library, built on first use (thread-safe, and
    process-safe: the ranks of a multi-process run on one host wait on a
    file lock while the first of them builds, then load its build)."""
    global _library
    with _lock:
        if _library is not None:
            return _library
        srcs = _sources()
        digest = _digest()
        lib_path = BUILD_DIR / LIB_NAME
        stamp = BUILD_DIR / (LIB_NAME + ".sha")
        t0 = time.perf_counter()
        log = "(cached build)"
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / (LIB_NAME + ".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not (lib_path.exists() and stamp.exists()
                    and stamp.read_text() == digest):
                log = _compile(srcs, lib_path)
                stamp.write_text(digest)
        seconds = time.perf_counter() - t0
        _library = KernelLibrary(ctypes.CDLL(str(lib_path)), lib_path,
                                 seconds, log)
        return _library
