"""Builds the CUDA kernels of `csrc/` and loads them with ctypes.

Each `csrc/<name>.cu` is compiled by one `nvcc` into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), for sm_90a:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
         -Xptxas -v -shared -Xcompiler -fPIC -o lib<name>.so csrc/<name>.cu

-fmad=false keeps every multiply and add separately rounded, as in the
plain torch versions, so a kernel can be held to its plain version bit for
bit; --use_fast_math is never used, so sqrtf and / stay IEEE where a kernel
writes them: the two interaction matrices (imatrix.cu) and the column
greedy's entries (greedy.cu), which are held bit-equal. group.cu, field.cu,
potential.cu and field_mma.cu take common.cuh's approximate root,
reciprocal and reciprocal root (sqrt.approx, rcp.approx, rsqrt.approx) by
name, with explicit multiply-adds, and are held within stated tolerances.
The libraries go
to `dipole_tpu_torch/_build/<hash>/`, keyed by a hash of the sources and
flags, on first use; all nvcc processes start together. A failed build
raises; there is no fallback.

Building and loading are serialised by one lock, and the temporary output
names carry the process and the thread: threads that call their first
kernels together (graph_dipole's per-patch estimator runs one thread per
patch) build each library once and never write one file from two jobs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["SOURCES", "build_all", "library", "entry", "check", "bump", "BUILD_LOG",
           "COUNT_LOCK"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("potential", "imatrix", "greedy", "field", "group", "knn", "fps",
           "replay", "field_mma", "radius_knn")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
_NVCC_TIMEOUT_S = 600

# name -> nvcc's output (ptxas registers and spills), filled by a fresh build
BUILD_LOG: dict[str, str] = {}
_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.RLock()
# the launch and plain-call counters' lock: handler threads of the server
# launch kernels concurrently
COUNT_LOCK = threading.Lock()


def bump(counts: dict, name: str) -> None:
    """counts[name] += 1 under COUNT_LOCK, so that no count of concurrent
    launches (or plain calls) is lost."""
    with COUNT_LOCK:
        counts[name] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels of dipole_tpu_torch cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Path of every kernel library, building the missing ones (one nvcc
    per source, all started together). Returns {name: path}."""
    with _lock:
        return _build_all()


def _build_all() -> dict[str, Path]:
    out_dir = BUILD_ROOT / _digest()
    paths = {name: out_dir / f"lib{name}.so" for name in SOURCES}
    todo = [name for name in SOURCES if not paths[name].exists()]
    if not todo:
        return paths
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    try:
        for name in todo:
            tmp = paths[name].with_name(
                f"lib{name}.so.tmp{os.getpid()}.{threading.get_ident()}")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp)
        t0 = time.perf_counter()
        for name, (proc, tmp) in procs.items():
            out, _ = proc.communicate(
                timeout=max(1.0, _NVCC_TIMEOUT_S - (time.perf_counter() - t0)))
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
            tmp.replace(paths[name])
            BUILD_LOG[name] = out
    finally:
        for proc, tmp in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name` (built on first use)."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build_all()[name]))
            lib.dipole_error_string.restype = ctypes.c_char_p
            lib.dipole_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
        return _libs[name]


def entry(lib_name: str, fn_name: str, argtypes):
    """(library, C function) of kernel library `lib_name`, the function's
    argument types set and its return type int (a CUDA error code)."""
    lib = library(lib_name)
    fn = getattr(lib, fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return lib, fn


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.dipole_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
