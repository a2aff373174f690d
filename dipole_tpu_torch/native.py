"""ctypes bridge to the native host runtime (native/dipole_native.cpp).

The port's own copy of dipole_tpu/native.py:23-92. It loads the same
`native/libdipole_native.so` the JAX package loads, so both packages search
neighbours with the same code. If that file is missing or does not load
(the committed build uses -march=native, so another host may reject it), the
source is built with the Makefile's flags into the port's ignored build
directory, never into native/. If neither works the call raises: no entry
point has a Python or scipy fallback on the port's path.
"""
from __future__ import annotations

import ctypes
import os
import shlex
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

__all__ = ["knn", "bfs_route_csr", "flip_local_search", "hoppe_orient_signs",
           "pca_normals", "load", "available"]

_REPO = Path(__file__).resolve().parent.parent
_NATIVE_DIR = _REPO / "native"
_LIB_PATH = _NATIVE_DIR / "libdipole_native.so"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_lib = None
_lock = threading.Lock()

_F = ctypes.POINTER(ctypes.c_float)
_I = ctypes.POINTER(ctypes.c_int)
# the C ABI of every exported function (dipole_tpu/native.py:33-58)
_SIGNATURES = {
    "dn_knn": (None, [_F, ctypes.c_int, _F, ctypes.c_int, ctypes.c_int, _I, _F]),
    "dn_bfs_route": (ctypes.c_int, [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int64), _I, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64)]),
    "dn_flip_local_search": (ctypes.c_double, [
        ctypes.c_int, ctypes.POINTER(ctypes.c_double), ctypes.c_int8,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]),
    "dn_hoppe_orient": (None, [
        _F, _F, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int8)]),
    "dn_pca_normals": (None, [
        _F, ctypes.c_int, _I, _F, ctypes.c_int, ctypes.c_float, _F]),
}


def _build_from_source() -> Path:
    """Compile native/dipole_native.cpp with the Makefile's flags into the
    port's build directory."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _BUILD_DIR / "libdipole_native.so"
    tmp = out.with_suffix(f".so.tmp{os.getpid()}")
    cmd = ["g++", *shlex.split("-O3 -march=native -std=c++17 -fPIC -shared -pthread"),
           "-o", str(tmp), str(_NATIVE_DIR / "dipole_native.cpp")]
    subprocess.run(cmd, check=True, capture_output=True)
    tmp.replace(out)
    return out


_PROBE = """
import ctypes, sys
F = ctypes.POINTER(ctypes.c_float)
lib = ctypes.CDLL(sys.argv[1])
pts = (ctypes.c_float * 6)()
idx = (ctypes.c_int * 2)()
d2 = (ctypes.c_float * 2)()
lib.dn_knn(pts, 2, pts, 2, 1, idx, d2)
"""


def _probe(path: Path) -> None:
    """One tiny kNN call in a child process: a library built for other CPU
    instructions dies there (SIGILL) instead of inside the pipeline."""
    subprocess.run([sys.executable, "-c", _PROBE, str(path)], check=True,
                   capture_output=True, timeout=60)


def load():
    """The loaded native library (cached); raises if it can be neither
    loaded nor built."""
    with _lock:
        return _load()


def _load():
    global _lib
    if _lib is not None:
        return _lib
    errors = []
    candidates = [_LIB_PATH, _BUILD_DIR / "libdipole_native.so", None]
    for path in candidates:
        try:
            if path is None:
                path = _build_from_source()
            if not path.exists():
                continue
            _probe(path)
            lib = ctypes.CDLL(str(path))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
        except (OSError, AttributeError, subprocess.SubprocessError) as e:
            errors.append(f"{path}: {e}")
            continue
        _lib = lib
        return lib
    raise RuntimeError("native library unavailable: " + "; ".join(errors))


def available() -> bool:
    """Whether the native library loads (or builds) on this host."""
    try:
        load()
    except RuntimeError:
        return False
    return True


def knn(base: np.ndarray, query: np.ndarray, k: int):
    """(indices (m,k) int64, squared distances (m,k) float32), sorted
    ascending — dipole_tpu/native.py:69-92 without its scipy fallback."""
    base = np.ascontiguousarray(np.asarray(base, np.float32)[:, :3])
    query = np.ascontiguousarray(np.asarray(query, np.float32)[:, :3])
    n, m = len(base), len(query)
    k = min(k, n)
    lib = load()
    idx = np.empty((m, k), np.int32)
    d2 = np.empty((m, k), np.float32)
    lib.dn_knn(base.ctypes.data_as(_F), n, query.ctypes.data_as(_F), m, k,
               idx.ctypes.data_as(_I), d2.ctypes.data_as(_F))
    return idx.astype(np.int64), d2


def bfs_route_csr(indptr: np.ndarray, indices: np.ndarray, start: int):
    """BFS order with disconnected-component restart over a CSR graph
    (dipole_tpu/native.py:95-137 without its Python fallback). Returns
    (route (n,) int64, number of components)."""
    n = len(indptr) - 1
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    if not 0 <= start < n:
        raise ValueError(f"start {start} outside [0, {n})")
    lib = load()
    out = np.empty(n, np.int64)
    comp = lib.dn_bfs_route(
        n, indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        indices.ctypes.data_as(_I), int(start),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out, comp


def hoppe_orient_signs(xyz: np.ndarray, nrm: np.ndarray, k: int) -> np.ndarray:
    """Hoppe consistent orientation in C++: kNN graph, 1 - |n.n| Prim MST,
    per-component max-z seeding and DFS sign propagation
    (dipole_tpu/native.py:140-159). Returns signs (n,) int8 in {+1, -1}."""
    xyz = np.ascontiguousarray(np.asarray(xyz, np.float32)[:, :3])
    nrm = np.ascontiguousarray(np.asarray(nrm, np.float32)[:, :3])
    n = len(xyz)
    lib = load()
    out = np.empty(n, np.int8)
    lib.dn_hoppe_orient(xyz.ctypes.data_as(_F), nrm.ctypes.data_as(_F), n, int(k),
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
    return out


def flip_local_search(M: np.ndarray, x0: np.ndarray, minimize: bool,
                      max_rounds: int = 256) -> np.ndarray:
    """Single-flip descent on obj = sum M_ij xor_ij from x0 in {0, 1}^n
    (dipole_tpu/native.py:162-175). Returns x (n,) uint8."""
    x = np.ascontiguousarray(np.asarray(x0, np.uint8).copy())
    M = np.ascontiguousarray(np.asarray(M, np.float64))
    lib = load()
    lib.dn_flip_local_search(
        len(x), M.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        -1 if minimize else 1, x.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        max_rounds)
    return x


def pca_normals(pos: np.ndarray, idx: np.ndarray, d2: np.ndarray,
                r2: float) -> np.ndarray:
    """Smallest-eigenvector normals of each point's neighbours idx (n, k)
    whose squared distance d2 is at most r2, in C++ with float64 sums and
    the closed-form 3x3 eigensolver (dn_pca_normals,
    native/dipole_native.cpp:386; dipole_tpu/native.py:178-200). Returns
    (n, 3) float32."""
    pos = np.ascontiguousarray(np.asarray(pos, np.float32)[:, :3])
    idx = np.ascontiguousarray(np.asarray(idx, np.int32))
    d2 = np.ascontiguousarray(np.asarray(d2, np.float32))
    n, k = idx.shape
    if d2.shape != (n, k) or (n and not 0 <= idx.min() <= idx.max() < len(pos)):
        raise ValueError(f"idx {idx.shape} and d2 {d2.shape} must match, with "
                         f"indices in [0, {len(pos)})")
    lib = load()
    out = np.empty((n, 3), np.float32)
    lib.dn_pca_normals(pos.ctypes.data_as(_F), n, idx.ctypes.data_as(_I),
                       d2.ctypes.data_as(_F), k, float(r2), out.ctypes.data_as(_F))
    return out
