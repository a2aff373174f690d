"""Wrappers of the search kernels: the PointCNN's `csrc/knn.cu` (replaces
dipole_tpu/ops/neighbors_pallas.py:_knn_kernel) and `csrc/fps.cu`
(neighbors_pallas.py:_fps_batch_kernel), and normal estimation's
`csrc/radius_knn.cu` (replaces no Pallas kernel: the JAX package searches on
the host KD-tree), with its plain torch version `radius_knn_plain` here.

A wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates its outputs and scratch with torch.empty, launches on
the current stream, raises when the launch returns a CUDA error, and adds
one to its count in LAUNCHES. The plain torch versions of knn and fps (and
their CPU dispatch) live in ops/neighbors.py. Every kernel is bit-equal to
its plain version (-fmad=false).
"""
from __future__ import annotations

import ctypes

import torch

from dipole_tpu_torch.ops import _build
from dipole_tpu_torch.ops.fields_cuda import check_tensor

__all__ = ["knn_with_dist", "fps_masked_batch", "fps_plan", "radius_knn",
           "radius_knn_plain", "radius_sq", "LAUNCHES", "MAX_K", "RADIUS_MAX_K",
           "FPS_MAX_PER_LANE"]

LAUNCHES = {"knn": 0, "fps": 0, "radius_knn": 0}
MAX_K = 32
RADIUS_MAX_K = 64       # the longest list of csrc/radius_knn.cu (its kMaxK)
FPS_MAX_PER_LANE = 16   # points a lane of csrc/fps.cu (its kMaxPer)

_P = ctypes.c_void_p
_N = ctypes.c_int


def knn_with_dist(dst: torch.Tensor, src: torch.Tensor, k: int):
    """(idx int32, d2 float32), each (B, Nd, k): the k nearest of the Ns
    sources of each batch for every query, ties to the lowest index — on the
    card, by csrc/knn.cu. dst (B, Nd, 3), src (B, Ns, 3)."""
    check_tensor(dst, "dst", 3, ndim=3)
    check_tensor(src, "src", 3, ndim=3)
    if src.device != dst.device or src.shape[0] != dst.shape[0]:
        raise ValueError("dst and src: expected one batch on one device")
    lib, max_src = _build.entry("knn", "dipole_knn_max_sources", [])
    b, nd, ns = dst.shape[0], dst.shape[1], src.shape[1]
    if not 0 < k <= MAX_K:
        raise ValueError(f"k must be in (0, {MAX_K}]: {k}")
    if not 0 < ns <= max_src() or b > 65535:
        raise ValueError(f"knn kernel takes 1..{max_src()} sources and up to "
                         f"65535 batches, got {ns} and {b}")
    _, fn = _build.entry("knn", "dipole_knn", [_P, _N, _P, _N, _N, _N, _P, _P, _P])
    idx = torch.empty((b, nd, k), dtype=torch.int32, device=dst.device)
    d2 = torch.empty((b, nd, k), dtype=torch.float32, device=dst.device)
    with torch.cuda.device(dst.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(dst.data_ptr(), nd, src.data_ptr(), ns, b, int(k),
                 idx.data_ptr(), d2.data_ptr(), stream)
    _build.check(lib, err, "dipole_knn")
    _build.bump(LAUNCHES, "knn")
    return idx, d2


def fps_plan(n: int) -> tuple[int, int]:
    """(warps, points a lane) of csrc/fps.cu's block for a patch of n
    points: the fewest warps with at most FPS_MAX_PER_LANE points a lane,
    then the fewest points a lane (even, at least 2) that cover n."""
    warps = max(1, -(-n // (32 * FPS_MAX_PER_LANE)))
    per = -(-n // (32 * warps))
    return warps, max(2, per + per % 2)


def fps_masked_batch(pos: torch.Tensor, valid: torch.Tensor, m: int,
                     starts: torch.Tensor) -> torch.Tensor:
    """(B, m) int32 farthest-point selections of each batch row over its
    valid points, from starts (B,) — on the card, by csrc/fps.cu. The
    starts are not read back (that would stall the host): a start outside
    [0, N) makes the kernel trap, and the stream's next synchronisation
    raises "unspecified launch failure". Callers also check their starts
    where they make them (ops/neighbors.fps_masked_batch on host starts,
    models/pointcnn.py)."""
    check_tensor(pos, "pos", 3, ndim=3)
    b, n = pos.shape[0], pos.shape[1]
    if (valid.dtype != torch.bool or valid.shape != (b, n)
            or valid.device != pos.device or not valid.is_contiguous()):
        raise ValueError("valid: expected a contiguous (B, N) bool tensor on "
                         "the positions' device")
    if (starts.dtype != torch.int32 or starts.shape != (b,)
            or starts.device != pos.device or not starts.is_contiguous()):
        raise ValueError("starts: expected a contiguous (B,) int32 tensor on "
                         "the positions' device")
    lib, max_pts = _build.entry("fps", "dipole_fps_max_points", [])
    if not 0 < n <= max_pts():
        raise ValueError(f"fps kernel takes 1..{max_pts()} points, got {n}")
    _, fn = _build.entry("fps", "dipole_fps",
                         [_P, _P, _N, _N, _N, _P, _N, _N, _P, _P])
    warps, per = fps_plan(n)
    out = torch.empty((b, m), dtype=torch.int32, device=pos.device)
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(pos.data_ptr(), valid.data_ptr(), b, n, int(m),
                 starts.data_ptr(), warps, per, out.data_ptr(), stream)
    _build.check(lib, err, "dipole_fps")
    _build.bump(LAUNCHES, "fps")
    return out


def radius_sq(radius: float) -> float:
    """radius² rounded to float32, the bound every d2 is held to (d2 <= it),
    as a Python float."""
    return float(torch.tensor(radius * radius, dtype=torch.float32))


def radius_knn_plain(pos: torch.Tensor, k: int, radius: float):
    """Plain torch version of radius_knn, on pos's device: the dense scan of
    ops/neighbors.knn (d2 = dx*dx + dy*dy + dz*dz, the k smallest (d2,
    index) pairs of each row by a stable sort, in query chunks), then the
    radius mask: a pair with d2 > radius_sq(radius), or a column past the
    cloud's size, reads index 0 and d2 = +inf."""
    from dipole_tpu_torch.ops import neighbors   # it imports this module

    if pos.is_cuda:
        _build.bump(neighbors.PLAIN_CUDA_CALLS, "radius_knn")
    idx, d2 = neighbors.knn(pos, pos, k, device=None)
    if d2.shape[1] < k:
        pad = (pos.shape[0], k - d2.shape[1])
        idx = torch.cat([idx, torch.zeros(pad, dtype=torch.int32, device=idx.device)], 1)
        d2 = torch.cat([d2, torch.full(pad, float("inf"), device=d2.device)], 1)
    inside = d2 <= radius_sq(radius)
    return (torch.where(inside, idx, 0),
            torch.where(inside, d2, float("inf")))


def radius_knn(pos: torch.Tensor, k: int, radius: float):
    """(idx int32, d2 float32), each (N, k): for every point of the cloud pos
    (N, 3), the up to k nearest points of pos within `radius` (self
    included), ordered by (d2, index) ascending, slots past the last one
    inside reading index 0 and d2 = +inf — on the card, by
    csrc/radius_knn.cu: the points bucketed into a grid of at most N cells
    (the keys sorted by torch.sort, no synchronisation), then one thread a
    query over its cells, ring by ring. Bit-equal to radius_knn_plain."""
    check_tensor(pos, "pos", 3)
    if not 0 < k <= RADIUS_MAX_K:
        raise ValueError(f"k must be in (0, {RADIUS_MAX_K}]: {k}")
    n = pos.shape[0]
    dev = pos.device
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    d2 = torch.empty((n, k), dtype=torch.float32, device=dev)
    if n == 0:
        return idx, d2
    lib, bucket = _build.entry("radius_knn", "dipole_radius_knn_bucket",
                               [_P, _N, _N, _P, _P, _P])
    _, search = _build.entry("radius_knn", "dipole_radius_knn_search",
                             [_P, _P, _P, _N, _N, _P, _N, ctypes.c_float, _P, _P,
                              _P, _P, _P])
    cells = n   # the grid's most cells
    grid = torch.empty(16, dtype=torch.int32, device=dev)
    keys = torch.empty(n, dtype=torch.int32, device=dev)
    spos = torch.empty((n, 4), dtype=torch.float32, device=dev)
    starts = torch.empty(cells + 1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = bucket(pos.data_ptr(), n, cells, grid.data_ptr(), keys.data_ptr(), stream)
        _build.check(lib, err, "dipole_radius_knn_bucket")
        sorted_keys, order = torch.sort(keys, stable=True)
        err = search(pos.data_ptr(), sorted_keys.data_ptr(), order.data_ptr(), n,
                     cells, grid.data_ptr(), int(k), radius_sq(radius),
                     spos.data_ptr(), starts.data_ptr(), idx.data_ptr(),
                     d2.data_ptr(), stream)
    _build.check(lib, err, "dipole_radius_knn_search")
    _build.bump(LAUNCHES, "radius_knn")
    return idx, d2
