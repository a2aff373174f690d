"""The PointCNN forward's dense neighbour search: batched masked kNN with
distances and batched masked farthest-point sampling — the port of the scans
in dipole_tpu/models/pointcnn.py (_knn_self :98-121, _interpolate :211-232,
_fps_masked :183-200) and of their Pallas kernels
(dipole_tpu/ops/neighbors_pallas.py).

Each public function is the dispatch point for its kernel: a CPU tensor takes
the plain torch version below, any other device goes to the wrapper in
ops/neighbors_cuda.py, which launches the CUDA kernel or raises. The plain
versions count their calls on CUDA tensors in PLAIN_CUDA_CALLS.

Decisions are the scans': d2 = dx*dx + dy*dy + dz*dz with each product and
sum rounded apart (dx = query - source for kNN, point - pick for FPS); kNN
takes one minimum per step, ties to the lowest index (torch.argmin returns
the first), then sets it to +inf; FPS takes the first maximum of the running
distance, invalid points parked at -1. The kernels make the same decisions
bit for bit. The JAX package on the CPU may contract a multiply and an add
into one FMA, which moves d2 by an ulp and can swap near-ties: against it,
selections are tie-equivalent.

The general-purpose searches of dipole_tpu/ops/neighbors.py:64-140 (knn,
knn_graph, fps, knn_interpolate) are XLA code in the JAX package, not Pallas,
so here they are plain torch on `device` (the card by default, as the JAX
twins run on the default accelerator; device=None keeps a tensor where it
lies), with the same decisions: kNN sorted by distance, ties to the lower
index; FPS from its start, the first farthest point.
"""
from __future__ import annotations

import torch

from dipole_tpu_torch.device import resolve_device
from dipole_tpu_torch.ops import _build, neighbors_cuda

__all__ = ["knn_with_dist", "knn_with_dist_plain", "fps_masked_batch",
           "fps_masked_batch_plain", "PLAIN_CUDA_CALLS", "knn", "knn_graph",
           "fps", "knn_interpolate"]

PLAIN_CUDA_CALLS = {"knn": 0, "fps": 0, "radius_knn": 0}
_QUERY_ELEMS = 1 << 24   # query block x base: the d2 block of one knn step


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) squared and summed over the last axis of 3, as
    dx*dx + dy*dy + dz*dz."""
    dx = a[..., 0] - b[..., 0]
    dy = a[..., 1] - b[..., 1]
    dz = a[..., 2] - b[..., 2]
    return dx * dx + dy * dy + dz * dz


def knn_with_dist_plain(dst: torch.Tensor, src: torch.Tensor, k: int):
    """Plain torch version of the kNN kernel: the k-step argmin scan.
    dst (B, Nd, 3), src (B, Ns, 3) -> idx (B, Nd, k) int32, d2 float32."""
    if dst.is_cuda:
        _build.bump(PLAIN_CUDA_CALLS, "knn")
    dd = _sq_dist(dst[:, :, None, :], src[:, None, :, :])       # (B, Nd, Ns)
    idx, d2 = [], []
    for _ in range(k):
        j = torch.argmin(dd, dim=-1, keepdim=True)
        d2.append(torch.gather(dd, -1, j))
        idx.append(j)
        dd.scatter_(-1, j, float("inf"))
    return (torch.cat(idx, -1).to(torch.int32), torch.cat(d2, -1))


def knn_with_dist(dst: torch.Tensor, src: torch.Tensor, k: int):
    """(idx, d2) of the k nearest src points per dst point, batched:
    dst (B, Nd, 3), src (B, Ns, 3) float32 on one device."""
    dst = dst.contiguous()
    src = src.contiguous()
    if dst.device.type == "cpu":
        return knn_with_dist_plain(dst, src, k)
    return neighbors_cuda.knn_with_dist(dst, src, k)


def fps_masked_batch_plain(pos: torch.Tensor, valid: torch.Tensor, m: int,
                           starts: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the FPS kernel: _fps_masked over the batch.
    pos (B, N, 3), valid (B, N) bool, starts (B,) -> (B, m) int32."""
    if pos.is_cuda:
        _build.bump(PLAIN_CUDA_CALLS, "fps")
    return _fps_scan(pos, valid, m, starts)


def _fps_scan(pos, valid, m: int, starts) -> torch.Tensor:
    rows = torch.arange(pos.shape[0], device=pos.device)
    starts = starts.to(device=pos.device, dtype=torch.int64)

    def dist(c):
        return _sq_dist(pos, pos[rows, c][:, None, :])

    mind = torch.where(valid, dist(starts), torch.full_like(pos[..., 0], -1.0))
    sel = [starts]
    for _ in range(1, m):
        c = torch.argmax(mind, dim=1)
        sel.append(c)
        mind = torch.minimum(mind, dist(c))
    return torch.stack(sel, dim=1).to(torch.int32)


def fps_masked_batch(pos: torch.Tensor, valid: torch.Tensor, m: int,
                     starts: torch.Tensor) -> torch.Tensor:
    """Batched masked FPS: (B, m) int32 selections of each row's valid
    points from its start, invalid points never chosen while a valid one
    remains. pos (B, N, 3) float32, valid (B, N) bool, starts (B,) int in
    [0, N): checked here when they lie on the host."""
    pos = pos.contiguous()
    starts = torch.as_tensor(starts)
    if starts.device.type == "cpu" and not bool(
            ((starts >= 0) & (starts < pos.shape[1])).all()):
        # host starts are checked here; starts on the card are not read back
        raise ValueError(f"starts outside [0, {pos.shape[1]})")
    if pos.device.type == "cpu":
        return fps_masked_batch_plain(pos, valid, m, starts)
    return neighbors_cuda.fps_masked_batch(
        pos, valid.contiguous(), m,
        starts.to(device=pos.device, dtype=torch.int32).contiguous())


def _xyz(x, device) -> torch.Tensor:
    """The first three columns of x as float32 on `device`; device=None
    leaves a tensor where it lies (numpy: the CPU)."""
    x = torch.as_tensor(x)
    if device is not None:
        x = x.to(resolve_device(device))
    return x[:, :3].to(torch.float32).contiguous()


def knn(base, query, k: int, device="cuda"):
    """For each query point, the k nearest base points (JAX
    neighbors.py:64-75): (indices (Nq, k) int32, squared distances (Nq, k)),
    ascending, ties to the lower index; k is capped at the base size."""
    base = _xyz(base, device)
    query = _xyz(query, base.device)
    k = min(k, base.shape[0])
    block = max(1, _QUERY_ELEMS // max(base.shape[0], 1))
    idx, d2 = [], []
    for lo in range(0, query.shape[0], block):
        dd = _sq_dist(query[lo:lo + block, None, :], base[None, :, :])
        d, i = torch.sort(dd, dim=1, stable=True)
        idx.append(i[:, :k].to(torch.int32))
        d2.append(d[:, :k].clone())   # not a view that keeps the block alive
    if not idx:
        return (torch.zeros((0, k), dtype=torch.int32, device=base.device),
                torch.zeros((0, k), device=base.device))
    return torch.cat(idx), torch.cat(d2)


def knn_graph(pos, k: int, loop: bool = True, device="cuda") -> torch.Tensor:
    """Neighbour table (N, k) with self when loop (the XConv convention,
    reference models/XConv.py:124-126; JAX neighbors.py:78-93); without
    loop, k + 1 are searched and the self column dropped."""
    pos = _xyz(pos, device)
    if loop:
        return knn(pos, pos, k, device=None)[0]
    idx, _ = knn(pos, pos, min(k + 1, pos.shape[0]), device=None)
    rows = torch.arange(pos.shape[0], device=pos.device)[:, None]
    # stable-compact each row (self may not come first under ties)
    order = torch.argsort((idx == rows).to(torch.uint8), dim=1, stable=True)
    return torch.gather(idx, 1, order)[:, :k]


def fps(pos, ratio: float, start: int | None = None, key=None,
        device="cuda") -> torch.Tensor:
    """Farthest point sampling of ceil(ratio N) indices (JAX
    neighbors.py:115-128): from `start`, else from
    prng.randint(key, (), 0, N) when a threefry key is given, else 0.
    (m,) int32."""
    from dipole_tpu_torch.utils import prng

    pos = _xyz(pos, device)
    n = pos.shape[0]
    m = max(1, min(int(-(-n * ratio // 1)), n))
    if start is None:
        start = int(prng.randint(key, (), 0, n)) if key is not None else 0
    valid = torch.ones((1, n), dtype=torch.bool, device=pos.device)
    return _fps_scan(pos[None], valid, m, torch.tensor([start]))[0]


def knn_interpolate(x, pos_x, pos_y, k: int = 16,
                    device="cuda") -> torch.Tensor:
    """Inverse-squared-distance kNN interpolation of features x from pos_x
    onto pos_y (JAX neighbors.py:131-140): w = 1 / max(d^2, 1e-16)."""
    idx, d2 = knn(pos_x, pos_y, k, device=device)
    x = torch.as_tensor(x).to(device=idx.device, dtype=torch.float32)
    w = 1.0 / torch.clamp(d2, min=1e-16)
    num = (x[idx.long()] * w[..., None]).sum(dim=1)
    return num / w.sum(dim=1, keepdim=True)
