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
"""
from __future__ import annotations

import torch

from dipole_tpu_torch.ops import _build, neighbors_cuda

__all__ = ["knn_with_dist", "knn_with_dist_plain", "fps_masked_batch",
           "fps_masked_batch_plain", "PLAIN_CUDA_CALLS"]

PLAIN_CUDA_CALLS = {"knn": 0, "fps": 0}


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
