"""PCA utilities and unoriented normal estimation — the port of
dipole_tpu/ops/estimate.py:27-138.

The hybrid criterion (k nearest, then a radius filter) mirrors Open3D's
KDTreeSearchParamHybrid as the JAX package does. `estimate_normals` takes
one of two routes for its neighbour search, chosen from what it is given and
counted in ROUTES:
  - "card": a CUDA device and 0 < k <= neighbors_cuda.RADIUS_MAX_K. The
    kernel csrc/radius_knn.cu searches the cloud on the card, and the PCA
    gathers from its answers where they lie;
  - "host": any other device or k. The native host KD-tree (the library the
    JAX package calls, which the CPU tests hold the port to), its answers
    then copied to the device.
Both give the same in-radius neighbourhoods, up to ties of d2 within an ulp
(the host library may contract d2 into FMAs). The masked covariance and the
closed-form 3x3 eigendecomposition run on `device` in float32 (TF32 is off
package-wide, so the covariance matmul is full float32 like the JAX side's
Precision.HIGHEST). `estimate_normals_tensor` leaves the (N, 6) cloud on
`device`; `estimate_normals` copies it back as numpy. Both record the search
and the PCA (the gather, the eigenvectors, the concatenation and, for
`estimate_normals`, the copy back) as the spans `estimate.knn` and
`estimate.pca` (utils/timing.py).
"""
from __future__ import annotations

import numpy as np
import torch

from dipole_tpu_torch import native
from dipole_tpu_torch.device import resolve_device
from dipole_tpu_torch.ops import _build, neighbors_cuda
from dipole_tpu_torch.ops.fields import sqrt_rn
from dipole_tpu_torch.ops.linalg import eigh3x3, smallest_eigvec_3x3
from dipole_tpu_torch.ops.neighbors import knn
from dipole_tpu_torch.utils.io import orient_center_np
from dipole_tpu_torch.utils.timing import span

__all__ = ["pca_eigen_values", "rotate_to_principle_components", "search_route",
           "estimate_normals", "estimate_normals_tensor", "estimate_normals_knn",
           "orient_center", "ROUTES"]

# estimate_normals calls by the route of their neighbour search
ROUTES = {"card": 0, "host": 0}


def pca_eigen_values(x):
    """(smallest eigenvalue, its eigenvector) of the xyz covariance
    (reference util.py:495-500). Host numpy, float64 like the JAX package."""
    x = np.asarray(x, dtype=np.float64)[:, :3]
    temp = x - x.mean(axis=0)
    cov = temp.T @ temp / x.shape[0]
    e, v = np.linalg.eigh(cov)
    return e[0:1].astype(np.float32), v[:, 0].astype(np.float32)


def rotate_to_principle_components(x, scale: bool = True,
                                   device="cuda") -> torch.Tensor:
    """A cloud rotated into its PCA frame (reference util.py:503-517, JAX
    estimate.py:37-53): (N, 3) or (N, 6) (normals rotated too, unscaled),
    xyz divided by the square root of the largest eigenvalue when `scale`.
    On `device`; device=None leaves a tensor where it lies."""
    x = torch.as_tensor(x)
    if device is not None:
        x = x.to(resolve_device(device))
    x = x.to(torch.float32)
    xyz = x[:, :3]
    temp = xyz - xyz.mean(dim=0)[None, :]
    e, v = eigh3x3(temp.T @ temp / x.shape[0])
    rotated = xyz @ v
    if scale:
        rotated = rotated / sqrt_rn(e[2:3])
    if x.shape[1] == 6:
        rotated = torch.cat([rotated, x[:, 3:6] @ v], dim=-1)
    return rotated


def masked_pca_normals(neigh: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Smallest-eigenvector normals from (N, k, 3) neighbourhoods with a
    validity mask (N, k)."""
    w = valid.to(torch.float32)[..., None]
    cnt = torch.clamp(w.sum(dim=1), min=1.0)
    mean = (neigh * w).sum(dim=1) / cnt
    d = (neigh - mean[:, None, :]) * w
    cov = torch.matmul(d.transpose(1, 2), d) / cnt[..., None]
    return smallest_eigvec_3x3(cov)


def search_route(dev: torch.device, k: int) -> str:
    """"card" where csrc/radius_knn.cu takes the search (a CUDA device, 0 <
    k <= its longest list), else "host"."""
    return ("card" if dev.type == "cuda" and 0 < k <= neighbors_cuda.RADIUS_MAX_K
            else "host")


def estimate_normals(inputpc, max_nn: int = 30, radius: float = 0.1,
                     keep_orientation: bool = False,
                     device="cuda") -> np.ndarray:
    """Unoriented PCA normals with Open3D's hybrid search criterion: up to
    max_nn nearest neighbours (self included) within `radius` (reference
    util.py:551-567). Returns (N, 6) numpy float32: estimate_normals_tensor's
    cloud, copied back inside the `estimate.pca` span."""
    inputpc = np.asarray(inputpc, dtype=np.float32)
    out = _estimate(inputpc, max_nn, radius, device, to_host=True)
    if keep_orientation and inputpc.shape[1] == 6:
        flip = (inputpc[:, 3:6] * out[:, 3:6]).sum(axis=-1) < 0
        out[flip, 3:6] *= -1
    return out


def estimate_normals_tensor(inputpc, max_nn: int = 30, radius: float = 0.1,
                            device="cuda") -> torch.Tensor:
    """estimate_normals' (N, 6) float32 cloud left on `device`: the positions
    and their normals, concatenated where they were computed. Queues the
    device's work and returns without waiting for it."""
    return _estimate(np.asarray(inputpc, dtype=np.float32), max_nn, radius, device,
                     to_host=False)


def _estimate(inputpc: np.ndarray, max_nn: int, radius: float, device, to_host: bool):
    dev = resolve_device(device)
    pos = np.ascontiguousarray(inputpc[:, :3])
    k = min(max_nn, len(pos))
    r2 = neighbors_cuda.radius_sq(radius)
    route = search_route(dev, k)
    _build.bump(ROUTES, route)
    with span("estimate.knn"):
        if route == "card":
            pos_t = torch.as_tensor(pos, device=dev)
            idx, d2 = neighbors_cuda.radius_knn(pos_t, k, radius)
        else:
            idx, d2 = native.knn(pos, pos, k)
    with span("estimate.pca"):
        if route == "host":
            pos_t = torch.as_tensor(pos, device=dev)
            idx = torch.as_tensor(idx, device=dev)
            d2 = torch.as_tensor(d2, device=dev)
        neigh = pos_t[idx]
        out = torch.cat([pos_t, masked_pca_normals(neigh, d2 <= r2)], dim=1)
        return out.cpu().numpy() if to_host else out


def estimate_normals_knn(inputpc, max_nn: int = 30, device="cuda") -> np.ndarray:
    """Unoriented PCA normals over the max_nn nearest neighbours with no
    radius filter (the reference's torch_cluster path, util.py:520-529; JAX
    estimate.py:119-128), the exact kNN on `device`. Returns (N, 6)."""
    dev = resolve_device(device)
    pos = torch.as_tensor(np.asarray(inputpc, np.float32)[:, :3], device=dev)
    idx, _ = knn(pos, pos, min(max_nn, len(pos)), device=None)
    neigh = pos[idx.long()]
    normals = masked_pca_normals(neigh, torch.ones(neigh.shape[:2], dtype=torch.bool,
                                                   device=dev))
    return torch.cat([pos, normals], dim=1).cpu().numpy()


def orient_center(pred: np.ndarray) -> np.ndarray:
    """Normals flipped toward the centroid-outward direction (reference
    util.py:39-44). Returns a new array."""
    return orient_center_np(pred)
