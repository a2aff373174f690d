"""Dipole potential, field, interaction matrices, group interaction and the
edge calculators — the port of dipole_tpu/ops/fields.py:107-227, :262-324
(:369-427), :430-468 and :475-532.

Physics (reference field_utils.py):
  potential  phi_t = sum_s p_s . R_ts / |R_ts|^3, R_ts = x_s - x_t, no eps;
             a coincident pair poisons the target's total, which is then
             scrubbed to 0 (field_utils.py:49-55)
  field      E_t = -sum_s (3 (p_s . R) R / r^2 - p_s) / (r^3 + eps),
             coincident pairs contribute nothing, non-finite components
             of the total 0 (field_utils.py:61-116)
  matrix     I[i, j] = E_j(x_i) . n_i, zero-distance and non-finite
             entries 0
  group      F[i, g] = sum over sources j of group g of I[i, j]
  xie        I[i, j] = (n_j.n_i - C (n_j.R)/r (n_i.R)/r) / r^3, the mirror
             field of j at i dotted with n_i; n_j.n_i at r = 0, non-finite
             entries 0 (field_utils.py:431-469, 509-519)

Each public function here is the dispatch point for its kernel: a CPU
tensor takes the plain torch version below, any other device goes to the
wrapper in ops/fields_cuda.py, which launches the CUDA kernel or raises.
The plain versions are tiled so that memory stays bounded, and count their
calls on CUDA tensors in PLAIN_CUDA_CALLS (so a run on the card can show it
never took them).

Arithmetic is the XLA formula the JAX package computes on every platform
(fields.py:124-133, 287-302), each 3-term dot product written out as
x*x' + y*y' + z*z' (no matmul: on CUDA that would go to cuBLAS and sum in
another order), and every square root correctly rounded (`sqrt_rn`).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from dipole_tpu_torch.device import as_f32, resolve_device
from dipole_tpu_torch.ops import _build, fields_cuda
from dipole_tpu_torch.utils.io import gen_grid

__all__ = ["potential", "potential_plain", "measure_mean_potential",
           "measure_mean_potential_batched",
           "field_grad", "field_grad_plain", "reference_field",
           "dipole_interaction_matrix", "dipole_interaction_matrix_plain",
           "point_group_interaction", "point_group_interaction_plain",
           "xie_interaction_matrix", "xie_interaction_matrix_plain",
           "field_edge_calculator", "field_edge_calculator_bool",
           "field_edge_calculator_count", "self_interaction",
           "self_interaction_all", "random_self_interaction", "xie_distance",
           "sqrt_rn", "PLAIN_CUDA_CALLS"]

PLAIN_CUDA_CALLS = {"dipole_potential": 0, "dipole_imatrix": 0,
                    "dipole_field": 0, "dipole_group": 0, "xie_imatrix": 0}

_PLAIN_BLOCK_S = 8192   # sources per tile of the plain potential
_PLAIN_BLOCK_T = 1024   # target rows per tile of the plain matrix and field
_FIELD_BLOCK_S = 1024   # sources per tile sum of the plain field (BLOCK_S)
_GROUP_BLOCK_S = 4096   # sources per one-hot product of the plain group


def _count_plain(name: str, t: torch.Tensor) -> None:
    if t.is_cuda:
        _build.bump(PLAIN_CUDA_CALLS, name)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, as IEEE sqrtf in the kernels.
    On CUDA that is torch.sqrt. torch's CPU sqrt is off by an ulp on some
    inputs (in float32 and, rarely, after rounding from float64 too), and
    which elements take that path changes from process to process; so on
    the CPU the root is numpy's, which is the hardware's exact one."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def potential_plain(sources: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the potential kernel. sources (M, 6),
    targets (T, >=3) -> phi (T,)."""
    _count_plain("dipole_potential", sources)
    tx, ty, tz = (targets[:, k:k + 1] for k in range(3))
    phi = torch.zeros(targets.shape[0], dtype=torch.float32,
                      device=targets.device)
    for b in range(0, sources.shape[0], _PLAIN_BLOCK_S):
        s = sources[b:b + _PLAIN_BLOCK_S]
        Rx = s[:, 0] - tx
        Ry = s[:, 1] - ty
        Rz = s[:, 2] - tz
        r2 = Rx * Rx + Ry * Ry + Rz * Rz
        r3 = r2 * sqrt_rn(r2)
        c = s[:, 3] * Rx + s[:, 4] * Ry + s[:, 5] * Rz
        phi = phi + torch.sum(c / r3, dim=1)
    return torch.where(torch.isfinite(phi), phi, torch.zeros_like(phi))


def potential(sources: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Dipole potential at targets (reference field_utils.py:12-55).
    sources (M, >=6) and targets (T, >=3) float32 tensors on one device."""
    src = sources[:, :6].contiguous()
    tgt = targets[:, :3].contiguous()
    if src.device.type == "cpu":
        return potential_plain(src, tgt)
    return fields_cuda.potential(src, tgt)


@functools.lru_cache(maxsize=None)
def _lattice(dev: torch.device) -> torch.Tensor:
    """The sign fix's 10^3 lattice (gen_grid(10)) on `dev`, uploaded once a
    device; never written."""
    return torch.as_tensor(gen_grid(10), device=dev)


def measure_mean_potential(pc, device="cuda") -> float:
    """Mean dipole potential over the 10^3 lattice (reference
    field_utils.py:7-9 + util.gen_grid util.py:26-36). Callers flip all
    normals when this is negative."""
    dev = resolve_device(device)
    return float(torch.mean(potential(as_f32(pc, dev), _lattice(dev))))


def measure_mean_potential_batched(pcs, device="cuda") -> np.ndarray:
    """The mean lattice potential of SEVERAL clouds (JAX fields.py:240-259),
    the micro-batched form of the sign fix: one potential launch a cloud
    (a cloud's sign fix is a small kernel), the means read back together.
    Each mean is measure_mean_potential's on that cloud, bit for bit. The
    JAX package's sentinel rows (padding to one vmapped shape) add terms
    that are exactly zero, so there are none here. Returns (B,) float32."""
    dev = resolve_device(device)
    if not len(pcs):
        return np.zeros((0,), np.float32)
    grid = _lattice(dev)
    return torch.stack([torch.mean(potential(as_f32(pc, dev), grid))
                        for pc in pcs]).cpu().numpy()


def _imatrix_tile(t: torch.Tensor, sources: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """I (T, M) for targets t (T, 6) and sources (M, 6): the two-divide XLA
    formula of fields.py:287-302, term for term as csrc/common.cuh."""
    sx, sy, sz, px, py, pz = (sources[:, k] for k in range(6))
    tx, ty, tz, nx, ny, nz = (t[:, k:k + 1] for k in range(6))
    Rx = sx - tx
    Ry = sy - ty
    Rz = sz - tz
    r2 = Rx * Rx + Ry * Ry + Rz * Rz
    zero = r2 == 0.0
    r = sqrt_rn(r2)
    denom = r * r2 + eps
    c = px * Rx + py * Ry + pz * Rz
    Rn = nx * Rx + ny * Ry + nz * Rz
    pn = px * nx + py * ny + pz * nz
    safe_r2 = torch.where(zero, torch.ones_like(r2), r2)
    I = -(3.0 * c * Rn / (safe_r2 * denom) - pn / denom)
    return torch.where(zero | ~torch.isfinite(I), torch.zeros_like(I), I)


def dipole_interaction_matrix_plain(targets: torch.Tensor, sources: torch.Tensor,
                                    eps: float) -> torch.Tensor:
    """Plain torch version of the interaction-matrix kernel. targets (T, 6),
    sources (M, 6) -> I (T, M)."""
    _count_plain("dipole_imatrix", sources)
    rows = [_imatrix_tile(targets[b:b + _PLAIN_BLOCK_T], sources, eps)
            for b in range(0, targets.shape[0], _PLAIN_BLOCK_T)]
    if not rows:
        return torch.zeros((0, sources.shape[0]), dtype=torch.float32,
                           device=sources.device)
    return torch.cat(rows, dim=0)


def dipole_interaction_matrix(pts: torch.Tensor, eps: float = 1e-6,
                              targets: torch.Tensor | None = None) -> torch.Tensor:
    """I[i, j] = (dipole field of point j evaluated at point i) . n_i.
    pts (M, >=6) sources; targets (T, >=6), default pts. Without targets
    the card's kernel runs its symmetric mode, the terms of each pair
    serving both I[i, j] and I[j, i]."""
    src = pts[:, :6].contiguous()
    tgt = src if targets is None else targets[:, :6].contiguous()
    if src.device.type == "cpu":
        return dipole_interaction_matrix_plain(tgt, src, eps)
    return fields_cuda.dipole_imatrix(tgt, src, eps, symmetric=targets is None)


def field_grad_plain(sources: torch.Tensor, targets: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """Plain torch version of the field kernel. sources (M, 6), targets
    (T, 3) -> E (T, 3). The XLA tile formula of fields.py:107-121 (one
    reciprocal per pair, term_R and term_p summed apart), one tile sum per
    block of 1024 sources as the XLA scan, scrubbed after the total."""
    _count_plain("dipole_field", sources)
    E = torch.zeros((targets.shape[0], 3), dtype=torch.float32,
                    device=targets.device)
    for tb in range(0, targets.shape[0], _PLAIN_BLOCK_T):
        tx, ty, tz = (targets[tb:tb + _PLAIN_BLOCK_T, k:k + 1] for k in range(3))
        for sb in range(0, sources.shape[0], _FIELD_BLOCK_S):
            s = sources[sb:sb + _FIELD_BLOCK_S]
            px, py, pz = s[:, 3], s[:, 4], s[:, 5]
            Rx = s[:, 0] - tx
            Ry = s[:, 1] - ty
            Rz = s[:, 2] - tz
            r2 = Rx * Rx + Ry * Ry + Rz * Rz
            zero = r2 == 0.0
            r = sqrt_rn(r2)
            denom = r * r2 + eps
            c = px * Rx + py * Ry + pz * Rz
            safe_r2 = torch.where(zero, torch.ones_like(r2), r2)
            t = 1.0 / (safe_r2 * denom)
            a = torch.where(zero, torch.zeros_like(t), 3.0 * c * t)
            b = torch.where(zero, torch.zeros_like(t), safe_r2 * t)
            term_R = torch.stack([(a * Rx).sum(1), (a * Ry).sum(1),
                                  (a * Rz).sum(1)], dim=1)
            term_p = torch.stack([(b * px).sum(1), (b * py).sum(1),
                                  (b * pz).sum(1)], dim=1)
            E[tb:tb + _PLAIN_BLOCK_T] += -(term_R - term_p)
    return torch.where(torch.isfinite(E), E, torch.zeros_like(E))


def field_grad(sources: torch.Tensor, targets: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Dipole field E (T, 3) at targets (T, >=3) from dipole sources
    (M, >=6), float32 tensors on one device (reference field_utils.py:61-116,
    JAX fields.py:186-202)."""
    src = sources[:, :6].contiguous()
    tgt = targets[:, :3].contiguous()
    if src.device.type == "cpu":
        return field_grad_plain(src, tgt, eps)
    return fields_cuda.field_grad(src, tgt, eps)


def reference_field(ref_pc, target_pc, device="cuda") -> np.ndarray:
    """Orientation transfer from an oriented cloud (reference
    field_utils.py:188-201, JAX fields.py:262-280): the reference's field at
    the targets; targets without normals adopt the normalized field as their
    normal, targets with normals only take the sign of E.n."""
    dev = resolve_device(device)
    ref_pc = np.asarray(ref_pc, dtype=np.float32)
    target_pc = np.asarray(target_pc, dtype=np.float32)
    E = field_grad(as_f32(ref_pc, dev), as_f32(target_pc, dev)).cpu().numpy()
    if target_pc.shape[1] == 3:
        length = np.linalg.norm(E, axis=-1)
        nz = length != 0
        En = E.copy()
        En[nz] = E[nz] / length[nz, None]
        return np.concatenate([target_pc, En], axis=1)
    out = target_pc.copy()
    inter = (E * out[:, 3:6]).sum(axis=-1)
    sign = (inter >= 0).astype(np.float32) * 2 - 1
    out[:, 3:6] *= sign[:, None]
    return out


def point_group_interaction_plain(pts: torch.Tensor, group_ids: torch.Tensor,
                                  num_groups: int, eps: float,
                                  targets: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version of the group kernel: the interaction matrix tile
    by tile, summed into groups. pts (N, 6) are the sources, and the
    targets unless targets (T, 6) are given; ids outside [0, num_groups)
    contribute nowhere. On the card the sums are a one-hot product, as the
    JAX package takes them (fields.py:431-447); on the CPU each row is
    summed in float64 in source order (index_add_), so that a row does not
    depend on the rows beside it (BLAS blocks its products by the row
    count): a target shard gives the bits of the whole call."""
    _count_plain("dipole_group", pts)
    tgt = pts if targets is None else targets
    n = pts.shape[0]
    exact = pts.device.type == "cpu"
    F = torch.zeros((tgt.shape[0], num_groups),
                    dtype=torch.float64 if exact else torch.float32,
                    device=pts.device)
    gid = group_ids.to(device=pts.device, dtype=torch.int64)
    for sb in range(0, n, _GROUP_BLOCK_S):
        g = gid[sb:sb + _GROUP_BLOCK_S]
        keep = torch.nonzero((g >= 0) & (g < num_groups))[:, 0]
        src = pts[sb:sb + _GROUP_BLOCK_S]
        if exact:
            src, g = src[keep], g[keep]
        else:
            onehot = torch.zeros((len(g), num_groups), dtype=torch.float32,
                                 device=pts.device)
            onehot[keep, g[keep]] = 1.0
        for tb in range(0, tgt.shape[0], _PLAIN_BLOCK_T):
            I = _imatrix_tile(tgt[tb:tb + _PLAIN_BLOCK_T], src, eps)
            if exact:
                F[tb:tb + _PLAIN_BLOCK_T].index_add_(1, g, I.double())
            else:
                F[tb:tb + _PLAIN_BLOCK_T] += I @ onehot
    return F.to(torch.float32)


def point_group_interaction(pts, group_ids, num_groups: int, eps: float = 1e-5,
                            source_weights=None,
                            targets: torch.Tensor | None = None) -> torch.Tensor:
    """F[i, g] = sum over sources j in group g of I[i, j] (JAX
    fields.py:450-468): the core of patch propagation. pts (N, >=6) float32
    tensor, group_ids (N,) integer tensor on its device. source_weights
    optionally scales every point's moment, as targets and as sources
    (weighted_prop). targets (T, >=6), default pts: rows of F for other
    points, used as given (parallel/sharding.py's target shards); a row's
    value does not depend on the rows beside it."""
    pts = pts[:, :6].to(torch.float32)
    if source_weights is not None:
        pts = pts.clone()
        pts[:, 3:6] *= torch.as_tensor(source_weights, dtype=torch.float32,
                                       device=pts.device)[:, None]
    pts = pts.contiguous()
    tgt = None if targets is None else targets[:, :6].to(torch.float32).contiguous()
    n_t = pts.shape[0] if tgt is None else tgt.shape[0]
    gid = torch.as_tensor(group_ids, device=pts.device)
    if num_groups == 0 or n_t == 0:
        return torch.zeros((n_t, num_groups), dtype=torch.float32,
                           device=pts.device)
    if pts.device.type == "cpu":
        return point_group_interaction_plain(pts, gid, num_groups, eps, tgt)
    return fields_cuda.point_group(pts, gid, num_groups, eps, targets=tgt)


def _xie_tile(t: torch.Tensor, sources: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """I (T, M) of the xie matrix for targets t (T, 6) and sources (M, 6):
    the XLA tile formula of fields.py:305-324 term for term, as
    csrc/common.cuh's xie_pair."""
    sx, sy, sz, px, py, pz = (sources[:, k] for k in range(6))
    tx, ty, tz, nx, ny, nz = (t[:, k:k + 1] for k in range(6))
    Rx = sx - tx
    Ry = sy - ty
    Rz = sz - tz
    r2 = Rx * Rx + Ry * Ry + Rz * Rz
    zero = r2 == 0.0
    r = sqrt_rn(r2)
    one = torch.ones_like(r2)
    safe_r = torch.where(zero, one, r)
    nsR = (px * Rx + py * Ry + pz * Rz) / safe_r
    ntR = (nx * Rx + ny * Ry + nz * Rz) / safe_r
    nn = px * nx + py * ny + pz * nz
    core = nn - C * nsR * ntR
    r3 = r2 * r
    I = torch.where(zero, nn, core / torch.where(zero, one, r3))
    return torch.where(torch.isfinite(I), I, torch.zeros_like(I))


def xie_interaction_matrix_plain(targets: torch.Tensor, sources: torch.Tensor,
                                 C: float, transposed: bool = False) -> torch.Tensor:
    """Plain torch version of the xie matrix kernel. targets (T, 6), sources
    (M, 6) -> I (T, M), or I^T (M, T) with the same bits when transposed."""
    _count_plain("xie_imatrix", sources)
    c = torch.tensor(C, dtype=torch.float32, device=sources.device)
    if transposed:
        out = torch.empty((sources.shape[0], targets.shape[0]),
                          dtype=torch.float32, device=sources.device)
        for b in range(0, sources.shape[0], _PLAIN_BLOCK_T):
            out[b:b + _PLAIN_BLOCK_T] = _xie_tile(
                targets, sources[b:b + _PLAIN_BLOCK_T], c).t()
        return out
    out = torch.empty((targets.shape[0], sources.shape[0]), dtype=torch.float32,
                      device=sources.device)
    for b in range(0, targets.shape[0], _PLAIN_BLOCK_T):
        out[b:b + _PLAIN_BLOCK_T] = _xie_tile(targets[b:b + _PLAIN_BLOCK_T],
                                              sources, c)
    return out


def xie_interaction_matrix(pts: torch.Tensor, C: float = 3.0,
                           targets: torch.Tensor | None = None, knn_mask=None,
                           transposed: bool = False) -> torch.Tensor:
    """Mirror-field interaction matrix I (T, M) (reference xie_intersaction,
    field_utils.py:509-519; JAX fields.py:400-427). pts (M, >=6) sources;
    targets (T, >=6), default pts. knn_mask: optional dense (T, M) 0/1 array
    keeping pair (i, j) iff target i is among source j's nearest (the
    propagation loops take the index form instead). transposed: return I^T
    (M, T), the layout the sequential xie loop reads columns from. The
    card's kernel runs exactly the real rows and columns (the JAX bucket
    padding is a TPU artefact); without targets it runs its symmetric mode,
    the terms of each pair serving both I[i, j] and I[j, i]."""
    src = pts[:, :6].contiguous()
    tgt = src if targets is None else targets[:, :6].contiguous()
    if src.device.type == "cpu":
        I = xie_interaction_matrix_plain(tgt, src, C, transposed)
    else:
        I = fields_cuda.xie_imatrix(tgt, src, C, transposed,
                                    symmetric=targets is None)
    if knn_mask is not None:
        mask = as_f32(knn_mask, I.device)
        I = I * (mask.t() if transposed else mask)
    return I


# ---------------------------------------------------------------------------
# Edge calculators / self-interaction diagnostics (JAX fields.py:475-532)
# ---------------------------------------------------------------------------

def field_edge_calculator(sources, targets, if_save: bool = False,
                          device="cuda"):
    """Patch-patch interaction weight (reference field_utils.py:145-160):
    w = (2 * sum E(S->T).n_T / |S|) * |T| (that operator order is the
    reference's), and its negation. The field runs on csrc/field.cu on the
    card; the sum over targets is float32, as in the JAX package."""
    dev = resolve_device(device)
    tgt = as_f32(targets, dev)
    E = field_grad(as_f32(sources, dev), tgt[:, :3])
    inter = float(torch.sum(E * tgt[:, 3:6]))
    w = inter * 2.0 / np.shape(sources)[0] * np.shape(targets)[0]
    return w, -w


def field_edge_calculator_bool(sources, targets, if_save: bool = False,
                               device="cuda"):
    w, _ = field_edge_calculator(sources, targets, if_save, device=device)
    return (1, -1) if w > 0 else (-1, 1)


def field_edge_calculator_count(sources, targets, if_save: bool = False,
                                device="cuda"):
    w, _ = field_edge_calculator(sources, targets, if_save, device=device)
    n = np.shape(sources)[0] * np.shape(targets)[0]
    return (n, -n) if w > 0 else (-n, n)


def self_interaction(nxyz, eps: float = 1e-5,
                     rng: np.random.Generator | None = None, device="cuda"):
    """Interaction between a random half-split of a cloud (reference
    field_utils.py:163-171)."""
    nxyz = np.asarray(nxyz)
    assert nxyz.shape[1] == 6
    rng = rng or np.random.default_rng()
    num = nxyz.shape[0]
    mask = np.ones(num, dtype=bool)
    mask[rng.permutation(num)[: num // 2]] = False
    w, _ = field_edge_calculator(nxyz[mask], nxyz[~mask], device=device)
    return w


def self_interaction_all(nxyz, eps: float = 1e-5, device="cuda"):
    w, _ = field_edge_calculator(nxyz, nxyz, device=device)
    return w


def random_self_interaction(nxyz, eps: float = 1e-5,
                            rng: np.random.Generator | None = None,
                            device="cuda"):
    nxyz = np.asarray(nxyz).copy()
    assert nxyz.shape[1] == 6
    rng = rng or np.random.default_rng()
    flip = np.zeros(nxyz.shape[0], dtype=bool)
    flip[rng.permutation(nxyz.shape[0])[: nxyz.shape[0] // 2]] = True
    nxyz[flip, 3:] *= -1
    w, _ = field_edge_calculator(nxyz, nxyz, device=device)
    return w


def xie_distance(sources, targets, device="cuda") -> torch.Tensor:
    """Per-target sum over sources of |n_s elementwise* R| (reference
    field_utils.py:522-526), tiled over targets."""
    dev = resolve_device(device)
    src = as_f32(sources, dev)
    tgt = as_f32(targets, dev)
    out = []
    for b in range(0, tgt.shape[0], _PLAIN_BLOCK_T):
        R = src[None, :, :3] - tgt[b:b + _PLAIN_BLOCK_T, None, :3]
        out.append(torch.linalg.norm(src[None, :, 3:6] * R, dim=-1).sum(dim=-1))
    return torch.cat(out) if out else torch.zeros(0, device=dev)
