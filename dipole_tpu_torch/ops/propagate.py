"""Strongest-field greedy propagation, per point and per patch — the port
of dipole_tpu/ops/propagate.py:61-209, :299-315 and :322-502.

Every propagation variant is linear in each source's sign, so the greedy
runs over an interaction accumulator: visiting point c adds s_c * I[:, c].
Two tiers, with the JAX package's boundary:
  * N <= matrix_limit (MATRIX_LIMIT = 10000): precompute I
    (fields.dipole_interaction_matrix) and read row c each step — I[c]
    stands in for the column by symmetry, exactly as the JAX scan does;
  * above it: compute column c on the fly each step
    (propagate.py:_dipole_column).
Both tiers run exactly N-1 steps. On a CPU tensor the plain torch loops below
run, at any size, as the JAX package's XLA scan does; on a CUDA tensor the
kernel of ops/propagate_cuda.py runs, or the call raises. Only the kernel has
a ceiling: its candidate key holds 2^24 point indices, and its wrappers
refuse a larger cloud (the JAX package's Pallas chain stops at the same
2^24).

Decisions replicate the JAX package: ties go to the lowest index
(torch.argmax returns the first maximum), a step flips when acc < 0, and the
diffuse re-vote keeps a sign iff acc * sign > 0.

Patch propagation (strongest_field_propagation_patches / _reps) runs the
same greedy over patches: the pair work is the group interaction F[i, q]
(fields.point_group_interaction, csrc/group.cu on the card), the patch-patch
weights W = F summed over each patch's targets, and the P-step greedy over W
runs on the host in float64 as in the JAX package.

The mirror-field ("xie") family (JAX propagate.py:509-857) runs over the xie
matrix (fields.xie_interaction_matrix): the sequential loop over the
transposed matrix (csrc/greedy.cu's xie mode), the in-order replay of T
orders in lock-step over the matrix's rows (csrc/replay.cu), and the
BFS-tree voting that draws the orders on the host and aligns the replayed
runs exactly (ops/solve.py). Every path holds one N x N array: exactly N
rows and columns (the JAX bucket padding is a TPU artefact), the kNN mask
in (N, k) index form, points_weight applied on the fly.

The batched forms behind the server's micro-batching (JAX
propagate.py:213-296, :861-922) take B independent clouds:
greedy_sign_sequence_batched runs every lane's on-the-fly column greedy,
whatever its size, as the JAX package's vmapped scan does (never the matrix
tier); orient_clouds_batched adds the diffuse re-vote and the sign fix
(a lone cloud takes the tiered greedy_sign_sequence); xie_in_order_batched
replays every cloud's orders over its own exact N_b x N_b matrix. On the
card each is one batched launch (csrc/greedy.cu's and csrc/replay.cu's
batched entries), on the CPU a plain loop a lane; the JAX package's
power-of-two batch and bucket padding only limited XLA compiles, and the
port has none.

Under a mesh (parallel/sharding.py) the patch propagations shard the group
interaction's target rows and the rest-point field pass, and the order
replay column-shards its matrix (without a kNN mask or weights).
"""
from __future__ import annotations

import numpy as np
import torch

from dipole_tpu_torch import graphs, native
from dipole_tpu_torch.device import as_f32, resolve_device
from dipole_tpu_torch.ops import _build, fields, propagate_cuda, solve

__all__ = ["greedy_sign_sequence", "greedy_sign_sequence_batched",
           "orient_clouds_batched", "xie_in_order_batched",
           "strongest_field_propagation_points",
           "strongest_field_propagation_patches",
           "strongest_field_propagation_reps",
           "xie_propagation_points", "xie_propagation_points_plus",
           "xie_propagation_in_order", "xie_propagation_bfs_tree",
           "bfs_orders", "align_and_vote",
           "greedy_rows_plain", "greedy_columns_plain", "xie_greedy_plain",
           "replay_plain", "dipole_column",
           "MATRIX_LIMIT", "PLAIN_CUDA_CALLS"]

MATRIX_LIMIT = 10000

PLAIN_CUDA_CALLS = {"greedy_rows": 0, "greedy_columns": 0, "greedy_xie": 0,
                    "replay": 0}


def dipole_column(pts: torch.Tensor, c, eps: float) -> torch.Tensor:
    """I[:, c]: interaction of source point c at every point (N,)."""
    src = pts[c]
    sx, sy, sz, spx, spy, spz = (src[..., k] for k in range(6))
    x, y, z, nx, ny, nz = (pts[:, k] for k in range(6))
    Rx = sx - x
    Ry = sy - y
    Rz = sz - z
    r2 = Rx * Rx + Ry * Ry + Rz * Rz
    zero = r2 == 0.0
    r = fields.sqrt_rn(r2)
    denom = r * r2 + eps
    cdot = Rx * spx + Ry * spy + Rz * spz
    Rn = Rx * nx + Ry * ny + Rz * nz
    pn = nx * spx + ny * spy + nz * spz
    safe_r2 = torch.where(zero, torch.ones_like(r2), r2)
    col = -(3.0 * cdot * Rn / (safe_r2 * denom) - pn / denom)
    return torch.where(zero | ~torch.isfinite(col), torch.zeros_like(col), col)


def _greedy_plain(n: int, start: int, column, device):
    """The greedy loop over `column(c)` vectors. c stays a device tensor
    (no host sync per step)."""
    acc = column(torch.tensor(start, device=device))
    sign = torch.zeros(n, dtype=torch.float32, device=device)
    sign[start] = 1.0
    visited = torch.zeros(n, dtype=torch.bool, device=device)
    visited[start] = True
    neg_inf = torch.tensor(-float("inf"), device=device)
    one = torch.tensor(1.0, device=device)
    for _ in range(n - 1):
        masked = torch.where(visited, neg_inf, torch.abs(acc))
        c = torch.argmax(masked)
        s = torch.where(acc[c] < 0, -one, one)
        sign[c] = s
        visited[c] = True
        acc = acc + s * column(c)
    return acc, sign


def greedy_rows_plain(I: torch.Tensor, start: int):
    """Plain torch version of the row-mode greedy kernel."""
    if I.is_cuda:
        _build.bump(PLAIN_CUDA_CALLS, "greedy_rows")
    return _greedy_plain(I.shape[0], start, lambda c: I[c], I.device)


def greedy_columns_plain(pts: torch.Tensor, start: int, eps: float):
    """Plain torch version of the column-mode greedy kernel."""
    if pts.is_cuda:
        _build.bump(PLAIN_CUDA_CALLS, "greedy_columns")
    return _greedy_plain(pts.shape[0], start,
                         lambda c: dipole_column(pts, c, eps), pts.device)


def greedy_sign_sequence(pts, starting_point: int = 0, eps: float = 1e-6,
                         matrix_limit: int | None = None, device="cuda"):
    """Run the strongest-field greedy ordering; returns (acc, sign) tensors
    on `device`: sign is the +-1 flip state per point and acc the final
    accumulated interaction (E . n_orig). The CPU loops run at any size; on
    the card the kernel refuses more than 2^24 points
    (propagate_cuda.MAX_POINTS)."""
    dev = resolve_device(device)
    pts = as_f32(pts, dev)[:, :6].contiguous()
    n = pts.shape[0]
    if n <= 1:
        return (torch.zeros(n, dtype=torch.float32, device=dev),
                torch.ones(n, dtype=torch.float32, device=dev))
    if not 0 <= starting_point < n:
        raise ValueError(f"starting point {starting_point} outside [0, {n})")
    limit = MATRIX_LIMIT if matrix_limit is None else matrix_limit
    if n <= limit:
        I = fields.dipole_interaction_matrix(pts, eps=eps)
        if dev.type == "cpu":
            return greedy_rows_plain(I, starting_point)
        return propagate_cuda.greedy_rows(I, starting_point)
    if dev.type == "cpu":
        return greedy_columns_plain(pts, starting_point, eps)
    return propagate_cuda.greedy_columns(pts, starting_point, eps)


def greedy_sign_sequence_batched(pts_list, starting_points=None,
                                 eps: float = 1e-6, device="cuda"):
    """The greedy ordering of SEVERAL independent clouds, the server's
    micro-batching core (JAX propagate.py:219-265): every lane runs the
    on-the-fly column greedy, whatever its size (the JAX package's vmapped
    scan), in one batched launch on the card (csrc/greedy.cu; a lane's state
    stays in registers, so the card refuses a cloud above the SMs x 8192
    points) or greedy_columns_plain a lane on the CPU. Each lane equals
    greedy_sign_sequence(..., matrix_limit=0) on its cloud alone, bit for
    bit. Returns a list of (acc, sign) float32 numpy arrays."""
    dev = resolve_device(device)
    pts = [as_f32(p, dev)[:, :6].contiguous() for p in pts_list]
    starts = [0] * len(pts) if starting_points is None else list(starting_points)
    if len(starts) != len(pts):
        raise ValueError(f"{len(pts)} clouds but {len(starts)} starting points")
    for b, (p, s0) in enumerate(zip(pts, starts)):
        if len(p) > 1 and not 0 <= s0 < len(p):
            raise ValueError(f"cloud {b}: starting point {s0} outside [0, {len(p)})")
    run = [b for b, p in enumerate(pts) if len(p) > 1]
    if dev.type == "cpu":
        lanes = [greedy_columns_plain(pts[b], starts[b], eps) for b in run]
    else:
        lanes = propagate_cuda.greedy_columns_batched(
            [pts[b] for b in run], [starts[b] for b in run], eps)
    out = [(np.zeros(len(p), np.float32), np.ones(len(p), np.float32)) for p in pts]
    for b, (acc, sign) in zip(run, lanes):
        out[b] = (acc.cpu().numpy(), sign.cpu().numpy())
    return out


def orient_clouds_batched(pcs, diffuse: bool = False, device="cuda") -> list:
    """Greedy-orient SEVERAL normalized (N_b, 6) clouds (JAX
    propagate.py:268-296): the batched greedy ordering (a lone cloud takes
    the tiered greedy_sign_sequence), the optional diffuse re-vote, and the
    lattice sign fix of every cloud (fields.measure_mean_potential_batched).
    The shared core of the server's simple_estimate micro-batch and
    api.orient_simple_batch. Returns new oriented arrays, still normalized."""
    dev = resolve_device(device)
    pcs = [np.asarray(p, np.float32) for p in pcs]
    if not pcs:
        return []
    if len(pcs) == 1:
        acc, sign = greedy_sign_sequence(pcs[0], device=dev)
        results = [(acc.cpu().numpy(), sign.cpu().numpy())]
    else:
        results = greedy_sign_sequence_batched(pcs, device=dev)
    out = []
    for pc, (acc, sign) in zip(pcs, results):
        if diffuse:
            vote = np.where(acc * sign > 0, 1.0, -1.0).astype(np.float32)
            sign = sign * vote
        o = pc.copy()
        o[:, 3:6] *= sign[:, None]
        out.append(o)
    means = fields.measure_mean_potential_batched(out, device=dev)
    for o, m in zip(out, means):
        if m < 0:
            o[:, 3:6] *= -1
    return out


def strongest_field_propagation_points(pts, diffuse: bool = False,
                                       starting_point: int = 0,
                                       eps: float = 1e-6,
                                       device="cuda") -> np.ndarray:
    """Per-point strongest-field propagation (reference
    field_utils.py:353-388). Returns a new oriented (N, 6) numpy array."""
    pts = np.asarray(pts, dtype=np.float32)
    acc, sign = greedy_sign_sequence(pts, starting_point, eps, device=device)
    acc = acc.cpu().numpy()
    sign = sign.cpu().numpy()
    if diffuse:
        # interactions against current normals: acc_i * sign_i; keep if > 0
        vote = np.where(acc * sign > 0, 1.0, -1.0).astype(np.float32)
        sign = sign * vote
    out = pts.copy()
    out[:, 3:6] *= sign[:, None]
    return out


# ---------------------------------------------------------------------------
# Patch-level greedy propagation
# ---------------------------------------------------------------------------

def _greedy_patch_signs(W: np.ndarray, start: int) -> np.ndarray:
    """Host-side greedy loop over the patch-patch weight matrix (P is small),
    in float64 (JAX propagate.py:322-337)."""
    P = W.shape[0]
    sign = np.zeros(P, dtype=np.float64)
    visited = np.zeros(P, dtype=bool)
    sign[start] = 1.0
    visited[start] = True
    acc = W[:, start].astype(np.float64).copy()
    for _ in range(P - 1):
        masked = np.where(visited, -np.inf, np.abs(acc))
        c = int(masked.argmax())
        s = -1.0 if acc[c] < 0 else 1.0
        sign[c] = s
        visited[c] = True
        acc += s * W[:, c]
    return sign.astype(np.float32)


def _flattest_patch(pts: np.ndarray, patch_list) -> int:
    """Seed = patch with the smallest |lambda_0| (PCA), reference
    field_utils.py:303-306."""
    e0 = []
    for idx in patch_list:
        x = pts[np.asarray(idx), :3].astype(np.float64)
        x = x - x.mean(axis=0)
        cov = x.T @ x / x.shape[0]
        w = np.linalg.eigvalsh(cov)
        e0.append(abs(w[0]))
    return int(np.argmin(e0))


def _patch_fields(work: np.ndarray, seg: np.ndarray, P: int, dev, mesh=None):
    """(F, W, seg tensor): the group interaction F[i, q] of the weighted
    points (N, 6) on `dev`, and the patch-patch weights W[p, q] = sum of
    F[i, q] over the points i of patch p (a one-hot product, the same sum on
    every run) as a float64 host array. With a mesh, F's target rows are
    sharded over it (parallel.sharding.point_group_interaction_sharded,
    bit-equal to the one-device F; JAX propagate.py:353-361)."""
    seg_t = torch.as_tensor(seg, dtype=torch.int64, device=dev)
    if mesh is not None:
        from dipole_tpu_torch.parallel.sharding import point_group_interaction_sharded

        F = torch.as_tensor(point_group_interaction_sharded(work, seg, P, mesh,
                                                            eps=1e-5), device=dev)
    else:
        F = fields.point_group_interaction(as_f32(work, dev), seg_t, P, eps=1e-5)
    onehot = torch.zeros((len(seg), P), dtype=torch.float32, device=dev)
    onehot[torch.arange(len(seg), device=dev), seg_t] = 1.0
    W = (onehot.t() @ F).cpu().numpy()
    return F, W, seg_t


def _diffuse_acc(F: torch.Tensor, seg_t: torch.Tensor, sign: np.ndarray):
    """Accumulated E.n per point from every other patch, under the patch
    signs: F @ sign minus the own-patch column (the reference's diffuse
    spreading skips the emitting patch, field_utils.py:256-261, 326-331)."""
    sign_t = torch.as_tensor(sign, dtype=torch.float32, device=F.device)
    own = F[torch.arange(F.shape[0], device=F.device), seg_t]
    return (F @ sign_t - own * sign_t[seg_t]).cpu().numpy()


def _stage(mesh, stage: str, n: int, dev):
    """The mesh a propagation stage runs on: a Mesh, a count or 'auto' as
    api.resolve_mesh takes them, then api.stage_mesh's decision."""
    from dipole_tpu_torch.api import resolve_mesh, stage_mesh

    return stage_mesh(resolve_mesh(mesh, dev), stage, n)


def strongest_field_propagation_patches(pts, filtered_patches, all_patches,
                                        diffuse: bool = False, weights=None,
                                        mesh=None, device="cuda") -> np.ndarray:
    """Patch-level greedy propagation (reference field_utils.py:286-348, JAX
    propagate.py:365-422). pts (N, 6); all_patches: index arrays covering
    every point; filtered_patches: (patch_id, index array) pairs whose points
    get the diffuse per-point re-vote; weights: optional per-point confidence,
    clamped to [0.1, 1], scaling the normals during propagation
    (weighted_prop). mesh: the pair work behind F splits its target rows
    over the mesh's devices (identical results). Returns a new oriented
    (N, 6) numpy array."""
    dev = resolve_device(device)
    pts = np.asarray(pts, dtype=np.float32)
    n = pts.shape[0]
    P = len(all_patches)
    if P == 0:
        return pts.copy()
    mesh = _stage(mesh, "patch", n, dev)
    seg = np.zeros(n, dtype=np.int32)
    for p, idx in enumerate(all_patches):
        seg[np.asarray(idx)] = p
    work = pts.copy()
    if weights is not None:
        work[:, 3:6] *= np.clip(np.asarray(weights, np.float32), 0.1, 1.0)[:, None]

    F, W, seg_t = _patch_fields(work, seg, P, dev, mesh)
    sign = _greedy_patch_signs(W, _flattest_patch(pts, all_patches))

    total = sign[seg].copy()                             # per-point sign
    if diffuse:
        acc = _diffuse_acc(F, seg_t, sign)
        for _, idx in filtered_patches:
            idx = np.asarray(idx)
            vote = np.where(acc[idx] * total[idx] > 0, 1.0, -1.0).astype(np.float32)
            total[idx] = total[idx] * vote

    out = pts.copy()
    out[:, 3:6] *= total[:, None]
    return out


def strongest_field_propagation_reps(pts, reps, diffuse: bool = False,
                                     weights=None, mesh=None,
                                     device="cuda") -> np.ndarray:
    """Representative-point propagation for large clouds (reference
    field_utils.py:207-282, JAX propagate.py:425-502): the greedy runs on
    the representatives of each patch (reps: (rep index array, rest index
    array) per patch); rest points inherit their patch's sign, then each is
    re-voted by the field of all oriented representatives (fields.field_grad,
    csrc/field.cu on the card). mesh: F's target rows and the rest points'
    field pass shard over the mesh's devices (JAX propagate.py:425-502)."""
    dev = resolve_device(device)
    pts = np.asarray(pts, dtype=np.float32)
    n = pts.shape[0]
    P = len(reps)
    if P == 0:
        return pts.copy()
    mesh = _stage(mesh, "patch", n, dev)
    work = pts.copy()
    if weights is not None:
        work[:, 3:6] *= np.clip(np.asarray(weights, np.float32), 0.1, 1.0)[:, None]

    rep_concat = np.concatenate([np.asarray(r) for r, _ in reps])
    rep_seg = np.concatenate(
        [np.full(len(np.asarray(r)), p, np.int32) for p, (r, _) in enumerate(reps)])
    F, W, seg_t = _patch_fields(work[rep_concat], rep_seg, P, dev, mesh)
    sign_patch = _greedy_patch_signs(
        W, _flattest_patch(work, [np.asarray(r) for r, _ in reps]))

    total = np.ones(n, dtype=np.float32)
    for p, (rep, rest) in enumerate(reps):
        total[np.asarray(rep)] = sign_patch[p]
        rest = np.asarray(rest)
        if rest.size:
            total[rest] = sign_patch[p]

    if diffuse:
        acc = _diffuse_acc(F, seg_t, sign_patch)
        cur = total[rep_concat]
        vote = np.where(acc * cur > 0, 1.0, -1.0).astype(np.float32)
        total[rep_concat] = cur * vote
    del F

    # orient every non-rep point by the field of the oriented reps
    # (reference field_utils.py:273-276)
    rest_concat = np.concatenate(
        [np.asarray(rest) for _, rest in reps if len(np.asarray(rest))]
        or [np.zeros(0, np.int64)]).astype(np.int64)
    if rest_concat.size:
        srcs = work[rep_concat].copy()
        srcs[:, 3:6] *= total[rep_concat][:, None]
        if mesh is not None:
            from dipole_tpu_torch.parallel.sharding import field_grad_sharded

            E = field_grad_sharded(srcs, work[rest_concat, :3], mesh, shard="targets")
        else:
            E = fields.field_grad(as_f32(srcs, dev),
                                  as_f32(work[rest_concat, :3], dev)).cpu().numpy()
        cur_n = work[rest_concat, 3:6] * total[rest_concat][:, None]
        inter = (E * cur_n).sum(-1)
        vote = np.where(inter > 0, 1.0, -1.0).astype(np.float32)
        total[rest_concat] = total[rest_concat] * vote

    out = pts.copy()
    out[:, 3:6] *= total[:, None]
    return out


# ---------------------------------------------------------------------------
# Xie (mirror-field) propagation
# ---------------------------------------------------------------------------

def _knn_idx(pts: np.ndarray, k: int) -> np.ndarray:
    """(N, min(N, k)) int64: row j holds source j's k nearest targets, self
    included (the native host KD-tree)."""
    idx, _ = native.knn(pts[:, :3], pts[:, :3], min(len(pts), k))
    return idx


def _build_knn_mask(pts: np.ndarray, k: int) -> np.ndarray:
    """Dense (N, N) mask: pair (i, j) kept iff target i is among source j's
    k nearest targets (reference field_utils.py:449-458; JAX
    propagate.py:635-646). The propagation loops take the index form."""
    n = len(pts)
    idx = _knn_idx(np.asarray(pts, np.float32), k)
    mask = np.zeros((n, n), dtype=np.float32)
    mask[idx.reshape(-1), np.repeat(np.arange(n), idx.shape[1])] = 1.0
    return mask


def xie_greedy_plain(IT: torch.Tensor, start: int, knn_idx=None):
    """Plain torch version of the xie mode of csrc/greedy.cu: the XLA scan
    propagate.py:_xie_greedy_scan step for step over the transposed xie
    matrix IT (row c = column c of I), N - 1 steps."""
    if IT.is_cuda:
        _build.bump(PLAIN_CUDA_CALLS, "greedy_xie")
    n, dev = IT.shape[0], IT.device

    def col(c):
        column = IT.index_select(0, c.view(1))[0]
        if knn_idx is not None:
            m = torch.zeros(n, dtype=torch.float32, device=dev)
            m[knn_idx.index_select(0, c.view(1))[0]] = 1.0
            column = column * m
        return column

    acc = torch.zeros(n, dtype=torch.float32, device=dev)
    rate = col(torch.tensor(start, device=dev))
    sign = torch.zeros(n, dtype=torch.float32, device=dev)
    sign[start] = 1.0
    visited = torch.zeros(n, dtype=torch.bool, device=dev)
    visited[start] = True
    neg_inf = torch.tensor(-float("inf"), device=dev)
    one = torch.tensor(1.0, device=dev)
    for _ in range(n - 1):
        acc = acc + rate
        c = torch.argmax(torch.where(visited, neg_inf, acc))
        s = torch.where(acc[c] < 0, -one, one)
        sign[c] = s
        visited[c] = True
        rate = rate + s * col(c)
    return acc, sign


def _xie_greedy(IT: torch.Tensor, start: int, knn_idx):
    if IT.device.type == "cpu":
        return xie_greedy_plain(IT, start, knn_idx)
    return propagate_cuda.xie_greedy(IT, start, knn_idx)


def _masked_inter(IT: torch.Tensor, knn_idx: torch.Tensor,
                  wq: torch.Tensor) -> torch.Tensor:
    """inter[t, i] = sum over sources j with i in knn_idx[j] of
    I[i, j] wq[t, j] (float64), from the transposed matrix IT[j, i]: the
    mask's N k pairs only, no dense mask (JAX propagate.py:612-625, 690-702).
    The products are float32 as in the JAX package; the sums are float64,
    so their order (index_add_'s atomics on the card) moves no decision."""
    n, k = knn_idx.shape
    jj = torch.arange(n, device=IT.device).repeat_interleave(k)
    ii = knn_idx.reshape(-1)
    ok = (ii >= 0) & (ii < n)
    jj, ii = jj[ok], ii[ok]
    vals = (IT[jj, ii][None, :] * wq[:, jj]).double()
    out = torch.zeros((wq.shape[0], n), dtype=torch.float64, device=IT.device)
    return out.index_add_(1, ii, vals)


def xie_propagation_points(pts, eps: float = 1e-2, diffuse: bool = False,
                           starting_point: int = 0, C: float = 3.0,
                           knn_mask: int = -1, device="cuda") -> np.ndarray:
    """Sequential mirror-field propagation (reference field_utils.py:536-563,
    JAX propagate.py:558-609). Returns a new oriented (N, 6) numpy array.

    knn_mask > 0 keeps pair (i, j) iff i is among j's knn_mask nearest
    targets, in (N, k) index form (no dense mask). eps is accepted and
    ignored, as in the JAX package. diffuse re-votes every point by the
    interaction of the whole signed cloud with it (I @ sign; float32 matmul,
    TF32 off; the masked form sums the mask's pairs in float64)."""
    dev = resolve_device(device)
    pts = np.asarray(pts, dtype=np.float32)
    n = len(pts)
    if n <= 1:
        return pts.copy()
    if not 0 <= starting_point < n:
        raise ValueError(f"starting point {starting_point} outside [0, {n})")
    knn_idx = None
    if knn_mask > 0:
        knn_idx = torch.as_tensor(_knn_idx(pts, knn_mask), device=dev)
    IT = fields.xie_interaction_matrix(as_f32(pts, dev), C=C, transposed=True)
    _, sign_t = _xie_greedy(IT, starting_point, knn_idx)
    sign = sign_t.cpu().numpy()
    if diffuse:
        # inter_i = sum_j I[i, j] sign_j = (sign @ I^T)_i, the whole
        # (current) cloud's interaction with i, self included
        if knn_idx is None:
            inter = (sign_t @ IT).cpu().numpy().astype(np.float64)
        else:
            inter = _masked_inter(IT, knn_idx, sign_t[None, :])[0].cpu().numpy()
        vote = np.where(inter * sign > 0, 1.0, -1.0).astype(np.float32)
        sign = sign * vote
    del IT
    out = pts.copy()
    out[:, 3:6] *= sign[:, None]
    return out


def xie_propagation_points_plus(pts, eps: float = 1e-2, diffuse: bool = False,
                                starting_point: int = 0,
                                device="cuda") -> np.ndarray:
    """Dipole pass then xie pass (reference field_utils.py:532-534)."""
    pts = strongest_field_propagation_points(pts, starting_point=starting_point,
                                             device=device)
    return xie_propagation_points(pts, eps, diffuse,
                                  starting_point=starting_point, device=device)


def replay_plain(I: torch.Tensor, orders: torch.Tensor, knn_idx=None, colw=None):
    """Plain torch version of csrc/replay.cu: the XLA scan
    propagate.py:_in_order_scan step for step (the kNN mask rebuilt from its
    index form each step), its row sums in float64. Returns (w (T, N)
    float32, inter (T, N) float64)."""
    if I.is_cuda:
        _build.bump(PLAIN_CUDA_CALLS, "replay")
    T, steps = orders.shape
    n, dev = I.shape[0], I.device
    w = torch.zeros((T, n), dtype=torch.float32, device=dev)
    inter = torch.zeros((T, n), dtype=torch.float64, device=dev)
    rg = torch.arange(T, device=dev)
    one = torch.tensor(1.0, device=dev)
    for k in range(steps):
        idx = orders[:, k]
        rows = I.index_select(0, idx)
        if knn_idx is not None:
            hit = (knn_idx[None, :, :] == idx[:, None, None]).any(dim=-1)
            rows = rows * hit.to(torch.float32)
        if colw is not None:
            rows = rows * colw[None, :]
        it = (rows.double() * w.double()).sum(dim=1)
        w[rg, idx] = torch.where(it < 0, -one, one)
        inter[rg, idx] = it
    return w, inter


def _replay(I, orders, knn_idx, colw):
    if I.device.type == "cpu":
        return replay_plain(I, orders, knn_idx, colw)
    return propagate_cuda.replay(I, orders, knn_idx, colw)


def xie_propagation_in_order(pts, orders, eps: float = 1e-2,
                             diffuse: bool = False, C: float = 3.0,
                             knn_mask: int = -1, points_weight=None,
                             kernel: str = "xie", mesh=None,
                             device="cuda") -> np.ndarray:
    """Order-driven batch replay (reference field_utils.py:569-605, JAX
    propagate.py:706-766): T orders (T, S) advanced in lock-step against one
    interaction matrix. Returns the (T, N) bool flip mask.

    kernel="xie" is the fork's mirror field; kernel="dipole" the paper's
    dipole interaction, whose matrix takes eps = 1e-6 whatever `eps` says,
    as in the JAX package (propagate.py:754, 759); the xie replay ignores
    eps. points_weight scales each source column (the reference's declared
    intent). knn_mask > 0 keeps pair (i, j) iff i is among j's nearest, in
    index form. diffuse re-votes every point by all recorded weights:
    wq @ I^T (float32 matmul, TF32 off), or the mask's pairs in float64.
    mesh: without a kNN mask and without weights, the matrix is
    column-sharded over the mesh's devices
    (parallel.sharding.xie_in_order_sharded; JAX propagate.py:795-799); the
    masked and weighted variants stay on one device, as in the JAX
    package."""
    dev = resolve_device(device)
    if kernel not in ("xie", "dipole"):
        raise ValueError(f"unknown kernel {kernel!r}")
    pts = np.asarray(pts, dtype=np.float32)
    orders = _check_orders(orders, len(pts))
    mesh = _stage(mesh, "replay", len(pts), dev)
    if mesh is not None and knn_mask <= 0 and points_weight is None:
        from dipole_tpu_torch.parallel.sharding import xie_in_order_sharded

        return xie_in_order_sharded(pts, orders, mesh, C=C, eps=eps,
                                    diffuse=diffuse, kernel=kernel)
    knn_idx = colw = None
    if knn_mask > 0:
        knn_idx = torch.as_tensor(_knn_idx(pts, knn_mask), device=dev)
    if points_weight is not None:
        colw = as_f32(points_weight, dev).contiguous()
    pts_t = as_f32(pts, dev)
    if kernel == "xie":
        I = fields.xie_interaction_matrix(pts_t, C=C)
    else:
        I = fields.dipole_interaction_matrix(pts_t, eps=1e-6)
    w, inter = _replay(I, torch.as_tensor(orders, device=dev), knn_idx, colw)
    if diffuse:
        wq = w if colw is None else w * colw[None, :]
        if knn_idx is None:
            inter = wq @ I.t()
        else:
            inter = _masked_inter(I.t(), knn_idx, wq)
    del I
    return (inter < 0).cpu().numpy()


def _check_orders(orders, n: int) -> np.ndarray:
    orders = np.asarray(orders, dtype=np.int64)
    if orders.ndim != 2 or orders.shape[1] > n or (
            orders.size and (orders.min() < 0 or orders.max() >= n)):
        raise ValueError(f"orders: expected (T, <= {n}) indices in [0, {n})")
    return orders


def xie_in_order_batched(pts_list, orders_list, diffuse: bool = False,
                         C: float = 3.0, kernel: str = "xie",
                         device="cuda") -> list:
    """Replay SEVERAL independent clouds' order sets (JAX
    propagate.py:873-922), the server's tree-xie micro-batching core: each
    cloud's exact N_b x N_b matrix (xie, or the dipole matrix at eps 1e-6;
    no padded stack), then every lane's orders in one batched replay on the
    card (csrc/replay.cu) or replay_plain a cloud on the CPU, and the
    diffuse re-vote per cloud. Each cloud's flips equal
    xie_propagation_in_order's on it alone. All B matrices are held at once:
    callers keep sum N_b^2 inside a budget (serve/batching.py). Returns a
    list of (T_b, N_b) bool flip masks."""
    dev = resolve_device(device)
    if kernel not in ("xie", "dipole"):
        raise ValueError(f"unknown kernel {kernel!r}")
    if len(pts_list) != len(orders_list):
        raise ValueError(f"{len(pts_list)} clouds but {len(orders_list)} order sets")
    mats, orders = [], []
    for p, o in zip(pts_list, orders_list):
        p = np.asarray(p, dtype=np.float32)
        orders.append(torch.as_tensor(_check_orders(o, len(p)), device=dev))
        pt = as_f32(p, dev)
        mats.append(fields.xie_interaction_matrix(pt, C=C) if kernel == "xie"
                    else fields.dipole_interaction_matrix(pt, eps=1e-6))
    if dev.type == "cpu":
        lanes = [replay_plain(I, o) for I, o in zip(mats, orders)]
    else:
        lanes = propagate_cuda.replay_batched(mats, orders)
    out = []
    for b, (w, inter) in enumerate(lanes):
        if diffuse:
            inter = w @ mats[b].t()
        mats[b] = None
        out.append((inter < 0).cpu().numpy())
    return out


def xie_propagation_bfs_tree(pts, eps: float = 1e-2, diffuse: bool = False,
                             starting_point: int = 0, k: int = 10,
                             threshold: float = 0.1, times: int = 1,
                             use_pw: bool = False, knn_mask: int = -1,
                             C: float = 3.0, kernel: str = "xie",
                             mesh=None, device="cuda"):
    """Multi-start BFS-tree propagation with vote alignment (reference
    field_utils.py:657-710, JAX propagate.py:769-807): `times` BFS orders
    from a thresholded kNN graph, replayed in lock-step, the runs aligned by
    solving the binary pairwise XOR problem exactly (replacing Gurobi), the
    flips majority-voted. mesh: the replay's (xie_propagation_in_order's),
    sharded without a kNN mask and without weights only. Returns
    (oriented_pts, flip_mask)."""
    if times <= 0 or times % 2 != 1:
        raise ValueError("times must be a positive odd number")
    pts = np.asarray(pts, dtype=np.float32)
    orders, points_weight = bfs_orders(pts, starting_point, k=k,
                                       threshold=threshold, times=times,
                                       use_pw=use_pw)
    flips = xie_propagation_in_order(
        pts, orders, eps=eps, diffuse=diffuse, C=C, knn_mask=knn_mask,
        points_weight=points_weight, kernel=kernel, mesh=mesh, device=device).T
    return align_and_vote(pts, flips)


def bfs_orders(pts, starting_point: int = 0, k: int = 10,
               threshold: float = 0.1, times: int = 1, use_pw: bool = False):
    """The host half of the BFS-tree pipeline (JAX propagate.py:810-837):
    thresholded kNN graph + `times` BFS orders from the reference's seeded
    random starts (field_utils.py:661-687). Returns (orders (T, N),
    points_weight or None)."""
    pts = np.asarray(pts, dtype=np.float32)
    n = len(pts)
    rs = np.random.RandomState(0)
    starting_points = [starting_point]
    while len(np.unique(starting_points)) < times:
        t = rs.randint(0, n)
        if t not in starting_points:
            starting_points.append(t)

    G, mean_k_dist = graphs.emst_from_pc(pts[:, :3], k, threshold)
    points_weight = mean_k_dist if use_pw else None
    orders = np.zeros((times, n), dtype=np.int32)
    for i in range(times):
        orders[i] = G.get_bfs_route(starting_points[i])
    return orders, points_weight


def align_and_vote(pts, flips):
    """Align the T replayed runs (exact binary enumeration of the pairwise
    XOR objective, replacing Gurobi) and majority-vote the flips (reference
    field_utils.py:696-709, JAX propagate.py:840-857). flips: (N, T).
    Returns (oriented, flip_mask)."""
    pts = np.asarray(pts, np.float32)
    n, times = flips.shape
    fl = flips.astype(np.int64)
    disagree = (fl[:, :, None] != fl[:, None, :]).sum(axis=0)
    A = disagree.astype(np.float64)
    B = (n - disagree).astype(np.float64)
    status = solve.miqp_min(A, B).astype(bool)
    aligned = flips ^ status[None, :]
    flip_mask = aligned.sum(axis=1) > times / 2
    out = pts.copy()
    out[flip_mask, 3:6] *= -1
    return out, flip_mask
