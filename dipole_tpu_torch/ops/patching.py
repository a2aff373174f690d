"""Voxel-grid patch partitioning, small-patch merging and the curvature
filter — the port's own copy of dipole_tpu/ops/patching.py:22-147 (host
numpy; the port imports nothing of dipole_tpu).

Reference semantics (util.py voxel patching): divide_pc (:338-341 +
_divide_pc :110-150 / _lzd_divide_pc :86-108), merge_nodes (:448-492) and
inference_utils.fix_n_filter (:52-71). divide_pc keeps the upstream
contract: divide into voxels, merge sub-minimum patches into grid
neighbours, return flat index arrays."""
from __future__ import annotations

import numpy as np

__all__ = ["voxel_indices", "divide_pc", "merge_small_patches", "fix_n_filter",
           "segment_ids_from_patches"]


def voxel_indices(pc: np.ndarray, n_part: int, ranges=(-1.5, 1.5)):
    """Bin points into an n_part^3 grid over `ranges`.

    Returns (patches, ijk): lists of per-patch point-index arrays and their
    integer grid coordinates, for occupied voxels only, ordered by flat
    voxel id (matches the fork's searchsorted binning, util.py:86-108)."""
    pc = np.asarray(pc)
    xyz = pc[:, :3]
    edges = np.linspace(ranges[0], ranges[1], n_part + 1)
    coord = np.stack(
        [np.searchsorted(edges, xyz[:, a], side="right") - 1 for a in range(3)],
        axis=1,
    )
    # lexicographic (x, y, z) voxel order — the upstream triple-loop's scan
    # order (util.py:136-149), which the merge pass depends on
    flat = (coord[:, 0] * (n_part + 1) + coord[:, 1]) * (n_part + 1) + coord[:, 2]
    order = np.argsort(flat, kind="stable")
    sorted_flat = flat[order]
    uniq, starts = np.unique(sorted_flat, return_index=True)
    patches = np.split(order, starts[1:])
    ijk = [coord[p[0]] for p in patches]
    return patches, ijk


def merge_small_patches(patches, ijk, min_patch: int, max_rounds: int = 10):
    """Merge patches with fewer than min_patch points into a grid-adjacent
    patch, matching upstream merge_nodes semantics exactly (reference
    util.py:448-492): the absorber is the *last* patch (in voxel scan order)
    with any cell pair within Chebyshev distance 1; up to 10 rounds; patches
    still below min_patch at the end are dropped.

    Returns (patches, ijk_groups) where ijk_groups[i] is the list of grid
    cells merged into patch i."""
    patches = [np.asarray(p) for p in patches]
    groups = [[np.asarray(c)] for c in ijk]
    P = len(patches)

    def find_absorber(i):
        found = -1
        for j in range(P):
            if j == i or not groups[j]:
                continue
            for ci in groups[i]:
                hit = False
                for cj in groups[j]:
                    if np.abs(ci - cj).max() <= 1:
                        found = j
                        hit = True
                        break
                if hit:
                    break
        return found

    for _ in range(max_rounds):
        remaining_small = False
        for i in range(P):
            if groups[i] and 0 < len(patches[i]) < min_patch:
                j = find_absorber(i)
                if j != -1:
                    patches[j] = np.concatenate([patches[j], patches[i]])
                    groups[j] = groups[j] + groups[i]
                    patches[i] = np.zeros(0, dtype=np.int64)
                    groups[i] = []
                    if len(patches[j]) < min_patch:
                        remaining_small = True
        if not remaining_small:
            break

    out_patches, out_groups = [], []
    for i in range(P):
        if groups[i] and len(patches[i]) >= min_patch:
            out_patches.append(patches[i])
            out_groups.append(groups[i])
    return out_patches, out_groups


def divide_pc(pc: np.ndarray, n_part: int, ranges=(-1.5, 1.5), min_patch: int = 0):
    """Voxel partition + small-patch merge -> list of flat index arrays
    (upstream divide_pc contract consumed by the patch pipelines,
    reference orient_pointcloud.py:25-27)."""
    patches, ijk = voxel_indices(pc, n_part, ranges)
    if min_patch > 0:
        patches, _ = merge_small_patches(patches, ijk, min_patch)
    return patches


def divide_pc_with_ijk(pc: np.ndarray, n_part: int, ranges=(-1.5, 1.5),
                       min_patch: int = 0):
    """divide_pc variant that also returns merged grid-cell provenance (the
    fork's lzd_merge_nodes ijk_source, reference util.py:408-446) — used by
    the patch-graph builder's adjacency tests."""
    patches, ijk = voxel_indices(pc, n_part, ranges)
    if min_patch > 0:
        return merge_small_patches(patches, ijk, min_patch)
    return patches, [[c] for c in ijk]


def fix_n_filter(input_pc: np.ndarray, patches, threshold: float):
    """Curvature filter (reference inference_utils.py:52-71): keep patches
    with e0/(e1 + e2/2) > threshold for network correction; snap near-flat
    patches' normal signs to their PCA normal instead (mutates input_pc's
    normals for those patches).

    Returns list of (original_index, patch) tuples, like the reference."""
    kept = []
    for i, patch in enumerate(patches):
        idx = np.asarray(patch)
        x = input_pc[idx, :3].astype(np.float64)
        temp = x - x.mean(axis=0)
        cov = temp.T @ temp / x.shape[0]
        e, v = np.linalg.eigh(cov)
        n = v[:, 0]
        if (e[0] / (e[1] + e[2] / 2)) > threshold:
            kept.append((i, idx))
        else:
            sign = (input_pc[idx, 3:6] @ n > 0).astype(np.float32) * 2 - 1
            input_pc[idx, 3:6] *= sign[:, None]
    return kept


def segment_ids_from_patches(patches, n: int) -> np.ndarray:
    """Point -> patch id mapping for segment ops."""
    seg = np.zeros(n, dtype=np.int32)
    for p, idx in enumerate(patches):
        seg[np.asarray(idx)] = p
    return seg
