"""The port's voxel patching, small-patch merging and curvature filter
(dipole_tpu_torch.ops.patching) against dipole_tpu.ops.patching: identical
index arrays, merges and filter decisions."""
import numpy as np
import pytest

from dipole_tpu.ops import patching as jpatching
from dipole_tpu_torch.ops import patching
from tests.conftest import make_sphere, scramble_signs


def _cloud(n, seed):
    pc = scramble_signs(make_sphere(n, seed=seed, noise=0.01), seed=seed + 1)[0]
    pc[:, :3] *= 0.45
    return pc


@pytest.mark.parametrize("n_part,min_patch", [(4, 0), (6, 20), (9, 40), (15, 21)])
def test_divide_pc_identical(n_part, min_patch):
    pc = _cloud(3000, 5)
    got = patching.divide_pc(pc[:, :3], n_part, min_patch=min_patch)
    want = jpatching.divide_pc(pc[:, :3], n_part, min_patch=min_patch)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    ga, ia = patching.divide_pc_with_ijk(pc[:, :3], n_part, min_patch=min_patch)
    gb, ib = jpatching.divide_pc_with_ijk(pc[:, :3], n_part, min_patch=min_patch)
    assert [c.tolist() for g in ia for c in g] == [c.tolist() for g in ib for c in g]
    np.testing.assert_array_equal(
        patching.segment_ids_from_patches(got, len(pc)),
        jpatching.segment_ids_from_patches(want, len(pc)))


@pytest.mark.parametrize("threshold", [0.0, 0.01, 0.05])
def test_fix_n_filter_identical(threshold):
    pc = _cloud(2000, 7)
    patches = jpatching.divide_pc(pc[:, :3], 6, min_patch=20)
    a, b = pc.copy(), pc.copy()
    got = patching.fix_n_filter(a, patches, threshold)
    want = jpatching.fix_n_filter(b, patches, threshold)
    assert [i for i, _ in got] == [i for i, _ in want]
    np.testing.assert_array_equal(a, b)        # snapped flat-patch normals


def test_merge_small_patches_identical():
    pc = _cloud(1500, 9)
    p, ijk = jpatching.voxel_indices(pc, 12)
    gp, gi = patching.voxel_indices(pc, 12)
    for a, b in zip(gp, p):
        np.testing.assert_array_equal(a, b)
    got, got_cells = patching.merge_small_patches(gp, gi, 30)
    want, want_cells = jpatching.merge_small_patches(p, ijk, 30)
    assert len(got) == len(want) and len(got) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert [[c.tolist() for c in g] for g in got_cells] == \
        [[c.tolist() for c in g] for g in want_cells]
