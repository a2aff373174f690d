"""The port's patch and representative propagation
(dipole_tpu_torch.ops.propagate, plain torch group interaction on the CPU)
against dipole_tpu.ops.propagate on JAX-CPU: identical signs on sphere
patches, diffuse and not, weighted and not, and the host greedy pieces
identical."""
import numpy as np
import pytest

from dipole_tpu.ops import patching as jpatching
from dipole_tpu.ops import propagate as jpropagate
from dipole_tpu_torch.ops import propagate
from tests.conftest import make_sphere, scramble_signs


def _setup(n, seed, n_part=6):
    pc = scramble_signs(make_sphere(n, seed=seed, noise=0.005), seed=seed + 1)[0]
    pc[:, :3] *= 0.45
    patches = jpatching.divide_pc(pc[:, :3], n_part, min_patch=20)
    filt = jpatching.fix_n_filter(pc, patches, 0.0)
    w = np.random.default_rng(seed).uniform(0.0, 1.2, n).astype(np.float32)
    return pc, patches, filt, w


@pytest.mark.parametrize("diffuse", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_patch_propagation_signs_identical(diffuse, weighted):
    pc, patches, filt, w = _setup(1600, 21)
    w = w if weighted else None
    want = jpropagate.strongest_field_propagation_patches(
        pc, filt, patches, diffuse=diffuse, weights=w)
    got = propagate.strongest_field_propagation_patches(
        pc, filt, patches, diffuse=diffuse, weights=w, device="cpu")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("diffuse", [False, True])
def test_reps_propagation_signs_identical(diffuse):
    pc, patches, _, w = _setup(2200, 31, n_part=5)
    rng = np.random.default_rng(3)
    reps = []
    for p in patches:
        perm = rng.permutation(len(p))
        reps.append((p[perm[:40]], p[perm[40:]]))
    assert sum(len(r) for _, r in reps) > 0          # the field pass runs
    want = jpropagate.strongest_field_propagation_reps(pc, reps, diffuse=diffuse,
                                                       weights=w)
    got = propagate.strongest_field_propagation_reps(pc, reps, diffuse=diffuse,
                                                     weights=w, device="cpu")
    np.testing.assert_array_equal(got, want)


def test_host_greedy_pieces_identical():
    pc, patches, _, _ = _setup(1200, 41)
    assert propagate._flattest_patch(pc, patches) == \
        jpropagate._flattest_patch(pc, patches)
    W = np.random.default_rng(4).normal(size=(17, 17)).astype(np.float32)
    for start in (0, 5, 16):
        np.testing.assert_array_equal(propagate._greedy_patch_signs(W, start),
                                      jpropagate._greedy_patch_signs(W, start))


def test_empty_patch_list_returns_copy():
    pc = make_sphere(50, seed=5)
    out = propagate.strongest_field_propagation_patches(pc, [], [], device="cpu")
    np.testing.assert_array_equal(out, pc)
    assert propagate.strongest_field_propagation_reps(pc, [], device="cpu").shape == pc.shape
