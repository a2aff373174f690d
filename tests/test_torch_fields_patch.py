"""The port's field, group interaction and reference field
(dipole_tpu_torch.ops.fields, plain torch on the CPU) against
dipole_tpu.ops.fields on JAX-CPU.

Tolerances: the field to rtol 1e-5 of each target's |E| plus 1e-6 of the
largest |E| (the sums run in other orders); the group interaction to rtol
1e-5 of sum |I| over the group (the JAX package sums through a one-hot
matmul, the port through another); zero-distance pairs contribute exactly
nothing."""
import numpy as np
import pytest
import torch

from dipole_tpu.ops import fields as jfields
from dipole_tpu_torch.ops import fields
from tests.conftest import make_sphere, scramble_signs


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _assert_field_close(got, want):
    scale = np.abs(want) + 0.1 * np.abs(want).max()
    assert np.all(np.abs(got - want) <= 1e-5 * scale)


@pytest.mark.parametrize("n_src,n_tgt", [(700, 300), (2500, 1100)])
def test_field_grad_matches_jax(n_src, n_tgt):
    src = scramble_signs(make_sphere(n_src, seed=n_src), seed=1)[0]
    tgt = make_sphere(n_tgt, seed=n_tgt)[:, :3]
    tgt[n_tgt // 2:] *= 1.4                      # off the surface too
    tgt[0] = src[3, :3]                          # on a source
    src[-50:] = src[:50]                         # duplicate sources
    want = np.asarray(jfields.field_grad(src, tgt))
    got = fields.field_grad(_t(src), _t(tgt)).numpy()
    assert got.shape == (n_tgt, 3) and np.isfinite(got).all()
    _assert_field_close(got, want)


def test_field_grad_zero_distance_pairs_contribute_nothing():
    src = make_sphere(200, seed=3)
    lone = np.concatenate([src[7:8, :3] + 5.0, src[7:8, 3:]], axis=1)
    # a target on a source sees exactly the field of the others
    got = fields.field_grad(_t(src), _t(src[7:8, :3])).numpy()
    rest = fields.field_grad(_t(np.delete(src, 7, axis=0)), _t(src[7:8, :3])).numpy()
    np.testing.assert_allclose(got, rest, rtol=1e-5, atol=1e-6)
    # a target only on its own source: no field
    assert (fields.field_grad(_t(lone), _t(lone[:, :3])).numpy() == 0).all()


def _group_scale(pts, gid, G, w):
    p = pts.copy()
    if w is not None:
        p[:, 3:6] *= w[:, None]
    I = np.abs(np.asarray(jfields.dipole_interaction_matrix(p, eps=1e-5)))
    onehot = np.zeros((len(p), G), np.float32)
    keep = (gid >= 0) & (gid < G)
    onehot[np.nonzero(keep)[0], gid[keep]] = 1.0
    return I @ onehot


@pytest.mark.parametrize("weighted", [False, True])
def test_point_group_interaction_matches_jax(weighted):
    pts = scramble_signs(make_sphere(1200, seed=8), seed=9)[0]
    pts[1100:] = pts[:100]                       # coincident pairs
    r = np.random.default_rng(10)
    gid = r.integers(0, 24, len(pts)).astype(np.int32)
    gid[gid == 5] = 6                            # group 5 has no source
    w = r.uniform(0.1, 1.0, len(pts)).astype(np.float32) if weighted else None
    want = np.asarray(jfields.point_group_interaction(pts, gid, 24,
                                                      source_weights=w))
    got = fields.point_group_interaction(_t(pts), torch.from_numpy(gid), 24,
                                         source_weights=w).numpy()
    assert got.shape == (1200, 24)
    assert (got[:, 5] == 0).all() and (want[:, 5] == 0).all()
    assert np.all(np.abs(got - want) <= 1e-5 * _group_scale(pts, gid, 24, w))


def test_point_group_interaction_ignores_ids_outside_range():
    pts = make_sphere(300, seed=11)
    gid = np.arange(300) % 4
    out = gid.copy()
    out[:40] = -1
    out[40:60] = 4
    keep = fields.point_group_interaction(_t(pts), torch.from_numpy(out), 4).numpy()
    ref = fields.point_group_interaction(_t(pts[60:]), torch.from_numpy(gid[60:]), 4)
    full = fields.point_group_interaction(_t(pts), torch.from_numpy(gid), 4).numpy()
    # sources outside [0, 4) contribute nowhere; every target still has a row
    assert keep.shape == full.shape
    np.testing.assert_allclose(keep[60:], ref.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cols", [3, 6])
def test_reference_field_matches_jax(cols):
    ref = make_sphere(800, seed=12)
    tgt = scramble_signs(make_sphere(500, seed=13), seed=14)[0]
    tgt = tgt if cols == 6 else tgt[:, :3]
    want = jfields.reference_field(ref, tgt)
    got = fields.reference_field(ref, tgt, device="cpu")
    assert got.shape == (500, 6)
    np.testing.assert_array_equal(got[:, :3], want[:, :3])
    if cols == 6:
        np.testing.assert_array_equal(got, want)       # signs only
    else:
        np.testing.assert_allclose(got[:, 3:], want[:, 3:], atol=1e-5)


def test_plain_group_matches_pallas_kernel_interpret():
    """The plain version of csrc/group.cu against the TPU kernel itself
    (fields_pallas._group_kernel in interpret mode): weights, coincident
    pairs, an empty group and ids outside [0, 24); 1e-5 of sum |I|."""
    from jax.experimental.pallas import tpu as pltpu

    from dipole_tpu.ops.fields_pallas import point_group_interaction_pallas

    pts = scramble_signs(make_sphere(600, seed=21), seed=22)[0]
    pts[560:] = pts[:40]                         # coincident pairs
    r = np.random.default_rng(23)
    gid = r.integers(0, 24, len(pts)).astype(np.int32)
    gid[gid == 9] = 10                           # group 9 has no source
    gid[:12] = -1
    gid[12:20] = 24
    w = r.uniform(0.1, 1.0, len(pts)).astype(np.float32)
    wp = pts.copy()
    wp[:, 3:6] *= w[:, None]
    # the weights are applied before the call: the Pallas wrapper's own
    # source_weights path calls np.clip without bounds, which numpy 2 refuses
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(point_group_interaction_pallas(wp, gid, 24))
    got = fields.point_group_interaction_plain(
        _t(wp), torch.from_numpy(gid), 24, 1e-5).numpy()
    assert got.shape == want.shape == (600, 24)
    assert (got[:, 9] == 0).all() and (want[:, 9] == 0).all()
    assert np.all(np.abs(got - want) <= 1e-5 * _group_scale(pts, gid, 24, w))


@pytest.mark.parametrize("counts", [
    [381] * 7,                                   # the lion's group size
    [1] * 700,                                   # many one-point groups
    [5000],                                      # G = 1, larger than a chunk
    [0, 0, 5, 0],                                # empty groups, first and last
    [0],                                         # no source at all
    [256, 256, 0, 1, 255, 257, 0, 0],            # starts on chunk edges
    [100, 700, 3, 0, 600, 1, 1, 2],              # ragged
])
def test_group_chunks_cover_every_group_once(counts):
    """csrc/group.cu's grid plan (ops/fields_cuda.group_chunks): every group
    in exactly one chunk, whole, in the chunk where its first source lies."""
    from dipole_tpu_torch.ops.fields_cuda import GROUP_CHUNK, group_chunks

    offsets = torch.zeros(len(counts) + 1, dtype=torch.int32)
    offsets[1:] = torch.cumsum(torch.tensor(counts), 0)
    n_src = int(offsets[-1])
    n_max = n_src + 300                          # the point count: ids outside [0, G)
    plan = group_chunks(offsets, n_max).tolist()
    n_chunks = max(1, -(-n_max // GROUP_CHUNK))
    assert len(plan) == n_chunks + 1
    assert plan[0] == 0 and plan[-1] == len(counts)
    assert all(a <= b for a, b in zip(plan, plan[1:]))
    for c in range(n_chunks):
        for g in range(plan[c], plan[c + 1]):
            owner = min(int(offsets[g]) // GROUP_CHUNK, n_chunks - 1)
            assert owner == c, (g, c)
