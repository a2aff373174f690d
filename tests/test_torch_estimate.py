"""Port normal estimation (dipole_tpu_torch.ops.linalg / estimate / native)
against dipole_tpu's on JAX-CPU, same numpy inputs from a seed."""
import numpy as np
import pytest
import torch

from dipole_tpu import native as jnative
from dipole_tpu.ops import estimate as jest
from dipole_tpu.ops import linalg as jlinalg
from dipole_tpu_torch import native
from dipole_tpu_torch.ops import estimate, linalg, neighbors_cuda
from tests.conftest import make_sphere
from neighbour_clouds import (CLOUDS, assert_sorted_and_padded, cloud,
                              differing_rows_are_ties)


def _spd(n, seed):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, 3, 3)).astype(np.float32)
    return (X @ X.transpose(0, 2, 1)).astype(np.float32)


def _assert_equal_up_to_row_sign(a, b, atol):
    d = np.minimum(np.abs(a - b).max(axis=-1), np.abs(a + b).max(axis=-1))
    assert d.max() <= atol, d.max()


def test_eigh3x3_matches_jax():
    A = _spd(500, 1)
    w_j, v_j = (np.asarray(x) for x in jlinalg.eigh3x3(A))
    w_t, v_t = (x.numpy() for x in linalg.eigh3x3(torch.as_tensor(A)))
    # float32 closed form in both: eigenvalues to 1e-6 of the matrix scale
    np.testing.assert_allclose(w_t, w_j, rtol=0, atol=1e-6 * np.abs(w_j).max())
    # eigenvectors (columns) up to sign, atol 1e-5
    _assert_equal_up_to_row_sign(np.swapaxes(v_t, -1, -2),
                                 np.swapaxes(v_j, -1, -2), 1e-5)


def test_eigh3x3_degenerate_and_isotropic():
    A = np.stack([np.eye(3), np.diag([1.0, 1.0, 2.0]), np.zeros((3, 3))]
                 ).astype(np.float32)
    w_t, v_t = linalg.eigh3x3(torch.as_tensor(A))
    w_j, _ = jlinalg.eigh3x3(A)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-5)
    assert torch.isfinite(v_t).all()


def test_smallest_eigvec_matches_jax():
    A = _spd(300, 2)
    got = linalg.smallest_eigvec_3x3(torch.as_tensor(A)).numpy()
    want = np.asarray(jlinalg.smallest_eigvec_3x3(A))
    _assert_equal_up_to_row_sign(got, want, 1e-5)


def test_native_knn_matches_jax_package_bridge():
    pos = make_sphere(700, seed=3)[:, :3]
    idx_t, d2_t = native.knn(pos, pos, 12)
    idx_j, d2_j = jnative.knn(pos, pos, 12)
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_array_equal(d2_t, d2_j)


@pytest.mark.parametrize("max_nn", [10, 30])
def test_estimate_normals_matches_jax(max_nn):
    gt = make_sphere(2000, seed=1)
    gt[:, :3] *= 0.4
    got = estimate.estimate_normals(gt[:, :3], max_nn=max_nn, device="cpu")
    want = jest.estimate_normals(gt[:, :3], max_nn=max_nn)
    assert got.shape == (2000, 6) and got.dtype == np.float32
    np.testing.assert_array_equal(got[:, :3], want[:, :3])
    _assert_equal_up_to_row_sign(got[:, 3:], want[:, 3:], 1e-5)


def test_estimate_normals_keep_orientation_matches_jax():
    gt = make_sphere(800, seed=4, noise=0.005)
    gt[:, :3] *= 0.3
    got = estimate.estimate_normals(gt, keep_orientation=True, device="cpu")
    want = jest.estimate_normals(gt, keep_orientation=True)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_pca_eigen_values_matches_jax():
    x = make_sphere(200, seed=5)
    for a, b in zip(estimate.pca_eigen_values(x), jest.pca_eigen_values(x)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cols,scale", [(6, True), (3, True), (3, False)])
def test_rotate_to_principle_components_matches_jax(cols, scale):
    """Same closed-form eigenvectors; rotated coordinates to 1e-6 of max."""
    r = np.random.default_rng(cols + scale)
    x = (r.normal(size=(500, 6)) * [1, 0.5, 0.2, 1, 1, 1]).astype(np.float32)[:, :cols]
    want = np.asarray(jest.rotate_to_principle_components(x, scale=scale))
    got = estimate.rotate_to_principle_components(x, scale=scale,
                                                  device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("max_nn", [8, 20])
def test_estimate_normals_knn_matches_jax(max_nn):
    """Exact kNN (same selections), the same masked PCA: positions equal,
    normals to 1e-5 up to sign per row."""
    pc = make_sphere(600, seed=max_nn, noise=0.01)
    want = jest.estimate_normals_knn(pc, max_nn)
    got = estimate.estimate_normals_knn(pc, max_nn, device="cpu")
    np.testing.assert_array_equal(got[:, :3], want[:, :3])
    _assert_equal_up_to_row_sign(got[:, 3:], want[:, 3:], 1e-5)


def test_orient_center_matches_jax():
    pc = make_sphere(400, seed=3)
    pc[::3, 3:] *= -1
    np.testing.assert_array_equal(estimate.orient_center(pc), jest.orient_center(pc))


def test_native_pca_normals_matches_masked_pca():
    """dn_pca_normals (float64 sums) against the JAX package's float32
    masked PCA on the same neighbourhoods: allclose up to sign per row. The
    float32 closed form loses ~1e-3 where a neighbourhood is nearly flat
    (smallest eigenvalue ~1e-4 of the largest), so atol 5e-3 on the worst
    row, 1e-4 on the median."""
    if not hasattr(native.load(), "dn_pca_normals"):
        pytest.skip("native library without dn_pca_normals")
    assert native.available()
    pc = make_sphere(2000, seed=2, noise=0.01)
    pos = pc[:, :3].copy()
    idx, d2 = native.knn(pos, pos, 30)
    for r2 in (0.01, 1e9):
        got = native.pca_normals(pos, idx, d2, r2)
        want = jest._masked_pca_best(pos[idx], d2 <= r2)
        row = np.minimum(np.abs(got - want).max(-1), np.abs(got + want).max(-1))
        assert row.max() <= 5e-3 and np.median(row) <= 1e-4, (row.max(), np.median(row))
    with pytest.raises(ValueError):
        native.pca_normals(pos, idx, d2[:, :5], 0.01)


def _host_hybrid(pos, k, radius):
    """The host route's neighbourhoods: native.knn, then the radius filter
    (outside: index 0, +inf), padded to k columns where k > N."""
    idx, d2 = native.knn(pos, pos, k)
    inside = d2 <= neighbors_cuda.radius_sq(radius)
    pad = ((0, 0), (0, k - idx.shape[1]))
    return (np.pad(np.where(inside, idx, 0), pad),
            np.pad(np.where(inside, d2, np.inf).astype(np.float32), pad,
                   constant_values=np.inf))


def _dense_definition(pos, k, radius):
    """radius_knn's function written out in numpy: float32 d2 as dx*dx +
    dy*dy + dz*dz (dx = query - point), each row's pairs in (d2, index)
    order by a stable sort, the first k kept, those past the radius (and
    columns past N) read (index 0, +inf)."""
    d = pos[:, None, :] - pos[None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    order = np.argsort(d2, axis=1, kind="stable")[:, :k]
    dk = np.take_along_axis(d2, order, axis=1)
    inside = dk <= np.float32(neighbors_cuda.radius_sq(radius))
    pad = ((0, 0), (0, k - order.shape[1]))
    return (np.pad(np.where(inside, order, 0), pad).astype(np.int32),
            np.pad(np.where(inside, dk, np.inf), pad,
                   constant_values=np.inf).astype(np.float32))


@pytest.mark.parametrize("k", [10, 30, 64])
@pytest.mark.parametrize("name", CLOUDS)
def test_radius_knn_plain_matches_host_search(name, k):
    """The card kernel's plain version: exactly its definition (the dense
    numpy scan), and against the host route (native.knn, then the radius
    filter) the same in-radius neighbourhoods up to ties of d2 within a few
    ulps (the host library contracts d2 into FMAs, and among exactly equal
    d2 its heap need not keep the lower index)."""
    pos = cloud(name)
    idx, d2 = (x.numpy() for x in
               neighbors_cuda.radius_knn_plain(torch.as_tensor(pos), k, 0.1))
    assert idx.shape == d2.shape == (len(pos), k)
    assert idx.dtype == np.int32 and d2.dtype == np.float32
    assert_sorted_and_padded(idx, d2)
    want_idx, want_d2 = _dense_definition(pos, k, 0.1)
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_array_equal(d2, want_d2)
    differing_rows_are_ties(pos, (idx, d2), _host_hybrid(pos, k, 0.1),
                            neighbors_cuda.radius_sq(0.1))
    self_found = (idx == np.arange(len(pos))[:, None]) & (d2 == 0)
    assert (d2[:, 0] == 0).all() and self_found.any(axis=1).all()
    if name == "far outlier":
        assert idx[700, 0] == 700 and np.isinf(d2[700, 1:]).all()


@pytest.mark.parametrize("dev,k,route", [("cuda", 30, "card"), ("cuda", 64, "card"),
                                         ("cuda", 65, "host"), ("cuda", 0, "host"),
                                         ("cpu", 30, "host")])
def test_search_route_by_device_and_k(dev, k, route):
    assert estimate.search_route(torch.device(dev), k) == route


def test_estimate_normals_counts_its_route_on_the_cpu():
    before = dict(estimate.ROUTES)
    estimate.estimate_normals(cloud("sphere"), device="cpu")
    assert estimate.ROUTES == {"card": before["card"], "host": before["host"] + 1}


def test_card_route_with_the_plain_search_matches_the_host_route(monkeypatch):
    """The card route's glue (its search's int32 indices and +inf slots,
    gathered and masked where they lie) on the CPU, with the kernel's plain
    version in the kernel's place: the host route's normals within 1e-5 up
    to sign, on the benchmark's ellipsoid where the radius binds."""
    pos = cloud("ellipsoid")
    want = estimate.estimate_normals(pos, device="cpu")
    monkeypatch.setattr(estimate, "search_route", lambda dev, k: "card")
    monkeypatch.setattr(neighbors_cuda, "radius_knn", neighbors_cuda.radius_knn_plain)
    before = dict(estimate.ROUTES)
    got = estimate.estimate_normals(pos, device="cpu")
    assert estimate.ROUTES["card"] == before["card"] + 1
    np.testing.assert_array_equal(got[:, :3], want[:, :3])
    _assert_equal_up_to_row_sign(got[:, 3:], want[:, 3:], 1e-5)
