"""The samplers make the same clouds from the same seed, and others from
another; their normals are the analytic unit normals."""
import numpy as np

from portbench import samplers
from portbench.loops import open_loop_client


def test_ellipsoid_batch_is_seeded():
    a = samplers.ellipsoid_batch(3, 500, 2**31 + 11)
    b = samplers.ellipsoid_batch(3, 500, 2**31 + 11)
    c = samplers.ellipsoid_batch(3, 500, 2**31 + 12)
    assert a.shape == (3, 500, 6) and a.dtype == np.float32
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    x, n = a[..., :3].astype(np.float64), a[..., 3:6].astype(np.float64)
    # on the surface x^2 + (y/0.7)^2 + (z/0.5)^2 = 1, normal along its gradient
    assert np.allclose((x / [1.0, 0.7, 0.5]) ** 2 @ np.ones(3), 1.0, atol=1e-5)
    g = x / np.array([1.0, 0.49, 0.25])
    g /= np.linalg.norm(g, axis=-1, keepdims=True)
    assert np.allclose((g * n).sum(-1), 1.0, atol=1e-5)


def test_client_sends_the_numpy_samplers_clouds():
    xyz, due, picks = open_loop_client.requests(7, 20.0, 1.0, 100, (1, 0.7, 0.5), 3)
    assert xyz.dtype == np.float64 and xyz.shape == (20, 100, 3) and len(due) == 20
    assert np.array_equal(xyz, samplers.ellipsoid_points(20, 100, 7))
    assert not np.array_equal(xyz, samplers.ellipsoid_points(20, 100, 8))
    assert np.allclose((xyz / [1.0, 0.7, 0.5]) ** 2 @ np.ones(3), 1.0)
    assert len(picks) == 3 and np.all(np.diff(picks) > 0)


def test_open_loop_same_arrivals_every_seed():
    d = open_loop_client.schedule(200, 20.0, 10.0)
    assert d[0] == 0.0 and d[-1] < 10.0 and np.all(np.diff(d) > 0)
    assert np.array_equal(d, open_loop_client.schedule(200, 20.0, 10.0))
    gaps = np.sort(np.diff(np.append(d, 10.0)))
    q = (np.arange(200) + 0.5) / 200
    want = np.sort(-np.log1p(-q))
    assert np.allclose(gaps, want * 10.0 / want.sum())
    x1, d1, p1 = open_loop_client.requests(9, 20.0, 1.0, 50, (1, 0.7, 0.5), 4)
    x2, d2, p2 = open_loop_client.requests(9, 20.0, 1.0, 50, (1, 0.7, 0.5), 4)
    x3, d3, _ = open_loop_client.requests(10, 20.0, 1.0, 50, (1, 0.7, 0.5), 4)
    assert np.array_equal(x1, x2) and np.array_equal(p1, p2) and len(p1) == 4
    assert np.array_equal(d1, d3) and not np.array_equal(x1, x3)
