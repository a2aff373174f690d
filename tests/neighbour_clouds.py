"""Clouds for the radius-bounded neighbour search (ops/neighbors_cuda's
radius_knn and its plain version) and the check that two searches found the
same in-radius neighbourhoods up to ties. Imports neither JAX nor the JAX
package, so the card's tests use it too."""
import numpy as np

# each cloud's name -> its (N, 3) float32 positions, from a fixed seed
CLOUDS = ("sphere", "ellipsoid", "duplicates", "lattice ties", "k above n",
          "one point", "far outlier")


def ellipsoid(n, seed, axes=(1.0, 0.7, 0.5)):
    """n points on the benchmark's ellipsoid (semi-axes 1, 0.7, 0.5)."""
    v = np.random.default_rng(seed).normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return (v * np.asarray(axes)).astype(np.float32)


def cloud(name, n=3000):
    """The named cloud: a sphere of radius 0.4; the ellipsoid at n points
    (the radius binds there); a sphere whose last third repeats its first
    points exactly; an integer lattice at a spacing of 1/32 (exact d2,
    shells of equal distances at every slot); 20 points (fewer than k);
    one point; a sphere with one point 1e4 away."""
    if name == "sphere":
        return ellipsoid(2000, 1, (0.4, 0.4, 0.4))
    if name == "ellipsoid":
        return ellipsoid(n, 2)
    if name == "duplicates":
        pos = ellipsoid(1500, 3, (0.4, 0.4, 0.4))
        pos[1000:] = pos[:500]
        return pos
    if name == "lattice ties":
        g = np.arange(12, dtype=np.float32) / 32
        lat = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
        return lat[np.random.default_rng(4).permutation(len(lat))]
    if name == "k above n":
        return ellipsoid(20, 5, (0.05, 0.05, 0.05))
    if name == "one point":
        return np.float32([[0.25, -0.5, 0.125]])
    if name == "far outlier":
        pos = ellipsoid(1500, 6, (0.4, 0.4, 0.4))
        pos[700] = (1.0e4, 0.0, 0.0)
        return pos
    raise ValueError(name)


def in_radius_sets(idx, d2, r2):
    """Each row's set of neighbour indices with d2 <= r2."""
    idx, d2 = np.asarray(idx), np.asarray(d2)
    return [set(i[d <= r2].tolist()) for i, d in zip(idx, d2)]


def assert_sorted_and_padded(idx, d2):
    """Rows in (d2, index) order; slots past the last neighbour read
    (index 0, +inf)."""
    idx, d2 = np.asarray(idx, np.int64), np.asarray(d2)
    empty = np.isinf(d2)
    assert (idx[empty] == 0).all()
    assert (np.diff(empty.astype(np.int8), axis=1) >= 0).all()
    a, b = d2[:, :-1], d2[:, 1:]
    both = ~empty[:, 1:]
    assert ((a < b) | ((a == b) & (idx[:, :-1] < idx[:, 1:])))[both].all()


def differing_rows_are_ties(pos, got, want, r2, rtol=1e-6):
    """The rows whose in-radius sets differ between two searches (each an
    (idx, d2) pair); asserts that each difference is a tie: every index in
    one set and not the other lies, in float64, within rtol of the larger
    set's farthest neighbour (a tie at the k-th slot) or of the radius (a
    tie at the radius), and that the two d2 of a shared index agree within
    rtol."""
    pos = np.asarray(pos, np.float64)
    a, b = in_radius_sets(*got, r2), in_radius_sets(*want, r2)
    rows = []
    for i, (sa, sb) in enumerate(zip(a, b)):
        if sa == sb:
            continue
        rows.append(i)
        dist = {j: float(((pos[j] - pos[i]) ** 2).sum()) for j in sa | sb}
        edge = max(max((dist[j] for j in sa), default=0.0),
                   max((dist[j] for j in sb), default=0.0))
        for j in sa ^ sb:
            assert (abs(dist[j] - edge) <= rtol * edge
                    or abs(dist[j] - r2) <= rtol * r2), (i, j, dist[j], edge, r2)
    ia, da = (np.asarray(x) for x in got)
    ib, db = (np.asarray(x) for x in want)
    same = (ia == ib).all(axis=1)
    fa, fb = da[same], db[same]
    fin = np.isfinite(fa) & np.isfinite(fb)
    assert (np.abs(fa[fin] - fb[fin]) <= rtol * np.maximum(fa[fin], 1e-30)).all()
    for i in np.flatnonzero(~same):
        shared = dict(zip(ib[i].tolist(), db[i].tolist()))
        for j, d in zip(ia[i].tolist(), da[i].tolist()):
            if np.isfinite(d) and np.isfinite(shared.get(j, np.inf)):
                assert abs(d - shared[j]) <= rtol * max(d, 1e-30), (i, j)
    return rows
