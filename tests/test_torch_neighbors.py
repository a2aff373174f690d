"""The port's plain kNN and FPS (dipole_tpu_torch.ops.neighbors) against
dipole_tpu: kNN against the Pallas kernel in interpret mode and against the
k-step scan of the PointCNN forward, FPS against the vmapped _fps_masked.

The JAX package on the CPU may contract a multiply and an add into an FMA,
which moves d2 by an ulp and can swap near-ties (tests/test_pallas.py:204):
kNN selections are asserted tie-equivalent, d2 to rtol 2e-6. FPS decisions
are identical on these inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dipole_tpu.models.pointcnn import _fps_masked
from dipole_tpu.ops.neighbors_pallas import knn_with_dist_pallas
from dipole_tpu_torch.ops import neighbors


def _scan(dst, src, k):
    """The reference k-step argmin scan (pointcnn._interpolate)."""
    d2 = jnp.sum((src[None, :, :] - dst[:, None, :]) ** 2, axis=-1)
    rows = jnp.arange(dst.shape[0])

    def step(dd, _):
        j = jnp.argmin(dd, axis=1)
        v = dd[rows, j]
        return dd.at[rows, j].set(jnp.inf), (j, v)

    _, (idx, d) = jax.lax.scan(step, d2, None, length=k)
    return np.moveaxis(np.asarray(idx), 0, 1), np.moveaxis(np.asarray(d), 0, 1)


def _assert_tie_equivalent(idx, d2, idx_ref, d2_ref, ns):
    assert int(idx.max()) < ns
    np.testing.assert_allclose(d2, d2_ref, rtol=2e-6, atol=0)
    diff = idx != idx_ref
    if diff.any():
        assert diff.mean() < 0.02


@pytest.mark.parametrize("nd,ns,k,nsent", [
    (512, 512, 16, 0),
    (308, 308, 20, 40),
    (185, 512, 16, 10),
    (130, 200, 20, 190),
    (308, 308, 20, 8),
])
def test_plain_knn_matches_pallas_and_scan(nd, ns, k, nsent):
    r = np.random.default_rng(nd + ns + k)
    dst = r.normal(size=(nd, 3)).astype(np.float32)
    src = r.normal(size=(ns, 3)).astype(np.float32)
    if nsent:
        src[-nsent:] = 1.0e6
    dst[-3:] = 1.0e6
    idx, d2 = neighbors.knn_with_dist(torch.from_numpy(dst[None]),
                                      torch.from_numpy(src[None]), k)
    idx, d2 = idx[0].numpy(), d2[0].numpy()
    assert idx.dtype == np.int32 and idx.shape == (nd, k)
    with pltpu.force_tpu_interpret_mode():
        ip, dp = knn_with_dist_pallas(dst, src, k, interpret=True)
    _assert_tie_equivalent(idx, d2, np.asarray(ip), np.asarray(dp), ns)
    _assert_tie_equivalent(idx, d2, *_scan(dst, src, k), ns)


def test_plain_knn_batched_rows_independent_and_k_above_sources():
    r = np.random.default_rng(3)
    pos = r.normal(size=(3, 200, 3)).astype(np.float32)
    pos[:, 100:120] = pos[:, :20]                     # exact ties at d2 = 0
    idx, d2 = neighbors.knn_with_dist(torch.from_numpy(pos), torch.from_numpy(pos), 20)
    for b in range(3):
        one = neighbors.knn_with_dist(torch.from_numpy(pos[b:b + 1]),
                                      torch.from_numpy(pos[b:b + 1]), 20)
        assert torch.equal(idx[b], one[0][0]) and torch.equal(d2[b], one[1][0])
    # duplicates: the lower index first (d2 0 twice)
    assert (idx[:, 100, :2].numpy() == [0, 100]).all()
    # more neighbours than sources: the spent row selects index 0 at +inf
    idx, d2 = neighbors.knn_with_dist(torch.from_numpy(pos[:, :5]),
                                      torch.from_numpy(pos[:, :5]), 8)
    assert (idx[..., 5:] == 0).all() and torch.isinf(d2[..., 5:]).all()
    want_idx, want_d2 = _scan(pos[0, :5], pos[0, :5], 8)
    np.testing.assert_array_equal(idx[0].numpy(), want_idx)


@pytest.mark.parametrize("B,N,m", [(8, 256, 154), (4, 308, 185), (3, 128, 77),
                                   (2, 512, 308)])
def test_plain_fps_matches_vmapped_fps_masked(B, N, m):
    r = np.random.default_rng(B * N + m)
    pos = r.normal(size=(B, N, 3)).astype(np.float32)
    nv = r.integers(max(1, m // 4), N + 1, B)
    nv[0] = max(1, m // 3)                            # fewer valid than picks
    pos[:, 10:14] = pos[:, :4]                        # duplicates
    for i in range(B):
        pos[i, nv[i]:] = 1.0e6
    valid = np.arange(N)[None, :] < nv[:, None]
    starts = (r.integers(0, 1 << 30, B) % nv).astype(np.int32)
    got = neighbors.fps_masked_batch(torch.from_numpy(pos), torch.from_numpy(valid),
                                     m, torch.from_numpy(starts)).numpy()
    want = np.asarray(jax.vmap(lambda p, v, s: _fps_masked(p, v, m, s))(
        pos, valid, starts))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    for i in range(B):                       # never an invalid point
        assert (got[i] < nv[i]).all()


@pytest.mark.parametrize("N,m", [(512, 308), (308, 185)])
def test_plain_fps_matches_pallas_kernel_interpret(N, m):
    """The plain version of csrc/fps.cu against the TPU kernel itself
    (neighbors_pallas._fps_batch_kernel in interpret mode) at the forward's
    two stage shapes: ragged valid counts, fewer valid points than picks,
    duplicates. Exact (see tests/test_pallas.py's FPS test)."""
    from dipole_tpu.ops.neighbors_pallas import fps_masked_batch_pallas

    B = 3
    r = np.random.default_rng(N + m)
    pos = r.normal(size=(B, N, 3)).astype(np.float32)
    nv = r.integers(max(1, m // 4), N + 1, B)
    nv[0] = max(1, m // 3)
    pos[:, 10:14] = pos[:, :4]
    for i in range(B):
        pos[i, nv[i]:] = 1.0e6
    valid = np.arange(N)[None, :] < nv[:, None]
    starts = (r.integers(0, 1 << 30, B) % nv).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fps_masked_batch_pallas(pos, valid, m, starts))
    got = neighbors.fps_masked_batch_plain(torch.from_numpy(pos), torch.from_numpy(valid),
                                           m, torch.from_numpy(starts)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 64, 65, 185, 308, 512, 513, 615,
                               1024, 1025, 4096, 8191, 8192])
def test_fps_plan_covers_the_patch(n):
    """csrc/fps.cu's block plan: one warp up to 512 points, then the fewest
    warps of at most 16 points a lane; an even count a lane, the fewest
    that covers n; every warp holds a point (none sweeps only empty slots)."""
    from dipole_tpu_torch.ops.neighbors_cuda import FPS_MAX_PER_LANE, fps_plan

    warps, per = fps_plan(n)
    assert warps == max(1, -(-n // 512)) and 1 <= warps <= 16
    assert per % 2 == 0 and 2 <= per <= FPS_MAX_PER_LANE
    assert 32 * warps * per >= n and 32 * warps * (per - 2) < max(n, 64)
    assert 32 * per * (warps - 1) < n


def test_fps_refuses_host_starts_outside_the_patch():
    """Starts are checked on the host, where the port makes them: the card's
    wrapper does not read them back."""
    from dipole_tpu_torch.models import pointcnn

    pos = torch.zeros((2, 16, 3))
    valid = torch.ones((2, 16), dtype=torch.bool)
    for bad in ([0, 16], [-1, 3]):
        with pytest.raises(ValueError, match="starts"):
            neighbors.fps_masked_batch(pos, valid, 4, torch.tensor(bad, dtype=torch.int32))
    model = pointcnn.PointCNN(0.6)
    patch = np.zeros((100, 6), np.float32)
    m1 = pointcnn._pad_sizes(128, 0.6)[0]
    for bad in ([[128, 0]], [[0, m1]], [[-1, 0]], [[0, 0], [0, 0]]):
        with pytest.raises(ValueError, match="starts"):
            pointcnn.pointcnn_logits_batched(model, [patch], starts=np.array(bad))


# ---- the general-purpose searches: knn, knn_graph, fps, knn_interpolate ----

from dipole_tpu.ops import neighbors as jneighbors  # noqa: E402


def _cloud_with_ties(seed, n):
    r = np.random.default_rng(seed)
    pts = r.normal(size=(n, 3)).astype(np.float32)
    pts[n // 2:] = pts[: n - n // 2]              # every point twice: exact ties
    return pts


@pytest.mark.parametrize("n,nq,k", [(300, 77, 8), (64, 64, 64), (1000, 333, 30),
                                    (5, 9, 16)])
def test_knn_matches_jax(n, nq, k):
    """Ties (duplicated points) to the lower index in both; d2 to 2 ulp."""
    base = _cloud_with_ties(n, n)
    query = np.random.default_rng(nq).normal(size=(nq, 3)).astype(np.float32)
    query[: nq // 3] = base[: nq // 3]
    ji, jd = jneighbors.knn(base, query, k)
    ti, td = neighbors.knn(base, query, k, device="cpu")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=2.4e-7, atol=1e-12)


@pytest.mark.parametrize("loop", [True, False])
def test_knn_graph_matches_jax(loop):
    pos = _cloud_with_ties(3, 200)
    np.testing.assert_array_equal(neighbors.knn_graph(pos, 6, loop=loop,
                                                      device="cpu").numpy(),
                                  np.asarray(jneighbors.knn_graph(pos, 6, loop=loop)))


@pytest.mark.parametrize("ratio,start,seed", [(0.3, None, 3), (0.6, 17, None),
                                              (1.0, None, None), (0.01, None, 9)])
def test_fps_matches_jax(ratio, start, seed):
    """Identical picks from a given start, a key-drawn start
    (randint(key, (), 0, n)) and the default 0."""
    pos = np.random.default_rng(4).normal(size=(257, 3)).astype(np.float32)
    jkey = None if seed is None else jax.random.PRNGKey(seed)
    want = jneighbors.fps(pos, ratio, start=start, key=jkey)
    got = neighbors.fps(pos, ratio, start=start,
                        key=None if jkey is None else np.asarray(jkey),
                        device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_knn_interpolate_matches_jax():
    """Weighted means: float32 sums in the same order, to 1e-6 of max |x|."""
    r = np.random.default_rng(5)
    pos_x = r.normal(size=(300, 3)).astype(np.float32)
    pos_y = r.normal(size=(120, 3)).astype(np.float32)
    pos_y[:10] = pos_x[:10]                       # d2 = 0: the 1e-16 floor
    x = r.normal(size=(300, 7)).astype(np.float32)
    for k in (16, 1):
        np.testing.assert_allclose(
            neighbors.knn_interpolate(x, pos_x, pos_y, k, device="cpu").numpy(),
            np.asarray(jneighbors.knn_interpolate(x, pos_x, pos_y, k)),
            rtol=0, atol=1e-6 * np.abs(x).max())


@pytest.mark.parametrize("name", ["knn", "knn_graph", "fps", "knn_interpolate",
                                  "rotate_to_principle_components"])
def test_public_names_default_to_the_card(monkeypatch, name):
    """A numpy call asks for the card, as the JAX twins run on the default
    accelerator; with none it raises instead of running on the CPU."""
    from dipole_tpu_torch.ops import estimate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pos = np.random.default_rng(6).normal(size=(40, 3)).astype(np.float32)
    call = {"knn": lambda: neighbors.knn(pos, pos, 4),
            "knn_graph": lambda: neighbors.knn_graph(pos, 4),
            "fps": lambda: neighbors.fps(pos, 0.5),
            "knn_interpolate": lambda: neighbors.knn_interpolate(pos, pos, pos, 4),
            "rotate_to_principle_components":
                lambda: estimate.rotate_to_principle_components(pos)}[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    # device=None keeps a CPU tensor where it lies
    t = torch.as_tensor(pos)
    assert neighbors.knn(t, t, 4, device=None)[0].device.type == "cpu"
