"""The port's mirror-field ("xie") family against dipole_tpu on JAX-CPU: the
xie matrix (rtol 1e-5, and against the Pallas kernel in interpret mode), the
sequential xie loop, the in-order replay, bfs_orders, align_and_vote and the
BFS-tree voting (identical signs and flips)."""
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dipole_tpu.ops import fields as jfields
from dipole_tpu.ops import fields_pallas as jpallas
from dipole_tpu.ops import propagate as jprop
from dipole_tpu_torch.ops import fields, fields_cuda, propagate, propagate_cuda
from tests.conftest import make_sphere, scramble_signs


def _cloud(n, seed, noise=0.01):
    pc, _ = scramble_signs(make_sphere(n, seed=seed, noise=noise), seed=seed + 1)
    return pc


def _xie(pts, **kw):
    t = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
         for k, v in kw.items()}
    return fields.xie_interaction_matrix(torch.as_tensor(pts), **t).numpy()


@pytest.mark.parametrize("C", [3.0, 2.5])
def test_xie_matrix_matches_jax(C):
    pc = _cloud(300, 40)
    pc[280:] = pc[:20]                            # coincident pairs: n_j . n_i
    want = np.asarray(jfields.xie_interaction_matrix(pc, C=C))
    got = _xie(pc, C=C)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    nn = pc[:, 3] * pc[:, 3] + pc[:, 4] * pc[:, 4] + pc[:, 5] * pc[:, 5]
    np.testing.assert_array_equal(np.diag(got), nn)          # r = 0: n . n
    np.testing.assert_array_equal(got[np.arange(280, 300), np.arange(20)], nn[:20])
    assert np.isfinite(got).all()


def test_xie_matrix_targets_and_mask_match_jax():
    pc = _cloud(260, 41)
    tgt = _cloud(130, 42) * np.float32(1.2)
    mask = jprop._build_knn_mask(pc, 8)[:130]
    want = np.asarray(jfields.xie_interaction_matrix(pc, targets=tgt, knn_mask=mask))
    got = _xie(pc, targets=tgt, knn_mask=mask)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_xie_matrix_transposed_layout_has_the_same_bits():
    pc = _cloud(333, 43)
    tgt = _cloud(111, 44)
    I = _xie(pc, targets=tgt)
    IT = _xie(pc, targets=tgt, transposed=True)
    assert IT.shape == (333, 111)
    np.testing.assert_array_equal(IT, I.T)


@pytest.mark.parametrize("C", [3.0, 2.5])
def test_xie_matrix_mirror_identity_is_exact(C):
    """The identity csrc/imatrix.cu's symmetric mode rests on: from the
    terms of pair (i, j) (source j at target i), I[j, i] = (nn - (C ntR)
    nsR) / r3 where I[i, j] = (nn - (C nsR) ntR) / r3, bit for bit, though
    I is not symmetric in float32."""
    pc = _cloud(700, 47)
    pc[650:] = pc[:50]                            # coincident pairs
    pc[600, :3] = 0.0                             # a pair 1e-20 apart:
    pc[601, :3] = [1e-20, 0.0, 0.0]               # its entry overflows
    pts = torch.as_tensor(pc)
    tx, ty, tz, nx, ny, nz = (pts[:, k:k + 1] for k in range(6))
    sx, sy, sz, px, py, pz = (pts[:, k] for k in range(6))
    Rx, Ry, Rz = sx - tx, sy - ty, sz - tz
    r2 = Rx * Rx + Ry * Ry + Rz * Rz
    zero = r2 == 0.0
    r = fields.sqrt_rn(r2)
    safe_r = torch.where(zero, torch.ones_like(r), r)
    nsR = (px * Rx + py * Ry + pz * Rz) / safe_r
    ntR = (nx * Rx + ny * Ry + nz * Rz) / safe_r
    nn = px * nx + py * ny + pz * nz
    r3 = torch.where(zero, torch.ones_like(r), r2 * r)

    def value(first, second):
        v = torch.where(zero, nn, (nn - C * first * second) / r3)
        return torch.where(torch.isfinite(v), v, torch.zeros_like(v))

    I = fields.xie_interaction_matrix_plain(pts, pts, C)
    assert torch.equal(value(nsR, ntR), I)
    assert torch.equal(value(ntR, nsR), I.t())
    assert torch.equal(value(ntR, nsR),
                       fields.xie_interaction_matrix_plain(pts, pts, C, transposed=True))
    assert not torch.equal(I, I.t())
    assert float(I[600, 601]) == 0.0 and float(I[601, 600]) == 0.0
    dup = (torch.arange(650, 700), torch.arange(50))
    assert torch.equal(I[dup], nn[dup])            # r = 0: n . n


def test_xie_matrix_matches_pallas_interpret():
    pc = _cloud(256, 45)
    tgt = _cloud(200, 46)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpallas.xie_interaction_matrix_pallas(pc, C=3.0, targets=tgt))
    np.testing.assert_allclose(_xie(pc, targets=tgt), want, rtol=1e-5, atol=1e-5)


def test_port_knn_mask_matches_jax_mask():
    pc = _cloud(400, 47)
    np.testing.assert_array_equal(propagate._build_knn_mask(pc, 8),
                                  jprop._build_knn_mask(pc, 8))


@pytest.mark.parametrize("knn_mask", [-1, 8])
@pytest.mark.parametrize("diffuse", [False, True])
def test_xie_propagation_points_matches_jax(diffuse, knn_mask):
    pc = _cloud(700, 48)
    want = jprop.xie_propagation_points(pc, eps=1e-2, diffuse=diffuse,
                                        starting_point=3, knn_mask=knn_mask)
    got = propagate.xie_propagation_points(pc, eps=1e-2, diffuse=diffuse,
                                           starting_point=3, knn_mask=knn_mask,
                                           device="cpu")
    np.testing.assert_array_equal(got, want)


def test_xie_greedy_plain_matches_the_jax_scan():
    """acc and sign of the plain loop against _xie_greedy_scan on an
    unpadded matrix (n = 256, a bucket size: no padded steps)."""
    import jax.numpy as jnp

    pc = _cloud(256, 49)
    I = np.asarray(jfields.xie_interaction_matrix(pc))
    acc_j, sign_j = jprop._xie_greedy_scan(jnp.asarray(I), jnp.int32(5),
                                           jnp.ones(256, bool))
    acc_t, sign_t = propagate.xie_greedy_plain(torch.as_tensor(I.T.copy()), 5)
    np.testing.assert_array_equal(sign_t.numpy(), np.asarray(sign_j))
    np.testing.assert_allclose(acc_t.numpy(), np.asarray(acc_j), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("masked", [False, True])
def test_xie_greedy_plain_matches_the_jax_scan_on_exact_ties(masked):
    """Point i + 150 duplicates point i, so their acc tie exactly until the
    lower index is picked (on the card such pairs lie in different blocks):
    the plain loop takes the JAX scan's picks, unmasked and with a k = 8
    kNN mask (index form, the same indices for both)."""
    import jax.numpy as jnp

    pc = _cloud(300, 51)
    pc[150:] = pc[:150]
    I = np.asarray(jfields.xie_interaction_matrix(pc))
    knn = propagate._knn_idx(pc, 8).astype(np.int32) if masked else None
    acc_j, sign_j = jprop._xie_greedy_scan(
        jnp.asarray(I), jnp.int32(4), jnp.ones(300, bool),
        None if knn is None else jnp.asarray(knn))
    acc_t, sign_t = propagate.xie_greedy_plain(
        torch.as_tensor(I.T.copy()), 4, None if knn is None else torch.as_tensor(knn))
    np.testing.assert_array_equal(sign_t.numpy(), np.asarray(sign_j))
    np.testing.assert_allclose(acc_t.numpy(), np.asarray(acc_j), rtol=1e-5, atol=1e-4)
    if not masked:
        np.testing.assert_array_equal(acc_t[:150].numpy(), acc_t[150:].numpy())


def test_xie_propagation_points_plus_matches_jax():
    pc = _cloud(500, 50)
    want = jprop.xie_propagation_points_plus(pc, eps=1e-2, diffuse=True)
    got = propagate.xie_propagation_points_plus(pc, eps=1e-2, diffuse=True,
                                                device="cpu")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kernel", ["xie", "dipole"])
@pytest.mark.parametrize("masked,weighted", [(False, False), (True, False),
                                             (False, True), (True, True)])
@pytest.mark.parametrize("diffuse", [False, True])
def test_in_order_replay_matches_jax(kernel, masked, weighted, diffuse):
    n = 600
    rng = np.random.default_rng(51)
    pc = _cloud(n, 52)
    orders = np.stack([rng.permutation(n) for _ in range(3)])
    w = rng.uniform(0.2, 1.0, n).astype(np.float32) if weighted else None
    kw = dict(eps=1e-2, diffuse=diffuse, kernel=kernel, points_weight=w,
              knn_mask=8 if masked else -1)
    want = jprop.xie_propagation_in_order(pc, orders, **kw)
    got = propagate.xie_propagation_in_order(pc, orders, device="cpu", **kw)
    assert got.shape == (3, n) and got.dtype == bool
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kernel", ["xie", "dipole"])
@pytest.mark.parametrize("kind", ["repeats", "short"])
@pytest.mark.parametrize("diffuse", [False, True])
def test_in_order_replay_repeats_and_short_orders_match_jax(kernel, kind, diffuse):
    """Orders that visit an index again (the later visit overwrites w and
    the recorded interaction) and orders shorter than N (the rest stays
    unvisited), weighted, against the JAX scan."""
    n = 300
    rng = np.random.default_rng(64)
    pc = _cloud(n, 65)
    if kind == "repeats":
        orders = rng.integers(0, n, (3, n))
        orders[:, 200:230] = orders[:, 10:40]            # repeats at a distance
        assert all(len(np.unique(o)) < n for o in orders)
    else:
        orders = np.stack([rng.permutation(n)[:n // 3] for _ in range(3)])
    w = rng.uniform(0.2, 1.0, n).astype(np.float32)
    kw = dict(eps=1e-2, diffuse=diffuse, kernel=kernel, points_weight=w)
    want = jprop.xie_propagation_in_order(pc, orders, **kw)
    got = propagate.xie_propagation_in_order(pc, orders, device="cpu", **kw)
    np.testing.assert_array_equal(got, want)
    if kind == "short" and not diffuse:
        visited = np.zeros((3, n), bool)
        visited[np.arange(3)[:, None], orders] = True
        assert not got[~visited].any()                   # unvisited: no flip


def test_replay_plain_records_float64_row_sums():
    """inter of the plain replay is the float64 sum of the float32 products
    I colw w at each visit, and w the sign of it."""
    n = 50
    rng = np.random.default_rng(53)
    pc = _cloud(n, 54)
    I = torch.as_tensor(np.asarray(jfields.xie_interaction_matrix(pc)))
    order = torch.as_tensor(rng.permutation(n))[None, :]
    colw = torch.as_tensor(rng.uniform(0.2, 1.0, n).astype(np.float32))
    w, inter = propagate.replay_plain(I, order, colw=colw)
    ws = torch.zeros(n)
    for idx in order[0].tolist():
        v = ((I[idx] * colw).double() * ws.double()).sum()
        assert inter[0, idx] == v
        ws[idx] = -1.0 if v < 0 else 1.0
    assert torch.equal(w[0], ws)


def test_bfs_orders_match_jax():
    pc = _cloud(500, 55)
    for use_pw in (False, True):
        want, pw_j = jprop.bfs_orders(pc, 7, k=10, threshold=0.3, times=5,
                                      use_pw=use_pw)
        got, pw_t = propagate.bfs_orders(pc, 7, k=10, threshold=0.3, times=5,
                                         use_pw=use_pw)
        np.testing.assert_array_equal(got, want)
        if use_pw:
            np.testing.assert_array_equal(pw_t, pw_j)
        else:
            assert pw_t is None and pw_j is None


def test_align_and_vote_matches_jax():
    rng = np.random.default_rng(56)
    pc = _cloud(300, 57)
    base = rng.random(300) < 0.5
    flips = np.stack([base ^ (rng.random(300) < 0.1) ^ bool(t % 2)
                      for t in range(5)], axis=1)
    want_pc, want_mask = jprop.align_and_vote(pc, flips)
    got_pc, got_mask = propagate.align_and_vote(pc, flips)
    np.testing.assert_array_equal(got_mask, want_mask)
    np.testing.assert_array_equal(got_pc, want_pc)


@pytest.mark.parametrize("kernel,masked,use_pw", [("xie", False, False),
                                                  ("xie", True, True),
                                                  ("dipole", False, False)])
def test_bfs_tree_matches_jax(kernel, masked, use_pw):
    pc = _cloud(500, 58)
    kw = dict(eps=1e-2, diffuse=True, times=3, k=10, threshold=1.0,
              kernel=kernel, knn_mask=8 if masked else -1, use_pw=use_pw)
    want, want_mask = jprop.xie_propagation_bfs_tree(pc, **kw)
    got, got_mask = propagate.xie_propagation_bfs_tree(pc, device="cpu", **kw)
    np.testing.assert_array_equal(got_mask, want_mask)
    np.testing.assert_array_equal(got, want)


def test_bfs_tree_refuses_even_times_and_a_mesh():
    """Even `times` raise; a mesh (4 CPU shards) column-shards the replay and
    gives the one-device output (tests/test_torch_sharding.py holds it to
    the JAX package's mesh)."""
    pc = _cloud(50, 59)
    with pytest.raises(ValueError, match="odd"):
        propagate.xie_propagation_bfs_tree(pc, times=2, device="cpu")
    got, got_mask = propagate.xie_propagation_bfs_tree(pc, times=1, mesh=4,
                                                       device="cpu")
    want, want_mask = propagate.xie_propagation_bfs_tree(pc, times=1, device="cpu")
    np.testing.assert_array_equal(got_mask, want_mask)
    np.testing.assert_array_equal(got, want)


def test_replay_refuses_bad_orders_and_kernels():
    pc = _cloud(30, 60)
    with pytest.raises(ValueError, match="orders"):
        propagate.xie_propagation_in_order(pc, np.array([[0, 30]]), device="cpu")
    with pytest.raises(ValueError, match="kernel"):
        propagate.xie_propagation_in_order(pc, np.zeros((1, 30), int), kernel="x",
                                           device="cpu")


def test_reverse_knn_lists_the_mask_rows():
    knn = torch.tensor([[0, 2], [1, 0], [2, 2], [3, 9]])
    ptr, src = propagate_cuda.reverse_knn(knn, 4)
    # target 0 <- sources 0, 1; 1 <- 1; 2 <- 0, 2 (once); 3 <- 3; 9 is out
    assert ptr.tolist() == [0, 2, 3, 5, 6]
    assert src.tolist() == [0, 1, 1, 0, 2, 3]


def test_xie_kernel_wrappers_refuse_cpu_tensors():
    pc = torch.as_tensor(_cloud(10, 61))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fields_cuda.xie_imatrix(pc, pc, 3.0)
    I = fields.xie_interaction_matrix(pc)
    with pytest.raises(ValueError, match="CUDA tensor"):
        propagate_cuda.xie_greedy(I, 0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        propagate_cuda.replay(I, torch.zeros((1, 10), dtype=torch.int64))


def test_edge_calculators_match_jax():
    a, b = _cloud(200, 62), _cloud(150, 63) * np.float32(1.5)
    w_j, _ = jfields.field_edge_calculator(a, b)
    w_t, neg = fields.field_edge_calculator(a, b, device="cpu")
    assert neg == -w_t
    np.testing.assert_allclose(w_t, w_j, rtol=1e-4)
    assert fields.field_edge_calculator_bool(a, b, device="cpu") == \
        jfields.field_edge_calculator_bool(a, b)
    assert fields.field_edge_calculator_count(a, b, device="cpu") == \
        jfields.field_edge_calculator_count(a, b)
    np.testing.assert_allclose(fields.self_interaction_all(a, device="cpu"),
                               jfields.self_interaction_all(a), rtol=1e-4)
    for fn in ("self_interaction", "random_self_interaction"):
        got = getattr(fields, fn)(a, rng=np.random.default_rng(3), device="cpu")
        want = getattr(jfields, fn)(a, rng=np.random.default_rng(3))
        np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(fields.xie_distance(a, b, device="cpu").numpy(),
                               np.asarray(jfields.xie_distance(a, b)), rtol=1e-5)
