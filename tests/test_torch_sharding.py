"""The port's one-process mesh (dipole_tpu_torch.parallel.sharding and every
mesh= of its API) on 8 CPU shards, against dipole_tpu.parallel.sharding on
the conftest's 8 virtual JAX CPU devices and against the port's own
one-device path, on the same inputs. Mirrors tests/test_sharding.py (all
but the JAX-only dry run of __graft_entry__).

Tolerances are the JAX tests': field and potential rtol 1e-4, atol 1e-5
(tighter than JAX's own 1e-3 / 1e-4 for the potential); the group is
bit-equal; greedy signs equal, acc within 1e-3; the replay agrees on >=
0.99 of its decisions; BFS-tree, patch and 'auto' outputs are equal;
ensemble logits within rtol 2e-4, atol 2e-5 of the one-device forward.
Two tolerances are wider, for the port against the JAX package only (the
two packages associate their float32 sums differently, per shard and per
block): fields and potentials within 1e-4 |want| + 1e-5 max |want| (the
field kernel's own bound, ops/fields_cuda.py: a component that cancels
from terms of ~1e5 has float32 steps above an atol of 1e-5), and logits
within atol 1e-3 (tests/test_torch_pointcnn.py's bound: sums in other
orders, and kNN near-ties).
"""
import jax
import numpy as np
import pytest
import torch

from dipole_tpu.ops import propagate as jpropagate
from dipole_tpu.parallel import sharding as jsharding
from dipole_tpu_torch import api
from dipole_tpu_torch.ops import fields, propagate
from dipole_tpu_torch.parallel import sharding
from dipole_tpu_torch.utils.io import gen_grid
from tests.conftest import make_sphere, scramble_signs

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def mesh():
    return sharding.make_mesh(8, device="cpu")


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return jsharding.make_mesh(8)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _close_to_jax(got, want):
    """The port against the JAX package's sharded result: 1e-4 |want| +
    1e-5 max |want| per entry (see the module docstring)."""
    want = np.asarray(want)
    assert np.all(np.abs(got - want) <= 1e-4 * np.abs(want) + 1e-5 * np.abs(want).max())


def test_make_mesh_and_its_refusals(mesh):
    assert mesh.size == 8 and mesh.axis_names == ("data",)
    assert all(d == CPU for d in mesh.devices) and mesh.type == "cpu"
    assert sharding.make_mesh(device="cpu").size == sharding.CPU_SHARDS
    assert sharding.Mesh(["cpu", "cpu"]).size == 2
    # more cards than exist, as the JAX package: no silent shrinking
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="available"):
        sharding.make_mesh(n + 1, device="cuda")
    with pytest.raises(ValueError, match="one type"):
        sharding.Mesh(["cpu", "cuda:0"])
    with pytest.raises(ValueError):
        sharding.Mesh([])



def test_two_axis_mesh_rows_columns_and_refusals():
    """A ("data", "model") mesh: shape as JAX's mesh.shape, devices in
    data-major order (row i = data shard i's devices, column j = the devices
    of model piece j), one device repeated; the sharded pipeline refuses
    it rather than guess an axis."""
    devs = [torch.device("cpu")] * 6
    m = sharding.Mesh(devs, shape=(3, 2))
    assert m.shape == {"data": 3, "model": 2} and m.axis_names == ("data", "model")
    assert m.size == 6 and m.type == "cpu"
    assert [len(m.row(i)) for i in range(3)] == [2, 2, 2]
    assert [len(m.column(j)) for j in range(2)] == [3, 3]
    assert sharding.Mesh(devs, shape=(2, 3)).axis_names == ("data", "model")
    made = sharding.make_mesh(device="cpu", shape=(2, 2))
    assert made.size == 4 and made.shape == {"data": 2, "model": 2}
    flat = sharding.make_mesh(3, device="cpu")
    assert flat.shape == {"data": 3} and flat.row(1) == (CPU,) and flat.column(0) == (CPU,) * 3
    # the order is data-major: tag each position by a distinct (fake) index
    order = sharding.Mesh.__new__(sharding.Mesh)
    order.devices, order._cols = tuple(range(6)), 2
    assert order.row(1) == (2, 3) and order.column(1) == (1, 3, 5)
    with pytest.raises(ValueError, match="does not hold"):
        sharding.Mesh(devs, shape=(4, 2))
    with pytest.raises(ValueError, match="one-axis mesh"):
        sharding.Mesh(devs, ("data", "model"), shape=(3, 2))
    with pytest.raises(ValueError, match="one or two axes"):
        sharding.Mesh(devs, shape=(3, 2, 1))
    pts = make_sphere(40, seed=12)
    with pytest.raises(ValueError, match="one-axis"):
        sharding.field_grad_sharded(pts, pts, made)
    with pytest.raises(ValueError, match="one-axis"):
        sharding.greedy_sign_sequence_sharded(pts, made)
    with pytest.raises(ValueError, match="one-axis"):
        api.orient_simple(pts, mesh=made, device="cpu")

@pytest.mark.parametrize("shard,ns,nt,seeds", [
    ("targets", 300, 500, (0, 1)), ("sources", 700, 200, (2, 3)),
    ("ring", 700, 500, (7, 8))])
def test_field_sharded_matches_single(mesh, jmesh, shard, ns, nt, seeds):
    src = make_sphere(ns, seed=seeds[0])
    tgt = make_sphere(nt, seed=seeds[1])
    single = fields.field_grad(_t(src), _t(tgt[:, :3])).numpy()
    multi = sharding.field_grad_sharded(src, tgt, mesh, shard=shard)
    if shard == "targets":
        # each target row sums its sources as the whole call does (the plain
        # field tiles sources, not targets): bit-equal on the CPU
        np.testing.assert_array_equal(multi, single)
    _close(multi, single)
    _close_to_jax(multi, jsharding.field_grad_sharded(src, tgt, jmesh, shard=shard))
    with pytest.raises(ValueError):
        sharding.field_grad_sharded(src, tgt, mesh, shard="typo")


@pytest.mark.parametrize("shard", ["sources", "ring"])
def test_potential_sharded_matches_single(mesh, jmesh, shard):
    src = make_sphere(400, seed=4 if shard == "sources" else 9) * 0.4
    tgt = gen_grid(10) if shard == "sources" else make_sphere(600, seed=10)
    single = fields.potential(_t(src), _t(tgt)).numpy()
    multi = sharding.potential_sharded(src, tgt, mesh, shard=shard)
    _close(multi, single)
    _close_to_jax(multi, jsharding.potential_sharded(src, tgt, jmesh, shard=shard))


def test_ring_per_device_memory_is_one_over_d(mesh, jmesh):
    """The ring holds 1/D of the cloud a shard: its inputs are sharded, and
    its output stays sharded like the targets."""
    n_dev = 8
    pts = make_sphere(n_dev * 128, seed=11)
    src = sharding._shards(_t(pts), mesh)
    tgt = sharding._shards(_t(pts[:, :3]), mesh)
    for shards in (src, tgt):
        assert len(shards) == n_dev
        assert all(s.shape[0] * n_dev == len(pts) for s in shards)
    out = sharding._ring(src, tgt, mesh, lambda s, t: sharding._field(s, t, 1e-5))
    assert len(out) == n_dev and all(o.shape == (128, 3) for o in out)
    got = torch.cat(out).numpy()
    want = fields.field_grad(_t(pts), _t(pts[:128, :3])).numpy()
    _close(got[:128], want, rtol=1e-3, atol=1e-4)
    _close_to_jax(got, jsharding.field_grad_sharded(pts, pts, jmesh, shard="ring"))


def test_interaction_accumulate_ring_matches_sources(mesh, jmesh):
    pts = make_sphere(300, seed=12)
    signs = np.where(np.random.default_rng(13).random(300) < 0.5, -1.0, 1.0)
    ring = sharding.interaction_accumulate_sharded(pts, signs, mesh, shard="ring")
    srcs = sharding.interaction_accumulate_sharded(pts, signs, mesh, shard="sources")
    _close(ring, srcs, rtol=1e-3, atol=1e-3)
    _close(ring, jsharding.interaction_accumulate_sharded(pts, signs, jmesh),
           rtol=1e-3, atol=1e-3)
    with pytest.raises(ValueError):
        sharding.interaction_accumulate_sharded(pts, signs, mesh, shard="typo")


def test_interaction_accumulate_sharded(mesh):
    pts = make_sphere(300, seed=5)
    signs = np.where(np.random.default_rng(6).random(300) < 0.5, -1.0, 1.0)
    acc = sharding.interaction_accumulate_sharded(pts, signs, mesh)
    I = fields.dipole_interaction_matrix(_t(pts), eps=1e-5).numpy()
    want = I @ signs
    scale = np.abs(I).sum(-1)
    assert np.all(np.abs(acc - want) <= 1e-2 * np.abs(want) + 1e-3 * scale + 1e-3)


def test_sharded_greedy_matches_single(mesh, jmesh):
    gt = make_sphere(500, seed=20)
    pc, _ = scramble_signs(gt, seed=21)
    acc_m, sign_m = sharding.greedy_sign_sequence_sharded(pc, mesh)
    acc_s, sign_s = propagate.greedy_sign_sequence(pc, device="cpu")
    assert (sign_s.numpy() == sign_m).mean() == 1.0
    assert np.allclose(acc_m, acc_s.numpy(), rtol=1e-3, atol=1e-3)
    acc_j, sign_j = jsharding.greedy_sign_sequence_sharded(pc, jmesh)
    assert (sign_j == sign_m).mean() == 1.0
    assert np.allclose(acc_m, acc_j, rtol=1e-3, atol=1e-3)
    # a start on another shard, and fewer points than shards
    for n, start in ((500, 377), (5, 3)):
        a, s = sharding.greedy_sign_sequence_sharded(pc[:n], mesh, starting_point=start)
        a1, s1 = propagate.greedy_sign_sequence(pc[:n], start, device="cpu")
        assert (s == s1.numpy()).all() and np.allclose(a, a1.numpy(), rtol=1e-3, atol=1e-3)


def test_orient_points_multichip_matches_single(mesh, jmesh):
    gt = make_sphere(400, seed=22)
    pc, _ = scramble_signs(gt, seed=23)
    multi = sharding.orient_points_multichip(pc, mesh, diffuse=True)
    single = propagate.strongest_field_propagation_points(pc, diffuse=True, device="cpu")
    if fields.measure_mean_potential(single, device="cpu") < 0:
        single[:, 3:6] *= -1
    agree = ((multi[:, 3:] * single[:, 3:]).sum(1) > 0).mean()
    assert agree == 1.0
    np.testing.assert_array_equal(multi, jsharding.orient_points_multichip(pc, jmesh))


def test_xie_in_order_sharded_matches_single(mesh, jmesh):
    """Column-sharded replay: the decisions of the one-device replay and of
    the JAX package's sharded replay (agreement, as there: the sums are
    associated per shard)."""
    rng = np.random.default_rng(31)
    pc = rng.normal(size=(300, 6)).astype(np.float32)
    pc[:, 3:] /= np.linalg.norm(pc[:, 3:], axis=1, keepdims=True)
    orders = np.stack([rng.permutation(300) for _ in range(3)])
    for kernel in ("xie", "dipole"):
        for diffuse in (False, True):
            single = propagate.xie_propagation_in_order(
                pc, orders, diffuse=diffuse, kernel=kernel, device="cpu")
            multi = sharding.xie_in_order_sharded(
                pc, orders, mesh, diffuse=diffuse, kernel=kernel)
            want = jsharding.xie_in_order_sharded(
                pc, orders, jmesh, diffuse=diffuse, kernel=kernel)
            assert multi.shape == single.shape == want.shape
            assert (multi == single).mean() >= 0.99, (kernel, diffuse)
            assert (multi == want).mean() >= 0.99, (kernel, diffuse)
    # through xie_propagation_in_order(mesh=): the sharded replay, and the
    # masked and weighted variants on one device, as in the JAX package
    np.testing.assert_array_equal(
        propagate.xie_propagation_in_order(pc, orders, mesh=mesh, device="cpu"),
        sharding.xie_in_order_sharded(pc, orders, mesh))
    w = rng.uniform(0.5, 1.0, 300).astype(np.float32)
    for kw in (dict(knn_mask=8), dict(points_weight=w)):
        np.testing.assert_array_equal(
            propagate.xie_propagation_in_order(pc, orders, mesh=mesh, device="cpu", **kw),
            propagate.xie_propagation_in_order(pc, orders, device="cpu", **kw))
    # the propagation eps does not reach the dipole matrix (pinned at 1e-6)
    single = propagate.xie_propagation_in_order(pc, orders, kernel="dipole",
                                                eps=0.01, device="cpu")
    multi = sharding.xie_in_order_sharded(pc, orders, mesh, kernel="dipole", eps=0.01)
    assert (multi == single).mean() >= 0.99
    # short orders with repeated indices
    short = np.stack([rng.integers(0, 300, 120) for _ in range(2)])
    assert (sharding.xie_in_order_sharded(pc, short, mesh)
            == propagate.xie_propagation_in_order(pc, short, device="cpu")).mean() >= 0.99
    with pytest.raises(ValueError):
        sharding.xie_in_order_sharded(pc, orders, mesh, kernel="typo")


def test_bfs_tree_mesh_matches_single(mesh, jmesh):
    """tree-xie with mesh=: the one-device output, and the JAX package's."""
    pc = make_sphere(260, seed=33)
    single, _ = propagate.xie_propagation_bfs_tree(
        pc, eps=0.01, times=3, diffuse=True, device="cpu")
    multi, _ = propagate.xie_propagation_bfs_tree(
        pc, eps=0.01, times=3, diffuse=True, mesh=mesh, device="cpu")
    assert (multi == single).all()
    want, _ = jpropagate.xie_propagation_bfs_tree(
        pc, eps=0.01, times=3, diffuse=True, mesh=jmesh)
    assert (multi == want).all()


def test_point_group_interaction_sharded_matches_single(mesh, jmesh):
    """Target-sharded F: bit-equal to the one-device call (each row sums
    its sources in the same order, whatever rows sit beside it)."""
    rng = np.random.default_rng(40)
    pc = make_sphere(700, seed=40)
    seg = rng.integers(0, 9, size=len(pc)).astype(np.int32)
    w = rng.uniform(0.1, 1.0, size=len(pc)).astype(np.float32)
    for weights in (None, w):
        single = fields.point_group_interaction(_t(pc), torch.from_numpy(seg), 9,
                                                source_weights=weights).numpy()
        multi = sharding.point_group_interaction_sharded(
            pc, seg, 9, mesh, eps=1e-5, source_weights=weights)
        assert multi.shape == single.shape
        np.testing.assert_array_equal(multi, single)
        want = jsharding.point_group_interaction_sharded(
            pc, seg, 9, jmesh, eps=1e-5, source_weights=weights)
        _close(multi, want, rtol=1e-4, atol=1e-4)


def test_patch_propagation_mesh_matches_single(mesh, jmesh):
    """strongest_field_propagation_patches / _reps with mesh=: the
    one-device output, and the JAX package's."""
    rng = np.random.default_rng(41)
    pc = make_sphere(600, seed=41)
    scram = rng.random(len(pc)) < 0.5
    pc[scram, 3:] *= -1
    order = rng.permutation(len(pc))
    all_patches = [np.sort(order[i::6]) for i in range(6)]
    filtered = [(i, p) for i, p in enumerate(all_patches)]
    w = rng.uniform(0.2, 1.0, size=len(pc)).astype(np.float32)
    for diffuse in (False, True):
        single = propagate.strongest_field_propagation_patches(
            pc, filtered, all_patches, diffuse=diffuse, weights=w, device="cpu")
        multi = propagate.strongest_field_propagation_patches(
            pc, filtered, all_patches, diffuse=diffuse, weights=w, mesh=mesh,
            device="cpu")
        np.testing.assert_array_equal(multi, single)
        np.testing.assert_array_equal(multi, jpropagate.strongest_field_propagation_patches(
            pc, filtered, all_patches, diffuse=diffuse, weights=w, mesh=jmesh))
    reps = []
    for p in all_patches:
        perm = rng.permutation(len(p))
        reps.append((p[perm[:60]], p[perm[60:]]))
    single = propagate.strongest_field_propagation_reps(pc, reps, diffuse=True,
                                                        device="cpu")
    multi = propagate.strongest_field_propagation_reps(pc, reps, diffuse=True,
                                                       mesh=mesh, device="cpu")
    assert ((single[:, 3:] * multi[:, 3:]).sum(1) > 0).mean() == 1.0
    want = jpropagate.strongest_field_propagation_reps(pc, reps, diffuse=True,
                                                       mesh=jmesh)
    assert ((want[:, 3:] * multi[:, 3:]).sum(1) > 0).mean() == 1.0


@pytest.fixture(scope="module")
def model_pair():
    """(JAX params, port module) with the same random weights."""
    from dipole_tpu import train as jtrain
    from dipole_tpu_torch.models.pointcnn import from_numpy_params

    params = jtrain.init_params(jax.random.PRNGKey(0))
    return params, from_numpy_params({k: np.asarray(v) for k, v in params.items()}, 0.6)


def _forward_patches(seed):
    rng = np.random.default_rng(seed)
    patches = []
    for _ in range(10):
        p = rng.normal(size=(rng.integers(40, 120), 6)).astype(np.float32)
        p[:, 3:] /= np.linalg.norm(p[:, 3:], axis=1, keepdims=True)
        patches.append(p)
    return patches


@pytest.mark.parametrize("starts", ["key", "centroid"])
def test_ensemble_forward_mesh_matches_single(mesh, jmesh, model_pair, starts):
    """The batched forward with its patch axis split over the mesh: per-patch
    logits of the one-device forward (patches are independent), for
    key-derived and explicit (centroid) starts, and the JAX package's."""
    from dipole_tpu.models import pointcnn as jpointcnn
    from dipole_tpu_torch.models.pointcnn import (centroid_starts,
                                                  pointcnn_logits_batched)

    params, model = model_pair
    patches = _forward_patches(42 if starts == "key" else 43)
    key = np.asarray(jax.random.PRNGKey(5))
    kw = dict(key=key) if starts == "key" else dict(starts=centroid_starts(patches))
    single = pointcnn_logits_batched(model, patches, **kw)
    multi = pointcnn_logits_batched(model, patches, mesh=mesh, **kw)
    want = jpointcnn.pointcnn_logits_batched(params, 0.6, patches, mesh=jmesh, **kw)
    for s, m, w in zip(single, multi, want):
        np.testing.assert_allclose(m, s, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(m, w, rtol=0, atol=1e-3)


def test_ensemble_votes_mesh_match_single(mesh, model_pair):
    from dipole_tpu_torch.models import inference

    _, model = model_pair
    patches = _forward_patches(44)
    key = np.asarray(jax.random.PRNGKey(6))
    single = inference.ensemble_vote_patches([model], patches, key=key)
    multi = inference.ensemble_vote_patches([model], patches, key=key, mesh=mesh)
    for (sf, sp), (mf, mp) in zip(single, multi):
        np.testing.assert_allclose(mp, sp, rtol=2e-4, atol=2e-5)


def test_resolve_mesh(mesh):
    from dipole_tpu_torch.api import AutoMesh, resolve_mesh

    for off in (None, 1, "1", "off", "0", "none", ""):
        assert resolve_mesh(off, "cpu") is None
    m = resolve_mesh(8, "cpu")
    assert isinstance(m, sharding.Mesh) and m.size == 8 and m.type == "cpu"
    assert resolve_mesh(mesh) is mesh
    assert resolve_mesh(sharding.Mesh(["cpu"])) is None
    auto = resolve_mesh("auto", "cpu")
    assert isinstance(auto, AutoMesh) and auto.mesh.size == sharding.CPU_SHARDS
    assert resolve_mesh(auto) is auto
    assert resolve_mesh("4", "cpu").size == 4
    with pytest.raises(ValueError):
        resolve_mesh(3.5, "cpu")
    # a count above the cards there is refused, as JAX refuses it
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="available"):
        resolve_mesh(n + 2)
    # a mesh runs where its device is: no CPU mesh under a CUDA device
    with pytest.raises(ValueError, match="does not run"):
        api._mesh_for(mesh, torch.device("cuda"))


def test_stage_mesh_decision_table(mesh):
    """--mesh auto: explicit meshes force sharding; auto keeps the
    sequential stages on one device up to capacity and shards the
    ensemble and the field (JAX api.py:102-111)."""
    am = api.AutoMesh(mesh)
    assert api.stage_mesh(None, "greedy", 100) is None
    for stage in ("greedy", "patch", "replay", "sign_fix", "ensemble"):
        assert api.stage_mesh(mesh, stage, 10_000) is mesh
    for stage in ("greedy", "patch", "replay", "sign_fix"):
        assert api.stage_mesh(am, stage, 10_000) is None
    for stage in ("ensemble", "field"):
        assert api.stage_mesh(am, stage) is mesh
    assert api._greedy_single_chip_max("cpu") == 2**62
    assert api._greedy_single_chip_max("cuda") == 2**24
    assert api.stage_mesh(am, "greedy", api._greedy_single_chip_max("cpu") + 1) is mesh


def test_orient_simple_auto_mesh_matches_single(mesh):
    """mesh='auto' end to end: the small cloud keeps to the one-device
    paths and gives the same output."""
    rng = np.random.default_rng(5)
    v = rng.normal(size=(256, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pc = np.concatenate([v, v], axis=1).astype(np.float32)
    out_auto = api.orient_simple(pc.copy(), diffuse=True, mesh=api.AutoMesh(mesh),
                                 device="cpu")
    out_single = api.orient_simple(pc.copy(), diffuse=True, device="cpu")
    assert np.array_equal(out_auto, out_single)


def test_orient_simple_mesh_matches_single_and_jax(mesh, jmesh):
    """An explicit mesh forces the sharded greedy and sign fix: the
    one-device output, and the JAX package's under its mesh."""
    from dipole_tpu import api as japi

    pc, _ = scramble_signs(make_sphere(300, seed=50), seed=51)
    single = api.orient_simple(pc, diffuse=True, device="cpu")
    for m in (mesh, 8, "8"):
        np.testing.assert_array_equal(
            api.orient_simple(pc, diffuse=True, mesh=m, device="cpu"), single)
    np.testing.assert_array_equal(
        api.orient_simple(pc, diffuse=True, mesh=mesh, device="cpu"),
        japi.orient_simple(pc, diffuse=True, mesh=jmesh))
