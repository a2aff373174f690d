"""The port's host graph layer, flip solver, native bridges, server handlers,
the xie methods of api.orient and the kernel build lock, against dipole_tpu
on JAX-CPU where it has a twin: identical CSR arrays, BFS routes, solver
outputs and Hoppe signs; the handlers within 0.02 GT agreement of the JAX
package (their normals come from PCAs that differ in the last bits)."""
import os
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from dipole_tpu import api as japi
from dipole_tpu import graphs as jgraphs
from dipole_tpu import native as jnative
from dipole_tpu.ops import solve as jsolve
from dipole_tpu.serve import handlers as jhandlers
from dipole_tpu_torch import api, graphs, native
from dipole_tpu_torch.ops import _build, solve
from dipole_tpu_torch.ops.metrics import sign_agreement
from dipole_tpu_torch.serve import handlers
from dipole_tpu_torch.serve.batching import MicroBatcher
from tests.conftest import make_sphere, scramble_signs


def _ellipsoid(n, seed):
    r = np.random.default_rng(seed)
    v = r.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    a = np.array([1.0, 0.7, 0.5])
    nrm = v / a
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return np.concatenate([v * a, nrm], axis=1).astype(np.float32)


@pytest.mark.parametrize("k,threshold", [(8, 1.0), (10, 0.1), (1, 0.5)])
def test_emst_csr_arrays_match_jax(k, threshold):
    pc = make_sphere(400, seed=70, noise=0.01)
    G, dist = graphs.emst_from_pc(pc[:, :3], k, threshold)
    Gj, dist_j = jgraphs.emst_from_pc(pc[:, :3], k, threshold)
    np.testing.assert_array_equal(G.indptr, Gj.indptr)
    np.testing.assert_array_equal(G.indices, Gj.indices)
    np.testing.assert_array_equal(G.weights, Gj.weights)
    np.testing.assert_array_equal(dist, dist_j)
    for start in (0, 123):
        np.testing.assert_array_equal(G.get_bfs_route(start), Gj.get_bfs_route(start))
        np.testing.assert_array_equal(G.get_weighted_bfs_route(start),
                                      Gj.get_weighted_bfs_route(start))


def test_bfs_route_restarts_across_components():
    indptr = np.array([0, 1, 2, 2, 3, 4])
    indices = np.array([1, 0, 4, 3])
    route, comp = native.bfs_route_csr(indptr, indices, 3)
    want, comp_j = jnative.bfs_route_csr(indptr, indices, 3)
    np.testing.assert_array_equal(route, want)
    assert comp == comp_j == 3
    with pytest.raises(ValueError, match="start"):
        native.bfs_route_csr(indptr, indices, 5)


def test_linked_list_and_riemannian_graphs_match_jax():
    pc = make_sphere(150, seed=71)
    G, d = graphs.riemannian_graph_from_pc(pc, k=6)
    Gj, dj = jgraphs.riemannian_graph_from_pc(pc, k=6)
    assert G.adj == Gj.adj
    np.testing.assert_array_equal(d, dj)
    np.testing.assert_array_equal(G.get_bfs_route(5), Gj.get_bfs_route(5))
    np.testing.assert_array_equal(G.get_weighted_bfs_route(5),
                                  Gj.get_weighted_bfs_route(5))
    assert graphs.hoppe_dist(pc[0], pc[1]) == jgraphs.hoppe_dist(pc[0], pc[1])


def test_minimum_spanning_tree_matches_jax():
    r = np.random.default_rng(72)
    edges = [(int(u), int(v), float(w)) for u, v, w in
             zip(r.integers(0, 40, 120), r.integers(0, 40, 120), r.random(120))
             if u != v]
    assert graphs.minimum_spanning_tree(40, edges) == \
        jgraphs.minimum_spanning_tree(40, edges)


@pytest.mark.parametrize("n", [6, 14, 25, 40])
@pytest.mark.parametrize("minimize", [True, False])
def test_solver_matches_jax(n, minimize):
    """Exact enumeration up to 20 variables, tree init + native local search
    above: the same assignment as the JAX package."""
    r = np.random.default_rng(n)
    A = r.normal(size=(n, n))
    B = r.normal(size=(n, n))
    got = solve.solve_flip_assignment(A, B, minimize=minimize)
    want = jsolve.solve_flip_assignment(A, B, minimize=minimize)
    np.testing.assert_array_equal(got, want)
    assert solve.cal_loss(got, A, B) == jsolve.cal_loss(want, A, B)
    np.testing.assert_array_equal(solve.miqp_min(A, B), jsolve.miqp_min(A, B))
    np.testing.assert_array_equal(solve.miqp_max(A, B), jsolve.miqp_max(A, B))


def test_flip_local_search_matches_jax():
    r = np.random.default_rng(73)
    M = r.normal(size=(30, 30))
    x0 = r.integers(0, 2, 30)
    for minimize in (True, False):
        np.testing.assert_array_equal(native.flip_local_search(M, x0, minimize),
                                      jnative.flip_local_search(M, x0, minimize))


@pytest.mark.parametrize("seed", [74, 75])
def test_hoppe_signs_match_jax(seed):
    gt = make_sphere(800, seed=seed, noise=0.005)
    scr, _ = scramble_signs(gt, seed=seed + 1)
    np.testing.assert_array_equal(native.hoppe_orient_signs(scr[:, :3], scr[:, 3:], 10),
                                  jnative.hoppe_orient_signs(scr[:, :3], scr[:, 3:], 10))
    np.testing.assert_array_equal(graphs.orient_normals_hoppe(scr, k=10),
                                  jgraphs.orient_normals_hoppe(scr, k=10))


def test_bid_graph_and_graph_pc_match_jax():
    pc = make_sphere(60, seed=76)
    patches = [np.arange(0, 20), np.arange(20, 40), np.arange(40, 60)]
    gt = pc.copy()
    pc = pc.copy()
    pc[20:40, 3:] *= -1
    flip = np.array([0, 1, 0])
    out = []
    for g in (graphs, jgraphs):
        G = g.BidGraph()
        G.V = [0, 1, 2]
        G.E = [g.BiEdge(0, 1, 2.0, -2.0), g.BiEdge(1, 2, -1.0, 1.0)]
        A, B = G.to_matrix()
        gpc = g.GraphPC(G, pc, patches, gt, flip)
        out.append((A, B, gpc.cal_flip_acc(), gpc.cal_edge_acc(),
                    gpc.get_edge_correctness(), gpc.get_node_flip_status()))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])
    assert out[0][2:] == out[1][2:]


HANDLER_CONFIGS = {
    "simple_estimate": {"diffuse": True},
    "xie_propagation": {"max_nn": 30, "eps": 1.0, "diffuse": False},
    "tree_xie_propagation": {"max_nn": 30, "eps": 1.0, "diffuse": False, "times": 3},
    "hoppe_estimate": {"k_neighbor": 10},
    "graph_dipole_estimate": {"max_nn": 30, "divide_method": "grid_partition",
                              "n_part": 4, "min_patch": 0},
}


@pytest.mark.parametrize("name", sorted(HANDLER_CONFIGS))
def test_handlers_match_jax(name):
    gt = _ellipsoid(1200, 77)
    xyz = gt[:, :3].astype(np.float64)
    got = handlers.dispatch(name, xyz, dict(HANDLER_CONFIGS[name]), device="cpu")
    want = jhandlers.dispatch(name, xyz, dict(HANDLER_CONFIGS[name]))
    assert got.shape == want.shape == (1200, 6) and got.dtype == np.float64
    np.testing.assert_allclose(got[:, :3], xyz, atol=1e-5)
    a_t, a_j = sign_agreement(got, gt), sign_agreement(want, gt)
    assert a_t >= a_j - 0.02, (a_t, a_j)
    assert ((got[:, 3:] * want[:, 3:]).sum(1) > 0).mean() >= 0.98


def test_dispatch_placeholder_batcher_and_unknown():
    xyz = np.random.default_rng(78).normal(size=(10, 3))
    logged = []
    out = handlers.dispatch("xie_propagation", xyz, {"max_nn": 30},
                            log=lambda msg, mode: logged.append(mode), device="cpu")
    want = jhandlers.dispatch("xie_propagation", xyz, {"max_nn": 30})
    np.testing.assert_array_equal(out, want)
    assert logged == ["warning"]
    with pytest.raises(ValueError, match="Unknown method"):
        handlers.dispatch("nope", xyz, {}, device="cpu")
    # a batcher routes simple_estimate through the micro-batched core
    b = MicroBatcher(window_s=0.0)
    gt = _ellipsoid(60, 80)
    out = handlers.dispatch("simple_estimate", gt[:, :3].astype(np.float64), {},
                            batcher=b, device="cpu")
    assert out.shape == (60, 6) and b.jobs_run == 1
    # a server mesh of more cards than exist raises, as in the JAX package;
    # a CPU mesh runs, bypasses the batcher and gives the one-device reply
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="available"):
        handlers.set_mesh(cards + 4)
    try:
        handlers.set_mesh(4, device="cpu")
        assert handlers.get_mesh().size == 4
        meshed = handlers.dispatch("simple_estimate", gt[:, :3].astype(np.float64),
                                   {}, batcher=b, device="cpu")
        assert b.jobs_run == 1
        np.testing.assert_array_equal(meshed, out)
    finally:
        handlers.set_mesh(1)
    assert handlers.get_mesh() is None


@pytest.mark.parametrize("method", ["xie", "tree_xie", "hoppe"])
def test_orient_xie_methods_match_jax(method):
    gt = _ellipsoid(1500, 79)
    got = api.orient(gt[:, :3], method=method, device="cpu")
    want = japi.orient(gt[:, :3], method=method)
    assert got.dtype == np.float32 and got.shape == (1500, 6)
    assert abs(sign_agreement(got, gt) - sign_agreement(want, gt)) <= 0.02
    assert sign_agreement(got, gt) >= 0.95
    assert ((got[:, 3:] * want[:, 3:]).sum(1) > 0).mean() >= 0.98


def test_orient_xie_default_device_without_gpu_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.orient(_ellipsoid(100, 80)[:, :3], method="xie")


def test_build_lock_serialises_threads(monkeypatch, tmp_path):
    """Eight threads calling library() on a cold build directory start each
    nvcc job once, under names that carry process and thread."""
    calls = []
    lock = threading.Lock()

    class FakeProc:
        def __init__(self, cmd, **kw):
            out = Path(cmd[cmd.index("-o") + 1])
            with lock:
                calls.append(out.name)
            out.write_bytes(b"lib")
            self.returncode = 0

        def communicate(self, timeout=None):
            return "ptxas info    : Used 8 registers", None

        def poll(self):
            return 0

    class FakeLib:
        def __init__(self, path):
            self.path = path
            self.dipole_error_string = lambda err: b""

    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", FakeProc)
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    monkeypatch.setattr(_build, "_libs", {})
    got = []
    threads = [threading.Thread(target=lambda: got.append(_build.library("replay")))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(got) == 8 and len({id(lib) for lib in got}) == 1
    assert len(calls) == len(_build.SOURCES)
    assert all(f".tmp{os.getpid()}." in name for name in calls)
    assert "replay" in _build.SOURCES
    assert (tmp_path / _build._digest() / "libreplay.so").exists()


def test_native_wrappers_raise_without_the_library(monkeypatch):
    def broken():
        raise RuntimeError("native library unavailable: test")

    monkeypatch.setattr(native, "load", broken)
    for call in (lambda: native.bfs_route_csr(np.array([0, 0]), np.zeros(0), 0),
                 lambda: native.flip_local_search(np.zeros((2, 2)), np.zeros(2), True),
                 lambda: native.hoppe_orient_signs(np.zeros((2, 3)), np.ones((2, 3)), 1)):
        with pytest.raises(RuntimeError, match="unavailable"):
            call()


@pytest.mark.parametrize("method", ["xie", "tree_xie", "hoppe"])
def test_chip_smoke_gt_threshold_holds_for_jax(method):
    """chip_smoke.py requires GT sign agreement >= 0.95 of the xie methods
    unless the JAX package scores less on the CPU at 2k on the same cloud
    (then its score - 0.02): the JAX package and the port score 1.000 on the
    first 2000 points of chip_smoke's 10k ellipsoid."""
    from chip_smoke import SEED, ellipsoid

    gt = ellipsoid(10000, SEED)[:2000]
    assert sign_agreement(japi.orient(gt[:, :3].copy(), method=method), gt) == 1.0
    assert sign_agreement(api.orient(gt[:, :3].copy(), method=method, device="cpu"),
                          gt) == 1.0
