"""Card-only tests of dipole_tpu_torch's CUDA kernels (marker `gpu`).

Each kernel is held against its plain torch version on the card, and the
card's path against the port's CPU path (which the other test_torch_* files
hold against dipole_tpu). The file imports neither JAX nor tests/conftest.py,
so it also runs on a GPU machine without JAX:

    python -m pytest tests/test_torch_gpu.py -q -p no:cacheprovider --noconftest

Without a CUDA device every test skips from the fixture below, decided at
run time, never at import.
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

from pathlib import Path

from dipole_tpu_torch import api
from dipole_tpu_torch.ops import (estimate, fields, fields_cuda, neighbors,
                                  neighbors_cuda, propagate, propagate_cuda)
from dipole_tpu_torch.tools import mxu_field_experiment as mxu
from dipole_tpu_torch.utils.io import Transform, gen_grid
from dipole_tpu_torch.utils.timing import timer_factory
from neighbour_clouds import (CLOUDS, assert_sorted_and_padded, cloud,
                              differing_rows_are_ties, ellipsoid)
from test_torch_card_route import host_propagation

ROOT = Path(__file__).resolve().parent.parent
CKPT = str(ROOT / "pre_trained_tpu" / "dipole_0.pt")

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def sphere(n, seed, scramble=True):
    r = np.random.default_rng(seed)
    v = r.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pc = np.concatenate([v, v], axis=1).astype(np.float32)
    if scramble:
        pc[r.random(n) < 0.5, 3:] *= -1
    return pc


def test_potential_kernel_matches_plain(cuda_device):
    src = torch.as_tensor(sphere(5000, 1), device=cuda_device)
    grid = torch.as_tensor(gen_grid(10), device=cuda_device)
    src[7, :3] = grid[321]                       # a poisoned target
    k = fields.potential(src, grid)
    p = fields.potential_plain(src, grid)
    # sums in other orders: rtol 1e-4 per target, plus an absolute floor of
    # 1e-5 of the largest |phi| for targets whose sum cancels
    torch.testing.assert_close(k, p, rtol=1e-4,
                               atol=1e-5 * float(p.abs().max()))
    assert float(k[321]) == 0.0 and float(p[321]) == 0.0


def test_imatrix_kernel_is_bit_equal(cuda_device):
    pc = torch.as_tensor(sphere(1000, 2), device=cuda_device)
    pc[900:] = pc[:100]                          # coincident pairs
    assert torch.equal(fields.dipole_interaction_matrix(pc),
                       fields.dipole_interaction_matrix_plain(pc, pc, 1e-6))
    tgt = torch.as_tensor(sphere(333, 3), device=cuda_device) * 1.5
    assert torch.equal(fields.dipole_interaction_matrix(pc, targets=tgt),
                       fields.dipole_interaction_matrix_plain(tgt, pc, 1e-6))


# each edge of the chunk plan (csrc/common.cuh's chunked::plan): 1, 31 and
# 32 sources (one chunk at one target), 2048 and 2049, and 180000 (528
# chunks at the lattice); 1 target, the lattice's 1000 and 1025 (a third
# block of 512 targets); a lattice point on a source (exactly 0 there)
@pytest.mark.parametrize("n_src", [1, 31, 32, 2048, 2049, 180000])
@pytest.mark.parametrize("n_tgt", [1, 1000, 1025])
def test_potential_kernel_chunk_plan_edges(cuda_device, n_src, n_tgt):
    grid = torch.as_tensor(gen_grid(10), device=cuda_device)
    extra = torch.as_tensor(np.random.default_rng(26).uniform(-1, 1, (25, 3))
                            .astype(np.float32), device=cuda_device)
    tgt = {1: grid[555:556], 1000: grid, 1025: torch.cat([grid, extra])}[n_tgt]
    at = 0 if n_tgt == 1 else 555                # grid[555]'s index in tgt
    src = torch.as_tensor(sphere(n_src, 27), device=cuda_device)
    src[0, :3] = tgt[at]
    k = fields.potential(src, tgt)
    p = fields.potential_plain(src, tgt)
    torch.testing.assert_close(k, p, rtol=1e-4, atol=1e-5 * float(p.abs().max()))
    assert float(k[at]) == 0.0 and float(p[at]) == 0.0
    assert bool(torch.isfinite(k).all())


def test_potential_and_field_take_no_targets_or_no_sources(cuda_device):
    """The chunk plan shared by both kernels: no targets, an empty output;
    no sources, zeros."""
    src = torch.as_tensor(sphere(100, 29), device=cuda_device)
    tgt = src[:, :3].contiguous()
    none = torch.zeros((0, 3), device=cuda_device)
    assert fields.potential(src, none).shape == (0,)
    assert fields.field_grad(src, none).shape == (0, 3)
    assert torch.equal(fields.potential(src[:0], tgt), torch.zeros(100, device=cuda_device))
    assert torch.equal(fields.field_grad(src[:0], tgt),
                       torch.zeros((100, 3), device=cuda_device))


# targets = sources (symmetric mode: each pair's terms give I[i, j] and
# the mirror I[j, i]) at sizes about the 64-point tile, a graph_dipole
# patch's 458 points, 3001 and 4096, with duplicates and a pair 1e-22
# apart (entries that overflow: 0), at eps 1e-6 (the replay's) and 1e-2;
# then 333 other targets (general mode)
@pytest.mark.parametrize("n", [1, 63, 64, 65, 129, 458, 3001, 4096])
@pytest.mark.parametrize("eps", [1e-6, 1e-2])
def test_imatrix_symmetric_mode_is_bit_equal(cuda_device, n, eps):
    pc = torch.as_tensor(sphere(n, 25), device=cuda_device)
    dup = n // 16
    if n > 64:
        pc[n - dup:] = pc[:dup]
        pc[dup, :3] = 0.0
        pc[dup + 1, :3] = torch.tensor([1e-22, 0.0, 0.0])
    I = fields.dipole_interaction_matrix(pc, eps=eps)
    assert torch.equal(I, fields.dipole_interaction_matrix_plain(pc, pc, eps))
    if n > 64:
        assert float(I[dup, dup + 1]) == 0.0 and float(I[dup + 1, dup]) == 0.0
        assert not torch.equal(I, I.t())
    tgt = torch.as_tensor(sphere(333, 28), device=cuda_device) * 1.5
    assert torch.equal(fields.dipole_interaction_matrix(pc, eps=eps, targets=tgt),
                       fields.dipole_interaction_matrix_plain(tgt, pc, eps))


@pytest.mark.parametrize("mode", ["rows", "columns"])
def test_greedy_kernel_is_bit_equal(cuda_device, mode):
    pts = torch.as_tensor(sphere(7000, 4), device=cuda_device)
    if mode == "rows":
        I = fields.dipole_interaction_matrix(pts)
        got = propagate_cuda.greedy_rows(I, 5)
        want = propagate.greedy_rows_plain(I, 5)
    else:
        got = propagate_cuda.greedy_columns(pts, 5, 1e-6)
        want = propagate.greedy_columns_plain(pts, 5, 1e-6)
    assert propagate_cuda.last_launch()["blocks"] > 1   # the exchange between blocks
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _greedy_both_modes(pts, start, **kw):
    """[(kernel, plain, launch)] of the row and the column greedy."""
    I = fields.dipole_interaction_matrix(pts)
    out = []
    for kernel, plain in (
            (lambda: propagate_cuda.greedy_rows(I, start, **kw),
             lambda: propagate.greedy_rows_plain(I, start)),
            (lambda: propagate_cuda.greedy_columns(pts, start, 1e-6, **kw),
             lambda: propagate.greedy_columns_plain(pts, start, 1e-6))):
        got = kernel()
        out.append((got, plain(), propagate_cuda.last_launch()))
    return out


# (n, _reg_cap, _blocks, points a thread): both sides of the register cap
# (through the private cap; 0 = state in global memory), one block up to
# its 8192 points and a forced one-block grid above them, a grid just above
# the one-block threshold, and 8 points a thread on two blocks
@pytest.mark.parametrize("n,reg_cap,blocks,per", [
    (4000, 4000, 0, 4), (4001, 4000, 0, 0), (20000, 5000, 0, 0),
    (8192, 0, 1, 8), (8193, 0, 1, 0), (2048, 0, 1, 2),
    (5121, 0, 0, 1), (12000, 0, 2, 8)])
def test_greedy_kernel_launch_shapes_are_bit_equal(cuda_device, n, reg_cap, blocks, per):
    pts = torch.as_tensor(sphere(n, 23), device=cuda_device)
    for got, want, launch in _greedy_both_modes(pts, 11, _reg_cap=reg_cap,
                                                _blocks=blocks):
        assert launch["per_thread"] == per
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n", [3000, 20000])
def test_greedy_kernel_ties_across_blocks(cuda_device, n):
    """Point i + n/2 duplicates point i, in another block: their |acc| tie
    exactly until the lower index is picked."""
    pc = sphere(n, 24)
    pc[n // 2:] = pc[:n // 2]
    pts = torch.as_tensor(pc, device=cuda_device)
    for reg_cap in (0, 1):                       # registers; global memory
        for got, want, launch in _greedy_both_modes(pts, 3, _reg_cap=reg_cap,
                                                    _blocks=4):
            assert launch["blocks"] == 4
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            assert torch.equal(got[0][:n // 2], got[0][n // 2:])


# one block (no exchange) up to 5120 points in row mode and 4096 in column
# mode, a grid of blocks above
@pytest.mark.parametrize("n", [2, 33, 1025, 4096, 4097, 5120, 5121])
def test_greedy_kernel_ragged_sizes_last_start(cuda_device, n):
    pts = torch.as_tensor(sphere(n, 9), device=cuda_device)
    I = fields.dipole_interaction_matrix(pts)
    for rows, kernel, plain in [
            (True, lambda: propagate_cuda.greedy_rows(I, n - 1),
             lambda: propagate.greedy_rows_plain(I, n - 1)),
            (False, lambda: propagate_cuda.greedy_columns(pts, n - 1, 1e-6),
             lambda: propagate.greedy_columns_plain(pts, n - 1, 1e-6))]:
        got = kernel()
        one_block = propagate_cuda.last_launch()["blocks"] == 1
        want = plain()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert one_block == (n <= propagate_cuda.one_block_max_n(
            "rows" if rows else "columns"))


def test_wrappers_check_their_inputs(cuda_device):
    pts = torch.as_tensor(sphere(64, 5), device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        fields_cuda.potential(pts.double(), pts[:, :3].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        fields_cuda.dipole_imatrix(pts.t().contiguous().t(), pts, 1e-6)
    with pytest.raises(ValueError, match="shape"):
        propagate_cuda.greedy_columns(pts[:, :3].contiguous(), 0, 1e-6)
    with pytest.raises(ValueError, match="starting point"):
        propagate_cuda.greedy_rows(fields.dipole_interaction_matrix(pts), 64)
    with pytest.raises(ValueError, match="symmetric"):
        fields_cuda.xie_imatrix(pts[:10].contiguous(), pts, 3.0, symmetric=True)
    with pytest.raises(ValueError, match="symmetric"):
        fields_cuda.dipole_imatrix(pts[:10].contiguous(), pts, 1e-6, symmetric=True)
    # the key's index field holds 2^24 points: the wrapper and the C entry
    # point refuse more
    big = torch.zeros((2**24 + 1, 6), device=cuda_device)
    with pytest.raises(ValueError, match="2\\^24"):
        propagate_cuda.greedy_columns(big, 0, 1e-6)
    with pytest.raises(RuntimeError, match="dipole_greedy: CUDA error"):
        propagate_cuda._launch(big.t().contiguous(), 2**24 + 1, 0, 1e-6, "columns", 0, 0)


def test_main_path_takes_kernels_only(cuda_device):
    for counts in (fields_cuda.LAUNCHES, propagate_cuda.LAUNCHES,
                   fields.PLAIN_CUDA_CALLS, propagate.PLAIN_CUDA_CALLS):
        counts.update({k: 0 for k in counts})
    api.orient_simple(sphere(500, 6), device=cuda_device)
    assert fields_cuda.LAUNCHES == {"dipole_potential": 1, "dipole_imatrix": 1,
                                    "dipole_field": 0, "dipole_group": 0,
                                    "xie_imatrix": 0, "field_mxu_exact": 0,
                                    "field_mxu_expansion": 0}
    assert propagate_cuda.LAUNCHES == {"greedy_rows": 1, "greedy_columns": 0,
                                       "greedy_xie": 0, "replay": 0,
                                       "greedy_columns_batched": 0,
                                       "replay_batched": 0}
    assert not any(fields.PLAIN_CUDA_CALLS.values())
    assert not any(propagate.PLAIN_CUDA_CALLS.values())


def _host_search(pos, k, radius):
    """The host route's neighbourhoods: native.knn, then the radius filter
    (outside: index 0, +inf)."""
    from dipole_tpu_torch import native

    idx, d2 = native.knn(pos, pos, k)
    inside = d2 <= neighbors_cuda.radius_sq(radius)
    return np.where(inside, idx, 0), np.where(inside, d2, np.inf)


@pytest.mark.parametrize("n", [3000, 10000, 180000])
def test_estimate_normals_on_card_matches_cpu(cuda_device, n):
    """The card route (csrc/radius_knn.cu) against the host route (the
    KD-tree) on a 3000-point sphere and on the benchmark's ellipsoid at
    10000 and 180000 points: the same in-radius neighbourhoods up to ties of
    d2 within a few ulps, and where they are the same, normals within 1e-5
    up to the sign of each row. The call is counted on the card route and
    launches the kernel, no plain version."""
    pos = sphere(3000, 7)[:, :3] * 0.4 if n == 3000 else ellipsoid(n, n)
    for counts in (estimate.ROUTES, neighbors_cuda.LAUNCHES, neighbors.PLAIN_CUDA_CALLS):
        counts.update({k: 0 for k in counts})
    got = estimate.estimate_normals(pos, device=cuda_device)
    assert estimate.ROUTES == {"card": 1, "host": 0}
    assert neighbors_cuda.LAUNCHES["radius_knn"] == 1
    assert not any(neighbors.PLAIN_CUDA_CALLS.values())
    want = estimate.estimate_normals(pos, device="cpu")
    card = [x.cpu().numpy() for x in neighbors_cuda.radius_knn(
        torch.as_tensor(pos, device=cuda_device), 30, 0.1)]
    tied = differing_rows_are_ties(pos, card, _host_search(pos, 30, 0.1),
                                   neighbors_cuda.radius_sq(0.1))
    same = np.ones(n, bool)
    same[tied] = False
    d = np.minimum(np.abs(got[:, 3:] - want[:, 3:]).max(1),
                   np.abs(got[:, 3:] + want[:, 3:]).max(1))
    assert d[same].max() <= 1e-5                # up to the sign of each row
    np.testing.assert_array_equal(got[:, :3], want[:, :3])


def _radius_cloud(name):
    """(positions, radius) of a case of the radius search: each cloud of
    tests/neighbour_clouds.py, and shapes the grid must survive: a flat
    cloud (one cell thick), points on a line, every point equal, and radii
    that hold only the point itself or every point."""
    r = np.random.default_rng(len(name))
    if name in CLOUDS:
        return cloud(name), 0.1
    if name == "flat":
        pos = ellipsoid(5000, 9)
        pos[:, 2] = 0.0
    elif name == "line":
        pos = np.zeros((3000, 3), np.float32)
        pos[:, 0] = r.uniform(-1.0, 1.0, 3000)
    elif name == "all equal":
        pos = np.full((500, 3), 0.3, np.float32)
    elif name == "only self":
        return ellipsoid(5000, 10), 1e-4
    elif name == "every point":
        return ellipsoid(2000, 11), 10.0
    return pos, 0.1


@pytest.mark.parametrize("k", [1, 10, 16, 30, 33, 64])
@pytest.mark.parametrize("name", [*CLOUDS, "flat", "line", "all equal", "only self",
                                  "every point"])
def test_radius_knn_kernel_is_bit_equal(cuda_device, name, k):
    pos, radius = _radius_cloud(name)
    pos = torch.as_tensor(pos, device=cuda_device)
    got = neighbors_cuda.radius_knn(pos, k, radius)
    want = neighbors_cuda.radius_knn_plain(pos, k, radius)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert_sorted_and_padded(got[0].cpu().numpy(), got[1].cpu().numpy())


@pytest.mark.parametrize("n", [10000, 180000])
def test_radius_knn_kernel_is_bit_equal_at_the_main_path_sizes(cuda_device, n):
    """The benchmark's two sizes: a served request's 10000 points and a
    batch call's 180000, k = 30, radius 0.1."""
    pos = torch.as_tensor(ellipsoid(n, n + 1), device=cuda_device)
    got = neighbors_cuda.radius_knn(pos, 30, 0.1)
    want = neighbors_cuda.radius_knn_plain(pos, 30, 0.1)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_radius_knn_wrapper_checks_its_inputs(cuda_device):
    pos = torch.as_tensor(ellipsoid(100, 12), device=cuda_device)
    for k in (0, neighbors_cuda.RADIUS_MAX_K + 1):
        with pytest.raises(ValueError, match="k must be"):
            neighbors_cuda.radius_knn(pos, k, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        neighbors_cuda.radius_knn(pos.cpu(), 30, 0.1)
    with pytest.raises(ValueError, match="shape"):
        neighbors_cuda.radius_knn(pos[:, :2].contiguous(), 30, 0.1)
    idx, d2 = neighbors_cuda.radius_knn(pos[:0], 30, 0.1)
    assert idx.shape == d2.shape == (0, 30)


def test_public_neighbour_names_run_numpy_on_the_card(cuda_device):
    """knn, knn_graph, fps, knn_interpolate and rotate_to_principle_components
    put a numpy input on the card by default, with the CPU's answers."""
    pos = sphere(500, 11)[:, :3].astype(np.float32)
    x = np.random.default_rng(3).normal(size=(500, 4)).astype(np.float32)
    pairs = [(neighbors.knn(pos, pos[:77], 8)[0], neighbors.knn(pos, pos[:77], 8, device="cpu")[0]),
             (neighbors.knn_graph(pos, 6), neighbors.knn_graph(pos, 6, device="cpu")),
             (neighbors.fps(pos, 0.3), neighbors.fps(pos, 0.3, device="cpu"))]
    for got, want in pairs:
        assert got.device.type == "cuda"
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    got = neighbors.knn_interpolate(x, pos, pos[:50], 8)
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(),
                               neighbors.knn_interpolate(x, pos, pos[:50], 8,
                                                         device="cpu").numpy(),
                               rtol=0, atol=1e-6 * np.abs(x).max())
    flat = pos * np.float32([1.0, 0.5, 0.2])    # well-separated eigenvalues
    got = estimate.rotate_to_principle_components(flat)
    assert got.device.type == "cuda"
    want = estimate.rotate_to_principle_components(flat, device="cpu").numpy()
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("cols", [6, 3])
def test_orient_simple_on_card_matches_cpu(cuda_device, cols):
    pc = sphere(3000, 8)
    if cols == 3:
        pc = pc[:, :3] * 0.4
    got = api.orient_simple(pc, diffuse=True, device=cuda_device)
    want = api.orient_simple(pc, diffuse=True, device="cpu")
    same = ((got[:, 3:] * want[:, 3:]).sum(1) > 0).mean()
    # 6 columns: the same matrix bits, the same decisions; 3 columns: the
    # PCA normals may differ in the last bits between devices
    assert same == 1.0 if cols == 6 else same >= 0.999


def _host_staged(pc, diffuse, estimate_normals, dev):
    """orient_simple's stages with numpy between them (the host route, as
    orient_simple ran them on the card before its card route; the
    propagation as its numpy formula), and the mean potential the sign fix
    read."""
    if estimate_normals or pc.shape[1] == 3:
        pc = estimate.estimate_normals(pc, device=dev)
    pc, transform = Transform.trans(pc)
    pc = host_propagation(pc, diffuse, dev)
    mean = fields.measure_mean_potential(pc, device=dev)
    return transform.inverse(api._sign_fix(pc, timer_factory(), dev)), mean


def _card_route_cloud(case):
    """(cloud, whether the sign fix flips it) of a card-route case: a
    scrambled sphere with normals (its first point's normal outward or
    inward, which decides the sign fix), the benchmark's ellipsoid as
    positions, or every point equal."""
    n = 12000 if "column tier" in case else 3000
    if "zero extent" in case:
        pc = np.tile(np.float32([[0.3, -0.2, 0.1, 0.0, 0.6, 0.8]]), (64, 1))
    elif "3 columns" in case:
        pc = ellipsoid(n, n + 5)
    else:
        pc = sphere(n, n + 6)
        pc[0, 3:] = pc[0, :3] * (-1.0 if "flipped" in case else 1.0)
    if "3 columns" in case:
        pc = pc[:, :3].copy()
    return pc, "flipped" in case


@pytest.mark.parametrize("diffuse", [False, True])
@pytest.mark.parametrize("case", ["6 columns", "6 columns flipped", "3 columns",
                                  "6 columns column tier", "6 columns column tier flipped",
                                  "3 columns column tier", "zero extent",
                                  "zero extent 3 columns", "estimate on 6 columns",
                                  "estimate on 6 columns column tier"])
def test_orient_simple_card_route_is_bit_identical_to_host_staged(cuda_device, case,
                                                                  diffuse):
    """orient_simple's card route (one upload, one copy back) against its
    stages run with numpy between them on the same card: the same bits, on
    both greedy tiers (3000 <= MATRIX_LIMIT < 12000 points), with and
    without the diffuse re-vote, where the sign fix flips the cloud, where
    every point is the same, and where normals are given but estimated
    anew. The call is counted on the card route."""
    pc, flipped = _card_route_cloud(case)
    est = case.startswith("estimate")
    api.ORIENT_SIMPLE_ROUTES.update(card=0, host=0)
    got = api.orient_simple(pc, diffuse=diffuse, estimate=est, device=cuda_device)
    assert api.ORIENT_SIMPLE_ROUTES == {"card": 1, "host": 0}
    want, mean = _host_staged(pc, diffuse, est, cuda_device)
    assert got.dtype == np.float32 and got.shape == (len(pc), 6)
    np.testing.assert_array_equal(got, want)
    if case.startswith("6 columns"):
        assert (mean < 0) == flipped


# (1, 1) and (32, 700): one chunk, one launch; (505, 499): a graph_dipole
# edge, cut into chunks of 32; 512 and 513 targets: one block of targets
# (4 a thread) and one more
@pytest.mark.parametrize("n_src,n_tgt", [(1, 1), (32, 700), (505, 499), (2047, 129),
                                         (2049, 4000), (4097, 512), (4097, 513),
                                         (9000, 300)])
def test_field_kernel_matches_plain(cuda_device, n_src, n_tgt):
    src = torch.as_tensor(sphere(n_src, 10), device=cuda_device)
    tgt = torch.as_tensor(sphere(n_tgt, 11)[:, :3] * 1.2, device=cuda_device)
    tgt[0] = src[0, :3]                          # a target on a source
    k = fields.field_grad(src, tgt)
    p = fields.field_grad_plain(src, tgt, 1e-5)
    # sums in other orders: rtol 1e-4 per component, plus 1e-5 of max|E|
    torch.testing.assert_close(k, p, rtol=1e-4, atol=1e-5 * float(p.abs().max()) + 1e-30)
    assert bool(torch.isfinite(k).all())


def _group_check(pts, gid, G, w=None):
    """csrc/group.cu against its plain version, 1e-4 of sum |I| per entry
    (the one-hot product sums in another order, the kernel takes
    approximate roots); every entry finite."""
    dev = pts.device
    k = fields.point_group_interaction(pts, gid, G, source_weights=w)
    wp = pts.clone()
    if w is not None:
        wp[:, 3:6] *= w[:, None]
    p = fields.point_group_interaction_plain(wp, gid, G, 1e-5)
    keep = (gid >= 0) & (gid < G)
    onehot = torch.zeros((len(gid), G), device=dev)
    onehot[torch.nonzero(keep)[:, 0], gid[keep]] = 1.0
    scale = torch.cat([fields.dipole_interaction_matrix_plain(wp[b:b + 2048], wp, 1e-5).abs()
                       @ onehot for b in range(0, len(wp), 2048)])
    assert k.shape == (len(pts), G) and bool(torch.isfinite(k).all())
    assert bool(((k - p).abs() <= 1e-4 * scale).all())
    return k


@pytest.mark.parametrize("n,G", [(1, 1), (129, 3), (3000, 40)])
def test_group_kernel_matches_plain(cuda_device, n, G):
    pts = torch.as_tensor(sphere(n, 12), device=cuda_device)
    if n > 100:
        pts[n - 50:] = pts[:50]                  # coincident pairs
    r = np.random.default_rng(n)
    gid = torch.as_tensor(r.integers(-1, G + 1, n), device=cuda_device)
    w = torch.as_tensor(r.uniform(0.1, 1.0, n).astype(np.float32), device=cuda_device)
    k = fields.point_group_interaction(pts, gid, G, source_weights=w)
    wp = pts.clone()
    wp[:, 3:6] *= w[:, None]
    p = fields.point_group_interaction_plain(wp, gid, G, 1e-5)
    I = fields.dipole_interaction_matrix_plain(wp, wp, 1e-5).abs()
    keep = (gid >= 0) & (gid < G)
    onehot = torch.zeros((n, G), device=cuda_device)
    onehot[torch.nonzero(keep)[:, 0], gid[keep]] = 1.0
    # the one-hot product sums in another order: 1e-4 of sum |I| per entry
    assert bool(((k - p).abs() <= 1e-4 * (I @ onehot)).all())


def _group_case(case, dev):
    """(pts, gid, G) of a named edge case of the group kernel's design."""
    r = np.random.default_rng(len(case))
    n = {"hand shape": 10000, "one group": 5000, "one-point groups": 1500}.get(case, 3000)
    pts = torch.as_tensor(sphere(n, 40 + len(case)), device=dev)
    if case == "larger than a tile":             # 1500 sources a group, tiles of 256
        gid = np.arange(n) % 2
    elif case == "one-point groups":             # G = n: many groups a block
        gid = r.permutation(n)
    elif case == "one group":
        gid = np.zeros(n, np.int64)
    elif case == "empty and outside":            # groups 0, 5 and 39 empty
        gid = r.integers(1, 39, n)
        gid[gid == 5] = 6
        gid[:100], gid[100:200] = -3, 40
    elif case == "coincident points":            # a third duplicates, zero pairs
        pts[2000:] = pts[:1000]
        gid = r.integers(0, 40, n)
    elif case == "ragged targets":               # n not a multiple of 4 or 512
        pts = pts[:2049]
        gid = r.integers(0, 40, 2049)
    elif case == "chunk edges":                  # groups straddle the chunks of 256
        sizes = [300, 0, 212, 256, 1, 255, 257, 0, 519] + [100] * 12
        gid = np.repeat(np.arange(len(sizes)), sizes)[r.permutation(3000)]
    else:                                        # hand shape: ~10k points, ~40 patches
        gid = r.integers(0, 40, n)
    G = {"one-point groups": n, "one group": 1}.get(case, int(gid.max()) + 1)
    if case == "empty and outside":
        G = 40
    return pts, torch.as_tensor(gid, device=dev), G


@pytest.mark.parametrize("case", ["larger than a tile", "one-point groups", "one group",
                                  "empty and outside", "coincident points",
                                  "ragged targets", "chunk edges", "hand shape"])
def test_group_kernel_edge_cases(cuda_device, case):
    pts, gid, G = _group_case(case, cuda_device)
    r = np.random.default_rng(7)
    w = torch.as_tensor(r.uniform(0.1, 1.0, len(pts)).astype(np.float32),
                        device=cuda_device)
    k = _group_check(pts, gid, G, w if case in ("coincident points", "chunk edges") else None)
    if case == "empty and outside":
        assert bool((k[:, [0, 5, 39]] == 0).all())


@pytest.mark.parametrize("b,nd,ns,k,nsent", [(1, 1, 1, 1, 0), (3, 185, 308, 16, 10),
                                             (2, 512, 512, 20, 40), (2, 64, 10, 16, 0),
                                             (1, 33, 2048, 32, 0)])
def test_knn_kernel_is_bit_equal(cuda_device, b, nd, ns, k, nsent):
    r = np.random.default_rng(nd + ns)
    src = r.normal(size=(b, ns, 3)).astype(np.float32)
    src[:, ns // 2:ns // 2 + ns // 8] = src[:, :ns // 8]
    if nsent:
        src[:, -nsent:] = 1.0e6
    dst = r.normal(size=(b, nd, 3)).astype(np.float32)
    dst[:, :min(nd, ns)] = src[:, :min(nd, ns)]
    dst, src = torch.as_tensor(dst, device=cuda_device), torch.as_tensor(src, device=cuda_device)
    got = neighbors.knn_with_dist(dst, src, k)
    want = neighbors.knn_with_dist_plain(dst, src, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# the PointCNN forward's five kNN calls (rows <- sources): k = 20 self
# searches, k = 16 interpolations
KNN_FORWARD = [(512, 512), (308, 308), (185, 185), (308, 185), (512, 308)]


def _knn_ties(kind, nd, ns, b=3):
    """Exact distance ties: points of an 8^3 integer lattice, or random
    points whose second half duplicates the first; the queries are the
    sources for a self search, else more rows drawn from the same points."""
    r = np.random.default_rng(nd * ns)
    if kind == "lattice":
        lat = np.stack(np.meshgrid(*[np.arange(8.0)] * 3, indexing="ij"), -1)
        lat = lat.reshape(-1, 3).astype(np.float32)
        src = np.stack([lat[r.permutation(512)[:ns]] for _ in range(b)])
        dst = src if nd == ns else np.stack([lat[r.permutation(512)[:nd]]
                                             for _ in range(b)])
    else:
        src = r.normal(size=(b, ns, 3)).astype(np.float32)
        src[:, ns - ns // 2:] = src[:, :ns // 2]
        dst = src if nd == ns else np.concatenate(
            [src, src[:, r.integers(0, ns, nd - ns)]], axis=1)
    return np.ascontiguousarray(dst), np.ascontiguousarray(src)


@pytest.mark.parametrize("k", [1, 16, 20, 32])
@pytest.mark.parametrize("kind", ["lattice", "duplicated half"])
@pytest.mark.parametrize("nd,ns", KNN_FORWARD)
def test_knn_kernel_ties_at_forward_shapes(cuda_device, nd, ns, kind, k):
    dst, src = (torch.as_tensor(a, device=cuda_device) for a in _knn_ties(kind, nd, ns))
    want = neighbors.knn_with_dist_plain(dst, src, k)
    got = neighbors_cuda.knn_with_dist(dst, src, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("b,nd,ns,k", [(2, 40, 8192, 20), (1, 257, 8192, 32),
                                       (3, 185, 12, 20), (2, 300, 7, 32)])
def test_knn_kernel_most_sources_and_k_above_sources(cuda_device, b, nd, ns, k):
    """8192 sources (the kernel's most), and k > Ns: once a row is spent the
    remaining slots are (index 0, +inf), as the scan gives."""
    r = np.random.default_rng(ns + k)
    src = r.normal(size=(b, ns, 3)).astype(np.float32)
    src[:, ns // 2:ns // 2 + ns // 8] = src[:, :ns // 8]
    dst = r.normal(size=(b, nd, 3)).astype(np.float32)
    dst, src = torch.as_tensor(dst, device=cuda_device), torch.as_tensor(src, device=cuda_device)
    want = neighbors.knn_with_dist_plain(dst, src, k)
    got = neighbors_cuda.knn_with_dist(dst, src, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if k > ns:
        assert bool((got[0][..., ns:] == 0).all())
        assert bool(torch.isinf(got[1][..., ns:]).all())


def _fps_args(b, n, m, dev, kind):
    r = np.random.default_rng(n + m)
    pos = r.normal(size=(b, n, 3)).astype(np.float32)
    if kind == "duplicates":                     # every point twice: exact ties
        pos[:, n - n // 2:] = pos[:, :n // 2]
    elif kind == "all equal":
        pos[:] = pos[:, :1]
    elif kind == "lattice":                      # small integer distances
        pos = r.integers(0, 4, size=(b, n, 3)).astype(np.float32)
    nv = r.integers(1, n + 1, b)
    nv[0] = max(1, min(n, m // 2))               # fewer valid points than picks
    valid = np.arange(n)[None, :] < nv[:, None]
    pos[~valid] = 1.0e6
    starts = (r.integers(0, 1 << 30, b) % nv).astype(np.int32)
    return (torch.as_tensor(pos, device=dev), torch.as_tensor(valid, device=dev), m,
            torch.as_tensor(starts, device=dev))


@pytest.mark.parametrize("b,n,m", [(1, 1, 1), (5, 129, 78), (3, 1024, 615), (2, 8192, 40)])
def test_fps_kernel_is_bit_equal(cuda_device, b, n, m):
    r = np.random.default_rng(n + m)
    pos = r.normal(size=(b, n, 3)).astype(np.float32)
    nv = r.integers(1, n + 1, b)
    valid = np.arange(n)[None, :] < nv[:, None]
    pos[~valid] = 1.0e6
    starts = (r.integers(0, 1 << 30, b) % nv).astype(np.int32)
    args = (torch.as_tensor(pos, device=cuda_device),
            torch.as_tensor(valid, device=cuda_device), m,
            torch.as_tensor(starts, device=cuda_device))
    assert torch.equal(neighbors.fps_masked_batch(*args),
                       neighbors.fps_masked_batch_plain(*args))


@pytest.mark.parametrize("kind", ["random", "duplicates", "all equal", "lattice"])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 308, 512, 513, 1024, 8192])
def test_fps_kernel_warp_boundaries_and_ties(cuda_device, n, kind):
    """Each boundary of the block plan (neighbors_cuda.fps_plan: points a
    lane, warps a patch) with exact distance ties, m = 1 and m > n."""
    for m in (1, min(n, 300) * 6 // 10 + 1, n + 3):
        args = _fps_args(4, n, m, cuda_device, kind)
        assert torch.equal(neighbors_cuda.fps_masked_batch(*args),
                           neighbors.fps_masked_batch_plain(*args)), (n, m, kind)


def test_patch_wrappers_check_their_inputs(cuda_device):
    pos = torch.zeros((2, 16, 3), device=cuda_device)
    with pytest.raises(ValueError, match="k must be"):
        neighbors_cuda.knn_with_dist(pos, pos, 33)
    with pytest.raises(ValueError, match="sources"):
        neighbors_cuda.knn_with_dist(pos, torch.zeros((2, 9000, 3), device=cuda_device), 4)
    valid = torch.ones((2, 16), dtype=torch.bool, device=cuda_device)
    # host starts outside the patch are refused; the card's are not read
    # back: the kernel traps (see below)
    with pytest.raises(ValueError, match="starts"):
        neighbors.fps_masked_batch(pos, valid, 4, torch.tensor([0, 16], dtype=torch.int32))
    with pytest.raises(ValueError, match="points"):
        neighbors_cuda.fps_masked_batch(
            torch.zeros((1, 8193, 3), device=cuda_device),
            torch.ones((1, 8193), dtype=torch.bool, device=cuda_device), 4,
            torch.zeros(1, dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError, match="group_ids"):
        fields_cuda.point_group(torch.zeros((4, 6), device=cuda_device),
                                torch.zeros(3, dtype=torch.int64, device=cuda_device), 2, 1e-5)


@pytest.mark.parametrize("bad", [16, -1])
def test_fps_kernel_refuses_a_start_outside_the_patch(cuda_device, bad):
    """The FPS wrapper does not read the starts back; the kernel traps on a
    start outside [0, n), and the stream's next synchronisation raises. A
    trap spoils the process's CUDA context, so the launch runs in a child
    process."""
    code = ("import torch\n"
            "from dipole_tpu_torch.ops import neighbors_cuda\n"
            "pos = torch.zeros((2, 16, 3), device='cuda')\n"
            "valid = torch.ones((2, 16), dtype=torch.bool, device='cuda')\n"
            f"st = torch.tensor([0, {bad}], dtype=torch.int32, device='cuda')\n"
            "neighbors_cuda.fps_masked_batch(pos, valid, 4, st)\n"
            "torch.cuda.synchronize()\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode != 0 and "unspecified launch failure" in run.stderr, \
        run.stdout[-2000:] + run.stderr[-2000:]


def test_patch_pipelines_take_kernels_only(cuda_device):
    counts = (fields_cuda.LAUNCHES, neighbors_cuda.LAUNCHES,
              fields.PLAIN_CUDA_CALLS, neighbors.PLAIN_CUDA_CALLS)
    for c in counts:
        c.update({k: 0 for k in c})
    pc = sphere(1500, 13)
    kw = dict(models=[CKPT], number_parts=5, minimum_points_per_patch=40, iters=1)
    api.orient_patches(pc, propagation_iters=1, device=cuda_device, **kw)
    api.orient_large(pc, device=cuda_device, **{**kw, "number_parts": 3})
    assert fields_cuda.LAUNCHES["dipole_group"] >= 3
    assert fields_cuda.LAUNCHES["dipole_field"] >= 1
    assert neighbors_cuda.LAUNCHES["knn"] >= 5 and neighbors_cuda.LAUNCHES["fps"] >= 2
    assert not any(fields.PLAIN_CUDA_CALLS.values())
    assert not any(neighbors.PLAIN_CUDA_CALLS.values())


def test_orient_patches_on_card_near_cpu(cuda_device):
    pc = sphere(1500, 14)
    kw = dict(models=[CKPT], number_parts=5, minimum_points_per_patch=40, iters=2,
              propagation_iters=1, diffuse=True, weighted_prop=True)
    got = api.orient_patches(pc, device=cuda_device, **kw)
    want = api.orient_patches(pc, device="cpu", **kw)
    assert ((got[:, 3:] * want[:, 3:]).sum(1) > 0).mean() >= 0.99


def _ellipsoid(n, seed):
    r = np.random.default_rng(seed)
    v = r.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    a = np.array([1.0, 0.7, 0.5])
    nrm = v / a
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return np.concatenate([v * a, nrm], axis=1).astype(np.float32)


# sizes about the kernel's 64-point tile: 1, 63, 64, 65 and 150 (over two
# tiles, no multiple); targets = sources (symmetric mode: each pair's
# terms give both I[i, j] and I[j, i]) and 333 other targets (general)
@pytest.mark.parametrize("n,C", [(1, 3.0), (63, 3.0), (64, 2.5), (65, 3.0),
                                 (150, 2.5), (1000, 3.0), (2049, 2.5)])
def test_xie_matrix_kernel_is_bit_equal_in_both_layouts(cuda_device, n, C):
    pc = torch.as_tensor(sphere(n, 15), device=cuda_device)
    dup = min(50, n // 3)
    if n > 40:
        pc[n - dup:] = pc[:dup]                  # coincident pairs: n . n
        pc[dup, :3] = 0.0                        # a pair 1e-20 apart, whose
        pc[dup + 1, :3] = torch.tensor([1e-20, 0.0, 0.0])   # entry overflows: 0
    tgt = torch.as_tensor(sphere(333, 16), device=cuda_device) * 1.5
    for targets in (None, tgt):
        t = pc if targets is None else targets
        I = fields.xie_interaction_matrix(pc, C=C, targets=targets)
        IT = fields.xie_interaction_matrix(pc, C=C, targets=targets, transposed=True)
        assert torch.equal(I, fields.xie_interaction_matrix_plain(t, pc, C))
        assert torch.equal(IT, fields.xie_interaction_matrix_plain(t, pc, C, True))
        assert torch.equal(IT, I.t())
    if n > 40:
        I = fields.xie_interaction_matrix(pc, C=C)
        assert float(I[dup, dup + 1]) == 0.0 and float(I[dup + 1, dup]) == 0.0
        assert not torch.equal(I, I.t())


def _xie_check(pc, start, k, device, *, blocks=0, zeros=False):
    """The xie greedy kernel against its plain version on cloud pc (with a
    k-nearest mask if k), bit for bit; returns (acc, launch)."""
    from dipole_tpu_torch.ops.propagate import _knn_idx

    IT = fields.xie_interaction_matrix(torch.as_tensor(pc, device=device),
                                       transposed=True)
    if zeros:
        # most entries 0 and some -0: many acc values tie at 0
        r = np.random.default_rng(len(pc))
        IT[torch.as_tensor(r.random(IT.shape) < 0.9, device=device)] = 0.0
        IT[torch.as_tensor(r.random(IT.shape) < 0.05, device=device)] = -0.0
    knn = torch.as_tensor(_knn_idx(pc, k), device=device) if k else None
    got = propagate_cuda.xie_greedy(IT, start, knn, _blocks=blocks)
    launch = propagate_cuda.last_launch()
    want = propagate.xie_greedy_plain(IT, start, knn)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    return got[0], launch


@pytest.mark.parametrize("n,k", [(2, 0), (3072, 8), (5000, 0), (5000, 8)])
def test_xie_greedy_kernel_is_bit_equal(cuda_device, n, k):
    _, launch = _xie_check(sphere(n, 17), n - 1, k, cuda_device)
    assert (launch["blocks"] > 1) == (n > propagate_cuda.one_block_max_n("xie"))


@pytest.mark.parametrize("k", [0, 8])
@pytest.mark.parametrize("side", [-1, 0, 1])
def test_xie_greedy_kernel_one_block_limit(cuda_device, side, k):
    """Both sides of the xie mode's one-block limit: one block up to it, a
    grid above."""
    n = propagate_cuda.one_block_max_n("xie") + side
    _, launch = _xie_check(sphere(n, 17), n - 1, k, cuda_device)
    assert (launch["blocks"] == 1) == (side <= 0)


@pytest.mark.parametrize("k", [0, 8])
@pytest.mark.parametrize("n,blocks", [(2, 0), (3000, 0), (3000, 4), (20000, 0)])
def test_xie_greedy_kernel_ties_across_blocks(cuda_device, n, blocks, k):
    """Point i + n/2 duplicates point i, in another block once there are
    several: their acc tie exactly until the lower index is picked."""
    pc = sphere(n, 24)
    pc[n // 2:] = pc[:n // 2]
    acc, launch = _xie_check(pc, 1 if n > 2 else 0, k, cuda_device, blocks=blocks)
    if blocks:
        assert launch["blocks"] == blocks
    if not k:          # (a kNN mask may keep one twin and not the other)
        assert torch.equal(acc[:n // 2], acc[n // 2:])


@pytest.mark.parametrize("k", [0, 8])
@pytest.mark.parametrize("blocks", [1, 5])
def test_xie_greedy_kernel_many_zero_entries(cuda_device, blocks, k):
    _xie_check(sphere(4500, 27), 9, k, cuda_device, blocks=blocks, zeros=True)


# 50 orders: more than the 48 lanes of one blocked loop (csrc/replay.cu)
@pytest.mark.parametrize("T,masked,weighted", [(1, False, False), (3, True, False),
                                               (9, False, True), (17, True, True),
                                               (50, False, True)])
def test_replay_kernel_takes_the_plain_decisions(cuda_device, T, masked, weighted):
    from dipole_tpu_torch.ops.propagate import _knn_idx

    n = 700
    pc = sphere(n, 18)
    r = np.random.default_rng(T)
    I = fields.xie_interaction_matrix(torch.as_tensor(pc, device=cuda_device))
    knn = torch.as_tensor(_knn_idx(pc, 8), device=cuda_device) if masked else None
    colw = (torch.as_tensor(r.uniform(0.2, 1.0, n).astype(np.float32),
                            device=cuda_device) if weighted else None)
    # one block of 128 steps, and 700 and 1500 steps (no multiple of it;
    # 1500 visits every index again)
    for steps in (128, 700, 1500):
        orders = torch.as_tensor(np.stack([np.concatenate(
            [r.permutation(n), r.permutation(n), r.permutation(n)])[:steps]
            for _ in range(T)]), device=cuda_device)
        w_p, i_p = propagate.replay_plain(I, orders, knn, colw)
        w_k, i_k = propagate_cuda.replay(I, orders, knn, colw)
        assert torch.equal(w_k, w_p) and torch.equal(i_k < 0, i_p < 0)
        # float64 sums in two orders: 1e-6 of the largest recorded |inter|
        assert float((i_k - i_p).abs().max()) <= 1e-6 * float(i_p.abs().max())


@pytest.mark.parametrize("kind", ["repeats", "short", "few"])
@pytest.mark.parametrize("masked", [False, True])
def test_replay_kernel_repeats_and_short_orders(cuda_device, kind, masked):
    """Orders that visit an index again (inside one block of steps and
    across blocks: the later visit overwrites), orders shorter than N, and
    orders over a handful of indices (many repeats in every block)."""
    from dipole_tpu_torch.ops.propagate import _knn_idx

    n = 600
    pc = sphere(n, 25)
    r = np.random.default_rng(26)
    I = fields.dipole_interaction_matrix(torch.as_tensor(pc, device=cuda_device))
    if kind == "repeats":
        orders = r.integers(0, n, (3, 900))
        orders[:, 500:540] = orders[:, 10:50]
        orders[:, 60:70] = orders[:, 50:60]
    elif kind == "short":
        orders = np.stack([r.permutation(n)[:211] for _ in range(3)])
    else:
        orders = r.integers(0, 7, (3, 300))
    orders = torch.as_tensor(orders, device=cuda_device)
    knn = torch.as_tensor(_knn_idx(pc, 8), device=cuda_device) if masked else None
    colw = torch.as_tensor(r.uniform(0.2, 1.0, n).astype(np.float32), device=cuda_device)
    w_p, i_p = propagate.replay_plain(I, orders, knn, colw)
    w_k, i_k = propagate_cuda.replay(I, orders, knn, colw)
    assert torch.equal(w_k, w_p) and torch.equal(i_k < 0, i_p < 0)
    assert float((i_k - i_p).abs().max()) <= 1e-6 * float(i_p.abs().max())


def test_xie_wrappers_check_their_inputs(cuda_device):
    I = fields.xie_interaction_matrix(torch.as_tensor(sphere(64, 19), device=cuda_device))
    with pytest.raises(ValueError, match="square"):
        propagate_cuda.xie_greedy(I[:10].contiguous(), 0)
    with pytest.raises(ValueError, match="starting point"):
        propagate_cuda.xie_greedy(I, 64)
    with pytest.raises(ValueError, match="at most 256"):
        propagate_cuda.xie_greedy(I, 0, torch.zeros((64, 300), dtype=torch.int64,
                                                     device=cuda_device))
    # one block holds at most 8192 points in registers
    with pytest.raises(RuntimeError, match="dipole_greedy: CUDA error"):
        propagate_cuda.xie_greedy(
            fields.xie_interaction_matrix(torch.as_tensor(sphere(8193, 19),
                                                          device=cuda_device),
                                          transposed=True), 0, _blocks=1)
    with pytest.raises(ValueError, match="outside"):
        propagate_cuda.replay(I, torch.full((1, 64), 64, device=cuda_device))
    with pytest.raises(MemoryError, match="needs 4000.00 GB"):
        fields_cuda.matrix_out(10**6, 10**6, cuda_device, "xie_imatrix")


def test_xie_paths_take_kernels_only(cuda_device):
    from dipole_tpu_torch.ops import propagate as prop

    counts = (fields_cuda.LAUNCHES, propagate_cuda.LAUNCHES,
              fields.PLAIN_CUDA_CALLS, prop.PLAIN_CUDA_CALLS)
    for c in counts:
        c.update({k: 0 for k in c})
    pc = _ellipsoid(3000, 20)[:, :3]
    for method in ("xie", "tree_xie"):
        api.orient(pc, method=method, device=cuda_device)
    assert fields_cuda.LAUNCHES["xie_imatrix"] == 2
    assert propagate_cuda.LAUNCHES["greedy_xie"] == 1
    assert propagate_cuda.LAUNCHES["replay"] == 1
    assert not any(fields.PLAIN_CUDA_CALLS.values())
    assert not any(prop.PLAIN_CUDA_CALLS.values())


@pytest.mark.parametrize("method", ["xie", "tree_xie", "hoppe"])
def test_orient_xie_methods_on_card_match_cpu(cuda_device, method):
    gt = _ellipsoid(3000, 21)
    got = api.orient(gt[:, :3], method=method, device=cuda_device)
    want = api.orient(gt[:, :3], method=method, device="cpu")
    assert ((got[:, 3:] * want[:, 3:]).sum(1) > 0).mean() >= 0.999


def test_graph_dipole_on_card_near_cpu(cuda_device):
    from dipole_tpu_torch.ops.metrics import sign_agreement
    from dipole_tpu_torch.pipelines import graph_dipole as gd

    gt = sphere(2000, 22, scramble=False)
    scr = sphere(2000, 22)
    out, *_ = gd.graph_dipole_core(scr.copy(), n_part=4, device=cuda_device)
    ref, *_ = gd.graph_dipole_core(scr.copy(), n_part=4, device="cpu")
    assert abs(sign_agreement(out, gt) - sign_agreement(ref, gt)) <= 0.02


def _mxu_data(n_tgt, n_src, apart=0.0, dev="cpu"):
    """The tool's data; with `apart`, targets closer than that to any source
    are moved away (the expansion's cancellation is documented behaviour
    there, not something to match), the distances taken on `dev` in blocks
    of targets."""
    src, tgt, _ = mxu.tool_data(n_tgt, n_src)
    if apart:
        s = torch.as_tensor(src[:, :3], dtype=torch.float64, device=dev)
        t = torch.as_tensor(tgt, dtype=torch.float64, device=dev)
        d = torch.cat([torch.cdist(t[i:i + 16384], s).min(1).values
                       for i in range(0, n_tgt, 16384)])
        tgt[(d < apart).cpu().numpy()] += 10.0
    return src, tgt


def _check_mxu_kernel(dev, kernel, n_tgt, n_src):
    src, tgt = _mxu_data(n_tgt, n_src, apart=0.02 if kernel == "expansion" else 0.0,
                         dev=dev)
    s = torch.as_tensor(src, device=dev)
    t = torch.as_tensor(tgt, device=dev)
    if kernel == "exact" and n_tgt > 16 and n_src > 8:
        t[0] = s[3, :3]                          # a target on a source
        s[n_src - 4:] = s[:4]                    # duplicate sources
    got = getattr(fields_cuda, f"field_mxu_{kernel}")(s, t, 1e-5)
    want = getattr(mxu, f"field_mxu_{kernel}_plain")(s, t, 1e-5)
    # 3xTF32 products and sums in other orders: per target, 1e-5 (exact) and
    # 5e-5 (expansion, whose r^2 cancels; no pair nearer than 0.02) of
    # sum |terms|, chip_smoke.py's limits
    rtol = 1e-5 if kernel == "exact" else 5e-5
    scale = mxu.tolerance_scale(s, t)
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs().double() <= rtol * scale[:, None]).all())


# the edges of csrc/field_mma.cu's tiles and stages: targets in tiles of 16,
# warps of 32 and blocks of 256 (63-65: the second warp's edge; 255-257 and
# 1025: a block's), sources in k-steps of 8 and stages of 128,
# double-buffered (129: one past a stage; 257: one past both buffers)
@pytest.mark.parametrize("kernel", ["exact", "expansion"])
@pytest.mark.parametrize("n_tgt,n_src", [(16, 8), (1, 1), (17, 9), (4096, 3001),
                                         (777, 20000), (63, 1), (64, 7), (65, 8),
                                         (1025, 9), (255, 512), (256, 513),
                                         (257, 129), (1025, 257)])
def test_mxu_field_kernels_match_plain(cuda_device, kernel, n_tgt, n_src):
    _check_mxu_kernel(cuda_device, kernel, n_tgt, n_src)


def _field_mma_chunks(n_src, n_tgt):
    import ctypes

    from dipole_tpu_torch.ops import _build

    _, chunks = _build.entry("field_mma", "dipole_field_mma_chunks",
                             [ctypes.c_int, ctypes.c_int])
    return chunks(n_src, n_tgt)


# both sides of the source axis's cut (common.cuh's chunked::plan): one
# chunk, written straight to the output, then two, added by the finish
# kernel; where few target blocks cut the sources finer (4096 targets) and
# where a chunk's most sources do (300000 targets)
@pytest.mark.parametrize("kernel", ["exact", "expansion"])
@pytest.mark.parametrize("n_tgt,n_src", [(4096, 128), (300000, 8192)])
def test_mxu_field_kernels_across_the_source_cut(cuda_device, kernel, n_tgt, n_src):
    assert _field_mma_chunks(n_src, n_tgt) == 0
    assert _field_mma_chunks(n_src + 1, n_tgt) == 2
    for m in (n_src, n_src + 1):
        _check_mxu_kernel(cuda_device, kernel, n_tgt, m)


@pytest.mark.parametrize("kernel", ["exact", "expansion"])
def test_mxu_field_kernels_repeat_bit_for_bit(cuda_device, kernel):
    src, tgt = _mxu_data(4096, 20000)
    s = torch.as_tensor(src, device=cuda_device)
    t = torch.as_tensor(tgt, device=cuda_device)
    fn = getattr(fields_cuda, f"field_mxu_{kernel}")
    assert _field_mma_chunks(20000, 4096) > 1
    assert torch.equal(fn(s, t, 1e-5), fn(s, t, 1e-5))


def test_mxu_tool_takes_kernels_only(cuda_device):
    for c in (fields_cuda.LAUNCHES, fields.PLAIN_CUDA_CALLS, mxu.PLAIN_CUDA_CALLS):
        c.update({k: 0 for k in c})
    res = mxu.main(n_tgt=1000, n_src=3000, device=cuda_device)
    assert fields_cuda.LAUNCHES["field_mxu_exact"] == 6
    assert fields_cuda.LAUNCHES["field_mxu_expansion"] == 6
    assert fields_cuda.LAUNCHES["dipole_field"] == 6
    assert not any(mxu.PLAIN_CUDA_CALLS.values())
    assert not any(fields.PLAIN_CUDA_CALLS.values())
    assert res["sign_agreement"]["mxu_exact"] >= 0.99
    with pytest.raises(ValueError, match="float32"):
        fields_cuda.field_mxu_exact(torch.zeros((4, 6), dtype=torch.float64,
                                                device=cuda_device),
                                    torch.zeros((2, 3), device=cuda_device), 1e-5)


# the batched entries behind the server's micro-batching (csrc/greedy.cu's
# and csrc/replay.cu's): every lane bit-equal to the launch over its cloud
# alone, and to the plain version

def _tied(n, seed):
    pc = sphere(n, seed)
    pc[n // 2:] = pc[:n // 2]
    return pc


@pytest.mark.parametrize("case", ["one block beside larger ones", "eight of 10000",
                                  "ties across blocks", "several launches",
                                  "more clouds than SMs"])
def test_greedy_batched_lanes_equal_single_launches(cuda_device, case):
    kw = {}
    if case == "one block beside larger ones":
        clouds = [sphere(n, 40 + n) for n in (3000, 12000, 4097, 700)]
    elif case == "eight of 10000":
        clouds = [sphere(10000, 50 + b) for b in range(8)]
    elif case == "ties across blocks":
        clouds = [_tied(6000, 41), _tied(20000, 42), sphere(2000, 43)]
    elif case == "several launches":
        clouds = [sphere(n, 44 + n) for n in (10000, 9000, 6000, 1000)]
        kw["_sms"] = 4
    else:
        sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
        clouds = [sphere(200 + b, 45 + b) for b in range(sms + 8)]
    pts = [torch.as_tensor(pc, device=cuda_device) for pc in clouds]
    starts = [(7 * b) % len(p) for b, p in enumerate(pts)]
    got = propagate_cuda.greedy_columns_batched(pts, starts, 1e-6, **kw)
    launches = propagate_cuda.last_launch()["launches"]
    assert (len(launches) > 1) == (case in ("several launches", "more clouds than SMs"))
    for p, s0, (acc, sign) in zip(pts, starts, got):
        a1, s1 = propagate_cuda.greedy_columns(p, s0, 1e-6)
        assert torch.equal(acc, a1) and torch.equal(sign, s1)
    if case != "more clouds than SMs":
        for p, s0, (acc, sign) in list(zip(pts, starts, got))[:4]:
            if len(p) <= 6000 or case == "eight of 10000":
                ap, sp = propagate.greedy_columns_plain(p, s0, 1e-6)
                assert torch.equal(acc, ap) and torch.equal(sign, sp)
    if case == "ties across blocks":
        for (acc, _), p in zip(got[:2], pts[:2]):
            h = len(p) // 2
            assert torch.equal(acc[:h], acc[h:])


def test_greedy_batched_refuses_what_registers_cannot_hold(cuda_device):
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    big = torch.zeros((sms * propagate_cuda.POINTS_PER_SM + 1, 6), device=cuda_device)
    small = torch.as_tensor(sphere(100, 46), device=cuda_device)
    with pytest.raises(ValueError, match="registers"):
        propagate_cuda.greedy_columns_batched([small, big], [0, 0], 1e-6)
    with pytest.raises(ValueError, match="starting point"):
        propagate_cuda.greedy_columns_batched([small], [100], 1e-6)
    with pytest.raises(ValueError, match="shape"):
        propagate_cuda.greedy_columns_batched([small[:, :3].contiguous()], [0], 1e-6)


@pytest.mark.parametrize("kernel", ["xie", "dipole"])
def test_replay_batched_lanes_equal_single_launches(cuda_device, kernel):
    """Clouds of 1500, 700, 3001 and 129 points with 3, 1, 5 and 3 orders of
    unequal lengths (one order set over repeated indices, one empty), then
    20 clouds of 3 orders: 60 lanes, more than one blocked loop takes."""
    r = np.random.default_rng(47)
    sizes = (1500, 700, 3001, 129)
    Ts = (3, 1, 5, 3)
    steps = (1500, 333, 2000, 0)
    mats, orders = [], []
    for n, T, S in zip(sizes, Ts, steps):
        pc = torch.as_tensor(sphere(n, 48 + n), device=cuda_device)
        mats.append(fields.xie_interaction_matrix(pc) if kernel == "xie"
                    else fields.dipole_interaction_matrix(pc))
        o = np.stack([np.concatenate([r.permutation(n), r.permutation(n)])[:S]
                      for _ in range(T)]).reshape(T, S)
        orders.append(torch.as_tensor(o, device=cuda_device))
    orders[2][:, 1600:1700] = orders[2][:, 40:140]
    many_m = [fields.xie_interaction_matrix(torch.as_tensor(sphere(300, 60 + b),
                                                            device=cuda_device))
              for b in range(20)]
    many_o = [torch.as_tensor(np.stack([r.permutation(300) for _ in range(3)]),
                              device=cuda_device) for _ in range(20)]
    for I_list, o_list in ((mats, orders), (many_m, many_o)):
        got = propagate_cuda.replay_batched(I_list, o_list)
        for I, o, (w, inter) in zip(I_list, o_list, got):
            w1, i1 = propagate_cuda.replay(I, o)
            assert torch.equal(w, w1) and torch.equal(inter, i1)
            if I.shape[0] <= 1500 and o.shape[1]:
                wp, ip = propagate.replay_plain(I, o)
                assert torch.equal(w, wp) and torch.equal(inter < 0, ip < 0)


def test_batched_paths_take_kernels_only(cuda_device):
    counts = (fields_cuda.LAUNCHES, propagate_cuda.LAUNCHES,
              fields.PLAIN_CUDA_CALLS, propagate.PLAIN_CUDA_CALLS)
    for c in counts:
        c.update({k: 0 for k in c})
    clouds = [sphere(n, 70 + n) for n in (2000, 3000, 2500)]
    got = propagate.orient_clouds_batched(clouds, diffuse=True, device=cuda_device)
    want = propagate.orient_clouds_batched(clouds, diffuse=True, device="cpu")
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    pcs = [_ellipsoid(n, 71 + n) for n in (1500, 2200)]
    orders = [propagate.bfs_orders(pc, 0, times=3)[0] for pc in pcs]
    flips = propagate.xie_in_order_batched(pcs, orders, device=cuda_device)
    for pc, o, f in zip(pcs, orders, flips):
        assert np.array_equal(f, propagate.xie_in_order_batched(
            [pc], [o], device="cpu")[0])
    assert propagate_cuda.LAUNCHES["greedy_columns_batched"] == 1
    assert propagate_cuda.LAUNCHES["replay_batched"] == 1
    assert fields_cuda.LAUNCHES["dipole_potential"] == 3
    assert not any(fields.PLAIN_CUDA_CALLS.values())
    assert not any(propagate.PLAIN_CUDA_CALLS.values())


def test_server_round_trip_on_cuda(cuda_device, tmp_path):
    import socket
    import threading
    import time

    from dipole_tpu_torch.serve import handlers, protocol
    from dipole_tpu_torch.serve.server_para import Server

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    srv = Server(host="127.0.0.1", port=port, log_dir=str(tmp_path), device="cuda")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    xyz = _ellipsoid(3000, 72)[:, :3].astype(np.float64)
    cfg = {"max_nn": 30, "eps": 1e-2, "diffuse": False, "times": 3, "knn_mask": -1,
           "C": 3}
    try:
        for _ in range(100):
            try:
                out = protocol.request("127.0.0.1", port, "tree_xie_propagation", xyz,
                                       cfg)
                break
            except ConnectionRefusedError:
                time.sleep(0.05)
        want = handlers.dispatch("tree_xie_propagation", xyz, dict(cfg), device="cuda")
        assert np.array_equal(out, want)
        out = protocol.request("127.0.0.1", port, "simple_estimate", xyz,
                               {"diffuse": True})
        assert out.shape == (3000, 6) and np.isfinite(out).all()
        assert srv.batcher.jobs_run == 3
    finally:
        srv.stop()



# ---- training and the torch_rng replay's forward ----

def _train_batch(n_batch=4, bucket=512, pool=0.6):
    from dipole_tpu_torch import train
    from dipole_tpu_torch.models import pointcnn
    from dipole_tpu_torch.utils import prng

    pc, labels, valid = train.make_batch(prng.prng_key(1), n_batch, bucket)
    valid[1, 450:] = False
    pc[1, 450:] = 0
    m1 = int(-(-bucket * pool // 1))
    return pc, labels, valid, pointcnn.key_starts(prng.prng_key(2), valid.sum(1), pool, m1)


def test_train_step_kernels_match_plain(cuda_device, monkeypatch):
    """One loss and backward with the kNN and FPS kernels and one with their
    plain versions from the same parameters and batch: both kernels are
    bit-equal to their plain versions and the backward is deterministic
    (the gathers' backward is index_put's accumulate, which sorts its
    indices), so the loss and every gradient are bit-equal."""
    import copy

    from dipole_tpu_torch import train
    from dipole_tpu_torch.models import pointcnn
    from dipole_tpu_torch.utils import prng

    params = train.calibrate_init(train.init_params(prng.prng_key(0)),
                                  train._probe_patch(0, 512), device=cuda_device)
    model = pointcnn.from_numpy_params(params, 0.6, trainable=True).to(cuda_device)
    pc, labels, valid, starts = _train_batch()
    out = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(pointcnn, "knn_with_dist", neighbors.knn_with_dist_plain)
            monkeypatch.setattr(pointcnn, "fps_masked_batch",
                                neighbors.fps_masked_batch_plain)
        m = copy.deepcopy(model)
        neighbors_cuda.LAUNCHES.update({k: 0 for k in neighbors_cuda.LAUNCHES})
        loss, _ = train.loss_fn(m, torch.as_tensor(pc, device=cuda_device),
                                torch.as_tensor(labels, device=cuda_device),
                                torch.as_tensor(valid, device=cuda_device), starts,
                                class_balance=True, gauge_free=True)
        loss.backward()
        assert neighbors_cuda.LAUNCHES["knn"] == (0 if plain else 5)
        assert neighbors_cuda.LAUNCHES["fps"] == (0 if plain else 2)
        out.append((float(loss.detach()), dict(m.named_parameters())))
    (lk, mk), (lp, mp) = out
    assert lk == lp
    for k, p in mp.items():
        assert (p.grad is None) == (mk[k].grad is None), k
        if p.grad is not None:
            assert torch.equal(mk[k].grad, p.grad), k


def test_train_steps_on_card_take_kernels_only(cuda_device):
    from dipole_tpu_torch import train

    neighbors_cuda.LAUNCHES.update({k: 0 for k in neighbors_cuda.LAUNCHES})
    neighbors.PLAIN_CUDA_CALLS.update({k: 0 for k in neighbors.PLAIN_CUDA_CALLS})
    model, history = train.train(steps=3, batch=4, n_points=256,
                                 device=cuda_device, verbose=False)
    assert np.isfinite(history).all()
    assert next(model.parameters()).is_cuda
    assert neighbors_cuda.LAUNCHES["knn"] >= 15 and neighbors_cuda.LAUNCHES["fps"] >= 6
    assert not any(neighbors.PLAIN_CUDA_CALLS.values())



def test_train_steps_on_virtual_mesh_take_kernels_only(cuda_device):
    """3 steps under a (2, 2) mesh of the one card repeated: each data row's
    forward launches the kNN and FPS kernels (5 and 2 a forward), never
    their plain versions, and the gathered model is whole on the card."""
    from dipole_tpu_torch import train
    from dipole_tpu_torch.parallel import sharding
    from dipole_tpu_torch.utils import prng

    mesh = sharding.Mesh([torch.device("cuda", 0)] * 4, shape=(2, 2))
    model = train._fresh_model(prng.prng_key(0), train._probe_patch(0, 512), 0.6,
                               cuda_device)
    _opt, step = train.make_train_step(model, 1e-3, total_steps=3, mesh=mesh)
    batch = _train_batch()
    neighbors_cuda.LAUNCHES.update({k: 0 for k in neighbors_cuda.LAUNCHES})
    neighbors.PLAIN_CUDA_CALLS.update({k: 0 for k in neighbors.PLAIN_CUDA_CALLS})
    losses = [float(step(*batch)[0]) for _ in range(3)]
    assert np.isfinite(losses).all()
    assert neighbors_cuda.LAUNCHES["knn"] == 3 * 2 * 5
    assert neighbors_cuda.LAUNCHES["fps"] == 3 * 2 * 2
    assert not any(neighbors.PLAIN_CUDA_CALLS.values())
    whole = step.gather()
    assert whole is model and all(p.is_cuda for p in whole.parameters())
    assert whole.state_dict().keys() == train.init_params(prng.prng_key(0)).keys()

def test_forward_precanon_on_card_matches_cpu(cuda_device):
    """The replay's forward (reference-canonicalized patches, explicit
    starts) on the card against the CPU: the same selections (kNN and FPS
    bit-equal to their plain versions), logits within 1e-3 (float32 GEMMs
    in other orders)."""
    from dipole_tpu_torch.models import inference, pointcnn
    from dipole_tpu_torch.utils.torch_rng import TorchMT19937

    r = np.random.default_rng(3)
    patches = [sphere(n, 40 + n, scramble=True) * np.float32(1 + r.random())
               for n in (500, 128, 77, 300)]
    canon = [inference._canon_reference(p) for p in patches]
    card = pointcnn.PointCNN.from_files(CKPT).to(cuda_device)
    cpu = pointcnn.PointCNN.from_files(CKPT)
    rng = TorchMT19937(1)
    starts = np.array([[rng.randint(len(p)), rng.randint(int(np.ceil(cpu.pool * len(p))))]
                       for p in patches], np.int32)
    got = pointcnn.pointcnn_logits_batched(card, canon, starts=starts, precanon=True)
    want = pointcnn.pointcnn_logits_batched(cpu, canon, starts=starts, precanon=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3)


# ---------------------------------------------------------------------------
# multi-device: a virtual mesh of four shards on one card
# ---------------------------------------------------------------------------

@pytest.fixture()
def vmesh(cuda_device):
    from dipole_tpu_torch.parallel import sharding

    return sharding.Mesh([torch.device("cuda", 0)] * 4)


def _zero_counts():
    for d in (fields_cuda.LAUNCHES, propagate_cuda.LAUNCHES, neighbors_cuda.LAUNCHES,
              fields.PLAIN_CUDA_CALLS, propagate.PLAIN_CUDA_CALLS,
              neighbors.PLAIN_CUDA_CALLS):
        d.update({k: 0 for k in d})


def _no_plain_calls():
    return not any(v for d in (fields.PLAIN_CUDA_CALLS, propagate.PLAIN_CUDA_CALLS,
                               neighbors.PLAIN_CUDA_CALLS) for v in d.values())


def test_sharded_fields_on_virtual_mesh(vmesh):
    """Each shard launches the field, potential and group kernels: the field
    and potential within their tolerances of the one-device kernel (field.cu
    and potential.cu plan their chunks from the shard's shape), the group
    bit-equal (its plan reads the sources only)."""
    from dipole_tpu_torch.parallel import sharding

    dev = vmesh.devices[0]
    src = torch.as_tensor(sphere(3000, 61), device=dev)
    tgt = torch.as_tensor(sphere(5000, 62)[:, :3] * 1.3, device=dev)
    want = fields.field_grad(src, tgt)
    tol = 1e-4 * want.abs() + 1e-5 * float(want.abs().max())
    _zero_counts()
    for mode in ("targets", "sources", "ring"):
        got = torch.as_tensor(sharding.field_grad_sharded(src, tgt, vmesh, shard=mode),
                              device=dev)
        assert bool(((got - want).abs() <= tol).all()), mode
    assert fields_cuda.LAUNCHES["dipole_field"] >= 4 + 4 + 16
    grid = torch.as_tensor(gen_grid(10), device=dev)
    want = fields.potential(src, grid)
    for mode in ("sources", "ring"):
        got = torch.as_tensor(sharding.potential_sharded(src, grid, vmesh, shard=mode),
                              device=dev)
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-5 * float(want.abs().max()))
    gid = torch.as_tensor(np.random.default_rng(63).integers(0, 37, 3000), device=dev)
    want = fields.point_group_interaction(src, gid, 37)
    got = sharding.point_group_interaction_sharded(src, gid, 37, vmesh)
    assert torch.equal(torch.as_tensor(got, device=dev), want)
    signs = np.where(np.random.default_rng(64).random(3000) < 0.5, -1.0, 1.0)
    I = fields.dipole_interaction_matrix(src, eps=1e-5)
    exact = (I @ torch.as_tensor(signs, dtype=torch.float32, device=dev)).cpu().numpy()
    scale = I.abs().sum(1).cpu().numpy()
    for mode in ("ring", "sources"):
        acc = sharding.interaction_accumulate_sharded(src, signs, vmesh, shard=mode)
        assert np.all(np.abs(acc - exact) <= 1e-4 * scale + 1e-5), mode
    assert fields_cuda.LAUNCHES["dipole_group"] == 5   # one + four shards
    assert _no_plain_calls()


def test_sharded_loops_on_virtual_mesh(vmesh):
    """The sharded greedy and replay (plain torch loops, as XLA scans in the
    JAX package) on the card: the one-device kernel path's decisions; the
    replay's block matrices by imatrix.cu's general modes."""
    from dipole_tpu_torch.parallel import sharding

    pc = sphere(2000, 65)
    acc_m, sign_m = sharding.greedy_sign_sequence_sharded(pc, vmesh)
    acc_s, sign_s = propagate.greedy_sign_sequence(pc, device=vmesh.devices[0])
    assert (sign_m == sign_s.cpu().numpy()).all()
    assert np.allclose(acc_m, acc_s.cpu().numpy(), rtol=1e-3, atol=1e-3)
    orders, _ = propagate.bfs_orders(pc, 0, times=3)
    _zero_counts()
    for kernel in ("xie", "dipole"):
        for diffuse in (False, True):
            got = sharding.xie_in_order_sharded(pc, orders, vmesh, kernel=kernel,
                                                diffuse=diffuse)
            want = propagate.xie_propagation_in_order(pc, orders, kernel=kernel,
                                                      diffuse=diffuse,
                                                      device=vmesh.devices[0])
            assert (got == want).mean() >= 0.99, (kernel, diffuse)
    assert fields_cuda.LAUNCHES["xie_imatrix"] >= 8 and fields_cuda.LAUNCHES["dipole_imatrix"] >= 8
    assert _no_plain_calls()


def test_sharded_ensemble_forward_on_virtual_mesh(vmesh):
    """The ensemble forward split over the shards: each launches the kNN and
    FPS kernels; the per-patch logits of the one-device forward."""
    from dipole_tpu_torch.models import pointcnn
    from dipole_tpu_torch.utils import prng

    model = pointcnn.PointCNN.from_files(CKPT).to(vmesh.devices[0])
    patches = [sphere(n, 70 + n) for n in (500, 128, 77, 300, 211, 90, 400, 150, 260)]
    key = prng.prng_key(3)
    want = pointcnn.pointcnn_logits_batched(model, patches, key=key)
    _zero_counts()
    got = pointcnn.pointcnn_logits_batched(model, patches, key=key, mesh=vmesh)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5)
    assert neighbors_cuda.LAUNCHES["knn"] >= 4 * 5 and neighbors_cuda.LAUNCHES["fps"] >= 4 * 2
    assert _no_plain_calls()


def test_api_and_handlers_on_virtual_mesh(vmesh, tmp_path):
    """orient_simple and the server handlers under the mesh: the one-device
    output."""
    from dipole_tpu_torch.serve import handlers

    pc = sphere(1500, 71)
    want = api.orient_simple(pc, diffuse=True, device="cuda")
    np.testing.assert_array_equal(
        api.orient_simple(pc, diffuse=True, mesh=vmesh, device="cuda"), want)
    xyz = sphere(1500, 72)[:, :3].astype(np.float64)
    one = handlers.dispatch("simple_estimate", xyz, {}, device="cuda")
    try:
        handlers.set_mesh(vmesh)
        np.testing.assert_array_equal(
            handlers.dispatch("simple_estimate", xyz, {}, device="cuda"), one)
    finally:
        handlers.set_mesh(None)


def test_mesh_mixing_cpu_and_cuda_raises(cuda_device):
    from dipole_tpu_torch.parallel import sharding

    with pytest.raises(ValueError, match="one type"):
        sharding.Mesh([torch.device("cpu"), cuda_device])
    with pytest.raises(ValueError, match="does not run"):
        api.orient_simple(sphere(100, 73), mesh=sharding.make_mesh(2, device="cpu"),
                          device="cuda")
    with pytest.raises(ValueError, match="available"):
        sharding.make_mesh(torch.cuda.device_count() + 1)
