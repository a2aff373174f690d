"""Patch-graph orientation: per-patch dipole rectification + global flip
assignment solved over the patch interaction graph — the port of
dipole_tpu/pipelines/graph_dipole.py, every function of it.

Capability parity with the fork's research harness (reference
graph_dipole.py): grid/ncut partitioning with a per-patch point estimator
(graph_dipole.py:87-117), patch-graph construction with dipole edge weights
(util.py:160-212, 271-329), global flip via the pairwise solver
(graph.py:444-470 — Gurobi there, exact-enumeration/local-search here), and
the GT-metric experiment drivers (graph_dipole.py:46-85, 202-339).

The missing `toolbox.bitree_cluster_plus` the reference imports
(util.py:277 — module absent from its repo) is reimplemented as recursive
spectral bisection over the kNN graph with a PCA-plane fallback.

On the card the per-patch estimator (st_propagation_points_file) runs
csrc/imatrix.cu, greedy.cu and potential.cu for each patch, the patch edges
csrc/field.cu (fields.field_edge_calculator); the flip assignment
(solve.miqp_max) and the partitioning run on the host. Every function takes
`device` (default "cuda")."""
from __future__ import annotations

import threading
from functools import partial
from pathlib import Path

import numpy as np
from scipy.spatial import cKDTree

from dipole_tpu_torch import graphs, native
from dipole_tpu_torch.device import resolve_device
from dipole_tpu_torch.ops import fields, propagate, solve
from dipole_tpu_torch.ops.estimate import estimate_normals
from dipole_tpu_torch.ops.metrics import cal_metrics
from dipole_tpu_torch.ops.patching import divide_pc_with_ijk
from dipole_tpu_torch.utils.io import Transform, load_point_cloud, write_ply
from dipole_tpu_torch.utils.timing import timer_factory

__all__ = [
    "propagate_points_file", "st_propagation_points_file",
    "xie_propagation_points_file", "xie_tree_propagation_points_file",
    "divide_pc_to_graph", "divide_pc_by_ncut", "bitree_cluster",
    "graph_dipole", "graph_dipole_server_api", "single_propagate_file",
    "run_file", "run_res_and_compare", "run_folder",
]

FLIP_TIMES = 9  # multi-start vote count (reference graph_dipole.py:198)


# ---------------------------------------------------------------------------
# Whole-file propagation wrappers (reference graph_dipole.py:27-43)
# ---------------------------------------------------------------------------

def propagate_points_file(input_pc, propagate_func, *args, device="cuda",
                          **kwargs):
    """normalize -> propagate -> lattice sign fix -> denormalize;
    propagate_func gets `device` too."""
    dev = resolve_device(device)
    pc, transform = Transform.trans(np.asarray(input_pc, np.float32))
    pc = propagate_func(pc, *args, device=dev, **kwargs)
    if fields.measure_mean_potential(pc, device=dev) < 0:
        pc[:, 3:6] *= -1
    return transform.inverse(pc)


def st_propagation_points_file(input_pc, verbose: bool = False, device="cuda"):
    return propagate_points_file(
        input_pc, propagate.strongest_field_propagation_points,
        diffuse=True, starting_point=0, device=device,
    )


def xie_propagation_points_file(input_pc, eps: float = 1e-2, verbose: bool = False,
                                device="cuda"):
    return propagate_points_file(
        input_pc, propagate.xie_propagation_points, eps=eps, diffuse=True,
        starting_point=0, device=device,
    )


def xie_tree_propagation_points_file(input_pc, eps: float = 1e-2,
                                     verbose: bool = False, times: int = 1,
                                     use_pw: bool = False, device="cuda"):
    def f(pc, device):
        out, _ = propagate.xie_propagation_bfs_tree(
            pc, eps=eps, diffuse=True, starting_point=0, times=times,
            use_pw=use_pw, knn_mask=-1, device=device,
        )
        return out

    return propagate_points_file(input_pc, f, device=device)


# ---------------------------------------------------------------------------
# Partitioning -> patch graph
# ---------------------------------------------------------------------------

def _apply_point_estimator(pc, patches, point_estimator, parallel=True):
    """Run the per-patch estimator; patch index sets are disjoint, so the
    threaded variant is race-free (mirrors reference util.py:186-196)."""
    if point_estimator is None:
        return
    def work(idx):
        pc[idx] = point_estimator(pc[idx])
    if parallel:
        threads = [threading.Thread(target=work, args=(np.asarray(p),)) for p in patches]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    else:
        for p in patches:
            work(np.asarray(p))


def divide_pc_to_graph(pc: np.ndarray, n_part: int, ranges=(-1.5, 1.5),
                       min_patch: int = 0, edge_calculator=None,
                       point_estimator=None):
    """Voxel partition -> per-patch estimator -> BidGraph with edges between
    grid-adjacent patches (|dijk| sums to 1 between any merged source cells;
    reference util.py:160-212)."""
    patches, ijk_groups = divide_pc_with_ijk(pc, n_part, ranges, min_patch)
    _apply_point_estimator(pc, patches, point_estimator)

    def is_neighbor(gi, gj):
        for ci in gi:
            for cj in gj:
                if np.abs(ci - cj).sum() == 1:
                    return True
        return False

    G = graphs.BidGraph()
    G.V = list(range(len(patches)))
    for i in range(len(patches)):
        for j in range(i + 1, len(patches)):
            if not is_neighbor(ijk_groups[i], ijk_groups[j]):
                continue
            if edge_calculator is None:
                raise ValueError("edge_calculator is required")
            w, invw = edge_calculator(pc[patches[i]], pc[patches[j]])
            G.E.append(graphs.BiEdge(i, j, w, invw))
    return G, patches


def bitree_cluster(xyz: np.ndarray, k_neighbors: int, minimum_rate: float) -> np.ndarray:
    """Recursive binary partition of a cloud down to leaves smaller than
    minimum_rate * N: spectral bisection (Fiedler vector of the kNN-graph
    Laplacian) with PCA-plane median split as fallback. Replaces the
    reference's missing toolbox bitree_cluster_plus (util.py:277)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    xyz = np.asarray(xyz, dtype=np.float64)
    n_total = len(xyz)
    min_pts = max(1, int(np.ceil(minimum_rate * n_total)))
    labels = np.zeros(n_total, dtype=np.int64)
    next_label = [1]

    def pca_split(idx):
        pts = xyz[idx]
        c = pts - pts.mean(axis=0)
        _, _, vt = np.linalg.svd(c, full_matrices=False)
        proj = c @ vt[0]
        return proj > np.median(proj)

    def spectral_split(idx):
        pts = xyz[idx]
        m = len(idx)
        kk = min(k_neighbors + 1, m)
        tree = cKDTree(pts)
        dist, nbr = tree.query(pts, k=kk)
        rows = np.repeat(np.arange(m), kk - 1)
        cols = nbr[:, 1:].reshape(-1)
        sigma = np.median(dist[:, -1]) + 1e-12
        w = np.exp(-(dist[:, 1:].reshape(-1) ** 2) / (2 * sigma ** 2))
        W = sp.coo_matrix((w, (rows, cols)), shape=(m, m))
        W = (W + W.T) * 0.5
        d = np.asarray(W.sum(axis=1)).ravel()
        D = sp.diags(d)
        L = D - W
        try:
            vals, vecs = spla.eigsh(L, k=2, M=D, sigma=0, which="LM", tol=1e-4)
            fiedler = vecs[:, np.argsort(vals)[1]]
            mask = fiedler > np.median(fiedler)
            if mask.sum() == 0 or mask.sum() == m:
                return pca_split(idx)
            return mask
        except Exception:
            return pca_split(idx)

    def recurse(idx):
        if len(idx) <= min_pts or len(idx) < 2 * max(2, k_neighbors // 2):
            return
        mask = spectral_split(idx) if len(idx) > 32 else pca_split(idx)
        right = idx[mask]
        left = idx[~mask]
        if len(left) == 0 or len(right) == 0:
            return
        lbl = next_label[0]
        next_label[0] += 1
        labels[right] = lbl
        recurse(left)
        recurse(right)

    recurse(np.arange(n_total))
    # compact labels to 0..P-1
    uniq, inv = np.unique(labels, return_inverse=True)
    return inv


def avg_min_dist(xyz: np.ndarray, k: int) -> float:
    """Median of the k-th nearest-neighbor distance (reference util.py:255-263)."""
    xyz = np.asarray(xyz, dtype=np.float32)[:, :3]
    kk = min(k + 1, len(xyz))
    _, d2 = native.knn(xyz, xyz, kk)
    return float(np.median(np.sqrt(d2[:, -1])))


def if_pc_neighbor(pc1, pc2, threshold: float) -> bool:
    """True if any cross pair is closer than threshold (reference
    util.py:227-249), with a bbox prefilter."""
    a = np.asarray(pc1)[:, :3]
    b = np.asarray(pc2)[:, :3]
    if (a.min(axis=0) - b.max(axis=0) > threshold).any():
        return False
    if (a.max(axis=0) - b.min(axis=0) < -threshold).any():
        return False
    d, _ = cKDTree(b).query(a, k=1)
    return bool((d < threshold).any())


def divide_pc_by_ncut(pc: np.ndarray, k_neighbors: int, mininum_rate: float,
                      edge_calculator=None, point_estimator=None):
    """ncut-style partition -> per-patch estimator -> BidGraph with edges
    between patches containing a sub-threshold point pair (reference
    util.py:271-329)."""
    labels = bitree_cluster(pc[:, :3], k_neighbors, mininum_rate)
    patches = [np.flatnonzero(labels == i) for i in range(labels.max() + 1)]
    _apply_point_estimator(pc, patches, point_estimator)

    threshold = avg_min_dist(pc[:, :3], k_neighbors)
    G = graphs.BidGraph()
    G.V = list(range(len(patches)))
    lock = threading.Lock()

    def edge_job(i, j):
        if if_pc_neighbor(pc[patches[i]], pc[patches[j]], threshold):
            w, invw = edge_calculator(pc[patches[i]], pc[patches[j]])
            with lock:
                G.E.append(graphs.BiEdge(i, j, w, invw))

    jobs = [(i, j) for i in range(len(patches)) for j in range(i + 1, len(patches))]
    threads = [threading.Thread(target=edge_job, args=ij) for ij in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return G, patches


# ---------------------------------------------------------------------------
# Full pipelines
# ---------------------------------------------------------------------------

def _solve_patch_flips(G: graphs.BidGraph):
    A, B = G.to_matrix()
    return solve.miqp_max(A, B)  # reference graph.py MIQP (maximize agreement)


def graph_dipole_core(input_pc: np.ndarray, divide_method: str = "grid_partition",
                      n_part: int = 10, min_patch: int = 0,
                      k_neighbors: int = 30, mininum_rate: float = 0.1,
                      device="cuda"):
    """normalized cloud in -> (oriented cloud, G, patches, flip)."""
    dev = resolve_device(device)
    edge_calculator = partial(fields.field_edge_calculator, device=dev)
    point_estimator = partial(st_propagation_points_file, device=dev)
    if divide_method == "grid_partition":
        G, patches = divide_pc_to_graph(
            input_pc, n_part=n_part, min_patch=min_patch,
            edge_calculator=edge_calculator, point_estimator=point_estimator,
        )
    elif divide_method == "ncut_partition":
        G, patches = divide_pc_by_ncut(
            input_pc, k_neighbors=k_neighbors, mininum_rate=mininum_rate,
            edge_calculator=edge_calculator, point_estimator=point_estimator,
        )
    else:
        raise ValueError(f"no such divide method: {divide_method}")
    flip = _solve_patch_flips(G)
    for i, f in enumerate(flip):
        if f == 1:
            input_pc[np.asarray(patches[i]), 3:6] *= -1
    return input_pc, G, patches, flip


def graph_dipole_server_api(xyz_data: np.ndarray, config: dict,
                            device="cuda") -> np.ndarray:
    """Server entry (reference graph_dipole.py:87-117)."""
    dev = resolve_device(device)
    pc = np.asarray(xyz_data, dtype=np.float32)
    if pc.shape[1] == 3:
        pc = np.concatenate([pc, np.zeros_like(pc)], axis=1)
    pc = estimate_normals(pc, max_nn=config["max_nn"], device=dev)
    pc, transform = Transform.trans(pc)
    kwargs = dict(divide_method=config["divide_method"])
    if config["divide_method"] == "grid_partition":
        kwargs.update(n_part=config["n_part"], min_patch=config["min_patch"])
    else:
        kwargs.update(
            k_neighbors=config["k_neighbors"],
            mininum_rate=max(config["mininum_rate"],
                             config["min_patch"] / len(pc)),
        )
    pc, _, _, _ = graph_dipole_core(pc, device=dev, **kwargs)
    return transform.inverse(pc)


def graph_dipole(pc_path, use_ncut: bool = True, verbose: bool = False,
                 output_path: str | None = None, device="cuda", timer=None):
    """Experiment driver with GT metrics and diagnostic dumps (reference
    graph_dipole.py:119-194). timer: a utils.timing.timer_factory() clock
    that receives the stage times (a fresh one by default)."""
    dev = resolve_device(device)
    stage_timer = timer or timer_factory()
    with stage_timer("load point cloud", count=False):
        data = load_point_cloud(pc_path)
    has_gt = data.shape[1] == 6 and np.abs(data[:, 3:6]).sum() > 0
    gt_pc = data.copy() if has_gt else None
    input_pc, transform = Transform.trans(data)

    with stage_timer("estimate unoriented normals"):
        input_pc = estimate_normals(input_pc, max_nn=30, device=dev)

    with stage_timer("build patch graph + rectify"):
        method = "ncut_partition" if use_ncut else "grid_partition"
        input_pc, G, patches, flip = graph_dipole_core(
            input_pc, divide_method=method, n_part=10, min_patch=0,
            k_neighbors=30, mininum_rate=0.1, device=dev,
        )
    input_pc = transform.inverse(input_pc)

    if verbose and output_path:
        out = Path(output_path)
        out.mkdir(parents=True, exist_ok=True)
        write_ply(out / "final_result.ply", input_pc[:, :3], input_pc[:, 3:6])

    if has_gt:
        gpc = graphs.GraphPC(G, input_pc, patches, gt_pc, flip_status=flip)
        gpc.print_metrics()
        if verbose and output_path:
            gpc.save_wrong_edge(str(Path(output_path) / "wrong_edge"))
        metrics = cal_metrics(gt_pc, input_pc)
        print("metrics:", metrics)
        return metrics
    return None


# ---------------------------------------------------------------------------
# Batch experiment harness (reference graph_dipole.py:202-339)
# ---------------------------------------------------------------------------

def single_propagate_file(pc_path, verbose=False, use_origin_normal=False,
                          propagation_method=st_propagation_points_file,
                          gt_path=None, device="cuda", **kwargs):
    data = load_point_cloud(pc_path)
    ori_pc = data.copy()
    if gt_path is not None:
        gt = load_point_cloud(gt_path)
        if np.linalg.norm(gt[:, :3] - data[:, :3]) > 1e-3:
            raise ValueError("gt and input pc do not match")
        gt_pc = gt
    else:
        gt_pc = ori_pc.copy()
    if not use_origin_normal:
        input_pc = estimate_normals(data[:, :3], max_nn=10, device=device)
    else:
        input_pc = ori_pc.copy()
    out = propagation_method(input_pc, verbose=verbose, device=device, **kwargs)
    if gt_pc.shape[1] == 6:
        metrics = cal_metrics(gt_pc, out)
        print("metrics:", metrics)
        return metrics
    return None


def run_file(path, verbose=False, device="cuda") -> tuple[str, str]:
    head = "filename,tree_xie_loss"
    m = single_propagate_file(
        path, use_origin_normal=False,
        propagation_method=xie_tree_propagation_points_file,
        times=FLIP_TIMES, verbose=verbose, device=device,
    )
    msg = f"{path},{m['count_90'] / m['total_count']}"
    return msg, head


def run_res_and_compare(gt_path, device="cuda") -> tuple[str, str]:
    """A/B comparison of propagation variants against a gt-named twin file
    (reference graph_dipole.py:202-233). The baseline compares the two
    normalized clouds; the JAX package unpacks Transform.trans the other
    way round (pipelines/graph_dipole.py:386-387) and so hands Transform
    objects to cal_metrics, which raises."""
    res_path = str(gt_path).replace("gt", "res")
    head = "filename,origin_loss,tree_xie_loss,xie_loss,dipole_loss"
    ori, _ = Transform.trans(load_point_cloud(res_path))
    gt, _ = Transform.trans(load_point_cloud(gt_path))
    base = cal_metrics(gt, ori)
    cells = [str(gt_path), str(base["count_90"] / base["total_count"])]
    for method, kw in [
        (xie_tree_propagation_points_file, {"times": FLIP_TIMES}),
        (xie_propagation_points_file, {}),
        (st_propagation_points_file, {}),
    ]:
        m = single_propagate_file(res_path, use_origin_normal=True,
                                  propagation_method=method, gt_path=gt_path,
                                  device=device, **kw)
        cells.append(str(m["count_90"] / m["total_count"]))
    return ",".join(cells), head


def run_folder(folder, exp_name, if_parallel=False, handler=run_file,
               log_dir="temp"):
    """Batch-run a folder of .ply files, appending accuracy rows to
    temp/<exp_name>.csv (reference graph_dipole.py:293-339). handler(path)
    returns (row, header); bind a device with functools.partial."""
    folder = Path(folder)
    log_path = Path(log_dir) / f"{exp_name}.csv"
    log_path.parent.mkdir(parents=True, exist_ok=True)
    files = sorted(p for p in folder.iterdir() if p.suffix == ".ply")
    lock = threading.Lock()
    state = {"head_written": False}

    def handle(path):
        msg, head = handler(str(path))
        with lock, open(log_path, "a") as f:
            if not state["head_written"]:
                f.write(head + "\n")
                state["head_written"] = True
            f.write(msg + "\n")

    if if_parallel:
        threads = [threading.Thread(target=handle, args=(p,)) for p in files]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    else:
        for p in files:
            handle(p)
    return log_path
