"""Host-side graph structures: kNN/EMST graphs, BFS orders, patch graphs,
and ground-truth diagnostics — the port's own copy of dipole_tpu/graphs.py.

Capability parity with reference graph.py (BiEdge/BidGraph :121-159,
LinkedListGraph + BFS routes :261-343, getEMSTfromPC :380-392,
getRiemannianGraphfromPC :394-424, GraphPC GT metrics :162-254) — built on
scipy's cKDTree instead of sklearn, with a deterministic adjacency order
(insertion order) rather than Python-set iteration order.

These are O(N log N)/O(N k) host paths, not device-hot; the O(N^2) work
stays in ops/fields.py on the card. BFS routes, the kNN and the Hoppe
orientation run in the native library (native.py), with no Python fallback.
"""
from __future__ import annotations

from collections import deque
import heapq
import sys

import numpy as np
from scipy.spatial import cKDTree

from dipole_tpu_torch import native

__all__ = [
    "BiEdge", "BidGraph", "LinkedListGraph", "GraphPC",
    "CSRGraph", "emst_from_pc", "riemannian_graph_from_pc", "hoppe_dist",
    "minimum_spanning_tree", "orient_normals_hoppe",
]


class BiEdge:
    """Undirected edge with a weight for 'same orientation' (w) and for
    'opposite orientation' (invw)."""

    __slots__ = ("u", "v", "w", "invw")

    def __init__(self, u, v, w, invw):
        self.u = u
        self.v = v
        self.w = w
        self.invw = invw

    def __iter__(self):
        return iter([self.u, self.v, self.w, self.invw])


class BidGraph:
    """Edge-list graph over patch ids; converts to the (A, B) matrices the
    flip solver consumes (reference graph.py:131-159)."""

    def __init__(self):
        self.V: list[int] = []
        self.E: list[BiEdge] = []

    def to_matrix(self):
        ids = set(self.V)
        for i in range(len(ids)):
            if i not in ids:
                raise ValueError("graph vertex ids are not contiguous")
        n = len(self.V)
        A = np.zeros((n, n))
        B = np.zeros((n, n))
        for e in self.E:
            A[e.u][e.v] = A[e.v][e.u] = e.w
            B[e.u][e.v] = B[e.v][e.u] = e.invw
        return A, B


class LinkedListGraph:
    """Adjacency-list graph supporting plain and weighted BFS orders with
    disconnected-component restart (reference graph.py:261-343)."""

    def __init__(self, node_num: int):
        self.node_num = node_num
        self.adj: list[list[tuple[int, float]]] = [[] for _ in range(node_num)]
        self._seen: list[set[int]] = [set() for _ in range(node_num)]

    def add_edge(self, u: int, v: int, w: float):
        if v not in self._seen[u]:
            self._seen[u].add(v)
            self.adj[u].append((v, w))

    def get_bfs_route(self, start: int) -> np.ndarray:
        res = np.empty(self.node_num, dtype=np.int64)
        k = 0
        visited = np.zeros(self.node_num, dtype=bool)
        q = deque([start])
        visited[start] = True
        components = 1
        while q:
            u = q.popleft()
            res[k] = u
            k += 1
            for v, _ in self.adj[u]:
                if not visited[v]:
                    visited[v] = True
                    q.append(v)
            if not q:
                if visited.all():
                    break
                nxt = int(np.flatnonzero(~visited)[0])
                visited[nxt] = True
                q.append(nxt)
                components += 1
        if components != 1:
            print(f"graph is disconnected: BFS route restarted across "
                  f"{components} components", file=sys.stderr)
        return res

    def get_weighted_bfs_route(self, start: int) -> np.ndarray:
        res = np.empty(self.node_num, dtype=np.int64)
        k = 0
        visited = np.zeros(self.node_num, dtype=bool)
        q: list[tuple[float, int]] = []
        heapq.heappush(q, (0.0, start))
        visited[start] = True
        components = 1
        while q:
            _, u = heapq.heappop(q)
            res[k] = u
            k += 1
            for v, w in self.adj[u]:
                if not visited[v]:
                    visited[v] = True
                    heapq.heappush(q, (w, v))
            if not q:
                if visited.all():
                    break
                nxt = int(np.flatnonzero(~visited)[0])
                visited[nxt] = True
                heapq.heappush(q, (0.0, nxt))
                components += 1
        if components != 1:
            print(f"graph is disconnected: BFS route restarted across "
                  f"{components} components", file=sys.stderr)
        return res


class CSRGraph:
    """Compressed adjacency graph with native BFS routes — the scalable
    counterpart of LinkedListGraph for point-level graphs (100k+ nodes)."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray,
                 weights: np.ndarray | None = None):
        self.indptr = np.asarray(indptr, np.int64)
        self.indices = np.asarray(indices, np.int32)
        self.weights = weights
        self.node_num = len(self.indptr) - 1

    def get_bfs_route(self, start: int) -> np.ndarray:
        route, components = native.bfs_route_csr(self.indptr, self.indices, start)
        if components != 1:
            print(f"graph is disconnected: BFS route restarted across "
                  f"{components} components", file=sys.stderr)
        return route

    def get_weighted_bfs_route(self, start: int) -> np.ndarray:
        G = LinkedListGraph(self.node_num)
        for u in range(self.node_num):
            for j in range(self.indptr[u], self.indptr[u + 1]):
                w = float(self.weights[j]) if self.weights is not None else 0.0
                G.add_edge(u, int(self.indices[j]), w)
        return G.get_weighted_bfs_route(start)


def emst_from_pc(xyz: np.ndarray, k: int = 10, threshold: float = 0.1):
    """Thresholded kNN graph ('EMST' in the reference's naming,
    graph.py:380-392), built with the native KD-tree into CSR form.
    Returns (CSRGraph, mean kNN distance per point)."""
    xyz = np.asarray(xyz, dtype=np.float32)[:, :3]
    n = len(xyz)
    kk = min(k, n)
    idx, d2 = native.knn(xyz, xyz, kk)
    dist = np.sqrt(d2.astype(np.float64))
    keep = (idx != np.arange(n)[:, None]) & (dist < threshold)
    counts = keep.sum(axis=1)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = idx[keep].astype(np.int32)
    weights = dist[keep].astype(np.float32)
    return CSRGraph(indptr, indices, weights), dist.mean(axis=1)


def hoppe_dist(x, y):
    """1 - |n1.n2| edge weight (Hoppe-style Riemannian graph,
    reference graph.py:394-399)."""
    nx_, ny_ = np.linalg.norm(x[:3]), np.linalg.norm(y[:3])
    if nx_ == 0 or ny_ == 0:
        return 1.0
    return 1.0 - float(np.clip(abs(np.dot(x[:3] / nx_, y[:3] / ny_)), 0, 1))


def riemannian_graph_from_pc(nxyz: np.ndarray, k: int = 10, dist_func=hoppe_dist):
    """kNN graph with a custom edge metric (reference graph.py:410-424).
    NOTE: like the reference, the kNN tree is built on the raw rows of nxyz."""
    nxyz = np.asarray(nxyz, dtype=np.float64)
    n = len(nxyz)
    tree = cKDTree(nxyz)
    kk = min(k, n)
    dist, idx = tree.query(nxyz, k=kk)
    if kk == 1:
        dist, idx = dist[:, None], idx[:, None]
    G = LinkedListGraph(n)
    for i in range(n):
        for j in range(kk):
            v = int(idx[i, j])
            if v != i:
                w = float(dist[i, j]) if dist_func is None else dist_func(nxyz[i], nxyz[v])
                G.add_edge(i, v, w)
    return G, dist.mean(axis=1)


class GraphPC:
    """Ground-truth diagnostics over a patch graph (reference
    graph.py:162-254): patch flip accuracy, edge-sign accuracy, and colored
    dumps of wrong edges for inspection."""

    def __init__(self, G: BidGraph, pc, indices, gt, flip_status):
        self.G = G
        self.pc = np.asarray(pc)
        self.indices = indices
        self.gt = np.asarray(gt)
        self.flip_status = np.asarray(flip_status)
        assert len(self.pc) == len(self.gt)

    def is_right_patch(self, i) -> bool:
        idx = np.asarray(self.indices[i])
        return float((self.gt[idx, 3:6] * self.pc[idx, 3:6]).sum()) > 0

    def cal_flip_acc(self) -> float:
        n = len(self.indices)
        true_count = sum(self.is_right_patch(i) for i in range(n))
        return max(true_count, n - true_count) / n

    def is_good_edge(self, edge: BiEdge) -> bool:
        ustat = self.is_right_patch(edge.u)
        vstat = self.is_right_patch(edge.v)
        rel_flip = self.flip_status[edge.u] != self.flip_status[edge.v]
        if edge.w > 0:
            return (ustat == vstat) ^ bool(rel_flip)
        return (ustat != vstat) ^ bool(rel_flip)

    def cal_edge_acc(self) -> float:
        if not self.G.E:
            return 1.0
        return sum(self.is_good_edge(e) for e in self.G.E) / len(self.G.E)

    def get_edge_correctness(self):
        return [self.is_good_edge(e) for e in self.G.E]

    def get_node_flip_status(self):
        return [self.is_right_patch(i) for i in range(len(self.indices))]

    def save_edge(self, edge: BiEdge, folder="temp"):
        from pathlib import Path
        from dipole_tpu_torch.utils.io import write_ply

        Path(folder).mkdir(parents=True, exist_ok=True)
        u = self.pc[np.asarray(self.indices[edge.u])].copy()
        v = self.pc[np.asarray(self.indices[edge.v])].copy()
        if self.flip_status[edge.u] == 1:
            u[:, 3:6] *= -1
        if self.flip_status[edge.v] == 1:
            v[:, 3:6] *= -1
        ops = np.concatenate([u, v], axis=0)
        color = np.zeros((len(ops), 3))
        color[: len(u)] = [1, 0, 0]
        color[len(u):] = [0, 0, 1]
        name = f"{edge.u}_{edge.v}_{edge.w}.ply"
        write_ply(Path(folder) / name, ops[:, :3], ops[:, 3:6], color)

    def save_all_edge(self, path):
        for e in self.G.E:
            self.save_edge(e, path)

    def save_wrong_edge(self, path):
        for e in self.G.E:
            if not self.is_good_edge(e):
                self.save_edge(e, path)

    def print_metrics(self):
        print("flip acc: ", self.cal_flip_acc())
        print("edge acc: ", self.cal_edge_acc())
        return 0


def minimum_spanning_tree(n: int, edges):
    """Prim's MST over an edge list [(u, v, w)]. Returns adjacency lists of
    the tree. Used by the Hoppe-style consistent orientation below."""
    import heapq as _hq

    adj = [[] for _ in range(n)]
    for u, v, w in edges:
        adj[u].append((w, v))
        adj[v].append((w, u))
    tree = [[] for _ in range(n)]
    visited = np.zeros(n, dtype=bool)
    for root in range(n):
        if visited[root]:
            continue
        visited[root] = True
        heap = [(w, root, v) for w, v in adj[root]]
        _hq.heapify(heap)
        while heap:
            w, u, v = _hq.heappop(heap)
            if visited[v]:
                continue
            visited[v] = True
            tree[u].append(v)
            tree[v].append(u)
            for w2, x in adj[v]:
                if not visited[x]:
                    _hq.heappush(heap, (w2, v, x))
    return tree


def orient_normals_hoppe(pc: np.ndarray, k: int = 10) -> np.ndarray:
    """Consistent tangent-plane orientation (Hoppe et al. 1992) — the
    capability the reference gets from Open3D's
    orient_normals_consistent_tangent_plane (socket_server.py:40-60):
    MST over the kNN graph with 1 - |n_i . n_j| weights, every connected
    component seeded from its max-z point (normal forced to +z) and oriented
    by depth-first propagation — all of it in the native library, which the
    JAX package takes too (graphs.py:318-334)."""
    pc = np.array(pc, dtype=np.float32, copy=True)
    if len(pc) == 0:
        return pc
    signs = native.hoppe_orient_signs(pc[:, :3], pc[:, 3:6], k)
    pc[:, 3:6] *= signs[:, None].astype(np.float32)
    return pc
