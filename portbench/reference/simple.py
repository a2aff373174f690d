"""Plain reference of per-point strongest-field propagation: the reference
fork's orient_simple.py and socket_server_para.py's simple_estimate.

    (estimate) unoriented PCA normals over the max_nn nearest neighbours
    within `radius` (Open3D's hybrid search) -> normalize (centre at the
    mean, divide by the largest bounding-box edge) -> strongest-field greedy
    from point 0 over N - 1 steps -> (diffuse) keep a sign iff the field of
    every other point agrees -> lattice sign fix (flip all where the mean
    dipole potential over the 10^3 lattice is negative) -> original frame.

Written from that description with torch operations only: an exact kNN in
float64, a float64 covariance and `torch.linalg.eigh`, the greedy over L
clouds side by side (one lane each) with the acc, |acc| and argmax of each
step on the device, captured in CUDA graphs on a card. `dtype` is the
arithmetic of everything after the neighbour search: float64 for the
reference, bfloat16 for the control (eigh, on the host, then takes the
bfloat16 covariance in float32, since LAPACK has no bfloat16).
"""
from __future__ import annotations

import numpy as np
import torch

KNN_QUERY_BLOCK = 2048
KNN_BLOCK_ELEMENTS = 2**26      # squared distances held at once, all lanes
POTENTIAL_SOURCE_BLOCK = 16384
GRAPH_STEPS = 64
# a neighbourhood is undecided in float32 when the k-th and (k+1)-th squared
# distances, or any of the k and the squared radius, lie this close
# (relative): the program's float32 search may then pick another set
UNDECIDED_RTOL = 1e-5
# nor does a neighbourhood decide its normal when the two smallest
# eigenvalues of its covariance lie within this share of the largest
DEGENERATE_RTOL = 1e-4


def knn(xyz: torch.Tensor, k: int):
    """(idx (L, N, k), d2 (L, N, k+1)) of the exact k nearest points of each
    point, self included, from float64 squared distances; d2 keeps the
    (k+1)-th for the undecided test (inf when N == k)."""
    L, N, _ = xyz.shape
    x = xyz.to(torch.float64)
    sq = (x * x).sum(-1)
    kk = min(k + 1, N)
    rows = max(1, min(KNN_QUERY_BLOCK, KNN_BLOCK_ELEMENTS // (L * N)))
    idx = torch.empty((L, N, k), dtype=torch.int64, device=xyz.device)
    d2 = torch.full((L, N, k + 1), float("inf"), dtype=torch.float64, device=xyz.device)
    for b in range(0, N, rows):
        q = x[:, b:b + rows]
        d = sq[:, b:b + rows, None] + sq[:, None, :] - 2.0 * q @ x.transpose(1, 2)
        val, ix = torch.topk(d.clamp_min_(0.0), kk, dim=-1, largest=False, sorted=True)
        idx[:, b:b + rows] = ix[..., :k]
        d2[:, b:b + rows, :kk] = val
    return idx, d2


def undecided(d2: torch.Tensor, k: int, radius: float) -> torch.Tensor:
    """(L, N) bool: points whose neighbour set float32 may not decide."""
    r2 = radius * radius
    tol = UNDECIDED_RTOL
    tie = (d2[..., k] - d2[..., k - 1]) <= tol * d2[..., k - 1].clamp_min(1e-300)
    edge = ((d2[..., :k] - r2).abs() <= tol * r2).any(-1)
    return tie | edge


def pca_normals(xyz: torch.Tensor, idx: torch.Tensor, d2: torch.Tensor,
                radius: float, dtype):
    """((L, N, 3) unit normals, (L, N) degenerate): the smallest eigenvector
    of the covariance of each point's neighbours within `radius`, and where
    the two smallest eigenvalues leave it undecided."""
    L, N, k = idx.shape
    x = xyz.to(dtype)
    neigh = x[torch.arange(L, device=x.device)[:, None, None], idx]
    w = (d2[..., :k] <= radius * radius).to(dtype)[..., None]
    cnt = w.sum(2).clamp_min(1.0)
    mean = (neigh * w).sum(2) / cnt
    d = (neigh - mean[:, :, None, :]) * w
    cov = (d.transpose(2, 3) @ d) / cnt[..., None]
    # LAPACK on the host: cuSOLVER's batched solver refuses this many 3 x 3s
    val, vec = torch.linalg.eigh(cov.to("cpu", torch.float64 if dtype == torch.float64
                                        else torch.float32))
    degenerate = (val[..., 1] - val[..., 0]) <= DEGENERATE_RTOL * val[..., 2]
    n = vec[..., :, 0].to(x.device, dtype)
    degenerate = degenerate.to(x.device)
    return n / n.norm(dim=-1, keepdim=True), degenerate


def normalize(xyz: torch.Tensor, dtype):
    """(normalized xyz, centre (L, 1, 3), scale (L, 1, 1)) in dtype."""
    x = xyz.to(dtype)
    centre = x.mean(dim=1, keepdim=True)
    scale = (x.amax(dim=1) - x.amin(dim=1)).amax(dim=-1)[:, None, None]
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    return (x - centre) / scale, centre, scale


class _Greedy:
    """The greedy's state over L clouds (L, N) and one step of it."""

    def __init__(self, pts: torch.Tensor, eps: float, start: int):
        L, N, _ = pts.shape
        self.x = pts[..., :3].contiguous()
        self.n = pts[..., 3:6].contiguous()
        self.eps = eps
        self.rows = torch.arange(L, device=pts.device)
        dt, dev = pts.dtype, pts.device
        self.sign = torch.zeros((L, N), dtype=dt, device=dev)
        self.visited = torch.zeros((L, N), dtype=torch.bool, device=dev)
        self.neg_inf = torch.tensor(-float("inf"), dtype=dt, device=dev)
        self.one = torch.tensor(1.0, dtype=dt, device=dev)
        self.true = torch.tensor(True, device=dev)
        c = torch.full((L,), start, dtype=torch.int64, device=dev)
        self.sign[self.rows, c] = 1.0
        self.visited[self.rows, c] = True
        self.acc = self.column(c)

    def column(self, c: torch.Tensor) -> torch.Tensor:
        """(L, N): the interaction of each lane's source c at every point:
        the field of dipole c along each point's normal (the reference
        fork's field_utils.py interaction, denominators r^3 + eps)."""
        xc = self.x[self.rows, c][:, None, :]
        nc = self.n[self.rows, c][:, :, None]
        R = xc - self.x
        r2 = (R * R).sum(-1)
        denom = torch.sqrt(r2) * r2 + self.eps
        cdot = (R @ nc)[..., 0]
        Rn = (R * self.n).sum(-1)
        pn = (self.n @ nc)[..., 0]
        zero = r2 == 0
        safe = torch.where(zero, self.one, r2)
        col = pn / denom - 3.0 * cdot * Rn / (safe * denom)
        return torch.where(zero, torch.zeros_like(col), col)

    def step(self) -> None:
        masked = torch.where(self.visited, self.neg_inf, self.acc.abs())
        c = masked.argmax(dim=1)
        a = self.acc[self.rows, c]
        s = torch.where(a < 0, -self.one, self.one)
        self.sign[self.rows, c] = s
        self.visited[self.rows, c] = self.true
        self.acc.add_(s[:, None] * self.column(c))


def _run(step, count: int, device) -> None:
    """step() `count` times; on a card in CUDA graphs of GRAPH_STEPS steps
    (each step's launches replayed without the host), the rest eagerly."""
    if device.type != "cuda" or count < 2 * GRAPH_STEPS:
        for _ in range(count):
            step()
        return
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        step()                                   # warms the capture's kernels
    torch.cuda.current_stream(device).wait_stream(side)
    count -= 1
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_STEPS):
            step()
    for _ in range(count // GRAPH_STEPS):
        graph.replay()
    for _ in range(count % GRAPH_STEPS):
        step()
    torch.cuda.synchronize(device)
    del graph


def greedy(pts: torch.Tensor, eps: float, start: int = 0):
    """(acc, sign) (L, N) of the strongest-field greedy over each lane's
    (N, 6) cloud: from `start` (sign +1), N - 1 times visit the unvisited
    point of largest |acc| (the lowest index on a tie), give it the sign of
    its acc (+1 at 0), and add its signed column to acc."""
    g = _Greedy(pts, eps, start)
    _run(g.step, pts.shape[1] - 1, pts.device)
    return g.acc, g.sign


def gen_grid(n: int = 10) -> np.ndarray:
    """The n^3 lattice 2 (k / n - 0.5), x-major, z fastest."""
    k = np.arange(n, dtype=np.float64)
    g = np.stack(np.meshgrid(k, k, k, indexing="ij"), axis=-1).reshape(-1, 3)
    return 2.0 * (g / n - 0.5)


def mean_potential(pts: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """(L,) mean over the lattice of the dipole potential of each lane's
    oriented cloud, sum over sources of (n . R) / |R|^3 with R = source -
    target (non-finite sums count 0)."""
    L, N, _ = pts.shape
    phi = torch.zeros((L, grid.shape[0]), dtype=pts.dtype, device=pts.device)
    for b in range(0, N, POTENTIAL_SOURCE_BLOCK):
        s = pts[:, b:b + POTENTIAL_SOURCE_BLOCK]
        R = s[:, None, :, :3] - grid[None, :, None, :]
        r2 = (R * R).sum(-1)
        c = (R * s[:, None, :, 3:6]).sum(-1)
        phi = phi + (c / (r2 * torch.sqrt(r2))).sum(-1)
    phi = torch.where(torch.isfinite(phi), phi, torch.zeros_like(phi))
    return phi.mean(-1)


def orient(points, max_nn: int = 30, radius: float = 0.1, diffuse: bool = False,
           eps: float = 1e-6, dtype=torch.float64, device="cpu"):
    """Orient L clouds of N points. points: (L, N, 3) as the program receives
    them (cast to float32 first, as the program does). Returns (out (L, N, 6)
    float64 numpy in the original frame, undecided (L, N) bool numpy)."""
    dev = torch.device(device)
    xyz32 = torch.as_tensor(np.asarray(points, dtype=np.float32)[..., :3], device=dev)
    k = min(max_nn, xyz32.shape[1])
    idx, d2 = knn(xyz32, k)
    loose = undecided(d2, k, radius)
    normals, degenerate = pca_normals(xyz32, idx, d2, radius, dtype)
    loose = loose | degenerate
    del idx, d2
    x, centre, scale = normalize(xyz32, dtype)
    pts = torch.cat([x, normals], dim=-1).contiguous()
    acc, sign = greedy(pts, eps)
    if diffuse:
        sign = sign * torch.where(acc * sign > 0, 1.0, -1.0).to(dtype)
    oriented = torch.cat([x, normals * sign[..., None]], dim=-1)
    grid = torch.as_tensor(gen_grid(10), dtype=dtype, device=dev)
    flip = torch.where(mean_potential(oriented, grid) < 0, -1.0, 1.0).to(dtype)
    out = torch.cat([x * scale + centre, normals * (sign * flip[:, None])[..., None]], -1)
    return out.to(torch.float64).cpu().numpy(), loose.cpu().numpy()


def judge(points, outputs, reference, loose) -> dict:
    """The compared numbers of L answers (None where one never came) against
    the reference's: oriented_gap, the largest 1 - cos between an answer's
    oriented normal and the reference's over the points whose neighbourhood
    is decided; and xyz_gap, the largest distance between an answer's point
    and the point sent, over the cloud's largest bounding-box edge. A
    missing answer reads inf in both."""
    if any(o is None for o in outputs):
        return {"oriented_gap": float("inf"), "xyz_gap": float("inf")}
    pts = np.asarray(points, np.float64)[..., :3]
    out = np.stack([np.asarray(o, np.float64) for o in outputs])
    ref = np.asarray(reference, np.float64)
    a, b = out[..., 3:6], ref[..., 3:6]
    cos = (a * b).sum(-1) / np.maximum(np.linalg.norm(a, axis=-1)
                                       * np.linalg.norm(b, axis=-1), 1e-300)
    cos = np.where(np.isfinite(cos), cos, -1.0)
    gap = np.where(loose, 0.0, 1.0 - cos)
    scale = (pts.max(axis=1) - pts.min(axis=1)).max(axis=-1)
    dist = np.linalg.norm(out[..., :3] - pts, axis=-1).max(axis=-1) / scale
    return {"oriented_gap": float(gap.max()),
            "xyz_gap": float(np.nan_to_num(dist, nan=np.inf).max())}
