"""Binary pairwise flip-assignment solvers — license-free MIQP replacement;
the port's own copy of dipole_tpu/ops/solve.py.

The reference solves, with the Gurobi MIQP solver, problems of the form

    optimize over x in {0,1}^n :  sum_ij A_ij (1 - xor_ij) + B_ij xor_ij
    with xor_ij = (x_i - x_j)^2

at two call sites (reference graph.py:433-470, field_utils.py:608-646):
  * multi-start vote alignment (n = times <= ~9)  — field_utils MIQP
    *minimizes* the objective (it maximizes -loss);
  * patch-graph flip assignment (n = #patches)    — graph.py MIQP
    *maximizes* it.

Here: exact vectorized enumeration for n <= exact_limit (2^n assignments),
and greedy spanning-tree initialization + iterated local search for larger
graphs. No solver license involved; for the vote-alignment sizes the result
is provably optimal. The local search is the native library's
(native.flip_local_search), as in the JAX package; it has no Python
fallback here.
"""
from __future__ import annotations

import numpy as np

from dipole_tpu_torch import native

__all__ = ["cal_loss", "solve_flip_assignment", "miqp_min", "miqp_max"]


def cal_loss(x, A, B) -> float:
    """Objective value for assignment x (reference graph.py:433-442)."""
    x = np.asarray(x, dtype=np.float64)
    A = np.asarray(A, dtype=np.float64)
    B = np.asarray(B, dtype=np.float64)
    xor = (x[:, None] - x[None, :]) ** 2
    return float((A * (1.0 - xor) + B * xor).sum())


def _objective_batch(X: np.ndarray, M: np.ndarray, const: float) -> np.ndarray:
    """obj(x) = const + sum_ij M_ij xor_ij for a batch of assignments X."""
    X = X.astype(np.float64)
    # xor_ij = x_i + x_j - 2 x_i x_j
    xi = X @ M.sum(axis=1)
    xj = X @ M.sum(axis=0)
    xij = np.einsum("bi,ij,bj->b", X, M, X)
    return const + xi + xj - 2.0 * xij


def _enumerate_exact(M: np.ndarray, const: float, minimize: bool) -> np.ndarray:
    n = M.shape[0]
    best_x = None
    best_v = None
    total = 1 << n
    chunk = 1 << min(n, 14)
    bits = np.arange(n)
    for start in range(0, total, chunk):
        idx = np.arange(start, min(start + chunk, total))[:, None]
        X = ((idx >> bits[None, :]) & 1).astype(np.float64)
        vals = _objective_batch(X, M, const)
        k = int(vals.argmin() if minimize else vals.argmax())
        v = vals[k]
        if best_v is None or (v < best_v if minimize else v > best_v):
            best_v = v
            best_x = X[k]
    return best_x.astype(np.float64)


def _greedy_tree_init(M: np.ndarray, minimize: bool) -> np.ndarray:
    """Orient along a maximum-|weight| spanning tree: strong pairwise
    preferences are satisfied first (Prim's algorithm, dense)."""
    n = M.shape[0]
    W = M + M.T  # xor coefficient; want xor_ij = 1 iff sgn*W_ij > 0
    sgn = -1.0 if minimize else 1.0
    x = np.zeros(n)
    in_tree = np.zeros(n, dtype=bool)
    in_tree[0] = True
    best = np.abs(W[0]).copy()
    parent = np.zeros(n, dtype=int)
    for _ in range(n - 1):
        cand = np.where(~in_tree, best, -np.inf)
        j = int(cand.argmax())
        if not np.isfinite(cand[j]):
            j = int(np.where(~in_tree)[0][0])
        p = parent[j]
        want_xor = (sgn * W[p, j]) > 0
        x[j] = 1.0 - x[p] if want_xor else x[p]
        in_tree[j] = True
        better = np.abs(W[j]) > best
        best = np.where(better, np.abs(W[j]), best)
        parent = np.where(better, j, parent)
    return x


def solve_flip_assignment(A, B, minimize: bool, exact_limit: int = 20,
                          restarts: int = 8, seed: int = 0) -> np.ndarray:
    """Solve the binary pairwise flip problem. Returns x in {0,1}^n.

    minimize=True matches the reference's vote-alignment call
    (field_utils.py:619-646, maximize -loss); minimize=False matches the
    patch-graph call (graph.py:444-470)."""
    A = np.asarray(A, dtype=np.float64)
    B = np.asarray(B, dtype=np.float64)
    n = A.shape[0]
    if n == 0:
        return np.zeros(0)
    const = float(A.sum())
    M = B - A  # obj = const + sum_ij M_ij xor_ij
    if n <= exact_limit:
        return _enumerate_exact(M, const, minimize)
    rng = np.random.default_rng(seed)
    best_x, best_v = None, None
    inits = [_greedy_tree_init(M, minimize), np.zeros(n)]
    inits += [rng.integers(0, 2, n).astype(np.float64) for _ in range(restarts)]
    for x0 in inits:
        x = native.flip_local_search(M, x0.astype(np.uint8), minimize)
        x = x.astype(np.float64)
        v = cal_loss(x, A, B)
        better = best_v is None or (v < best_v if minimize else v > best_v)
        if better:
            best_x, best_v = x, v
    return best_x


def miqp_min(A, B) -> np.ndarray:
    """Reference field_utils.MIQP semantics (minimize cal_loss)."""
    return solve_flip_assignment(A, B, minimize=True)


def miqp_max(A, B) -> np.ndarray:
    """Reference graph.MIQP semantics (maximize cal_loss)."""
    return solve_flip_assignment(A, B, minimize=False)
