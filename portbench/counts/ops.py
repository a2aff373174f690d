"""Operations and bytes of the kernels on the cells' paths, as functions of
shapes (add, sub, mul, div and sqrt count one each).

The per-pair constants are frozen copies of chip_smoke.py's OPS_*
(chip_smoke.py:269-283), counted there from the kernels' formulas; a later
rewrite of a kernel does not change what its time is divided by. Inputs are
counted as read once and outputs as written once.
"""
from __future__ import annotations

OPS_POTENTIAL = 17
OPS_IMATRIX = 33
OPS_GREEDY_COLUMN = 37        # the column entry + the acc update and |acc|
OPS_GREEDY_ROW = 4            # the acc update and |acc|
OPS_FIELD = 33                # the pair terms and both sums
OPS_GROUP = OPS_IMATRIX + 1   # the entry and its sum
OPS_KNN = 9                   # d2 and at least one comparison per pair
OPS_FPS = 10                  # d2, the running minimum and the argmax
OPS_XIE = 31                  # the xie entry (common.cuh's xie_pair)
OPS_GREEDY_XIE = 4            # rate update (2), acc += rate, the compare
OPS_REPLAY = 2                # one multiply-add per entry and order
# the tensor-core field variants, per pair: the pair math left on the CUDA
# cores, and the products (x 3 passes of 3xTF32) on the tensor cores
OPS_MXU = {"field_mxu_exact": (21, 16), "field_mxu_expansion": (12, 28)}
TF32_PASSES = 3
F32 = 4                       # bytes of a float32
SIGN_FIX_GRID = 10 ** 3       # the lattice the global sign fix averages over


def greedy_columns(n: int):
    """(operations, bytes) of the column greedy over n points: n columns of
    n entries; reads (n, 6), writes acc and sign."""
    return OPS_GREEDY_COLUMN * n * n, F32 * (6 * n + 2 * n)


def potential(n_src: int, n_tgt: int):
    """(operations, bytes) of the dipole potential of n_src sources at
    n_tgt targets."""
    return OPS_POTENTIAL * n_src * n_tgt, F32 * (6 * n_src + 3 * n_tgt + n_tgt)


def orient_simple_call(n: int):
    """Device operations that one orient_simple call on n points needs: the
    greedy's n^2 pair interactions (37 operations a pair, whether a column
    is computed on the fly or read from the matrix tier's precomputed
    matrix: 33 + 4) and the sign fix's potential. The host kNN is not device
    work; the PCA's few operations a point are left out."""
    return greedy_columns(n)[0] + potential(n, SIGN_FIX_GRID)[0]
