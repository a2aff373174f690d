// Dense dipole interaction matrix I[i, j] = E_j(x_i) . n_i, (N_t, N_s)
// row-major float32, eps 1e-6 by default. Coincident pairs and non-finite
// entries are 0.
//
// Replaces: dipole_tpu/ops/fields_pallas.py:_dipole_imatrix_kernel (via
// dipole_interaction_matrix_pallas). The TPU build itself computes this
// matrix with the XLA fields.dipole_interaction_matrix; the port's greedy
// matrix tier (N <= MATRIX_LIMIT) reads rows of this kernel's output.
//
// What bounds it on an H100: bytes written. At N = 10000 the output is
// 400 MB (0.12 ms at 3.35 TB/s) against ~30 flops per entry (3e9 flops,
// 0.045 ms at 67 TFLOP/s fp32).
//
// Design: a block owns kCols consecutive columns and kRows rows; each
// thread keeps its source j in registers and writes its column of the
// kRows rows, so every row store of a warp is 128 contiguous bytes
// (coalesced along j). The kRows target points are staged in shared memory.
//
// Arithmetic: common.cuh's dipole_pair, the two-divide XLA formula of
// dipole_tpu/ops/fields.py:287-302, so kernel and plain version agree bit
// for bit. The Pallas kernel's single-reciprocal form
// (fields_pallas.py:228-229) differs from both in the last bits.
//
// The mirror-field ("xie") matrix, xie_imatrix below, replaces
// dipole_tpu/ops/fields_pallas.py:_xie_imatrix_kernel (:234-254, via
// xie_interaction_matrix_pallas :298). The same design and bound (N^2 x 4 B
// written: 0.12 ms at 10k, 1.07 ms at 30k), with common.cuh's xie_pair. That
// matrix is symmetric in exact arithmetic but not in float32 ((C nsR) ntR
// rounds unlike (C ntR) nsR), and the sequential xie loop reads columns
// while the replay reads rows; so the kernel writes either I or I^T, with
// the register point as source or as target, and each path reads contiguous
// rows of the one array it holds.

#include "common.cuh"

namespace {

constexpr int kCols = 256;  // threads per block, one column each
constexpr int kRows = 8;    // target rows per block

__global__ void __launch_bounds__(kCols)
imatrix_kernel(const float* __restrict__ tgt, int n_t,
               const float* __restrict__ src, int n_s, float eps,
               float* __restrict__ out) {
  __shared__ float t[6][kRows];
  const int j = blockIdx.x * kCols + threadIdx.x;
  const int n_row_blocks = (n_t + kRows - 1) / kRows;
  float sx = 0.f, sy = 0.f, sz = 0.f, px = 0.f, py = 0.f, pz = 0.f;
  if (j < n_s) {
    const float* s = src + 6 * (size_t)j;
    sx = s[0]; sy = s[1]; sz = s[2];
    px = s[3]; py = s[4]; pz = s[5];
  }
  for (int rb = blockIdx.y; rb < n_row_blocks; rb += gridDim.y) {
    const int i0 = rb * kRows;
    if (threadIdx.x < 6 * kRows) {
      const int r = threadIdx.x / 6, c = threadIdx.x % 6;
      t[c][r] = (i0 + r < n_t) ? tgt[6 * (size_t)(i0 + r) + c] : 0.f;
    }
    __syncthreads();
    if (j < n_s) {
      const int rows = min(kRows, n_t - i0);
      for (int r = 0; r < rows; ++r) {
        out[(size_t)(i0 + r) * n_s + j] =
            dipole_pair(sx, sy, sz, px, py, pz, t[0][r], t[1][r], t[2][r],
                        t[3][r], t[4][r], t[5][r], eps);
      }
    }
    __syncthreads();
  }
}

// The xie matrix in either layout. Each thread keeps one point of `reg` in
// registers and writes its column of kRows staged points of `rows`:
// out[r * n_reg + j] = xie_pair(source, target), where the register point
// is the source (kRegIsSource, out = I with rows the targets) or the target
// (out = I^T, rows the sources). Both layouts hold the same bits, entry for
// entry, and both store 128 contiguous bytes per warp and row.
template <bool kRegIsSource>
__global__ void __launch_bounds__(kCols)
xie_kernel(const float* __restrict__ rows_pts, int n_rows,
           const float* __restrict__ reg_pts, int n_reg, float C,
           float* __restrict__ out) {
  __shared__ float t[6][kRows];
  const int j = blockIdx.x * kCols + threadIdx.x;
  const int n_row_blocks = (n_rows + kRows - 1) / kRows;
  float qx = 0.f, qy = 0.f, qz = 0.f, qnx = 0.f, qny = 0.f, qnz = 0.f;
  if (j < n_reg) {
    const float* a = reg_pts + 6 * (size_t)j;
    qx = a[0]; qy = a[1]; qz = a[2];
    qnx = a[3]; qny = a[4]; qnz = a[5];
  }
  for (int rb = blockIdx.y; rb < n_row_blocks; rb += gridDim.y) {
    const int i0 = rb * kRows;
    if (threadIdx.x < 6 * kRows) {
      const int r = threadIdx.x / 6, c = threadIdx.x % 6;
      t[c][r] = (i0 + r < n_rows) ? rows_pts[6 * (size_t)(i0 + r) + c] : 0.f;
    }
    __syncthreads();
    if (j < n_reg) {
      const int rows = min(kRows, n_rows - i0);
      for (int r = 0; r < rows; ++r) {
        out[(size_t)(i0 + r) * n_reg + j] =
            kRegIsSource
                ? xie_pair(qx, qy, qz, qnx, qny, qnz, t[0][r], t[1][r],
                           t[2][r], t[3][r], t[4][r], t[5][r], C)
                : xie_pair(t[0][r], t[1][r], t[2][r], t[3][r], t[4][r],
                           t[5][r], qx, qy, qz, qnx, qny, qnz, C);
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// tgt (n_t, 6) and src (n_s, 6) row-major float32 on the device; out
// (n_t, n_s). Returns cudaGetLastError().
int dipole_imatrix(const float* tgt, int n_t, const float* src, int n_s,
                   float eps, float* out, cudaStream_t stream) {
  if (n_t <= 0 || n_s <= 0) return 0;
  const int col_blocks = (n_s + kCols - 1) / kCols;
  const int row_blocks = min((n_t + kRows - 1) / kRows, 65535);
  imatrix_kernel<<<dim3(col_blocks, row_blocks), kCols, 0, stream>>>(
      tgt, n_t, src, n_s, eps, out);
  return static_cast<int>(cudaGetLastError());
}

// The xie matrix of tgt (n_t, 6) and src (n_s, 6): out is I (n_t, n_s)
// when transposed == 0, I^T (n_s, n_t) otherwise. Returns cudaGetLastError().
int xie_imatrix(const float* tgt, int n_t, const float* src, int n_s,
                float C, int transposed, float* out, cudaStream_t stream) {
  if (n_t <= 0 || n_s <= 0) return 0;
  const float* rows = transposed ? src : tgt;
  const float* reg = transposed ? tgt : src;
  const int n_rows = transposed ? n_s : n_t;
  const int n_reg = transposed ? n_t : n_s;
  const dim3 grid((n_reg + kCols - 1) / kCols,
                  min((n_rows + kRows - 1) / kRows, 65535));
  if (transposed) {
    xie_kernel<false><<<grid, kCols, 0, stream>>>(rows, n_rows, reg, n_reg, C,
                                                  out);
  } else {
    xie_kernel<true><<<grid, kCols, 0, stream>>>(rows, n_rows, reg, n_reg, C,
                                                 out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
