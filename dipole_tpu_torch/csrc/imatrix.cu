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

}  // extern "C"
