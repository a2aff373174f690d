// Point-group interaction: F[i, g] = sum over sources j of group g of
// I[i, j], I[i, j] = E_j(x_i) . n_i (eps 1e-5 on the patch paths), without
// building I. Groups with no source give 0.
//
// Replaces: dipole_tpu/ops/fields_pallas.py:_group_kernel (via
// point_group_interaction_pallas), the core of strongest-field patch and
// representative propagation (dipole_tpu/ops/propagate.py:353-362).
//
// What bounds it on an H100: operations. N targets x N sources pairs of
// ~34 flops (a sqrt and two divides each) against 4 N G bytes of output:
// at N = 150k, G = 400 that is 7.7e11 flops (11 ms at 67 TFLOP/s fp32)
// against 240 MB (0.07 ms at 3.35 TB/s).
//
// Design: the wrapper sorts the sources by group (stable, so each group
// keeps index order) and passes the group offsets. The grid is (target
// tiles) x (groups); a block stages its group's sources in shared memory
// kTile at a time, and each thread sums its target over them in index order
// and writes F once: no atomics, the same sum on every run. The output is
// written transposed, Ft (G, N_t), so that the threads of a warp store 128
// contiguous bytes; the wrapper hands back the (N_t, G) view.
//
// Arithmetic: common.cuh's dipole_pair, the entries of imatrix.cu bit for
// bit. The JAX package sums them through a one-hot matmul
// (dipole_tpu/ops/fields.py:431-447): the totals agree to a relative
// tolerance against sum |I|, not bit for bit.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // targets per block
constexpr int kTile = 128;     // sources staged in shared memory at a time

__global__ void __launch_bounds__(kThreads)
group_kernel(const float* __restrict__ tgt, int n_t,
             const float* __restrict__ src, const int* __restrict__ offsets,
             int n_groups, float eps, float* __restrict__ out_t) {
  __shared__ float s[6][kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n_t;
  float t[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (live) {
#pragma unroll
    for (int c = 0; c < 6; ++c) t[c] = tgt[6 * (size_t)i + c];
  }
  for (int g = blockIdx.y; g < n_groups; g += gridDim.y) {
    const int begin = offsets[g];
    const int end = offsets[g + 1];
    float acc = 0.f;
    for (int base = begin; base < end; base += kTile) {
      const int j = base + threadIdx.x;
      if (j < end) {
#pragma unroll
        for (int c = 0; c < 6; ++c) s[c][threadIdx.x] = src[6 * (size_t)j + c];
      }
      __syncthreads();
      const int m = min(kTile, end - base);
      for (int k = 0; k < m; ++k) {
        acc += dipole_pair(s[0][k], s[1][k], s[2][k], s[3][k], s[4][k],
                           s[5][k], t[0], t[1], t[2], t[3], t[4], t[5], eps);
      }
      __syncthreads();
    }
    if (live) out_t[(size_t)g * n_t + i] = acc;
  }
}

}  // namespace

extern "C" {

// tgt (n_t, 6) and src (n_s, 6) row-major float32 on the device, src sorted
// by group; offsets (n_groups + 1) int32, group g's sources are
// src[offsets[g]:offsets[g + 1]]; out_t (n_groups, n_t). Returns
// cudaGetLastError().
int dipole_group(const float* tgt, int n_t, const float* src,
                 const int* offsets, int n_groups, float eps, float* out_t,
                 cudaStream_t stream) {
  if (n_t <= 0 || n_groups <= 0) return 0;
  const int t_blocks = (n_t + kThreads - 1) / kThreads;
  const int g_blocks = min(n_groups, 65535);
  group_kernel<<<dim3(t_blocks, g_blocks), kThreads, 0, stream>>>(
      tgt, n_t, src, offsets, n_groups, eps, out_t);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
