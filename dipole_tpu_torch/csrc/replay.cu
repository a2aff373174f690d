// The in-order replay: T propagation orders advanced in lock-step over one
// interaction matrix.
//
// Replaces: the XLA scan dipole_tpu/ops/propagate.py:_in_order_scan
// (:649-703; no Pallas twin), which carries xie_propagation_in_order and the
// BFS-tree voting. Step k, for every order t: idx = orders[t, k],
//   inter = sum_j I[idx, j] colw[j] mask(idx, j) w[t, j],
//   w[t, idx] = inter < 0 ? -1 : 1,  inter_rec[t, idx] = inter.
// colw (points_weight) is optional; mask(i, j) = [i in knn[j]], the kNN mask
// in index form, is optional too. The diffuse re-vote after the loop is a
// matrix product and stays in torch (ops/propagate.py).
//
// What bounds it on an H100: latency. The bytes are T rows of N floats per
// step (T N^2 x 4 B in all: 10.8 GB, 3.2 ms at 3.35 TB/s, for T = 3 at 30k),
// but every step depends on the previous one's decisions, so each order
// meets N times.
//
// Design: the orders never read each other's state, so each runs alone.
// Unmasked, one thread-block cluster of 8 or 16 blocks per order: each block
// sums its slice of the row, the cluster meets at its hardware barrier, and
// the block that owns column idx reads the others' partials from their
// shared memory (DSMEM), parity double-buffered as in greedy.cu, and writes
// the decision into its own slice; only the owner reads w[t, idx] later, so
// one barrier per step suffices. One block per order would stream each
// order's N^2 floats through one SM; one cooperative grid for all orders
// pays a barrier over all 132 SMs per step, and was slower than the
// clusters on every shape measured on an H100. The wrapper takes 16-block
// clusters while all T run at once (dipole_replay_max_clusters), else 8
// (PERF.md has both times).
// Masked, only the ~k sources j with idx in knn[j] enter a row's sum, so
// each order runs in one warp over the reverse kNN lists (rev_ptr/rev_src:
// the sources of each target, ascending), with no barrier at all.
//
// Determinism: w is 0 or +-1, so once I colw is rounded in float32 every
// product is exact in float64; sums run in float64 in a fixed order. The
// plain torch version sums in float64 in its own order, so kernel and plain
// version take the same decisions unless |inter| falls below ~1e-12 of the
// sum of |I w|, and agree in inter to ~1e-15 relative.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float entry(const float* __restrict__ row,
                                       const float* __restrict__ colw, int j) {
  const float v = row[j];
  return colw ? v * colw[j] : v;
}

__global__ void __launch_bounds__(32)
replay_masked_kernel(const float* __restrict__ I, int n, int steps,
                     const int* __restrict__ orders, int T,
                     const float* __restrict__ colw,
                     const int* __restrict__ rev_ptr,
                     const int* __restrict__ rev_src, float* __restrict__ w,
                     double* __restrict__ inter) {
  const int t = blockIdx.x;
  if (t >= T) return;
  const int lane = threadIdx.x;
  const size_t nn = n;
  float* wt = w + t * nn;
  for (int k = 0; k < steps; ++k) {
    const int idx = orders[t * (size_t)steps + k];
    const float* row = I + (size_t)idx * nn;
    double v = 0.0;
    for (int e = rev_ptr[idx] + lane; e < rev_ptr[idx + 1]; e += 32) {
      const int j = rev_src[e];
      v += (double)entry(row, colw, j) * (double)wt[j];
    }
    v = warp_sum(v);
    if (lane == 0) {
      inter[t * nn + idx] = v;
      wt[idx] = v < 0.0 ? -1.f : 1.f;
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads, 1)
replay_cluster_kernel(const float* __restrict__ I, int n, int steps,
                      const int* __restrict__ orders,
                      const float* __restrict__ colw, float* __restrict__ w,
                      double* __restrict__ inter) {
  __shared__ double part[2];
  __shared__ double sh[kWarps];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int t = blockIdx.x / cs;
  const size_t nn = n;
  const int per = (n + cs - 1) / cs;
  const int c0 = rank * per;
  const int c1 = min(n, c0 + per);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* wt = w + t * nn;
  for (int k = 0; k < steps; ++k) {
    const int idx = orders[t * (size_t)steps + k];
    const float* row = I + (size_t)idx * nn;
    double p = 0.0;
    for (int j = c0 + threadIdx.x; j < c1; j += kThreads) {
      p += (double)entry(row, colw, j) * (double)wt[j];
    }
    p = warp_sum(p);
    if (lane == 0) sh[warp] = p;
    __syncthreads();
    if (threadIdx.x == 0) {
      double v = 0.0;
      for (int q = 0; q < kWarps; ++q) v += sh[q];
      part[k & 1] = v;
    }
    cluster.sync();
    if (threadIdx.x == 0 && idx >= c0 && idx < c1) {
      double v = 0.0;
      for (int q = 0; q < cs; ++q) v += *cluster.map_shared_rank(&part[k & 1], q);
      inter[t * nn + idx] = v;
      wt[idx] = v < 0.0 ? -1.f : 1.f;
    }
    __syncthreads();
  }
  // no block may leave while another can still read its shared memory
  cluster.sync();
}

}  // namespace

extern "C" {

// *count: the most clusters of `size` blocks (8 or 16) of the unmasked
// replay that the card runs at once. Returns a cudaError_t value.
int dipole_replay_max_clusters(int size, int* count) {
  if (size != 8 && size != 16) return static_cast<int>(cudaErrorInvalidValue);
  if (size > 8) {
    cudaError_t e = cudaFuncSetAttribute(
        replay_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(size);
  cfg.blockDim = dim3(kThreads);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = size;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      count, (void*)replay_cluster_kernel, &cfg));
}

// Replays T orders (T, steps) int32 over the (n, n) row-major matrix I.
// colw (n,) or null. rev_ptr (n + 1,) and rev_src (n k,) int32 select the
// masked mode (one warp per order); null, the unmasked one with clusters of
// `cluster` blocks (8 or 16). w (T, n) float32 and inter (T, n) float64
// must be zero on entry and hold the decisions and the recorded
// interactions on return. Returns a cudaError_t value.
int dipole_replay(const float* I, int n, const int* orders, int T, int steps,
                  const float* colw, const int* rev_ptr, const int* rev_src,
                  int cluster, float* w, double* inter, cudaStream_t stream) {
  if (n <= 0 || T <= 0 || steps < 0 ||
      (rev_ptr == nullptr) != (rev_src == nullptr) ||
      (rev_ptr == nullptr && cluster != 8 && cluster != 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (steps == 0) return 0;
  if (rev_ptr != nullptr) {
    replay_masked_kernel<<<T, 32, 0, stream>>>(I, n, steps, orders, T, colw,
                                               rev_ptr, rev_src, w, inter);
    return static_cast<int>(cudaGetLastError());
  }
  if (cluster > 8) {
    cudaError_t e = cudaFuncSetAttribute(
        replay_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(T * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, replay_cluster_kernel, I, n, steps,
                                     orders, colw, w, inter);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
