// The strongest-field greedy ordering, the whole loop in one cooperative
// kernel.
//
// Replaces: dipole_tpu/ops/propagate_pallas.py:_greedy_kernel (VMEM-resident,
// N <= 131072), _greedy_streamed_kernel (HBM-streamed, N <= 1M) and
// _greedy_xl_kernel (state in HBM too, N <= 2^24) with one design over the
// whole range up to 2^24 points; and, in row mode, the XLA scan
// dipole_tpu/ops/propagate.py:_greedy_scan_matrix of the matrix tier.
//
// The loop: acc starts as the start point's vector and the start point is
// visited at +1. Then for N-1 steps: pick the unvisited point with the
// largest |acc| (ties to the lowest index), set its sign to -1 if its
// acc < 0 else +1, and add sign x its vector to acc. Exactly N-1 steps run:
// the JAX package's bucket padding, dead steps and launch segments were TPU
// artefacts. Two update modes share the loop:
//   row mode    reads row c of the precomputed matrix I (the matrix tier,
//               propagate.py:82-106: I[c] stands in for the column by
//               symmetry, as in the JAX scan);
//   column mode computes column c on the fly from the cloud, the formula of
//               propagate.py:_dipole_column (109-124).
// A third loop, the xie mode (xie_greedy_kernel below), runs the mirror-field
// propagation over rows of the transposed xie matrix on the same grid.
//
// What bounds it on an H100: latency. Each step depends on a global argmax
// over all of acc, so the grid meets at a barrier once a step; at N = 180k
// the barrier and the two block reductions around it cost more than the
// step's N interaction terms (~30 flops each, all of them L2-resident: the
// cloud is 24 B/pt, 4.3 MB at 180k, in the 50 MB L2).
//
// Design: a cooperative launch (cudaLaunchCooperativeKernel) with at most
// one block of 1024 threads per SM, capped at the co-resident count from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor (more blocks than fit would
// deadlock at the barrier). Thread t owns points t, t + T, t + 2T, ... for
// the whole run, so acc and sign are only ever touched by their owner. One
// step is one sweep: the owner adds s x column(c) to acc, marks c visited,
// and folds its points' masked |acc| into a (max, min-index, signed acc)
// candidate; the block reduces its candidates and publishes one, slot
// double-buffered by step parity; one grid.sync(); then every block reduces
// all the published candidates itself (the same winner in every block, no
// second barrier) and reads the winner's sign from the signed acc carried
// with it. Parity double-buffering is what makes one barrier enough: a block
// can overwrite step k's slots only at step k + 2, after the barrier of
// step k + 1, which every block reaches only after it has read step k's.
// Up to kOneBlockMaxN points the grid is one block, which syncs with
// __syncthreads alone: there that is cheaper than grid.sync() over blocks
// that each hold a few points (chip_smoke.py times the kernel on both sides
// of the threshold).
//
// Arithmetic: compiled with -fmad=false; sqrtf and / are IEEE, and the
// column follows propagate.py:_dipole_column term for term in the plain
// torch version's order (two divides, not the Pallas kernels'
// single-reciprocal form of propagate_pallas.py:73-74). The acc update adds
// s x col with s = +-1, which is exact before the one rounding of the add.
// So the kernel and its plain version agree bit for bit in acc and sign.

#include <climits>
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kOneBlockMaxN = 3 * kThreads;
constexpr int kMaxK = 256;  // kNN mask width of the xie mode

struct Cand {
  float v;  // |acc| of an unvisited point
  int i;    // its index
  float a;  // its signed acc
};

__device__ __forceinline__ bool better(float v, int i, const Cand& b) {
  return v > b.v || (v == b.v && i < b.i);
}

__device__ __forceinline__ void warp_reduce(Cand& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_down_sync(0xffffffffu, b.v, off);
    const int i = __shfl_down_sync(0xffffffffu, b.i, off);
    const float a = __shfl_down_sync(0xffffffffu, b.a, off);
    if (better(v, i, b)) b = Cand{v, i, a};
  }
}

// Block-wide (max, min-index) reduction; every thread gets the result.
__device__ Cand block_reduce(Cand b, Cand* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_reduce(b);
  if (lane == 0) sh[warp] = b;
  __syncthreads();
  if (warp == 0) {
    b = lane < (int)(blockDim.x >> 5) ? sh[lane] : Cand{-INFINITY, INT_MAX, 0.f};
    warp_reduce(b);
    if (lane == 0) sh[32] = b;
  }
  __syncthreads();
  const Cand r = sh[32];
  __syncthreads();
  return r;
}

// I[i, c] = E_c(x_i) . n_i from the (6, n) channel-major cloud.
__device__ __forceinline__ float column_entry(const float* __restrict__ pts,
                                              size_t n, int i, float sx,
                                              float sy, float sz, float spx,
                                              float spy, float spz, float eps) {
  const float x = pts[i], y = pts[n + i], z = pts[2 * n + i];
  const float nx = pts[3 * n + i], ny = pts[4 * n + i], nz = pts[5 * n + i];
  const float Rx = sx - x;
  const float Ry = sy - y;
  const float Rz = sz - z;
  const float r2 = Rx * Rx + Ry * Ry + Rz * Rz;
  const bool zero = r2 == 0.f;
  const float r = sqrtf(r2);
  const float denom = r * r2 + eps;
  const float cdot = Rx * spx + Ry * spy + Rz * spz;
  const float Rn = Rx * nx + Ry * ny + Rz * nz;
  const float pn = nx * spx + ny * spy + nz * spz;
  const float safe_r2 = zero ? 1.f : r2;
  const float col = -(3.f * cdot * Rn / (safe_r2 * denom) - pn / denom);
  return (zero || !isfinite(col)) ? 0.f : col;
}

template <bool kRows>
__global__ void __launch_bounds__(kThreads, 1)
greedy_kernel(const float* __restrict__ data, int n, int start, float eps,
              float* __restrict__ acc, float* __restrict__ sign,
              float* __restrict__ part_v, int* __restrict__ part_i,
              float* __restrict__ part_a) {
  __shared__ Cand sh[33];
  const size_t nn = n;
  const int stride = gridDim.x * blockDim.x;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  int c = start;
  float s = 1.f;
  for (int step = 0; step < n; ++step) {
    float sx = 0.f, sy = 0.f, sz = 0.f, spx = 0.f, spy = 0.f, spz = 0.f;
    if (!kRows) {
      sx = data[c]; sy = data[nn + c]; sz = data[2 * nn + c];
      spx = data[3 * nn + c]; spy = data[4 * nn + c]; spz = data[5 * nn + c];
    }
    Cand best{-INFINITY, INT_MAX, 0.f};
    for (int i = tid; i < n; i += stride) {
      const float col = kRows ? data[(size_t)c * nn + i]
                              : column_entry(data, nn, i, sx, sy, sz, spx,
                                             spy, spz, eps);
      float a, sg;
      if (step == 0) {
        a = col;
        sg = (i == start) ? 1.f : 0.f;
        sign[i] = sg;
      } else {
        a = acc[i] + s * col;
        sg = sign[i];
        if (i == c) {
          sg = s;
          sign[i] = s;
        }
      }
      acc[i] = a;
      if (sg == 0.f && better(fabsf(a), i, best)) best = Cand{fabsf(a), i, a};
    }
    if (step == n - 1) break;
    best = block_reduce(best, sh);
    const int slot = (step & 1) * gridDim.x;
    if (threadIdx.x == 0) {
      part_v[slot + blockIdx.x] = best.v;
      part_i[slot + blockIdx.x] = best.i;
      part_a[slot + blockIdx.x] = best.a;
    }
    if (gridDim.x > 1) {
      cg::this_grid().sync();
    } else {
      __syncthreads();
    }
    Cand win{-INFINITY, INT_MAX, 0.f};
    for (int k = threadIdx.x; k < (int)gridDim.x; k += blockDim.x) {
      // L2 reads: the slots were written by other SMs
      const float v = __ldcg(part_v + slot + k);
      const int i = __ldcg(part_i + slot + k);
      if (better(v, i, win)) win = Cand{v, i, __ldcg(part_a + slot + k)};
    }
    win = block_reduce(win, sh);
    c = win.i;
    s = win.a < 0.f ? -1.f : 1.f;
  }
}

// The mirror-field ("xie") sequential loop (xie mode), which replaces the
// XLA scan dipole_tpu/ops/propagate.py:_xie_greedy_scan (:509-555). It
// keeps a rate vector besides acc: rate starts as the start point's column
// and acc at 0; each step adds rate to acc, picks the unvisited point with
// the largest SIGNED acc (ties to the lowest index), sets its sign to -1 iff
// its acc < 0, and adds sign x its column to rate, in that order. IT is the
// (n, n) transposed xie matrix, so column c of I is the contiguous row c of
// IT. knn (n, k), when k > 0, is the kNN mask in index form: column c is
// multiplied by 1 at the rows knn[c] and by 0 elsewhere, as the JAX scan
// does, without a dense mask. Every update is elementwise with s = +-1, so
// kernel and plain version agree bit for bit in acc and sign. The grid, the
// candidate reduction and the one barrier per step are the greedy's above;
// the sweep count is the same: n sweeps, n - 1 picks, and acc += rate in
// all but the last sweep (n - 1 additions, as the JAX scan's n - 1 steps).
__global__ void __launch_bounds__(kThreads, 1)
xie_greedy_kernel(const float* __restrict__ IT, int n, int start,
                  const int* __restrict__ knn, int k,
                  float* __restrict__ acc, float* __restrict__ rate,
                  float* __restrict__ sign, float* __restrict__ part_v,
                  int* __restrict__ part_i, float* __restrict__ part_a) {
  __shared__ Cand sh[33];
  __shared__ int hits[kMaxK];
  const size_t nn = n;
  const int stride = gridDim.x * blockDim.x;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  int c = start;
  float s = 1.f;
  for (int step = 0; step < n; ++step) {
    if (k > 0) {
      for (int m = threadIdx.x; m < k; m += blockDim.x) {
        hits[m] = knn[(size_t)c * k + m];
      }
      __syncthreads();
    }
    const float* col = IT + (size_t)c * nn;
    const bool add = step < n - 1;
    Cand best{-INFINITY, INT_MAX, 0.f};
    for (int i = tid; i < n; i += stride) {
      float v = col[i];
      if (k > 0) {
        bool hit = false;
        for (int m = 0; m < k; ++m) hit |= hits[m] == i;
        v = v * (hit ? 1.f : 0.f);
      }
      float r, a, sg;
      if (step == 0) {
        r = v;
        sg = (i == start) ? 1.f : 0.f;
        sign[i] = sg;
        a = add ? 0.f + r : 0.f;
      } else {
        sg = sign[i];
        if (i == c) {
          sg = s;
          sign[i] = s;
        }
        r = rate[i] + s * v;
        a = acc[i];
        if (add) a = a + r;
      }
      rate[i] = r;
      acc[i] = a;
      if (sg == 0.f && better(a, i, best)) best = Cand{a, i, a};
    }
    if (!add) break;
    best = block_reduce(best, sh);
    const int slot = (step & 1) * gridDim.x;
    if (threadIdx.x == 0) {
      part_v[slot + blockIdx.x] = best.v;
      part_i[slot + blockIdx.x] = best.i;
      part_a[slot + blockIdx.x] = best.a;
    }
    if (gridDim.x > 1) {
      cg::this_grid().sync();
    } else {
      __syncthreads();
    }
    Cand win{-INFINITY, INT_MAX, 0.f};
    for (int q = threadIdx.x; q < (int)gridDim.x; q += blockDim.x) {
      const float v = __ldcg(part_v + slot + q);
      const int i = __ldcg(part_i + slot + q);
      if (better(v, i, win)) win = Cand{v, i, __ldcg(part_a + slot + q)};
    }
    win = block_reduce(win, sh);
    c = win.i;
    s = win.a < 0.f ? -1.f : 1.f;
  }
}

// Grid of a cooperative greedy launch over n points: one block up to
// kOneBlockMaxN points, above that one block per SM, or fewer for small n,
// and never more than part_capacity. Returns a cudaError_t value.
int greedy_grid(void* kernel, int n, int part_capacity, int* blocks) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop || per_sm < 1) return static_cast<int>(cudaErrorNotSupported);
  // one block per SM at most; per_sm >= 1, so all of them are co-resident
  int b = n <= kOneBlockMaxN ? 1 : min((n + kThreads - 1) / kThreads, sms);
  *blocks = min(b, part_capacity);
  return 0;
}

}  // namespace

extern "C" {

// Runs the greedy over n points from `start`. rows != 0: data is the
// (n, n) row-major interaction matrix; rows == 0: data is the (6, n)
// channel-major cloud [x, y, z, nx, ny, nz] and eps enters the column.
// acc and sign are (n,) outputs; part_v/part_i/part_a are scratch of
// 2 x part_capacity entries each. The grid is one block up to
// kOneBlockMaxN points, above that one block per SM, or fewer for small n.
// *blocks_out receives the grid size.
// Returns a cudaError_t value (0 on success).
int dipole_greedy(const float* data, int n, int start, float eps, int rows,
                  float* acc, float* sign, float* part_v, int* part_i,
                  float* part_a, int part_capacity, int* blocks_out,
                  cudaStream_t stream) {
  if (n <= 0 || start < 0 || start >= n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* kernel = rows ? (void*)greedy_kernel<true> : (void*)greedy_kernel<false>;
  int blocks = 0;
  int e = greedy_grid(kernel, n, part_capacity, &blocks);
  if (e != 0) return e;
  *blocks_out = blocks;
  void* args[] = {(void*)&data, (void*)&n,     (void*)&start,
                  (void*)&eps,  (void*)&acc,   (void*)&sign,
                  (void*)&part_v, (void*)&part_i, (void*)&part_a};
  cudaError_t err = cudaLaunchCooperativeKernel(kernel, dim3(blocks),
                                                dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The xie mode: the loop of xie_greedy_kernel over the (n, n) transposed
// xie matrix IT from `start`; knn (n, k) int32 or k == 0 for no mask. acc,
// rate and sign are (n,) outputs; the scratch and the grid as
// dipole_greedy's. Returns a cudaError_t value (0 on success).
int dipole_xie_greedy(const float* IT, int n, int start, const int* knn,
                      int k, float* acc, float* rate, float* sign,
                      float* part_v, int* part_i, float* part_a,
                      int part_capacity, int* blocks_out,
                      cudaStream_t stream) {
  if (n <= 0 || start < 0 || start >= n || k < 0 || k > kMaxK ||
      (k > 0 && knn == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* kernel = (void*)xie_greedy_kernel;
  int blocks = 0;
  int e = greedy_grid(kernel, n, part_capacity, &blocks);
  if (e != 0) return e;
  *blocks_out = blocks;
  void* args[] = {(void*)&IT,   (void*)&n,      (void*)&start,
                  (void*)&knn,  (void*)&k,      (void*)&acc,
                  (void*)&rate, (void*)&sign,   (void*)&part_v,
                  (void*)&part_i, (void*)&part_a};
  cudaError_t err = cudaLaunchCooperativeKernel(kernel, dim3(blocks),
                                                dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
