// Batched masked farthest-point sampling: for each patch b, m selections
// starting at starts[b]. The running distance of a valid point starts at
// its d2 to the start and of an invalid point at -1; each step picks the
// largest running distance (lowest index on ties), then takes the minimum
// with every point's d2 to the pick. Invalid points are never chosen while
// a valid one has a positive distance. d2 = dx*dx + dy*dy + dz*dz with
// dx = x - x_pick. Output (B, m) int32, column 0 the start.
//
// Replaces: dipole_tpu/ops/neighbors_pallas.py:_fps_batch_kernel (via
// fps_masked_batch_pallas), the two pooling stages of every PointCNN
// forward (pointcnn.py:319-338); decisions as pointcnn._fps_masked
// (:183-200) mapped over the batch.
//
// What bounds it on an H100: latency. m - 1 dependent steps, each a
// block-wide argmax; the work, B (m - 1) N pairs of ~10 operations, is
// small ((256, 512, m 308): 4e8 operations, 6 us at 67 TFLOP/s).
//
// Design: one block per patch, kThreads threads; thread t holds the
// coordinates and running distance of points t + kThreads q in registers.
// A step is a local argmax, a warp shuffle argmax and a shared-memory
// argmax over the warps (largest value, then lowest index), and the
// winner's coordinates are read by every thread from device memory (one
// broadcast load, L1-resident).
//
// Arithmetic: -fmad=false, so the distances and hence every decision are
// bit-equal to the plain torch version (ops/neighbors.py).

#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kPer = 16;                          // points per thread
constexpr int kMaxPoints = kThreads * kPer;       // 8192
constexpr int kWarpsPerBlock = kThreads / 32;

__device__ __forceinline__ void argmax_pair(float* v, int* j, float v2, int j2) {
  if (v2 > *v || (v2 == *v && j2 < *j)) {
    *v = v2;
    *j = j2;
  }
}

__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ pos, const unsigned char* __restrict__ valid,
           int n, int m, const int* __restrict__ starts, int* __restrict__ out) {
  __shared__ float red_v[kWarpsPerBlock];
  __shared__ int red_j[kWarpsPerBlock];
  __shared__ int winner;
  const int b = blockIdx.x;
  const float* P = pos + (size_t)b * n * 3;
  const unsigned char* V = valid + (size_t)b * n;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  int c = starts[b];
  float x[kPer], y[kPer], z[kPer], mind[kPer];
  {
    const float cx = P[3 * c], cy = P[3 * c + 1], cz = P[3 * c + 2];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int j = threadIdx.x + q * kThreads;
      x[q] = y[q] = z[q] = 0.f;
      mind[q] = -INFINITY;  // out of range: never the maximum
      if (j < n) {
        x[q] = P[3 * j];
        y[q] = P[3 * j + 1];
        z[q] = P[3 * j + 2];
        const float dx = x[q] - cx, dy = y[q] - cy, dz = z[q] - cz;
        mind[q] = V[j] ? dx * dx + dy * dy + dz * dz : -1.f;
      }
    }
  }
  if (threadIdx.x == 0) out[(size_t)b * m] = c;

  for (int i = 1; i < m; ++i) {
    float bv = -INFINITY;
    int bj = INT_MAX;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int j = threadIdx.x + q * kThreads;
      if (j < n && mind[q] > bv) {  // ascending j: the lowest index on ties
        bv = mind[q];
        bj = j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      argmax_pair(&bv, &bj, __shfl_xor_sync(0xffffffffu, bv, off),
                  __shfl_xor_sync(0xffffffffu, bj, off));
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_j[warp] = bj;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < kWarpsPerBlock ? red_v[lane] : -INFINITY;
      bj = lane < kWarpsPerBlock ? red_j[lane] : INT_MAX;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        argmax_pair(&bv, &bj, __shfl_xor_sync(0xffffffffu, bv, off),
                    __shfl_xor_sync(0xffffffffu, bj, off));
      }
      if (lane == 0) {
        winner = bj;
        out[(size_t)b * m + i] = bj;
      }
    }
    __syncthreads();
    c = winner;
    const float cx = P[3 * c], cy = P[3 * c + 1], cz = P[3 * c + 2];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const float dx = x[q] - cx, dy = y[q] - cy, dz = z[q] - cz;
      const float d = dx * dx + dy * dy + dz * dz;
      if (d < mind[q]) mind[q] = d;
    }
  }
}

}  // namespace

extern "C" {

int dipole_fps_max_points() { return kMaxPoints; }

// pos (B, n, 3) float32, valid (B, n) bool (one byte each), starts (B,)
// int32 in [0, n), all on the device; out (B, m) int32. 1 <= n <=
// kMaxPoints. Returns cudaGetLastError().
int dipole_fps(const float* pos, const unsigned char* valid, int batch, int n,
               int m, const int* starts, int* out, cudaStream_t stream) {
  if (n <= 0 || n > kMaxPoints) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || m <= 0) return 0;
  fps_kernel<<<batch, kThreads, 0, stream>>>(pos, valid, n, m, starts, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
