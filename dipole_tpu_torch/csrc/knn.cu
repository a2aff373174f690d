// Batched dense k-nearest neighbours: for each batch b and query row q, the
// k <= 32 nearest of the Ns sources of batch b by d2 = dx*dx + dy*dy +
// dz*dz (dx = query - source), one minimum per step, ties to the lowest
// source index, the chosen entry then set to +inf. Outputs idx (int32) and
// d2 (float32), (B, Nd, k). A row whose remaining distances are all +inf
// selects index 0 with d2 = +inf, as the argmin scan does. Positions are
// finite (the PointCNN pads with 1e6 sentinels).
//
// Replaces: dipole_tpu/ops/neighbors_pallas.py:_knn_kernel (via
// knn_with_dist_pallas), the search core of the PointCNN forward: the
// self-kNN of each XConv position set (k = 20, pointcnn.py:98-121) and the
// interpolation kNN (k = 16, :211-232).
//
// What bounds it on an H100: operations. B Nd Ns pairs of 8 flops plus at
// least one comparison each, against 12 bytes per point and 8 k bytes per
// query written: (256, 512, 512) is 6.7e7 pairs, 6e8 operations (9 us at
// 67 TFLOP/s) against 4 MB (1.3 us).
//
// Design: one warp per query row. The block stages its batch's sources in
// shared memory once; each warp writes its row's Ns distances to its own
// slice of shared memory. Lane l owns the entries j = l + 32 i and keeps
// the minimum (value, lowest index) of them; a step is one warp argmin over
// the 32 lane minima (value, then index), after which only the owning lane
// marks the entry +inf and rescans its Ns/32 entries. So a row costs Ns + k
// Ns/32 reads of shared memory instead of the scan's k Ns.
//
// Arithmetic: -fmad=false keeps the three products and two sums separately
// rounded, in the plain version's order, so idx and d2 are bit-equal to the
// plain torch scan (ops/neighbors.py).

#include <climits>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;           // query rows per block
constexpr int kMaxK = 32;
constexpr int kMaxSources = 8192;   // 16 Ns bytes of shared memory: 128 KB

__device__ __forceinline__ void rescan(const float* d, int ns, int lane,
                                       float* best, int* best_j) {
  *best = INFINITY;
  *best_j = INT_MAX;
  for (int j = lane; j < ns; j += 32) {
    const float v = d[j];
    if (*best_j == INT_MAX || v < *best) {
      *best = v;
      *best_j = j;
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
knn_kernel(const float* __restrict__ dst, int nd,
           const float* __restrict__ src, int ns, int k,
           int* __restrict__ out_idx, float* __restrict__ out_d2) {
  extern __shared__ float smem[];
  float* s = smem;                               // (ns, 3)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* d = smem + 3 * (size_t)ns + (size_t)warp * ns;
  const int b = blockIdx.y;
  const float* sb = src + (size_t)b * ns * 3;
  for (int j = threadIdx.x; j < 3 * ns; j += blockDim.x) s[j] = sb[j];
  __syncthreads();

  const int q = blockIdx.x * kWarps + warp;
  if (q >= nd) return;  // no block barrier below
  const float* p = dst + ((size_t)b * nd + q) * 3;
  const float qx = p[0], qy = p[1], qz = p[2];
  for (int j = lane; j < ns; j += 32) {
    const float dx = qx - s[3 * j];
    const float dy = qy - s[3 * j + 1];
    const float dz = qz - s[3 * j + 2];
    d[j] = dx * dx + dy * dy + dz * dz;
  }
  __syncwarp();
  float best;
  int best_j;
  rescan(d, ns, lane, &best, &best_j);
  int* oi = out_idx + ((size_t)b * nd + q) * k;
  float* od = out_d2 + ((size_t)b * nd + q) * k;
  for (int r = 0; r < k; ++r) {
    float v = best;
    int j = best_j;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float v2 = __shfl_xor_sync(0xffffffffu, v, off);
      const int j2 = __shfl_xor_sync(0xffffffffu, j, off);
      if (v2 < v || (v2 == v && j2 < j)) {
        v = v2;
        j = j2;
      }
    }
    if (lane == 0) {
      oi[r] = j;
      od[r] = v;
    }
    if ((j & 31) == lane) {
      d[j] = INFINITY;
      rescan(d, ns, lane, &best, &best_j);
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

int dipole_knn_max_sources() { return kMaxSources; }

// dst (B, nd, 3) and src (B, ns, 3) row-major float32 on the device;
// out_idx (B, nd, k) int32 and out_d2 (B, nd, k) float32. 0 < k <= 32,
// 1 <= ns <= kMaxSources; k > ns selects index 0 at +inf once the row is
// spent, as the scan does. Returns cudaGetLastError().
int dipole_knn(const float* dst, int nd, const float* src, int ns, int batch,
               int k, int* out_idx, float* out_d2, cudaStream_t stream) {
  if (k <= 0 || k > kMaxK || ns <= 0 || ns > kMaxSources || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nd <= 0 || batch <= 0) return 0;
  const size_t smem = sizeof(float) * (3 + kWarps) * (size_t)ns;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        knn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((nd + kWarps - 1) / kWarps, batch);
  knn_kernel<<<grid, kWarps * 32, smem, stream>>>(dst, nd, src, ns, k,
                                                  out_idx, out_d2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
