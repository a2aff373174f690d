// Batched dense k-nearest neighbours: for each batch b and query row q, the
// k <= 32 nearest of the Ns sources of batch b by d2 = dx*dx + dy*dy +
// dz*dz (dx = query - source), in the order of the plain version's scan:
// one minimum per step, ties to the lowest source index, the chosen entry
// then set to +inf. That is the k smallest (d2, index) pairs, ascending.
// Outputs idx (int32) and d2 (float32), (B, Nd, k). A row whose remaining
// distances are all +inf selects index 0 with d2 = +inf, as the argmin scan
// does (k > Ns). Positions are finite and d2 does not overflow (the
// PointCNN pads with 1e6 sentinels).
//
// Replaces: dipole_tpu/ops/neighbors_pallas.py:_knn_kernel (via
// knn_with_dist_pallas), the search core of the PointCNN forward: the
// self-kNN of each XConv position set (k = 20, pointcnn.py:98-121) and the
// interpolation kNN (k = 16, :211-232).
//
// What bounds it on an H100: operations. B Nd Ns pairs of 8 flops plus at
// least one comparison each, against 12 bytes per point and 8 k bytes per
// query written: (256, 512, 512) is 6.7e7 pairs, 6e8 operations (9 us at
// 67 TFLOP/s) against 4 MB (1.3 us). What the card spends is instructions
// issued, so the design counts those.
//
// Design: one thread per query. A block holds up to 256 queries of one
// batch row and stages that row's sources in shared memory once, as float4
// read in index order (one broadcast load a source for the whole warp).
// Each thread keeps its k best as a list sorted by (d2, index) in
// registers (K = 16, 20 or 32 slots, the kernel templated on K and fully
// unrolled, so the list never goes to local memory), initialised to
// (+inf, index 0): exactly the scan's answer once the row is spent. A
// source costs the 8 flops of d2 and one compare against a threshold;
// below it, (d2, index) goes into a buffer of 16 in shared memory. Every 8
// sources the warp looks whether a lane's buffer may overflow, and if so
// every lane inserts its buffered pairs in order, each only if strictly
// below the list's K-th value, after any equal values (so ties keep the
// lower index, as the argmin does), and then takes the K-th value as the
// new threshold. Inserting is ~5 K instructions; a lane of a warp that
// inserted at every source that beats its list would make the whole warp
// wait at nearly every source (32 lanes, ~K (1 + ln(Ns/K)) inserts each);
// the buffer lets the lanes insert together. Sources are padded with +inf
// positions, whose d2 is +inf and never inserted.
//
// Splitting a query's sources over two or four threads, whose lists the
// first then merges, was measured too: it saved at most 7 us a forward,
// at one shape (PERF.md, PR 6), so the kernel keeps one thread a query.
//
// Arithmetic: -fmad=false keeps the three products and two sums separately
// rounded, in the plain version's order, so idx and d2 are bit-equal to the
// plain torch scan (ops/neighbors.py).

#include "common.cuh"

namespace {

constexpr int kMaxK = 32;
constexpr int kMaxSources = 8192;   // 16 Ns bytes of shared memory: 128 KB
constexpr int kMaxThreads = 256;    // queries a block
constexpr int kBuf = 16;            // pairs a thread buffers before it inserts
constexpr int kChunk = 8;           // sources between two looks at the buffers
constexpr unsigned kFull = 0xffffffffu;

// (d, j) into the list sorted by (value, index), which holds only pairs of
// lower index than j: after any equal values, the last pair dropped.
template <int K>
__device__ __forceinline__ void insert(float (&v)[K], int (&ix)[K], float d, int j) {
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    const bool up = d < v[s - 1];
    if (d < v[s]) {
      v[s] = up ? v[s - 1] : d;
      ix[s] = up ? ix[s - 1] : j;
    }
  }
  if (d < v[0]) {
    v[0] = d;
    ix[0] = j;
  }
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads)
knn_kernel(const float* __restrict__ dst, int nd, const float* __restrict__ src,
           int ns, int ns_pad, int k, int* __restrict__ out_idx,
           float* __restrict__ out_d2) {
  extern __shared__ float4 smem[];
  float4* s = smem;                                          // (ns_pad)
  const int T = blockDim.x;
  // kBuf x T buffered pairs: values, then indices
  float* bv = reinterpret_cast<float*>(smem + ns_pad) + threadIdx.x;
  int* bi = reinterpret_cast<int*>(smem + ns_pad) + kBuf * T + threadIdx.x;
  const int b = blockIdx.y;
  const float* sb = src + (size_t)b * ns * 3;
  for (int j = threadIdx.x; j < ns_pad; j += T) {
    s[j] = j < ns ? make_float4(sb[3 * j], sb[3 * j + 1], sb[3 * j + 2], 0.f)
                  : make_float4(INFINITY, INFINITY, INFINITY, 0.f);
  }
  __syncthreads();

  // every thread runs the loop (the warp votes); one past the rows searches
  // for row 0 and writes nothing
  const int q = blockIdx.x * T + threadIdx.x;
  const bool live = q < nd;
  const float* p = dst + ((size_t)b * nd + (live ? q : 0)) * 3;
  const float qx = p[0], qy = p[1], qz = p[2];
  float v[K];
  int ix[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    v[r] = INFINITY;
    ix[r] = 0;
  }
  float thr = INFINITY;
  int cnt = 0;
  for (int j0 = 0;; j0 += kChunk) {
    const bool more = j0 < ns_pad;
    if (more) {
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const float4 c = s[j0 + u];
        const float dx = qx - c.x;
        const float dy = qy - c.y;
        const float dz = qz - c.z;
        const float d = dx * dx + dy * dy + dz * dz;
        if (d < thr) {
          bv[cnt * T] = d;
          bi[cnt * T] = j0 + u;
          ++cnt;
        }
      }
    }
    if (__any_sync(kFull, cnt > kBuf - kChunk) || !more) {
      for (int r = 0; r < cnt; ++r) {
        const float d = bv[r * T];
        if (d < v[K - 1]) insert(v, ix, d, bi[r * T]);
      }
      cnt = 0;
      thr = v[K - 1];
    }
    if (!more) break;
  }
  if (live) {
    int* oi = out_idx + ((size_t)b * nd + q) * k;
    float* od = out_d2 + ((size_t)b * nd + q) * k;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      if (r < k) {
        oi[r] = ix[r];
        od[r] = v[r];
      }
    }
  }
}

}  // namespace

extern "C" {

int dipole_knn_max_sources() { return kMaxSources; }

// dst (B, nd, 3) and src (B, ns, 3) row-major float32 on the device;
// out_idx (B, nd, k) int32 and out_d2 (B, nd, k) float32. 0 < k <= 32,
// 1 <= ns <= kMaxSources; k > ns selects index 0 at +inf once the row is
// spent, as the scan does. The queries of a batch row are spread evenly
// over blocks of a multiple of 32 threads, at most 256. Returns
// cudaGetLastError().
int dipole_knn(const float* dst, int nd, const float* src, int ns, int batch,
               int k, int* out_idx, float* out_d2, cudaStream_t stream) {
  if (k <= 0 || k > kMaxK || ns <= 0 || ns > kMaxSources || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nd <= 0 || batch <= 0) return 0;
  const int blocks = (nd + kMaxThreads - 1) / kMaxThreads;
  const int threads = ((nd + blocks - 1) / blocks + 31) / 32 * 32;
  const int ns_pad = (ns + kChunk - 1) / kChunk * kChunk;
  const size_t smem = sizeof(float4) * ns_pad + 2 * sizeof(float) * kBuf * threads;
  void* kernel = k <= 16   ? (void*)knn_kernel<16>
                 : k <= 20 ? (void*)knn_kernel<20>
                           : (void*)knn_kernel<32>;
  // above 48 KB: set for every size
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {(void*)&dst,    (void*)&nd, (void*)&src,     (void*)&ns,
                  (void*)&ns_pad, (void*)&k,  (void*)&out_idx, (void*)&out_d2};
  e = cudaLaunchKernel(kernel, dim3(blocks, batch), dim3(threads), args, smem,
                       stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
