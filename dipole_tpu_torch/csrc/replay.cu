// The in-order replay: T propagation orders advanced in lock-step over one
// interaction matrix.
//
// Replaces: the XLA scan dipole_tpu/ops/propagate.py:_in_order_scan
// (:649-703; no Pallas twin), which carries xie_propagation_in_order and the
// BFS-tree voting. Step k, for every order t: idx = orders[t, k],
//   inter = sum_j I[idx, j] colw[j] mask(idx, j) w[t, j],
//   w[t, idx] = inter < 0 ? -1 : 1,  inter_rec[t, idx] = inter.
// colw (points_weight) is optional; mask(i, j) = [i in knn[j]], the kNN mask
// in index form, is optional too. An index may repeat in an order: a later
// visit overwrites w and inter_rec. The diffuse re-vote after the loop is a
// matrix product and stays in torch (ops/propagate.py).
//
// What bounds it on an H100: taken one step at a time, latency: every step
// waits for the previous decision, a barrier a step (the first design, one
// thread-block cluster per order, paid 2.6 us a step). Blocked as below, the
// floor is the bytes: each order's S rows of N floats read once, T S N x 4 B
// in all (10.8 GB, 3.2 ms at 3.35 TB/s for T = 3 at 30k); as built, the
// decision pass's one warp per order and the launches between the passes
// take about as long as the bulk pass (PERF.md).
//
// Design, unmasked: the order is known before the replay starts and w is 0
// except where the order has already been, so the sums of B steps can be
// taken at once from w as it stands at the block's start, and corrected
// inside the block:
//   inter_k = base_k + sum_{m < k} A[k, m] delta_m,
//   base_k = sum_j I[o_k, j] colw[j] w_start[j],  A[k, m] = I[o_k, o_m] colw[o_m],
// where delta_m = w_new - w_old at step m's index (0, +-1 or +-2: the change,
// not the new value, keeps repeated indices right). Two launches a block of
// B steps, on the caller's stream:
//   replay_bulk_kernel  base for the B steps of all T orders at once: T B
//                       rows cut into chunks over every SM, float64 partial
//                       sums (exact products, w in {0, +-1}); streams the
//                       rows once, the bandwidth-bound part. Each chunk also
//                       hands over the entries of A whose column it holds,
//                       read again from the caches rather than gathered
//                       later from HBM;
//   replay_seq_kernel   one block per order: sums the partials in a fixed
//                       order, copies A into shared memory, and one warp
//                       takes the B decisions, 32 steps at a time (lane l
//                       holds step 32 q + l): inside such a sub-block a step
//                       is one broadcast by shuffles and one update a lane,
//                       with no barrier; after it its 32 changes go into
//                       the later steps' bases. It writes w and inter_rec
//                       for the last visit of each index.
// The kernel boundary is the only barrier: S / B x 2 launches instead of S
// barriers. B = kBlockSteps = 128, measured against 32, 64 and 256 (PERF.md);
// the scratch the passes share is sized by dipole_replay_scratch.
// Masked, only the ~k sources j with idx in knn[j] enter a row's sum, so
// each order runs in one warp over the reverse kNN lists (rev_ptr/rev_src:
// the sources of each target, ascending), with no barrier at all.
//
// Determinism: w is 0 or +-1, so once I colw is rounded in float32 every
// product (and every A delta) is exact in float64; sums run in float64 in a
// fixed order. The plain torch version sums in float64 in its own order, so
// kernel and plain version take the same decisions unless |inter| falls
// below ~1e-12 of the sum of |I w|, and agree in inter to ~1e-15 relative.

#include "common.cuh"

namespace {

constexpr int kBulkThreads = 256;
constexpr int kSeqThreads = 512;
constexpr int kBlockSteps = 128;  // B, measured (PERF.md)
constexpr int kQ = kBlockSteps / 32;  // steps a lane holds in the decision pass
constexpr int kMaxChunks = 64;
constexpr unsigned kFull = 0xffffffffu;

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

constexpr int kPairs = kBlockSteps * (kBlockSteps - 1) / 2;  // entries of A

// Column m of the block's correction A (A[k, m] = I[o_k, o_m] colw[o_m] for
// k > m) starts at tri_col(m) + m + 1: the lanes' k of one step are
// neighbours in memory.
__device__ __forceinline__ int tri_col(int m) {
  constexpr int B = kBlockSteps;
  return m * (B - 1) - m * (m - 1) / 2 - m - 1;
}

// The bulk pass of the steps [k0, k0 + gridDim.y) of every order: block
// (c, m, t) sums chunk c of row o_m = orders[t, k0 + m] against w[t] as it
// stands into part[(t B + m) chunks + c], and, while the chunk is in the
// caches, picks the entries A[m, m'] (m' < m) whose column o_m' lies in it
// into tri[t kPairs + tri_col(m') + m].
__global__ void __launch_bounds__(kBulkThreads)
replay_bulk_kernel(const float* __restrict__ I, int n, int steps,
                   const int* __restrict__ orders, int k0, int chunks,
                   const float* __restrict__ colw, const float* __restrict__ w,
                   double* __restrict__ part, float* __restrict__ tri) {
  __shared__ double sh[kBulkThreads / 32];
  const int c = blockIdx.x, m = blockIdx.y, t = blockIdx.z;
  const size_t nn = n;
  const int* ot = orders + t * (size_t)steps + k0;
  const float* row = I + (size_t)ot[m] * nn;
  const float* wt = w + t * nn;
  const int per = (n + chunks - 1) / chunks;
  const int j0 = c * per, j1 = min(n, j0 + per);
  double p = 0.0;
#pragma unroll 4
  for (int j = j0 + threadIdx.x; j < j1; j += kBulkThreads) {
    p += (double)entry(row, colw, j) * (double)wt[j];
  }
  p = warp_sum(p);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = p;
  for (int mm = threadIdx.x; mm < m; mm += kBulkThreads) {
    const int j = ot[mm];
    if (j >= j0 && j < j1) {
      tri[(size_t)t * kPairs + tri_col(mm) + m] = entry(row, colw, j);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double v = 0.0;
    for (int q = 0; q < kBulkThreads / 32; ++q) v += sh[q];
    part[((size_t)t * kBlockSteps + m) * chunks + c] = v;
  }
}

// The decisions of the steps [k0, k0 + bp) of order blockIdx.x, B = 32 kQ
// steps at most: the bases from the partials and A into shared memory, then
// one warp, lane l holding steps l, l + 32, ..., 32 steps (a sub-block) at
// a time: within it every step is one broadcast and one update a lane;
// after it its 32 changes go into the later steps' bases. Writes w and
// inter of each index at its last visit in the block.
__global__ void __launch_bounds__(kSeqThreads, 1)
replay_seq_kernel(int n, int steps, const int* __restrict__ orders, int k0,
                  int bp, int chunks, const double* __restrict__ part,
                  const float* __restrict__ tri, float* __restrict__ w,
                  double* __restrict__ inter) {
  extern __shared__ double base[];  // [B], then A [kPairs], ids [B], w0 [B]
  constexpr int B = kBlockSteps;
  float* A = reinterpret_cast<float*>(base + B);
  int* ids = reinterpret_cast<int*>(A + kPairs);
  float* w0 = reinterpret_cast<float*>(ids + B);
  const int t = blockIdx.x;
  const size_t nn = n;
  float* wt = w + t * nn;
  for (int m = threadIdx.x; m < bp; m += kSeqThreads) {
    const int id = orders[t * (size_t)steps + k0 + m];
    ids[m] = id;
    w0[m] = wt[id];
    const double* pm = part + ((size_t)t * B + m) * chunks;
    double b = 0.0;
    for (int c = 0; c < chunks; ++c) b += pm[c];
    base[m] = b;
  }
  // kPairs is a multiple of 4 and both ends 16-byte aligned (B = 32 kQ)
  const float4* tt = reinterpret_cast<const float4*>(tri + (size_t)t * kPairs);
#pragma unroll 4
  for (int e = threadIdx.x; e < kPairs / 4; e += kSeqThreads) {
    reinterpret_cast<float4*>(A)[e] = tt[e];
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  double b[kQ];   // base, then inter, of step 32 q + lane
  float wc[kQ];   // w at that step's index as the step finds it
  int id[kQ];
  unsigned last = 0u;  // bit q: step 32 q + lane is its index's last visit
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int m = 32 * q + lane;
    const bool in = m < bp;
    b[q] = in ? base[m] : 0.0;
    wc[q] = in ? w0[m] : 0.f;
    id[q] = in ? ids[m] : -1;
    if (in) last |= 1u << q;
  }
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int m0 = 32 * q;
    if (m0 >= bp) break;
    const int top = min(32, bp - m0);
    float dq = 0.f;  // the change this lane's step made
    for (int l = 0; l < top; ++l) {
      const double x = __shfl_sync(kFull, b[q], l);
      const float wold = __shfl_sync(kFull, wc[q], l);
      const int im = __shfl_sync(kFull, id[q], l);
      const float wn = x < 0.0 ? -1.f : 1.f;
      const float d = wn - wold;
      if (lane == l) dq = d;
      if (lane > l && lane < top) {
        if (d != 0.f) b[q] += (double)A[tri_col(m0 + l) + m0 + lane] * (double)d;
        if (id[q] == im) wc[q] = wn;
      } else if (lane < l && id[q] == im) {
        last &= ~(1u << q);
      }
    }
    if (q + 1 < kQ && m0 + 32 < bp) {
      for (int l = 0; l < top; ++l) {
        const float d = __shfl_sync(kFull, dq, l);
        const int im = __shfl_sync(kFull, id[q], l);
        const float wn = __shfl_sync(kFull, b[q], l) < 0.0 ? -1.f : 1.f;
        const int col = tri_col(m0 + l);
        bool again = false;
#pragma unroll
        for (int q2 = q + 1; q2 < kQ; ++q2) {
          if (32 * q2 + lane < bp) {
            if (d != 0.f) b[q2] += (double)A[col + 32 * q2 + lane] * (double)d;
            if (id[q2] == im) {
              wc[q2] = wn;
              again = true;
            }
          }
        }
        if (__any_sync(kFull, again) && lane == l) last &= ~(1u << q);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    if (last & (1u << q)) {
      wt[id[q]] = b[q] < 0.0 ? -1.f : 1.f;
      inter[t * nn + id[q]] = b[q];
    }
  }
}

cudaError_t replay_blocked(const float* I, int n, const int* orders, int T,
                           int steps, const float* colw, double* part, float* tri,
                           float* w, double* inter, cudaStream_t stream) {
  constexpr int B = kBlockSteps;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const size_t smem = B * sizeof(double) + (size_t)kPairs * sizeof(float) +
                      2 * B * sizeof(int);
  e = cudaFuncSetAttribute(replay_seq_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  for (int k0 = 0; k0 < steps; k0 += B) {
    const int bp = min(B, steps - k0);
    // about four bulk blocks an SM, chunks of at least 1024 columns
    int chunks = (4 * sms + T * bp - 1) / (T * bp);
    chunks = max(1, min(chunks, min(kMaxChunks, (n + 1023) / 1024)));
    replay_bulk_kernel<<<dim3(chunks, bp, T), kBulkThreads, 0, stream>>>(
        I, n, steps, orders, k0, chunks, colw, w, part, tri);
    replay_seq_kernel<<<T, kSeqThreads, smem, stream>>>(
        n, steps, orders, k0, bp, chunks, part, tri, w, inter);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The scratch of an unmasked replay of T orders: part_doubles float64 and
// tri_floats float32 entries. Returns 0.
int dipole_replay_scratch(int T, long long* part_doubles, long long* tri_floats) {
  *part_doubles = (long long)T * kBlockSteps * kMaxChunks;
  *tri_floats = (long long)T * kPairs;
  return 0;
}

// Replays T orders (T, steps) int32 over the (n, n) row-major matrix I.
// colw (n,) or null. rev_ptr (n + 1,) and rev_src (n k,) int32 select the
// masked mode (one warp per order); null, the unmasked one, blocked over
// kBlockSteps steps, with part and tri scratch of the sizes
// dipole_replay_scratch gives. w (T, n) float32 and inter (T, n) float64
// must be zero on entry and hold the decisions and the recorded
// interactions on return. Returns a cudaError_t value.
int dipole_replay(const float* I, int n, const int* orders, int T, int steps,
                  const float* colw, const int* rev_ptr, const int* rev_src,
                  double* part, float* tri, float* w, double* inter,
                  cudaStream_t stream) {
  if (n <= 0 || T <= 0 || T > 65535 || steps < 0 ||
      (rev_ptr == nullptr) != (rev_src == nullptr) ||
      (rev_ptr == nullptr && (part == nullptr || tri == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (steps == 0) return 0;
  if (rev_ptr != nullptr) {
    replay_masked_kernel<<<T, 32, 0, stream>>>(I, n, steps, orders, T, colw,
                                               rev_ptr, rev_src, w, inter);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(
      replay_blocked(I, n, orders, T, steps, colw, part, tri, w, inter, stream));
}

}  // extern "C"
