// Point-group interaction: F[i, g] = sum over sources j of group g of
// I[i, j], I[i, j] = E_j(x_i) . n_i (eps 1e-5 on the patch paths), without
// building I. Groups with no source give 0.
//
// Replaces: dipole_tpu/ops/fields_pallas.py:_group_kernel (via
// point_group_interaction_pallas), the core of strongest-field patch and
// representative propagation (dipole_tpu/ops/propagate.py:353-362).
//
// What bounds it on an H100: instruction issue. N targets x N sources pairs
// against 4 N G bytes of output: at N = 138869, G = 364 that is 1.9e10
// pairs (34 operations each, as counted for the bound: 9.8 ms at 67
// TFLOP/s fp32) against 200 MB (0.06 ms at 3.35 TB/s). A pair costs ~27
// issued instructions (the source's two loads shared by 4 targets), so the
// design cuts instructions, not bytes.
//
// Design: the wrapper sorts the sources by group (stable, so each group
// keeps index order), passes the group offsets, and cuts the sorted
// sources into chunks at group starts (chunk c owns the groups that start
// in [c K, (c + 1) K), K = 256 sources; a group larger than K stays whole in
// the chunk where it starts). The grid is (chunks) x (target tiles): a
// block of kThreads threads holds kPerThread targets a thread in registers,
// stages its chunk's sources in shared memory kTile at a time (one float4
// and one float2 a source, read by broadcast), sums every target over them
// in index order and writes F at each group's end, empty groups as 0. No
// atomics: the same F on every run. Many small groups share one block. Four
// targets a thread: 6 and 8 tie it at the lion's shape and lose at the
// hand's 10000 points x 60 groups, where fewer, larger blocks leave a tail
// on 132 SMs. One loop walks sources, tiles and group ends, with no helper
// taking the addresses of its counters (that put them on the stack).
// The output is written transposed, Ft (G, N_t): each store of a warp
// covers 128 contiguous bytes; the wrapper hands back the (N_t, G) view.
//
// Arithmetic: the TPU kernel's one-divide formula (fields_pallas.py:335-346),
// t = 1 / (r2 denom), I = -t (3 c Rn - pn r2), denom = r r2 + eps, with
// explicit multiply-adds (-fmad=false stays the build-wide flag) and the
// hardware's approximate square root and reciprocal (sqrt.approx.ftz,
// rcp.approx.ftz: relative errors below 2^-22 each). Rn = n.R stays a dot
// product of the inputs as given: for near neighbours on one surface it
// cancels, and a target carrying a rounded 3n (one multiply a pair fewer)
// gave several times the error at the lion's shape. An entry then moves by a few float32 ulps, and a
// sum of ~400 of them by ~1e-6 of sum |I|, against the tolerance of 1e-4
// sum |I| per entry that holds the kernel to the plain version
// (ops/fields.py), whose one-hot product sums in another order anyway. A
// coincident pair (r2 = 0) needs no test of its own: t is +inf and
// 3 c Rn - pn r2 is 0, so I is NaN, and the non-finite scrub that every
// entry passes gives 0, as the TPU kernel's select does. IEEE-rounded
// roots (__fsqrt_rn, __frcp_rn) were measured too: 53-76% slower at both
// shapes, with no error the tolerance sees (PERF.md).

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = 4;                       // targets a thread
constexpr int kTargets = kThreads * kPerThread;     // targets a block
constexpr int kTile = 256;                          // sources staged at a time

// I of source (a.xyz, a.w b.x b.y) at target t (x y z nx ny nz); 0 when
// not finite, coincident pairs included.
__device__ __forceinline__ float pair(float4 a, float2 b, const float* t,
                                      float eps) {
  const float Rx = a.x - t[0];
  const float Ry = a.y - t[1];
  const float Rz = a.z - t[2];
  const float r2 = __fmaf_rn(Rz, Rz, __fmaf_rn(Ry, Ry, Rx * Rx));
  const float denom = __fmaf_rn(root(r2), r2, eps);
  const float c = __fmaf_rn(b.y, Rz, __fmaf_rn(b.x, Ry, a.w * Rx));
  const float Rn = __fmaf_rn(t[5], Rz, __fmaf_rn(t[4], Ry, t[3] * Rx));
  const float pn = __fmaf_rn(b.y, t[5], __fmaf_rn(b.x, t[4], a.w * t[3]));
  const float inv = recip(r2 * denom);
  const float v = -inv * __fmaf_rn(3.f * c, Rn, -(pn * r2));
  return fabsf(v) < INFINITY ? v : 0.f;
}

__global__ void __launch_bounds__(kThreads)
group_kernel(const float* __restrict__ tgt, int n_t,
             const float* __restrict__ src, const int* __restrict__ offsets,
             const int* __restrict__ chunk_groups, float eps,
             float* __restrict__ out_t) {
  __shared__ float4 sa[kTile];   // x, y, z, px
  __shared__ float2 sb[kTile];   // py, pz
  const int g_lo = chunk_groups[blockIdx.x];
  const int g_hi = chunk_groups[blockIdx.x + 1];
  if (g_lo == g_hi) return;      // no group starts in this chunk
  const int i0 = blockIdx.y * kTargets + threadIdx.x;
  float t[kPerThread][6];
  float acc[kPerThread];
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int i = i0 + q * kThreads;
#pragma unroll
    for (int c = 0; c < 6; ++c) t[q][c] = i < n_t ? tgt[6 * (size_t)i + c] : 0.f;
    acc[q] = 0.f;
  }
  int g = g_lo;
  int gend = offsets[g + 1];
  const int s_end = offsets[g_hi];
  // source j = base + k, k in the staged tile [base, base + m)
  int base = offsets[g_lo], m = 0, k = 0;
  for (;;) {
    const int j = base + k;
    while (g < g_hi && gend <= j) {   // groups that end at j, empty ones too
      float* row = out_t + (size_t)g * n_t;
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        if (i0 + q * kThreads < n_t) row[i0 + q * kThreads] = acc[q];
        acc[q] = 0.f;
      }
      if (++g < g_hi) gend = offsets[g + 1];
    }
    if (j >= s_end) break;
    if (k == m) {                     // the tile is spent: stage the next
      __syncthreads();
      base = j;
      m = min(kTile, s_end - base);
      k = 0;
      for (int s = threadIdx.x; s < m; s += kThreads) {
        const float* p = src + 6 * (size_t)(base + s);
        sa[s] = make_float4(p[0], p[1], p[2], p[3]);
        sb[s] = make_float2(p[4], p[5]);
      }
      __syncthreads();
    }
    const int stop = min(m, gend - base);
#pragma unroll 2
    for (; k < stop; ++k) {
      const float4 a = sa[k];
      const float2 b = sb[k];
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) acc[q] += pair(a, b, t[q], eps);
    }
  }
}

}  // namespace

extern "C" {

// tgt (n_t, 6) and src (>= offsets[n_groups], 6) row-major float32 on the
// device, src sorted by group; offsets (n_groups + 1) int32, group g's
// sources are src[offsets[g]:offsets[g + 1]]; chunk_groups (n_chunks + 1)
// int32, nondecreasing from 0 to n_groups: chunk c sums groups
// [chunk_groups[c], chunk_groups[c + 1]); out_t (n_groups, n_t); at most
// 65535 kTargets targets. Returns cudaGetLastError().
int dipole_group(const float* tgt, int n_t, const float* src,
                 const int* offsets, int n_groups, const int* chunk_groups,
                 int n_chunks, float eps, float* out_t, cudaStream_t stream) {
  if (n_t <= 0 || n_groups <= 0) return 0;
  const int t_blocks = (n_t + kTargets - 1) / kTargets;
  if (n_chunks <= 0 || t_blocks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  group_kernel<<<dim3(n_chunks, t_blocks), kThreads, 0, stream>>>(
      tgt, n_t, src, offsets, chunk_groups, eps, out_t);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
