// Dipole field at target points, eps 1e-5 by default:
//   E_t = -sum_s [3 (p_s . R) R / (r^2 (r^3 + eps)) - p_s / (r^3 + eps)],
// R = x_s - x_t; coincident pairs contribute nothing; a non-finite total
// component is 0.
//
// Replaces: dipole_tpu/ops/fields_pallas.py:_field_kernel + _pair_terms
// (via field_grad_pallas), reached from fields.field_grad: the rest-point
// re-vote of orient_large (ops/propagate.py:300-308: the lion's 138869
// representatives at its 41131 other points), orientation transfer
// (reference_field: 10000 sources at 180000 targets) and graph_dipole's
// edge weights (~500 x ~500, 44 calls a run).
//
// What bounds it on an H100: instruction issue. T targets x S sources
// pairs of 33 operations each as counted for the bound (1.8e9 pairs at the
// transfer: 0.89 ms at 67 TFLOP/s fp32; 5.7e9 at the lion: 2.8 ms) against
// 24 bytes a source and 24 a target. The inner loop is 210 SASS
// instructions for 2 sources x 4 targets, 26 a pair (one target a thread
// with IEEE roots took ~69), so the design cuts instructions: ~1 ps a
// pair, half the bound.
//
// Design, as csrc/group.cu: a block of kThreads threads holds kPerThread
// targets a thread in registers and stages its chunk's sources in shared
// memory kTile at a time, one float4 (x, y, z, px) and one float2 (py, pz)
// a source, read by broadcast. The source axis is cut into chunks along
// grid.y, planned on the host (common.cuh's chunked::plan, shared with
// csrc/potential.cu) so that each shape fills the 132 SMs: chunks of at
// most kMaxChunk sources (the transfer: 352 target blocks x 5 chunks; the
// lion: 81 x 68), and, where the target blocks are
// few, as many chunks of at least kMinChunk sources as bring the grid to
// kFillBlocks (a graph_dipole edge of 505 x 499: 16 chunks of 32). Each
// block writes its chunk's partial field and common.cuh's
// chunked::field_finish (shared with csrc/field_mma.cu) adds the chunks in
// order, then scrubs: no atomics, the same total on every run. A single
// chunk writes the scrubbed total itself, in one launch. Measured against
// this (PERF.md): 8 targets a thread tie at the transfer and lose 6% at the
// lion and 58% at the edge; chunks of at least 128 at the edge take 2.9x
// the kernel time.
//
// Arithmetic: the TPU kernel's one-reciprocal formula (fields_pallas.py
// _pair_terms): t = 1 / (r2 denom), a = 3 c t, b = r2 t, denom = r r2 + eps,
// E += b p - a R in one sum a component, with explicit multiply-adds
// (-fmad=false stays the build-wide flag) and the hardware's approximate
// square root and reciprocal (sqrt.approx.ftz, rcp.approx.ftz: relative
// errors below 2^-22 each). A coincident pair (r2 = 0) takes t = 0 and so
// contributes nothing. The sums run in another order than the plain torch
// version's (ops/fields.py, 1024-source tile sums): each component is held
// to it within 1e-4 |E| + 1e-5 max|E| (tests/test_torch_gpu.py,
// chip_smoke.py). At the lion's shape the worst component is at 0.167 of
// that tolerance, with approximate or with IEEE-rounded roots alike (the
// one-target-a-thread kernel: 0.156): the error is the order of the sums.
// IEEE-rounded roots (__fsqrt_rn, __frcp_rn) take 66-69% more time.

#include "common.cuh"

namespace {

using chunked::kPerThread;
using chunked::kTargets;
using chunked::kThreads;
using chunked::kTile;

// e += the field of source (a.xyz, moment a.w b.x b.y) at target t.
__device__ __forceinline__ void add_pair(float4 a, float2 b, const float* t,
                                         float eps, float* e) {
  const float Rx = a.x - t[0];
  const float Ry = a.y - t[1];
  const float Rz = a.z - t[2];
  const float r2 = __fmaf_rn(Rz, Rz, __fmaf_rn(Ry, Ry, Rx * Rx));
  const float denom = __fmaf_rn(root(r2), r2, eps);
  const float c = __fmaf_rn(b.y, Rz, __fmaf_rn(b.x, Ry, a.w * Rx));
  const float inv = r2 == 0.f ? 0.f : recip(r2 * denom);
  const float ca = 3.f * c * inv;
  const float cb = r2 * inv;
  e[0] = __fmaf_rn(cb, a.w, __fmaf_rn(-ca, Rx, e[0]));
  e[1] = __fmaf_rn(cb, b.x, __fmaf_rn(-ca, Ry, e[1]));
  e[2] = __fmaf_rn(cb, b.y, __fmaf_rn(-ca, Rz, e[2]));
}

// Block (x, y) sums sources [y chunk, (y + 1) chunk) at targets
// [x kTargets, (x + 1) kTargets), thread q-th target x kTargets + q
// kThreads + threadIdx.x. With one chunk it writes the scrubbed field to
// out, else its partial to partial[y].
__global__ void __launch_bounds__(kThreads)
field_partial(const float* __restrict__ src, int n_src, int chunk,
              const float* __restrict__ tgt, int n_tgt, float eps,
              float* __restrict__ partial, float* __restrict__ out) {
  __shared__ float4 sa[kTile];   // x, y, z, px
  __shared__ float2 sb[kTile];   // py, pz
  const int i0 = blockIdx.x * kTargets + threadIdx.x;
  float t[kPerThread][3];
  float e[kPerThread][3];
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int i = i0 + q * kThreads;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      t[q][c] = i < n_tgt ? tgt[3 * (size_t)i + c] : 0.f;
      e[q][c] = 0.f;
    }
  }
  const int begin = blockIdx.y * chunk;
  const int end = min(begin + chunk, n_src);
  for (int base = begin; base < end; base += kTile) {
    const int m = min(kTile, end - base);
    __syncthreads();             // the previous tile is spent
    chunked::stage_sources(src, base, m, sa, sb);
    __syncthreads();
#pragma unroll 2
    for (int k = 0; k < m; ++k) {
      const float4 a = sa[k];
      const float2 b = sb[k];
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) add_pair(a, b, t[q], eps, e[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int i = i0 + q * kThreads;
    if (i >= n_tgt) continue;
    if (gridDim.y == 1) {
#pragma unroll
      for (int c = 0; c < 3; ++c) out[3 * (size_t)i + c] = scrub(e[q][c]);
    } else {
      float* p = partial + ((size_t)blockIdx.y * n_tgt + i) * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) p[c] = e[q][c];
    }
  }
}

}  // namespace

extern "C" {

// Number of partial fields dipole_field writes for n_src sources at n_tgt
// targets: the scratch the caller allocates holds that many x n_tgt x 3
// floats (none for a single chunk, which writes out directly).
int dipole_field_chunks(int n_src, int n_tgt) {
  int n_chunks, chunk;
  chunked::plan(n_src, n_tgt, &n_chunks, &chunk);
  return n_chunks > 1 ? n_chunks : 0;
}

// src (n_src, 6) and tgt (n_tgt, 3), row-major float32 on the device;
// partial (dipole_field_chunks(n_src, n_tgt), n_tgt, 3) scratch; out
// (n_tgt, 3). Returns cudaGetLastError().
int dipole_field(const float* src, int n_src, const float* tgt, int n_tgt,
                 float eps, float* partial, float* out, cudaStream_t stream) {
  if (n_tgt <= 0) return 0;
  int n_chunks, chunk;
  chunked::plan(n_src, n_tgt, &n_chunks, &chunk);
  if (n_chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int t_blocks = (n_tgt + kTargets - 1) / kTargets;
  if (n_chunks > 0) {
    field_partial<<<dim3(t_blocks, n_chunks), kThreads, 0, stream>>>(
        src, n_src, chunk, tgt, n_tgt, eps, partial, out);
  }
  chunked::finish_field<true>(partial, n_chunks, n_tgt, out, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
