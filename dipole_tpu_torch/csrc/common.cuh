// Shared by every kernel library of the port: each library is built on its
// own (one nvcc per source) and exports the error-string lookup its ctypes
// wrapper uses to report a failed launch.
#pragma once

#include <cmath>

#include <cuda_runtime.h>

extern "C" const char* dipole_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The terms of the dipole interaction of source s (moment p) at target t
// (normal n), R = x_s - x_t: c = p.R, Rn = n.R, D = safe_r2 denom and pd =
// pn / denom, with pn = p.n, denom = r r2 + eps and safe_r2 = r2 (1 at r =
// 0). The two-divide XLA formula of dipole_tpu/ops/fields.py:287-302 term for
// term and in the order of the plain torch version (fields.py of the port),
// built with -fmad=false (sqrtf and / IEEE): bit-equal to it.
struct DipoleTerms {
  float c, Rn, D, pd;
  bool zero;
};

__device__ __forceinline__ DipoleTerms dipole_terms(float sx, float sy, float sz,
                                                    float px, float py, float pz,
                                                    float tx, float ty, float tz,
                                                    float nx, float ny, float nz,
                                                    float eps) {
  const float Rx = sx - tx;
  const float Ry = sy - ty;
  const float Rz = sz - tz;
  const float r2 = Rx * Rx + Ry * Ry + Rz * Rz;
  const bool zero = r2 == 0.f;
  const float rr = sqrtf(r2);
  const float denom = rr * r2 + eps;
  DipoleTerms m;
  m.c = px * Rx + py * Ry + pz * Rz;
  m.Rn = nx * Rx + ny * Ry + nz * Rz;
  m.D = (zero ? 1.f : r2) * denom;
  m.pd = (px * nx + py * ny + pz * nz) / denom;
  m.zero = zero;
  return m;
}

// -((3 first) second / D - pd) (left to right), 0 at r = 0 or when not
// finite. With (first, second) = (c, Rn) it is the entry of s at t, I[t, s].
// With (Rn, c) it is the mirror entry I[s, t], bit for bit: swapping s and
// t negates R exactly, so r2, r, denom, D and pn keep their bits, c' = -Rn
// and Rn' = -c exactly, and (3 c') Rn' = (3 Rn) c.
__device__ __forceinline__ float dipole_value(const DipoleTerms& m, float first,
                                              float second) {
  const float v = -(3.f * first * second / m.D - m.pd);
  return (m.zero || !isfinite(v)) ? 0.f : v;
}

// One entry of the interaction matrix, I = E_s(x_t) . n_t; coincident pairs
// and non-finite entries are 0.
__device__ __forceinline__ float dipole_pair(float sx, float sy, float sz,
                                             float px, float py, float pz,
                                             float tx, float ty, float tz,
                                             float nx, float ny, float nz,
                                             float eps) {
  const DipoleTerms m = dipole_terms(sx, sy, sz, px, py, pz, tx, ty, tz, nx, ny,
                                     nz, eps);
  return dipole_value(m, m.c, m.Rn);
}

// The terms of the mirror-field ("xie") interaction of source s at target
// t, R = x_s - x_t: nsR = (n_s.R)/r, ntR = (n_t.R)/r, nn = n_s.n_t, r3 =
// r2 r. The XLA tile formula of dipole_tpu/ops/fields.py:305-324 term for
// term (two divides by safe_r, r3 = r2 r) and in the plain torch version's
// order, built with -fmad=false (sqrtf and / IEEE): bit-equal to it.
struct XieTerms {
  float nsR, ntR, nn, r3;
  bool zero;
};

__device__ __forceinline__ XieTerms xie_terms(float sx, float sy, float sz,
                                              float px, float py, float pz,
                                              float tx, float ty, float tz,
                                              float nx, float ny, float nz) {
  const float Rx = sx - tx;
  const float Ry = sy - ty;
  const float Rz = sz - tz;
  const float r2 = Rx * Rx + Ry * Ry + Rz * Rz;
  const bool zero = r2 == 0.f;
  const float r = sqrtf(r2);
  const float safe_r = zero ? 1.f : r;
  XieTerms m;
  m.nsR = (px * Rx + py * Ry + pz * Rz) / safe_r;
  m.ntR = (nx * Rx + ny * Ry + nz * Rz) / safe_r;
  m.nn = px * nx + py * ny + pz * nz;
  m.r3 = r2 * r;
  m.zero = zero;
  return m;
}

// (nn - C first second) / r3 (C first second left to right), nn at r = 0,
// 0 when not finite. With (first, second) = (nsR, ntR) it is the entry of
// s at t, I[t, s]. With (ntR, nsR) it is the mirror entry I[s, t], bit for
// bit: swapping s and t negates R exactly, so r2, r, r3 and nn keep their
// bits, nsR' = -ntR and ntR' = -nsR exactly, and C nsR' ntR' = C ntR nsR.
__device__ __forceinline__ float xie_value(const XieTerms& m, float first,
                                           float second, float C) {
  const float core = m.nn - C * first * second;
  // nn / 1 is nn exactly: one divide on every pair, no branch around it
  const float v = (m.zero ? m.nn : core) / (m.zero ? 1.f : m.r3);
  return isfinite(v) ? v : 0.f;
}

// One entry of the xie interaction matrix, I = the mirror field of source s
// at target t dotted with n_t: (n_s.n_t - C (n_s.R)/r (n_t.R)/r) / r^3, and
// n_s.n_t at r = 0; non-finite entries are 0.
__device__ __forceinline__ float xie_pair(float sx, float sy, float sz,
                                          float px, float py, float pz,
                                          float tx, float ty, float tz,
                                          float nx, float ny, float nz,
                                          float C) {
  const XieTerms m = xie_terms(sx, sy, sz, px, py, pz, tx, ty, tz, nx, ny, nz);
  return xie_value(m, m.nsR, m.ntR, C);
}

// The hardware's approximate square root, reciprocal and reciprocal square
// root (one MUFU instruction each, relative errors below 2^-22; .ftz takes
// a subnormal input as 0).
__device__ __forceinline__ float root(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float recip(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rroot(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float scrub(float x) {
  return isfinite(x) ? x : 0.f;
}

// The source-chunk design of the field (field.cu) and the potential
// (potential.cu): a block of kThreads threads holds kPerThread targets a
// thread in registers and stages its chunk's sources in shared memory kTile
// at a time (stage_sources), read by broadcast. The source axis is cut into
// chunks along grid.y by plan(); each block writes its chunk's partial sums
// and a second kernel adds the chunks in a fixed order, with no atomics, so
// every run gives the same total. A single chunk writes the total itself.
namespace chunked {

constexpr int kThreads = 128;
constexpr int kPerThread = 4;                    // targets a thread
constexpr int kTargets = kThreads * kPerThread;  // targets a block
constexpr int kTile = 256;                       // sources staged at a time
constexpr int kMaxChunk = 2048;                  // sources a block, at most
constexpr int kMinChunk = 32;                    // and at least, when cut finer
constexpr int kFillBlocks = 8 * 132;             // blocks that fill the card

// Sources [base, base + m) of src (n, 6) into sa (x, y, z, px) and sb (py,
// pz) by the block's kThreads threads; m <= kTile.
__device__ __forceinline__ void stage_sources(const float* __restrict__ src,
                                              int base, int m, float4* sa,
                                              float2* sb) {
  for (int s = threadIdx.x; s < m; s += kThreads) {
    const float* p = src + 6 * (size_t)(base + s);
    sa[s] = make_float4(p[0], p[1], p[2], p[3]);
    sb[s] = make_float2(p[4], p[5]);
  }
}

// (chunks, sources a chunk) of the grid for n_src sources at n_tgt
// targets, `targets` a block: chunks of at most max_chunk sources, and more
// of at least min_chunk where fewer target blocks than kFillBlocks would
// leave SMs idle.
inline void plan(int n_src, int n_tgt, int* n_chunks, int* chunk,
                 int targets = kTargets, int max_chunk = kMaxChunk,
                 int min_chunk = kMinChunk) {
  if (n_src <= 0) {
    *n_chunks = 0;
    *chunk = 1;
    return;
  }
  const int t_blocks = max(1, (n_tgt + targets - 1) / targets);
  const int fill = min((kFillBlocks + t_blocks - 1) / t_blocks,
                       (n_src + min_chunk - 1) / min_chunk);
  const int want = max((n_src + max_chunk - 1) / max_chunk, fill);
  *chunk = (n_src + want - 1) / want;
  *n_chunks = (n_src + *chunk - 1) / *chunk;
}

// out (n_tgt, 3) = the partial fields (n_chunks, n_tgt, 3) summed over the
// chunks in chunk order, each total scrubbed if kScrub (csrc/field.cu) and
// left as it is if not (csrc/field_mma.cu).
template <bool kScrub>
__global__ void field_finish(const float* __restrict__ partial, int n_chunks,
                             int n_tgt, float* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_tgt) return;
  float e[3] = {0.f, 0.f, 0.f};
  for (int c = 0; c < n_chunks; ++c) {
    const float* p = partial + ((size_t)c * n_tgt + t) * 3;
    e[0] += p[0];
    e[1] += p[1];
    e[2] += p[2];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) out[3 * (size_t)t + k] = kScrub ? scrub(e[k]) : e[k];
}

// Launches field_finish<kScrub> on stream, unless a single chunk wrote out
// itself.
template <bool kScrub>
inline void finish_field(const float* partial, int n_chunks, int n_tgt,
                         float* out, cudaStream_t stream) {
  if (n_chunks == 1) return;
  field_finish<kScrub><<<(n_tgt + 127) / 128, 128, 0, stream>>>(
      partial, n_chunks, n_tgt, out);
}

}  // namespace chunked
