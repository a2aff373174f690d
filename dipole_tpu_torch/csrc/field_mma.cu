// The dipole field at target points with its sums on the tensor cores: the
// two "MXU" variants of the field kernel (csrc/field.cu's function),
//   E_t = sum_s (b p_s - a R) = sum_s b p_s - sum_s a s + (sum_s a) t,
// R = x_s - x_t, a = 3 (p_s . R) / (r^2 (r^3 + eps)), b = 1 / (r^3 + eps);
// the three sums become one product per 512-source chunk,
// [b | a] (T, 2S) @ W (2S, 4), W = [[p, 0], [-s, 1]], and
// E += D[:, :3] + D[:, 3] t per chunk. Output not scrubbed.
//
// Replaces: tools/mxu_field_experiment.py (the JAX package's prototype)
//   dipole_field_mxu_exact      _field_kernel_mxu_exact (:26): R, r^2, c
//                               on the vector unit exactly as
//                               fields_pallas._pair_terms, the output
//                               reduction as the product above;
//   dipole_field_mxu_expansion  _field_kernel_mxu_expansion (:67): r^2 =
//                               t^2 + s^2 - 2 t.s and c = p.s - t.p from two
//                               K=3 products (T,3)@(3,S) too, zero test
//                               r^2 <= 0, r = sqrt(safe_r2);
// both launched by make_padded (:108, pallas_call :112).
//
// What bounds it on an H100: operations on the CUDA cores. The pair math
// that stays there (sub, squares, sqrt, one reciprocal, a, b) is ~21 flops
// a pair for the exact variant, ~12 for the expansion; the tensor-core
// products are 16 (exact) and 28 (expansion) flops a pair, times 3 for
// 3xTF32, at 495 TFLOP/s TF32. At the tool's 65536 x 262144: 5.4 ms
// (exact) and 3.1 ms (expansion) at 67 TFLOP/s fp32; inputs ~7 MB.
//
// Design (simple first, not yet fast): one warp owns 16 targets and walks
// all sources, staged in shared memory one 512-source chunk at a time
// (a block of 4 warps shares the stage). Per 8 sources the warp issues
// mma.sync.m16n8k8 (row.col, tf32 in, f32 accumulate) into one 16 x 8
// accumulator: A_b [p | 0] then A_a [-s | 1], so columns 0-2 hold
// sum bp - sum as and column 3 sum a (columns 4-7 idle). Lane (g, q)
// (g = lane / 4, q = lane % 4) computes a and b on the CUDA cores for
// exactly the four pairs its A fragment holds: targets g and g + 8,
// sources q and q + 4. The expansion variant first takes t.s and t.p for
// the 16 x 8 tile from two MMAs (A = the targets' xyz padded with zeros to
// k = 8, B = the sources); its accumulator gives lane (g, q) sources 2q
// and 2q + 1, so W's rows (the k axis of the output MMA) are ordered
// 0, 2, 4, 6, 1, 3, 5, 7: the values feed the output MMA from the
// registers they are in, with no shuffle. 65536 targets make 4096 warps,
// enough to fill the card without splitting the source axis. The chunk
// sums are added in source order on the CUDA cores, as the JAX loop does.
//
// Precision, 3xTF32: each operand x is split once, big = rna_tf32(x),
// small = rna_tf32(x - big) (exact with -fmad=false), and the product is
// small.big + big.small + big.big, small terms first; one TF32 pass would
// leave ~2^-11 per product. a and b have field.cu's bits for the exact
// variant (the same arithmetic, one reciprocal, IEEE sqrtf and /). The
// sums are taken in another order, and the small.small term is dropped:
// held to its plain torch version within 1e-5 of S_t = sum_s (|b||p| +
// |a|(|s| + |t|)) per target. The expansion variant's r^2 cancels for
// near pairs (its t.s is only as good as 3xTF32): held within 5e-5 S_t
// where no pair is nearer than 0.02 and within 1e-3 S_t on the tool's
// data (its near pairs differ by ~1e-4 S_t); near a coincident pair it may
// give inf, as the TPU prototype does. A build whose output reduction
// takes one TF32 pass (FIELD_MMA_OUTPUT_PASSES=1, chip_smoke.py's control)
// misses 1e-5 S_t by 12-21x and 5e-5 S_t by 2.5-3.6x on an H100.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;              // warps per block, 16 targets each
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;              // targets per warp (the MMA's M)
constexpr int kChunk = 512;            // sources per chunk sum (S_BLK)
constexpr unsigned kFull = 0xffffffffu;

// x rounded to TF32 (nearest, ties away), as the tensor cores read it
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

struct Split {
  uint32_t big, small;
};

__device__ __forceinline__ Split split(float x) {
  const uint32_t big = tf32(x);
  return {big, tf32(x - __uint_as_float(big))};
}

// d += A B, one m16n8k8 TF32 product
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += A B in 3xTF32 from split operands: small.big, big.small, big.big
__device__ __forceinline__ void mma3(float (&d)[4], const Split (&a)[4],
                                     Split b0, Split b1) {
  mma(d, a[0].small, a[1].small, a[2].small, a[3].small, b0.big, b1.big);
  mma(d, a[0].big, a[1].big, a[2].big, a[3].big, b0.small, b1.small);
  mma(d, a[0].big, a[1].big, a[2].big, a[3].big, b0.big, b1.big);
}

// the output reduction's product; FIELD_MMA_OUTPUT_PASSES=1 builds the
// one-pass control that chip_smoke.py's limits must reject
#ifndef FIELD_MMA_OUTPUT_PASSES
#define FIELD_MMA_OUTPUT_PASSES 3
#endif
__device__ __forceinline__ void mma3(float (&d)[4], const float (&a)[4],
                                     float b0, float b1) {
  const Split as[4] = {split(a[0]), split(a[1]), split(a[2]), split(a[3])};
#if FIELD_MMA_OUTPUT_PASSES == 1
  mma(d, as[0].big, as[1].big, as[2].big, as[3].big, split(b0).big, split(b1).big);
#else
  mma3(d, as, split(b0), split(b1));
#endif
}

// Chunk end: lane (g, q) holds D[g][2q], D[g][2q+1], D[g+8][2q],
// D[g+8][2q+1]; lanes q = 0 take columns 2-3 from lanes q = 1 and add
// D[:, :3] + D[:, 3] t for targets g and g + 8 to acc.
__device__ __forceinline__ void add_chunk(const float (&d)[4], int q,
                                          const float (&t)[2][3],
                                          float (&acc)[2][3]) {
  float e[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = __shfl_down_sync(kFull, d[i], 1);
  if (q == 0) {
    const float D[2][4] = {{d[0], d[1], e[0], e[1]}, {d[2], d[3], e[2], e[3]}};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int k = 0; k < 3; ++k) acc[h][k] += D[h][k] + D[h][3] * t[h][k];
    }
  }
}

// Stages sources [base, base + m) of src (n, 6) as s[6][kChunk]; with
// s2ps, also s.s and p.s of each (the expansion's per-source terms).
__device__ __forceinline__ void stage(const float* __restrict__ src, int base,
                                      int m, float (*s)[kChunk],
                                      float (*s2ps)[kChunk]) {
  __syncthreads();
  for (int j = threadIdx.x; j < m; j += kThreads) {
    const float* row = src + 6 * (size_t)(base + j);
    float v[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) s[c][j] = v[c] = row[c];
    if (s2ps) {
      s2ps[0][j] = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
      s2ps[1][j] = v[3] * v[0] + v[4] * v[1] + v[5] * v[2];
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void load_targets(const float* __restrict__ tgt,
                                             int n_tgt, int row0, int g,
                                             float (&t)[2][3]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = row0 + g + 8 * h;
#pragma unroll
    for (int k = 0; k < 3; ++k) t[h][k] = i < n_tgt ? tgt[3 * (size_t)i + k] : 0.f;
  }
}

__device__ __forceinline__ void store(float* __restrict__ out, int n_tgt,
                                      int row0, int g, int q,
                                      const float (&acc)[2][3]) {
  if (q != 0) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = row0 + g + 8 * h;
    if (i < n_tgt) {
#pragma unroll
      for (int k = 0; k < 3; ++k) out[3 * (size_t)i + k] = acc[h][k];
    }
  }
}

// B fragments of W = [[p, 0], [-s, 1]] for the sources j0 (row k = q) and
// j1 (row k = q + 4), column n = g: p_j[g] and -s_j[g] for g < 3, 0 and 1
// in column 3, 0 elsewhere and for sources past the chunk's end.
__device__ __forceinline__ void w_fragments(const float (*s)[kChunk], int m,
                                            int g, int j0, int j1, float (&bp)[2],
                                            float (&bs)[2]) {
  const int j[2] = {j0, j1};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool live = j[i] < m;
    bp[i] = g < 3 && live ? s[3 + g][j[i]] : 0.f;
    bs[i] = g < 3 && live ? -s[g][j[i]] : (g == 3 ? 1.f : 0.f);
  }
}

__global__ void __launch_bounds__(kThreads)
field_mxu_exact(const float* __restrict__ src, int n_src,
                const float* __restrict__ tgt, int n_tgt, float eps,
                float* __restrict__ out) {
  __shared__ float s[6][kChunk];
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int row0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRows;
  float t[2][3], acc[2][3] = {};
  load_targets(tgt, n_tgt, row0, g, t);
  for (int base = 0; base < n_src; base += kChunk) {
    const int m = min(kChunk, n_src - base);
    stage(src, base, m, s, nullptr);
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < m; k0 += 8) {
      // A fragments: (g, q), (g+8, q), (g, q+4), (g+8, q+4)
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i & 1;
        const int j = k0 + q + 4 * (i >> 1);
        // csrc/field.cu's pair arithmetic, term for term; computed for
        // every lane (no branch before the MMAs) and dropped past the
        // chunk's end, where the stage holds stale values
        const float px = s[3][j], py = s[4][j], pz = s[5][j];
        const float Rx = s[0][j] - t[h][0];
        const float Ry = s[1][j] - t[h][1];
        const float Rz = s[2][j] - t[h][2];
        const float r2 = Rx * Rx + Ry * Ry + Rz * Rz;
        const bool zero = r2 == 0.f || j >= m;
        const float r = sqrtf(r2);
        const float denom = r * r2 + eps;
        const float c = px * Rx + py * Ry + pz * Rz;
        const float safe_r2 = zero ? 1.f : r2;
        const float inv = 1.f / (safe_r2 * denom);
        const float a = zero ? 0.f : 3.f * c * inv;
        const float b = zero ? 0.f : safe_r2 * inv;
        av[i] = a;
        bv[i] = b;
      }
      float bp[2], bs[2];
      w_fragments(s, m, g, k0 + q, k0 + q + 4, bp, bs);
      mma3(d, bv, bp[0], bp[1]);
      mma3(d, av, bs[0], bs[1]);
    }
    add_chunk(d, q, t, acc);
  }
  store(out, n_tgt, row0, g, q, acc);
}

__global__ void __launch_bounds__(kThreads)
field_mxu_expansion(const float* __restrict__ src, int n_src,
                    const float* __restrict__ tgt, int n_tgt, float eps,
                    float* __restrict__ out) {
  __shared__ float s[6][kChunk];
  __shared__ float s2ps[2][kChunk];
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int row0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRows;
  float t[2][3], acc[2][3] = {};
  load_targets(tgt, n_tgt, row0, g, t);
  float t2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    t2[h] = t[h][0] * t[h][0] + t[h][1] * t[h][1] + t[h][2] * t[h][2];
  // A of the K=3 products: the targets' xyz in k = q < 3, zeros in k >= 3
  const Split zero_split = {0u, 0u};
  const float tq0 = q == 0 ? t[0][0] : (q == 1 ? t[0][1] : t[0][2]);
  const float tq1 = q == 0 ? t[1][0] : (q == 1 ? t[1][1] : t[1][2]);
  const Split ta[4] = {q < 3 ? split(tq0) : zero_split,
                       q < 3 ? split(tq1) : zero_split, zero_split,
                       zero_split};
  for (int base = 0; base < n_src; base += kChunk) {
    const int m = min(kChunk, n_src - base);
    stage(src, base, m, s, s2ps);
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < m; k0 += 8) {
      // B of the K=3 products: row k = q < 3 of source k0 + g's xyz and p
      const bool live = q < 3 && k0 + g < m;
      const int qc = min(q, 2);
      const Split sb = live ? split(s[qc][k0 + g]) : zero_split;
      const Split pb = live ? split(s[3 + qc][k0 + g]) : zero_split;
      float ts[4] = {0.f, 0.f, 0.f, 0.f}, tp[4] = {0.f, 0.f, 0.f, 0.f};
      mma3(ts, ta, sb, zero_split);
      mma3(tp, ta, pb, zero_split);
      // this lane's pairs: targets g, g (sources 2q, 2q+1), g+8, g+8
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1;
        const int j = k0 + 2 * q + (i & 1);
        const float r2 = t2[h] + s2ps[0][j] - 2.f * ts[i];
        const float c = s2ps[1][j] - tp[i];
        const bool zero = r2 <= 0.f;
        const float safe_r2 = zero ? 1.f : r2;
        const float r = sqrtf(safe_r2);
        const float denom = r * safe_r2 + eps;
        const float inv = 1.f / (safe_r2 * denom);
        const bool off = zero || j >= m;     // past the chunk's end: stale
        const float a = off ? 0.f : 3.f * c * inv;
        const float b = off ? 0.f : safe_r2 * inv;
        av[i] = a;
        bv[i] = b;
      }
      // k = q holds source 2q and k = q + 4 source 2q + 1: the A fragment
      // (g, q), (g+8, q), (g, q+4), (g+8, q+4) is accumulator entries 0,
      // 2, 1, 3, and W's rows follow the same order
      const float af[4] = {av[0], av[2], av[1], av[3]};
      const float bf[4] = {bv[0], bv[2], bv[1], bv[3]};
      float bp[2], bs[2];
      w_fragments(s, m, g, k0 + 2 * q, k0 + 2 * q + 1, bp, bs);
      mma3(d, bf, bp[0], bp[1]);
      mma3(d, af, bs[0], bs[1]);
    }
    add_chunk(d, q, t, acc);
  }
  store(out, n_tgt, row0, g, q, acc);
}

template <typename Kernel>
int launch(Kernel kernel, const float* src, int n_src, const float* tgt,
           int n_tgt, float eps, float* out, cudaStream_t stream) {
  if (n_tgt <= 0) return 0;
  const int blocks = (n_tgt + kWarps * kRows - 1) / (kWarps * kRows);
  kernel<<<blocks, kThreads, 0, stream>>>(src, n_src, tgt, n_tgt, eps, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// src (n_src, 6) and tgt (n_tgt, 3), row-major float32 on the device; out
// (n_tgt, 3), not scrubbed. Returns cudaGetLastError().
int dipole_field_mxu_exact(const float* src, int n_src, const float* tgt,
                           int n_tgt, float eps, float* out,
                           cudaStream_t stream) {
  return launch(field_mxu_exact, src, n_src, tgt, n_tgt, eps, out, stream);
}

int dipole_field_mxu_expansion(const float* src, int n_src, const float* tgt,
                               int n_tgt, float eps, float* out,
                               cudaStream_t stream) {
  return launch(field_mxu_expansion, src, n_src, tgt, n_tgt, eps, out, stream);
}

}  // extern "C"
