// The dipole field at target points with its sums on the tensor cores: the
// two "MXU" variants of the field kernel (csrc/field.cu's function),
//   E_t = sum_s (b p_s - a R) = sum_s b p_s - sum_s a s + (sum_s a) t,
// R = x_s - x_t, a = 3 (p_s . R) / (r^2 (r^3 + eps)), b = 1 / (r^3 + eps);
// the three sums become one product a k-step of 8 sources,
// [b | a/3] (T, 16) @ W (16, 8), W = [[p, 0 | p, 0], [-3s, 3 | -3s, 0]],
// the left half of W's columns TF32-rounded and the right half the
// remainder. Output not scrubbed.
//
// Replaces: tools/mxu_field_experiment.py (the JAX package's prototype)
//   dipole_field_mxu_exact      _field_kernel_mxu_exact (:26): R, r^2, c
//                               on the CUDA cores, the output reduction as
//                               the product above;
//   dipole_field_mxu_expansion  _field_kernel_mxu_expansion (:67): r^2 =
//                               t^2 + s^2 - 2 t.s and c = p.s - t.p from
//                               products on the tensor cores too, zero test
//                               r^2 <= 0;
// both launched by make_padded (:108, pallas_call :112).
//
// What bounds it on an H100: instructions issued on the CUDA cores, slowed
// by the products. A lane's k-step (8 pairs) is 173 SASS instructions in
// the exact variant, 21.6 a pair: ~15 of pair math (two of them MUFU), 4
// to split a and b, 1 product, 0.75 shared loads; in the expansion 135,
// 16.9 a pair, with 16 m16n8k8 products a k-step where the exact has 8. At
// the tool's 65536 x 262144 both take 16.6-16.9 ms (PERF.md; the first
// design 57.8 and 72.4), ~3x and ~5x the 5.4 and 3.1 ms bounds (21 and 12
// flops a pair on the CUDA cores at 67 TFLOP/s fp32 against the products
// at 495 TFLOP/s TF32; inputs ~7 MB). Replacing each product by four fp32
// instructions, more issue, took 11-27% off: mma.sync's TF32 rate holds
// the warps. csrc/field.cu (26 instructions a pair, no products) takes the
// same time there, 15.9-16.7 ms.
//
// Design. A warp owns kTiles tiles of 16 targets (one m16n8k8 A operand
// each); a block of kWarps warps owns kTargets targets. Sources are staged
// in shared memory kTile at a time, double-buffered: a thread loads its
// source of the next stage into registers before the warps sum the current
// one, and writes it, with every B operand of the products already split
// and in the order the product reads it, after; one barrier a stage. A
// warp then reads each B operand as one 8-byte load a lane, with no select
// and no split. Per k-step of 8 sources, lane (g, q) (g = lane / 4, q =
// lane % 4) computes a and b on the CUDA cores for exactly the pairs its A
// fragments hold (targets g and g + 8 of each tile, two sources) and feeds
// them to the products from the registers they are in. The source axis is
// cut into chunks along grid.y by common.cuh's chunked::plan (chunks of
// kMinChunk to kMaxChunk sources, enough to fill the card); each block
// writes its partial field and common.cuh's chunked::field_finish (shared
// with csrc/field.cu, here without the scrub) adds the chunks in order: no
// atomics, the same output on every run. A single chunk writes the output
// itself. The launch bounds are measured: the exact variant's 113
// registers (2 blocks an SM) beat its 80 (3) by 1-3%, the expansion's 80
// (3 blocks) its 88-101 (2) by 5-8%.
//
// The exact variant takes csrc/field.cu's arithmetic (common.cuh's root
// and recip, sqrt.approx/rcp.approx, explicit FMAs), with a tiny normal
// number added to r^2 denom instead of a test: a coincident pair (r^2 = 0,
// so c = 0) gives a = b = 0 exactly, so a target on a source gets the
// field of the other sources. The expansion takes r^2 and c from four
// products of A = [-2 t_big, -2 t_small, 1, 1] (8 columns, constant a
// tile) with the sources' [s_big; s_big; s2_big; s2_small] and [s_small;
// 0] (r^2, the product's input C = t^2) and [p_big/2; p_big/2; ps_big;
// ps_small] and [p_small/2; 0] (c): r^2 and c land in the accumulator
// layout, which gives lane (g, q) sources 2q and 2q + 1, so the
// expansion's output product reads its K rows in the source order 0, 2, 4,
// 6, 1, 3, 5, 7.
//
// Precision, 3xTF32. The tensor cores read a TF32 operand from the top 19
// bits of its 32, so a product value x goes in as itself (its TF32 part,
// truncated) and as x - that part (exact): two instructions a value. PTX
// leaves the low 13 bits of a .tf32 operand to the implementation; the
// truncation is what sm_90a was measured to do (an NVIDIA H100: the exact
// variant at 0.04 of its tolerance, the one-pass control below 12-18x
// outside it; PERF.md). A card or driver that rounded instead would cost
// up to one TF32 ulp a product, and tests/test_torch_gpu.py's
// test_mxu_field_kernels_match_plain, at 1e-5 S_t, would fail. W's
// columns 4-7 hold the remainders of columns 0-3, so one product of an A
// part gives that part times W's TF32 part and its remainder, and the two
// A parts take two products (small x small included), where three were
// needed with W split the same way as A. Each stage's sums go to
// registers on the CUDA cores (the products' accumulators restart), so no
// tensor-core sum runs over more than kTile sources. The sums run in
// another order than the plain torch version's (512-source chunk
// products): held to it within 1e-5 of S_t = sum_s (|b||p| + |a|(|s| +
// |t|)) per target (exact; 0.04 of that at the checks, the first design
// 0.13-0.19), the expansion within 5e-5 S_t where no pair is nearer than
// 0.02 and within 1e-3 S_t on the tool's data (its r^2 cancels for near
// pairs); near a coincident pair the expansion may give inf, as the TPU
// prototype does. A build whose output product takes one TF32 pass
// (FIELD_MMA_OUTPUT_PASSES=1: the A parts only, W's remainder columns 0;
// chip_smoke.py's control) must miss those limits.
//
// wgmma.mma_async was measured and lost (PERF.md): m64n8k8 for every
// product 9-15% slower, or wrong with a group left in flight (ptxas reused
// its A registers); m64n32k8 for the expansion's r^2 and c, the output on
// mma.sync, 0-4% slower: the waits and the warpgroup's lockstep cost more
// than the faster tensor rate gives.

#include <cstdint>

#include "common.cuh"

#ifndef FIELD_MMA_OUTPUT_PASSES
#define FIELD_MMA_OUTPUT_PASSES 3
#endif

namespace {

constexpr int kWarps = 8;                      // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kTiles = 2;                      // 16-target tiles a warp
constexpr int kTargets = kWarps * 16 * kTiles; // targets a block
constexpr int kTile = 128;                     // sources a stage
constexpr int kSteps = kTile / 8;              // k-steps of 8 sources a stage
constexpr int kB = 64;                         // floats of one 8 x 8 B operand
constexpr int kMaxChunk = 8192;                // sources a block, at most
constexpr int kMinChunk = 128;                 // and at least, when cut finer
constexpr bool kSplitA = FIELD_MMA_OUTPUT_PASSES != 1;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTiny = 2e-38f;                // normal: recip keeps it

// The staged sources. Exact: positions and moments for the pair math, and
// per k-step the B operands W_b, W_a of the output product. Expansion: per
// k-step the B operands of r^2 (2), of c (2), then W_b and W_a.
template <bool kExpansion>
struct Stage {
  float4 sa[kTile];               // x, y, z, px
  float2 sb[kTile];               // py, pz
  float w[kSteps][2][kB];
};

template <>
struct Stage<true> {
  float w[kSteps][6][kB];
};

// Where B[k][n] of an 8 x 8 B operand lies in its kB floats: lane 4n + q
// reads B[q][n] and B[q + 4][n] as one float2.
__device__ __forceinline__ int b_at(int k, int n) {
  return 8 * n + 2 * (k & 3) + (k >> 2);
}

// x rounded to TF32 (nearest, ties away), as a float
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xffffe000u);
}

struct Split {
  float big, small;
};

// a staged B value: its TF32 rounding and the remainder's, both exact TF32
__device__ __forceinline__ Split split(float x) {
  const float big = tf32_rna(x);
  return {big, tf32_rna(x - big)};
}

// a product value x's remainder below the TF32 part the tensor cores read
__device__ __forceinline__ uint32_t rest(float x) {
  return __float_as_uint(x - __uint_as_float(__float_as_uint(x) & 0xffffe000u));
}

struct BOp {
  uint32_t b0, b1;
};

__device__ __forceinline__ BOp b_op(const float* b, int lane) {
  const float2 v = reinterpret_cast<const float2*>(b)[lane];
  return {__float_as_uint(v.x), __float_as_uint(v.y)};
}

// d += A B, one m16n8k8 TF32 product of this warp's 16 rows
__device__ __forceinline__ void product(float (&d)[4], const uint32_t (&a)[4],
                                        BOp b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.b0), "r"(b.b1));
}


// The output product of one k-step and tile: b (A fragment order) times
// W_b into db, a / 3 times W_a into da, each as its TF32 part and, but in
// the one-pass control, its remainder.
__device__ __forceinline__ void output_products(float (&db)[4], float (&da)[4],
                                                const float (&b)[4],
                                                const float (&a)[4], BOp wb,
                                                BOp wa) {
  uint32_t x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = __float_as_uint(b[i]);
  product(db, x, wb);
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = __float_as_uint(a[i]);
  product(da, x, wa);
  if (kSplitA) {
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = rest(b[i]);
    product(db, x, wb);
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = rest(a[i]);
    product(da, x, wa);
  }
}

// Writes row k of W_b and W_a (columns 0-3 the TF32 parts of [p, 0] and
// [-3s, 3], 4-7 the remainders) for a source at s, moment p.
__device__ __forceinline__ void stage_w(float* wb, float* wa, int k,
                                        const float* s, const float* p,
                                        bool live) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const Split bp = split(p[c]);
    const Split as = split(-3.f * s[c]);
    wb[b_at(k, c)] = bp.big;
    wb[b_at(k, 4 + c)] = kSplitA ? bp.small : 0.f;
    wa[b_at(k, c)] = as.big;
    wa[b_at(k, 4 + c)] = kSplitA ? as.small : 0.f;
  }
  wb[b_at(k, 3)] = 0.f;
  wb[b_at(k, 7)] = 0.f;
  wa[b_at(k, 3)] = live ? 3.f : 0.f;
  wa[b_at(k, 7)] = 0.f;
}

// Stages source j of a stage from v (x, y, z, px, py, pz; zeros past the
// chunk's end, whose B rows are 0 and so add nothing).
__device__ __forceinline__ void stage_source(Stage<false>& st, int j,
                                             const float (&v)[6], bool live) {
  st.sa[j] = make_float4(v[0], v[1], v[2], v[3]);
  st.sb[j] = make_float2(v[4], v[5]);
  stage_w(st.w[j >> 3][0], st.w[j >> 3][1], j & 7, v, v + 3, live);
}

__device__ __forceinline__ void stage_source(Stage<true>& st, int j,
                                             const float (&v)[6], bool live) {
  float(*w)[kB] = st.w[j >> 3];
  const int n = j & 7;
  const float s2 = __fmaf_rn(v[2], v[2], __fmaf_rn(v[1], v[1], v[0] * v[0]));
  const float ps = __fmaf_rn(v[5], v[2], __fmaf_rn(v[4], v[1], v[3] * v[0]));
  const Split s2s = split(s2), pss = split(ps);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const Split sc = split(v[c]), pc = split(v[3 + c]);
    w[0][b_at(c, n)] = sc.big;                 // r^2: [s_big; s_big; s2]
    w[0][b_at(3 + c, n)] = sc.big;
    w[1][b_at(c, n)] = sc.small;               //      [s_small; 0]
    w[1][b_at(3 + c, n)] = 0.f;
    w[2][b_at(c, n)] = 0.5f * pc.big;          // c: [p_big/2; p_big/2; ps]
    w[2][b_at(3 + c, n)] = 0.5f * pc.big;
    w[3][b_at(c, n)] = 0.5f * pc.small;        //    [p_small/2; 0]
    w[3][b_at(3 + c, n)] = 0.f;
  }
  w[0][b_at(6, n)] = s2s.big;
  w[0][b_at(7, n)] = s2s.small;
  w[1][b_at(6, n)] = 0.f;
  w[1][b_at(7, n)] = 0.f;
  w[2][b_at(6, n)] = pss.big;
  w[2][b_at(7, n)] = pss.small;
  w[3][b_at(6, n)] = 0.f;
  w[3][b_at(7, n)] = 0.f;
  // the output product's K row of source n: lane q holds sources 2q, 2q + 1
  stage_w(w[4], w[5], (n >> 1) + 4 * (n & 1), v, v + 3, live);
}

__device__ __forceinline__ void load_source(const float* __restrict__ src,
                                            int j, int end, float (&v)[6]) {
  const bool live = j < end;
  const float* p = src + 6 * (size_t)(live ? j : 0);
#pragma unroll
  for (int c = 0; c < 6; ++c) v[c] = live ? p[c] : 0.f;
}

// a and b of the pair (source s, moment p; target t): csrc/field.cu's
// arithmetic with kTiny added to r^2 denom, so that r^2 = 0 gives 0 (c =
// 0); below half an ulp of any r^2 denom above 1e-31, it changes no other
// pair's bits
__device__ __forceinline__ void exact_pair(float4 s, float2 p,
                                           const float (&t)[3], float eps,
                                           float& a, float& b) {
  const float Rx = s.x - t[0];
  const float Ry = s.y - t[1];
  const float Rz = s.z - t[2];
  const float r2 = __fmaf_rn(Rz, Rz, __fmaf_rn(Ry, Ry, Rx * Rx));
  const float denom = __fmaf_rn(root(r2), r2, eps);
  const float c = __fmaf_rn(p.y, Rz, __fmaf_rn(p.x, Ry, s.w * Rx));
  const float inv = recip(__fmaf_rn(r2, denom, kTiny));
  a = c * inv;
  b = r2 * inv;
}

// a and b of a pair from the expansion's r^2 and c; r^2 <= 0 gives 0
__device__ __forceinline__ void expansion_pair(float r2, float c, float eps,
                                               float& a, float& b) {
  const float denom = __fmaf_rn(root(r2), r2, eps);
  const float inv = r2 > 0.f ? recip(r2 * denom) : 0.f;
  a = c * inv;
  b = r2 * inv;
}

// The k-steps of one stage into db, da (exact variant).
__device__ __forceinline__ void sum_stage(const Stage<false>& st, int steps,
                                          int lane, const float (&t)[kTiles][2][3],
                                          const uint32_t (&)[kTiles][4],
                                          const float (&)[kTiles][2], float eps,
                                          float (&db)[kTiles][4],
                                          float (&da)[kTiles][4]) {
  const int q = lane & 3;
  for (int k = 0; k < steps; ++k) {
    const float4 s0 = st.sa[8 * k + q], s1 = st.sa[8 * k + q + 4];
    const float2 p0 = st.sb[8 * k + q], p1 = st.sb[8 * k + q + 4];
    const BOp wb = b_op(st.w[k][0], lane), wa = b_op(st.w[k][1], lane);
    float a[kTiles][4], b[kTiles][4];
#pragma unroll
    for (int h = 0; h < kTiles; ++h) {
      // fragment i: target g + 8 (i & 1), source q + 4 (i >> 1)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        exact_pair(s0, p0, t[h][r], eps, a[h][r], b[h][r]);
        exact_pair(s1, p1, t[h][r], eps, a[h][2 + r], b[h][2 + r]);
      }
    }
#pragma unroll
    for (int h = 0; h < kTiles; ++h) output_products(db[h], da[h], b[h], a[h], wb, wa);
  }
}

// The k-steps of one stage into db, da (expansion variant): A holds the
// tile's [-2 t_big, -2 t_small, 1, 1], t2 the fragment rows' t^2.
__device__ __forceinline__ void sum_stage(const Stage<true>& st, int steps,
                                          int lane, const float (&)[kTiles][2][3],
                                          const uint32_t (&A)[kTiles][4],
                                          const float (&t2)[kTiles][2], float eps,
                                          float (&db)[kTiles][4],
                                          float (&da)[kTiles][4]) {
  for (int k = 0; k < steps; ++k) {
    const BOp r1 = b_op(st.w[k][0], lane), r2b = b_op(st.w[k][1], lane);
    const BOp c1 = b_op(st.w[k][2], lane), c2 = b_op(st.w[k][3], lane);
    const BOp wb = b_op(st.w[k][4], lane), wa = b_op(st.w[k][5], lane);
    float r2[kTiles][4], c[kTiles][4];
#pragma unroll
    for (int h = 0; h < kTiles; ++h) {
      r2[h][0] = r2[h][1] = t2[h][0];
      r2[h][2] = r2[h][3] = t2[h][1];
#pragma unroll
      for (int i = 0; i < 4; ++i) c[h][i] = 0.f;
    }
#pragma unroll
    for (int h = 0; h < kTiles; ++h) {
      product(r2[h], A[h], r1);
      product(r2[h], A[h], r2b);
      product(c[h], A[h], c1);
      product(c[h], A[h], c2);
    }
    // accumulator entry i is target g + 8 (i >> 1), source 2q + (i & 1):
    // A fragment entry 0, 2, 1, 3 of the output product
    float a[kTiles][4], b[kTiles][4];
#pragma unroll
    for (int h = 0; h < kTiles; ++h) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int f = ((i & 1) << 1) | (i >> 1);
        expansion_pair(r2[h][i], c[h][i], eps, a[h][f], b[h][f]);
      }
    }
#pragma unroll
    for (int h = 0; h < kTiles; ++h) output_products(db[h], da[h], b[h], a[h], wb, wa);
  }
}

// Block (x, y) sums sources [y chunk, (y + 1) chunk) at targets [x kTargets,
// (x + 1) kTargets): warp w's tile h is the 16 targets from x kTargets +
// 16 (kTiles w + h). With one chunk it writes the field to out, else its
// partial to partial[y].
template <bool kExpansion>
__global__ void __launch_bounds__(kThreads, kExpansion ? 3 : 1)
field_mma_partial(const float* __restrict__ src, int n_src, int chunk,
                  const float* __restrict__ tgt, int n_tgt, float eps,
                  float* __restrict__ partial, float* __restrict__ out) {
  extern __shared__ float4 smem[];
  Stage<kExpansion>* stage = reinterpret_cast<Stage<kExpansion>*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  int row0[kTiles];
  float t[kTiles][2][3];
#pragma unroll
  for (int h = 0; h < kTiles; ++h) {
    row0[h] = blockIdx.x * kTargets + 16 * (kTiles * warp + h);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row0[h] + g + 8 * r;
#pragma unroll
      for (int k = 0; k < 3; ++k) t[h][r][k] = i < n_tgt ? tgt[3 * (size_t)i + k] : 0.f;
    }
  }
  // the expansion's A of r^2 and c: row [-2 t_big, -2 t_small, 1, 1]; this
  // lane's entries (g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4)
  uint32_t A[kTiles][4];
  float t2[kTiles][2];
#pragma unroll
  for (int h = 0; h < kTiles; ++h) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float* tt = t[h][r];
      t2[h][r] = __fmaf_rn(tt[2], tt[2], __fmaf_rn(tt[1], tt[1], tt[0] * tt[0]));
      const Split x = split(tt[0]), y = split(tt[1]), z = split(tt[2]);
      const float lo = q == 0 ? x.big : q == 1 ? y.big : q == 2 ? z.big : x.small;
      const float hi = q == 0 ? y.small : q == 1 ? z.small : -0.5f;
      A[h][r] = __float_as_uint(-2.f * lo);
      A[h][2 + r] = __float_as_uint(-2.f * hi);
    }
  }

  float acc[kTiles][4] = {};
  const int begin = blockIdx.y * chunk;
  const int end = min(begin + chunk, n_src);
  float v[6];
  if (threadIdx.x < kTile) {
    load_source(src, begin + threadIdx.x, end, v);
    stage_source(stage[0], threadIdx.x, v, begin + (int)threadIdx.x < end);
  }
  __syncthreads();
  int buf = 0;
  for (int base = begin; base < end; base += kTile) {
    const int next = base + kTile;
    const bool more = next < end;
    if (more && threadIdx.x < kTile) load_source(src, next + threadIdx.x, end, v);
    float db[kTiles][4] = {}, da[kTiles][4] = {};
    sum_stage(stage[buf], min(kSteps, (end - base + 7) / 8), lane, t, A, t2, eps,
              db, da);
#pragma unroll
    for (int h = 0; h < kTiles; ++h) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[h][i] += db[h][i] + da[h][i];
    }
    if (more && threadIdx.x < kTile) {
      stage_source(stage[buf ^ 1], threadIdx.x, v, next + (int)threadIdx.x < end);
    }
    __syncthreads();
    buf ^= 1;
  }

  // lane (g, q) holds columns 2q, 2q + 1 of rows g, g + 8: the TF32 parts'
  // columns 0-3 plus the remainders' 4-7 (lane q + 2), then lane q = 0
  // takes columns 2-3 from lane 1: E = D[:, :3] + D[:, 3] t
#pragma unroll
  for (int h = 0; h < kTiles; ++h) {
    float c01[4], c23[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) c01[i] = acc[h][i] + __shfl_down_sync(kFull, acc[h][i], 2);
#pragma unroll
    for (int i = 0; i < 4; ++i) c23[i] = __shfl_down_sync(kFull, c01[i], 1);
    if (q != 0) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row0[h] + g + 8 * r;
      if (i >= n_tgt) continue;
      const float col[3] = {c01[2 * r], c01[2 * r + 1], c23[2 * r]};
      const float sum_a = c23[2 * r + 1];
      float* o = gridDim.y == 1 ? out + 3 * (size_t)i
                                : partial + ((size_t)blockIdx.y * n_tgt + i) * 3;
      // the target read again: the expansion holds no t through the sums
#pragma unroll
      for (int k = 0; k < 3; ++k) o[k] = __fmaf_rn(sum_a, tgt[3 * (size_t)i + k], col[k]);
    }
  }
}

inline void plan(int n_src, int n_tgt, int* n_chunks, int* chunk) {
  chunked::plan(n_src, n_tgt, n_chunks, chunk, kTargets, kMaxChunk, kMinChunk);
}

template <bool kExpansion>
int launch(const float* src, int n_src, const float* tgt, int n_tgt, float eps,
           float* partial, float* out, cudaStream_t stream) {
  if (n_tgt <= 0) return 0;
  int n_chunks, chunk;
  plan(n_src, n_tgt, &n_chunks, &chunk);
  if (n_chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 2 * sizeof(Stage<kExpansion>);
  // set on every launch: the attribute belongs to the current device, and
  // a process may launch on several cards
  const cudaError_t attr = cudaFuncSetAttribute(
      field_mma_partial<kExpansion>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int t_blocks = (n_tgt + kTargets - 1) / kTargets;
  if (n_chunks > 0) {
    field_mma_partial<kExpansion><<<dim3(t_blocks, n_chunks), kThreads, smem, stream>>>(
        src, n_src, chunk, tgt, n_tgt, eps, partial, out);
  }
  chunked::finish_field<false>(partial, n_chunks, n_tgt, out, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Number of partial fields either variant writes for n_src sources at n_tgt
// targets: the scratch the caller allocates holds that many x n_tgt x 3
// floats (none for a single chunk, which writes out directly).
int dipole_field_mma_chunks(int n_src, int n_tgt) {
  int n_chunks, chunk;
  plan(n_src, n_tgt, &n_chunks, &chunk);
  return n_chunks > 1 ? n_chunks : 0;
}

// src (n_src, 6) and tgt (n_tgt, 3), row-major float32 on the device;
// partial (dipole_field_mma_chunks(n_src, n_tgt), n_tgt, 3) scratch; out
// (n_tgt, 3), not scrubbed. Returns cudaGetLastError().
int dipole_field_mxu_exact(const float* src, int n_src, const float* tgt,
                           int n_tgt, float eps, float* partial, float* out,
                           cudaStream_t stream) {
  return launch<false>(src, n_src, tgt, n_tgt, eps, partial, out, stream);
}

int dipole_field_mxu_expansion(const float* src, int n_src, const float* tgt,
                               int n_tgt, float eps, float* partial, float* out,
                               cudaStream_t stream) {
  return launch<true>(src, n_src, tgt, n_tgt, eps, partial, out, stream);
}

}  // extern "C"
