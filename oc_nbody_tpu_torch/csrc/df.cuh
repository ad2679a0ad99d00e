// Two-float (df32) arithmetic and the pair physics of the df32 tier, shared
// by K10 (rows_accel_df.cu) and K11 (rows_jerk_df.cu), with the launch plan
// and the two reductions both kernels use.
//
// A df number is a pair (hi, lo) of f32 with |lo| <= ulp(hi)/2: about 48
// significand bits. Every pair quantity of the tier is one: separation, r^2,
// its inverse square root, the weight, each product summed, and the sums
// themselves (oc_nbody_tpu/ops/pallas_df.py, oc_nbody_tpu/ops/df32.py).
//
// Error-free transforms. two_sum and two_prod recover the rounding error of
// an f32 operation from an exact sequence of roundings, so every operation
// in this header is an intrinsic with its rounding spelled out (__fadd_rn,
// __fsub_rn, __fmul_rn, __fmaf_rn): nvcc neither contracts nor reorders
// those, whatever --fmad says. two_prod is the product and one fused
// multiply-add, p = a*b, e = fma(a, b, -p), exact in two operations (the
// TPU kernel splits each factor with a 12-bit mask because it has no FMA).
// No fast-math: rsqrtf keeps its 2-ulp bound, and the f32 Newton step
// brings it to f32 accuracy before the df step.
//
// Work per pair, an FMA counted as 2 flops and the rsqrt apart:
//   two_sum 6, quick_two_sum 3, two_prod 3, df_add 11, df_mul 10,
//   df_sqr 9, df_mul_f 8, df_sep 14, df_rsqrt 39;
//   accel pair  (df_accel_pair): 3 df_sep + (3 df_sqr + 3 df_add) + df_rsqrt
//     + (df_sqr + 2 df_mul) + 3 (df_mul + df_add) = 42 + 60 + 39 + 29 + 63
//     = 233;
//   accel+jerk pair (df_jerk_pair): 6 df_sep + 60 + 39 + (df_sqr + 2 df_mul)
//     + (3 df_mul + 2 df_add) + (df_mul_f + 2 df_mul) + 3 (df_mul + df_add)
//     + 3 (2 df_mul + 2 df_add) = 84 + 60 + 39 + 29 + 52 + 28 + 63 + 126
//     = 481.
#pragma once

#include <cuda_runtime.h>

#include "pair.cuh"  // kMinNormal, the guard's threshold

namespace ocn {

struct df {
  float hi, lo;
};

struct df3 {
  df x, y, z;
};

// s + e == a + b exactly (Knuth).
__device__ __forceinline__ df two_sum(float a, float b) {
  const float s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  const float e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
  return {s, e};
}

// s + e == a + b exactly, requires |a| >= |b| (Dekker).
__device__ __forceinline__ df quick_two_sum(float a, float b) {
  const float s = __fadd_rn(a, b);
  return {s, __fsub_rn(b, __fsub_rn(s, a))};
}

// p + e == a * b exactly (barring underflow of e).
__device__ __forceinline__ df two_prod(float a, float b) {
  const float p = __fmul_rn(a, b);
  return {p, __fmaf_rn(a, b, -p)};
}

__device__ __forceinline__ df df_neg(df x) { return {-x.hi, -x.lo}; }

__device__ __forceinline__ df df_add(df x, df y) {
  const df s = two_sum(x.hi, y.hi);
  return quick_two_sum(s.hi, __fadd_rn(s.lo, __fadd_rn(x.lo, y.lo)));
}

// The cross terms x.hi y.lo + x.lo y.hi enter below the product's last bit;
// they are folded into its error word by two fused multiply-adds.
__device__ __forceinline__ df df_mul(df x, df y) {
  const df p = two_prod(x.hi, y.hi);
  const float e = __fmaf_rn(x.lo, y.hi, __fmaf_rn(x.hi, y.lo, p.lo));
  return quick_two_sum(p.hi, e);
}

__device__ __forceinline__ df df_sqr(df x) {
  const df p = two_prod(x.hi, x.hi);
  const float e = __fmaf_rn(__fadd_rn(x.hi, x.hi), x.lo, p.lo);
  return quick_two_sum(p.hi, e);
}

__device__ __forceinline__ df df_mul_f(df x, float b) {
  const df p = two_prod(x.hi, b);
  return quick_two_sum(p.hi, __fmaf_rn(x.lo, b, p.lo));
}

// df 1/sqrt(x): the hardware seed, one plain-f32 Newton step, one df Newton
// step y <- y (3 - x y^2) / 2. GUARDED is for eps == 0, where a self pair
// has x == 0: the seed is then 0 and every later product keeps it 0, so the
// pair adds nothing. The seed takes pair.cuh:inv_r's guard (the reference's
// seed, ops/pallas_df.py:_df_rsqrt, on f32 arithmetic that flushes a
// subnormal x.hi): a pair with x.hi below 2^-126 adds nothing either.
template <bool GUARDED>
__device__ __forceinline__ df df_rsqrt(df x) {
  const float y0 = rsqrtf(x.hi);
  float y = GUARDED ? (x.hi >= kMinNormal ? y0 : 0.f) : y0;
  const float h = __fmul_rn(0.5f, x.hi);
  y = __fmul_rn(y, __fmaf_rn(-h, __fmul_rn(y, y), 1.5f));
  const df xy2 = df_mul(x, two_prod(y, y));
  const df tm = df_add(df{3.f, 0.f}, df_neg(xy2));
  const df out = df_mul_f(tm, y);
  return {__fmul_rn(0.5f, out.hi), __fmul_rn(0.5f, out.lo)};
}

// One component of the df separation source - row: the exact difference of
// the hi words, the lo difference folded in, then renormalised by a second
// two_sum. For a close pair the lo correction exceeds ulp(d), and df_sqr on
// an unnormalised pair loses (de/d)^2 of r^2.
__device__ __forceinline__ df df_sep(float sh, float sl, float rh, float rl) {
  const df d = two_sum(sh, -rh);
  return two_sum(d.hi, __fadd_rn(d.lo, __fsub_rn(sl, rl)));
}

__device__ __forceinline__ df3 df_sep3(float4 sh, float4 sl, float3 rh,
                                       float3 rl) {
  return {df_sep(sh.x, sl.x, rh.x, rl.x), df_sep(sh.y, sl.y, rh.y, rl.y),
          df_sep(sh.z, sl.z, rh.z, rl.z)};
}

// u = |d|^2 + eps^2 in df.
__device__ __forceinline__ df df_r2(const df3& d, df eps2) {
  return df_add(df_add(df_sqr(d.x), df_sqr(d.y)),
                df_add(df_sqr(d.z), eps2));
}

__device__ __forceinline__ void df_acc3(df3& a, df w, const df3& d) {
  a.x = df_add(a.x, df_mul(w, d.x));
  a.y = df_add(a.y, df_mul(w, d.y));
  a.z = df_add(a.z, df_mul(w, d.z));
}

// The action of one source on one row, accel only. A source is two float4,
// (hi.x, hi.y, hi.z, gm.hi) and (lo.x, lo.y, lo.z, gm.lo), gm = G m formed
// in f64 and split.
template <bool GUARDED>
__device__ __forceinline__ void df_accel_pair(float4 sh, float4 sl, float3 xh,
                                              float3 xl, df eps2, df3& a) {
  const df3 d = df_sep3(sh, sl, xh, xl);
  const df inv = df_rsqrt<GUARDED>(df_r2(d, eps2));
  const df w = df_mul(df{sh.w, sl.w}, df_mul(df_sqr(inv), inv));
  df_acc3(a, w, d);
}

// The same with the jerk: vh, vl are the source's velocity planes (w
// unused), j += w dv - 3 (d.dv) w inv^2 d, every term df.
template <bool GUARDED>
__device__ __forceinline__ void df_jerk_pair(float4 sh, float4 sl, float4 vh,
                                             float4 vl, float3 xh, float3 xl,
                                             float3 uh, float3 ul, df eps2,
                                             df3& a, df3& j) {
  const df3 d = df_sep3(sh, sl, xh, xl);
  const df3 dv = df_sep3(vh, vl, uh, ul);
  const df inv = df_rsqrt<GUARDED>(df_r2(d, eps2));
  const df inv2 = df_sqr(inv);
  const df w = df_mul(df{sh.w, sl.w}, df_mul(inv2, inv));
  const df rv = df_add(df_add(df_mul(d.x, dv.x), df_mul(d.y, dv.y)),
                       df_mul(d.z, dv.z));
  const df ms = df_neg(df_mul(df_mul_f(rv, 3.f), df_mul(w, inv2)));
  df_acc3(a, w, d);
  j.x = df_add(j.x, df_add(df_mul(w, dv.x), df_mul(ms, d.x)));
  j.y = df_add(j.y, df_add(df_mul(w, dv.y), df_mul(ms, d.y)));
  j.z = df_add(j.z, df_add(df_mul(w, dv.z), df_mul(ms, d.z)));
}

// ---- launch plan and reductions of K10 and K11 --------------------------
//
// K9's layout (rows_jerk_x.cu): a block of kDfRows x kDfLanes threads takes
// kDfRows rows and one chunk of the sources, staged through shared memory
// kDfStage at a time; thread (lane l, row r) sums sources l, l + kDfLanes,
// ... of each stage into df accumulators in registers. The lanes' sums are
// then added by df_add in lane order, the chunks' by df_add in chunk order
// in a second pass: the sum over sources is df to the end, in one fixed
// order, with no atomics, so a launch repeats bitwise.
//
// These kernels serve self-interactions only (the block stepper's active
// rows take another route), so the chunk count may follow the row count:
// enough chunks that the blocks fill the card, one chunk once the row tiles
// alone do.

constexpr int kDfRows = 32;   // rows per block: one warp's lanes
constexpr int kDfLanes = 8;   // source lanes per row: one warp each
constexpr int kDfThreads = kDfRows * kDfLanes;
constexpr int kDfStage = kDfThreads;   // sources staged per step
constexpr int kDfTargetBlocks = 1056;  // 8 blocks for each of 132 SMs

// (sources per chunk, chunks): a function of (nr, ns) alone.
inline void df_plan(int nr, int ns, int& chunk, int& nchunks) {
  const int tiles = (nr + kDfRows - 1) / kDfRows;
  const int want = (kDfTargetBlocks + tiles - 1) / tiles;
  const int most = (ns + kDfStage - 1) / kDfStage;
  const int n = want < most ? want : most;
  chunk = ((ns + n - 1) / n + kDfStage - 1) / kDfStage * kDfStage;
  nchunks = (ns + chunk - 1) / chunk;
}

__device__ __forceinline__ float3 df_row3(const float* __restrict__ p, int i) {
  return make_float3(p[3 * i], p[3 * i + 1], p[3 * i + 2]);
}

__device__ __forceinline__ float4 df_src4(const float* __restrict__ p, int j,
                                          float w) {
  return make_float4(p[3 * j], p[3 * j + 1], p[3 * j + 2], w);
}

// The lanes' sums of one block, added in lane order. red[l][k][r] holds
// lane l's word k of row r: words 0 .. NC-1 the hi words of the NC
// components, NC .. 2 NC - 1 their lo words. Warp k < NC adds component k
// and stores the chunk partial to part[(c * 2 NC + word) * nr + row].
template <int NC>
__device__ __forceinline__ void df_reduce_lanes(
    const float (&red)[kDfLanes][2 * NC][kDfRows], int lane, int r, int c,
    int i, int nr, float* __restrict__ part) {
  if (lane >= NC) return;
  df t = {red[0][lane][r], red[0][NC + lane][r]};
#pragma unroll
  for (int l = 1; l < kDfLanes; ++l)
    t = df_add(t, df{red[l][lane][r], red[l][NC + lane][r]});
  part[(static_cast<long long>(c) * 2 * NC + lane) * nr + i] = t.hi;
  part[(static_cast<long long>(c) * 2 * NC + NC + lane) * nr + i] = t.lo;
}

// Pass 2, one thread per (component, row): the chunk partials added by
// df_add in chunk order. Components 0..2 go to (ahi, alo), 3..5 to
// (jhi, jlo).
template <int NC>
__global__ void df_reduce_chunks(const float* __restrict__ part, int nr,
                                 int nchunks, float* __restrict__ ahi,
                                 float* __restrict__ alo,
                                 float* __restrict__ jhi,
                                 float* __restrict__ jlo) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= static_cast<long long>(NC) * nr) return;
  const int k = static_cast<int>(t / nr);
  const int i = static_cast<int>(t % nr);
  df s = {part[static_cast<long long>(k) * nr + i],
          part[static_cast<long long>(NC + k) * nr + i]};
  for (int c = 1; c < nchunks; ++c) {
    const long long base = static_cast<long long>(c) * 2 * NC;
    s = df_add(s, df{part[(base + k) * nr + i],
                    part[(base + NC + k) * nr + i]});
  }
  if (k < 3) {
    ahi[3 * i + k] = s.hi;
    alo[3 * i + k] = s.lo;
  } else {
    jhi[3 * i + k - 3] = s.hi;
    jlo[3 * i + k - 3] = s.lo;
  }
}

template <int NC>
inline int df_launch_reduce(const float* part, int nr, int nchunks, float* ahi,
                            float* alo, float* jhi, float* jlo,
                            cudaStream_t s) {
  constexpr int kReduceThreads = 256;
  const long long work = static_cast<long long>(NC) * nr;
  const int blocks = static_cast<int>((work + kReduceThreads - 1) /
                                      kReduceThreads);
  df_reduce_chunks<NC><<<blocks, kReduceThreads, 0, s>>>(part, nr, nchunks,
                                                         ahi, alo, jhi, jlo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ocn
