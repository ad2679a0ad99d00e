// Pair physics shared by the gravity kernels: softened f32 accel, potential
// and jerk of one source on one row, on centred coordinates, in the f32 tier
// and in the extended (hi/lo) tier, and the tile layout of the
// pair-symmetric kernels.
//
// Conventions (oc_nbody_tpu/ops/gravity.py): d = x_j - x_i points at the
// source, dv = v_j - v_i, u = |d|^2 + eps^2, inv = u^-1/2,
//   a_i   += G m_j d inv^3
//   phi_i -= G m_j inv      (the self term is removed by the caller)
//   j_i   += G m_j inv^3 (dv - 3 (d.dv) inv^2 d)
// A source is a float4 (x, y, z, G m), its velocity a float4 (vx, vy, vz, 0).
// No fast-math: rsqrtf keeps its documented 2-ulp bound; FMA contraction is
// allowed.
//
// Extended tier (oc_nbody_tpu/ops/pallas_pair.py:_hilo_sep_inv): a position
// is the pair (hi, lo) of f32 with hi + lo the centred f64 coordinate to
// ~2^-48; the split is made outside the kernels, in f64. A source is two
// float4, (hi.x, hi.y, hi.z, G m) and (lo.x, lo.y, lo.z, 0), and for the
// jerk two more, the velocity's hi and lo. Per pair
//   d = hi_j - hi_i, e = lo_j - lo_i, u = d.d + (2 d.e + eps^2),
//   inv = rsqrt(u) refined by one Newton step, s = d + e,
// and the sums use s where the f32 tier uses d. The lo terms matter only
// for close pairs, where d is a difference of two nearly equal hi values
// (exact, by Sterbenz) and e is of its size.
// FMA contraction stays on here too: these kernels hold no error-free
// transform. Every product and sum above is an ordinary rounded f32
// operation whose result is used as a value, so fusing a multiply into an
// add only removes one rounding. A two-float (df32) kernel is different:
// two_prod and two_sum recover the rounding error of an operation from the
// exact sequence of roundings, and a contraction the compiler chooses (or
// declines) changes what they recover; such a kernel must spell out its
// __fmaf_rn and __fadd_rn / __fmul_rn calls itself.
#pragma once

#include <cuda_runtime.h>

namespace ocn {

// Tile edge of the pair-symmetric jerk kernels K3 and K7: one block of
// kSymTile threads per tile pair (K2, K6, K12 and K15 tile by their own
// geometry, sym_rows.cuh; K13 and K16 by jerk_rows.cuh's).
constexpr int kSymTile = 128;

// The least normal f32, 2^-126.
constexpr float kMinNormal = 1.17549435e-38f;

// Zero-guarded rsqrt, the one guard of every kernel (the df32 seed,
// df.cuh:df_rsqrt, and inv_r_ftz below spell the same rule).
// GUARDED is for eps == 0, where a self pair has u == 0 and must add
// nothing; with eps > 0, u >= eps^2 > 0 everywhere and the compare is
// dropped. The reference (ops/pallas_pair.py:_inv_r) is u > 0 ?
// rsqrt(max(u, 2^-126)) : 0 evaluated in f32 arithmetic that flushes a
// subnormal u to 0 (the TPU; XLA on the CPU), so a u below 2^-126 (a pair
// closer than ~1e-19) adds nothing there. This card keeps subnormals, so
// the flush is spelled out: u >= 2^-126 ? rsqrt(u) : 0.
template <bool GUARDED>
__device__ __forceinline__ float inv_r(float u) {
  if (GUARDED) return u >= kMinNormal ? rsqrtf(u) : 0.f;
  return rsqrtf(u);
}

// rsqrt(u) without the denormal path: rsqrt.approx.ftz is the same MUFU.RSQ
// as rsqrtf, bit for bit on every normal u, minus the three instructions
// that rescale a denormal one. GUARDED (eps == 0) is inv_r's guard: 0 for u
// below the least normal float. With eps > 0, u >= eps^2 is normal (for
// eps above ~1.1e-19), so inv_r_ftz and inv_r give the same bits wherever
// either is used (K2, K6, K12, K13, K15 and K16 take this one).
template <bool GUARDED>
__device__ __forceinline__ float inv_r_ftz(float u) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(u));
  if (GUARDED) return u >= kMinNormal ? r : 0.f;
  return r;
}

// One-sided pair: the action of source s on the row at (xi, yi, zi).
// ph accumulates +G m_j inv; the caller stores -ph.
template <bool WITH_PHI, bool GUARDED>
__device__ __forceinline__ void row_pair(float4 s, float xi, float yi,
                                         float zi, float eps2, float& ax,
                                         float& ay, float& az, float& ph) {
  const float dx = s.x - xi, dy = s.y - yi, dz = s.z - zi;
  const float u = dx * dx + dy * dy + dz * dz + eps2;
  const float inv = inv_r<GUARDED>(u);
  const float gminv = s.w * inv;
  const float w = gminv * (inv * inv);
  ax += w * dx;
  ay += w * dy;
  az += w * dz;
  if (WITH_PHI) ph += gminv;
}

// One-sided accel+jerk pair (pallas_gravity.py:_accel_jerk_kernel): the
// action of source s moving at sv on the row at xi moving at vi. With
// GUARDED and u == 0, inv = 0 gives w = 0 and s = 0: a self pair adds
// nothing to either sum.
template <bool GUARDED>
__device__ __forceinline__ void row_jerk_pair(float4 s, float4 sv, float3 xi,
                                              float3 vi, float eps2,
                                              float3& a, float3& j) {
  const float dx = s.x - xi.x, dy = s.y - xi.y, dz = s.z - xi.z;
  const float dvx = sv.x - vi.x, dvy = sv.y - vi.y, dvz = sv.z - vi.z;
  const float u = dx * dx + dy * dy + dz * dz + eps2;
  const float inv = inv_r<GUARDED>(u);
  const float inv2 = inv * inv;
  const float w = s.w * (inv * inv2);
  const float rv = dx * dvx + dy * dvy + dz * dvz;
  const float sc = (3.f * rv) * w * inv2;
  a.x += w * dx;
  a.y += w * dy;
  a.z += w * dz;
  j.x += w * dvx - sc * dx;
  j.y += w * dvy - sc * dy;
  j.z += w * dvz - sc * dz;
}

// Pair-symmetric accel + jerk pair (K3; K13 runs the same function spelled
// for the issue rate, jerk_rows.cuh:sym_jerk_pair_rb): with w = G m_j
// inv^3, rv = d.dv and B = dv - 3 rv inv^2 d, the action (w d, w B) into
// (a, j) and the reaction -G m_i inv^3 (d, B) into (ca.xyz, ca.w, cj.xy).
template <bool GUARDED>
__device__ __forceinline__ void sym_jerk_pair(float4 s, float4 sv, float3 xi,
                                              float3 vi, float gmi,
                                              float eps2, float3& a,
                                              float3& j, float4& ca,
                                              float2& cj) {
  const float dx = s.x - xi.x, dy = s.y - xi.y, dz = s.z - xi.z;
  const float dvx = sv.x - vi.x, dvy = sv.y - vi.y, dvz = sv.z - vi.z;
  const float u = dx * dx + dy * dy + dz * dz + eps2;
  const float inv = inv_r<GUARDED>(u);
  const float inv2 = inv * inv;
  const float inv3 = inv * inv2;
  const float w = s.w * inv3;
  const float wi = gmi * inv3;
  const float rv = dx * dvx + dy * dvy + dz * dvz;
  const float uu = (3.f * rv) * inv2;
  const float bx = dvx - uu * dx, by = dvy - uu * dy, bz = dvz - uu * dz;
  a.x += w * dx;
  a.y += w * dy;
  a.z += w * dz;
  j.x += w * bx;
  j.y += w * by;
  j.z += w * bz;
  ca.x -= wi * dx;
  ca.y -= wi * dy;
  ca.z -= wi * dz;
  ca.w -= wi * bx;
  cj.x -= wi * by;
  cj.y -= wi * bz;
}

// The extended tier's separation and inverse distance: s = d + e and the
// Newton-refined inv. With GUARDED and u below 2^-126 (a coincident pair at
// eps == 0, or a u that rounds below zero), inv_r gives 0 and the Newton
// step leaves 0 * (1.5 - 0) = 0, so the pair adds nothing. FTZ takes the
// seed from inv_r_ftz: the same bits, three instructions fewer (K6, K15,
// K16).
template <bool GUARDED, bool FTZ = false>
__device__ __forceinline__ float hilo_sep_inv(float4 sh, float4 sl, float3 xi,
                                              float3 li, float eps2,
                                              float3& s) {
  const float dx = sh.x - xi.x, dy = sh.y - xi.y, dz = sh.z - xi.z;
  const float ex = sl.x - li.x, ey = sl.y - li.y, ez = sl.z - li.z;
  const float dd = dx * dx + dy * dy + dz * dz;
  const float de = dx * ex + dy * ey + dz * ez;
  const float u = dd + (2.f * de + eps2);
  float inv = FTZ ? inv_r_ftz<GUARDED>(u) : inv_r<GUARDED>(u);
  inv *= 1.5f - (0.5f * u) * (inv * inv);
  s = make_float3(dx + ex, dy + ey, dz + ez);
  return inv;
}

// The relative velocity of the extended tier, (vhi_j - vhi_i) + (vlo_j -
// vlo_i).
__device__ __forceinline__ float3 hilo_dv(float4 vh, float4 vl, float3 vi,
                                          float3 vli) {
  return make_float3((vh.x - vi.x) + (vl.x - vli.x),
                     (vh.y - vi.y) + (vl.y - vli.y),
                     (vh.z - vi.z) + (vl.z - vli.z));
}

// One-sided extended pair (pallas_gravity.py:_accel_kernel_x and
// _accel_phi_kernel_x): the action of the source (sh, sl) on the row at
// (xi, li). ph accumulates +G m_j inv; the caller stores -ph, which keeps
// the softened self term (the raw potential of this tier). FTZ as in
// hilo_sep_inv.
template <bool WITH_PHI, bool GUARDED, bool FTZ = false>
__device__ __forceinline__ void row_pair_x(float4 sh, float4 sl, float3 xi,
                                           float3 li, float eps2, float& ax,
                                           float& ay, float& az, float& ph) {
  float3 s;
  const float inv = hilo_sep_inv<GUARDED, FTZ>(sh, sl, xi, li, eps2, s);
  const float gminv = sh.w * inv;
  const float w = gminv * (inv * inv);
  ax += w * s.x;
  ay += w * s.y;
  az += w * s.z;
  if (WITH_PHI) ph += gminv;
}

// One-sided extended accel+jerk pair (pallas_gravity.py:
// _accel_jerk_kernel_x): hi/lo positions and velocities.
template <bool GUARDED>
__device__ __forceinline__ void row_jerk_pair_x(float4 sh, float4 sl,
                                                float4 vh, float4 vl,
                                                float3 xi, float3 li,
                                                float3 vi, float3 vli,
                                                float eps2, float3& a,
                                                float3& j) {
  float3 s;
  const float inv = hilo_sep_inv<GUARDED>(sh, sl, xi, li, eps2, s);
  const float3 dv = hilo_dv(vh, vl, vi, vli);
  const float inv2 = inv * inv;
  const float w = sh.w * (inv * inv2);
  const float rv = s.x * dv.x + s.y * dv.y + s.z * dv.z;
  const float sc = (3.f * rv) * w * inv2;
  a.x += w * s.x;
  a.y += w * s.y;
  a.z += w * s.z;
  j.x += w * dv.x - sc * s.x;
  j.y += w * dv.y - sc * s.y;
  j.z += w * dv.z - sc * s.z;
}

// Pair-symmetric extended pair (K6, K15): the action of the source (sh, sl)
// on the row at (xi, li) into (ax, ay, az, ph), and the row's reaction on
// the source, -G m_i s inv^3 (and -G m_i inv for the potential), into col.
// Its rsqrt seed is inv_r_ftz's (hilo_sep_inv's FTZ).
template <bool WITH_PHI, bool GUARDED>
__device__ __forceinline__ void sym_pair_x(float4 sh, float4 sl, float3 xi,
                                           float3 li, float gmi, float eps2,
                                           float& ax, float& ay, float& az,
                                           float& ph, float4& col) {
  float3 s;
  const float inv = hilo_sep_inv<GUARDED, true>(sh, sl, xi, li, eps2, s);
  const float inv2 = inv * inv;
  const float gjinv = sh.w * inv;
  const float giinv = gmi * inv;
  const float w = gjinv * inv2;
  const float wi = giinv * inv2;
  ax += w * s.x;
  ay += w * s.y;
  az += w * s.z;
  col.x -= wi * s.x;
  col.y -= wi * s.y;
  col.z -= wi * s.z;
  if (WITH_PHI) {
    ph += gjinv;
    col.w -= giinv;
  }
}

// Pair-symmetric extended accel + jerk pair (K7, K16): with w = G m_j
// inv^3, rv = s.dv and B = dv - 3 rv inv^2 s, the action (w s, w B) into
// (a, j) and the reaction -G m_i inv^3 (s, B) into (ca.xyz, ca.w, cj.xy).
// FTZ as in hilo_sep_inv.
template <bool GUARDED, bool FTZ = false>
__device__ __forceinline__ void sym_jerk_pair_x(
    float4 sh, float4 sl, float4 vh, float4 vl, float3 xi, float3 li,
    float3 vi, float3 vli, float gmi, float eps2, float3& a, float3& j,
    float4& ca, float2& cj) {
  float3 s;
  const float inv = hilo_sep_inv<GUARDED, FTZ>(sh, sl, xi, li, eps2, s);
  const float3 dv = hilo_dv(vh, vl, vi, vli);
  const float inv2 = inv * inv;
  const float inv3 = inv * inv2;
  const float w = sh.w * inv3;
  const float wi = gmi * inv3;
  const float rv = s.x * dv.x + s.y * dv.y + s.z * dv.z;
  const float uu = (3.f * rv) * inv2;
  const float bx = dv.x - uu * s.x, by = dv.y - uu * s.y,
              bz = dv.z - uu * s.z;
  a.x += w * s.x;
  a.y += w * s.y;
  a.z += w * s.z;
  j.x += w * bx;
  j.y += w * by;
  j.z += w * bz;
  ca.x -= wi * s.x;
  ca.y -= wi * s.y;
  ca.z -= wi * s.z;
  ca.w -= wi * bx;
  cj.x -= wi * by;
  cj.y -= wi * bz;
}

// One Kahan step (oc_nbody_tpu/ops/pallas_gravity.py:_two_sum), the
// compensated sums of K14 and K17: s + c takes in x, with the roundings
// spelled out (y = x - c, t = s + y, c = (t - s) - y) so that nvcc cannot
// contract or reassociate them.
__device__ __forceinline__ void kahan_add(float& s, float& c, float x) {
  const float y = __fsub_rn(x, c);
  const float t = __fadd_rn(s, y);
  c = __fsub_rn(__fsub_rn(t, s), y);
  s = t;
}

__device__ __forceinline__ void kahan_add3(float3& s, float3& c, float3 x) {
  kahan_add(s.x, c.x, x.x);
  kahan_add(s.y, c.y, x.y);
  kahan_add(s.z, c.z, x.z);
}

// First linear block index of row I of the upper triangle of tile pairs,
// whose rows hold J = I .. nt-1.
__device__ __forceinline__ long long triangle_start(long long I, int nt) {
  return I * nt - I * (I - 1) / 2;
}

// Linear block index b -> tile pair (I, J) with I <= J.
__device__ __forceinline__ void tile_pair(long long b, int nt, int& I,
                                          int& J) {
  const double a = 2.0 * nt + 1.0;
  int i = static_cast<int>(0.5 * (a - sqrt(a * a - 8.0 * static_cast<double>(b))));
  i = max(0, min(i, nt - 1));
  while (i > 0 && triangle_start(i, nt) > b) --i;
  while (i + 1 < nt && triangle_start(i + 1, nt) <= b) ++i;
  I = i;
  J = i + static_cast<int>(b - triangle_start(i, nt));
}

// Second pass of the accel + jerk tile-pair kernels (K3, K13, K16): row i
// of n, in tile X = i / tile, sums its np tile partials sc[X][P][i % tile],
// P = 0 .. np-1, in that order (tile = kSymTile for K3, the row tile of
// K13's and K16's geometry), one thread a row; no
// atomics, so the sum is bitwise the same from launch to launch. A slot is
// a float4 (a, j.x) and a float2 (j.y, j.z) at the same index of two
// planes. (A template, so that every source including this header may
// define it: Plane2 is float2.)
template <typename Plane2>
__global__ void tile_reduce_jerk(const float4* __restrict__ sc4,
                                 const Plane2* __restrict__ sc2, int n,
                                 int tile, int np, float* __restrict__ acc,
                                 float* __restrict__ jerk) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int X = i / tile;
  const size_t base = static_cast<size_t>(X) * np * tile + (i - X * tile);
  float4 s4 = sc4[base];
  Plane2 s2 = sc2[base];
  for (int P = 1; P < np; ++P) {
    const size_t at = base + static_cast<size_t>(P) * tile;
    const float4 v4 = sc4[at];
    const Plane2 v2 = sc2[at];
    s4.x += v4.x;
    s4.y += v4.y;
    s4.z += v4.z;
    s4.w += v4.w;
    s2.x += v2.x;
    s2.y += v2.y;
  }
  acc[3 * i] = s4.x;
  acc[3 * i + 1] = s4.y;
  acc[3 * i + 2] = s4.z;
  jerk[3 * i] = s4.w;
  jerk[3 * i + 1] = s2.x;
  jerk[3 * i + 2] = s2.y;
}

// Threads per block of the second passes (tile_reduce_jerk,
// sym_rows.cuh:partials_reduce).
constexpr int kReduceThreads = 256;

}  // namespace ocn
