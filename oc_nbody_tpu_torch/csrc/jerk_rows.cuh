// Register-blocked rows for accel + jerk: the tile sweep of the cross
// kernels K13 (cross_jerk.cu, f32) and K16 (cross_jerk_x.cu, the extended
// hi/lo tier), on the plan of sym_rows.cuh (K2, K12).
//
// A block of rb::kThreads threads owns a row tile of R * kThreads rows of
// set A, R rows a thread, held in registers: position, velocity, G m and
// the six sums a and j (13 floats a row at f32, 19 with the hi/lo planes).
// It sweeps a range of B's columns in shared sub-tiles of rb::kCols
// sources on the rotating diagonal (column (t + k) mod kCols at step k).
// Each step loads one column, computes R pairs (the thread's R rows
// against it), sums that column's six-float reaction (a.xyz, j.xyz) over
// the R rows in registers and read-modify-writes the warp's slot once: a
// float4 (a.x, a.y, a.z, j.x) and a float2 (j.y, j.z). The first design of
// K13 and K16 (one row a thread) did that read-modify-write for every
// pair: 80 shared bytes a pair at f32 (16 B source, 16 B velocity, 48 B
// slot traffic) and 112 at the extended tier (four 16 B source planes),
// which bound both at the shared-memory rate (128 B a clock per SM). Here
// it is 80 / R and 112 / R bytes a pair, so from R = 4 on the issue rate
// of the pair binds instead: the f32 pair is respelled for it
// (sym_jerk_pair_rb: 33 FP32 instructions and one MUFU), the extended pair
// is pair.cuh:sym_jerk_pair_x to the letter (its Newton-refined inverse
// and lo-corrected separation are what the close-pair limits rest on) but
// for its rsqrt seed, taken without the denormal rescale (inv_r_ftz: the
// same bits on every u the kernel sees, and it freed the register that R =
// 4 spilled with the guard).
//
// Every sum is taken in a fixed order: a row's action over the columns in
// sweep order, a column's reaction over its R rows, then over the warp's
// lanes in step order, then over the warps in warp order. The partials go
// to scratch, written once per launch, and pair.cuh:tile_reduce_jerk sums
// them per row in slot order, so two launches of one geometry are bitwise
// equal. No float atomics anywhere.
#pragma once

#include "sym_rows.cuh"

namespace ocn {
namespace rbj {

using rb::kCols;
using rb::kThreads;
using rb::kWarps;
using rb::load3;
using rb::load4;

// Pair-symmetric f32 accel + jerk pair (pair.cuh:sym_jerk_pair, the same
// function) spelled for the issue rate as sym_rows.cuh:sym_pair_rb is:
// u and rv as FMA chains, B = dv - 3 rv inv^2 d and the sums as FMAs, and
// inv_r_ftz (no denormal rescale). With w = G m_j inv^3 and wi = G m_i
// inv^3 the row takes (w d, w B) into (a, j) and the column the reaction
// -wi (d, B) into (ca.xyz, ca.w, cj.xy). 33 FP32 instructions and one
// MUFU (53 flops, an FMA counting 2).
template <bool GUARDED>
__device__ __forceinline__ void sym_jerk_pair_rb(float4 s, float4 sv,
                                                 float3 xi, float3 vi,
                                                 float gmi, float eps2,
                                                 float3& a, float3& j,
                                                 float4& ca, float2& cj) {
  const float dx = s.x - xi.x, dy = s.y - xi.y, dz = s.z - xi.z;
  const float dvx = sv.x - vi.x, dvy = sv.y - vi.y, dvz = sv.z - vi.z;
  const float u = fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, eps2)));
  const float inv = inv_r_ftz<GUARDED>(u);
  const float inv2 = inv * inv;
  const float inv3 = inv * inv2;
  const float w = s.w * inv3, wi = gmi * inv3;
  const float rv = fmaf(dz, dvz, fmaf(dy, dvy, dx * dvx));
  const float uu = (3.f * rv) * inv2;
  const float bx = fmaf(-uu, dx, dvx), by = fmaf(-uu, dy, dvy),
              bz = fmaf(-uu, dz, dvz);
  a.x = fmaf(w, dx, a.x);
  a.y = fmaf(w, dy, a.y);
  a.z = fmaf(w, dz, a.z);
  j.x = fmaf(w, bx, j.x);
  j.y = fmaf(w, by, j.y);
  j.z = fmaf(w, bz, j.z);
  ca.x = fmaf(-wi, dx, ca.x);
  ca.y = fmaf(-wi, dy, ca.y);
  ca.z = fmaf(-wi, dz, ca.z);
  ca.w = fmaf(-wi, bx, ca.w);
  cj.x = fmaf(-wi, by, cj.x);
  cj.y = fmaf(-wi, bz, cj.y);
}

// The f32 tier (K13): a set is positions, velocities and masses (G m
// formed in f32, as K3 forms it); a source is two float4, (x, y, z, G m)
// and (vx, vy, vz, 0), kept as two shared planes.
struct F32 {
  struct Set {
    const float* pos;
    const float* vel;
    const float* mass;
    int n;
    float G;
  };
  struct Src {
    float4 p, v;
  };
  struct Tile {
    float4 p[kCols], v[kCols];
  };
  template <int R>
  struct Rows {
    float3 x[R], v[R];
    float gm[R];
    float3 a[R], j[R];
  };

  __device__ __forceinline__ static void load_src(Tile& sh, const Set& B,
                                                  int t, int i) {
    if (i < B.n) {
      sh.p[t] = load4(B.pos, i, B.G * B.mass[i]);
      sh.v[t] = load4(B.vel, i, 0.f);
    } else {
      sh.p[t] = sh.v[t] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ __forceinline__ static Src fetch(const Tile& sh, int c) {
    return {sh.p[c], sh.v[c]};
  }
  template <int R>
  __device__ __forceinline__ static void load_row(Rows<R>& w, int q,
                                                  const Set& A, int i) {
    const bool ok = i < A.n;
    const float3 z = make_float3(0.f, 0.f, 0.f);
    w.x[q] = ok ? load3(A.pos, i) : z;
    w.v[q] = ok ? load3(A.vel, i) : z;
    w.gm[q] = ok ? A.G * A.mass[i] : 0.f;
  }
  template <bool GUARDED, int R>
  __device__ __forceinline__ static void pairs(const Src& s, Rows<R>& w,
                                               float eps2, float4& ca,
                                               float2& cj) {
#pragma unroll
    for (int q = 0; q < R; ++q)
      sym_jerk_pair_rb<GUARDED>(s.p, s.v, w.x[q], w.v[q], w.gm[q], eps2,
                                w.a[q], w.j[q], ca, cj);
  }
};

// The extended tier (K16): a set is the (hi, lo) planes of positions and of
// velocities, split under one centring by the caller, and gm = G m
// rounded to f32; a source is four float4, (hi, G m), (lo, 0), (vhi, 0),
// (vlo, 0), kept as four shared planes.
struct Ext {
  struct Set {
    const float* hi;
    const float* lo;
    const float* vhi;
    const float* vlo;
    const float* gm;
    int n;
  };
  struct Src {
    float4 h, l, vh, vl;
  };
  struct Tile {
    float4 h[kCols], l[kCols], vh[kCols], vl[kCols];
  };
  template <int R>
  struct Rows {
    float3 x[R], lx[R], v[R], lv[R];
    float gm[R];
    float3 a[R], j[R];
  };

  __device__ __forceinline__ static void load_src(Tile& sh, const Set& B,
                                                  int t, int i) {
    if (i < B.n) {
      sh.h[t] = load4(B.hi, i, B.gm[i]);
      sh.l[t] = load4(B.lo, i, 0.f);
      sh.vh[t] = load4(B.vhi, i, 0.f);
      sh.vl[t] = load4(B.vlo, i, 0.f);
    } else {
      sh.h[t] = sh.l[t] = sh.vh[t] = sh.vl[t] =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ __forceinline__ static Src fetch(const Tile& sh, int c) {
    return {sh.h[c], sh.l[c], sh.vh[c], sh.vl[c]};
  }
  template <int R>
  __device__ __forceinline__ static void load_row(Rows<R>& w, int q,
                                                  const Set& A, int i) {
    const bool ok = i < A.n;
    const float3 z = make_float3(0.f, 0.f, 0.f);
    w.x[q] = ok ? load3(A.hi, i) : z;
    w.lx[q] = ok ? load3(A.lo, i) : z;
    w.v[q] = ok ? load3(A.vhi, i) : z;
    w.lv[q] = ok ? load3(A.vlo, i) : z;
    w.gm[q] = ok ? A.gm[i] : 0.f;
  }
  template <bool GUARDED, int R>
  __device__ __forceinline__ static void pairs(const Src& s, Rows<R>& w,
                                               float eps2, float4& ca,
                                               float2& cj) {
#pragma unroll
    for (int q = 0; q < R; ++q)
      sym_jerk_pair_x<GUARDED, true>(s.h, s.l, s.vh, s.vl, w.x[q], w.lx[q],
                                     w.v[q], w.lv[q], w.gm[q], eps2, w.a[q],
                                     w.j[q], ca, cj);
  }
};

// The block's shared memory: a sub-tile of sources and each warp's reaction
// slots.
template <class Tier>
struct Shared {
  typename Tier::Tile src;
  float4 col4[kWarps][kCols];
  float2 col2[kWarps][kCols];
};

// Thread t's rows row0 + q * kThreads + t, q < R; a row at or past n is a
// massless particle at the origin at rest (its action is not stored, and it
// adds nothing to any reaction).
template <class Tier, int R>
__device__ __forceinline__ void load_rows(typename Tier::template Rows<R>& w,
                                          const typename Tier::Set& A,
                                          int row0) {
  const float3 z = make_float3(0.f, 0.f, 0.f);
#pragma unroll
  for (int q = 0; q < R; ++q) {
    Tier::load_row(w, q, A, row0 + q * kThreads + threadIdx.x);
    w.a[q] = w.j[q] = z;
  }
}

// The row partials of the live rows, (a, j.x) to d4[q * kThreads + t] and
// (j.y, j.z) to d2[...].
template <class Rows, int R>
__device__ __forceinline__ void store_rows(const Rows& w,
                                           float4* __restrict__ d4,
                                           float2* __restrict__ d2, int row0,
                                           int n) {
  const int t = threadIdx.x;
#pragma unroll
  for (int q = 0; q < R; ++q)
    if (row0 + q * kThreads + t < n) {
      d4[q * kThreads + t] =
          make_float4(w.a[q].x, w.a[q].y, w.a[q].z, w.j[q].x);
      d2[q * kThreads + t] = make_float2(w.j[q].y, w.j[q].z);
    }
}

// The pair-symmetric sweep of one sub-tile: the action of its ncol live
// sources on the thread's rows, and their reaction into the warp's slots,
// one read-modify-write a column for R pairs. FULL (ncol == kCols) drops
// the column mask from the loop.
template <class Tier, int R, bool GUARDED, bool FULL>
__device__ __forceinline__ void sweep_pairs(
    typename Tier::template Rows<R>& w, const typename Tier::Tile& src,
    float4* mine4, float2* mine2, int ncol, float eps2) {
  const int t = threadIdx.x;
#pragma unroll 2
  for (int k = 0; k < kCols; ++k) {
    const int c = (t + k) & (kCols - 1);
    if (FULL || c < ncol) {
      const typename Tier::Src s = Tier::fetch(src, c);
      float4 ca = mine4[c];
      float2 cj = mine2[c];
      Tier::template pairs<GUARDED, R>(s, w, eps2, ca, cj);
      mine4[c] = ca;
      mine2[c] = cj;
    }
    __syncwarp();
  }
}

// The block's rows against columns [c0, c0 + width) of B, sub-tile by
// sub-tile; the reaction on column c0 + u, summed over the block's warps in
// warp order, goes to (react4[u], react2[u]) for every live column.
template <class Tier, int R, bool GUARDED>
__device__ __forceinline__ void sweep_block(
    typename Tier::template Rows<R>& w, Shared<Tier>& sh,
    const typename Tier::Set& B, int c0, int width, float eps2,
    float4* __restrict__ react4, float2* __restrict__ react2) {
  const int t = threadIdx.x;
  for (int u0 = 0; u0 < width && c0 + u0 < B.n; u0 += kCols) {
    __syncthreads();  // the last sub-tile's readers are done
    Tier::load_src(sh.src, B, t, c0 + u0 + t);
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      sh.col4[v][t] = make_float4(0.f, 0.f, 0.f, 0.f);
      sh.col2[v][t] = make_float2(0.f, 0.f);
    }
    __syncthreads();
    const int ncol = min(kCols, B.n - (c0 + u0));
    if (ncol == kCols)
      sweep_pairs<Tier, R, GUARDED, true>(w, sh.src, sh.col4[t >> 5],
                                          sh.col2[t >> 5], ncol, eps2);
    else
      sweep_pairs<Tier, R, GUARDED, false>(w, sh.src, sh.col4[t >> 5],
                                           sh.col2[t >> 5], ncol, eps2);
    __syncthreads();
    if (t < ncol) {
      float4 s4 = sh.col4[0][t];
      float2 s2 = sh.col2[0][t];
#pragma unroll
      for (int v = 1; v < kWarps; ++v) {
        s4.x += sh.col4[v][t].x;
        s4.y += sh.col4[v][t].y;
        s4.z += sh.col4[v][t].z;
        s4.w += sh.col4[v][t].w;
        s2.x += sh.col2[v][t].x;
        s2.y += sh.col2[v][t].y;
      }
      react4[u0 + t] = s4;
      react2[u0 + t] = s2;
    }
  }
}

// Floats of scratch in geometry geom (0: rb::cross_geometry(nA, nB)): ntA
// x ntB x (TA + TB) slots of six; -1 for a geometry not compiled.
inline long long scratch_floats(int nA, int nB, int geom) {
  const int g = geom == 0 ? rb::cross_geometry(nA, nB) : geom;
  if (!rb::geom_ok(g)) return -1;
  const int R = g / 16, S = g % 16;
  int ntA, ntB;
  rb::cross_tiles_of(nA, nB, R, S, ntA, ntB);
  const long long ta = R * kThreads;
  return 6LL * ntA * ntB * (ta + ta / S);
}

// One block per tile pair (I, J), I < ntA, J < ntB: A-tile I against B's
// columns [J TB, (J + 1) TB). The block's row partials go to slot (I, J)
// of A's planes, its columns' reaction partials to slot (J, I) of B's.
template <class Tier, int R, bool GUARDED>
__global__ void __launch_bounds__(kThreads)
    cross_jerk_tiles(typename Tier::Set A, int ntA, typename Tier::Set B,
                     int ntB, int S, float eps2, float4* __restrict__ sc4A,
                     float2* __restrict__ sc2A, float4* __restrict__ sc4B,
                     float2* __restrict__ sc2B) {
  __shared__ Shared<Tier> sh;
  constexpr int TA = R * kThreads;
  const int tb = TA / S;
  const int I = static_cast<int>(blockIdx.x / ntB);
  const int J = static_cast<int>(blockIdx.x % ntB);
  typename Tier::template Rows<R> w;
  load_rows<Tier, R>(w, A, I * TA);
  const size_t bslot = (static_cast<size_t>(J) * ntA + I) * tb;
  sweep_block<Tier, R, GUARDED>(w, sh, B, J * tb, tb, eps2, sc4B + bslot,
                                sc2B + bslot);
  const size_t aslot = (static_cast<size_t>(I) * ntB + J) * TA;
  store_rows<typename Tier::template Rows<R>, R>(w, sc4A + aslot,
                                                 sc2A + aslot, I * TA, A.n);
}

// The two passes in geometry (R, S). Scratch layout: A's float4 plane
// (ntA ntB TA), B's float4 plane (ntA ntB TB), A's float2 plane, B's
// float2 plane. Every slot a reduce reads is written once per call, so the
// scratch needs no clearing.
template <class Tier, int R, bool GUARDED>
void launch(const typename Tier::Set& A, const typename Tier::Set& B, int S,
            float eps2, float* scratch, float* accA, float* jerkA,
            float* accB, float* jerkB, cudaStream_t stream) {
  constexpr int TA = R * kThreads;
  const int tb = TA / S;
  int ntA, ntB;
  rb::cross_tiles_of(A.n, B.n, R, S, ntA, ntB);
  const size_t slotsA = static_cast<size_t>(ntA) * ntB * TA;
  const size_t slotsB = static_cast<size_t>(ntA) * ntB * tb;
  float4* sc4A = reinterpret_cast<float4*>(scratch);
  float4* sc4B = sc4A + slotsA;
  float2* sc2A = reinterpret_cast<float2*>(sc4B + slotsB);
  float2* sc2B = sc2A + slotsA;
  const long long blocks = static_cast<long long>(ntA) * ntB;
  cross_jerk_tiles<Tier, R, GUARDED>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          A, ntA, B, ntB, S, eps2, sc4A, sc2A, sc4B, sc2B);
  constexpr int kR = kReduceThreads;
  tile_reduce_jerk<float2><<<(A.n + kR - 1) / kR, kR, 0, stream>>>(
      sc4A, sc2A, A.n, TA, ntB, accA, jerkA);
  tile_reduce_jerk<float2><<<(B.n + kR - 1) / kR, kR, 0, stream>>>(
      sc4B, sc2B, B.n, tb, ntA, accB, jerkB);
}

template <class Tier, int R>
void launch_r(const typename Tier::Set& A, const typename Tier::Set& B,
              int S, float eps2, int guarded, float* scratch, float* accA,
              float* jerkA, float* accB, float* jerkB, cudaStream_t s) {
  if (guarded)
    launch<Tier, R, true>(A, B, S, eps2, scratch, accA, jerkA, accB, jerkB,
                          s);
  else
    launch<Tier, R, false>(A, B, S, eps2, scratch, accA, jerkA, accB, jerkB,
                           s);
}

// A launch in geometry geom (0: rb::cross_geometry(A.n, B.n)); empty sets
// give zeros. Returns cudaGetLastError() after the launches,
// cudaErrorInvalidValue for a geometry not compiled.
template <class Tier>
int cross_jerk(const typename Tier::Set& A, const typename Tier::Set& B,
               float eps2, int guarded, int geom, void* scratch, float* accA,
               float* jerkA, float* accB, float* jerkB, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (A.n <= 0 || B.n <= 0) {
    if (A.n > 0) {
      cudaMemsetAsync(accA, 0, sizeof(float) * 3 * A.n, s);
      cudaMemsetAsync(jerkA, 0, sizeof(float) * 3 * A.n, s);
    }
    if (B.n > 0) {
      cudaMemsetAsync(accB, 0, sizeof(float) * 3 * B.n, s);
      cudaMemsetAsync(jerkB, 0, sizeof(float) * 3 * B.n, s);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int g = geom == 0 ? rb::cross_geometry(A.n, B.n) : geom;
  if (!rb::geom_ok(g)) return static_cast<int>(cudaErrorInvalidValue);
  const int R = g / 16, S = g % 16;
  float* sc = static_cast<float*>(scratch);
  switch (R) {
    case 1: launch_r<Tier, 1>(A, B, S, eps2, guarded, sc, accA, jerkA, accB,
                              jerkB, s);
      break;
    case 2: launch_r<Tier, 2>(A, B, S, eps2, guarded, sc, accA, jerkA, accB,
                              jerkB, s);
      break;
    case 4: launch_r<Tier, 4>(A, B, S, eps2, guarded, sc, accA, jerkA, accB,
                              jerkB, s);
      break;
    default:
      launch_r<Tier, 8>(A, B, S, eps2, guarded, sc, accA, jerkA, accB, jerkB,
                        s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rbj
}  // namespace ocn
