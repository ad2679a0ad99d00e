// Register-blocked rows: the tile sweep of the pair-symmetric accel kernels,
// at the f32 tier K2 (sym_accel.cu) and K12 (cross_accel.cu), and at the
// extended hi/lo tier K6 (sym_accel_x.cu) and K15 (cross_accel_x.cu).
//
// A block of kThreads threads owns a row tile of R * kThreads rows, R rows a
// thread, held in registers (position, G m and the action sums: 8 floats a
// row at f32, 11 with the hi/lo planes). It sweeps a range of columns in
// shared sub-tiles of kCols sources. In the pair-symmetric sweep each step
// loads one column, computes R pairs (the thread's R rows against it), sums
// that column's reaction over the R rows in a register and does one
// read-modify-write of the warp's reaction slot. The first designs (one row
// a thread) paid those shared accesses on every pair: 48 bytes a pair at
// f32 (source, slot read, slot write) and 64 at the extended tier (the
// source's hi and lo planes), which bound them at 128 bytes a clock per
// SM. Here it is 48 / R and 64 / R bytes a pair, so from R = 4 on the
// issue rate of the pair bounds the sweep instead. The f32 pair is spelled
// in the fewest instructions (sym_pair_rb: 16 FP32 instructions and one
// MUFU; spelled as the other kernels' pairs are, rsqrtf and all, it
// compiled to 21 and the MUFU). The extended pair is pair.cuh:sym_pair_x to
// the letter (its Newton-refined inverse and lo-corrected separation are
// what the close-pair limits rest on) but for its rsqrt seed, taken by
// inv_r_ftz: 32 FP32 instructions and one MUFU, 34 with the potential
// (counted in Ext below).
// Lanes step on a rotating diagonal, column (t + k) mod kCols at step k, so
// the 32 lanes of a warp touch 32 distinct columns and the warp-private
// slots need no atomics; __syncwarp orders the steps, once per R pairs.
//
// Every sum is taken in a fixed order: a row's action over the columns in
// sweep order, a column's reaction over its R rows, then over the warp's
// lanes in step order, then over the warps in warp order. The partials go
// to scratch, and partials_reduce sums them per row in slot order, so two
// launches of one geometry are bitwise equal. No float atomics anywhere.
#pragma once

#include "pair.cuh"

namespace ocn {
namespace rb {

constexpr int kThreads = 128;  // threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 128;     // sources a shared sub-tile
static_assert(kCols == kThreads, "one source a thread loads a sub-tile");
static_assert((kCols & (kCols - 1)) == 0,
              "the rotating diagonal needs kCols = 2^k");

// The geometries compiled: R rows a thread (R = 1, 2, 4, 8) and a split S
// <= R of the column range (S = 1, 2, 4, 8), so that a block sweeps R *
// kThreads / S columns, a whole number of sub-tiles. Encoded R * 16 + S.
__host__ __device__ constexpr int geom(int R, int S) { return R * 16 + S; }
inline bool geom_ok(int g) {
  const int R = g / 16, S = g % 16;
  return (R == 1 || R == 2 || R == 4 || R == 8) &&
         (S == 1 || S == 2 || S == 4 || S == 8) && S <= R;
}

// Enough blocks to fill the card: eight blocks of four warps on each of the
// H100's 132 SMs, rounded. A geometry with fewer leaves SMs idle or runs a
// short last wave.
constexpr long long kMinBlocks = 1024;

// The geometry of a grid whose block count is blocks(R, S): the most rows a
// thread that still gives kMinBlocks blocks, with the fewest splits (each
// split adds a row partial); the most blocks (R = S = 1) if none does.
template <typename Blocks>
inline int choose_geom(Blocks blocks) {
  for (int R = 8; R >= 1; R /= 2)
    for (int S = 1; S <= R; S *= 2)
      if (blocks(R, S) >= kMinBlocks) return geom(R, S);
  return geom(1, 1);
}

// Row tiles of TE = R * kThreads rows of a self-interaction of n (K2, K6).
inline int sym_tiles_of(int n, int R) {
  const int te = R * kThreads;
  return (n + te - 1) / te;
}

// The geometry of a self-interaction of n (K2, K6): choose_geom over its
// S nt (nt + 1) / 2 blocks, the triangle of tile pairs times the splits.
inline int sym_geometry(int n) {
  return choose_geom([n](int R, int S) {
    const long long nt = sym_tiles_of(n, R);
    return S * nt * (nt + 1) / 2;
  });
}

// The tiling of a cross launch (two disjoint sets, K12, K13, K15, K16) in
// geometry (R, S): ntA A-tiles of TA = R * kThreads rows, ntB B-tiles of
// TA / S columns, one block per tile pair.
inline void cross_tiles_of(int nA, int nB, int R, int S, int& ntA,
                           int& ntB) {
  const int ta = R * kThreads, tb = ta / S;
  ntA = (nA + ta - 1) / ta;
  ntB = (nB + tb - 1) / tb;
}

// The geometry of an nA x nB cross launch (choose_geom over its ntA x ntB
// blocks); encoded R * 16 + S.
inline int cross_geometry(int nA, int nB) {
  return choose_geom([nA, nB](int R, int S) {
    int ntA, ntB;
    cross_tiles_of(nA, nB, R, S, ntA, ntB);
    return static_cast<long long>(ntA) * ntB;
  });
}

// Floats of scratch of a self-interaction of n in geometry geom (0:
// sym_geometry(n)): nt x nt S x TE float4, 16 N nt S bytes; -1 for a
// geometry not compiled.
inline long long sym_scratch_floats(int n, int geom) {
  const int g = geom == 0 ? sym_geometry(n) : geom;
  if (!geom_ok(g)) return -1;
  const int R = g / 16, S = g % 16;
  const long long nt = sym_tiles_of(n, R);
  return 4LL * nt * nt * S * R * kThreads;
}

// Floats of scratch of an nA x nB cross launch in geometry geom (0:
// cross_geometry(nA, nB)): ntA x ntB x (TA + TB) float4; -1 for a geometry
// not compiled.
inline long long cross_scratch_floats(int nA, int nB, int geom) {
  const int g = geom == 0 ? cross_geometry(nA, nB) : geom;
  if (!geom_ok(g)) return -1;
  const int R = g / 16, S = g % 16;
  int ntA, ntB;
  cross_tiles_of(nA, nB, R, S, ntA, ntB);
  const long long ta = R * kThreads;
  return 4LL * ntA * ntB * (ta + ta / S);
}

__device__ __forceinline__ float3 load3(const float* __restrict__ p, int i) {
  return make_float3(p[3 * i], p[3 * i + 1], p[3 * i + 2]);
}

__device__ __forceinline__ float4 load4(const float* __restrict__ p, int i,
                                        float w) {
  return make_float4(p[3 * i], p[3 * i + 1], p[3 * i + 2], w);
}

// Pair-symmetric pair: the action of source s on the row at (xi, yi, zi)
// into (ax, ay, az, ph), and the row's reaction on the source, -G m_i d
// inv^3 (and -G m_i inv for the potential), into col; ph accumulates
// +G m_j inv, the caller stores -ph. 16 FP32 instructions without the
// potential: u = eps^2 + dx^2 + dy^2 + dz^2 as three FMAs, and w = G m_j
// inv^3, wi = G m_i inv^3 through inv^3 (25 flops, an FMA counting 2; 28
// with the potential, which needs G m inv for both rows).
template <bool WITH_PHI, bool GUARDED>
__device__ __forceinline__ void sym_pair_rb(float4 s, float xi, float yi,
                                            float zi, float gmi, float eps2,
                                            float& ax, float& ay, float& az,
                                            float& ph, float4& col) {
  const float dx = s.x - xi, dy = s.y - yi, dz = s.z - zi;
  const float u = fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, eps2)));
  const float inv = inv_r_ftz<GUARDED>(u);
  const float inv2 = inv * inv;
  float w, wi;
  if (WITH_PHI) {
    const float gjinv = s.w * inv, giinv = gmi * inv;
    w = gjinv * inv2;
    wi = giinv * inv2;
    ph += gjinv;
    col.w -= giinv;
  } else {
    const float inv3 = inv * inv2;
    w = s.w * inv3;
    wi = gmi * inv3;
  }
  ax = fmaf(w, dx, ax);
  ay = fmaf(w, dy, ay);
  az = fmaf(w, dz, az);
  col.x = fmaf(-wi, dx, col.x);
  col.y = fmaf(-wi, dy, col.y);
  col.z = fmaf(-wi, dz, col.z);
}

// One-sided pair (pair.cuh:row_pair), spelled as sym_pair_rb: the action
// of source s on the row at (xi, yi, zi).
template <bool WITH_PHI, bool GUARDED>
__device__ __forceinline__ void row_pair_rb(float4 s, float xi, float yi,
                                            float zi, float eps2, float& ax,
                                            float& ay, float& az,
                                            float& ph) {
  const float dx = s.x - xi, dy = s.y - yi, dz = s.z - zi;
  const float u = fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, eps2)));
  const float inv = inv_r_ftz<GUARDED>(u);
  const float gminv = s.w * inv;
  const float w = gminv * (inv * inv);
  ax = fmaf(w, dx, ax);
  ay = fmaf(w, dy, ay);
  az = fmaf(w, dz, az);
  if (WITH_PHI) ph += gminv;
}

// The f32 tier (K2, K12): a set is positions and masses, G m formed in f32
// as the rows and sources are loaded; a source is one float4 (x, y, z, G m).
struct F32 {
  struct Set {
    const float* pos;
    const float* mass;
    int n;
    float G;
  };
  using Src = float4;
  struct Tile {
    float4 p[kCols];
  };
  template <int R>
  struct Rows {
    float x[R], y[R], z[R], gm[R];
    float ax[R], ay[R], az[R], ph[R];
  };

  __device__ __forceinline__ static void load_src(Tile& sh, const Set& P,
                                                  int t, int j) {
    sh.p[t] = j < P.n ? load4(P.pos, j, P.G * P.mass[j])
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ static Src fetch(const Tile& sh, int c) {
    return sh.p[c];
  }
  template <int R>
  __device__ __forceinline__ static void load_row(Rows<R>& w, int q,
                                                  const Set& P, int i) {
    const bool ok = i < P.n;
    w.x[q] = ok ? P.pos[3 * i] : 0.f;
    w.y[q] = ok ? P.pos[3 * i + 1] : 0.f;
    w.z[q] = ok ? P.pos[3 * i + 2] : 0.f;
    w.gm[q] = ok ? P.G * P.mass[i] : 0.f;
  }
  template <bool WITH_PHI, bool GUARDED, int R>
  __device__ __forceinline__ static void pairs(const Src& s, Rows<R>& w,
                                               float eps2, float4& col) {
#pragma unroll
    for (int q = 0; q < R; ++q)
      sym_pair_rb<WITH_PHI, GUARDED>(s, w.x[q], w.y[q], w.z[q], w.gm[q],
                                     eps2, w.ax[q], w.ay[q], w.az[q],
                                     w.ph[q], col);
  }
  template <bool WITH_PHI, bool GUARDED, int R>
  __device__ __forceinline__ static void row_pairs(const Src& s, Rows<R>& w,
                                                   float eps2) {
#pragma unroll
    for (int q = 0; q < R; ++q)
      row_pair_rb<WITH_PHI, GUARDED>(s, w.x[q], w.y[q], w.z[q], eps2,
                                     w.ax[q], w.ay[q], w.az[q], w.ph[q]);
  }
};

// The extended tier (K6, K15): a set is the (hi, lo) planes of positions,
// split under one centring by the caller, and gm = G m rounded to f32; a
// source is two float4, (hi, G m) and (lo, 0), kept as two shared planes.
// The pair is pair.cuh:sym_pair_x with its seed from inv_r_ftz (FTZ =
// true: the same bits on every u the kernel sees, a normal one or one the
// guard zeroes). Without the potential it is 32 FP32 instructions and one
// MUFU: d, e and s = d + e (9 FADD), d.d and d.e (2 FMUL, 4 FFMA), u =
// d.d + (2 d.e + eps^2) (FFMA, FADD), the Newton step (3 FMUL, FFMA), inv^2,
// G m inv and w of both rows (5 FMUL), the action and the reaction (6
// FFMA): 44 flops, an FMA counting 2. The potential adds two FADD (46).
// The diagonal's one-sided pair (row_pair_x) is 27 and the MUFU.
struct Ext {
  struct Set {
    const float* hi;
    const float* lo;
    const float* gm;
    int n;
  };
  struct Src {
    float4 h, l;
  };
  struct Tile {
    float4 h[kCols], l[kCols];
  };
  template <int R>
  struct Rows {
    float3 x[R], lx[R];
    float gm[R];
    float ax[R], ay[R], az[R], ph[R];
  };

  __device__ __forceinline__ static void load_src(Tile& sh, const Set& P,
                                                  int t, int j) {
    if (j < P.n) {
      sh.h[t] = load4(P.hi, j, P.gm[j]);
      sh.l[t] = load4(P.lo, j, 0.f);
    } else {
      sh.h[t] = sh.l[t] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ __forceinline__ static Src fetch(const Tile& sh, int c) {
    return {sh.h[c], sh.l[c]};
  }
  template <int R>
  __device__ __forceinline__ static void load_row(Rows<R>& w, int q,
                                                  const Set& P, int i) {
    const bool ok = i < P.n;
    const float3 z = make_float3(0.f, 0.f, 0.f);
    w.x[q] = ok ? load3(P.hi, i) : z;
    w.lx[q] = ok ? load3(P.lo, i) : z;
    w.gm[q] = ok ? P.gm[i] : 0.f;
  }
  template <bool WITH_PHI, bool GUARDED, int R>
  __device__ __forceinline__ static void pairs(const Src& s, Rows<R>& w,
                                               float eps2, float4& col) {
#pragma unroll
    for (int q = 0; q < R; ++q)
      sym_pair_x<WITH_PHI, GUARDED>(s.h, s.l, w.x[q], w.lx[q], w.gm[q],
                                    eps2, w.ax[q], w.ay[q], w.az[q],
                                    w.ph[q], col);
  }
  template <bool WITH_PHI, bool GUARDED, int R>
  __device__ __forceinline__ static void row_pairs(const Src& s, Rows<R>& w,
                                                   float eps2) {
#pragma unroll
    for (int q = 0; q < R; ++q)
      row_pair_x<WITH_PHI, GUARDED, true>(s.h, s.l, w.x[q], w.lx[q], eps2,
                                          w.ax[q], w.ay[q], w.az[q],
                                          w.ph[q]);
  }
};

// Thread t's rows row0 + q * kThreads + t, q < R; a row at or past n is a
// massless particle at the origin (its action is not stored, and it adds
// nothing to any reaction).
template <class Tier, int R>
__device__ __forceinline__ void load_rows(typename Tier::template Rows<R>& w,
                                          const typename Tier::Set& P,
                                          int row0) {
#pragma unroll
  for (int q = 0; q < R; ++q) {
    Tier::load_row(w, q, P, row0 + q * kThreads + threadIdx.x);
    w.ax[q] = w.ay[q] = w.az[q] = w.ph[q] = 0.f;
  }
}

// The row partials (a, -phi) of the live rows to dst[q * kThreads + t].
template <class Rows, int R>
__device__ __forceinline__ void store_rows(const Rows& w,
                                           float4* __restrict__ dst,
                                           int row0, int n) {
  const int t = threadIdx.x;
#pragma unroll
  for (int q = 0; q < R; ++q)
    if (row0 + q * kThreads + t < n)
      dst[q * kThreads + t] =
          make_float4(w.ax[q], w.ay[q], w.az[q], -w.ph[q]);
}

// The pair-symmetric sweep of one sub-tile: the action of its ncol live
// sources on the thread's rows, and their reaction into the warp's slots.
// FULL (ncol == kCols, every sub-tile but a ragged last one) drops the
// column mask from the loop.
template <class Tier, int R, bool WITH_PHI, bool GUARDED, bool FULL>
__device__ __forceinline__ void sweep_pairs(
    typename Tier::template Rows<R>& w, const typename Tier::Tile& src,
    float4* mine, int ncol, float eps2) {
  const int t = threadIdx.x;
#pragma unroll 2
  for (int k = 0; k < kCols; ++k) {
    const int c = (t + k) & (kCols - 1);
    if (FULL || c < ncol) {
      const typename Tier::Src s = Tier::fetch(src, c);
      float4 a = mine[c];
      Tier::template pairs<WITH_PHI, GUARDED, R>(s, w, eps2, a);
      mine[c] = a;
    }
    __syncwarp();
  }
}

// The one-sided sweep of one sub-tile (a diagonal tile of K2 and K6, every
// pair in both directions): all lanes read the same source, a broadcast.
template <class Tier, int R, bool WITH_PHI, bool GUARDED>
__device__ __forceinline__ void sweep_rows(
    typename Tier::template Rows<R>& w, const typename Tier::Tile& src,
    int ncol, float eps2) {
  for (int k = 0; k < ncol; ++k)
    Tier::template row_pairs<WITH_PHI, GUARDED, R>(Tier::fetch(src, k), w,
                                                   eps2);
}

// The block's shared memory: a sub-tile of sources and each warp's
// reaction slots.
template <class Tier>
struct Shared {
  typename Tier::Tile src;
  float4 col[kWarps][kCols];
};

// The block's rows against columns [c0, c0 + width) of P, sub-tile by
// sub-tile. SYM: pair-symmetric, and the reaction on column c0 + u, summed
// over the block's warps in warp order, goes to react[u] for every live
// column; else one-sided (react unused).
template <class Tier, int R, bool WITH_PHI, bool GUARDED, bool SYM>
__device__ __forceinline__ void sweep_block(
    typename Tier::template Rows<R>& w, Shared<Tier>& sh,
    const typename Tier::Set& P, int c0, int width, float eps2,
    float4* __restrict__ react) {
  float4(*col)[kCols] = sh.col;
  const int t = threadIdx.x;
  for (int u0 = 0; u0 < width && c0 + u0 < P.n; u0 += kCols) {
    __syncthreads();  // the last sub-tile's readers are done
    Tier::load_src(sh.src, P, t, c0 + u0 + t);
    if (SYM) {
#pragma unroll
      for (int v = 0; v < kWarps; ++v)
        col[v][t] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    const int ncol = min(kCols, P.n - (c0 + u0));
    if (SYM) {
      if (ncol == kCols)
        sweep_pairs<Tier, R, WITH_PHI, GUARDED, true>(w, sh.src, col[t >> 5],
                                                      ncol, eps2);
      else
        sweep_pairs<Tier, R, WITH_PHI, GUARDED, false>(
            w, sh.src, col[t >> 5], ncol, eps2);
      __syncthreads();
      if (t < ncol) {
        float4 s = col[0][t];
#pragma unroll
        for (int v = 1; v < kWarps; ++v) {
          s.x += col[v][t].x;
          s.y += col[v][t].y;
          s.z += col[v][t].z;
          s.w += col[v][t].w;
        }
        react[u0 + t] = s;
      }
    } else {
      sweep_rows<Tier, R, WITH_PHI, GUARDED>(w, sh.src, ncol, eps2);
    }
  }
}

// Second pass: row i of n, in tile X = i / tile at r = i % tile, sums its
// np = X + (nt - X) * S partials sc[X][P][r], P = 0 .. np - 1, in that
// order, from a scratch of nt * S slots a tile; one thread a row. A
// self-interaction's tile X holds X reaction partials (from the row tiles
// before it), then S row partials for each tile from X on; a cross
// launch's (S = 1, nt the other set's tile count) holds nt partials.
template <bool WITH_PHI>
__global__ void partials_reduce(const float4* __restrict__ sc, int n,
                                int tile, int nt, int S,
                                float* __restrict__ acc,
                                float* __restrict__ phi) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int X = i / tile;
  const int np = X + (nt - X) * S;
  const float4* p =
      sc + static_cast<size_t>(X) * nt * S * tile + (i - X * tile);
  float4 s = p[0];
  for (int P = 1; P < np; ++P) {
    const float4 v = p[static_cast<size_t>(P) * tile];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  acc[3 * i] = s.x;
  acc[3 * i + 1] = s.y;
  acc[3 * i + 2] = s.z;
  if (WITH_PHI) phi[i] = s.w;
}

// The self-interaction's tile pass: one block per tile pair (I, J), I <= J,
// and column part s < S (block b: tile pair b / S, part b % S). The block's
// rows are tile I and its columns the s-th of S equal parts of tile J. Off
// the diagonal the sweep is pair-symmetric; a diagonal tile adds to rows
// only, every pair in both directions (so the softened self term -G m/eps
// stays in the potential, for the caller to remove). The row partial goes
// to slot I + (J - I) S + s of tile I and, off the diagonal, the columns'
// reaction partials to slot I of tile J.
template <class Tier, int R, bool WITH_PHI, bool GUARDED>
__global__ void __launch_bounds__(kThreads)
    sym_tiles(typename Tier::Set P, int nt, int S, float eps2,
              float4* __restrict__ scratch) {
  __shared__ Shared<Tier> sh;
  constexpr int TE = R * kThreads;
  const int width = TE / S;
  const int s = static_cast<int>(blockIdx.x % S);
  int I, J;
  tile_pair(blockIdx.x / S, nt, I, J);
  const size_t slots = static_cast<size_t>(nt) * S;  // slots a tile
  typename Tier::template Rows<R> w;
  load_rows<Tier, R>(w, P, I * TE);
  const int c0 = J * TE + s * width;
  if (I == J)
    sweep_block<Tier, R, WITH_PHI, GUARDED, false>(w, sh, P, c0, width,
                                                   eps2, nullptr);
  else
    sweep_block<Tier, R, WITH_PHI, GUARDED, true>(
        w, sh, P, c0, width, eps2,
        scratch + (J * slots + I) * TE + s * width);
  store_rows<typename Tier::template Rows<R>, R>(
      w, scratch + (I * slots + I + (J - I) * S + s) * TE, I * TE, P.n);
}

// The cross tile pass: one block per tile pair (I, J), I < ntA, J < ntB:
// A-tile I against B's columns [J TB, (J + 1) TB), pair-symmetric. The
// row partials go to scA[I][J], the columns' reaction partials to
// scB[J][I].
template <class Tier, int R, bool WITH_PHI, bool GUARDED>
__global__ void __launch_bounds__(kThreads)
    cross_tiles(typename Tier::Set A, int ntA, typename Tier::Set B, int ntB,
                int S, float eps2, float4* __restrict__ scA,
                float4* __restrict__ scB) {
  __shared__ Shared<Tier> sh;
  constexpr int TA = R * kThreads;
  const int tb = TA / S;
  const int I = static_cast<int>(blockIdx.x / ntB);
  const int J = static_cast<int>(blockIdx.x % ntB);
  typename Tier::template Rows<R> w;
  load_rows<Tier, R>(w, A, I * TA);
  sweep_block<Tier, R, WITH_PHI, GUARDED, true>(
      w, sh, B, J * tb, tb, eps2,
      scB + (static_cast<size_t>(J) * ntA + I) * tb);
  store_rows<typename Tier::template Rows<R>, R>(
      w, scA + (static_cast<size_t>(I) * ntB + J) * TA, I * TA, A.n);
}

// go.template run<R, WITH_PHI, GUARDED>() for the geometry's R and the
// launch's flags.
template <int R, class Go>
void run_flags(bool with_phi, int guarded, const Go& go) {
  if (with_phi) {
    if (guarded)
      go.template run<R, true, true>();
    else
      go.template run<R, true, false>();
  } else {
    if (guarded)
      go.template run<R, false, true>();
    else
      go.template run<R, false, false>();
  }
}

template <class Go>
void run_geometry(int R, bool with_phi, int guarded, const Go& go) {
  switch (R) {
    case 1: run_flags<1>(with_phi, guarded, go); break;
    case 2: run_flags<2>(with_phi, guarded, go); break;
    case 4: run_flags<4>(with_phi, guarded, go); break;
    default: run_flags<8>(with_phi, guarded, go);
  }
}

// A self-interaction's two passes in geometry (R, S). Every slot a row of
// the output reads is written exactly once, so the scratch needs no
// clearing.
template <class Tier>
struct SymLaunch {
  typename Tier::Set P;
  int S;
  float eps2;
  float4* scratch;
  float* acc;
  float* phi;
  cudaStream_t stream;

  template <int R, bool WITH_PHI, bool GUARDED>
  void run() const {
    const int nt = sym_tiles_of(P.n, R);
    const long long blocks = static_cast<long long>(S) * nt * (nt + 1) / 2;
    sym_tiles<Tier, R, WITH_PHI, GUARDED>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            P, nt, S, eps2, scratch);
    constexpr int kR = kReduceThreads;
    partials_reduce<WITH_PHI><<<(P.n + kR - 1) / kR, kR, 0, stream>>>(
        scratch, P.n, R * kThreads, nt, S, acc, phi);
  }
};

// A cross launch's tile pass and a reduce per set in geometry (R, S).
// Scratch layout: A's plane (ntA ntB TA float4), then B's (ntA ntB TB).
template <class Tier>
struct CrossLaunch {
  typename Tier::Set A, B;
  int S;
  float eps2;
  float4* scratch;
  float *accA, *phiA, *accB, *phiB;
  cudaStream_t stream;

  template <int R, bool WITH_PHI, bool GUARDED>
  void run() const {
    constexpr int TA = R * kThreads;
    int ntA, ntB;
    cross_tiles_of(A.n, B.n, R, S, ntA, ntB);
    float4* scA = scratch;
    float4* scB = scA + static_cast<size_t>(ntA) * ntB * TA;
    const long long blocks = static_cast<long long>(ntA) * ntB;
    cross_tiles<Tier, R, WITH_PHI, GUARDED>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            A, ntA, B, ntB, S, eps2, scA, scB);
    constexpr int kR = kReduceThreads;
    partials_reduce<WITH_PHI><<<(A.n + kR - 1) / kR, kR, 0, stream>>>(
        scA, A.n, TA, ntB, 1, accA, phiA);
    partials_reduce<WITH_PHI><<<(B.n + kR - 1) / kR, kR, 0, stream>>>(
        scB, B.n, TA / S, ntA, 1, accB, phiB);
  }
};

// The self-interaction of P in geometry geom (0: sym_geometry(P.n)); phi
// null: no potential. scratch holds sym_scratch_floats(P.n, geom) floats.
// Returns cudaGetLastError() after both launches, cudaErrorInvalidValue for
// a geometry not compiled.
template <class Tier>
int sym_accel(const typename Tier::Set& P, float eps2, int guarded,
              int geom, void* scratch, float* acc, float* phi,
              void* stream) {
  const int g = geom == 0 ? sym_geometry(P.n) : geom;
  if (!geom_ok(g)) return static_cast<int>(cudaErrorInvalidValue);
  if (P.n > 0)
    run_geometry(g / 16, phi != nullptr, guarded,
                 SymLaunch<Tier>{P, g % 16, eps2,
                                 static_cast<float4*>(scratch), acc, phi,
                                 static_cast<cudaStream_t>(stream)});
  return static_cast<int>(cudaGetLastError());
}

// The cross interaction of A and B in geometry geom (0: cross_geometry(A.n,
// B.n)); phiA and phiB both null (no potential) or both given; empty sets
// give zeros. scratch holds cross_scratch_floats(A.n, B.n, geom) floats.
// Returns cudaGetLastError() after the launches, cudaErrorInvalidValue for
// a geometry not compiled.
template <class Tier>
int cross_accel(const typename Tier::Set& A, const typename Tier::Set& B,
                float eps2, int guarded, int geom, void* scratch,
                float* accA, float* phiA, float* accB, float* phiB,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (A.n <= 0 || B.n <= 0) {
    if (A.n > 0) {
      cudaMemsetAsync(accA, 0, sizeof(float) * 3 * A.n, s);
      if (phiA != nullptr) cudaMemsetAsync(phiA, 0, sizeof(float) * A.n, s);
    }
    if (B.n > 0) {
      cudaMemsetAsync(accB, 0, sizeof(float) * 3 * B.n, s);
      if (phiB != nullptr) cudaMemsetAsync(phiB, 0, sizeof(float) * B.n, s);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int g = geom == 0 ? cross_geometry(A.n, B.n) : geom;
  if (!geom_ok(g)) return static_cast<int>(cudaErrorInvalidValue);
  run_geometry(g / 16, phiA != nullptr, guarded,
               CrossLaunch<Tier>{A, B, g % 16, eps2,
                                 static_cast<float4*>(scratch), accA, phiA,
                                 accB, phiB, s});
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rb
}  // namespace ocn
