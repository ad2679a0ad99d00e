// Register-blocked rows: the tile sweep of the pair-symmetric kernels K2
// (sym_accel.cu) and K12 (cross_accel.cu).
//
// A block of kThreads threads owns a row tile of R * kThreads rows, R rows a
// thread, held in registers (position, G m and the action sums). It sweeps
// a range of columns in shared sub-tiles of kCols sources. In the
// pair-symmetric sweep each step loads one column, computes R pairs (the
// thread's R rows against it), sums that column's reaction over the R rows
// in a register and does one read-modify-write of the warp's reaction slot.
// Three 16-byte shared-memory accesses (source, slot read, slot write) thus
// serve R pairs: 48 / R bytes a pair, where one row a thread (the first
// design of K2 and K12) spent 48. At 128 bytes a clock per SM that is
// 2.7 pairs a clock at R = 1; from R = 4 on the issue rate bounds the
// sweep instead, so the pair itself is spelled in the fewest instructions
// (sym_pair_rb: 16 FP32 instructions and one MUFU; spelled as the other
// kernels' pairs are, rsqrtf and all, it compiled to 21 and the MUFU).
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

// The tiling of a cross launch (two disjoint sets, K12, K13, K16) in
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

template <int R>
struct Rows {
  float x[R], y[R], z[R], gm[R];
  float ax[R], ay[R], az[R], ph[R];
};

// Thread t's rows row0 + q * kThreads + t, q < R; a row at or past n is a
// massless particle at the origin (its action is not stored, and it adds
// nothing to any reaction).
template <int R>
__device__ __forceinline__ void load_rows(Rows<R>& w,
                                          const float* __restrict__ pos,
                                          const float* __restrict__ mass,
                                          int row0, int n, float G) {
  const int t = threadIdx.x;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = row0 + q * kThreads + t;
    const bool ok = i < n;
    w.x[q] = ok ? pos[3 * i] : 0.f;
    w.y[q] = ok ? pos[3 * i + 1] : 0.f;
    w.z[q] = ok ? pos[3 * i + 2] : 0.f;
    w.gm[q] = ok ? G * mass[i] : 0.f;
    w.ax[q] = w.ay[q] = w.az[q] = w.ph[q] = 0.f;
  }
}

// The row partials (a, -phi) of the live rows to dst[q * kThreads + t].
template <int R>
__device__ __forceinline__ void store_rows(const Rows<R>& w,
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
template <int R, bool WITH_PHI, bool GUARDED, bool FULL>
__device__ __forceinline__ void sweep_pairs(Rows<R>& w,
                                            const float4* src, float4* mine,
                                            int ncol, float eps2) {
  const int t = threadIdx.x;
#pragma unroll 2
  for (int k = 0; k < kCols; ++k) {
    const int c = (t + k) & (kCols - 1);
    if (FULL || c < ncol) {
      const float4 s = src[c];
      float4 a = mine[c];
#pragma unroll
      for (int q = 0; q < R; ++q)
        sym_pair_rb<WITH_PHI, GUARDED>(s, w.x[q], w.y[q], w.z[q], w.gm[q],
                                       eps2, w.ax[q], w.ay[q], w.az[q],
                                       w.ph[q], a);
      mine[c] = a;
    }
    __syncwarp();
  }
}

// The one-sided sweep of one sub-tile (a diagonal tile of K2, every pair in
// both directions): all lanes read the same source, a broadcast.
template <int R, bool WITH_PHI, bool GUARDED>
__device__ __forceinline__ void sweep_rows(Rows<R>& w,
                                           const float4* __restrict__ src,
                                           int ncol, float eps2) {
  for (int k = 0; k < ncol; ++k) {
    const float4 s = src[k];
#pragma unroll
    for (int q = 0; q < R; ++q)
      row_pair_rb<WITH_PHI, GUARDED>(s, w.x[q], w.y[q], w.z[q], eps2,
                                     w.ax[q], w.ay[q], w.az[q], w.ph[q]);
  }
}

// The block's shared memory: a sub-tile of sources and each warp's
// reaction slots.
struct Shared {
  float4 src[kCols];
  float4 col[kWarps][kCols];
};

// The block's rows against columns [c0, c0 + width) of (pos, mass) (n
// live), sub-tile by sub-tile. SYM: pair-symmetric, and the reaction on
// column c0 + u, summed over the block's warps in warp order, goes to
// react[u] for every live column; else one-sided (react unused).
template <int R, bool WITH_PHI, bool GUARDED, bool SYM>
__device__ __forceinline__ void sweep_block(Rows<R>& w, Shared& sh,
                                            const float* __restrict__ pos,
                                            const float* __restrict__ mass,
                                            int n, int c0, int width,
                                            float G, float eps2,
                                            float4* __restrict__ react) {
  float4* src = sh.src;
  float4(*col)[kCols] = sh.col;
  const int t = threadIdx.x;
  for (int u0 = 0; u0 < width && c0 + u0 < n; u0 += kCols) {
    const int j = c0 + u0 + t;
    __syncthreads();  // the last sub-tile's readers are done
    src[t] = j < n ? make_float4(pos[3 * j], pos[3 * j + 1], pos[3 * j + 2],
                                 G * mass[j])
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    if (SYM) {
#pragma unroll
      for (int v = 0; v < kWarps; ++v)
        col[v][t] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    const int ncol = min(kCols, n - (c0 + u0));
    if (SYM) {
      if (ncol == kCols)
        sweep_pairs<R, WITH_PHI, GUARDED, true>(w, src, col[t >> 5], ncol,
                                                eps2);
      else
        sweep_pairs<R, WITH_PHI, GUARDED, false>(w, src, col[t >> 5], ncol,
                                                 eps2);
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
      sweep_rows<R, WITH_PHI, GUARDED>(w, src, ncol, eps2);
    }
  }
}

// Second pass: row i of n, in tile X = i / tile at r = i % tile, sums its
// np = X + (nt - X) * S partials sc[X][P][r], P = 0 .. np - 1, in that
// order, from a scratch of nt * S slots a tile; one thread a row. K2's tile
// X holds X reaction partials (from the row tiles before it), then S row
// partials for each tile from X on; K12's (S = 1) holds nt partials.
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

}  // namespace rb
}  // namespace ocn
