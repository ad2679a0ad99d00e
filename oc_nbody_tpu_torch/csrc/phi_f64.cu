// K23: the float64 pair potential of the diagnostics row under
// output.diag_f64 (diagnostics.pair_and_external_phi):
//   phi_i = -G sum_{j != i} m_j (r_ij^2 + eps^2)^-1/2
// every pair in f64, on the operands ops/gravity.py:potential prepares
// (positions centred in f64, G m in f64).
//
// Replaces no TPU kernel: the JAX package's f64 row is its plain jnp oracle
// (oc_nbody_tpu/diagnostics.py:pair_and_external_phi), which the TPU
// emulates in software. The port ran the same sum as eager PyTorch in
// chunks of 512 rows (ops/gravity.py:potential, 256 chunks at 131,072
// stars, six or more (512, N) f64 temporaries of 537 MB each): 1.17 s of
// c5's 3.4 s segment on card 0, bound by memory traffic and launches, while
// the other cards of the mesh waited. This card computes f64 natively, so
// the sum is one kernel here; the eager loop stays as the plain twin
// (ops/cuda_phi64.py:potential_plain).
//
// Bound on the card: the FP64 pipe, 64 lanes an SM (132 SMs at 1.98 GHz:
// 16.7e12 FP64 instructions a second, 33.5e12 flops with an FMA counted
// twice). A pair is three DADD (the differences), three DFMA (u, eps^2
// folded into the first), rsqrt(double) (MUFU.RSQ64H, which runs on the
// special-function unit, then two DMUL and three DFMA of refinement) and
// one DFMA into the sum: 12 FP64 instructions a pair in the compiled loop
// (cuobjdump -sass), beside ~7 integer, move and branch instructions on
// other pipes. 131,072^2 pairs are then 12.3 ms, 1,048,576^2 788 ms; the
// kernel takes 16.9 ms and 1.03 s on an H100 at 700 W, 73% and 76% of that.
// Memory is no bound: a block reads its source tiles once.
//
// Design, for the issue slots of the FP64 pipe:
//  * kR = 4 rows a thread in registers, as K2 does (csrc/sym_rows.cuh); an
//    f64 value takes two registers, so the rows hold 32 of the thread's 56.
//    Each source read from shared memory serves four pairs. (On an H100 at
//    131,072 stars: 17.27 ms at 2 rows a thread, 17.10 at 4, 18.13 at 8.)
//  * Sources staged 128 at a time in shared memory as two double2 (x, y)
//    and (z, G m), read by all threads at once (broadcasts). The last tile
//    is padded with G m = 0, which adds exactly +0 (u stays finite, or the
//    guard gives 0), so the inner loop has no bound check.
//  * The sources are cut into splits of whole tiles, their size a function
//    of N alone (split_size): grid (row blocks, splits). At 131,072 stars
//    that is 256 row blocks by 32 splits, 8,192 blocks on 132 SMs, where
//    one split a row block would leave the card half empty. Pass 1 writes
//    each row's sum over its split to scratch; pass 2 adds a row's split
//    sums in split order, negates, and adds the softened self term.
//  * The guard u >= DBL_MIN ? rsqrt(u) : 0 (ops/gravity.py:_inv_r,
//    csrc/pair.cuh:inv_r in f32) is compiled in only at eps = 0; with eps >
//    0, u >= eps^2 is normal and the compare would cost a slot a pair.
//
// The self term is removed as the plain function removes it: the sum runs
// over every source, the row's own included (u = eps^2: G m_i / eps; 0
// under the guard at eps = 0), and pass 2 adds (G m_i) * (1 / eps) back,
// with the plain function's two roundings (gravity.self_phi).
//
// Determinism: no atomics and no host syncs; a row's sum runs over its
// split's sources in index order, the splits are added in order, and the
// split boundaries depend on N alone (not on the card or the launch), so
// two launches give the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;      // threads a block
constexpr int kR = 4;              // rows a thread
constexpr int kTile = 128;         // sources staged a step
constexpr int kMinSplit = 4096;    // sources a split at N <= 32 * 4,096
constexpr int kMaxSplits = 32;
constexpr double kMinNormal = 2.2250738585072014e-308;  // DBL_MIN

// Sources a split: kMinSplit, doubled until kMaxSplits splits cover n.
inline int split_size(int n) {
  int c = kMinSplit;
  while (static_cast<long long>(c) * kMaxSplits < n) c *= 2;
  return c;
}

inline int num_splits(int n) {
  const int c = split_size(n);
  return (n + c - 1) / c;
}

template <bool GUARDED>
__device__ __forceinline__ double inv_r(double u) {
  if (GUARDED) return u >= kMinNormal ? rsqrt(u) : 0.0;
  return rsqrt(u);
}

// Pass 1: rows [blockIdx.x * kR * kThreads, ...) against the sources of
// split blockIdx.y; src is (n, 4) as double2 pairs (x, y), (z, G m).
template <bool GUARDED>
__global__ void __launch_bounds__(kThreads)
    phi_f64_partial(const double2* __restrict__ src, int n, int split,
                    double eps2, double* __restrict__ part) {
  __shared__ double2 tile[2 * kTile];
  const int row0 = blockIdx.x * (kR * kThreads) + threadIdx.x;
  double x[kR], y[kR], z[kR], acc[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = min(row0 + r * kThreads, n - 1);
    const double2 a = src[2 * static_cast<long long>(i)];
    x[r] = a.x;
    y[r] = a.y;
    z[r] = src[2 * static_cast<long long>(i) + 1].x;
    acc[r] = 0.0;
  }
  const int j_begin = blockIdx.y * split;
  const int j_end = min(j_begin + split, n);
  for (int j0 = j_begin; j0 < j_end; j0 += kTile) {
#pragma unroll
    for (int e = threadIdx.x; e < 2 * kTile; e += kThreads) {
      const int j = j0 + e / 2;
      tile[e] = j < j_end ? src[2 * static_cast<long long>(j0) + e]
                          : make_double2(0.0, 0.0);
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < kTile; ++t) {
      const double2 a = tile[2 * t];
      const double2 b = tile[2 * t + 1];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const double dx = a.x - x[r];
        const double dy = a.y - y[r];
        const double dz = b.x - z[r];
        const double u = fma(dz, dz, fma(dy, dy, fma(dx, dx, eps2)));
        acc[r] = fma(b.y, inv_r<GUARDED>(u), acc[r]);
      }
    }
    __syncthreads();
  }
  const long long base = static_cast<long long>(blockIdx.y) * n;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = row0 + r * kThreads;
    if (i < n) part[base + i] = acc[r];
  }
}

// Pass 2: phi_i = -(the split sums of row i, in split order) + G m_i / eps.
__global__ void phi_f64_reduce(const double* __restrict__ part, int n,
                               int splits, const double2* __restrict__ src,
                               double inv_eps, double* __restrict__ phi) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  double s = 0.0;
  for (int c = 0; c < splits; ++c)
    s = __dadd_rn(s, part[static_cast<long long>(c) * n + i]);
  const double gm = src[2 * static_cast<long long>(i) + 1].y;
  phi[i] = __dadd_rn(-s, __dmul_rn(gm, inv_eps));
}

}  // namespace

// Doubles of scratch a launch on n stars needs: one per star and split.
extern "C" long long ocn_phi_f64_scratch(int n) {
  return n > 0 ? static_cast<long long>(num_splits(n)) * n : 0;
}

// src (n, 4: x, y, z, G m) and phi (n,) are contiguous f64 on the device,
// the positions centred; part holds ocn_phi_f64_scratch(n) doubles. eps2 =
// eps^2 and inv_eps = 1 / eps (0 at eps = 0), each rounded to f64 as
// gravity.potential rounds them; guarded compiles in the zero guard.
// Returns cudaGetLastError() after the launches.
extern "C" int ocn_phi_f64(const double* src, int n, double eps2,
                           double inv_eps, int guarded, double* part,
                           double* phi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const double2* src2 = reinterpret_cast<const double2*>(src);
  const dim3 grid((n + kR * kThreads - 1) / (kR * kThreads), num_splits(n));
  if (guarded)
    phi_f64_partial<true><<<grid, kThreads, 0, s>>>(src2, n, split_size(n),
                                                    eps2, part);
  else
    phi_f64_partial<false><<<grid, kThreads, 0, s>>>(src2, n, split_size(n),
                                                     eps2, part);
  constexpr int kReduceThreads = 256;
  phi_f64_reduce<<<(n + kReduceThreads - 1) / kReduceThreads, kReduceThreads,
                   0, s>>>(part, n, num_splits(n), src2, inv_eps, phi);
  return static_cast<int>(cudaGetLastError());
}
