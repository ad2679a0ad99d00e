// K3: pair-symmetric softened accel + jerk of N particles (the Hermite
// force evaluation). Each unordered pair {i, j} is computed once: with
// w = G m_j inv^3, rv = d.dv and B = dv - 3 rv inv^2 d, row i gets (w d,
// w B) and row j the reaction -G m_i inv^3 (d, B).
//
// Replaces the TPU triangle sweep _make_sym_kernel with _pair_jerk (_OP_J)
// (oc_nbody_tpu/ops/pallas_pair.py:256 and :137, launched by _sym_call via
// accel_jerk_sym, oc_nbody_tpu/ops/pallas_gravity.py:1766).
//
// Bound on the card: 53 f32 flops (an FMA counts 2) and one rsqrtf per
// pair (the Pallas cost estimate counts 60), plus six shared-memory
// accesses per pair (two 16-byte source reads, a 16- and an 8-byte reaction
// read and write). Device memory is touched only by the partials below, so
// the kernel is bound by the FMA pipe and shared-memory bandwidth together.
//
// The design is K2's (csrc/sym_accel.cu) with six sums in place of three:
//
//  * sym_jerk_tiles: one block of T threads per tile pair (I, J), I <= J.
//    Thread r owns row I*T + r (position, velocity, accel and jerk in
//    registers). Off the diagonal it sweeps tile J on a rotating diagonal,
//    column (r + k) mod T at step k, so the 32 lanes of a warp touch 32
//    distinct columns in a step; each warp keeps its own reaction
//    accumulators in shared memory (a float4 plane: a.x, a.y, a.z, j.x;
//    a float2 plane: j.y, j.z) and __syncwarp orders the steps. A diagonal
//    tile (I == J) adds to rows only, every pair in both directions, as on
//    the TPU; the self pair adds nothing. The block writes its row partial
//    to scratch[I][J] and, off the diagonal, the sum of its warps' reaction
//    partials, taken in warp order, to scratch[J][I].
//  * ocn::tile_reduce_jerk (pair.cuh): row r of tile X sums scratch[X][P][r]
//    for P = 0 .. nt-1 in that order.
//
// No float atomics anywhere, so the result is bitwise the same from launch
// to launch. Scratch is nt x nt x T slots of six floats (a float4 plane
// followed by a float2 plane), i.e. 24 N nt bytes: 50 MB at N = 16,384 and
// 0.8 GB at 65,536 with T = 128. Every slot a row of the output reads is
// written exactly once per call, so scratch needs no clearing. N need not
// be a multiple of T: pairs whose row or column lies past N are masked, and
// nothing is padded.

#include "pair.cuh"

namespace {

constexpr int T = ocn::kSymTile;
constexpr int kWarps = T / 32;
static_assert((T & (T - 1)) == 0, "the rotating diagonal needs T = 2^k");

template <bool GUARDED>
__global__ void __launch_bounds__(T)
    sym_jerk_tiles(const float* __restrict__ pos,
                   const float* __restrict__ vel,
                   const float* __restrict__ mass, int n, int nt, float G,
                   float eps2, float4* __restrict__ sc4,
                   float2* __restrict__ sc2) {
  __shared__ float4 src[T];
  __shared__ float4 svel[T];
  __shared__ float4 col4[kWarps][T];
  __shared__ float2 col2[kWarps][T];
  int I, J;
  ocn::tile_pair(blockIdx.x, nt, I, J);
  const int r = threadIdx.x;
  const int i = I * T + r;
  const bool row_ok = i < n;
  float3 xi = make_float3(0.f, 0.f, 0.f), vi = make_float3(0.f, 0.f, 0.f);
  float gmi = 0.f;
  if (row_ok) {
    xi = make_float3(pos[3 * i], pos[3 * i + 1], pos[3 * i + 2]);
    vi = make_float3(vel[3 * i], vel[3 * i + 1], vel[3 * i + 2]);
    gmi = G * mass[i];
  }
  const int jj = J * T + r;
  if (jj < n) {
    src[r] = make_float4(pos[3 * jj], pos[3 * jj + 1], pos[3 * jj + 2],
                         G * mass[jj]);
    svel[r] = make_float4(vel[3 * jj], vel[3 * jj + 1], vel[3 * jj + 2], 0.f);
  } else {
    src[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    svel[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    col4[w][r] = make_float4(0.f, 0.f, 0.f, 0.f);
    col2[w][r] = make_float2(0.f, 0.f);
  }
  __syncthreads();

  const int ncol = min(T, n - J * T);  // live columns of tile J
  float3 a = make_float3(0.f, 0.f, 0.f), jk = make_float3(0.f, 0.f, 0.f);
  if (I == J) {
    if (row_ok)
      for (int k = 0; k < ncol; ++k)
        ocn::row_jerk_pair<GUARDED>(src[k], svel[k], xi, vi, eps2, a, jk);
  } else {
    // tile I < J <= nt-1 is never the ragged last tile: every row is live
    float4* mine4 = col4[r >> 5];
    float2* mine2 = col2[r >> 5];
#pragma unroll 4
    for (int k = 0; k < T; ++k) {
      const int c = (r + k) & (T - 1);
      if (c < ncol) {
        float4 ca = mine4[c];
        float2 cj = mine2[c];
        ocn::sym_jerk_pair<GUARDED>(src[c], svel[c], xi, vi, gmi, eps2, a, jk,
                                    ca, cj);
        mine4[c] = ca;
        mine2[c] = cj;
      }
      __syncwarp();
    }
  }
  if (row_ok) {
    const size_t slot = (static_cast<size_t>(I) * nt + J) * T + r;
    sc4[slot] = make_float4(a.x, a.y, a.z, jk.x);
    sc2[slot] = make_float2(jk.y, jk.z);
  }
  __syncthreads();
  if (I != J && r < ncol) {
    float4 s4 = col4[0][r];
    float2 s2 = col2[0][r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      s4.x += col4[w][r].x;
      s4.y += col4[w][r].y;
      s4.z += col4[w][r].z;
      s4.w += col4[w][r].w;
      s2.x += col2[w][r].x;
      s2.y += col2[w][r].y;
    }
    const size_t slot = (static_cast<size_t>(J) * nt + I) * T + r;
    sc4[slot] = s4;
    sc2[slot] = s2;
  }
}

template <bool GUARDED>
void launch(const float* pos, const float* vel, const float* mass, int n,
            float G, float eps2, float4* sc4, float2* sc2, float* acc,
            float* jerk, cudaStream_t stream) {
  const int nt = (n + T - 1) / T;
  const long long pairs = static_cast<long long>(nt) * (nt + 1) / 2;
  sym_jerk_tiles<GUARDED><<<static_cast<unsigned>(pairs), T, 0, stream>>>(
      pos, vel, mass, n, nt, G, eps2, sc4, sc2);
  constexpr int kR = ocn::kReduceThreads;
  ocn::tile_reduce_jerk<float2><<<(n + kR - 1) / kR, kR, 0, stream>>>(
      sc4, sc2, n, T, nt, acc, jerk);
}

}  // namespace

// pos, vel (n, 3), mass (n,), acc and jerk (n, 3) are contiguous f32 on the
// device. scratch holds nt * nt * T * 6 floats with nt = ceil(n / T) and T
// = ocn_sym_tile(): the float4 plane first, then the float2 plane. Returns
// cudaGetLastError() after both launches.
extern "C" int ocn_sym_jerk(const float* pos, const float* vel,
                            const float* mass, int n, float G, float eps2,
                            int guarded, void* scratch, float* acc,
                            float* jerk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    const size_t slots = static_cast<size_t>((n + T - 1) / T) *
                         ((n + T - 1) / T) * T;
    float4* sc4 = static_cast<float4*>(scratch);
    float2* sc2 = reinterpret_cast<float2*>(sc4 + slots);
    if (guarded)
      launch<true>(pos, vel, mass, n, G, eps2, sc4, sc2, acc, jerk, s);
    else
      launch<false>(pos, vel, mass, n, G, eps2, sc4, sc2, acc, jerk, s);
  }
  return static_cast<int>(cudaGetLastError());
}
