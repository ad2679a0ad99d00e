// K16: softened accel + jerk between two DISJOINT sets A (nA rows) and B
// (nB sources) at the extended (hi/lo) precision tier, each pair once: with
// w = G m_b inv^3, rv = s.dv and B = dv - 3 rv inv^2 s, A's row gets (w s,
// w B) and B's the reaction -G m_a inv^3 (s, B). No self pair exists
// between disjoint sets.
//
// Replaces the TPU cross-pair sweep _make_cross_kernel with _pair_jerk_x
// (_OP_JX) (oc_nbody_tpu/ops/pallas_pair.py:296 and :202, launched by
// _cross_call at :369), run for every unordered chunk pair of the chunked
// extended accel + jerk self-interaction past STREAM_N
// (accel_jerk_sym_x_chunked, oc_nbody_tpu/ops/pallas_gravity.py:1932) and
// by accel_jerk_cross_pair_x_hilo (:2201).
//
// Positions and velocities arrive as (hi, lo) f32 planes of the f64 state,
// each centred ONCE for the whole set and split in f64 by the caller; gm is
// (G m in f64) rounded to f32. The pair is K7's, pair.cuh:sym_jerk_pair_x.
//
// Bound on the card: 77 f32 flops (an FMA counts 2) and one rsqrtf per
// pair, plus eight shared-memory accesses per pair (four 16-byte source
// reads, a 16- and an 8-byte reaction read and write); device memory is
// touched only by the partials, so the FMA pipe and shared-memory bandwidth
// bind together, as in K7.
//
// Design: K13's plan (csrc/cross_jerk.cu) with K7's block
// (csrc/sym_jerk_x.cu): one block of T threads per tile pair (I, J) over all
// ntA x ntB pairs; thread r owns A-row I*T + r (twelve coordinates, G m,
// six sums in registers) and sweeps B-tile J, staged as four float4 per
// source, on a rotating diagonal, each warp keeping its own reaction
// accumulators in shared memory (a float4 plane a.x, a.y, a.z, j.x and a
// float2 plane j.y, j.z). The row partial goes to scA[I][J] and the warps'
// reaction partials, summed in warp order, to scB[J][I]; then
// ocn::tile_reduce_jerk once per set, partials in tile order. No float
// atomics: two launches are bitwise equal. Scratch is 2 x ntA x ntB x T
// slots of six floats (K13's layout: scA's float4 plane, scB's float4
// plane, scA's float2 plane, scB's float2 plane), 2.0 GB at nA = nB =
// 73,728 (CHUNK_SYMXJ); the caller allocates it once per evaluation.
// Ragged nA and nB are masked, not padded; scratch offsets are size_t.

#include "pair.cuh"

namespace {

constexpr int T = ocn::kSymTile;
constexpr int kWarps = T / 32;
static_assert((T & (T - 1)) == 0, "the rotating diagonal needs T = 2^k");

__device__ __forceinline__ float3 load3(const float* __restrict__ p, int i) {
  return make_float3(p[3 * i], p[3 * i + 1], p[3 * i + 2]);
}

__device__ __forceinline__ float4 load4(const float* __restrict__ p, int i,
                                        float w) {
  return make_float4(p[3 * i], p[3 * i + 1], p[3 * i + 2], w);
}

template <bool GUARDED>
__global__ void __launch_bounds__(T)
    cross_jerk_tiles_x(const float* __restrict__ hiA,
                       const float* __restrict__ loA,
                       const float* __restrict__ vhiA,
                       const float* __restrict__ vloA,
                       const float* __restrict__ gmA, int nA, int ntA,
                       const float* __restrict__ hiB,
                       const float* __restrict__ loB,
                       const float* __restrict__ vhiB,
                       const float* __restrict__ vloB,
                       const float* __restrict__ gmB, int nB, int ntB,
                       float eps2, float4* __restrict__ sc4A,
                       float4* __restrict__ sc4B, float2* __restrict__ sc2A,
                       float2* __restrict__ sc2B) {
  __shared__ float4 shi[T];
  __shared__ float4 slo[T];
  __shared__ float4 svh[T];
  __shared__ float4 svl[T];
  __shared__ float4 col4[kWarps][T];
  __shared__ float2 col2[kWarps][T];
  const int I = static_cast<int>(blockIdx.x / ntB);
  const int J = static_cast<int>(blockIdx.x % ntB);
  const int r = threadIdx.x;
  const int i = I * T + r;
  const bool row_ok = i < nA;
  const float3 zero = make_float3(0.f, 0.f, 0.f);
  float3 xi = zero, li = zero, vi = zero, vli = zero;
  float gmi = 0.f;
  if (row_ok) {
    xi = load3(hiA, i);
    li = load3(loA, i);
    vi = load3(vhiA, i);
    vli = load3(vloA, i);
    gmi = gmA[i];
  }
  const int jj = J * T + r;
  if (jj < nB) {
    shi[r] = load4(hiB, jj, gmB[jj]);
    slo[r] = load4(loB, jj, 0.f);
    svh[r] = load4(vhiB, jj, 0.f);
    svl[r] = load4(vloB, jj, 0.f);
  } else {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    shi[r] = z;
    slo[r] = z;
    svh[r] = z;
    svl[r] = z;
  }
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    col4[w][r] = make_float4(0.f, 0.f, 0.f, 0.f);
    col2[w][r] = make_float2(0.f, 0.f);
  }
  __syncthreads();

  const int ncol = min(T, nB - J * T);  // live columns of tile J
  float3 a = zero, jk = zero;
  float4* mine4 = col4[r >> 5];
  float2* mine2 = col2[r >> 5];
#pragma unroll 2
  for (int k = 0; k < T; ++k) {
    const int c = (r + k) & (T - 1);
    if (row_ok && c < ncol) {
      float4 ca = mine4[c];
      float2 cj = mine2[c];
      ocn::sym_jerk_pair_x<GUARDED>(shi[c], slo[c], svh[c], svl[c], xi, li,
                                    vi, vli, gmi, eps2, a, jk, ca, cj);
      mine4[c] = ca;
      mine2[c] = cj;
    }
    __syncwarp();
  }
  if (row_ok) {
    const size_t slot = (static_cast<size_t>(I) * ntB + J) * T + r;
    sc4A[slot] = make_float4(a.x, a.y, a.z, jk.x);
    sc2A[slot] = make_float2(jk.y, jk.z);
  }
  __syncthreads();
  if (r < ncol) {
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
    const size_t slot = (static_cast<size_t>(J) * ntA + I) * T + r;
    sc4B[slot] = s4;
    sc2B[slot] = s2;
  }
}

template <bool GUARDED>
void launch(const float* hiA, const float* loA, const float* vhiA,
            const float* vloA, const float* gmA, int nA, const float* hiB,
            const float* loB, const float* vhiB, const float* vloB,
            const float* gmB, int nB, float eps2, float* scratch, float* accA,
            float* jerkA, float* accB, float* jerkB, cudaStream_t stream) {
  const int ntA = (nA + T - 1) / T;
  const int ntB = (nB + T - 1) / T;
  const size_t slots = static_cast<size_t>(ntA) * ntB * T;
  float4* sc4A = reinterpret_cast<float4*>(scratch);
  float4* sc4B = sc4A + slots;
  float2* sc2A = reinterpret_cast<float2*>(sc4B + slots);
  float2* sc2B = sc2A + slots;
  cross_jerk_tiles_x<GUARDED><<<static_cast<unsigned>(slots / T), T, 0,
                                stream>>>(hiA, loA, vhiA, vloA, gmA, nA, ntA,
                                          hiB, loB, vhiB, vloB, gmB, nB, ntB,
                                          eps2, sc4A, sc4B, sc2A, sc2B);
  constexpr int kR = ocn::kReduceThreads;
  ocn::tile_reduce_jerk<float2><<<(nA + kR - 1) / kR, kR, 0, stream>>>(
      sc4A, sc2A, nA, ntB, accA, jerkA);
  ocn::tile_reduce_jerk<float2><<<(nB + kR - 1) / kR, kR, 0, stream>>>(
      sc4B, sc2B, nB, ntA, accB, jerkB);
}

}  // namespace

// hiA, loA, vhiA, vloA (nA, 3), gmA (nA,), the same four planes of B (nB,
// 3), gmB (nB,), accA, jerkA (nA, 3) and accB, jerkB (nB, 3) are contiguous
// f32 on the device, the planes split under one centring of positions and
// one of velocities; scratch holds at least ocn_cross_jerk_scratch(nA, nB)
// floats (K13's). Returns cudaGetLastError() after the launches.
extern "C" int ocn_cross_jerk_x(const float* hiA, const float* loA,
                                const float* vhiA, const float* vloA,
                                const float* gmA, int nA, const float* hiB,
                                const float* loB, const float* vhiB,
                                const float* vloB, const float* gmB, int nB,
                                float eps2, int guarded, void* scratch,
                                float* accA, float* jerkA, float* accB,
                                float* jerkB, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nA <= 0 || nB <= 0) {
    if (nA > 0) {
      cudaMemsetAsync(accA, 0, sizeof(float) * 3 * nA, s);
      cudaMemsetAsync(jerkA, 0, sizeof(float) * 3 * nA, s);
    }
    if (nB > 0) {
      cudaMemsetAsync(accB, 0, sizeof(float) * 3 * nB, s);
      cudaMemsetAsync(jerkB, 0, sizeof(float) * 3 * nB, s);
    }
    return static_cast<int>(cudaGetLastError());
  }
  float* sc = static_cast<float*>(scratch);
  if (guarded)
    launch<true>(hiA, loA, vhiA, vloA, gmA, nA, hiB, loB, vhiB, vloB, gmB, nB,
                 eps2, sc, accA, jerkA, accB, jerkB, s);
  else
    launch<false>(hiA, loA, vhiA, vloA, gmA, nA, hiB, loB, vhiB, vloB, gmB,
                  nB, eps2, sc, accA, jerkA, accB, jerkB, s);
  return static_cast<int>(cudaGetLastError());
}
