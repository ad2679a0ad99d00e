// K13: softened accel + jerk between two DISJOINT sets A (nA rows) and B
// (nB sources), each pair once: with w = G m_b inv^3, rv = d.dv and B = dv
// - 3 rv inv^2 d, A's row gets (w d, w B) and B's the reaction -G m_a inv^3
// (d, B). No self pair exists between disjoint sets.
//
// Replaces the TPU cross-pair sweep _make_cross_kernel with _pair_jerk
// (_OP_J) (oc_nbody_tpu/ops/pallas_pair.py:296 and :137, launched by
// _cross_call at :369), run for every unordered chunk pair of the chunked
// accel + jerk self-interaction past STREAM_N (accel_jerk_sym_chunked,
// oc_nbody_tpu/ops/pallas_gravity.py:1876) and by accel_jerk_cross_pair
// (:2140).
//
// Bound on the card: K3's pair, 53 f32 flops (an FMA counts 2) and one
// rsqrtf per pair (pair.cuh:sym_jerk_pair), plus six shared-memory accesses
// per pair; device memory is touched only by the partials, so the FMA pipe
// and shared-memory bandwidth bind together, as in K3.
//
// Design: K3's block (csrc/sym_jerk.cu) on K12's plan (csrc/cross_accel.cu):
// one block of T threads per tile pair (I, J) over all ntA x ntB pairs, the
// rotating-diagonal column sweep with per-warp reaction accumulators in
// shared memory (a float4 plane a.x, a.y, a.z, j.x and a float2 plane j.y,
// j.z), the row partial to scA[I][J] and the warps' reaction partials,
// summed in warp order, to scB[J][I]; then ocn::tile_reduce_jerk once per
// set, partials in index order. No float atomics: two launches are bitwise
// equal. Scratch is 2 x ntA x ntB x T slots of six floats: 3.6 GB at nA =
// nB = 98,304, the jerk chunk; the caller allocates it once per evaluation.
// Its layout: scA's float4 plane, scB's float4 plane, scA's float2 plane,
// scB's float2 plane. Ragged nA and nB are masked, not padded.

#include "pair.cuh"

namespace {

constexpr int T = ocn::kSymTile;
constexpr int kWarps = T / 32;
static_assert((T & (T - 1)) == 0, "the rotating diagonal needs T = 2^k");

template <bool GUARDED>
__global__ void __launch_bounds__(T)
    cross_jerk_tiles(const float* __restrict__ posA,
                     const float* __restrict__ velA,
                     const float* __restrict__ massA, int nA, int ntA,
                     const float* __restrict__ posB,
                     const float* __restrict__ velB,
                     const float* __restrict__ massB, int nB, int ntB,
                     float G, float eps2, float4* __restrict__ sc4A,
                     float4* __restrict__ sc4B, float2* __restrict__ sc2A,
                     float2* __restrict__ sc2B) {
  __shared__ float4 src[T];
  __shared__ float4 svel[T];
  __shared__ float4 col4[kWarps][T];
  __shared__ float2 col2[kWarps][T];
  const int I = static_cast<int>(blockIdx.x / ntB);
  const int J = static_cast<int>(blockIdx.x % ntB);
  const int r = threadIdx.x;
  const int i = I * T + r;
  const bool row_ok = i < nA;
  float3 xi = make_float3(0.f, 0.f, 0.f), vi = make_float3(0.f, 0.f, 0.f);
  float gmi = 0.f;
  if (row_ok) {
    xi = make_float3(posA[3 * i], posA[3 * i + 1], posA[3 * i + 2]);
    vi = make_float3(velA[3 * i], velA[3 * i + 1], velA[3 * i + 2]);
    gmi = G * massA[i];
  }
  const int jj = J * T + r;
  if (jj < nB) {
    src[r] = make_float4(posB[3 * jj], posB[3 * jj + 1], posB[3 * jj + 2],
                         G * massB[jj]);
    svel[r] = make_float4(velB[3 * jj], velB[3 * jj + 1], velB[3 * jj + 2],
                          0.f);
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

  const int ncol = min(T, nB - J * T);  // live columns of tile J
  float3 a = make_float3(0.f, 0.f, 0.f), jk = make_float3(0.f, 0.f, 0.f);
  float4* mine4 = col4[r >> 5];
  float2* mine2 = col2[r >> 5];
#pragma unroll 4
  for (int k = 0; k < T; ++k) {
    const int c = (r + k) & (T - 1);
    if (row_ok && c < ncol) {
      float4 ca = mine4[c];
      float2 cj = mine2[c];
      ocn::sym_jerk_pair<GUARDED>(src[c], svel[c], xi, vi, gmi, eps2, a, jk,
                                  ca, cj);
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
void launch(const float* posA, const float* velA, const float* massA, int nA,
            const float* posB, const float* velB, const float* massB, int nB,
            float G, float eps2, float* scratch, float* accA, float* jerkA,
            float* accB, float* jerkB, cudaStream_t stream) {
  const int ntA = (nA + T - 1) / T;
  const int ntB = (nB + T - 1) / T;
  const size_t slots = static_cast<size_t>(ntA) * ntB * T;
  float4* sc4A = reinterpret_cast<float4*>(scratch);
  float4* sc4B = sc4A + slots;
  float2* sc2A = reinterpret_cast<float2*>(sc4B + slots);
  float2* sc2B = sc2A + slots;
  cross_jerk_tiles<GUARDED><<<static_cast<unsigned>(slots / T), T, 0,
                              stream>>>(posA, velA, massA, nA, ntA, posB,
                                        velB, massB, nB, ntB, G, eps2, sc4A,
                                        sc4B, sc2A, sc2B);
  constexpr int kR = ocn::kReduceThreads;
  ocn::tile_reduce_jerk<float2><<<(nA + kR - 1) / kR, kR, 0, stream>>>(
      sc4A, sc2A, nA, ntB, accA, jerkA);
  ocn::tile_reduce_jerk<float2><<<(nB + kR - 1) / kR, kR, 0, stream>>>(
      sc4B, sc2B, nB, ntA, accB, jerkB);
}

}  // namespace

// Floats of scratch a call on nA x nB needs: 2 x ntA x ntB x T slots of six.
extern "C" long long ocn_cross_jerk_scratch(int nA, int nB) {
  const long long ntA = (nA + T - 1) / T, ntB = (nB + T - 1) / T;
  return 12LL * ntA * ntB * T;
}

// posA, velA (nA, 3), massA (nA,), posB, velB (nB, 3), massB (nB,), accA,
// jerkA (nA, 3) and accB, jerkB (nB, 3) are contiguous f32 on the device,
// positions and velocities centred in one frame; scratch holds at least
// ocn_cross_jerk_scratch(nA, nB) floats. Returns cudaGetLastError() after
// the launches.
extern "C" int ocn_cross_jerk(const float* posA, const float* velA,
                              const float* massA, int nA, const float* posB,
                              const float* velB, const float* massB, int nB,
                              float G, float eps2, int guarded, void* scratch,
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
    launch<true>(posA, velA, massA, nA, posB, velB, massB, nB, G, eps2, sc,
                 accA, jerkA, accB, jerkB, s);
  else
    launch<false>(posA, velA, massA, nA, posB, velB, massB, nB, G, eps2, sc,
                  accA, jerkA, accB, jerkB, s);
  return static_cast<int>(cudaGetLastError());
}
