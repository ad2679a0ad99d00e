// K12: softened gravity between two DISJOINT sets A (nA rows) and B (nB
// sources), each pair once, with an optional potential output: the action
// of B goes to A's rows and the reaction (-G m_a d inv^3, and -G m_a inv
// for the potential) to B's. The sets share no particle, so there is no
// self pair and no self term anywhere.
//
// Replaces the TPU cross-pair sweep _make_cross_kernel with _pair_accel
// (_OP_A) and _pair_phi (_OP_P) (oc_nbody_tpu/ops/pallas_pair.py:296,
// launched by _cross_call at :369). The JAX package runs it for every
// unordered chunk pair (i < j) of the chunked self-interaction past
// STREAM_N (_cross_accumulate :414 under _sym_chunked_generic :443, via
// accel_sym_chunked and accel_potential_sym_chunked,
// oc_nbody_tpu/ops/pallas_gravity.py:1835, :1853) and for the disjoint-set
// forms accel_cross_pair and accel_potential_cross_pair (:2103, :2121).
//
// Bound on the card: the pair of K2, 26 f32 flops (28 with the potential;
// an FMA counts 2) and one rsqrtf per pair (pair.cuh:sym_pair), plus three
// 16-byte shared-memory accesses per pair. Device memory is touched only by
// the partials below, so the kernel is bound by the FMA pipe and
// shared-memory bandwidth together, as K2.
//
// Design: K2's block (csrc/sym_accel.cu) over all ntA x ntB tile pairs, no
// triangle and no diagonal case. Two passes, no float atomics, fixed order:
//
//  * cross_tiles: one block of T threads per tile pair (I, J), I < ntA,
//    J < ntB. Thread r owns A-row I*T + r in registers and sweeps B-tile J
//    on a rotating diagonal, column (r + k) mod T at step k, so the 32
//    lanes of a warp touch 32 distinct columns in a step; each warp keeps
//    its own reaction accumulators in shared memory and __syncwarp orders
//    the steps. The block writes its row partial to scA[I][J] and the sum
//    of its warps' reaction partials, taken in warp order, to scB[J][I].
//  * ocn::tile_reduce (pair.cuh), once per set: A-row r of tile X sums
//    scA[X][P][r] for P = 0 .. ntB-1, B-row r of tile Y sums scB[Y][P][r]
//    for P = 0 .. ntA-1, in that order.
//
// So two launches are bitwise equal. Scratch is 2 x ntA x ntB x T float4
// (16 bytes each): 4.3 GB at nA = nB = 131,072 with T = 128, the chunk of
// the chunked self-interaction; the caller allocates it once per
// evaluation and hands it to every chunk pair. Every slot a reduce reads is
// written once per call, so it needs no clearing. nA and nB need not be
// equal nor multiples of T: a row past nA skips its pairs (its lane still
// keeps the warp's step), a column past nB is masked, and nothing is
// padded. Scratch offsets are size_t (the slot count passes 2^31 from nA =
// nB = 131,072 on).

#include "pair.cuh"

namespace {

constexpr int T = ocn::kSymTile;
constexpr int kWarps = T / 32;
static_assert((T & (T - 1)) == 0, "the rotating diagonal needs T = 2^k");

template <bool WITH_PHI, bool GUARDED>
__global__ void __launch_bounds__(T)
    cross_tiles(const float* __restrict__ posA,
                const float* __restrict__ massA, int nA, int ntA,
                const float* __restrict__ posB,
                const float* __restrict__ massB, int nB, int ntB, float G,
                float eps2, float4* __restrict__ scA,
                float4* __restrict__ scB) {
  __shared__ float4 src[T];
  __shared__ float4 col[kWarps][T];
  const int I = static_cast<int>(blockIdx.x / ntB);
  const int J = static_cast<int>(blockIdx.x % ntB);
  const int r = threadIdx.x;
  const int i = I * T + r;
  const bool row_ok = i < nA;
  float xi = 0.f, yi = 0.f, zi = 0.f, gmi = 0.f;
  if (row_ok) {
    xi = posA[3 * i];
    yi = posA[3 * i + 1];
    zi = posA[3 * i + 2];
    gmi = G * massA[i];
  }
  const int j = J * T + r;
  src[r] = j < nB ? make_float4(posB[3 * j], posB[3 * j + 1],
                                posB[3 * j + 2], G * massB[j])
                  : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) col[w][r] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const int ncol = min(T, nB - J * T);  // live columns of tile J
  float ax = 0.f, ay = 0.f, az = 0.f, ph = 0.f;
  float4* mine = col[r >> 5];
#pragma unroll 4
  for (int k = 0; k < T; ++k) {
    const int c = (r + k) & (T - 1);
    if (row_ok && c < ncol) {
      float4 a = mine[c];
      ocn::sym_pair<WITH_PHI, GUARDED>(src[c], xi, yi, zi, gmi, eps2, ax, ay,
                                       az, ph, a);
      mine[c] = a;
    }
    __syncwarp();
  }
  if (row_ok)
    scA[(static_cast<size_t>(I) * ntB + J) * T + r] =
        make_float4(ax, ay, az, -ph);
  __syncthreads();
  if (r < ncol) {
    float4 s = col[0][r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      s.x += col[w][r].x;
      s.y += col[w][r].y;
      s.z += col[w][r].z;
      s.w += col[w][r].w;
    }
    scB[(static_cast<size_t>(J) * ntA + I) * T + r] = s;
  }
}

template <bool WITH_PHI, bool GUARDED>
void launch(const float* posA, const float* massA, int nA, const float* posB,
            const float* massB, int nB, float G, float eps2, float4* scA,
            float4* scB, float* accA, float* phiA, float* accB, float* phiB,
            cudaStream_t stream) {
  const int ntA = (nA + T - 1) / T;
  const int ntB = (nB + T - 1) / T;
  const long long blocks = static_cast<long long>(ntA) * ntB;
  cross_tiles<WITH_PHI, GUARDED><<<static_cast<unsigned>(blocks), T, 0,
                                   stream>>>(posA, massA, nA, ntA, posB,
                                             massB, nB, ntB, G, eps2, scA,
                                             scB);
  constexpr int kR = ocn::kReduceThreads;
  ocn::tile_reduce<WITH_PHI><<<(nA + kR - 1) / kR, kR, 0, stream>>>(
      scA, nA, ntB, accA, phiA);
  ocn::tile_reduce<WITH_PHI><<<(nB + kR - 1) / kR, kR, 0, stream>>>(
      scB, nB, ntA, accB, phiB);
}

}  // namespace

// Floats of scratch a call on nA x nB needs: 2 x ntA x ntB x T float4.
extern "C" long long ocn_cross_scratch(int nA, int nB) {
  const long long ntA = (nA + T - 1) / T, ntB = (nB + T - 1) / T;
  return 8LL * ntA * ntB * T;
}

// posA (nA, 3), massA (nA,), posB (nB, 3), massB (nB,), accA (nA, 3) and
// accB (nB, 3) are contiguous f32 on the device, the positions centred in
// one frame; scratch holds at least ocn_cross_scratch(nA, nB) floats. phiA
// and phiB are both null (no potential) or both given. Returns
// cudaGetLastError() after the launches.
extern "C" int ocn_cross_accel(const float* posA, const float* massA, int nA,
                               const float* posB, const float* massB, int nB,
                               float G, float eps2, int guarded,
                               void* scratch, float* accA, float* phiA,
                               float* accB, float* phiB, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nA <= 0 || nB <= 0) {
    if (nA > 0) {
      cudaMemsetAsync(accA, 0, sizeof(float) * 3 * nA, s);
      if (phiA != nullptr) cudaMemsetAsync(phiA, 0, sizeof(float) * nA, s);
    }
    if (nB > 0) {
      cudaMemsetAsync(accB, 0, sizeof(float) * 3 * nB, s);
      if (phiB != nullptr) cudaMemsetAsync(phiB, 0, sizeof(float) * nB, s);
    }
    return static_cast<int>(cudaGetLastError());
  }
  float4* scA = static_cast<float4*>(scratch);
  float4* scB = scA + static_cast<size_t>((nA + T - 1) / T) *
                          ((nB + T - 1) / T) * T;
  if (phiA != nullptr) {
    if (guarded)
      launch<true, true>(posA, massA, nA, posB, massB, nB, G, eps2, scA, scB,
                         accA, phiA, accB, phiB, s);
    else
      launch<true, false>(posA, massA, nA, posB, massB, nB, G, eps2, scA, scB,
                          accA, phiA, accB, phiB, s);
  } else {
    if (guarded)
      launch<false, true>(posA, massA, nA, posB, massB, nB, G, eps2, scA,
                          scB, accA, phiA, accB, phiB, s);
    else
      launch<false, false>(posA, massA, nA, posB, massB, nB, G, eps2, scA,
                           scB, accA, phiA, accB, phiB, s);
  }
  return static_cast<int>(cudaGetLastError());
}
