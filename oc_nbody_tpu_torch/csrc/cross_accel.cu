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
// Bound on the card: the pair of K2, 25 f32 flops (28 with the potential;
// an FMA counts 2) and one rsqrt per pair (sym_rows.cuh:sym_pair_rb).
// Device memory is touched only by the partials below. As K2 (csrc/sym_accel.cu),
// the first design (one row a thread) ran at the shared-memory rate, 48
// bytes a pair; this one holds R rows a thread in registers
// (csrc/sym_rows.cuh), 48 / R bytes a pair, so from R = 4 on the issue
// rate of its 17 instructions a pair bounds it.
//
// Design: K2's register-blocked block over all ntA x ntB tile pairs, no
// triangle and no diagonal case. A-tiles hold TA = 128 R rows, B-tiles
// TB = TA / S columns. Two passes, no float atomics, fixed order:
//
//  * cross_tiles: one block of 128 threads per tile pair (I, J), I < ntA,
//    J < ntB, sweeping A-tile I against B-tile J pair-symmetrically
//    (rb::sweep_pairs). The block writes its row partials to scA[I][J] and
//    its columns' reaction partials, summed over its warps in warp order,
//    to scB[J][I].
//  * rb::partials_reduce, once per set: A-row r of tile X sums scA[X][P][r]
//    for P = 0 .. ntB-1, B-row r of tile Y sums scB[Y][P][r] for P = 0 ..
//    ntA-1, in that order.
//
// The geometry (R, S) is chosen from (nA, nB) alone (cross_geometry): the
// most rows a thread that still gives enough blocks to fill the card, with
// the narrowest B-tiles only where it must (16,384^2 runs R = 8, S = 4).
// So two launches on the same sets are bitwise equal. Scratch is ntA x ntB x (TA + TB) float4: 0.54 GB at nA =
// nB = 131,072 with R = 8, S = 1, the chunk of the chunked
// self-interaction; the caller allocates it once per evaluation and hands
// it to every chunk pair. Every slot a reduce reads is written once per
// call, so it needs no clearing. nA and nB need not be equal nor multiples
// of a tile: a row past nA is massless (its action is dropped, its
// reaction is zero), a column past nB is masked, and nothing is padded.
// Scratch offsets are size_t.

#include "sym_rows.cuh"

namespace {

namespace rb = ocn::rb;

template <int R, bool WITH_PHI, bool GUARDED>
__global__ void __launch_bounds__(rb::kThreads)
    cross_tiles(const float* __restrict__ posA,
                const float* __restrict__ massA, int nA, int ntA,
                const float* __restrict__ posB,
                const float* __restrict__ massB, int nB, int ntB, int S,
                float G, float eps2, float4* __restrict__ scA,
                float4* __restrict__ scB) {
  __shared__ rb::Shared sh;
  constexpr int TA = R * rb::kThreads;
  const int tb = TA / S;
  const int I = static_cast<int>(blockIdx.x / ntB);
  const int J = static_cast<int>(blockIdx.x % ntB);
  rb::Rows<R> w;
  rb::load_rows(w, posA, massA, I * TA, nA, G);
  rb::sweep_block<R, WITH_PHI, GUARDED, true>(
      w, sh, posB, massB, nB, J * tb, tb, G, eps2,
      scB + (static_cast<size_t>(J) * ntA + I) * tb);
  rb::store_rows(w, scA + (static_cast<size_t>(I) * ntB + J) * TA, I * TA,
                 nA);
}

using rb::cross_geometry;
using rb::cross_tiles_of;

template <int R, bool WITH_PHI, bool GUARDED>
void launch(const float* posA, const float* massA, int nA, const float* posB,
            const float* massB, int nB, int S, float G, float eps2,
            float4* scratch, float* accA, float* phiA, float* accB,
            float* phiB, cudaStream_t stream) {
  constexpr int TA = R * rb::kThreads;
  int ntA, ntB;
  cross_tiles_of(nA, nB, R, S, ntA, ntB);
  float4* scA = scratch;
  float4* scB = scA + static_cast<size_t>(ntA) * ntB * TA;
  const long long blocks = static_cast<long long>(ntA) * ntB;
  cross_tiles<R, WITH_PHI, GUARDED>
      <<<static_cast<unsigned>(blocks), rb::kThreads, 0, stream>>>(
          posA, massA, nA, ntA, posB, massB, nB, ntB, S, G, eps2, scA, scB);
  constexpr int kR = ocn::kReduceThreads;
  rb::partials_reduce<WITH_PHI><<<(nA + kR - 1) / kR, kR, 0, stream>>>(
      scA, nA, TA, ntB, 1, accA, phiA);
  rb::partials_reduce<WITH_PHI><<<(nB + kR - 1) / kR, kR, 0, stream>>>(
      scB, nB, TA / S, ntA, 1, accB, phiB);
}

template <int R>
void launch_r(const float* posA, const float* massA, int nA,
              const float* posB, const float* massB, int nB, int S, float G,
              float eps2, int guarded, float4* sc, float* accA, float* phiA,
              float* accB, float* phiB, cudaStream_t s) {
  if (phiA != nullptr) {
    if (guarded)
      launch<R, true, true>(posA, massA, nA, posB, massB, nB, S, G, eps2, sc,
                            accA, phiA, accB, phiB, s);
    else
      launch<R, true, false>(posA, massA, nA, posB, massB, nB, S, G, eps2,
                             sc, accA, phiA, accB, phiB, s);
  } else {
    if (guarded)
      launch<R, false, true>(posA, massA, nA, posB, massB, nB, S, G, eps2,
                             sc, accA, phiA, accB, phiB, s);
    else
      launch<R, false, false>(posA, massA, nA, posB, massB, nB, S, G, eps2,
                              sc, accA, phiA, accB, phiB, s);
  }
}

}  // namespace

// Floats of scratch K15 (csrc/cross_accel_x.cu) needs on nA x nB: its
// tiles are pair.cuh's kSymTile, 2 x ntA x ntB x T float4.
extern "C" long long ocn_cross_scratch(int nA, int nB) {
  constexpr int T = ocn::kSymTile;
  const long long ntA = (nA + T - 1) / T, ntB = (nB + T - 1) / T;
  return 8LL * ntA * ntB * T;
}

// K12's geometry on nA x nB, encoded R * 16 + S (csrc/sym_rows.cuh).
extern "C" int ocn_cross_geometry(int nA, int nB) {
  return cross_geometry(nA, nB);
}

// Floats of scratch K12 needs on nA x nB in geometry geom (0:
// cross_geometry(nA, nB), the one ocn_cross_accel takes); -1 for a
// geometry not compiled.
extern "C" long long ocn_cross_accel_scratch(int nA, int nB, int geom) {
  const int g = geom == 0 ? cross_geometry(nA, nB) : geom;
  if (!rb::geom_ok(g)) return -1;
  const int R = g / 16, S = g % 16;
  int ntA, ntB;
  cross_tiles_of(nA, nB, R, S, ntA, ntB);
  const long long ta = R * rb::kThreads;
  return 4LL * ntA * ntB * (ta + ta / S);
}

// K12 in geometry geom (0: cross_geometry(nA, nB)). posA (nA, 3), massA
// (nA,), posB (nB, 3), massB (nB,), accA (nA, 3) and accB (nB, 3) are
// contiguous f32 on the device, the positions centred in one frame;
// scratch holds at least ocn_cross_accel_scratch(nA, nB, geom) floats.
// phiA and phiB are both null (no potential) or both given. Returns
// cudaGetLastError() after the launches, cudaErrorInvalidValue for a
// geometry not compiled.
extern "C" int ocn_cross_accel_at(const float* posA, const float* massA,
                                  int nA, const float* posB,
                                  const float* massB, int nB, float G,
                                  float eps2, int guarded, int geom,
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
  const int g = geom == 0 ? cross_geometry(nA, nB) : geom;
  if (!rb::geom_ok(g)) return static_cast<int>(cudaErrorInvalidValue);
  const int R = g / 16, S = g % 16;
  float4* sc = static_cast<float4*>(scratch);
  switch (R) {
    case 1: launch_r<1>(posA, massA, nA, posB, massB, nB, S, G, eps2,
                        guarded, sc, accA, phiA, accB, phiB, s);
      break;
    case 2: launch_r<2>(posA, massA, nA, posB, massB, nB, S, G, eps2,
                        guarded, sc, accA, phiA, accB, phiB, s);
      break;
    case 4: launch_r<4>(posA, massA, nA, posB, massB, nB, S, G, eps2,
                        guarded, sc, accA, phiA, accB, phiB, s);
      break;
    default:
      launch_r<8>(posA, massA, nA, posB, massB, nB, S, G, eps2, guarded, sc,
                  accA, phiA, accB, phiB, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// K12 in the geometry cross_geometry(nA, nB) picks: the entry every caller
// of the port takes.
extern "C" int ocn_cross_accel(const float* posA, const float* massA, int nA,
                               const float* posB, const float* massB, int nB,
                               float G, float eps2, int guarded,
                               void* scratch, float* accA, float* phiA,
                               float* accB, float* phiB, void* stream) {
  return ocn_cross_accel_at(posA, massA, nA, posB, massB, nB, G, eps2,
                            guarded, 0, scratch, accA, phiA, accB, phiB,
                            stream);
}
