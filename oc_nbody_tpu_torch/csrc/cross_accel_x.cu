// K15: softened gravity between two DISJOINT sets A (nA rows) and B (nB
// sources) at the extended (hi/lo) precision tier, each pair once, with an
// optional raw potential output: the action of B goes to A's rows and the
// reaction (-G m_a s inv^3, and -G m_a inv for the potential) to B's. The
// sets share no particle, so there is no self pair and no self term.
//
// Replaces the TPU cross-pair sweep _make_cross_kernel with _pair_accel_x
// (_OP_AX) and _pair_phi_x (_OP_PX) (oc_nbody_tpu/ops/pallas_pair.py:296,
// :174, :182, launched by _cross_call at :369). The JAX package runs it for
// every unordered chunk pair (i < j) of the chunked extended
// self-interaction past STREAM_N (_sym_chunked_generic :443, via
// accel_sym_x_chunked and accel_potential_sym_x_chunked,
// oc_nbody_tpu/ops/pallas_gravity.py:1896, :1913) and for the disjoint-set
// forms accel_cross_pair_x_hilo and accel_potential_cross_pair_x_hilo
// (:2170, :2185).
//
// Both sets arrive as (hi, lo) f32 planes of f64 positions that the caller
// centred ONCE for the whole particle set and split in f64 (a centring per
// chunk would break the hi/lo invariant across chunks); gm is (G m in f64)
// rounded to f32. The pair is K6's, pair.cuh:sym_pair_x.
//
// Bound on the card: 44 f32 flops (46 with the potential; an FMA counts 2)
// and one rsqrtf per pair, plus four 16-byte shared-memory accesses per
// pair (two source reads, the reaction's read and write). Device memory is
// touched only by the partials below, so the kernel is bound by the FMA
// pipe and shared-memory bandwidth together, as K6.
//
// Design: K12's plan (csrc/cross_accel.cu) with K6's block
// (csrc/sym_accel_x.cu): one block of T threads per tile pair (I, J) over
// all ntA x ntB pairs, no triangle and no diagonal case. Thread r owns A-row
// I*T + r (hi, lo, G m) in registers and sweeps B-tile J, staged as two
// float4 per source, on a rotating diagonal, column (r + k) mod T at step
// k; each warp keeps its own reaction accumulators in shared memory and
// __syncwarp orders the steps. The block writes its row partial to
// scA[I][J] and the sum of its warps' reaction partials, in warp order, to
// scB[J][I]; then ocn::tile_reduce (pair.cuh) once per set, partials in
// tile order. No float atomics: two launches are bitwise equal. Scratch is
// 2 x ntA x ntB x T float4: 2.4 GB at nA = nB = 98,304 (CHUNK_SYMX) with T
// = 128; the caller allocates it once per evaluation. Every slot a reduce
// reads is written once per call. A row past nA skips its pairs, a column
// past nB is masked, nothing is padded; scratch offsets are size_t.

#include "pair.cuh"

namespace {

constexpr int T = ocn::kSymTile;
constexpr int kWarps = T / 32;
static_assert((T & (T - 1)) == 0, "the rotating diagonal needs T = 2^k");

__device__ __forceinline__ float3 load3(const float* __restrict__ p, int i) {
  return make_float3(p[3 * i], p[3 * i + 1], p[3 * i + 2]);
}

template <bool WITH_PHI, bool GUARDED>
__global__ void __launch_bounds__(T)
    cross_tiles_x(const float* __restrict__ hiA, const float* __restrict__ loA,
                  const float* __restrict__ gmA, int nA, int ntA,
                  const float* __restrict__ hiB, const float* __restrict__ loB,
                  const float* __restrict__ gmB, int nB, int ntB, float eps2,
                  float4* __restrict__ scA, float4* __restrict__ scB) {
  __shared__ float4 shi[T];
  __shared__ float4 slo[T];
  __shared__ float4 col[kWarps][T];
  const int I = static_cast<int>(blockIdx.x / ntB);
  const int J = static_cast<int>(blockIdx.x % ntB);
  const int r = threadIdx.x;
  const int i = I * T + r;
  const bool row_ok = i < nA;
  float3 xi = make_float3(0.f, 0.f, 0.f), li = make_float3(0.f, 0.f, 0.f);
  float gmi = 0.f;
  if (row_ok) {
    xi = load3(hiA, i);
    li = load3(loA, i);
    gmi = gmA[i];
  }
  const int j = J * T + r;
  if (j < nB) {
    const float3 h = load3(hiB, j), l = load3(loB, j);
    shi[r] = make_float4(h.x, h.y, h.z, gmB[j]);
    slo[r] = make_float4(l.x, l.y, l.z, 0.f);
  } else {
    shi[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    slo[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
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
      ocn::sym_pair_x<WITH_PHI, GUARDED>(shi[c], slo[c], xi, li, gmi, eps2,
                                         ax, ay, az, ph, a);
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
void launch(const float* hiA, const float* loA, const float* gmA, int nA,
            const float* hiB, const float* loB, const float* gmB, int nB,
            float eps2, float4* scA, float4* scB, float* accA, float* phiA,
            float* accB, float* phiB, cudaStream_t stream) {
  const int ntA = (nA + T - 1) / T;
  const int ntB = (nB + T - 1) / T;
  const long long blocks = static_cast<long long>(ntA) * ntB;
  cross_tiles_x<WITH_PHI, GUARDED><<<static_cast<unsigned>(blocks), T, 0,
                                     stream>>>(hiA, loA, gmA, nA, ntA, hiB,
                                               loB, gmB, nB, ntB, eps2, scA,
                                               scB);
  constexpr int kR = ocn::kReduceThreads;
  ocn::tile_reduce<WITH_PHI><<<(nA + kR - 1) / kR, kR, 0, stream>>>(
      scA, nA, ntB, accA, phiA);
  ocn::tile_reduce<WITH_PHI><<<(nB + kR - 1) / kR, kR, 0, stream>>>(
      scB, nB, ntA, accB, phiB);
}

}  // namespace

// hiA, loA (nA, 3), gmA (nA,), hiB, loB (nB, 3), gmB (nB,), accA (nA, 3) and
// accB (nB, 3) are contiguous f32 on the device, the planes split under one
// centring; scratch holds at least ocn_cross_scratch(nA, nB) floats (the
// same 2 x ntA x ntB x T float4 as K12). phiA and phiB are both null (no
// potential) or both given. Returns cudaGetLastError() after the launches.
extern "C" int ocn_cross_accel_x(const float* hiA, const float* loA,
                                 const float* gmA, int nA, const float* hiB,
                                 const float* loB, const float* gmB, int nB,
                                 float eps2, int guarded, void* scratch,
                                 float* accA, float* phiA, float* accB,
                                 float* phiB, void* stream) {
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
      launch<true, true>(hiA, loA, gmA, nA, hiB, loB, gmB, nB, eps2, scA, scB,
                         accA, phiA, accB, phiB, s);
    else
      launch<true, false>(hiA, loA, gmA, nA, hiB, loB, gmB, nB, eps2, scA,
                          scB, accA, phiA, accB, phiB, s);
  } else {
    if (guarded)
      launch<false, true>(hiA, loA, gmA, nA, hiB, loB, gmB, nB, eps2, scA,
                          scB, accA, phiA, accB, phiB, s);
    else
      launch<false, false>(hiA, loA, gmA, nA, hiB, loB, gmB, nB, eps2, scA,
                           scB, accA, phiA, accB, phiB, s);
  }
  return static_cast<int>(cudaGetLastError());
}
