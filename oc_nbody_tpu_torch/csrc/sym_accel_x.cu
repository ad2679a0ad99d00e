// K6: pair-symmetric softened self-gravity of N particles at the extended
// (hi/lo) precision tier, with an optional raw potential output. Each
// unordered pair {i, j} is computed once: the action goes to row i and the
// reaction (-G m_i s inv^3, and -G m_i inv for the potential) to row j.
//
// Replaces the TPU triangle sweep _make_sym_kernel with _pair_accel_x
// (_OP_AX) and _pair_phi_x (_OP_PX) (oc_nbody_tpu/ops/pallas_pair.py:256,
// :174, :182, launched by _sym_call via accel_sym_x and
// accel_potential_sym_x, oc_nbody_tpu/ops/pallas_gravity.py:1781 and :1796).
//
// Positions arrive as (hi, lo) f32 planes of the f64 coordinates, centred
// once and split in f64 by the caller; gm is (G m in f64) rounded to f32.
// The separation and inverse distance are pair.cuh:hilo_sep_inv.
//
// Bound on the card: 44 f32 flops (46 with the potential; an FMA counts 2)
// and one rsqrtf per unique pair, plus four 16-byte shared-memory accesses
// per pair (two source reads, the reaction's read and write). Device memory
// is touched only by the partials below, so the kernel is bound by the FMA
// pipe and shared-memory bandwidth together.
//
// The design is K2's (sym_accel.cu) with two float4 per source: one block
// of T threads per tile pair (I, J), I <= J; thread r owns row I*T + r in
// registers; off the diagonal it sweeps tile J on a rotating diagonal,
// column (r + k) mod T at step k, each warp keeping its own reaction
// accumulators in shared memory; a diagonal tile adds to rows only, every
// pair in both directions, so the softened self term -G m/eps stays in the
// potential (the raw potential of this tier; the caller adds self_phi).
// The block writes its row partial to scratch[I][J] and, off the diagonal,
// the sum of its warps' reaction partials in warp order to scratch[J][I];
// sym_reduce_x sums scratch[X][P][r] over P in order. No float atomics:
// two launches give the same bits. Scratch is nt x nt x T float4 (16 N nt
// bytes: 2.1 GB at N = 131,072 with T = 128), every slot read is written
// once per call. N need not be a multiple of T.

#include "pair.cuh"

namespace {

constexpr int T = ocn::kSymTile;
constexpr int kWarps = T / 32;
static_assert((T & (T - 1)) == 0, "the rotating diagonal needs T = 2^k");

template <bool WITH_PHI, bool GUARDED>
__global__ void __launch_bounds__(T)
    sym_tiles_x(const float* __restrict__ hi, const float* __restrict__ lo,
                const float* __restrict__ gm, int n, int nt, float eps2,
                float4* __restrict__ scratch) {
  __shared__ float4 shi[T];
  __shared__ float4 slo[T];
  __shared__ float4 col[kWarps][T];
  int I, J;
  ocn::tile_pair(blockIdx.x, nt, I, J);
  const int r = threadIdx.x;
  const int i = I * T + r;
  const bool row_ok = i < n;
  float3 xi = make_float3(0.f, 0.f, 0.f), li = make_float3(0.f, 0.f, 0.f);
  float gmi = 0.f;
  if (row_ok) {
    xi = make_float3(hi[3 * i], hi[3 * i + 1], hi[3 * i + 2]);
    li = make_float3(lo[3 * i], lo[3 * i + 1], lo[3 * i + 2]);
    gmi = gm[i];
  }
  const int j = J * T + r;
  if (j < n) {
    shi[r] = make_float4(hi[3 * j], hi[3 * j + 1], hi[3 * j + 2], gm[j]);
    slo[r] = make_float4(lo[3 * j], lo[3 * j + 1], lo[3 * j + 2], 0.f);
  } else {
    shi[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    slo[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int w = 0; w < kWarps; ++w) col[w][r] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const int ncol = min(T, n - J * T);  // live columns of tile J
  float ax = 0.f, ay = 0.f, az = 0.f, ph = 0.f;
  if (I == J) {
    if (row_ok)
      for (int k = 0; k < ncol; ++k)
        ocn::row_pair_x<WITH_PHI, GUARDED>(shi[k], slo[k], xi, li, eps2, ax,
                                           ay, az, ph);
  } else {
    // tile I < J <= nt-1 is never the ragged last tile: every row is live
    float4* mine = col[r >> 5];
#pragma unroll 4
    for (int k = 0; k < T; ++k) {
      const int c = (r + k) & (T - 1);
      if (c < ncol) {
        float4 a = mine[c];
        ocn::sym_pair_x<WITH_PHI, GUARDED>(shi[c], slo[c], xi, li, gmi, eps2,
                                           ax, ay, az, ph, a);
        mine[c] = a;
      }
      __syncwarp();
    }
  }
  if (row_ok)
    scratch[(static_cast<size_t>(I) * nt + J) * T + r] =
        make_float4(ax, ay, az, -ph);
  __syncthreads();
  if (I != J && r < ncol) {
    float4 s = col[0][r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      s.x += col[w][r].x;
      s.y += col[w][r].y;
      s.z += col[w][r].z;
      s.w += col[w][r].w;
    }
    scratch[(static_cast<size_t>(J) * nt + I) * T + r] = s;
  }
}

template <bool WITH_PHI>
__global__ void sym_reduce_x(const float4* __restrict__ scratch, int n,
                             int nt, float* __restrict__ acc,
                             float* __restrict__ phi) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float4* p = scratch + static_cast<size_t>(i / T) * nt * T + (i % T);
  float4 s = p[0];
  for (int P = 1; P < nt; ++P) {
    const float4 v = p[static_cast<size_t>(P) * T];
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

template <bool WITH_PHI, bool GUARDED>
void launch(const float* hi, const float* lo, const float* gm, int n,
            float eps2, float4* scratch, float* acc, float* phi,
            cudaStream_t stream) {
  const int nt = (n + T - 1) / T;
  const long long pairs = static_cast<long long>(nt) * (nt + 1) / 2;
  sym_tiles_x<WITH_PHI, GUARDED>
      <<<static_cast<unsigned>(pairs), T, 0, stream>>>(hi, lo, gm, n, nt,
                                                       eps2, scratch);
  constexpr int kReduce = 256;
  sym_reduce_x<WITH_PHI><<<(n + kReduce - 1) / kReduce, kReduce, 0, stream>>>(
      scratch, n, nt, acc, phi);
}

}  // namespace

// hi, lo (n, 3), gm (n,) and acc (n, 3) are contiguous f32 on the device;
// phi (n,) may be null, and then no potential is computed. scratch holds
// nt * nt * T float4 with nt = ceil(n / T) and T = ocn_sym_tile(). Returns
// cudaGetLastError() after both launches.
extern "C" int ocn_sym_accel_x(const float* hi, const float* lo,
                               const float* gm, int n, float eps2,
                               int guarded, void* scratch, float* acc,
                               float* phi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* sc = static_cast<float4*>(scratch);
  if (n > 0) {
    if (phi != nullptr) {
      if (guarded)
        launch<true, true>(hi, lo, gm, n, eps2, sc, acc, phi, s);
      else
        launch<true, false>(hi, lo, gm, n, eps2, sc, acc, phi, s);
    } else {
      if (guarded)
        launch<false, true>(hi, lo, gm, n, eps2, sc, acc, phi, s);
      else
        launch<false, false>(hi, lo, gm, n, eps2, sc, acc, phi, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
