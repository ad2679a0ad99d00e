// K7: pair-symmetric softened accel + jerk of N particles at the extended
// (hi/lo) precision tier (the Hermite force evaluation of that tier). Each
// unordered pair {i, j} is computed once: with w = G m_j inv^3, rv = s.dv
// and B = dv - 3 rv inv^2 s, row i gets (w s, w B) and row j the reaction
// -G m_i inv^3 (s, B).
//
// Replaces the TPU triangle sweep _make_sym_kernel with _pair_jerk_x
// (_OP_JX) (oc_nbody_tpu/ops/pallas_pair.py:256 and :202, launched by
// _sym_call via accel_jerk_sym_x, oc_nbody_tpu/ops/pallas_gravity.py:1811).
//
// Positions and velocities arrive as (hi, lo) f32 planes of the f64 state,
// each centred once and split in f64 by the caller; gm is (G m in f64)
// rounded to f32. s and inv are pair.cuh:hilo_sep_inv, dv is
// pair.cuh:hilo_dv.
//
// Bound on the card: 77 f32 flops (an FMA counts 2) and one rsqrtf per
// unique pair, plus eight shared-memory accesses per pair (four 16-byte
// source reads, a 16- and an 8-byte reaction read and write). Device memory
// is touched only by the partials below, so the kernel is bound by the FMA
// pipe and shared-memory bandwidth together.
//
// The design is K3's (sym_jerk.cu) with four float4 per source: one block
// of T threads per tile pair (I, J), I <= J; thread r owns row I*T + r
// (twelve coordinates, G m, six sums in registers); off the diagonal it
// sweeps tile J on a rotating diagonal, each warp keeping its own reaction
// accumulators in shared memory (a float4 plane: a.x, a.y, a.z, j.x; a
// float2 plane: j.y, j.z); a diagonal tile adds to rows only. The block
// writes its row partial to scratch[I][J] and, off the diagonal, the sum of
// its warps' reaction partials in warp order to scratch[J][I];
// sym_jerk_reduce_x sums scratch[X][P][r] over P in order. No float
// atomics: two launches give the same bits. Scratch is nt x nt x T slots of
// six floats (24 N nt bytes: 50 MB at N = 16,384 with T = 128). N need not
// be a multiple of T.

#include "pair.cuh"

namespace {

constexpr int T = ocn::kSymTile;
constexpr int kWarps = T / 32;
static_assert((T & (T - 1)) == 0, "the rotating diagonal needs T = 2^k");

__device__ __forceinline__ float4 load3(const float* __restrict__ p, int i,
                                        float w) {
  return make_float4(p[3 * i], p[3 * i + 1], p[3 * i + 2], w);
}

template <bool GUARDED>
__global__ void __launch_bounds__(T)
    sym_jerk_tiles_x(const float* __restrict__ hi,
                     const float* __restrict__ lo,
                     const float* __restrict__ vhi,
                     const float* __restrict__ vlo,
                     const float* __restrict__ gm, int n, int nt, float eps2,
                     float4* __restrict__ sc4, float2* __restrict__ sc2) {
  __shared__ float4 shi[T];
  __shared__ float4 slo[T];
  __shared__ float4 svh[T];
  __shared__ float4 svl[T];
  __shared__ float4 col4[kWarps][T];
  __shared__ float2 col2[kWarps][T];
  int I, J;
  ocn::tile_pair(blockIdx.x, nt, I, J);
  const int r = threadIdx.x;
  const int i = I * T + r;
  const bool row_ok = i < n;
  const float3 zero = make_float3(0.f, 0.f, 0.f);
  float3 xi = zero, li = zero, vi = zero, vli = zero;
  float gmi = 0.f;
  if (row_ok) {
    xi = make_float3(hi[3 * i], hi[3 * i + 1], hi[3 * i + 2]);
    li = make_float3(lo[3 * i], lo[3 * i + 1], lo[3 * i + 2]);
    vi = make_float3(vhi[3 * i], vhi[3 * i + 1], vhi[3 * i + 2]);
    vli = make_float3(vlo[3 * i], vlo[3 * i + 1], vlo[3 * i + 2]);
    gmi = gm[i];
  }
  const int jj = J * T + r;
  if (jj < n) {
    shi[r] = load3(hi, jj, gm[jj]);
    slo[r] = load3(lo, jj, 0.f);
    svh[r] = load3(vhi, jj, 0.f);
    svl[r] = load3(vlo, jj, 0.f);
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

  const int ncol = min(T, n - J * T);  // live columns of tile J
  float3 a = zero, jk = zero;
  if (I == J) {
    if (row_ok)
      for (int k = 0; k < ncol; ++k)
        ocn::row_jerk_pair_x<GUARDED>(shi[k], slo[k], svh[k], svl[k], xi, li,
                                      vi, vli, eps2, a, jk);
  } else {
    // tile I < J <= nt-1 is never the ragged last tile: every row is live
    float4* mine4 = col4[r >> 5];
    float2* mine2 = col2[r >> 5];
#pragma unroll 2
    for (int k = 0; k < T; ++k) {
      const int c = (r + k) & (T - 1);
      if (c < ncol) {
        float4 ca = mine4[c];
        float2 cj = mine2[c];
        ocn::sym_jerk_pair_x<GUARDED>(shi[c], slo[c], svh[c], svl[c], xi, li,
                                      vi, vli, gmi, eps2, a, jk, ca, cj);
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

__global__ void sym_jerk_reduce_x(const float4* __restrict__ sc4,
                                  const float2* __restrict__ sc2, int n,
                                  int nt, float* __restrict__ acc,
                                  float* __restrict__ jerk) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t base = static_cast<size_t>(i / T) * nt * T + (i % T);
  float4 s4 = sc4[base];
  float2 s2 = sc2[base];
  for (int P = 1; P < nt; ++P) {
    const size_t at = base + static_cast<size_t>(P) * T;
    const float4 v4 = sc4[at];
    const float2 v2 = sc2[at];
    s4.x += v4.x;
    s4.y += v4.y;
    s4.z += v4.z;
    s4.w += v4.w;
    s2.x += v2.x;
    s2.y += v2.y;
  }
  acc[3 * i] = s4.x;
  acc[3 * i + 1] = s4.y;
  acc[3 * i + 2] = s4.z;
  jerk[3 * i] = s4.w;
  jerk[3 * i + 1] = s2.x;
  jerk[3 * i + 2] = s2.y;
}

template <bool GUARDED>
void launch(const float* hi, const float* lo, const float* vhi,
            const float* vlo, const float* gm, int n, float eps2, float4* sc4,
            float2* sc2, float* acc, float* jerk, cudaStream_t stream) {
  const int nt = (n + T - 1) / T;
  const long long pairs = static_cast<long long>(nt) * (nt + 1) / 2;
  sym_jerk_tiles_x<GUARDED><<<static_cast<unsigned>(pairs), T, 0, stream>>>(
      hi, lo, vhi, vlo, gm, n, nt, eps2, sc4, sc2);
  constexpr int kReduce = 256;
  sym_jerk_reduce_x<<<(n + kReduce - 1) / kReduce, kReduce, 0, stream>>>(
      sc4, sc2, n, nt, acc, jerk);
}

}  // namespace

// hi, lo, vhi, vlo (n, 3), gm (n,), acc and jerk (n, 3) are contiguous f32
// on the device. scratch holds nt * nt * T * 6 floats with nt = ceil(n / T)
// and T = ocn_sym_tile(): the float4 plane first, then the float2 plane.
// Returns cudaGetLastError() after both launches.
extern "C" int ocn_sym_jerk_x(const float* hi, const float* lo,
                              const float* vhi, const float* vlo,
                              const float* gm, int n, float eps2, int guarded,
                              void* scratch, float* acc, float* jerk,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    const size_t slots = static_cast<size_t>((n + T - 1) / T) *
                         ((n + T - 1) / T) * T;
    float4* sc4 = static_cast<float4*>(scratch);
    float2* sc2 = reinterpret_cast<float2*>(sc4 + slots);
    if (guarded)
      launch<true>(hi, lo, vhi, vlo, gm, n, eps2, sc4, sc2, acc, jerk, s);
    else
      launch<false>(hi, lo, vhi, vlo, gm, n, eps2, sc4, sc2, acc, jerk, s);
  }
  return static_cast<int>(cudaGetLastError());
}
