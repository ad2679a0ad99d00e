// K9: one-sided softened accel + jerk of a row set from a source set at
// the extended (hi/lo) precision tier: the block-timestep active-row
// evaluation of that tier (a handful to a few thousand rows against all
// sources) and the Hermite self-interaction below the pair-symmetric
// kernel's floor.
//
// Replaces the TPU row sweep _accel_jerk_kernel_x
// (oc_nbody_tpu/ops/pallas_gravity.py:1208, launched by
// accel_jerk_rows_x_hilo at :1590).
//
// K17, its compensated variant (COMP), replaces the TPU streamed kernel
// _accel_jerk_stream_kernel_x (pallas_gravity.py:1415), which
// accel_jerk_rows_x_hilo takes past STREAM_N = 262,144 sources or
// RT_MAX_ROWS = 65,536 rows (:1596): the block stepper's active rows at the
// extended tier when N > 262,144, or when more than 65,536 rows are active
// (every particle, at each multiple of dt_max). That kernel streams the
// sources in tiles of TJ_XS = 1,024 and adds each tile's partial to the
// running sum with a Kahan step (_two_sum, :1444-1451). Here, as in K14
// (rows_jerk_t.cu), each lane sums a stage's 32 sources into a fresh
// partial and adds it to its running sum by a Kahan step, and pass 2 adds
// the chunk partials by Kahan steps, in the JAX package's form
// (pair.cuh:kahan_add, spelled with __fadd_rn / __fsub_rn so that --fmad
// cannot contract it). It adds 24 flops per lane and stage of 32 pairs.
//
// Rows and sources arrive as (hi, lo) f32 planes of f64 positions and
// velocities that the caller centred once, on the sources' centre for both
// sets, and split in f64; gm is (G m in f64) rounded to f32. The pair
// arithmetic is pair.cuh:row_jerk_pair_x.
//
// Bound on the card: 65 f32 flops (an FMA counts 2) and one rsqrtf per
// pair; each source (52 bytes) is read once per block from device memory
// (or L2) for 32 rows, and the partial sums are 24 bytes per row and chunk,
// so bytes never bind: the FMA pipe does.
//
// Design: K5's (rows_jerk_t.cu), because under block steps the rows are
// few and a one-thread-per-row layout would fill a fraction of the card.
// Two passes, no atomics, fixed summation order.
//   Pass 1, grid (row tiles of kRows, source chunks). The sources are cut
//     into chunks whose size depends on ns alone (chunk_size()). A block of
//     kRows x kLanes threads takes kRows rows and one chunk: it stages the
//     chunk in shared memory kStage sources at a time as four float4 (hi
//     with G m, lo, velocity hi, velocity lo). Thread (lane l, row r) sums
//     the sources l, l + kLanes, ... of each stage serially into its six
//     sums; the 32 threads of a warp share l, so each shared read is a
//     broadcast. The kLanes sums of a row are then added in lane order, and
//     the row's six chunk partials are stored to scratch.
//   Pass 2, one thread per (row, component): the chunk partials summed in
//     chunk order.
// Every row's arithmetic depends only on its own planes and on the
// sources: the chunk boundaries, the lane split and both orders are fixed
// by ns. So a row's result is bitwise the same whatever other rows share
// the launch (a compacted active set and the masked full set agree), and
// two launches agree bitwise. At 1M sources there are 128 chunks of 8,192
// and the scratch is 6 x 128 x nr floats, 3.2 GB at nr = 1,048,576; every
// scratch offset is 64-bit.
//
// The ragged last stage is masked by the loop bound; rows past nr compute
// and store nothing, so no input is padded.

#include "pair.cuh"

namespace {

constexpr int kRows = 32;    // rows per block: one warp's lanes
constexpr int kLanes = 8;    // source lanes per row: one warp each
constexpr int kThreads = kRows * kLanes;
constexpr int kStage = kThreads;  // sources staged in shared memory per step
constexpr int kMinChunk = 256;    // sources per chunk at ns <= kMaxChunks * 256
constexpr int kMaxChunks = 128;

// Sources per chunk: kMinChunk, doubled until at most kMaxChunks chunks
// cover ns. A function of ns alone.
inline int chunk_size(int ns) {
  int c = kMinChunk;
  while (static_cast<long long>(c) * kMaxChunks < ns) c *= 2;
  return c;
}

__device__ __forceinline__ float3 row3(const float* __restrict__ p, int i) {
  return make_float3(p[3 * i], p[3 * i + 1], p[3 * i + 2]);
}

__device__ __forceinline__ float4 src4(const float* __restrict__ p, int j,
                                       float w) {
  return make_float4(p[3 * j], p[3 * j + 1], p[3 * j + 2], w);
}

template <bool GUARDED, bool COMP>
__global__ void __launch_bounds__(kThreads)
    rows_jerk_x_partial(const float* __restrict__ rhi,
                        const float* __restrict__ rlo,
                        const float* __restrict__ vhi,
                        const float* __restrict__ vlo, int nr,
                        const float* __restrict__ shi,
                        const float* __restrict__ slo,
                        const float* __restrict__ svhi,
                        const float* __restrict__ svlo,
                        const float* __restrict__ gm, int ns, int chunk,
                        float eps2, float* __restrict__ part) {
  __shared__ float4 thi[kStage];
  __shared__ float4 tlo[kStage];
  __shared__ float4 tvh[kStage];
  __shared__ float4 tvl[kStage];
  __shared__ float red[kLanes][6][kRows];
  const int r = threadIdx.x % kRows;
  const int lane = threadIdx.x / kRows;
  const int i = blockIdx.x * kRows + r;
  const int c = blockIdx.y;
  const bool live = i < nr;
  const float3 zero = make_float3(0.f, 0.f, 0.f);
  float3 xi = zero, li = zero, vi = zero, vli = zero;
  if (live) {
    xi = row3(rhi, i);
    li = row3(rlo, i);
    vi = row3(vhi, i);
    vli = row3(vlo, i);
  }
  float3 a = zero, jk = zero;
  float3 ca = zero, cj = zero;  // K17's Kahan compensations
  const int c0 = c * chunk;
  const int c1 = min(c0 + chunk, ns);
  for (int s0 = c0; s0 < c1; s0 += kStage) {
    const int j = s0 + threadIdx.x;
    if (j < c1) {
      thi[threadIdx.x] = src4(shi, j, gm[j]);
      tlo[threadIdx.x] = src4(slo, j, 0.f);
      tvh[threadIdx.x] = src4(svhi, j, 0.f);
      tvl[threadIdx.x] = src4(svlo, j, 0.f);
    }
    __syncthreads();
    const int m = min(kStage, c1 - s0);
    // K9 sums into (a, jk) directly; K17 into a fresh stage partial
    float3 pa = zero, pj = zero;
    float3& sa = COMP ? pa : a;
    float3& sj = COMP ? pj : jk;
    if (m == kStage) {
#pragma unroll 4
      for (int k = lane; k < kStage; k += kLanes)
        ocn::row_jerk_pair_x<GUARDED>(thi[k], tlo[k], tvh[k], tvl[k], xi, li,
                                      vi, vli, eps2, sa, sj);
    } else {
      for (int k = lane; k < m; k += kLanes)
        ocn::row_jerk_pair_x<GUARDED>(thi[k], tlo[k], tvh[k], tvl[k], xi, li,
                                      vi, vli, eps2, sa, sj);
    }
    if (COMP) {
      ocn::kahan_add3(a, ca, pa);
      ocn::kahan_add3(jk, cj, pj);
    }
    __syncthreads();
  }
  red[lane][0][r] = a.x;
  red[lane][1][r] = a.y;
  red[lane][2][r] = a.z;
  red[lane][3][r] = jk.x;
  red[lane][4][r] = jk.y;
  red[lane][5][r] = jk.z;
  __syncthreads();
  // six warps each add one component's kLanes sums in lane order
  if (lane < 6 && live) {
    float t = red[0][lane][r];
#pragma unroll
    for (int l = 1; l < kLanes; ++l) t += red[l][lane][r];
    // scratch planes: part[(c * 6 + component) * nr + row]
    part[(static_cast<long long>(c) * 6 + lane) * nr + i] = t;
  }
}

template <bool COMP>
__global__ void rows_jerk_x_reduce(const float* __restrict__ part, int nr,
                                   int nchunks, float* __restrict__ acc,
                                   float* __restrict__ jerk) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= 6LL * nr) return;
  const int k = static_cast<int>(t / nr);
  const int i = static_cast<int>(t % nr);
  float s = 0.f, comp = 0.f;
#pragma unroll 8
  for (int c = 0; c < nchunks; ++c) {
    const float p = part[(static_cast<long long>(c) * 6 + k) * nr + i];
    if (COMP)
      ocn::kahan_add(s, comp, p);
    else
      s += p;
  }
  if (k < 3)
    acc[3 * i + k] = s;
  else
    jerk[3 * i + k - 3] = s;
}

template <bool GUARDED, bool COMP>
void launch(const float* rhi, const float* rlo, const float* vhi,
            const float* vlo, int nr, const float* shi, const float* slo,
            const float* svhi, const float* svlo, const float* gm, int ns,
            float eps2, float* part, float* acc, float* jerk,
            cudaStream_t s) {
  const int chunk = chunk_size(ns);
  const int nchunks = (ns + chunk - 1) / chunk;
  const dim3 grid((nr + kRows - 1) / kRows, nchunks);
  rows_jerk_x_partial<GUARDED, COMP><<<grid, kThreads, 0, s>>>(
      rhi, rlo, vhi, vlo, nr, shi, slo, svhi, svlo, gm, ns, chunk, eps2,
      part);
  constexpr int kReduceThreads = 256;
  const long long work = 6LL * nr;
  const int blocks = static_cast<int>((work + kReduceThreads - 1) /
                                      kReduceThreads);
  rows_jerk_x_reduce<COMP><<<blocks, kReduceThreads, 0, s>>>(part, nr,
                                                             nchunks, acc,
                                                             jerk);
}

}  // namespace

// Floats of scratch the launch needs: six per row and source chunk.
extern "C" long long ocn_rows_jerk_x_scratch(int nr, int ns) {
  const int chunk = chunk_size(ns);
  const long long nchunks = (ns + chunk - 1) / chunk;
  return 6LL * nchunks * nr;
}

// rhi, rlo, vhi, vlo (nr, 3), shi, slo, svhi, svlo (ns, 3), gm (ns,), acc
// and jerk (nr, 3) are contiguous f32 on the device; part holds
// ocn_rows_jerk_x_scratch(nr, ns) floats. compensated picks K17 (Kahan
// steps across stages and chunks) over K9. Returns cudaGetLastError() after
// the launches.
extern "C" int ocn_rows_jerk_x(const float* rhi, const float* rlo,
                               const float* vhi, const float* vlo, int nr,
                               const float* shi, const float* slo,
                               const float* svhi, const float* svlo,
                               const float* gm, int ns, float eps2,
                               int guarded, int compensated, float* part,
                               float* acc, float* jerk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nr <= 0) return static_cast<int>(cudaGetLastError());
  if (ns <= 0) {
    cudaMemsetAsync(acc, 0, sizeof(float) * 3 * nr, s);
    cudaMemsetAsync(jerk, 0, sizeof(float) * 3 * nr, s);
    return static_cast<int>(cudaGetLastError());
  }
  if (compensated) {
    if (guarded)
      launch<true, true>(rhi, rlo, vhi, vlo, nr, shi, slo, svhi, svlo, gm, ns,
                         eps2, part, acc, jerk, s);
    else
      launch<false, true>(rhi, rlo, vhi, vlo, nr, shi, slo, svhi, svlo, gm,
                          ns, eps2, part, acc, jerk, s);
  } else {
    if (guarded)
      launch<true, false>(rhi, rlo, vhi, vlo, nr, shi, slo, svhi, svlo, gm,
                          ns, eps2, part, acc, jerk, s);
    else
      launch<false, false>(rhi, rlo, vhi, vlo, nr, shi, slo, svhi, svlo, gm,
                           ns, eps2, part, acc, jerk, s);
  }
  return static_cast<int>(cudaGetLastError());
}
