// K5: one-sided softened accel + jerk of a few rows from many resident
// sources, split over the sources: the block-timestep active-row
// evaluation, where a micro-step moves a handful to a few thousand of the
// sources.
//
// Replaces the TPU transposed kernel _accel_jerk_kernel_t with its sweep
// _sweep_t_jerk (oc_nbody_tpu/ops/pallas_gravity.py:926, :801; launched by
// accel_jerk_rows_t at :1006). The TPU stored rows transposed to dodge the
// (8, 128) VMEM padding; the card has no such padding, so none of that
// layout is kept. What the card needs is enough blocks when the rows are
// few: K4 (rows_jerk.cu) puts one thread on a row and 128 rows in a block,
// so 64 active rows fill one block on one of 132 SMs.
//
// Bound on the card: 41 f32 flops (an FMA counts 2) and one rsqrtf per
// pair, the arithmetic of pair.cuh:row_jerk_pair; each source is read once
// per block from device memory (or L2) for 32 rows, and the partial sums
// are 24 bytes per row and chunk, so bytes never bind: the FMA pipe does.
//
// Design: two passes, no atomics, fixed summation order.
//   Pass 1, grid (row tiles of kRows, source chunks). The sources are cut
//     into chunks whose size depends on ns alone (chunk_size()). A block of
//     kRows x kLanes threads takes kRows rows and one chunk: it stages the
//     chunk in shared memory kStage sources at a time, as float4(x, y, z,
//     G m) and float4(vx, vy, vz, 0). Thread (lane l, row r) sums the
//     sources l, l + kLanes, l + 2 kLanes, ... of each stage serially into
//     its six sums; the 32 threads of a warp share l, so each shared read
//     is a broadcast. The kLanes sums of a row are then added in lane
//     order, and the row's six chunk partials are stored to scratch.
//   Pass 2, one thread per (row, component): the chunk partials summed in
//     chunk order.
// Every row's arithmetic depends only on its own position and velocity and
// on the sources: the chunk boundaries, the lane split and both orders are
// fixed by ns. So a row's result is bitwise the same whatever other rows
// share the launch (a compacted active set and the masked full set agree),
// and two launches agree bitwise. At nr = 64 and ns = 32,768 the first pass
// runs 2 x 128 blocks of 256 threads.
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

template <bool GUARDED>
__global__ void __launch_bounds__(kThreads)
    rows_jerk_t_partial(const float* __restrict__ rows,
                        const float* __restrict__ vrows, int nr,
                        const float* __restrict__ src,
                        const float* __restrict__ svel,
                        const float* __restrict__ mass, int ns, int chunk,
                        float G, float eps2, float* __restrict__ part) {
  __shared__ float4 tile[kStage];
  __shared__ float4 vtile[kStage];
  __shared__ float red[kLanes][6][kRows];
  const int r = threadIdx.x % kRows;
  const int lane = threadIdx.x / kRows;
  const int i = blockIdx.x * kRows + r;
  const int c = blockIdx.y;
  const bool live = i < nr;
  float3 xi = make_float3(0.f, 0.f, 0.f), vi = make_float3(0.f, 0.f, 0.f);
  if (live) {
    xi = make_float3(rows[3 * i], rows[3 * i + 1], rows[3 * i + 2]);
    vi = make_float3(vrows[3 * i], vrows[3 * i + 1], vrows[3 * i + 2]);
  }
  float3 a = make_float3(0.f, 0.f, 0.f), jk = make_float3(0.f, 0.f, 0.f);
  const int c0 = c * chunk;
  const int c1 = min(c0 + chunk, ns);
  for (int s0 = c0; s0 < c1; s0 += kStage) {
    const int j = s0 + threadIdx.x;
    if (j < c1) {
      tile[threadIdx.x] =
          make_float4(src[3 * j], src[3 * j + 1], src[3 * j + 2], G * mass[j]);
      vtile[threadIdx.x] =
          make_float4(svel[3 * j], svel[3 * j + 1], svel[3 * j + 2], 0.f);
    }
    __syncthreads();
    const int m = min(kStage, c1 - s0);
    if (m == kStage) {
#pragma unroll 8
      for (int k = lane; k < kStage; k += kLanes)
        ocn::row_jerk_pair<GUARDED>(tile[k], vtile[k], xi, vi, eps2, a, jk);
    } else {
      for (int k = lane; k < m; k += kLanes)
        ocn::row_jerk_pair<GUARDED>(tile[k], vtile[k], xi, vi, eps2, a, jk);
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

__global__ void rows_jerk_t_reduce(const float* __restrict__ part, int nr,
                                   int nchunks, float* __restrict__ acc,
                                   float* __restrict__ jerk) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= 6LL * nr) return;
  const int k = static_cast<int>(t / nr);
  const int i = static_cast<int>(t % nr);
  float s = 0.f;
#pragma unroll 8
  for (int c = 0; c < nchunks; ++c)
    s += part[(static_cast<long long>(c) * 6 + k) * nr + i];
  if (k < 3)
    acc[3 * i + k] = s;
  else
    jerk[3 * i + k - 3] = s;
}

}  // namespace

// Floats of scratch the launch needs: six per row and source chunk.
extern "C" long long ocn_rows_jerk_t_scratch(int nr, int ns) {
  const int chunk = chunk_size(ns);
  const long long nchunks = (ns + chunk - 1) / chunk;
  return 6LL * nchunks * nr;
}

// rows, vrows (nr, 3), src, svel (ns, 3), mass (ns,), acc and jerk (nr, 3)
// are contiguous f32 on the device; part holds ocn_rows_jerk_t_scratch(nr,
// ns) floats. Returns cudaGetLastError() after the launches.
extern "C" int ocn_rows_jerk_t(const float* rows, const float* vrows, int nr,
                               const float* src, const float* svel,
                               const float* mass, int ns, float G, float eps2,
                               int guarded, float* part, float* acc,
                               float* jerk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nr <= 0) return static_cast<int>(cudaGetLastError());
  if (ns <= 0) {
    cudaMemsetAsync(acc, 0, sizeof(float) * 3 * nr, s);
    cudaMemsetAsync(jerk, 0, sizeof(float) * 3 * nr, s);
    return static_cast<int>(cudaGetLastError());
  }
  const int chunk = chunk_size(ns);
  const int nchunks = (ns + chunk - 1) / chunk;
  const dim3 grid((nr + kRows - 1) / kRows, nchunks);
  if (guarded)
    rows_jerk_t_partial<true><<<grid, kThreads, 0, s>>>(
        rows, vrows, nr, src, svel, mass, ns, chunk, G, eps2, part);
  else
    rows_jerk_t_partial<false><<<grid, kThreads, 0, s>>>(
        rows, vrows, nr, src, svel, mass, ns, chunk, G, eps2, part);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  constexpr int kReduceThreads = 256;
  const long long work = 6LL * nr;
  const int blocks = static_cast<int>((work + kReduceThreads - 1) /
                                      kReduceThreads);
  rows_jerk_t_reduce<<<blocks, kReduceThreads, 0, s>>>(part, nr, nchunks, acc,
                                                       jerk);
  return static_cast<int>(cudaGetLastError());
}
