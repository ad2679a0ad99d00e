// The source-split layout of the rows-vs-sources kernels for few rows
// against many sources: K5/K14 (rows_jerk_t.cu), K9/K17 (rows_jerk_x.cu),
// K18 (rows_accel_t.cu), K19 (rows_accel_xs.cu) and the ring steps K20
// (ring_accel.cu) and K21 (ring_jerk.cu). Each kernel family writes its own
// first pass (what it stages and which pair function it runs; K18's and
// K5's live in rows_accel_t.cuh and rows_jerk_t.cuh, which K20 and K21
// share); the shape of the passes, the lane reduction, the chunk-order
// reductions and the scratch size live here, once.
//
// Two passes, no atomics, fixed summation order.
//   Pass 1, grid (row tiles of kRows, source chunks) of kThreads threads.
//     The sources are cut into chunks whose size depends on ns alone
//     (chunk_size()). A block takes kRows rows and one chunk and stages the
//     chunk in shared memory kStage sources at a time. Thread (lane l, row
//     r) sums the sources l, l + kLanes, ... of each stage serially; the 32
//     threads of a warp share l, so each shared read is a broadcast. The
//     kernel hands its kComp sums per thread to store_partials(), which adds
//     the kLanes sums of a row in lane order and stores the row's kComp
//     chunk partials to scratch, plane (c * kComp + component).
//   Pass 2, reduce(): one thread per (row, component), the chunk partials
//     summed in chunk order (COMP: by Kahan steps); components 0-2 go to
//     acc (nr, 3), the rest to tail (nr, kComp - 3), negated with NEG_TAIL
//     (the potential is summed as G m / r). The ring steps' pass 2 is
//     accumulate(): the same plain chunk-order sum, then added by a Kahan
//     step into running sums that persist across launches.
// Every row's arithmetic depends only on its own inputs and on the sources:
// the chunk boundaries, the lane split and both orders are fixed by ns. So
// a row's result is bitwise the same whatever other rows share the launch,
// and two launches agree bitwise. Every scratch offset is 64-bit.

#pragma once

#include "pair.cuh"

namespace ocn {
namespace {
namespace split {

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

inline int num_chunks(int ns) {
  const int chunk = chunk_size(ns);
  return (ns + chunk - 1) / chunk;
}

// Pass 1's grid: row tiles by source chunks.
inline dim3 partial_grid(int nr, int ns) {
  return dim3((nr + kRows - 1) / kRows, num_chunks(ns));
}

// Floats of scratch a launch needs: kComp per row and source chunk.
inline long long scratch_floats(int nr, int ns, int kComp) {
  return static_cast<long long>(kComp) * num_chunks(ns) * nr;
}

// The end of pass 1, called by every thread of the block with its kComp
// sums v: the kLanes sums of row r added in lane order by kComp warps, and
// stored to part[(c * kComp + component) * nr + i] for a live row.
template <int kComp>
__device__ __forceinline__ void store_partials(
    float (&red)[kLanes][kComp][kRows], const float* v, int lane, int r,
    bool live, int c, int nr, int i, float* __restrict__ part) {
  static_assert(kComp <= kLanes, "one warp per component");
#pragma unroll
  for (int k = 0; k < kComp; ++k) red[lane][k][r] = v[k];
  __syncthreads();
  if (lane < kComp && live) {
    float t = red[0][lane][r];
#pragma unroll
    for (int l = 1; l < kLanes; ++l) t += red[l][lane][r];
    part[(static_cast<long long>(c) * kComp + lane) * nr + i] = t;
  }
}

template <int kComp, bool COMP, bool NEG_TAIL>
__global__ void reduce(const float* __restrict__ part, int nr, int nchunks,
                       float* __restrict__ acc, float* __restrict__ tail) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= static_cast<long long>(kComp) * nr) return;
  const int k = static_cast<int>(t / nr);
  const int i = static_cast<int>(t % nr);
  float s = 0.f, comp = 0.f;
#pragma unroll 8
  for (int c = 0; c < nchunks; ++c) {
    const float p = part[(static_cast<long long>(c) * kComp + k) * nr + i];
    if (COMP)
      kahan_add(s, comp, p);
    else
      s += p;
  }
  if (k < 3)
    acc[3 * i + k] = s;
  else
    tail[static_cast<long long>(kComp - 3) * i + (k - 3)] = NEG_TAIL ? -s : s;
}

// Pass 2's launch on stream s, after pass 1 wrote part.
template <int kComp, bool COMP, bool NEG_TAIL>
void launch_reduce(const float* part, int nr, int ns, float* acc,
                   float* tail, cudaStream_t s) {
  constexpr int kReduceThreads = 256;
  const long long work = static_cast<long long>(kComp) * nr;
  const int blocks = static_cast<int>((work + kReduceThreads - 1) /
                                      kReduceThreads);
  reduce<kComp, COMP, NEG_TAIL><<<blocks, kReduceThreads, 0, s>>>(
      part, nr, num_chunks(ns), acc, tail);
}

// The ring steps' pass 2 (K20, K21): the oc_nbody_tpu/ops/pallas_gravity.py
// _accumulate_t of one ring step. One thread per (row, component) sums the
// step's chunk partials in chunk order, in plain f32 (a step's sum, like
// the TPU sweep's sum over its source tiles, is not compensated), negates
// the tail with NEG_TAIL, and then either stores the step sum and zeroes the
// compensation (first: the evaluation's first step; comp may be null when
// the evaluation has one step) or adds it into (out, comp) by a Kahan step.
// out and comp live in device memory across the launches of one
// evaluation; each launch reads and writes its own rows only.
template <int kComp, bool NEG_TAIL>
__global__ void accumulate(const float* __restrict__ part, int nr,
                           int nchunks, int first, float* __restrict__ acc,
                           float* __restrict__ acc_comp,
                           float* __restrict__ tail,
                           float* __restrict__ tail_comp) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= static_cast<long long>(kComp) * nr) return;
  const int k = static_cast<int>(t / nr);
  const int i = static_cast<int>(t % nr);
  float s = 0.f;
#pragma unroll 8
  for (int c = 0; c < nchunks; ++c)
    s += part[(static_cast<long long>(c) * kComp + k) * nr + i];
  float* out = acc;
  float* comp = acc_comp;
  long long o = 3LL * i + k;
  if (k >= 3) {
    out = tail;
    comp = tail_comp;
    o = static_cast<long long>(kComp - 3) * i + (k - 3);
    if (NEG_TAIL) s = -s;
  }
  if (first) {
    out[o] = s;
    if (comp != nullptr) comp[o] = 0.f;
  } else {
    float sum = out[o], c = comp[o];
    kahan_add(sum, c, s);
    out[o] = sum;
    comp[o] = c;
  }
}

// The ring's pass 2 on stream s, after pass 1 wrote part.
template <int kComp, bool NEG_TAIL>
void launch_accumulate(const float* part, int nr, int ns, int first,
                       float* acc, float* acc_comp, float* tail,
                       float* tail_comp, cudaStream_t s) {
  constexpr int kReduceThreads = 256;
  const long long work = static_cast<long long>(kComp) * nr;
  const int blocks = static_cast<int>((work + kReduceThreads - 1) /
                                      kReduceThreads);
  accumulate<kComp, NEG_TAIL><<<blocks, kReduceThreads, 0, s>>>(
      part, nr, num_chunks(ns), first, acc, acc_comp, tail, tail_comp);
}

}  // namespace split
}  // namespace
}  // namespace ocn
