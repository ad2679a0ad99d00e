// K5: one-sided softened accel + jerk of a few rows from many resident
// sources, split over the sources: the block-timestep active-row
// evaluation, where a micro-step moves a handful to a few thousand of the
// sources. K14, its compensated variant (COMP), takes the same rows past
// STREAM_N = 262,144 sources, at any row count.
//
// K5 replaces the TPU transposed kernel _accel_jerk_kernel_t with its sweep
// _sweep_t_jerk (oc_nbody_tpu/ops/pallas_gravity.py:926, :801; launched by
// accel_jerk_rows_t at :1006). The TPU stored rows transposed to dodge the
// (8, 128) VMEM padding; the card has no such padding, so none of that
// layout is kept. What the card needs is enough blocks when the rows are
// few: K4 (rows_jerk.cu) puts one thread on a row and 128 rows in a block,
// so 64 active rows fill one block on one of 132 SMs.
//
// K14 replaces the TPU streamed kernel _accel_jerk_stream_kernel
// (pallas_gravity.py:586, launched by accel_jerk_rows_streamed at :640),
// which accel_jerk_rows (:350-353) takes past STREAM_N sources: the block
// stepper's active rows at N > 262,144. That kernel streams the sources
// from HBM in tiles of TJ = 2,048 and adds each tile's partial to the
// running sum with a Kahan step (COMPENSATED, :63-76, on by default for the
// streamed forms: the serial sum across 512 tiles at 1M sources is where
// f32 error grows). Here a chunk of sources is 8,192 at 1M (chunk_size), a
// lane sums 1,024 of them, and 128 chunk partials are added, so K14 keeps
// two compensated stages: each lane sums a stage's 32 sources into a fresh
// partial and adds it to its running sum by a Kahan step, and pass 2 adds
// the chunk partials by a Kahan step, in the JAX package's form (y = p - c,
// t = s + y, c = (t - s) - y). The steps are spelled with __fadd_rn and
// __fsub_rn, which nvcc neither contracts nor reorders, as in csrc/df.cuh.
//
// Bound on the card: 41 f32 flops (an FMA counts 2) and one rsqrtf per
// pair, the arithmetic of pair.cuh:row_jerk_pair (K14 adds 24 flops per
// lane and stage of 32 pairs, under one a pair); each source is read once
// per block from device memory (or L2) for 32 rows, and the partial sums
// are 24 bytes per row and chunk, so bytes never bind: the FMA pipe does.
//
// Design: the source-split layout of rows_split.cuh (two passes, no
// atomics, fixed summation order). Pass 1 stages the chunk as float4(x, y,
// z, G m) and float4(vx, vy, vz, 0); each thread sums its sources into its
// six sums (K14: into a stage partial, then Kahan into its sums); pass 2
// adds the chunk partials (K14: by Kahan steps). A row's result does not
// depend on the launch's other rows, so a compacted active set and the
// masked full set agree. At nr = 64 and ns = 32,768 the first pass runs
// 2 x 128 blocks of 256 threads. Past STREAM_N there are 128 chunks and the
// scratch is 6 x 128 x nr floats, 3.2 GB at nr = 1,048,576.
//
// The ragged last stage is masked by the loop bound; rows past nr compute
// and store nothing, so no input is padded.

#include "rows_jerk_t.cuh"

namespace {

template <bool GUARDED, bool COMP>
void launch(const float* rows, const float* vrows, int nr, const float* src,
            const float* svel, const float* mass, int ns, float G, float eps2,
            float* part, float* acc, float* jerk, cudaStream_t s) {
  rows_jerk_t_partial<GUARDED, COMP>
      <<<ocn::split::partial_grid(nr, ns), kThreads, 0, s>>>(
          rows, vrows, nr, src, svel, mass, ns, ocn::split::chunk_size(ns), G,
          eps2, part);
  ocn::split::launch_reduce<6, COMP, false>(part, nr, ns, acc, jerk, s);
}

}  // namespace

// Floats of scratch the launch needs: six per row and source chunk.
extern "C" long long ocn_rows_jerk_t_scratch(int nr, int ns) {
  return ocn::split::scratch_floats(nr, ns, 6);
}

// rows, vrows (nr, 3), src, svel (ns, 3), mass (ns,), acc and jerk (nr, 3)
// are contiguous f32 on the device; part holds ocn_rows_jerk_t_scratch(nr,
// ns) floats. compensated picks K14 (Kahan steps across stages and chunks)
// over K5. Returns cudaGetLastError() after the launches.
extern "C" int ocn_rows_jerk_t(const float* rows, const float* vrows, int nr,
                               const float* src, const float* svel,
                               const float* mass, int ns, float G, float eps2,
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
      launch<true, true>(rows, vrows, nr, src, svel, mass, ns, G, eps2, part,
                         acc, jerk, s);
    else
      launch<false, true>(rows, vrows, nr, src, svel, mass, ns, G, eps2, part,
                          acc, jerk, s);
  } else {
    if (guarded)
      launch<true, false>(rows, vrows, nr, src, svel, mass, ns, G, eps2, part,
                          acc, jerk, s);
    else
      launch<false, false>(rows, vrows, nr, src, svel, mass, ns, G, eps2,
                           part, acc, jerk, s);
  }
  return static_cast<int>(cudaGetLastError());
}
