// K18: one-sided softened accel, and optionally the pair potential, of a
// few rows from many sources, split over the sources: the second sweep of
// escape pruning (the cluster bucket's rows against every particle) and its
// diagnostics potential. K18<COMP>, its compensated variant, takes rows
// against more than STREAM_N = 262,144 sources, at any row count.
//
// K18 replaces the TPU transposed kernels _accel_kernel_t with its sweep
// _sweep_t_accel and _accel_phi_kernel_t with _sweep_t_phi
// (oc_nbody_tpu/ops/pallas_gravity.py:857, :763, :913, :869; launched by
// accel_rows_t and accel_potential_rows_t at :942, :973), which accel_rows
// and accel_potential_rows take from RT_MIN_ACCEL = 32,768 sources up to
// RT_MAX_ROWS = 65,536 rows (:160-168, :251-256). Those sums are not
// compensated (COMPENSATED_RESIDENT is off, :63-76).
//
// K18<COMP> replaces the TPU streamed kernels _accel_stream_kernel and
// _accel_phi_stream_kernel (pallas_gravity.py:419, :495; launched by
// accel_rows_streamed and accel_potential_rows_streamed at :454, :539),
// which accel_rows and accel_potential_rows take past STREAM_N sources
// (:156-158, :248-250). Those add each source tile's partial to the running
// sum by a Kahan step, on the accel and on the potential (COMPENSATED, on by
// default for the streamed forms). Here, as in K14 (rows_jerk_t.cu), each
// lane sums a stage's 32 sources into a fresh partial and adds it to its
// running sums by a Kahan step, and pass 2 adds the chunk partials by Kahan
// steps (pair.cuh:kahan_add, spelled with __fadd_rn / __fsub_rn so that
// --fmad cannot contract it).
//
// Rows and sources arrive centred in one frame as f32; G m is folded into
// the staged source. The pair arithmetic is pair.cuh:row_pair, the one K1
// runs: 18 f32 flops per pair (19 with the potential; an FMA counts 2) and
// one rsqrtf. The potential keeps the softened self term of a row that is
// also a source; the caller adds self_phi.
//
// Why not K1's layout: the pruned sweep 2 is a few thousand rows against
// all N sources, and K1's one thread per row gives 32 blocks on 132 SMs at
// 4,096 rows (the lesson of K4 against K5).
//
// Design: the source-split layout of rows_split.cuh, which K5 shares. Pass
// 1 stages the chunk as float4(x, y, z, G m); each thread sums its sources
// into its three (four) sums (COMP: into a stage partial, then Kahan into
// its sums); pass 2 stores the potential negated. At ns = 65,536 there are
// 128 chunks of 512, at 1,048,576 128 chunks of 8,192; the scratch is 3 (4)
// x 128 x nr floats, 268 MB at nr = 131,072 with the potential.
//
// The ragged last stage is masked by the loop bound; rows past nr compute
// and store nothing, so no input is padded.

#include "rows_accel_t.cuh"

namespace {

template <bool WITH_PHI, bool GUARDED, bool COMP>
void launch(const float* rows, int nr, const float* src, const float* mass,
            int ns, float G, float eps2, float* part, float* acc, float* phi,
            cudaStream_t s) {
  rows_accel_t_partial<WITH_PHI, GUARDED, COMP>
      <<<ocn::split::partial_grid(nr, ns), kThreads, 0, s>>>(
          rows, nr, src, mass, ns, ocn::split::chunk_size(ns), G, eps2, part);
  ocn::split::launch_reduce<WITH_PHI ? 4 : 3, COMP, true>(part, nr, ns, acc,
                                                          phi, s);
}

template <bool WITH_PHI, bool COMP>
void dispatch_guard(bool guarded, const float* rows, int nr, const float* src,
                    const float* mass, int ns, float G, float eps2,
                    float* part, float* acc, float* phi, cudaStream_t s) {
  if (guarded)
    launch<WITH_PHI, true, COMP>(rows, nr, src, mass, ns, G, eps2, part, acc,
                                 phi, s);
  else
    launch<WITH_PHI, false, COMP>(rows, nr, src, mass, ns, G, eps2, part, acc,
                                  phi, s);
}

}  // namespace

// Floats of scratch the launch needs: three per row and source chunk, four
// with the potential.
extern "C" long long ocn_rows_accel_t_scratch(int nr, int ns, int with_phi) {
  return ocn::split::scratch_floats(nr, ns, with_phi ? 4 : 3);
}

// rows (nr, 3), src (ns, 3), mass (ns,) and acc (nr, 3) are contiguous f32
// on the device; phi (nr,) may be null, and then no potential is computed;
// part holds ocn_rows_accel_t_scratch(nr, ns, phi != null) floats.
// compensated picks K18<COMP> (Kahan steps across stages and chunks) over
// K18. Returns cudaGetLastError() after the launches.
extern "C" int ocn_rows_accel_t(const float* rows, int nr, const float* src,
                                const float* mass, int ns, float G,
                                float eps2, int guarded, int compensated,
                                float* part, float* acc, float* phi,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nr <= 0) return static_cast<int>(cudaGetLastError());
  if (ns <= 0) {
    cudaMemsetAsync(acc, 0, sizeof(float) * 3 * nr, s);
    if (phi != nullptr) cudaMemsetAsync(phi, 0, sizeof(float) * nr, s);
    return static_cast<int>(cudaGetLastError());
  }
  const bool g = guarded != 0;
  if (phi != nullptr) {
    if (compensated)
      dispatch_guard<true, true>(g, rows, nr, src, mass, ns, G, eps2, part,
                                 acc, phi, s);
    else
      dispatch_guard<true, false>(g, rows, nr, src, mass, ns, G, eps2, part,
                                  acc, phi, s);
  } else {
    if (compensated)
      dispatch_guard<false, true>(g, rows, nr, src, mass, ns, G, eps2, part,
                                  acc, phi, s);
    else
      dispatch_guard<false, false>(g, rows, nr, src, mass, ns, G, eps2, part,
                                   acc, phi, s);
  }
  return static_cast<int>(cudaGetLastError());
}
