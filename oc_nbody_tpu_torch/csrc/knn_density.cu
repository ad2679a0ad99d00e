// K22: the Casertano & Hut (1985) k-th-nearest-neighbour sweep behind the
// diagnostics row's CH85 core (diagnostics.local_density): for each probe,
// the k-th smallest distinct positive squared distance to the sources
// (rk2) and the summed mass of the sources at the k - 1 smaller distinct
// distances (mnb).
//
// Replaces no TPU kernel: the JAX package computes CH85 as one jitted
// jnp program (oc_nbody_tpu/diagnostics.py:local_density), which XLA fuses
// on the TPU. Eager PyTorch cannot fuse it, and its chunk loop (256 probes
// a chunk, a 256 x S d² matrix in device memory and k + 1 passes over it,
// ~22 launches a chunk) took ~385 ms of the north star's ~400 ms row at
// 65,536 probes and sources. The loop stays as the plain twin
// (ops/cuda_knn.py:knn_density_plain), and this kernel gives its rk2 bits.
//
// Bound on the card: issue rate. A pair is three subtractions, three
// multiplications, two additions and one compare (9 FP32 instructions and
// a predicated branch), ~10 instructions: 65,536² pairs are ~1.3 ms at 132
// SMs x 128 lanes x 1.98 GHz. A source is one 16-byte broadcast read from
// shared memory; device memory is touched once per probe and per source
// tile. A probe keeps its k slots in registers, so the compare against the
// k-th slot rejects almost every pair: a probe inserts about
// k (1 + ln(n / k)) times in a sweep of n sources (~62 at 65,536). An
// insertion (~45 instructions, branch-free over the k slots) diverges
// within the warp, which is what holds the kernel above its bound.
//
// Design: one probe a thread (its coordinates and 2 k slots in registers,
// 32 in all), 128 threads a block, one block sweeping every source, which
// is staged tile by tile in shared memory as float4 (x, y, z, stride-scaled
// mass). R probes a thread, as in K2, came out slower here (65,536² on an
// H100 80GB HBM3 at 700 W: 6.1 ms at R = 4, 3.1 at R = 2, 2.9 at R = 1
// with the sources split in two): the R insertions of a thread run one
// after the other, and the registers of 4 probes spill. 65,536 probes are
// 512 blocks, four to an SM; splitting the sources over blocks to fill the
// card further, with a merge of the per-split slots, took 2.8 ms against
// 3.7 for one sweep a probe: under a millisecond a diagnostics row, so the
// kernel keeps the one sweep. No atomics and no host syncs, so two launches
// give the same bits; rk2 is exact (a minimum), and mnb's f32 additions run
// in source order within each slot, then over the slots.
//
// The distance is the plain twin's to the bit: torch computes
// sum((p - s) ** 2, dim=-1), and on the card its reduction over the three
// terms adds (dx² + dz²) + dy² (two threads a row: x and z on one, y on
// the other, then one shuffle; verified against the twin on the card). The
// _rn intrinsics keep nvcc from contracting any of it into an FMA.
//
// Tie semantics, exactly the twin's k threshold passes (the JAX package's):
// d² <= 0 (self and coincident pairs) counts as +inf; equal f32 distances
// collapse to one rank and all their masses count. A probe keeps k sorted
// slots of (distinct d², summed mass), +inf and 0 at the start; a source at
// a slot's value adds its mass there, a smaller new value is inserted and
// the last slot falls out with its mass. rk2 = slot k - 1, mnb = slots 0 ..
// k - 2. With fewer than k distinct positive distances the +inf slot holds
// the masses of the excluded pairs, so mnb is every source's mass when
// even slot k - 2 is +inf, as the twin's `d2 <= inf` mask gives.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;    // threads a block, one probe each
constexpr int kTile = kThreads;  // sources a shared tile, one a thread

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// Slots d (ascending, distinct but for +inf) and their masses w; v <= d[K-1].
template <int K>
__device__ __forceinline__ void insert(float (&d)[K], float (&w)[K], float v,
                                       float m) {
  bool done = false;
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (!done && v == d[j]) {
      w[j] += m;
      done = true;
    }
  if (done) return;
  // v < d[K-1]: shift the slots above v up by one, put v at its place
#pragma unroll
  for (int j = K - 1; j > 0; --j) {
    const bool shift = v < d[j - 1];
    const bool place = !shift && v < d[j];
    d[j] = shift ? d[j - 1] : (place ? v : d[j]);
    w[j] = shift ? w[j - 1] : (place ? m : w[j]);
  }
  if (v < d[0]) {
    d[0] = v;
    w[0] = m;
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    knn_sweep(const float* __restrict__ probes, int np,
              const float4* __restrict__ src, int ns,
              float* __restrict__ rk2, float* __restrict__ mnb) {
  __shared__ float4 tile[kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < np;
  const float px = live ? probes[3 * i] : 0.f;
  const float py = live ? probes[3 * i + 1] : 0.f;
  const float pz = live ? probes[3 * i + 2] : 0.f;
  float d[K], w[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    d[j] = inf();
    w[j] = 0.f;
  }
  auto visit = [&](const float4 s) {
    const float dx = __fsub_rn(px, s.x);
    const float dy = __fsub_rn(py, s.y);
    const float dz = __fsub_rn(pz, s.z);
    const float d2 = __fadd_rn(
        __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dz, dz)), __fmul_rn(dy, dy));
    if (d2 <= d[K - 1]) {  // rare once the slots fill
      const float v = d2 > 0.f ? d2 : inf();
      if (v <= d[K - 1]) insert<K>(d, w, v, s.w);
    }
  };
  for (int j0 = 0; j0 < ns; j0 += kTile) {
    const int j = j0 + threadIdx.x;
    if (j < ns) tile[threadIdx.x] = src[j];
    __syncthreads();
    const int m = min(kTile, ns - j0);
    if (m == kTile) {
#pragma unroll 8
      for (int t = 0; t < kTile; ++t) visit(tile[t]);
    } else {
      for (int t = 0; t < m; ++t) visit(tile[t]);
    }
    __syncthreads();
  }
  if (!live) return;
  float s = w[0];
#pragma unroll
  for (int j = 1; j < K - 1; ++j) s += w[j];
  rk2[i] = d[K - 1];
  mnb[i] = s;
}

}  // namespace

// probes (np, 3) and src (ns, 4: x, y, z, mass) are contiguous f32 on the
// device, centred in one frame; rk2 and mnb (np,) f32 outputs. k = 6 is
// compiled; any other k returns cudaErrorInvalidValue without a launch.
// Returns cudaGetLastError() after the launch.
extern "C" int ocn_knn_density(const float* probes, int np, const float* src,
                               int ns, int k, float* rk2, float* mnb,
                               void* stream) {
  if (k != 6) return static_cast<int>(cudaErrorInvalidValue);
  if (np > 0)
    knn_sweep<6><<<(np + kThreads - 1) / kThreads, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        probes, np, reinterpret_cast<const float4*>(src), ns, rk2, mnb);
  return static_cast<int>(cudaGetLastError());
}
