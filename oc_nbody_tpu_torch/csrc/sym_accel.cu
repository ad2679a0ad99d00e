// K2: pair-symmetric softened self-gravity of N particles, with an
// optional potential output. Each unordered pair {i, j} is computed once:
// the action goes to row i and the reaction (-G m_i d inv^3, and
// -G m_i inv for the potential) to row j.
//
// Replaces the TPU triangle sweep _make_sym_kernel with _pair_accel (_OP_A)
// and _pair_phi (_OP_P) (oc_nbody_tpu/ops/pallas_pair.py:256, launched by
// _sym_call at :353 via accel_sym and accel_potential_sym,
// oc_nbody_tpu/ops/pallas_gravity.py:1736 and :1749).
//
// Bound on the card: about 25 f32 flops and one rsqrtf per pair (half the
// rsqrtf of K1 on the same N), plus three 16-byte shared-memory accesses
// per pair (source read, reaction read and write). Device memory is touched
// only by the partials below. So the kernel is bound by the FMA pipe and
// shared-memory bandwidth together.
//
// On the TPU the grid runs in order and each reaction is a sequential
// read-modify-write of the resident output. Here blocks run in parallel and
// the sum must be bitwise reproducible from run to run, so there are no
// float atomics; the reduction is two passes in a fixed order:
//
//  * sym_tiles: one block of T threads per tile pair (I, J), I <= J. Thread
//    r owns row I*T + r in registers. Off the diagonal it sweeps tile J on a
//    rotating diagonal, column (r + k) mod T at step k, so the 32 lanes of a
//    warp touch 32 distinct columns in a step. Each warp keeps its own
//    reaction accumulators in shared memory and __syncwarp orders the steps.
//    A diagonal tile (I == J) adds to rows only, every pair in both
//    directions, as on the TPU (pallas_pair.py:259-260): the self pair adds
//    nothing to the acceleration and the softened self term -G m/eps to the
//    potential, which the wrapper removes with self_phi.
//    The block writes its row partial to scratch[I][J] and, off the
//    diagonal, the sum of its warps' reaction partials, taken in warp order,
//    to scratch[J][I].
//  * sym_reduce: row r of tile X sums scratch[X][P][r] for P = 0 .. nt-1 in
//    that order.
//
// Scratch is nt x nt x T float4, i.e. 16 N nt bytes: 0.54 GB at N = 65,536
// and 8.6 GB at N = 262,144 with T = 128. Every slot a row of the output
// reads is written exactly once per call, so scratch needs no clearing.
// N need not be a multiple of T: pairs whose row or column lies past N are
// masked, and nothing is padded.

#include "pair.cuh"

namespace {

constexpr int T = 128;
constexpr int kWarps = T / 32;
static_assert((T & (T - 1)) == 0, "the rotating diagonal needs T = 2^k");

// First linear block index of row I of the upper triangle of tile pairs,
// whose rows hold J = I .. nt-1.
__device__ __forceinline__ long long triangle_start(long long I, int nt) {
  return I * nt - I * (I - 1) / 2;
}

// Linear block index b -> tile pair (I, J) with I <= J.
__device__ __forceinline__ void tile_pair(long long b, int nt, int& I,
                                          int& J) {
  const double a = 2.0 * nt + 1.0;
  int i = static_cast<int>(0.5 * (a - sqrt(a * a - 8.0 * static_cast<double>(b))));
  i = max(0, min(i, nt - 1));
  while (i > 0 && triangle_start(i, nt) > b) --i;
  while (i + 1 < nt && triangle_start(i + 1, nt) <= b) ++i;
  I = i;
  J = i + static_cast<int>(b - triangle_start(i, nt));
}

template <bool WITH_PHI, bool GUARDED>
__device__ __forceinline__ void sym_pair(float4 s, float xi, float yi,
                                         float zi, float gmi, float eps2,
                                         float& ax, float& ay, float& az,
                                         float& ph, float4& col) {
  const float dx = s.x - xi, dy = s.y - yi, dz = s.z - zi;
  const float u = dx * dx + dy * dy + dz * dz + eps2;
  const float inv = ocn::inv_r<GUARDED>(u);
  const float inv2 = inv * inv;
  const float gjinv = s.w * inv;
  const float giinv = gmi * inv;
  const float w = gjinv * inv2;
  const float wi = giinv * inv2;
  ax += w * dx;
  ay += w * dy;
  az += w * dz;
  col.x -= wi * dx;
  col.y -= wi * dy;
  col.z -= wi * dz;
  if (WITH_PHI) {
    ph += gjinv;
    col.w -= giinv;
  }
}

template <bool WITH_PHI, bool GUARDED>
__global__ void __launch_bounds__(T)
    sym_tiles(const float* __restrict__ pos, const float* __restrict__ mass,
              int n, int nt, float G, float eps2,
              float4* __restrict__ scratch) {
  __shared__ float4 src[T];
  __shared__ float4 col[kWarps][T];
  int I, J;
  tile_pair(blockIdx.x, nt, I, J);
  const int r = threadIdx.x;
  const int i = I * T + r;
  const bool row_ok = i < n;
  float xi = 0.f, yi = 0.f, zi = 0.f, gmi = 0.f;
  if (row_ok) {
    xi = pos[3 * i];
    yi = pos[3 * i + 1];
    zi = pos[3 * i + 2];
    gmi = G * mass[i];
  }
  const int j = J * T + r;
  src[r] = j < n ? make_float4(pos[3 * j], pos[3 * j + 1], pos[3 * j + 2],
                               G * mass[j])
                 : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) col[w][r] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const int ncol = min(T, n - J * T);  // live columns of tile J
  float ax = 0.f, ay = 0.f, az = 0.f, ph = 0.f;
  if (I == J) {
    if (row_ok)
      for (int k = 0; k < ncol; ++k)
        ocn::row_pair<WITH_PHI, GUARDED>(src[k], xi, yi, zi, eps2, ax, ay, az,
                                         ph);
  } else {
    // tile I < J <= nt-1 is never the ragged last tile: every row is live
    float4* mine = col[r >> 5];
#pragma unroll 4
    for (int k = 0; k < T; ++k) {
      const int c = (r + k) & (T - 1);
      if (c < ncol) {
        float4 a = mine[c];
        sym_pair<WITH_PHI, GUARDED>(src[c], xi, yi, zi, gmi, eps2, ax, ay, az,
                                    ph, a);
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
__global__ void sym_reduce(const float4* __restrict__ scratch, int n, int nt,
                           float* __restrict__ acc, float* __restrict__ phi) {
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
void launch(const float* pos, const float* mass, int n, float G, float eps2,
            float4* scratch, float* acc, float* phi, cudaStream_t stream) {
  const int nt = (n + T - 1) / T;
  const long long pairs = static_cast<long long>(nt) * (nt + 1) / 2;
  sym_tiles<WITH_PHI, GUARDED><<<static_cast<unsigned>(pairs), T, 0, stream>>>(
      pos, mass, n, nt, G, eps2, scratch);
  constexpr int kReduce = 256;
  sym_reduce<WITH_PHI><<<(n + kReduce - 1) / kReduce, kReduce, 0, stream>>>(
      scratch, n, nt, acc, phi);
}

}  // namespace

// The tile edge T; the caller sizes scratch as nt * nt * T float4 with
// nt = ceil(n / T).
extern "C" int ocn_sym_tile() { return T; }

// pos (n, 3), mass (n,) and acc (n, 3) are contiguous f32 on the device;
// phi (n,) may be null, and then no potential is computed. Returns
// cudaGetLastError() after both launches.
extern "C" int ocn_sym_accel(const float* pos, const float* mass, int n,
                             float G, float eps2, int guarded, void* scratch,
                             float* acc, float* phi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* sc = static_cast<float4*>(scratch);
  if (n > 0) {
    if (phi != nullptr) {
      if (guarded)
        launch<true, true>(pos, mass, n, G, eps2, sc, acc, phi, s);
      else
        launch<true, false>(pos, mass, n, G, eps2, sc, acc, phi, s);
    } else {
      if (guarded)
        launch<false, true>(pos, mass, n, G, eps2, sc, acc, phi, s);
      else
        launch<false, false>(pos, mass, n, G, eps2, sc, acc, phi, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
