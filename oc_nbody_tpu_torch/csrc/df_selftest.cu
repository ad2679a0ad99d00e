// The df32 tier's arithmetic applied elementwise, so a test can hold the
// device's error-free transforms to exactness: two_sum and two_prod of
// (a, b), and df_rsqrt of the df number (xh, xl), all from df.cuh as K10
// and K11 use them. A kernel whose transforms silently degrade still
// passes every smooth-cluster comparison at 1e-7; this check does not.

#include "df.cuh"

namespace {

__global__ void df_selftest(const float* __restrict__ a,
                            const float* __restrict__ b,
                            const float* __restrict__ xh,
                            const float* __restrict__ xl, int n,
                            float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const ocn::df s = ocn::two_sum(a[i], b[i]);
  const ocn::df p = ocn::two_prod(a[i], b[i]);
  const ocn::df y = ocn::df_rsqrt<false>(ocn::df{xh[i], xl[i]});
  const long long m = n;
  out[i] = s.hi;
  out[m + i] = s.lo;
  out[2 * m + i] = p.hi;
  out[3 * m + i] = p.lo;
  out[4 * m + i] = y.hi;
  out[5 * m + i] = y.lo;
}

}  // namespace

// a, b, xh, xl (n,) and out (6, n) are contiguous f32 on the device. out's
// rows: the sum and its error, the product and its error, the inverse
// square root's hi and lo words. Returns cudaGetLastError().
extern "C" int ocn_df_selftest(const float* a, const float* b, const float* xh,
                               const float* xl, int n, float* out,
                               void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  constexpr int kThreads = 256;
  df_selftest<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(a, b, xh, xl, n, out);
  return static_cast<int>(cudaGetLastError());
}
