// Set or scale the stored triangle of an (m, n) matrix, with a distinct
// diagonal value: the port of the Pallas kernels `tzset` and `tzscale`
// (slate_tpu/ops/pallas_kernels.py:193-224, both through `_tz_call` and
// `_tz_kernel`, whose triangle masks come from iota on global indices).
//   set:   out = diag on i == j, offdiag in the strict stored triangle,
//          a elsewhere (the other triangle is kept);
//   scale: out = a·diag on i == j, a·offdiag in the strict stored
//          triangle, a elsewhere.
// Lower stores i >= j, upper i <= j; on a non-square matrix the
// diagonal ends at min(m, n).  Out of place, as the Pallas kernel.
//
// What bounds it on an H100: bytes.  scale reads and writes m·n
// elements; set reads only the kept triangle (the load sits in the branch
// that keeps it) and writes m·n.  No FLOP worth counting.  The products
// are __fmul_rn/__dmul_rn so that nvcc cannot fold them into anything
// else: the kernel equals its plain version bitwise.

#include "tile2d.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256)
tz_kernel(const T* __restrict__ a, T* __restrict__ out, int m, int n,
          int lower, int scale, T offdiag, T diag) {
  tile2d::for_each(m, n, [&](int i, int j, int64_t e) {
    const bool on_diag = i == j;
    const bool in_tri = lower ? (i >= j) : (i <= j);
    if (scale) {
      const T v = a[e];
      out[e] = on_diag ? tile2d::mul_rn(v, diag)
                       : (in_tri ? tile2d::mul_rn(v, offdiag) : v);
    } else {
      out[e] = on_diag ? diag : (in_tri ? offdiag : a[e]);
    }
  });
}

template <typename T>
int launch(const T* a, T* out, int m, int n, int lower, int scale,
           double offdiag, double diag, cudaStream_t stream) {
  if (!tile2d::valid(m, n)) return (int)cudaErrorInvalidValue;
  tz_kernel<T><<<tile2d::grid(m, n), tile2d::block(), 0, stream>>>(
      a, out, m, n, lower, scale, (T)offdiag, (T)diag);
  return (int)cudaGetLastError();
}

}  // namespace

// a, out: (m, n) contiguous, row-major.  scale = 0 sets, 1 scales.
// offdiag and diag are rounded to the element type here.
extern "C" int slate_tz_f32(const float* a, float* out, int m, int n,
                            int lower, int scale, double offdiag, double diag,
                            cudaStream_t stream) {
  return launch<float>(a, out, m, n, lower, scale, offdiag, diag, stream);
}

extern "C" int slate_tz_f64(const double* a, double* out, int m, int n,
                            int lower, int scale, double offdiag, double diag,
                            cudaStream_t stream) {
  return launch<double>(a, out, m, n, lower, scale, offdiag, diag, stream);
}
