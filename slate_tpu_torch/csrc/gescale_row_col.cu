// out = diag(r)·A·diag(c): the port of the Pallas kernel
// `gescale_row_col` (slate_tpu/ops/pallas_kernels.py:249-270,
// `_scale_rc_kernel`), out[i, j] = (r[i]·A[i, j])·c[j] in that order.
//
// What bounds it on an H100: bytes, 2·m·n + m + n elements (A read, out
// written, r and c read once; a block reads its 32 entries of c and of r
// through L1).  Both products are rounded on their own
// (__fmul_rn/__dmul_rn), so the kernel equals its plain version bitwise.

#include "tile2d.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256)
gescale_row_col_kernel(const T* __restrict__ r, const T* __restrict__ c,
                       const T* __restrict__ a, T* __restrict__ out, int m,
                       int n) {
  tile2d::for_each(m, n, [&](int i, int j, int64_t e) {
    out[e] = tile2d::mul_rn(tile2d::mul_rn(r[i], a[e]), c[j]);
  });
}

template <typename T>
int launch(const T* r, const T* c, const T* a, T* out, int m, int n,
           cudaStream_t stream) {
  if (!tile2d::valid(m, n)) return (int)cudaErrorInvalidValue;
  gescale_row_col_kernel<T><<<tile2d::grid(m, n), tile2d::block(), 0,
                              stream>>>(r, c, a, out, m, n);
  return (int)cudaGetLastError();
}

}  // namespace

// r: (m,), c: (n,), a and out: (m, n) contiguous, row-major, one dtype.
extern "C" int slate_gescale_row_col_f32(const float* r, const float* c,
                                         const float* a, float* out, int m,
                                         int n, cudaStream_t stream) {
  return launch<float>(r, c, a, out, m, n, stream);
}

extern "C" int slate_gescale_row_col_f64(const double* r, const double* c,
                                         const double* a, double* out, int m,
                                         int n, cudaStream_t stream) {
  return launch<double>(r, c, a, out, m, n, stream);
}
