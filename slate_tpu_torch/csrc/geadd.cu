// out = α·A + β·B in B's dtype: the port of the Pallas kernel `geadd`
// (slate_tpu/ops/pallas_kernels.py:227-246, `_geadd_kernel`).
//
// What bounds it on an H100: bytes, 3·m·n elements (A and B read, out
// written), two products and one sum an element.  B is read even where
// β = 0, as the Pallas kernel reads it: a NaN or Inf in B stays in the
// result.  Each product and the sum are rounded on their own
// (__fmul_rn/__fadd_rn and the fp64 forms), where nvcc would otherwise
// contract α·a + β·b into an FMA: the kernel equals its plain version,
// which rounds each product, bitwise.

#include "tile2d.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256)
geadd_kernel(T alpha, const T* __restrict__ a, T beta,
             const T* __restrict__ b, T* __restrict__ out, int m, int n) {
  tile2d::for_each(m, n, [&](int, int, int64_t e) {
    out[e] = tile2d::add_rn(tile2d::mul_rn(alpha, a[e]),
                            tile2d::mul_rn(beta, b[e]));
  });
}

template <typename T>
int launch(double alpha, const T* a, double beta, const T* b, T* out, int m,
           int n, cudaStream_t stream) {
  if (!tile2d::valid(m, n)) return (int)cudaErrorInvalidValue;
  geadd_kernel<T><<<tile2d::grid(m, n), tile2d::block(), 0, stream>>>(
      (T)alpha, a, (T)beta, b, out, m, n);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b, out: (m, n) contiguous, row-major, one dtype.  alpha and beta are
// rounded to the element type here.
extern "C" int slate_geadd_f32(double alpha, const float* a, double beta,
                               const float* b, float* out, int m, int n,
                               cudaStream_t stream) {
  return launch<float>(alpha, a, beta, b, out, m, n, stream);
}

extern "C" int slate_geadd_f64(double alpha, const double* a, double beta,
                               const double* b, double* out, int m, int n,
                               cudaStream_t stream) {
  return launch<double>(alpha, a, beta, b, out, m, n, stream);
}
