// The 2-D elementwise geometry shared by tz.cu, geadd.cu and
// gescale_row_col.cu: one 256-thread block owns a 32-column × 32-row
// patch of a row-major (m, n) matrix, threadIdx.x walks the 32 columns
// (one 128-byte line a warp in fp32) and each of the 8 thread rows takes
// 4 of the patch's rows.  The Pallas kernels' (bm, bn) BlockSpec tiles
// become this patch; the edges are masked here, so any (m, n) runs.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tile2d {

constexpr int TX = 32, TY = 8, ROWS = 32;

inline dim3 grid(int m, int n) {
  return dim3((unsigned)((n + TX - 1) / TX), (unsigned)((m + ROWS - 1) / ROWS));
}

inline dim3 block() { return dim3(TX, TY); }

// Calls f(i, j, i * n + j) for every element of this thread's patch rows.
template <typename F>
__device__ __forceinline__ void for_each(int m, int n, F f) {
  const int j = blockIdx.x * TX + threadIdx.x;
  if (j >= n) return;
#pragma unroll
  for (int r = 0; r < ROWS; r += TY) {
    const int i = blockIdx.y * ROWS + r + threadIdx.y;
    if (i < m) f(i, j, (int64_t)i * n + j);
  }
}

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

inline bool valid(int m, int n) {
  return m > 0 && n > 0 && (m + ROWS - 1) / ROWS <= 65535;
}

}  // namespace tile2d
