// B lower Cholesky factors in one launch: the port of the Pallas kernel
// `potrf_batched` (slate_tpu/ops/pallas_kernels.py:2288-2343:
// _chol_blocked_value, _potrf_batched_kernel).  Same blocked algorithm per
// problem, ib = 32: an unblocked Cholesky of the diagonal block and its
// forward-substitution inverse B⁻¹, L21 = A21·B⁻ᵀ, the rank-32 trailing
// update, and the upper triangle zeroed.
//
// What bounds it on an H100: at B = 64, n = 256 the batch moves 25.2 MB
// (each input's lower triangle read, each factor written whole) and does
// 3.6e8 FLOP, ~0.0075 ms at the card's memory rate, but each problem is a
// chain of n/32 dependent steps.  The TPU
// kernel keeps whole problems in VMEM; one fp32 problem at n = 256 is
// 256 KB, more than a block's 227 KB of shared memory.  So ONE BLOCK OF
// 1024 THREADS OWNS ONE PROBLEM and works from its output buffer in device
// memory, which L2 holds (64 problems × 256 KB = 16 MB of the 50 MB L2),
// with the phases of the reference's _chol_blocked_value: the 32×32
// Cholesky and its inverse on one warp in shared memory, L21 and the
// trailing update as 128×128-tiled block_gemm calls.  The problems run
// side by side on the SMs, with no barrier between blocks; a batch of
// fewer problems than SMs leaves SMs idle.  The trailing-update tiles
// wholly above the diagonal are skipped.  Reads only the lower triangle.

#include "tri_panel.cuh"

namespace {

using namespace tri_panel;

__global__ void __launch_bounds__(NTH, 1)
potrf_batched_kernel(const float* A, float* L, float* W, int n) {
  __shared__ __align__(16) Smem s;
  const int tid = threadIdx.x;
  const int64_t nn = (int64_t)n * n;
  A += blockIdx.x * nn;
  L += blockIdx.x * nn;
  W += blockIdx.x * (int64_t)(n - IB) * IB;
  for (int64_t e = tid; e < nn; e += NTH) {
    const int i = (int)(e / n), j = (int)(e % n);
    L[e] = (i >= j) ? A[e] : 0.f;
  }
  __syncthreads();

  for (int k0 = 0; k0 < n; k0 += IB) {
    float* lkk = L + (int64_t)k0 * n + k0;
    const int m = n - k0 - IB;
    if (tid < 32) {
      load_lower_block_warp(s, lkk, n);
      chol_unblocked_warp(s);
      if (m > 0) trtri_unblocked_warp(s);
    }
    __syncthreads();
    {
      const int r = tid / IB, c = tid % IB;
      if (r >= c) lkk[(int64_t)r * n + c] = s.blk[r][c];
    }
    if (m > 0) {
      float* a21 = L + (int64_t)(k0 + IB) * n + k0;
      __syncthreads();
      // W (m, IB) = A21 · B⁻ᵀ, B⁻¹ read from shared memory
      block_gemm(s, m, IB, IB, 1.f, a21, n, 1, false, &s.inv[0][0], 1, IB + 1,
                 false, 0.f, W, IB, false);
      for (int e = tid; e < m * IB; e += NTH)
        a21[(int64_t)(e / IB) * n + e % IB] = W[e];
      // A22 -= W · Wᵀ on the lower triangle
      block_gemm(s, m, m, IB, -1.f, W, IB, 1, false, W, 1, IB, false, 1.f,
                 a21 + IB, n, true);
    }
  }
}

}  // namespace

// A: (batch, n, n) contiguous, only each problem's lower triangle is read.
// L: (batch, n, n) contiguous output.  W: scratch of batch·(n - 32)·32
// floats.  n a multiple of 32.
extern "C" int slate_potrf_batched_f32(const float* A, float* L, float* W,
                                       int batch, int n, cudaStream_t stream) {
  if (batch < 1 || n < IB || n % IB != 0) return (int)cudaErrorInvalidValue;
  potrf_batched_kernel<<<batch, NTH, 0, stream>>>(A, L, W, n);
  return (int)cudaGetLastError();
}
