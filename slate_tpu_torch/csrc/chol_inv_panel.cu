// (L, L⁻¹) of an (nb, nb) SPD block in one launch: the port of the Pallas
// kernel `chol_inv_panel` (slate_tpu/ops/pallas_kernels.py:282-414:
// _chol_unblocked, _trtri_unblocked, _block_inv_doubling,
// _chol_inv_kernel).  Same blocked algorithm, ib = 32: per inner block an
// unblocked Cholesky and a forward-substitution inverse, L21 = A21·B⁻ᵀ,
// the trailing update, then the recursive-doubling inverse.
//
// What bounds it on an H100: the work is ~2/3·nb³ FLOP (88 MFLOP at
// nb = 512) over 2.6 MB of inputs and outputs, a few microseconds at the
// card's fp32 peak, but the algorithm is a chain of dependent steps that
// the TPU ran inside one core's VMEM.  Here one block of 1024 threads on
// one SM owns the whole panel (see tri_panel.cuh): the bound in practice
// is one SM's FFMA rate and its L2 bandwidth, plus a barrier per phase.
// The design keeps every phase at the block's full width — the 32×32
// unblocked Cholesky and its inverse run in shared memory on one warp
// (no block barriers inside them), and L21, the trailing update and the
// doubling products are 128×128-tiled block_gemm calls with 4×4 register
// blocks.  Spreading a panel over a cluster (distributed shared memory)
// is later work.
//
// Reads only the lower triangle of A: the strip driver leaves stale
// values above the diagonal block (slate_tpu/ops/blocks.py:566-569).

#include "tri_panel.cuh"

namespace {

using namespace tri_panel;

__global__ void __launch_bounds__(NTH, 1)
chol_inv_panel_kernel(const float* A, int64_t lda, float* L, float* Linv,
                      float* W, int nb) {
  __shared__ __align__(16) Smem s;
  const int tid = threadIdx.x;
  const int64_t nn = (int64_t)nb * nb;
  for (int64_t e = tid; e < nn; e += NTH) {
    const int i = (int)(e / nb), j = (int)(e % nb);
    L[e] = (i >= j) ? A[(int64_t)i * lda + j] : 0.f;
    Linv[e] = 0.f;
  }
  __syncthreads();

  for (int k0 = 0; k0 < nb; k0 += IB) {
    float* lkk = L + (int64_t)k0 * nb + k0;
    if (tid < 32) {
      load_lower_block_warp(s, lkk, nb);
      chol_unblocked_warp(s);
      trtri_unblocked_warp(s);
    }
    __syncthreads();
    {
      const int r = tid / IB, c = tid % IB;
      if (r >= c) lkk[(int64_t)r * nb + c] = s.blk[r][c];
      Linv[(int64_t)(k0 + r) * nb + k0 + c] = s.inv[r][c];
    }
    const int m = nb - k0 - IB;
    if (m > 0) {
      float* a21 = L + (int64_t)(k0 + IB) * nb + k0;
      const float* binv = Linv + (int64_t)k0 * nb + k0;
      __syncthreads();
      // W (m, IB) = A21 · Binvᵀ
      block_gemm(s, m, IB, IB, 1.f, a21, nb, 1, false, binv, 1, nb, false,
                 0.f, W, IB, false);
      for (int e = tid; e < m * IB; e += NTH)
        a21[(int64_t)(e / IB) * nb + e % IB] = W[e];
      // A22 -= W · Wᵀ on the lower triangle
      block_gemm(s, m, m, IB, -1.f, W, IB, 1, false, W, 1, IB, false,
                 1.f, L + (int64_t)(k0 + IB) * nb + k0 + IB, nb, true);
    } else {
      __syncthreads();
    }
  }
  block_inv_doubling(s, L, nb, Linv, nb, W, nb);
}

}  // namespace

// A: (nb, nb) with row stride lda, only its lower triangle is read.
// L, Linv: contiguous (nb, nb) outputs.  W: scratch of
// max((nb/2)², nb·32) floats.  nb a power of two ≥ 32.
extern "C" int slate_chol_inv_panel_f32(const float* A, int64_t lda, float* L,
                                        float* Linv, float* W, int nb,
                                        cudaStream_t stream) {
  if (nb < IB || (nb & (nb - 1)) != 0 || lda < nb)
    return (int)cudaErrorInvalidValue;
  chol_inv_panel_kernel<<<1, NTH, 0, stream>>>(A, lda, L, Linv, W, nb);
  return (int)cudaGetLastError();
}
