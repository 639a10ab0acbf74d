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
  chol_inv_block(s, A, lda, L, Linv, W, nb);
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
