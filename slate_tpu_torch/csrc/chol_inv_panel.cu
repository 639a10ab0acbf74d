// (L, L⁻¹) of an (nb, nb) SPD block in one launch: the port of the Pallas
// kernel `chol_inv_panel` (slate_tpu/ops/pallas_kernels.py:282-414:
// _chol_unblocked, _trtri_unblocked, _block_inv_doubling,
// _chol_inv_kernel).  Same blocked algorithm, ib = 32: per inner block an
// unblocked Cholesky and a forward-substitution inverse, L21 = A21·B⁻ᵀ,
// the trailing update, then the recursive-doubling inverse.  Its callers
// are the composed Cholesky step (posv), the CholQR² panel of geqrf and its
// guard, and hegv's factor of B.
//
// What bounds it on an H100: ~2/3·nb³ FLOP (8.9e7 at nb = 512) over 2.6 MB
// of inputs and outputs, a few microseconds at the card's fp32 peak; but the
// algorithm is a chain of nb/32 dependent steps, each starting from a
// 32 × 32 factorization, that the TPU ran inside one core's VMEM.  Latency
// bounds it: the chain's length and a grid barrier a step.  So one
// cooperative grid of 256-thread blocks runs tri_grid.cuh's chol_inv_grid
// over the card: block 0 factors each diagonal block (the Cholesky on one
// warp in registers, its inverse on another one column behind) as soon as
// its last update is done, the trailing 32 × 32 tiles of a step go over
// the other blocks, and the doubling's tiles over all of them;
// nb/32 + 2·log2(nb/32) − 1 grid barriers in all.  The rounding is that of
// the reference's blocked algorithm (potrf_batched.cu's, one block a
// problem).  Every global read is
// __ldcg (other blocks wrote the data in the launch).  FFMA in full fp32;
// no library call.
//
// Reads only the lower triangle of A: the strip driver leaves stale
// values above the diagonal block (slate_tpu/ops/blocks.py:566-569).

#include "tri_grid.cuh"

namespace {

using namespace tri_grid;

// One block an SM: the widest phase at nb = 512 has 120 tiles, and at two
// (128 registers) the 32 × 32 factor spills.
__global__ void __launch_bounds__(NTH, 1)
chol_inv_panel_kernel(const float* A, int64_t lda, float* L, float* Linv,
                      float* W, int nb) {
  __shared__ __align__(16) float sm[SMEM_FLOATS];
  cg::grid_group grid = cg::this_grid();
  chol_inv_grid(sm, grid, A, lda, L, Linv, W, nb);
}

}  // namespace

// The grid for nb: co-resident blocks, capped at the widest phase's tiles
// (the first step's lower trailing tiles or the last doubling level's).
extern "C" int slate_chol_inv_panel_plan(int nb, int* G) {
  return plan_grid((const void*)chol_inv_panel_kernel, chol_inv_grid_tiles(nb), G);
}

// A: (nb, nb) with row stride lda, only its lower triangle is read.
// L, Linv: contiguous (nb, nb) outputs.  W: scratch of nb² floats.  nb a
// power of two ≥ 32.  G from the plan.
extern "C" int slate_chol_inv_panel_f32(const float* A, int64_t lda, float* L,
                                        float* Linv, float* W, int nb, int G,
                                        cudaStream_t stream) {
  if (nb < IB || (nb & (nb - 1)) != 0 || lda < nb || G < 1)
    return (int)cudaErrorInvalidValue;
  void* args[] = {&A, &lda, &L, &Linv, &W, &nb};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)chol_inv_panel_kernel, dim3(G), dim3(NTH), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
