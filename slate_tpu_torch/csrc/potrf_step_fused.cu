// One whole right-looking Cholesky step on the (n, n) carry, IN PLACE: the
// port of the Pallas kernel `potrf_step_fused`
// (slate_tpu/ops/pallas_kernels.py:1631, body _potrf_step_fused_kernel
// :1604, phases _potrf_panel_phase :1542 and _potrf_trailing_stream :1574).
// The diagonal block's chol + inverse, L21 = A21·L11⁻ᵀ and the symmetric
// rank-nb update of the trailing lower tile pairs in one launch, k0 a
// run-time argument.  It is the `fused` depth of the Cholesky driver
// (slate_tpu_torch/ops/blocks.py:potrf_steps): nb = 512 at n = 8192, 16
// launches per posv.
//
// What bounds it on an H100: at k0 = 0, n = 8192, nb = 512 the step does
// ~3.6e10 fp32 FLOP (the trailing update 3.2e10 of it) over ~0.27 GB of
// carry read and written: bound by operations at ~0.54 ms.  The TPU kernel
// keeps the (n, nb) column in VMEM and streams the trailing tiles through a
// double buffer; here the kernel is ONE step of potrf_full_fused.cu's loop,
// the same device code (potrf_grid.cuh) on the same grid: 256-thread
// blocks, one an SM, the diagonal block factored by the whole grid
// (tri_grid.cuh's chol_inv_grid, a grid barrier a 32-step), then L21 and
// the trailing tiles on 128 × 128 tile_gemm tiles.  So the full kernel's
// launch is bitwise the chain of these launches.  No library call; FFMA
// only (TF32 fails the residual gates).

#include "potrf_grid.cuh"

namespace {

using namespace potrf_grid;

__global__ void __launch_bounds__(NTH, 1) potrf_step_fused_kernel(Params p, int k0) {
  __shared__ __align__(16) float sm[SMEM_FLOATS];
  cg::grid_group grid = cg::this_grid();
  step(sm, grid, p, k0);
}

}  // namespace

// Static shared memory of one block (ops/smem.py checks its formula
// against this when the library loads).
extern "C" int64_t slate_potrf_step_fused_smem_bytes() {
  return (int64_t)sizeof(float) * SMEM_FLOATS;
}

// The grid for (n, nb, tc): the full kernel's, capped at the widest phase's
// tiles at k0 = 0 (potrf_grid.cuh plan).
extern "C" int slate_potrf_step_fused_plan(int n, int nb, int tc, int* G) {
  return plan((const void*)potrf_step_fused_kernel, n, nb, tc, G);
}

// a: (n, n) carry with row stride ld, updated in place.  lkk, linv: (nb,
// nb) scratch; s: nb² floats; l21: (n - nb)·nb floats (at least one
// float).  k0 a multiple of nb below n.  G from the plan.
extern "C" int slate_potrf_step_fused_f32(float* a, int64_t ld, float* lkk,
                                          float* linv, float* s, float* l21,
                                          int n, int nb, int tc, int k0, int G,
                                          cudaStream_t stream) {
  Params p{a, ld, lkk, linv, s, l21, n, nb, tc};
  if (!shape_ok(p) || k0 < 0 || k0 % nb != 0 || k0 >= n || G < 1)
    return (int)cudaErrorInvalidValue;
  void* args[] = {&p, &k0};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)potrf_step_fused_kernel, dim3(G), dim3(NTH), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
