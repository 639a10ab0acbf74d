// One whole right-looking Cholesky step on the (n, n) carry, IN PLACE: the
// port of the Pallas kernel `potrf_step_fused`
// (slate_tpu/ops/pallas_kernels.py:1631, body _potrf_step_fused_kernel
// :1604, phases _potrf_panel_phase :1542 and _potrf_trailing_stream :1574).
// The diagonal block's chol + inverse, L21 = A21·L11⁻ᵀ and the symmetric
// rank-nb update of the trailing lower tile pairs in one launch, k0 a
// run-time argument.  It is the `fused` depth of the Cholesky driver
// (slate_tpu_torch/ops/blocks.py:potrf_steps): nb = 512 at n = 8192, 16
// launches per posv.  The step body is potrf_step.cuh.
//
// What bounds it on an H100: at k0 = 0, n = 8192, nb = 512 the step does
// ~3.6e10 fp32 FLOP (the trailing update 3.2e10 of it) over ~0.27 GB of
// carry read and written: bound by operations at ~0.54 ms.  The TPU kernel
// keeps the (n, nb) column in VMEM and streams the trailing tiles through a
// double buffer; here one cooperative grid of 1024-thread blocks, one per
// SM, runs every phase: the diagonal block on one block (the rest wait at
// the grid barrier: the serial part, ~1.9 ms at nb = 512 for
// tri_panel.cuh's chol_inv_block on one SM), then L21 and the trailing tiles as 128 × 128
// block_gemm work units (4 × 4 FFMA register blocks, K = nb) spread over
// the grid.  No library call; FFMA only (TF32 fails the residual gates).

#include "potrf_step.cuh"

namespace {

using namespace potrf_step;

__global__ void __launch_bounds__(NTH, 1) potrf_step_fused_kernel(Params p, int k0) {
  __shared__ __align__(16) Smem s;
  cg::grid_group grid = cg::this_grid();
  step(s, p, k0, grid);
}

}  // namespace

// Static shared memory of one block (ops/smem.py checks its formula
// against this when the library loads).
extern "C" int64_t slate_potrf_step_fused_smem_bytes() { return (int64_t)sizeof(Smem); }

extern "C" int slate_potrf_step_fused_plan(int* G) {
  return plan_grid((const void*)potrf_step_fused_kernel, G);
}

// a: (n, n) carry with row stride ld, updated in place.  lkk, linv: (nb,
// nb) scratch; w: max((nb/2)², nb·32) floats; l21: (n - nb)·nb floats (at
// least one float).  k0 a multiple of nb below n.  G from the plan.
extern "C" int slate_potrf_step_fused_f32(float* a, int64_t ld, float* lkk,
                                          float* linv, float* w, float* l21,
                                          int n, int nb, int tc, int k0, int G,
                                          cudaStream_t stream) {
  Params p{a, ld, lkk, linv, w, l21, n, nb, tc};
  if (!shape_ok(p) || k0 < 0 || k0 % nb != 0 || k0 >= n || G < 1)
    return (int)cudaErrorInvalidValue;
  void* args[] = {&p, &k0};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)potrf_step_fused_kernel, dim3(G), dim3(NTH), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
