// The whole right-looking Cholesky factorization of the (n, n) carry in
// ONE launch, IN PLACE: the port of the Pallas kernel `potrf_full_fused`
// (slate_tpu/ops/pallas_kernels.py:1738, body _potrf_full_fused_kernel
// :1676, phases _potrf_panel_phase and _potrf_trailing_stream :1542-1601).
// It is the `full` depth of the Cholesky driver
// (slate_tpu_torch/ops/blocks.py:potrf_full): one launch per posv.
//
// The function is the chain of potrf_step_fused.cu's steps for k0 = 0, nb,
// 2·nb, …, and it runs that kernel's device code (potrf_grid.cuh) at each
// k0, so the two depths give the same factor, bit for bit.
//
// What bounds it on an H100: n³/3 fp32 FLOP (1.8e11 at n = 8192) over a
// 0.27 GB carry: bound by operations at ~2.7 ms.  Each step is
// potrf_grid.cuh's three phases of one cooperative grid of 256-thread
// blocks, one an SM: (A) the diagonal block by the whole grid
// (tri_grid.cuh's chol_inv_grid), (B) L21 on 128 × 128 tile_gemm tiles,
// (C) the trailing update on the same tiles, block column k + 1's first;
// a grid barrier follows each.  Overlapping the next diagonal factor with
// the rest of the update (flags per tile column in place of the grid
// barrier) is later work.

#include "potrf_grid.cuh"

namespace {

using namespace potrf_grid;

__global__ void __launch_bounds__(NTH, 1) potrf_full_fused_kernel(Params p) {
  __shared__ __align__(16) float sm[SMEM_FLOATS];
  cg::grid_group grid = cg::this_grid();
  for (int k0 = 0; k0 < p.n; k0 += p.nb) {
    step(sm, grid, p, k0);
    if (k0 + p.nb < p.n) {
      grid.sync();
    }
  }
}

}  // namespace

// Static shared memory of one block (ops/smem.py checks its formula
// against this when the library loads).
extern "C" int64_t slate_potrf_full_fused_smem_bytes() {
  return (int64_t)sizeof(float) * SMEM_FLOATS;
}

// The grid for (n, nb, tc), as the step kernel's (potrf_grid.cuh plan).
extern "C" int slate_potrf_full_fused_plan(int n, int nb, int tc, int* G) {
  return plan((const void*)potrf_full_fused_kernel, n, nb, tc, G);
}

// a: (n, n) carry with row stride ld, updated in place.  lkk, linv: (nb,
// nb) scratch; s: nb² floats; l21: (n - nb)·nb floats (at least one
// float).  G from the plan.
extern "C" int slate_potrf_full_fused_f32(float* a, int64_t ld, float* lkk,
                                          float* linv, float* s, float* l21,
                                          int n, int nb, int tc, int G,
                                          cudaStream_t stream) {
  Params p{a, ld, lkk, linv, s, l21, n, nb, tc};
  if (!shape_ok(p) || G < 1) return (int)cudaErrorInvalidValue;
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)potrf_full_fused_kernel, dim3(G), dim3(NTH), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
