// The whole right-looking Cholesky factorization of the (n, n) carry in
// ONE launch, IN PLACE: the port of the Pallas kernel `potrf_full_fused`
// (slate_tpu/ops/pallas_kernels.py:1738, body _potrf_full_fused_kernel
// :1676).  The step body of potrf_step_fused.cu (potrf_step.cuh) for
// k0 = 0, nb, 2·nb, … inside one cooperative grid, a grid barrier between
// steps.  It is the `full` depth of the Cholesky driver
// (slate_tpu_torch/ops/blocks.py:potrf_full): one launch per posv.
//
// What bounds it on an H100: n³/3 fp32 FLOP (1.8e11 at n = 8192) over a
// 0.27 GB carry: bound by operations at ~2.7 ms.  The TPU kernel also
// updates the next block column first ("lookahead") and keeps it resident
// in VMEM, so the next diagonal factor starts without waiting on the
// trailing stream.  Here the steps are separated by grid.sync(), so the
// next diagonal block waits for the whole trailing update either way: the
// kernel has no lookahead, and the per-element arithmetic is the step
// kernel's, so the two depths give the same factor.  Overlapping the
// serial diagonal factor with the trailing tiles (flags per tile column in
// place of the grid barrier) is later work.

#include "potrf_step.cuh"

namespace {

using namespace potrf_step;

__global__ void __launch_bounds__(NTH, 1) potrf_full_fused_kernel(Params p) {
  __shared__ __align__(16) Smem s;
  cg::grid_group grid = cg::this_grid();
  for (int k0 = 0; k0 < p.n; k0 += p.nb) {
    step(s, p, k0, grid);
    grid.sync();
  }
}

}  // namespace

extern "C" int64_t slate_potrf_full_fused_smem_bytes() { return (int64_t)sizeof(Smem); }

extern "C" int slate_potrf_full_fused_plan(int* G) {
  return plan_grid((const void*)potrf_full_fused_kernel, G);
}

// As slate_potrf_step_fused_f32, for every k0.
extern "C" int slate_potrf_full_fused_f32(float* a, int64_t ld, float* lkk,
                                          float* linv, float* w, float* l21,
                                          int n, int nb, int tc, int G,
                                          cudaStream_t stream) {
  Params p{a, ld, lkk, linv, w, l21, n, nb, tc};
  if (!shape_ok(p) || G < 1) return (int)cudaErrorInvalidValue;
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)potrf_full_fused_kernel, dim3(G), dim3(NTH), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
