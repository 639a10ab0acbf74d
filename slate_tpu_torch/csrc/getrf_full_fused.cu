// The whole right-looking partial-pivot LU of the transposed (n_rows, m)
// scattered carry in ONE launch, IN PLACE: the port of the Pallas kernel
// `getrf_full_fused` (slate_tpu/ops/pallas_kernels.py:1481, body
// _getrf_full_fused_kernel :1405).  The step body of getrf_step_fused.cu
// (lu_panel.cuh's panel phase, then lu_step.cuh's trailing phase) for
// k0 = 0, nb, … below min(n_rows, m) inside one cooperative grid, the
// pivots of every step written in factorization order.  It is the `full`
// depth of the scattered LU driver (slate_tpu_torch/linalg/lu.py:
// getrf_scattered): one launch per gesv.
//
// What bounds it on an H100: 2n³/3 fp32 FLOP (3.7e11 at n = 8192) over a
// 0.54 GB carry: bound by operations at ~5.5 ms.  The TPU kernel updates
// the next panel's rows first and keeps them resident in VMEM
// ("lookahead"), so the next panel phase starts without the trailing
// stream's traffic.  Here the panel of step k + 1 is read from the carry
// after a grid barrier that follows the whole trailing update of step k:
// no lookahead, and the per-element arithmetic is the step kernel's, so
// the depths pick the same pivots.  The active mask lives in one array
// that each block reads and writes only for its own lanes in the panel
// phase, so it is updated in place from step to step.

#include "lu_step.cuh"

namespace {

namespace cg = cooperative_groups;
using lu_step::Params;

__global__ void __launch_bounds__(lu_panel::NT, 1) getrf_full_fused_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int ktot = min(p.n_rows, p.pp.m);
  for (int k0 = 0; k0 < ktot; k0 += p.nb) {
    Params q = p;
    q.k0 = k0;
    q.pp.in = q.pp.out = p.carry + (int64_t)k0 * p.ld;
    q.pp.piv = p.pp.piv + k0;
    lu_panel::panel_phase<true>(q.pp, smem);
    grid.sync();
    if (k0 + p.nb < p.n_rows) {
      lu_step::trailing(q, smem, grid);
      grid.sync();
    }
  }
}

}  // namespace

extern "C" int64_t slate_getrf_full_fused_smem_bytes(int m, int nb, int ib, int G) {
  return 4 * lu_panel::dyn_floats(m, nb, ib, G, lu_step::GEMM_FLOATS);
}

extern "C" int slate_getrf_full_fused_plan(int m, int nb, int ib, int* G) {
  return lu_panel::plan_grid_for((const void*)getrf_full_fused_kernel, m, nb, ib,
                                 lu_step::GEMM_FLOATS, G);
}

// carry: (n_rows, m) with row stride ld.  act: (m), the active mask on
// entry and after the factorization.  piv: min(n_rows, m) int64, in
// factorization order.  linv, t, x2: (nb, nb) scratch; u: (n_rows - nb)·nb
// floats (at least one); cand, cval, clane as in getrf_step_fused.cu.  nb a
// multiple of 128 and of ib dividing min(n_rows, m).  G from the plan.
extern "C" int slate_getrf_full_fused_f32(
    float* carry, int64_t ld, int n_rows, float* act, int64_t* piv, float* linv,
    float* cand, float* cval, int* clane, float* t, float* x2, float* u, int m,
    int nb, int ib, int G, cudaStream_t stream) {
  if (nb % lu_step::TM != 0 || std::min(n_rows, m) % nb != 0 || ld < m)
    return (int)cudaErrorInvalidValue;
  Params p{{carry, ld, carry, ld, act, act, piv, linv, cand, cval, clane, m, nb, ib,
            G},
           carry, ld, n_rows, 0, nb, t, x2, u, 1};
  void* args[] = {&p};
  return lu_panel::launch_for((const void*)getrf_full_fused_kernel, args, m, nb,
                              ib, G, lu_step::GEMM_FLOATS, stream);
}
