// One whole right-looking partial-pivot LU step on the transposed (n_rows,
// m) scattered carry, IN PLACE: the port of the Pallas kernel
// `getrf_step_fused` (slate_tpu/ops/pallas_kernels.py:1317, body
// _getrf_step_fused_kernel :1251 over _fused_panel_phase :922, _newton_x2
// :1219 and _lu_chunk_update :1233).  The panel LU of rows [k0, k0 + nb)
// (lu_panel.cuh, the phase getrf_panel_fused.cu launches alone), then the
// Newton-refined pivot-block inverse, the U12 solve, the rank-nb update of
// every later row and the u12 scatter (lu_step.cuh), k0 a run-time
// argument.  update = 0 stops after the scatter (the fused_trsm depth).
// It is the `fused` and `fused_trsm` depth of the scattered LU driver
// (slate_tpu_torch/linalg/lu.py:getrf_scattered): nb = 512 at n = 8192,
// 16 launches per gesv.
//
// What bounds it on an H100: at k0 = 0 on the (8192, 8192) carry the step
// does ~6.4e10 fp32 FLOP (the rank-512 update 6.0e10 of it) over a 0.54 GB
// carry read and written: bound by operations at ~1.0 ms.  The TPU kernel
// keeps the panel and its one-hot pivot matrix in VMEM and streams the
// trailing rows through a double buffer; here one cooperative grid, one
// block per SM, keeps each block's lanes of the panel in shared memory for
// the panel phase (one grid.sync per column), then reuses that shared
// memory for 128 × 128 FFMA product tiles of the trailing phase, with a
// grid barrier between its four phases.  The pivot gather is a gather, not
// a product with a one-hot matrix (see lu_step.cuh).  No library call.

#include "lu_step.cuh"

namespace {

namespace cg = cooperative_groups;
using lu_step::Params;

__global__ void __launch_bounds__(lu_panel::NT, 1) getrf_step_fused_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  lu_panel::panel_phase(p.pp, smem);
  if (p.k0 + p.nb >= p.n_rows) return;
  grid.sync();
  lu_step::trailing(p, smem, grid);
}

}  // namespace

// Dynamic shared memory of one block on a grid of G (ops/smem.py checks its
// formula against this when the library loads).
extern "C" int64_t slate_getrf_step_fused_smem_bytes(int m, int nb, int ib, int G) {
  return 4 * lu_panel::dyn_floats(m, nb, ib, G, lu_step::GEMM_FLOATS);
}

extern "C" int slate_getrf_step_fused_plan(int m, int nb, int ib, int* G) {
  return lu_panel::plan_grid_for((const void*)getrf_step_fused_kernel, m, nb, ib,
                                 lu_step::GEMM_FLOATS, G);
}

// carry: (n_rows, m) with row stride ld, the panel at row k0.  act_in,
// act_out: (m).  piv: (nb) int64.  linv: contiguous (nb, nb).  cand, cval,
// clane: 2·G·nb floats, 2·G floats, 2·G ints.  t, x2: (nb, nb) scratch;
// u: (n_rows - k0 - nb)·nb floats (at least one).  nb a multiple of 128 and
// of ib, 1 ≤ ib ≤ 32, k0 + nb ≤ min(n_rows, m).  G from the plan.
extern "C" int slate_getrf_step_fused_f32(
    float* carry, int64_t ld, int64_t k0, int n_rows, const float* act_in,
    float* act_out, int64_t* piv, float* linv, float* cand, float* cval,
    int* clane, float* t, float* x2, float* u, int m, int nb, int ib,
    int update, int G, cudaStream_t stream) {
  if (nb % lu_step::TM != 0 || k0 < 0 || k0 + nb > n_rows || k0 + nb > m ||
      ld < m)
    return (int)cudaErrorInvalidValue;
  float* panel = carry + k0 * ld;
  Params p{{panel, ld, panel, ld, act_in, act_out, piv, linv, cand, cval, clane, m,
            nb, ib, G},
           carry, ld, n_rows, (int)k0, nb, t, x2, u, update};
  void* args[] = {&p};
  return lu_panel::launch_for((const void*)getrf_step_fused_kernel, args, m, nb,
                              ib, G, lu_step::GEMM_FLOATS, stream);
}
