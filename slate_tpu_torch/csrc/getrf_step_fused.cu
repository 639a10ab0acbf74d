// One whole right-looking partial-pivot LU step on the transposed (n_rows,
// m) scattered carry, IN PLACE: the port of the Pallas kernel
// `getrf_step_fused` (slate_tpu/ops/pallas_kernels.py:1317, body
// _getrf_step_fused_kernel :1251 over _fused_panel_phase :922, _newton_x2
// :1219 and _lu_chunk_update :1233).  The panel LU of rows [k0, k0 + nb),
// then the Newton-refined pivot-block inverse, the U12 solve, the rank-nb
// update of every lane still active and the u12 scatter, k0 a run-time
// argument; update = 0 stops after the scatter (the fused_trsm depth).  It
// is the `fused` and `fused_trsm` depth of the scattered LU driver
// (slate_tpu_torch/linalg/lu.py:getrf_scattered): nb = 512 at n = 8192, 16
// launches per gesv.
//
// What bounds it on an H100: at k0 = 0 on the (8192, 8192) carry the step
// does ~6.4e10 fp32 FLOP (the rank-512 update 6.0e10 of it) over a 0.54 GB
// carry read and written: bound by operations at ~1.0 ms.  In practice the
// panel's latency (a grid barrier and two L2 round trips a column) and the
// FFMA update tile's issue rate bound it.  The kernel is ONE
// step of getrf_full_fused.cu's loop, the same device code (lu_full.cuh):
// block 0 lists the lanes active on entry while the grid copies the mask,
// then the panel and the rank-nb update run over the active lanes only,
// the products on double-buffered tiles.  The full kernel's launch is
// therefore bitwise the chain of these launches.  No library call.

#include "lu_full.cuh"

namespace {

namespace cg = cooperative_groups;
using lu_full::Params;

__global__ void __launch_bounds__(lu_panel::NT, 1)
    getrf_step_fused_kernel(Params p, const float* act_in, int k0, int update) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  // the lanes active on entry (list 0), and the mask the panel updates
  if (blockIdx.x == 0)
    lu_full::compact(act_in, nullptr, p.m, p.lanes, p.na, reinterpret_cast<int*>(smem));
  for (int l = blockIdx.x * lu_panel::NT + threadIdx.x; l < p.m; l += p.G * lu_panel::NT)
    p.act[l] = act_in[l];
  grid.sync();
  lu_full::ColumnBarrier columns{p.bar, (unsigned)p.G, 0u};
  const int na = __ldcg(p.na);
  lu_full::panel(p, k0, p.lanes, na, smem, columns);
  if (k0 + p.nb >= p.n_rows) return;
  grid.sync();
  lu_full::products(p, k0, p.lanes, na, p.lanes + p.m, p.na + 1, smem, grid);
  lu_full::update(p, k0, p.lanes + p.m, p.na + 1, smem, update != 0);
}

}  // namespace

// Dynamic shared memory of one block on a grid of G: the full kernel's
// (ops/smem.py lu_full_bytes).
extern "C" int64_t slate_getrf_step_fused_smem_bytes(int m, int nb, int ib, int G) {
  return 4 * lu_panel::dyn_floats(m, nb, ib, G, lu_full::trail_floats(nb));
}

extern "C" int slate_getrf_step_fused_plan(int m, int nb, int ib, int* G) {
  return lu_panel::plan_grid_for((const void*)getrf_step_fused_kernel, m, nb, ib,
                                 lu_full::trail_floats(nb), G);
}

// carry: (n_rows, m) with row stride ld, the panel at row k0.  act_in,
// act_out: (m).  piv: (nb) int64.  linv, l11, t, x2: (nb, nb), linv an
// output; u, cpiv: (n_rows - k0 - nb)·nb floats each (at least one); cand,
// cval, clane: 2·G·nb floats, 2·G floats, 2·G ints; lanes: 2·m ints, na: 2
// ints, bar: one zeroed int.  nb and k0 multiples of 128, nb a multiple of
// ib, 1 ≤ ib ≤ 32, k0 + nb ≤ m, n_rows − k0 − nb a multiple of 128.  G from
// the plan.
extern "C" int slate_getrf_step_fused_f32(
    float* carry, int64_t ld, int64_t k0, int n_rows, const float* act_in,
    float* act_out, int64_t* piv, float* linv, float* cand, float* cval,
    int* clane, float* l11, float* t, float* x2, float* u, float* cpiv, int* lanes,
    int* na, unsigned* bar, int m, int nb, int ib, int update, int G,
    cudaStream_t stream) {
  if (nb % lu_full::TT != 0 || k0 < 0 || k0 % lu_full::TT != 0 || k0 + nb > n_rows ||
      (n_rows - k0 - nb) % lu_full::TT != 0 || k0 + nb > m || ld < m)
    return (int)cudaErrorInvalidValue;
  Params p{carry, ld, n_rows, m, nb, ib, G, act_out, piv, (int)k0, linv, cand, cval,
           clane, l11, t, x2, u, cpiv, lanes, na, bar};
  int k = (int)k0;
  void* args[] = {&p, &act_in, &k, &update};
  return lu_panel::launch_for((const void*)getrf_step_fused_kernel, args, m, nb, ib, G,
                              lu_full::trail_floats(nb), stream);
}
