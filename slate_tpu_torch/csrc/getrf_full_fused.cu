// The whole right-looking partial-pivot LU of the transposed (n_rows, m)
// scattered carry in ONE launch, IN PLACE: the port of the Pallas kernel
// `getrf_full_fused` (slate_tpu/ops/pallas_kernels.py:1481, body
// _getrf_full_fused_kernel :1405).  The step of getrf_step_fused.cu (the
// same device code, lu_full.cuh) for k0 = 0, nb, … below min(n_rows, m)
// inside one cooperative grid, the pivots of every step written in
// factorization order, each step over the lanes still active.  It is the
// `full` depth of the scattered LU driver (slate_tpu_torch/linalg/lu.py:
// getrf_scattered): one launch per gesv.
//
// What bounds it on an H100: 2n³/3 fp32 FLOP (3.7e11 at n = 8192) over a
// 0.54 GB carry: bound by operations at ~5.5 ms.  In practice the panels
// bound it: each of the n columns is a grid-wide argmax, one grid barrier
// and two L2 round trips, ~3.4 µs a column whatever the number of active
// lanes, so about two thirds of the launch at n = 8192; the trailing
// products run on FFMA tiles at ~27 TFLOP/s.  The TPU kernel updates the
// next panel's rows first and keeps them resident in VMEM ("lookahead").
// Here the panel of step k + 1 starts after a grid barrier that follows
// the whole trailing update of step k: a look-ahead that ran the next
// panel on part of the grid beside the rest of the update was tried and
// lost (the update's traffic slowed the panel's round trips more than the
// overlap saved).  Each step runs the step kernel's code, so the two
// depths agree bitwise.  The active mask is one array updated in
// place; the list of the lanes still active (two buffers of m ints) is
// rebuilt after each panel.

#include "lu_full.cuh"

namespace {

namespace cg = cooperative_groups;
using lu_full::Params;

__global__ void __launch_bounds__(lu_panel::NT, 1) getrf_full_fused_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int ktot = min(p.n_rows, p.m);
  if (blockIdx.x == 0)
    lu_full::compact(p.act, nullptr, p.m, p.lanes, p.na, reinterpret_cast<int*>(smem));
  grid.sync();
  lu_full::ColumnBarrier columns{p.bar, (unsigned)p.G, 0u};
  for (int k0 = 0, cur = 0; k0 < ktot; k0 += p.nb, cur ^= 1) {
    const int* list = p.lanes + (int64_t)cur * p.m;
    int* next = p.lanes + (int64_t)(cur ^ 1) * p.m;
    const int na = __ldcg(p.na + cur);
    lu_full::panel(p, k0, list, na, smem, columns);
    grid.sync();
    if (k0 + p.nb < p.n_rows) {
      lu_full::products(p, k0, list, na, next, p.na + (cur ^ 1), smem, grid);
      lu_full::update(p, k0, next, p.na + (cur ^ 1), smem);
      grid.sync();
    }
  }
}

}  // namespace

// Dynamic shared memory of one block on a grid of G: the panel's share or
// the trailing phase's, whichever is larger (ops/smem.py lu_full_bytes).
extern "C" int64_t slate_getrf_full_fused_smem_bytes(int m, int nb, int ib, int G) {
  return 4 * lu_panel::dyn_floats(m, nb, ib, G, lu_full::trail_floats(nb));
}

extern "C" int slate_getrf_full_fused_plan(int m, int nb, int ib, int* G) {
  return lu_panel::plan_grid_for((const void*)getrf_full_fused_kernel, m, nb, ib,
                                 lu_full::trail_floats(nb), G);
}

// carry: (n_rows, m) with row stride ld.  act: (m), the active mask on
// entry and after the factorization.  piv: min(n_rows, m) int64, in
// factorization order.  linv, l11, t, x2: (nb, nb) scratch; u, cpiv:
// (n_rows - nb)·nb floats each (at least one); cand, cval, clane as in
// getrf_step_fused.cu; lanes: 2·m ints, na: 2 ints, bar: one zeroed int.
// nb a multiple of 128
// and of ib dividing min(n_rows, m).  G from the plan.
extern "C" int slate_getrf_full_fused_f32(
    float* carry, int64_t ld, int n_rows, float* act, int64_t* piv, float* linv,
    float* cand, float* cval, int* clane, float* l11, float* t, float* x2, float* u,
    float* cpiv, int* lanes, int* na, unsigned* bar, int m, int nb, int ib, int G,
    cudaStream_t stream) {
  if (nb % lu_full::TT != 0 || std::min(n_rows, m) % nb != 0 || ld < m)
    return (int)cudaErrorInvalidValue;
  Params p{carry, ld, n_rows, m, nb, ib, G, act, piv, 0, linv, cand, cval, clane,
           l11, t, x2, u, cpiv, lanes, na, bar};
  void* args[] = {&p};
  return lu_panel::launch_for((const void*)getrf_full_fused_kernel, args, m, nb, ib, G,
                              lu_full::trail_floats(nb), stream);
}
