// Partial-pivot LU of a transposed (w, m) panel, out of place, with the
// unit-lower pivot-block inverse: the port of the Pallas kernel
// `getrf_panel_linv` (slate_tpu/ops/pallas_kernels.py:873, pallas_call
// :884, body _factor_panel_linv_kernel :774-869).  It is the panel leaf of
// the blocked recursion getrf_rec (slate_tpu_torch/linalg/lu.py): w = 256
// slabs, m from n down to 256, ib = 32.
//
// What bounds it on an H100: ~m·w² fp32 FLOP (0.54 GFLOP at (256, 8192))
// over 2·m·w·4 bytes (16.8 MB), so by the card's peaks it is bound by
// operations at ~0.008 ms.  In practice it is bound by latency: w
// dependent column steps, each an argmax over every active lane.  The
// design (lu_panel.cuh) copies the slab into `out` and factors it there:
// one thread-block cluster runs each inner block's ib columns from its
// registers or shared memory, one cluster barrier a column, while the
// rest of the grid applies the previous inner block's delayed update;
// the grid meets once per inner block.

#include "lu_panel.cuh"

// Dynamic shared memory of one block (ops/smem.py lu_panel_cluster_bytes;
// the launch asks for at least half an SM's).
extern "C" int64_t slate_getrf_panel_linv_smem_bytes(int m, int w, int ib) {
  return 4 * lu_panel::panel_floats(m, w, ib, lu_panel::MAX_CLUSTER);
}

// G, C: the grid and the leaf cluster's size to launch with.
extern "C" int slate_getrf_panel_linv_plan(int m, int w, int ib, int* G, int* C) {
  return lu_panel::plan(m, w, ib, G, C);
}

// slab: (w, m) with row stride ld_in; out: contiguous (w, m).  act_in,
// act_out: (m).  piv: (w) int64.  linv: contiguous (w, w).  iwork: 2·m + 1
// ints; lblk: 3·ib² floats; bar: two zeroed unsigned.  w a multiple of
// ib, 1 ≤ ib ≤ 32; G and C from the plan.
extern "C" int slate_getrf_panel_linv_f32(const float* slab, int64_t ld_in, float* out,
                                          const float* act_in, float* act_out, int64_t* piv,
                                          float* linv, int* iwork, float* lblk, unsigned* bar,
                                          int m, int w, int ib, int G, int C,
                                          cudaStream_t stream) {
  lu_panel::Params p{slab, ld_in, out, (int64_t)m, act_in, act_out, piv, linv, iwork,
                     iwork + m, iwork + 2 * (int64_t)m, lblk, bar, m, w, ib, G, C};
  return lu_panel::launch(p, stream);
}
