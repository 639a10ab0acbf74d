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
// dependent column steps, each a grid-wide argmax.  The design (see
// lu_panel.cuh) keeps every lane in the shared memory of one block of a
// cooperative grid for the whole panel, so each column costs one
// grid.sync and a few block barriers and the panel crosses device memory
// once each way; the rank-ib updates run from registers.  A panel of 256
// lanes still runs, on a grid of 8 blocks.

#include "lu_panel.cuh"

// slab: (w, m) with row stride ld_in; out: contiguous (w, m).  act_in,
// act_out: (m).  piv: (w) int64.  linv: contiguous (w, w).  cand, cval,
// clane: scratch of 2·G·w floats, 2·G floats and 2·G ints, G from
// slate_getrf_panel_linv_plan.  w a multiple of ib, 1 ≤ ib ≤ 32.
extern "C" int slate_getrf_panel_linv_plan(int m, int w, int ib, int* G) {
  return lu_panel::plan_grid(m, w, ib, G);
}

extern "C" int slate_getrf_panel_linv_f32(
    const float* slab, int64_t ld_in, float* out, const float* act_in,
    float* act_out, int64_t* piv, float* linv, float* cand, float* cval,
    int* clane, int m, int w, int ib, int G, cudaStream_t stream) {
  lu_panel::Params p{slab, ld_in, out, (int64_t)m, act_in, act_out, piv, linv,
                     cand, cval, clane, m, w, ib, G};
  return lu_panel::launch(p, stream);
}
