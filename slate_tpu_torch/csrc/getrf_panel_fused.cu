// Partial-pivot LU of panel rows [k0, k0 + nb) of the transposed (n, m)
// carry, IN PLACE, with the unit-lower pivot-block inverse: the port of
// the Pallas kernel `getrf_panel_fused` (slate_tpu/ops/pallas_kernels.py
// :1080, pallas_call :1101, body _fused_panel_phase :922-1061 over
// _factor_block_lane_major :690-771).  It is the panel of the scattered
// driver getrf_scattered (slate_tpu_torch/linalg/lu.py): nb = 512 rows of
// the (8192, 8192) carry per launch, 16 launches per gesv at n = 8192.
// Rows of the carry outside the panel are never read or written, which
// stands in for the TPU kernel's aliased HBM carry.
//
// What bounds it on an H100: ~m·nb² fp32 FLOP (2.1 GFLOP at m = 8192)
// over 2·m·nb·4 bytes (33.6 MB): bound by operations at ~0.032 ms by the
// card's peaks.  The TPU kernel holds the 16 MB panel in VMEM and walks
// it on one core; one SM cannot hold it, and one SM walking it through L2
// would take several ms.  So one cooperative grid of one block per SM
// splits the lanes, each block keeping its ~63 lanes × 512 rows in shared
// memory from the first column to the last (lu_panel.cuh): one grid.sync
// per column, the rank-ib (ib = 16) updates from registers.  The
// reference's bb-wide column-block steps exist to fit VMEM grid steps; the
// panel stays resident here for its whole width, so bb only has to
// divide nb and leaves the arithmetic alone.

#include "lu_panel.cuh"

// carry: (n, m) with row stride ld; the panel starts at row k0.  act_in,
// act_out: (m).  piv: (nb) int64.  linv: contiguous (nb, nb).  cand,
// cval, clane: scratch of 2·G·nb floats, 2·G floats and 2·G ints, G from
// slate_getrf_panel_fused_plan.  nb a multiple of ib, 1 ≤ ib ≤ 32.
extern "C" int slate_getrf_panel_fused_plan(int m, int nb, int ib, int* G) {
  return lu_panel::plan_grid(m, nb, ib, G);
}

extern "C" int slate_getrf_panel_fused_f32(
    float* carry, int64_t ld, int64_t k0, const float* act_in, float* act_out,
    int64_t* piv, float* linv, float* cand, float* cval, int* clane, int m,
    int nb, int ib, int G, cudaStream_t stream) {
  float* panel = carry + k0 * ld;
  lu_panel::Params p{panel, ld, panel, ld, act_in, act_out, piv, linv,
                     cand, cval, clane, m, nb, ib, G};
  return lu_panel::launch(p, stream);
}
