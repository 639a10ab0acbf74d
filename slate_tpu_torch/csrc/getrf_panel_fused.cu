// Partial-pivot LU of panel rows [k0, k0 + nb) of the transposed (n, m)
// carry, IN PLACE, with the unit-lower pivot-block inverse: the port of
// the Pallas kernel `getrf_panel_fused` (slate_tpu/ops/pallas_kernels.py
// :1080, pallas_call :1101, body _fused_panel_phase :922-1061 over
// _factor_block_lane_major :690-771).  It is the panel of the scattered
// driver getrf_scattered (slate_tpu_torch/linalg/lu.py): nb = 512 rows of
// the (8192, 8192) carry per launch, ib = 16, 16 launches per gesv at
// n = 8192.  Rows of the carry outside the panel are never read or
// written, which stands in for the TPU kernel's aliased HBM carry.
//
// What bounds it on an H100: ~m·nb² fp32 FLOP (2.1 GFLOP at m = 8192)
// over 2·m·nb·4 bytes (33.6 MB): bound by operations at ~0.032 ms by the
// card's peaks.  In practice it is bound by latency: nb dependent column
// steps, each an argmax over every active lane.  The TPU kernel holds the
// 16 MB panel in VMEM and walks it on one core.  Here (lu_panel.cuh) one
// thread-block cluster runs each inner block's ib columns from its
// registers or shared memory, one cluster barrier a column, while the
// rest of the grid applies the previous inner block's delayed update to
// the panel in L2; the grid meets once per inner block.  The reference's
// bb-wide column-block steps exist to fit VMEM grid steps; bb only has
// to divide nb and leaves the arithmetic alone.

#include "lu_panel.cuh"

// Dynamic shared memory of one block (ops/smem.py lu_panel_cluster_bytes;
// the launch asks for at least half an SM's).
extern "C" int64_t slate_getrf_panel_fused_smem_bytes(int m, int nb, int ib) {
  return 4 * lu_panel::panel_floats(m, nb, ib, lu_panel::MAX_CLUSTER);
}

// G, C: the grid and the leaf cluster's size to launch with.
extern "C" int slate_getrf_panel_fused_plan(int m, int nb, int ib, int* G, int* C) {
  return lu_panel::plan(m, nb, ib, G, C);
}

// carry: (n, m) with row stride ld; the panel starts at row k0.  act_in,
// act_out: (m).  piv: (nb) int64.  linv: contiguous (nb, nb).  iwork:
// 2·m + 1 ints; lblk: 3·ib² floats; bar: two zeroed unsigned.  nb a
// multiple of ib, 1 ≤ ib ≤ 32; G and C from the plan.
extern "C" int slate_getrf_panel_fused_f32(float* carry, int64_t ld, int64_t k0,
                                           const float* act_in, float* act_out, int64_t* piv,
                                           float* linv, int* iwork, float* lblk, unsigned* bar,
                                           int m, int nb, int ib, int G, int C,
                                           cudaStream_t stream) {
  float* panel = carry + k0 * ld;
  lu_panel::Params p{panel, ld, panel, ld, act_in, act_out, piv, linv, iwork, iwork + m,
                     iwork + 2 * (int64_t)m, lblk, bar, m, nb, ib, G, C};
  return lu_panel::launch(p, stream);
}
