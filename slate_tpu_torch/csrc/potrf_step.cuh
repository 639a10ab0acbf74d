// Device code shared by the two cooperative Cholesky kernels,
// potrf_step_fused.cu and potrf_full_fused.cu, as the Pallas kernels share
// _potrf_panel_phase and _potrf_trailing_stream
// (slate_tpu/ops/pallas_kernels.py:1542-1601): ONE right-looking step of
// the lower Cholesky factorization of the (n, n) carry at column k0.
//
// The function (the TPU kernel's contract):
//   * the (nb, nb) diagonal block becomes L11 (zeros above its diagonal),
//     with L11⁻¹ formed beside it (chol_inv_block, ib = 32, doubling
//     inverse: tri_panel.cuh);
//   * the rows below it in the block column become L21 = A21·L11⁻ᵀ;
//   * the trailing block loses L21·L21ᵀ on the (tc, tc) tile pairs (i, j)
//     with i ≥ j — the diagonal tiles whole, the tiles above them never;
//   * rows and columns before k0, the rows above the diagonal block in its
//     block column and everything right of it above the trailing block
//     pass through untouched.
//
// Execution model.  The TPU kernel keeps the (n, nb) block column resident
// in VMEM (16 MB at 8192 × 512); an SM holds 227 KB.  So every block of one
// cooperative grid of 1024-thread blocks (one per SM) runs the step in
// three phases separated by grid.sync():
//   A. block 0 factors the diagonal block (chol_inv_block, from L2) while
//      the other blocks wait: the step's serial part;
//   B. L21 = A21·L11⁻ᵀ in 128 × 128 tiles of block_gemm, into a scratch
//      (n, nb) copy (in place would race: a tile's rows are read by the
//      other tiles of its row);
//   C. the trailing update, 128 × 128 subtiles of the lower tile pairs,
//      each C -= L21_i·L21_jᵀ with K = nb, read from the scratch copy,
//      and the copy of L21 into the carry's block column.
// Every global read goes through L2 (ld.global.cg): other blocks wrote the
// data in the same launch, and L1 is not coherent across SMs.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tri_panel.cuh"

namespace potrf_step {

namespace cg = cooperative_groups;
using namespace tri_panel;

constexpr int T = GT;    // 128: the L21 and trailing work-unit edge

struct Params {
  float* a;        // (n, n) carry, row stride ld
  int64_t ld;
  float* lkk;      // (nb, nb) scratch: L11
  float* linv;     // (nb, nb) scratch: L11⁻¹
  float* w;        // chol_inv_block scratch: max((nb/2)², nb·32) floats
  float* l21;      // (n - nb, nb) scratch: L21, row r - (k0 + nb)
  int n, nb, tc;
};

// Shapes the kernels take: nb a power of two ≥ 128, tc a multiple of 128
// dividing nb, nb dividing n, row stride ≥ n.
inline bool shape_ok(const Params& p) {
  return p.nb >= T && (p.nb & (p.nb - 1)) == 0 && p.tc >= T && p.tc % T == 0 &&
         p.nb % p.tc == 0 && p.n >= p.nb && p.n % p.nb == 0 && p.ld >= p.n;
}

// One step at k0 by every block of the grid.  Every block returns after
// the same number of grid barriers; the trailing phase ends with none.
static __device__ void step(Smem& s, const Params& p, int k0, cg::grid_group& grid) {
  const int tid = threadIdx.x, g = blockIdx.x, G = gridDim.x;
  const int n = p.n, nb = p.nb;
  const int64_t ld = p.ld;
  float* akk = p.a + (int64_t)k0 * ld + k0;

  // A. the diagonal block, on block 0
  if (g == 0) {
    chol_inv_block<true>(s, akk, ld, p.lkk, p.linv, p.w, nb);
    for (int64_t e = tid; e < (int64_t)nb * nb; e += NTH)
      akk[(e / nb) * ld + e % nb] = p.lkk[e];
  }
  grid.sync();
  const int r0 = k0 + nb, nt = n - r0;
  if (nt == 0) return;

  // B. L21 = A21·L11⁻ᵀ: B(k, j) = L11⁻¹[j, k]
  const int nrt = nt / T, nct = nb / T;
  for (int u = g; u < nrt * nct; u += G) {
    const int rt = u / nct, ct = u % nct;
    block_gemm<true>(s, T, T, nb, 1.f, p.a + (int64_t)(r0 + rt * T) * ld + k0, ld,
                     1, false, p.linv + (int64_t)ct * T * nb, 1, nb, false, 0.f,
                     p.l21 + (int64_t)rt * T * nb + ct * T, nb, false);
  }
  grid.sync();

  // C. L21 into the carry's block column, and the trailing subtiles (I, J)
  //    whose tc tiles lie on or below the diagonal
  for (int64_t e = (int64_t)g * NTH + tid; e < (int64_t)nt * nb;
       e += (int64_t)G * NTH)
    p.a[(r0 + e / nb) * ld + k0 + e % nb] = __ldcg(p.l21 + e);
  const int per = p.tc / T;
  for (int u = g; u < nrt * nrt; u += G) {
    const int I = u / nrt, J = u % nrt;
    if (I / per < J / per) continue;
    block_gemm<true>(s, T, T, nb, -1.f, p.l21 + (int64_t)I * T * nb, nb, 1, false,
                     p.l21 + (int64_t)J * T * nb, 1, nb, false, 1.f,
                     p.a + (int64_t)(r0 + I * T) * ld + r0 + J * T, ld, false);
  }
}

// The cooperative grid: as many 1024-thread blocks as are co-resident
// (one per SM).  Returns a CUDA error code.
inline int plan_grid(const void* kernel, int* G_out) {
  int dev = 0, sms = 0, coop = 0, occ = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, NTH, 0)) !=
      cudaSuccess)
    return (int)err;
  if (occ < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *G_out = occ * sms;
  return 0;
}

}  // namespace potrf_step
