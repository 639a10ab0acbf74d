// Device code of chol_l21_panel.cu, ppotrf's fused per-step panel: the
// cooperative grid of 1024-thread blocks (one per SM) whose block 0 runs
// one of tri_panel.cuh's single-block algorithms (chol_inv_block) while the
// other blocks wait at a grid barrier, before the whole grid takes 128 × 128
// tiles of a product (block_gemm).  The Cholesky steps of the posv driver
// run on tri_grid.cuh's grids instead (potrf_grid.cuh).
//
// Every global read of data another block wrote goes through L2
// (ld.global.cg, block_gemm<true>): L1 is not coherent across SMs.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tri_panel.cuh"

namespace potrf_step {

namespace cg = cooperative_groups;
using namespace tri_panel;

constexpr int T = GT;    // 128: the product's work-unit edge

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
