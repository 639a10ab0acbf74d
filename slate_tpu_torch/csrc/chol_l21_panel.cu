// ppotrf's fused per-step panel in one launch: the port of the Pallas kernel
// `chol_l21_panel` (slate_tpu/ops/pallas_kernels.py:602, body
// _chol_l21_kernel :591).  For the (nb, nb) SPD diagonal block D and the
// replicated full-height (M, nb) panel P it returns L = chol(D) (zeros above
// the diagonal) and X = P·L⁻ᵀ: the Cholesky and explicit inverse of
// chol_inv_panel, then the panel's trsm as a product, which the TPU kernel
// keeps in VMEM beside the factor.
//
// What bounds it on an H100: at the distributed path's shape (M = 16384,
// nb = 256) the useful work is M·nb² (a product by a triangle) + ⅔nb³ ≈
// 1.08e9 FLOP over 34 MB of inputs and outputs, so it is bound by
// operations (≈ 0.016 ms at 67 TFLOP/s fp32); but the factor of D is a chain
// of nb/32 dependent 32-steps, bound by latency, and an SM holds 227 KB
// where the TPU kernel held the whole panel (16 MB) in VMEM.  So the kernel
// is potrf_grid.cuh's chol_panel, phases A and B of the Cholesky step
// kernels, on one cooperative grid of 256-thread blocks, one an SM:
//   A. (L, L⁻¹) of D by the whole grid (tri_grid.cuh's chol_inv_grid: the
//      32² Cholesky on one warp and its inverse one column behind on
//      another, each step's trailing 32 × 32 tiles over the blocks, then the
//      recursive doubling's tiles), a grid barrier a 32-step;
//   B. X = P·L⁻ᵀ in 128 × 128 tile_gemm tiles with L⁻¹ read as the
//      transpose of a row-major operand, the slabs its triangle zeroes
//      skipped: a tile of X's columns [j0, j0 + 128) runs K < j0 + 128.
// Each X element's sum runs over k ascending by fmaf from zero, and L is
// chol_inv_grid's, so L is bitwise chol_inv_panel.cu's L of the same D.
// The grid is as wide as the wider phase has tiles, up to one block an SM.
// Every global read is __ldcg (other blocks wrote the data in the launch).
// FFMA in full fp32; no library call.

#include "potrf_grid.cuh"

namespace {

using namespace potrf_grid;

__global__ void __launch_bounds__(NTH, 1)
chol_l21_panel_kernel(const float* D, int64_t ldd, const float* P, int64_t ldp,
                      float* L, float* Linv, float* W, float* X, int m, int nb) {
  __shared__ __align__(16) float sm[SMEM_FLOATS];
  cg::grid_group grid = cg::this_grid();
  chol_panel(sm, grid, D, ldd, L, Linv, W, nb, P, ldp, m,
             [&](int i, int j, float v) { X[(int64_t)i * nb + j] = v; });
}

}  // namespace

// The grid for an (m, nb) panel: co-resident blocks, capped at the wider
// phase's tiles (chol_inv_grid's 32 × 32 tiles or the product's 128²).
extern "C" int slate_chol_l21_panel_plan(int m, int nb, int* G) {
  const int tiles = (m / T) * (nb / T);
  const int diag = chol_inv_grid_tiles(nb);
  return plan_grid((const void*)chol_l21_panel_kernel, tiles > diag ? tiles : diag, G);
}

// D: (nb, nb), row stride ldd, only its lower triangle read.  P: (m, nb),
// row stride ldp.  L, Linv: contiguous (nb, nb) (L an output, Linv
// scratch); W: scratch of nb² floats; X: contiguous (m, nb) output.  nb a
// power of two in [128, 1024], m a multiple of 128.  G from the plan.
extern "C" int slate_chol_l21_panel_f32(const float* D, int64_t ldd,
                                        const float* P, int64_t ldp, float* L,
                                        float* Linv, float* W, float* X, int m,
                                        int nb, int G, cudaStream_t stream) {
  if (nb < T || nb > 1024 || (nb & (nb - 1)) != 0 || m < T || m % T != 0 ||
      ldd < nb || ldp < nb || G < 1)
    return (int)cudaErrorInvalidValue;
  void* args[] = {&D, &ldd, &P, &ldp, &L, &Linv, &W, &X, &m, &nb};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)chol_l21_panel_kernel, dim3(G), dim3(NTH), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
