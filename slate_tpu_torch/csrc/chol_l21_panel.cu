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
// operations (≈ 0.016 ms at 67 TFLOP/s fp32).  The TPU kernel holds the whole panel in VMEM (16 MB); an SM holds
// 227 KB.  So one cooperative grid of 1024-thread blocks, one per SM, runs
// two phases (potrf_step.cuh's grid):
//   A. block 0 factors D and inverts L (tri_panel.cuh's chol_inv_block,
//      ib = 32, recursive-doubling inverse) while the others wait at the
//      grid barrier: the serial part, on one SM;
//   B. every block takes 128 × 128 tiles of X with block_gemm, reading L⁻¹
//      through L2 (ld.global.cg: block 0 wrote it in this launch, and L1 is
//      not coherent across SMs).  L⁻ᵀ is UPPER triangular, the opposite of
//      block_gemm's b_lower skip: a tile of X's columns [j0, j0 + 128)
//      needs only K < j0 + 128, so each tile's K is cut there instead.
// FFMA only (TF32 fails the drivers' residual gates); no library call.

#include "potrf_step.cuh"

namespace {

using namespace potrf_step;

__global__ void __launch_bounds__(NTH, 1)
chol_l21_panel_kernel(const float* D, int64_t ldd, const float* P, int64_t ldp,
                      float* L, float* Linv, float* W, float* X, int m, int nb) {
  __shared__ __align__(16) Smem s;
  cg::grid_group grid = cg::this_grid();
  if (blockIdx.x == 0) chol_inv_block(s, D, ldd, L, Linv, W, nb);
  grid.sync();
  // X(i, j) = Σ_k P(i, k)·L⁻¹(j, k): B(k, j) = Linv[j·nb + k]
  const int nrt = m / T, nct = nb / T;
  for (int u = blockIdx.x; u < nrt * nct; u += gridDim.x) {
    const int rt = u / nct, ct = u % nct;
    block_gemm<true>(s, T, T, (ct + 1) * T, 1.f, P + (int64_t)rt * T * ldp, ldp,
                     1, false, Linv + (int64_t)ct * T * nb, 1, nb, false, 0.f,
                     X + (int64_t)rt * T * nb + ct * T, nb, false);
  }
}

}  // namespace

extern "C" int slate_chol_l21_panel_plan(int* G) {
  return plan_grid((const void*)chol_l21_panel_kernel, G);
}

// D: (nb, nb), row stride ldd, only its lower triangle read.  P: (m, nb),
// row stride ldp.  L, Linv: contiguous (nb, nb) (L an output, Linv
// scratch); W: scratch of max((nb/2)², nb·32) floats; X: contiguous (m, nb)
// output.  nb a power of two in [128, 1024], m a multiple of 128.  G from
// the plan.
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
