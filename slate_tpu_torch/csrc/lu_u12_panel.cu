// pgetrf's fused block-row solve in one launch: the port of the Pallas kernel
// `lu_u12_panel` (slate_tpu/ops/pallas_kernels.py:646, body _lu_u12_kernel
// :629).  For the unit-lower (nb, nb) L11 (unit diagonal stored) and the
// (nb, w) block row B it returns U = u1 + L⁻¹·r1, where u1 = L⁻¹·B and
// r1 = B − L11·u1 (one residual correction), and the departure
// dev = max|r1| / max(max|B|, FLT_MIN) of the uncorrected solve, which the
// caller guards on (the exact trsm takes over past 1e-2).  L⁻¹ is the
// trtri_panel inverse of L11's lower triangle; the correction multiplies by
// L11 as given, as the TPU kernel does.
//
// What bounds it on an H100: at the widest call of the distributed path
// (nb = 256, w = 16384) the three products by triangles (L⁻¹ twice and the
// unit-lower L11 the caller stores) and the inverse need 3·nb²·w + nb³/3 ≈
// 3.23e9 FLOP over 34 MB: bound by operations (≈ 0.048 ms at 67 TFLOP/s
// fp32).  The TPU kernel keeps B, U and r1 in VMEM; here
// one cooperative grid of 1024-thread blocks, one per SM:
//   A. block 0 inverts L11 (tri_panel.cuh's per-32 block inverses and
//      recursive doubling, as trtri_panel.cu) and zeroes the two maxima
//      while the others wait at the grid barrier;
//   B. each block owns 128-wide column strips of B and runs, for its strip,
//      u1 = L⁻¹·B into U, r1 = B − L11·u1 into scratch, U += L⁻¹·r1, all
//      block_gemm with K = nb (the L⁻¹ products skip its zero slabs), and
//      folds the strip's max|r1| and max|B| into two device words by
//      atomicMax on the bit patterns (|x| is non-negative, so its bits
//      order as integers; a NaN's bits are the largest, so a NaN propagates
//      as the TPU kernel's max does);
//   C. after a second grid barrier one thread writes dev.
// Every read of data written in the launch goes through L2 (ld.global.cg).
// FFMA only; no library call.

#include <cfloat>

#include "potrf_step.cuh"

namespace {

using namespace potrf_step;

__device__ __forceinline__ int abs_bits(float v) { return __float_as_int(fabsf(v)); }

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(NTH, 1)
lu_u12_panel_kernel(const float* L, int64_t ldl, const float* B, int64_t ldb,
                    float* U, float* Linv, float* W, float* R, int* mx,
                    float* dev, int nb, int w) {
  __shared__ __align__(16) Smem s;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;

  // A. L⁻¹ on block 0 (trtri_panel.cu's body)
  if (blockIdx.x == 0) {
    if (tid < 2) mx[tid] = 0;
    const int64_t nn = (int64_t)nb * nb;
    for (int64_t e = tid; e < nn; e += NTH) Linv[e] = 0.f;
    __syncthreads();
    for (int k0 = 0; k0 < nb; k0 += IB) {
      if (tid < 32) {
        load_lower_block_warp(s, L + (int64_t)k0 * ldl + k0, ldl);
        trtri_unblocked_warp(s);
      }
      __syncthreads();
      const int r = tid / IB, c = tid % IB;
      Linv[(int64_t)(k0 + r) * nb + k0 + c] = s.inv[r][c];
      __syncthreads();
    }
    block_inv_doubling(s, L, ldl, Linv, nb, W, nb);
  }
  grid.sync();

  // B. the strips
  int rmax = 0, bmax = 0;
  for (int u = blockIdx.x; u < w / T; u += gridDim.x) {
    const int j0 = u * T;
    const float* b = B + j0;
    float* us = U + j0;
    float* rs = R + j0;
    // u1 = L⁻¹·B
    block_gemm<true>(s, nb, T, nb, 1.f, Linv, nb, 1, true, b, ldb, 1, false, 0.f,
                     us, w, false);
    for (int e = tid; e < nb * T; e += NTH) {
      const int i = e / T, j = e % T;
      const float v = b[(int64_t)i * ldb + j];
      rs[(int64_t)i * w + j] = v;
      bmax = max(bmax, abs_bits(v));
    }
    __syncthreads();
    // r1 = B − L11·u1
    block_gemm<true>(s, nb, T, nb, -1.f, L, ldl, 1, false, us, w, 1, false, 1.f,
                     rs, w, false);
    for (int e = tid; e < nb * T; e += NTH)
      rmax = max(rmax, abs_bits(__ldcg(rs + (int64_t)(e / T) * w + e % T)));
    // U = u1 + L⁻¹·r1
    block_gemm<true>(s, nb, T, nb, 1.f, Linv, nb, 1, true, rs, w, 1, false, 1.f,
                     us, w, false);
  }
  rmax = warp_max(rmax);
  bmax = warp_max(bmax);
  if ((tid & 31) == 0) {
    atomicMax(mx, rmax);
    atomicMax(mx + 1, bmax);
  }
  grid.sync();

  // C. the departure
  if (blockIdx.x == 0 && tid == 0) {
    const float r = __int_as_float(atomicAdd(mx, 0));
    const float bm = __int_as_float(atomicAdd(mx + 1, 0));
    dev[0] = r / (bm != bm ? bm : fmaxf(bm, FLT_MIN));
  }
}

}  // namespace

extern "C" int slate_lu_u12_panel_plan(int* G) {
  return plan_grid((const void*)lu_u12_panel_kernel, G);
}

// L: (nb, nb) unit lower with row stride ldl (unit diagonal and zeros above
// it stored).  B: (nb, w) with row stride ldb.  U: contiguous (nb, w)
// output; Linv: (nb, nb) scratch; W: (nb/2)² floats of scratch; R: (nb, w)
// scratch; mx: two ints of scratch; dev: one float, the output departure.
// nb a power of two in [32, 1024], w a multiple of 128.  G from the plan.
extern "C" int slate_lu_u12_panel_f32(const float* L, int64_t ldl, const float* B,
                                      int64_t ldb, float* U, float* Linv, float* W,
                                      float* R, int* mx, float* dev, int nb, int w,
                                      int G, cudaStream_t stream) {
  if (nb < IB || nb > 1024 || (nb & (nb - 1)) != 0 || w < T || w % T != 0 ||
      ldl < nb || ldb < w || G < 1)
    return (int)cudaErrorInvalidValue;
  void* args[] = {&L, &ldl, &B, &ldb, &U, &Linv, &W, &R, &mx, &dev, &nb, &w};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)lu_u12_panel_kernel, dim3(G), dim3(NTH), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
