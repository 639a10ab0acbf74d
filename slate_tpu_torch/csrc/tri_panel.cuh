// Device code of the single-block triangular kernel potrf_batched.cu, as
// the Pallas kernels share _chol_unblocked and _trtri_unblocked
// (slate_tpu/ops/pallas_kernels.py:282-363).  The grid kernels of
// tri_grid.cuh (chol_inv_panel.cu, trtri_panel.cu among them) keep the
// rounding of the reference's _block_inv_doubling and _chol_inv_kernel
// (pallas_kernels.py:340, :366).
//
// Execution model: ONE block of 1024 threads owns the whole (nb, nb)
// panel (potrf_batched: one block per problem).  On the TPU the panel sits in VMEM; on an H100 a 512² fp32 panel
// (1 MB) does not fit one SM's 227 KB of shared memory, so the panel
// stays in global memory (it is L2-resident: 50 MB of L2) and the block
// stages 32-wide slabs through shared memory, with __syncthreads between
// phases.  Global writes made before a __syncthreads are visible to the
// whole block after it, which is all the phases need.  No pointer here is
// __restrict__: the panel is read and written in one launch, and the
// read-only (non-coherent) load path must not be used for it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tri_panel {

constexpr int IB = 32;      // unblocked inner block, as the reference's ib
constexpr int NTH = 1024;   // threads of the one block
constexpr int GT = 128;     // block_gemm output tile edge (32×32 threads × 4×4)
constexpr int GK = 32;      // block_gemm K slab

struct Smem {
  float As[GK][GT + 4];     // A slab, k-major: As[k][i]
  float Bs[GK][GT + 4];     // B slab: Bs[k][j]
  float blk[IB][IB + 1];    // the unblocked diagonal block
  float inv[IB][IB + 1];    // its inverse
};

// C = alpha·A·B + beta·C for 0 ≤ i < M, 0 ≤ j < N, by the whole block.
// A(i, k) = A[i·sar + k·sac], B(k, j) = B[k·sbr + j·sbc], C(i, j) =
// C[i·ldc + j].  a_lower: A(i, k) = 0 for k > i, so K slabs past a tile's
// last row are skipped; b_lower: B(k, j) = 0 for k < j, so K slabs before
// a tile's first column are skipped (the zeros must be stored: the skip
// is by slab, not by element).  c_lower: only i ≥ j is written, and
// tiles wholly above the diagonal are skipped.  beta == 0 never reads C.
// C must not overlap A or B.  Ends with __syncthreads.
static __device__ void block_gemm(Smem& s, int M, int N, int K, float alpha,
                                  const float* A, int64_t sar, int64_t sac,
                                  bool a_lower,
                                  const float* B, int64_t sbr, int64_t sbc,
                                  bool b_lower,
                                  float beta, float* C, int64_t ldc,
                                  bool c_lower) {
  const int tid = threadIdx.x;
  const int tx = tid % 32, ty = tid / 32;
  for (int m0 = 0; m0 < M; m0 += GT) {
    for (int n0 = 0; n0 < N; n0 += GT) {
      if (c_lower && n0 > m0 + GT - 1) continue;
      const int kb = b_lower ? (n0 / GK) * GK : 0;
      const int ke = a_lower ? min(K, m0 + GT) : K;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int k0 = kb; k0 < ke; k0 += GK) {
#pragma unroll
        for (int r = 0; r < (GT * GK) / NTH; ++r) {
          const int e = tid + r * NTH;
          int i, k;
          if (sac == 1) { k = e % GK; i = e / GK; } else { i = e % GT; k = e / GT; }
          float v = 0.f;
          if (m0 + i < M && k0 + k < K)
            v = A[(int64_t)(m0 + i) * sar + (int64_t)(k0 + k) * sac];
          s.As[k][i] = v;
        }
#pragma unroll
        for (int r = 0; r < (GT * GK) / NTH; ++r) {
          const int e = tid + r * NTH;
          int j, k;
          if (sbc == 1) { j = e % GT; k = e / GT; } else { k = e % GK; j = e / GK; }
          float v = 0.f;
          if (n0 + j < N && k0 + k < K)
            v = B[(int64_t)(k0 + k) * sbr + (int64_t)(n0 + j) * sbc];
          s.Bs[k][j] = v;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < GK; ++k) {
          const float4 a = *reinterpret_cast<const float4*>(&s.As[k][ty * 4]);
          const float4 b = *reinterpret_cast<const float4*>(&s.Bs[k][tx * 4]);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gi = m0 + ty * 4 + i;
        if (gi >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gj = n0 + tx * 4 + j;
          if (gj >= N || (c_lower && gj > gi)) continue;
          float* c = C + (int64_t)gi * ldc + gj;
          *c = beta == 0.f ? alpha * acc[i][j] : alpha * acc[i][j] + beta * *c;
        }
      }
    }
  }
  __syncthreads();
}

// Unblocked right-looking Cholesky of the lower (IB, IB) block in s.blk, in
// place (the reference's _chol_unblocked, pallas_kernels.py:282).  Run by
// one warp: lane r owns row r.
static __device__ void chol_unblocked_warp(Smem& s) {
  const int r = threadIdx.x % 32;
  for (int j = 0; j < IB; ++j) {
    const float ajj = s.blk[j][j];
    const float inv = 1.f / sqrtf(ajj);
    __syncwarp();
    const float v = s.blk[r][j] * inv;
    if (r == j) s.blk[j][j] = ajj * inv;
    else if (r > j) s.blk[r][j] = v;
    __syncwarp();
    if (r > j)
      for (int c = j + 1; c <= r; ++c) s.blk[r][c] = fmaf(-v, s.blk[c][j], s.blk[r][c]);
    __syncwarp();
  }
}

// Inverse of the lower non-unit (IB, IB) triangle in s.blk into s.inv by
// row-wise forward substitution (the reference's _trtri_unblocked).  Run
// by one warp: lane c owns column c, which needs no other lane's values.
static __device__ void trtri_unblocked_warp(Smem& s) {
  const int c = threadIdx.x % 32;
  for (int i = 0; i < IB; ++i) {
    float acc = (i == c) ? 1.f : 0.f;
    for (int k = 0; k < i; ++k) acc = fmaf(-s.blk[i][k], s.inv[k][c], acc);
    s.inv[i][c] = acc / s.blk[i][i];
  }
  __syncwarp();
}

// Load the lower triangle of the (IB, IB) block at L (row stride ld) into
// s.blk, zeros above the diagonal.  One warp: lane r loads row r.
static __device__ void load_lower_block_warp(Smem& s, const float* L, int64_t ld) {
  const int r = threadIdx.x % 32;
  for (int c = 0; c < IB; ++c)
    s.blk[r][c] = (r >= c) ? L[(int64_t)r * ld + c] : 0.f;
  __syncwarp();
}

}  // namespace tri_panel
