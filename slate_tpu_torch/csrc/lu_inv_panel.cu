// No-pivot LU of an (nb, nb) block and the inverses of both factors in one
// launch: the port of the Pallas kernel `lu_inv_panel`
// (slate_tpu/ops/pallas_kernels.py:417-557: _lu_unblocked,
// _triu_tri_unblocked, _block_uinv_doubling, _lu_inv_kernel).  Same blocked
// algorithm, ib = 32: per inner block an unblocked LU and the inverses of its
// unit-lower and upper triangles, L21 = A21·U11⁻¹, U12 = L11⁻¹·A12, the
// trailing update A22 −= L21·U12; then L⁻¹ and U⁻¹ by recursive doubling.
// Its caller is the Householder reconstruction of the CholQR² QR panel
// (slate_tpu_torch/linalg/qr.py:_cholqr2_panel), whose block needs no
// pivoting.
//
// What bounds it on an H100: ~4/3·nb³ FLOP (1.8e8 at nb = 512) over 4 MB of
// inputs and outputs, a few microseconds at the card's fp32 peak, but the
// algorithm is a chain of dependent steps that the TPU ran inside one
// core's VMEM.  As chol_inv_panel.cu, one block of 1024 threads on one SM
// owns the whole panel, which stays in global memory (L2-resident) while
// 32-wide slabs are staged through shared memory (tri_panel.cuh): the bound
// in practice is one SM's FFMA rate and its L2 bandwidth, plus a barrier
// per phase.  The 32×32 LU and the inverses of its triangles run in shared
// memory on one warp; L21, U12, the trailing update and the doubling
// products are block_gemm calls.  U⁻¹ is the transpose of the lower inverse
// of Uᵀ: U is transposed into scratch, tri_panel.cuh's lower doubling runs
// on it, and the result is transposed in place, so no upper-triangular copy
// of the doubling code is needed.  Spreading the panel over a cluster is
// later work.

#include "tri_panel.cuh"

namespace {

using namespace tri_panel;

// Load the whole (IB, IB) block at A (row stride ld) into s.blk.  One warp:
// lane c loads column c, so each row is one coalesced read.
static __device__ void load_block_warp(Smem& s, const float* A, int64_t ld) {
  const int c = threadIdx.x % 32;
  for (int r = 0; r < IB; ++r) s.blk[r][c] = A[(int64_t)r * ld + c];
  __syncwarp();
}

// Store s.blk or s.inv (src) to the (IB, IB) block at A.  One warp.
static __device__ void store_block_warp(float (*src)[IB + 1], float* A,
                                        int64_t ld) {
  const int c = threadIdx.x % 32;
  for (int r = 0; r < IB; ++r) A[(int64_t)r * ld + c] = src[r][c];
  __syncwarp();
}

// Unblocked right-looking no-pivot LU of s.blk in place, packed: unit L
// strictly below the diagonal, U on and above (the reference's
// _lu_unblocked).  One warp: lane r owns row r; row j is only read while
// column j is eliminated.
static __device__ void lu_unblocked_warp(Smem& s) {
  const int r = threadIdx.x % 32;
  for (int j = 0; j < IB - 1; ++j) {
    if (r > j) {
      const float l = s.blk[r][j] / s.blk[j][j];
      s.blk[r][j] = l;
      for (int c = j + 1; c < IB; ++c) s.blk[r][c] = fmaf(-l, s.blk[j][c], s.blk[r][c]);
    }
    __syncwarp();
  }
}

// Inverse of the unit-lower triangle of s.blk (its strict lower part, ones
// on the diagonal) into s.inv by row-wise forward substitution (the
// reference's _trtri_unblocked on tril(blk, -1) + I).  One warp: lane c
// owns column c, which needs no other lane's values.
static __device__ void unit_lower_inv_warp(Smem& s) {
  const int c = threadIdx.x % 32;
  for (int i = 0; i < IB; ++i) {
    float acc = (i == c) ? 1.f : 0.f;
    for (int k = 0; k < i; ++k) acc = fmaf(-s.blk[i][k], s.inv[k][c], acc);
    s.inv[i][c] = acc;
  }
  __syncwarp();
}

// Transpose s.blk in place.  One warp: lane r swaps the pairs (r, c), c < r.
static __device__ void transpose_block_warp(Smem& s) {
  const int r = threadIdx.x % 32;
  for (int c = 0; c < r; ++c) {
    const float t = s.blk[r][c];
    s.blk[r][c] = s.blk[c][r];
    s.blk[c][r] = t;
  }
  __syncwarp();
}

__global__ void __launch_bounds__(NTH, 1)
lu_inv_panel_kernel(const float* A, int64_t lda, float* LU, float* Linv,
                    float* Uinv, float* Ut, float* W, int nb) {
  __shared__ __align__(16) Smem s;
  const int tid = threadIdx.x;
  const int64_t nn = (int64_t)nb * nb;
  for (int64_t e = tid; e < nn; e += NTH) {
    LU[e] = A[(e / nb) * lda + e % nb];
    Linv[e] = 0.f;
    Uinv[e] = 0.f;
  }
  __syncthreads();

  // Uinv holds Y = (U⁻¹)ᵀ, lower, until the transpose at the end.
  for (int k0 = 0; k0 < nb; k0 += IB) {
    float* akk = LU + (int64_t)k0 * nb + k0;
    float* lkk = Linv + (int64_t)k0 * nb + k0;
    float* ykk = Uinv + (int64_t)k0 * nb + k0;
    if (tid < 32) {
      load_block_warp(s, akk, nb);
      lu_unblocked_warp(s);
      store_block_warp(s.blk, akk, nb);
      unit_lower_inv_warp(s);
      store_block_warp(s.inv, lkk, nb);
      transpose_block_warp(s);         // U11ᵀ on and below the diagonal
      trtri_unblocked_warp(s);         // (U11ᵀ)⁻¹ = (U11⁻¹)ᵀ
      store_block_warp(s.inv, ykk, nb);
    }
    __syncthreads();
    const int m = nb - k0 - IB;
    if (m > 0) {
      float* a21 = LU + (int64_t)(k0 + IB) * nb + k0;
      float* a12 = akk + IB;
      float* l21 = W;                        // (m, IB)
      float* u12 = W + (int64_t)m * IB;      // (IB, m)
      // L21 = A21 · U11⁻¹, U11⁻¹(k, j) = Y(j, k)
      block_gemm(s, m, IB, IB, 1.f, a21, nb, 1, false, ykk, 1, nb, false, 0.f,
                 l21, IB, false);
      // U12 = L11⁻¹ · A12
      block_gemm(s, IB, m, IB, 1.f, lkk, nb, 1, true, a12, nb, 1, false, 0.f,
                 u12, m, false);
      // A22 −= L21 · U12
      block_gemm(s, m, m, IB, -1.f, l21, IB, 1, false, u12, m, 1, false, 1.f,
                 a21 + IB, nb, false);
      for (int e = tid; e < m * IB; e += NTH) {
        a21[(int64_t)(e / IB) * nb + e % IB] = l21[e];
        a12[(int64_t)(e / m) * nb + e % m] = u12[e];
      }
      __syncthreads();
    }
  }
  // L⁻¹: the doubling reads only the blocks below the diagonal blocks of
  // the packed factor, which are all L.
  block_inv_doubling(s, LU, nb, Linv, nb, W, nb);
  for (int64_t e = tid; e < nn; e += NTH) Ut[e] = LU[(e % nb) * nb + e / nb];
  __syncthreads();
  block_inv_doubling(s, Ut, nb, Uinv, nb, W, nb);
  for (int64_t e = tid; e < nn; e += NTH) {
    const int64_t i = e / nb, j = e % nb;
    if (i < j) {
      const float t = Uinv[e];
      Uinv[e] = Uinv[j * nb + i];
      Uinv[j * nb + i] = t;
    }
  }
}

}  // namespace

// A: (nb, nb) with row stride lda.  LU, Linv, Uinv: contiguous (nb, nb)
// outputs.  W: scratch of nb² + max((nb/2)², 2·nb·32) floats.  nb a power
// of two ≥ 32.
extern "C" int slate_lu_inv_panel_f32(const float* A, int64_t lda, float* LU,
                                      float* Linv, float* Uinv, float* W,
                                      int nb, cudaStream_t stream) {
  if (nb < IB || (nb & (nb - 1)) != 0 || lda < nb)
    return (int)cudaErrorInvalidValue;
  const int64_t nn = (int64_t)nb * nb;
  lu_inv_panel_kernel<<<1, NTH, 0, stream>>>(A, lda, LU, Linv, Uinv, W,
                                             W + nn, nb);
  return (int)cudaGetLastError();
}
