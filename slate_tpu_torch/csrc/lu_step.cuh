// Device code of the cooperative partial-pivot LU step kernel,
// getrf_step_fused.cu (getrf_full_fused.cu runs the same step over the
// active lanes only, lu_full.cuh), as the Pallas kernels share
// _fused_panel_phase, _newton_x2 and _lu_chunk_update
// (slate_tpu/ops/pallas_kernels.py:922, :1219, :1233): the trailing phase
// of ONE right-looking step on the transposed (n_rows, m) scattered carry,
// after the panel phase (lu_panel.cuh) has factored rows [k0, k0 + nb).
//
// The function.  X is the panel's unit-lower pivot-block inverse and L11
// its pivot block, L11[i, k] = carry[k0 + k, piv[i]] (i > k).  Then
//   X₂ = X·(2I − L11·X)                  (one Newton step, the composed
//                                          driver's correction pair)
//   U  = C[:, piv]·X₂ᵀ                   (the solved U12, transposed)
//   C[:, l] -= U·L[:, l]   for every lane l still active after the panel
//   C[:, piv] = U                          (the u12 scatter)
// over the trailing rows C = carry[k0 + nb:], with L[j, l] = carry[k0 + j,
// l]; lanes retired before the panel pass through untouched.  `update` =
// 0 (the fused_trsm depth) skips the rank-nb update and only scatters U.
// On the TPU the pivot gather is folded into MXU products with one-hot
// matrices, G = X₂·Π and W = Π − Lᵀ, so that each trailing row block is
// rows·(1 − pivm) + (rows·Gᵀ)·W (pallas_kernels.py:1264-1270); that is the
// same function, which here is a gather of the nb pivot lanes, two
// products and a scatter, with no product by a one-hot matrix.
//
// Execution model: the grid of the panel phase (one 256-thread block per
// SM, each holding its lanes of the panel in shared memory) goes on to the
// trailing phase, reusing its dynamic shared memory for 128 × 128 product
// tiles (8 × 8 FFMA register blocks per thread, K staged 16 at a time, as
// matmul.cu).  The phases are separated by grid.sync():
//   1. T = L11·X, the lower 128-tiles (L11 gathered through piv);
//   2. X₂ = 2X − X·T, the lower 128-tiles;
//   3. U = C[:, piv]·X₂ᵀ, 128 rows × 128 columns a tile;
//   4. the rank-nb update, 128 rows × 128 lanes a tile, writing the lanes
//      active after the panel, and the scatter of U into the pivot lanes
//      (disjoint lanes, so the two need no barrier between them).
// Every lane is multiplied, the retired ones by a zero multiplier row and
// then not written: the masked form of the TPU kernel, which does more
// FLOP than the active lanes need once many lanes have retired.  Every
// global read goes through L2 (__ldcg): other blocks wrote the data in the
// same launch, and L1 is not coherent across SMs.

#pragma once

#include "lu_panel.cuh"

namespace lu_step {

namespace cg = cooperative_groups;
using lu_panel::NT;

constexpr int TM = 128, TN = 128, TK = 16, PAD = 4;
// dynamic shared memory the trailing phase needs: the A and B slabs and a
// tile's lane mask (ops/smem.py LU_STEP_GEMM_FLOATS)
constexpr int64_t GEMM_FLOATS = 2 * TK * (TM + PAD) + TN;

struct Params {
  lu_panel::Params pp;  // the panel phase: in = out = carry + k0·ld
  float* carry;         // (n_rows, m), row stride ld
  int64_t ld;
  int n_rows, k0, nb;
  float* t;             // (nb, nb) scratch: L11·X
  float* x2;            // (nb, nb) scratch: X₂
  float* u;             // (n_rows - nb, nb) scratch: U, row r - (k0 + nb)
  int update;
};

// A pivot lane (written by the panel phase in the same launch).
__device__ __forceinline__ int ldpiv(const int64_t* q) {
  return (int)__ldcg(reinterpret_cast<const long long*>(q));
}

// Tile row / column of accumulator entry (i, j) of thread (ty, tx).
__device__ __forceinline__ int tile_row(int i) {
  return i < 4 ? (threadIdx.x / 16) * 4 + i : 64 + (threadIdx.x / 16) * 4 + (i - 4);
}
__device__ __forceinline__ int tile_col(int j) {
  return j < 4 ? (threadIdx.x % 16) * 4 + j : 64 + (threadIdx.x % 16) * 4 + (j - 4);
}

// acc = Σ_{k ∈ [kb, ke)} A(i, k)·B(k, j) for the TM × TN tile, (i, j)
// tile-local; la(i, k) and lb(k, j) return the operands (0 outside the
// matrices).  A_KFAST: neighbouring threads load neighbouring k of A, else
// neighbouring i; B_KFAST likewise.  sm: 2·TK·(TM + PAD) floats of shared
// memory.  Ends with __syncthreads.
template <bool A_KFAST, bool B_KFAST, class LA, class LB>
__device__ __forceinline__ void tile_mma(float* sm, const LA& la, const LB& lb,
                                         int kb, int ke, float (&acc)[8][8]) {
  float(*As)[TM + PAD] = reinterpret_cast<float(*)[TM + PAD]>(sm);
  float(*Bs)[TN + PAD] = reinterpret_cast<float(*)[TN + PAD]>(sm + TK * (TM + PAD));
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = kb; k0 < ke; k0 += TK) {
#pragma unroll
    for (int r = 0; r < (TM * TK) / NT; ++r) {
      const int e = tid + r * NT;
      int i, k;
      if (A_KFAST) { k = e % TK; i = e / TK; } else { i = e % TM; k = e / TM; }
      As[k][i] = k0 + k < ke ? la(i, k0 + k) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < (TN * TK) / NT; ++r) {
      const int e = tid + r * NT;
      int j, k;
      if (B_KFAST) { k = e % TK; j = e / TK; } else { j = e % TN; k = e / TN; }
      Bs[k][j] = k0 + k < ke ? lb(k0 + k, j) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// The trailing phase of the step at p.k0, by every block of the grid,
// after the panel phase and a grid barrier.  Three grid barriers inside;
// none at the end.
static __device__ void trailing(const Params& p, float* sm, cg::grid_group& grid) {
  const int g = blockIdx.x, G = gridDim.x, tid = threadIdx.x;
  const int nb = p.nb, m = p.pp.m, k0 = p.k0, r0 = k0 + nb;
  const int nt = p.n_rows - r0;
  const int64_t ld = p.ld;
  const float* carry = p.carry;
  const int64_t* piv = p.pp.piv;
  const float* X = p.pp.linv;
  const float* act = p.pp.act_out;
  const float* L = carry + (int64_t)k0 * ld;      // the factored panel rows
  const int nbt = nb / TM;
  float acc[8][8];

  // 1. T = L11·X on the lower tiles: T[I, J] sums k ∈ [J·TM, (I + 1)·TM)
  for (int u = g; u < nbt * nbt; u += G) {
    const int I = u / nbt, J = u % nbt;
    if (I < J) continue;
    auto la = [&](int i, int k) -> float {
      const int row = I * TM + i;
      if (k > row) return 0.f;
      if (k == row) return 1.f;
      return __ldcg(L + (int64_t)k * ld + ldpiv(piv + row));
    };
    auto lb = [&](int k, int j) { return __ldcg(X + (int64_t)k * nb + J * TN + j); };
    tile_mma<true, false>(sm, la, lb, J * TM, (I + 1) * TM, acc);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        p.t[(int64_t)(I * TM + tile_row(i)) * nb + J * TN + tile_col(j)] = acc[i][j];
  }
  grid.sync();

  // 2. X₂ = 2X − X·T on the lower tiles
  for (int u = g; u < nbt * nbt; u += G) {
    const int I = u / nbt, J = u % nbt;
    if (I < J) continue;
    auto la = [&](int i, int k) { return __ldcg(X + (int64_t)(I * TM + i) * nb + k); };
    auto lb = [&](int k, int j) { return __ldcg(p.t + (int64_t)k * nb + J * TN + j); };
    tile_mma<true, false>(sm, la, lb, J * TM, (I + 1) * TM, acc);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int64_t e = (int64_t)(I * TM + tile_row(i)) * nb + J * TN + tile_col(j);
        p.x2[e] = 2.f * __ldcg(X + e) - acc[i][j];
      }
  }
  grid.sync();

  // 3. U = C[:, piv]·X₂ᵀ: U[r, j] sums k ≤ j (X₂ lower), k < (J + 1)·TN
  const int nrt = lu_panel::ceildiv(nt, TM);
  for (int u = g; u < nrt * nbt; u += G) {
    const int R = u / nbt, J = u % nbt;
    auto la = [&](int i, int k) -> float {
      const int r = R * TM + i;
      if (r >= nt) return 0.f;
      return __ldcg(carry + (int64_t)(r0 + r) * ld + ldpiv(piv + k));
    };
    auto lb = [&](int k, int j) { return __ldcg(p.x2 + (int64_t)(J * TN + j) * nb + k); };
    tile_mma<true, true>(sm, la, lb, 0, (J + 1) * TN, acc);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = R * TM + tile_row(i);
      if (r >= nt) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) p.u[(int64_t)r * nb + J * TN + tile_col(j)] = acc[i][j];
    }
  }
  grid.sync();

  // 4. the rank-nb update of the lanes active after the panel, and the
  //    scatter of U into this step's pivot lanes
  if (p.update) {
    float* mask = sm + 2 * TK * (TM + PAD);
    const int nlt = lu_panel::ceildiv(m, TN);
    for (int u = g; u < nrt * nlt; u += G) {
      const int R = u / nlt, Lt = u % nlt;
      if (tid < TN) {
        const int l = Lt * TN + tid;
        mask[tid] = (l < m && __ldcg(act + l) > 0.f) ? 1.f : 0.f;
      }
      __syncthreads();
      auto la = [&](int i, int k) -> float {
        const int r = R * TM + i;
        return r < nt ? __ldcg(p.u + (int64_t)r * nb + k) : 0.f;
      };
      auto lb = [&](int k, int j) -> float {
        return mask[j] > 0.f ? __ldcg(L + (int64_t)k * ld + Lt * TN + j) : 0.f;
      };
      tile_mma<true, false>(sm, la, lb, 0, nb, acc);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = R * TM + tile_row(i);
        if (r >= nt) continue;
        float* crow = p.carry + (int64_t)(r0 + r) * ld + Lt * TN;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tile_col(j);
          if (mask[c] > 0.f) crow[c] = __ldcg(crow + c) - acc[i][j];
        }
      }
      __syncthreads();
    }
  }
  for (int64_t e = (int64_t)g * NT + tid; e < (int64_t)nt * nb; e += (int64_t)G * NT)
    p.carry[(int64_t)(r0 + e / nb) * ld + ldpiv(piv + e % nb)] = __ldcg(p.u + e);
}

}  // namespace lu_step
