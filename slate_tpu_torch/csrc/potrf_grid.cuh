// Device code of the cooperative Cholesky kernels: potrf_step_fused.cu (one
// step at a given k0) and potrf_full_fused.cu (the loop of steps), as the
// Pallas kernels share _potrf_panel_phase and _potrf_trailing_stream
// (slate_tpu/ops/pallas_kernels.py:1542-1601), and chol_l21_panel.cu,
// ppotrf's panel, which is the step's phases A and B (chol_panel) on a
// panel of its own.  The step is ONE right-looking step of the lower
// Cholesky factorization of the (n, n) carry at column k0.
//
// The function (the TPU kernel's contract):
//   * the (nb, nb) diagonal block becomes L11 (zeros above its diagonal),
//     with L11⁻¹ formed beside it;
//   * the rows below it in the block column become L21 = A21·L11⁻ᵀ;
//   * the trailing block loses L21·L21ᵀ on the (tc, tc) tile pairs (i, j)
//     with i ≥ j — the diagonal tiles whole, the tiles above them never;
//   * rows and columns before k0, the rows above the diagonal block in its
//     block column and everything right of it above the trailing block
//     pass through untouched.
//
// Execution model: one cooperative grid of 256-thread blocks (tri_grid.cuh),
// one an SM (at two, 128 registers, the 128 × 128 tile spills), the step
// in three phases separated by grid.sync():
//   A. (L11, L11⁻¹) of the diagonal block by the whole grid
//      (chol_inv_grid: its 32 × 32 trailing tiles over the blocks, one grid
//      barrier a 32-step, then the doubling's tiles), into scratch;
//   B. L21 = A21·L11⁻ᵀ in 128 × 128 tile_gemm tiles (8 × 8 fragments, two
//      slab buffers; L11⁻ᵀ read as the transpose of L11⁻¹, its zero slabs
//      skipped) into a scratch (n, nb) copy: in place would race, since a
//      tile's rows are read by the other tiles of its row; and L11 into the
//      carry;
//   C. L21 into the carry's block column, and the trailing update, 128 ×
//      128 tiles of the lower (tc, tc) pairs, each C − L21_I·L21_Jᵀ with
//      K = nb read from the copy, block column k + 1's tiles first (the TPU
//      kernel's look-ahead order).
// Each element's sum runs over k ascending by fmaf from zero and the
// epilogues are c − Σ and Σ; slabs of stored zeros are skipped, which
// changes no sum.  So the diagonal block is bitwise chol_inv_panel.cu's
// factor of it, and the full kernel, which runs this step for k0 = 0, nb,
// …, is bitwise the chain of step launches.  Every global read is __ldcg.
// FFMA in full fp32; no library call.

#pragma once

#include "tri_grid.cuh"

namespace potrf_grid {

using namespace tri_grid;

constexpr int T = 128;   // the L21 and trailing tile edge

struct Params {
  float* a;        // (n, n) carry, row stride ld
  int64_t ld;
  float* lkk;      // (nb, nb) scratch: L11
  float* linv;     // (nb, nb) scratch: L11⁻¹
  float* s;        // nb² floats: chol_inv_grid's scratch
  float* l21;      // (n - nb, nb) scratch: L21, row r - (k0 + nb)
  int n, nb, tc;
};

// Shapes the kernels take: nb a power of two ≥ 128, tc a multiple of 128
// dividing nb, nb dividing n, row stride ≥ n.
inline bool shape_ok(const Params& p) {
  return p.nb >= T && (p.nb & (p.nb - 1)) == 0 && p.tc >= T && p.tc % T == 0 &&
         p.nb % p.tc == 0 && p.n >= p.nb && p.n % p.nb == 0 && p.ld >= p.n;
}

// Trailing tiles of nrt × nrt at tile pair height per: column J holds the
// tiles I ≥ (J / per)·per.
__host__ __device__ inline int trailing_tiles(int nrt, int per) {
  int total = 0;
  for (int J = 0; J < nrt; ++J) total += nrt - J / per * per;
  return total;
}

// Tile u of that list, column by column (so block column k + 1 first).
__device__ inline void trailing_tile(int u, int nrt, int per, int& I, int& J) {
  J = 0;
  for (int c = nrt; u >= c; c = nrt - J / per * per) {
    u -= c;
    ++J;
  }
  I = J / per * per + u;
}

// The grid a kernel of this step needs for (n, nb, tc): co-resident blocks,
// capped at the widest phase's tiles (the diagonal block's, or the first
// step's L21 or trailing tiles).
inline int plan(const void* kernel, int n, int nb, int tc, int* G) {
  const int nrt = (n - nb) / T;
  int want = chol_inv_grid_tiles(nb);
  if (nrt * (nb / T) > want) want = nrt * (nb / T);
  if (tc >= T && trailing_tiles(nrt, tc / T) > want) want = trailing_tiles(nrt, tc / T);
  return plan_grid(kernel, want, G);
}

// Phases A and B of a Cholesky panel by every block of the grid: (L, L⁻¹)
// of the (nb, nb) SPD block D (row stride ldd; only its lower triangle is
// read) into the contiguous L and Linv by chol_inv_grid (S: its nb²
// scratch), a grid barrier, then X = P·L⁻ᵀ for the (m, nb) panel P (row
// stride ldp) in 128 × 128 tile_gemm tiles: B(k, j) = L⁻¹[j, k], zero for
// k > j, so the tiles of column ct run ct + 1 slabs (the widest first).
// store(i, j, v) writes X(i, j).  m a multiple of 128 (0: no product),
// nb a power of two ≥ 128.  Ends with no grid barrier.
template <class Store>
__device__ void chol_panel(float* sm, cg::grid_group& grid, const float* D, int64_t ldd,
                           float* L, float* Linv, float* S, int nb, const float* P,
                           int64_t ldp, int m, Store store) {
  chol_inv_grid(sm, grid, D, ldd, L, Linv, S, nb);
  grid.sync();
  const int nrt = m / T, nct = nb / T;
  for (int u = blockIdx.x; u < nrt * nct; u += gridDim.x)
    tile_gemm<T, T, FULL, UPPER, false, true>(sm, u % nrt * T, (nct - 1 - u / nrt) * T, m,
                                              nb, nb, P, ldp, Linv, nb, store);
}

// The step at k0 by every block of the grid.  Every block passes the same
// grid barriers; the step ends with none (the trailing phase's writes need
// a grid barrier before the next step reads them).
__device__ inline void step(float* sm, cg::grid_group& grid, const Params& p, int k0) {
  const int g = blockIdx.x, G = gridDim.x, tid = threadIdx.x;
  const int n = p.n, nb = p.nb, per = p.tc / T;
  const int64_t ld = p.ld;
  float* akk = p.a + (int64_t)k0 * ld + k0;
  const int r0 = k0 + nb, nt = n - r0;
  float* l21 = p.l21;
  // A and B. the diagonal block by the whole grid, then L21 = A21·L11⁻ᵀ
  // into the scratch copy
  chol_panel(sm, grid, akk, ld, p.lkk, p.linv, p.s, nb, p.a + (int64_t)r0 * ld + k0, ld,
             nt, [&](int i, int j, float v) { l21[(int64_t)i * nb + j] = v; });
  // L11 into the carry (phase B reads only the rows below it)
  for (int64_t e = (int64_t)g * NTH + tid; e < (int64_t)nb * nb; e += (int64_t)G * NTH)
    akk[(e / nb) * ld + e % nb] = __ldcg(p.lkk + e);
  if (nt == 0) return;
  grid.sync();

  // C. L21 into the carry's block column, and the trailing tiles whose
  //    (tc, tc) pair lies on or below the diagonal
  for (int64_t e = (int64_t)g * NTH + tid; e < (int64_t)nt * nb; e += (int64_t)G * NTH)
    p.a[(r0 + e / nb) * ld + k0 + e % nb] = __ldcg(l21 + e);
  float* c = p.a + (int64_t)r0 * ld + r0;
  const int nrt = nt / T;
  const int tiles = trailing_tiles(nrt, per);
  for (int u = g; u < tiles; u += G) {
    int I, J;
    trailing_tile(u, nrt, per, I, J);
    tile_gemm<T, T, FULL, FULL, false, true>(
        sm, I * T, J * T, nt, nt, nb, l21, nb, l21, nb, [&](int i, int j, float v) {
          float* x = c + (int64_t)i * ld + j;
          *x = __ldcg(x) - v;
        });
  }
}

}  // namespace potrf_grid
