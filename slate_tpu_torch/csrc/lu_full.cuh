// Device code of the partial-pivot LU kernels that run a step over the
// lanes still active: ONE step of getrf_step_fused.cu at a given k0, and the
// whole factorization of getrf_full_fused.cu, a loop of the same step.  The
// panel is the blocked elimination of lu_panel.cuh's panel kernels over a
// list of lanes, on the whole grid with one grid barrier a column, then
// the trailing phase on double-buffered product tiles.  The panel rounds
// every element as the panel kernels do, so a step's panel is bitwise
// getrf_panel_fused's from the same state (two independent
// implementations); and the full launch runs this same step code at every
// k0, so it is bitwise the chain of step launches.
//
// The trailing phase of a step at k0 (X the panel's unit-lower pivot-block
// inverse, L11[i, k] = carry[k0 + k, piv[i]] for i > k):
//   X₂ = X·(2I − L11·X)                  (one Newton step)
//   U  = C[:, piv]·X₂ᵀ                   (the solved U12, transposed)
//   C[:, l] -= U·L[:, l]   for every lane l still active after the panel
//   C[:, piv] = U                          (the u12 scatter)
// over the trailing rows C = carry[k0 + nb:], L[j, l] = carry[k0 + j, l];
// lanes retired before the panel pass through untouched.  The TPU kernel
// folds the pivot gather into MXU products with one-hot matrices
// (slate_tpu/ops/pallas_kernels.py:1264-1270); here it is a gather.
//
// How the step runs, and why its sums do not depend on it:
//   * The active lanes.  Before each panel the grid holds the ascending
//     list of the lanes still active (a compaction of the previous list by
//     the mask, by one block while the others run the first products), and
//     both the panel and the rank-nb update run over that list.  A retired
//     lane is left untouched by the panel and by the update, so dropping
//     it changes no element.  The panel's argmax keeps the lowest lane among
//     equal maxima (the list is ascending, and the candidates carry their
//     lane), and every per-lane operation is lu_panel.cuh's.
//   * The products.  T = L11·X and X₂ = 2X − X·T on tri_grid.cuh's
//     tile_gemm in 32 × 32 tiles (the nb² products are latency-bound, so
//     small tiles spread them over the blocks), with L11 written out as a
//     unit-lower matrix by the panel; meanwhile the blocks gather
//     C[:, piv] into a contiguous copy, so that U = C[:, piv]·X₂ᵀ runs on
//     tile_gemm's 128-tiles (X₂ read transposed); the rank-nb update on
//     gather_tile below, a 128 × 128 tile with tile_gemm's two slabs and
//     two register sets in flight, whose B operand's columns are the
//     tile's active lanes, held in shared memory.  Every element is an
//     fmaf sum from zero over ascending k; tiles only skip k whose operand
//     is a stored or known zero, and which lanes share a tile changes no
//     sum.
//   * The panel's inner-block end.  The U12 rows, the block inverse and
//     the products of the new rows of L11⁻¹ run at once on separate warps
//     (registers for ib = 16), and the pivot columns' rows are padded in
//     shared memory; the sums are lu_panel.cuh's, in its order.
//
// Execution model: a cooperative grid planned by lu_panel.cuh's
// plan_grid_for (one 256-thread block per SM, the panel's lanes in dynamic
// shared memory), grid.sync() between phases.  Every global read of data written in the launch goes
// through L2 (__ldcg).

#pragma once

#include "lu_panel.cuh"
#include "tri_grid.cuh"

namespace lu_full {

namespace cg = cooperative_groups;
using lu_panel::ceildiv;
using lu_panel::ColumnBarrier;   // the panels' column barrier over the whole grid
using lu_panel::copy_batched;
using lu_panel::NT;
using lu_panel::NWARP;

static_assert(NT == tri_grid::NTH, "one block shape for the panel and the tiles");

constexpr int TT = 128;    // gather_tile's edge
constexpr int U12_WARPS = 5;   // warps of the panel's U12 substitution
constexpr int DR = 4, DL = 4;  // a thread's rows and lanes in the panel's delayed update
constexpr int TS = 32;     // the nb² products' tile edge
// dynamic shared memory of the trailing phase, floats: the product tiles'
// slabs (tile_gemm's 32-tiles need the most: its SMEM_FLOATS), then the
// step's nb pivot lanes and a tile's 128 active lanes (ops/smem.py
// LU_FULL_TRAIL_FLOATS)
constexpr int TILE_FLOATS = tri_grid::SMEM_FLOATS;

__host__ __device__ inline int64_t trail_floats(int nb) { return TILE_FLOATS + nb + TT; }

struct Params {
  float* carry;        // (n_rows, m), row stride ld, factored in place
  int64_t ld;
  int n_rows, m, nb, ib, G;
  float* act;          // (m) the active mask (> 0: active), in place
  int64_t* piv;        // pivot lanes in factorization order, from column piv_k0
  int piv_k0;          // the column of piv[0]: 0 for the whole LU, k0 for a step
  float* linv;         // (nb, nb) L11⁻¹ of the current panel
  float* cand;         // [2][G][nb] published candidate columns
  float* cval;         // [2][G] candidate |value| (-1: none)
  int* clane;          // [2][G] candidate lane (m: none)
  float* l11;          // (nb, nb) the panel's unit-lower pivot block
  float* t;            // (nb, nb) L11·X
  float* x2;           // (nb, nb) X₂
  float* u;            // (n_rows - nb, nb) U, row r - (k0 + nb)
  float* cpiv;         // (n_rows - nb, nb) C[:, piv], row r - (k0 + nb)
  int* lanes;          // [2][m] the active lanes of a step, ascending
  int* na;             // [2] how many
  unsigned* bar;       // a zeroed counter: the panels' column barrier
};

// The pivots of the step at k0.
__device__ __forceinline__ int64_t* step_piv(const Params& p, int k0) {
  return p.piv + (k0 - p.piv_k0);
}

// ---------------------------------------------------------------------------
// The list of active lanes
// ---------------------------------------------------------------------------

// out = the lanes of `in` (n of them; in == nullptr: 0 … n − 1) whose mask
// is > 0, in order, and *nout their count, by ONE block: each thread
// counts a contiguous chunk, a block scan places the chunks.  s_cnt: NT
// ints of shared memory.  Ends with __syncthreads.
__device__ inline void compact(const float* act, const int* in, int n, int* out,
                               int* nout, int* s_cnt) {
  const int tid = threadIdx.x;
  const int c = ceildiv(n, NT), s0 = min(n, tid * c), s1 = min(n, s0 + c);
  int cnt = 0;
  for (int s = s0; s < s1; ++s) {
    const int l = in ? __ldcg(in + s) : s;
    cnt += __ldcg(act + l) > 0.f;
  }
  s_cnt[tid] = cnt;
  __syncthreads();
  // inclusive scan over the block (Hillis–Steele; NT is small)
  for (int off = 1; off < NT; off *= 2) {
    const int v = tid >= off ? s_cnt[tid - off] : 0;
    __syncthreads();
    s_cnt[tid] += v;
    __syncthreads();
  }
  int o = s_cnt[tid] - cnt;
  for (int s = s0; s < s1; ++s) {
    const int l = in ? __ldcg(in + s) : s;
    if (__ldcg(act + l) > 0.f) __stcg(out + o++, l);
  }
  if (tid == NT - 1) __stcg(nout, s_cnt[NT - 1]);
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The panel over the active lanes
// ---------------------------------------------------------------------------

// The first part of an inner block's end in the panel (rows [b0, b1)
// factored, their ib pivot columns in P), three jobs on separate warps at
// once, each sum in lu_panel.cuh's order:
//   * warps 0 … 4: U12 of the rows past the block, by forward
//     substitution with the unit-lower L11 of the block (redundant in
//     every block);
//   * warp 5: the block inverse X[b, b] into Xbb, lane c column c;
//   * warps 6 and 7: T = L[b, c:b0]·X[c:b0, c] for the owned linv columns
//     c = g + q·G < b0.
// IBC = ib known at compile time (U12's row and X[b, b]'s column in
// registers), or 0 (the same loops in shared memory).  Ends with
// a block barrier.
template <int IBC>
__device__ void block_end_part1(float* P, float* Xbb, const float* Xo, float* T, int w,
                                int b0, int ib, int nown, int g, int G) {
  const int tid = threadIdx.x, warp = tid / 32, b1 = b0 + ib, pw = w + 1;
  if (warp < U12_WARPS) {
    for (int i = b1 + tid; i < w; i += U12_WARPS * 32) {
      if constexpr (IBC > 0) {
        float u[IBC];
#pragma unroll
        for (int jj = 0; jj < IBC; ++jj) u[jj] = P[jj * pw + i];
#pragma unroll
        for (int jj = 1; jj < IBC; ++jj) {
#pragma unroll
          for (int kk = 0; kk < jj; ++kk)
            u[jj] = fmaf(-P[jj * pw + b0 + kk], u[kk], u[jj]);
          P[jj * pw + i] = u[jj];
        }
      } else {
        for (int jj = 1; jj < ib; ++jj) {
          float u = P[jj * pw + i];
          for (int kk = 0; kk < jj; ++kk)
            u = fmaf(-P[jj * pw + b0 + kk], P[kk * pw + i], u);
          P[jj * pw + i] = u;
        }
      }
    }
  } else if (warp == U12_WARPS) {
    const int c = tid % 32;
    if (c < ib) {
      if constexpr (IBC > 0) {
        float x[IBC];
#pragma unroll
        for (int jj = 0; jj < IBC; ++jj) {
          float acc = jj == c ? 1.f : 0.f;
#pragma unroll
          for (int kk = 0; kk < jj; ++kk)
            if (kk >= c) acc = fmaf(-P[jj * pw + b0 + kk], x[kk], acc);
          x[jj] = jj >= c ? acc : 0.f;
          Xbb[jj * IBC + c] = x[jj];
        }
      } else {
        for (int jj = 0; jj < ib; ++jj) {
          float acc = jj == c ? 1.f : 0.f;
          for (int kk = c; kk < jj; ++kk)
            acc = fmaf(-P[jj * pw + b0 + kk], Xbb[kk * ib + c], acc);
          Xbb[jj * ib + c] = jj >= c ? acc : 0.f;
        }
      }
    }
  } else {
    for (int e = tid - (U12_WARPS + 1) * 32; e < ib * nown; e += (NWARP - U12_WARPS - 1) * 32) {
      const int jj = e % ib, q = e / ib;   // a warp reads few rows of Xo
      const int c = g + q * G;
      const float* a = P + jj * pw;
      const float* x = Xo + (int64_t)q * w;
      float acc = 0.f;
#pragma unroll 8
      for (int k = c; k < b0; ++k) acc = fmaf(a[k], x[k], acc);
      T[jj * nown + q] = acc;
    }
  }
  __syncthreads();
}

// The panel (lu_panel.cuh's elimination) on rows [k0, k0 + nb) of the carry for
// the na lanes of `list`, by every block of the grid: block g holds list
// slots [g·cs, (g+1)·cs), cs = ⌈na / G⌉, in shared memory (lane[l] their
// lanes, ~lane once pivoted; blk[l] the column a lane was pivoted at, −1
// if none), with lu_panel.cuh's arithmetic for each of them, and owns
// the linv columns c ≡ g (mod G).  Ends after the write-back of the
// block's lanes, the zero mask of its pivot lanes, the rows of L11 of its
// pivot lanes and its linv columns, with no grid barrier.  Not inlined,
// so that its registers are allocated for it alone.
__device__ __noinline__ void panel(const Params p, int k0, const int* list, int na,
                                   float* smem, ColumnBarrier& grid) {
  __shared__ float red_v[NWARP];
  __shared__ int red_l[NWARP];
  __shared__ int s_p, s_g;

  const int tid = threadIdx.x, g = blockIdx.x, G = p.G;
  const int m = p.m, w = p.nb, ib = p.ib;
  const int64_t ld = p.ld;
  const int cs = max(1, ceildiv(na, G)), nown = ceildiv(w, G);
  const int nl = max(0, min(cs, na - g * cs));   // lanes this block holds
  float* in = p.carry + (int64_t)k0 * ld;
  int64_t* piv = step_piv(p, k0);

  float* S = smem;                             // S[i·cs + l]: own lanes
  // P[jj·pw + i]: pivot columns, rows padded by one float (the rows' same
  // bank would serialize the linv products' reads; the padding comes out
  // of smem_floats' 64 spare words)
  const int pw = w + 1;
  float* P = S + (int64_t)w * cs;
  float* Xo = P + ib * pw;                     // Xo[q·w + r]: owned linv cols
  float* Xbb = Xo + (int64_t)nown * w;         // Xbb[jj·ib + kk]
  float* T = Xbb + ib * ib;                    // T[jj·nown + q]
  int* lane = reinterpret_cast<int*>(T + ib * nown);  // lane[l]
  int* blk = lane + cs;                        // blk[l]

  for (int l = tid; l < cs; l += NT) {
    lane[l] = l < nl ? __ldcg(list + g * cs + l) : 0;
    blk[l] = -1;
  }
  __syncthreads();
  for (int64_t e = tid; e < (int64_t)w * cs; e += NT) {
    const int i = (int)(e / cs), l = (int)(e % cs);
    S[e] = l < nl ? __ldcg(in + (int64_t)i * ld + lane[l]) : 0.f;
  }
  for (int64_t e = tid; e < (int64_t)nown * w; e += NT) Xo[e] = 0.f;
  __syncthreads();

  for (int b0 = 0; b0 < w; b0 += ib) {
    const int b1 = b0 + ib;
    for (int jj = 0; jj < ib; ++jj) {
      const int j = b0 + jj;
      const int buf = j & 1;
      // 1. masked argmax over this block's lanes (ascending scan keeps the
      //    lowest lane among equal maxima)
      float bv = -1.f;
      int bl = INT_MAX, bg = 0;
      for (int l = tid; l < nl; l += NT) {
        if (lane[l] >= 0) {
          const float v = fabsf(S[(int64_t)j * cs + l]);
          if (v > bv) { bv = v; bl = l; }
        }
      }
      lu_panel::warp_best(bv, bl, bg);
      if ((tid & 31) == 0) { red_v[tid >> 5] = bv; red_l[tid >> 5] = bl; }
      __syncthreads();
      // every thread reduces the warps' bests itself (no second barrier)
      bv = red_v[0];
      bl = red_l[0];
#pragma unroll
      for (int r = 1; r < NWARP; ++r)
        if (lu_panel::better(red_v[r], red_l[r], bv, bl)) { bv = red_v[r]; bl = red_l[r]; }
      const int lc = bv >= 0.f ? bl : -1;
      // 2. publish the candidate: its |value|, lane and column
      if (tid == 0) {
        __stcg(&p.cval[buf * G + g], lc >= 0 ? bv : -1.f);
        __stcg(&p.clane[buf * G + g], lc >= 0 ? lane[lc] : m);
      }
      if (lc >= 0) {
        float* dst = p.cand + ((int64_t)buf * G + g) * w;
        for (int i = tid; i < w; i += NT) __stcg(&dst[i], S[(int64_t)i * cs + lc]);
      }
      // 3. the column's one grid-wide barrier
      grid.sync();
      // 4. the same reduction of the G candidates in every block
      if (tid < 32) {
        float v = -1.f;
        int l = INT_MAX, q = -1;
        for (int r = tid; r < G; r += 32) {
          const float ov = __ldcg(&p.cval[buf * G + r]);
          const int ol = __ldcg(&p.clane[buf * G + r]);
          if (ov >= 0.f && lu_panel::better(ov, ol, v, l)) { v = ov; l = ol; q = r; }
        }
        lu_panel::warp_best(v, l, q);
        if (tid == 0) {
          s_p = v >= 0.f ? l : m;
          s_g = v >= 0.f ? q : -1;
          if (g == 0) piv[j] = (int64_t)s_p;
        }
      }
      __syncthreads();
      const int pg = s_g;
      float* pc = P + jj * pw;
      const float* src = p.cand + ((int64_t)buf * G + (pg < 0 ? 0 : pg)) * w;
      for (int i = tid; i < w; i += NT) pc[i] = pg >= 0 ? __ldcg(&src[i]) : 0.f;
      __syncthreads();
      // in-block update of this block's lanes: row j takes the multipliers,
      // rows (j, b1) the rank-1 update (unfused, as the plain version)
      const float pval = pc[j];
      const float safe = pval == 0.f ? 1.f : pval;
      const int lp = pg == g ? lc : -1;
      for (int l = tid; l < nl; l += NT) {
        if (l == lp) { lane[l] = ~lane[l]; blk[l] = j; continue; }
        if (lane[l] < 0) continue;
        const float mult = S[(int64_t)j * cs + l] / safe;
        S[(int64_t)j * cs + l] = mult;
        for (int i = j + 1; i < b1; ++i)
          S[(int64_t)i * cs + l] = __fsub_rn(S[(int64_t)i * cs + l],
                                             __fmul_rn(pc[i], mult));
      }
      __syncthreads();
    }

    // ---- block end, part 1 (the last column ended with a block barrier)
    if (ib == 16) block_end_part1<16>(P, Xbb, Xo, T, w, b0, ib, nown, g, G);
    else block_end_part1<0>(P, Xbb, Xo, T, w, b0, ib, nown, g, G);
    // ---- block end, part 2
    // delayed rank-ib update of this block's lanes, rows [b1, w): each
    // thread a DR-row × DL-lane tile (lanes tl + k·ntl, so neighbouring
    // threads read neighbouring lanes); a lane pivoted in this block takes
    // its U12 row
    {
      const int nr = w - b1;
      const int nti = ceildiv(nr, DR), ntl = ceildiv(nl, DL);
      for (int t = tid; t < nti * ntl; t += NT) {
        const int i0 = b1 + (t / ntl) * DR, tl = t % ntl;
        int ln[DL];
        bool live[DL];
        float acc[DR][DL];
#pragma unroll
        for (int k = 0; k < DL; ++k) {
          ln[k] = tl + k * ntl;
          live[k] = ln[k] < nl && lane[ln[k]] >= 0;
#pragma unroll
          for (int r = 0; r < DR; ++r)
            acc[r][k] = (live[k] && i0 + r < w) ? S[(int64_t)(i0 + r) * cs + ln[k]] : 0.f;
        }
#pragma unroll 4
        for (int jj = 0; jj < ib; ++jj) {
          float mv[DL], uv[DR];
#pragma unroll
          for (int k = 0; k < DL; ++k)
            mv[k] = live[k] ? S[(int64_t)(b0 + jj) * cs + ln[k]] : 0.f;
#pragma unroll
          for (int r = 0; r < DR; ++r)
            uv[r] = i0 + r < w ? P[jj * pw + i0 + r] : 0.f;
#pragma unroll
          for (int r = 0; r < DR; ++r)
#pragma unroll
            for (int k = 0; k < DL; ++k) acc[r][k] = fmaf(-uv[r], mv[k], acc[r][k]);
        }
#pragma unroll
        for (int k = 0; k < DL; ++k) {
          if (ln[k] >= nl) continue;
          const int bj = blk[ln[k]] - b0;
#pragma unroll
          for (int r = 0; r < DR; ++r) {
            if (i0 + r >= w) continue;
            float* s = &S[(int64_t)(i0 + r) * cs + ln[k]];
            if (live[k]) *s = acc[r][k];
            else if (bj >= 0) *s = P[bj * pw + i0 + r];
          }
        }
      }
    }
    // linv block row b for the owned columns c = g + q·G < b1:
    // X[b, c] = -X[b, b]·T
    for (int e = tid; e < ib * nown; e += NT) {
      const int jj = e / nown, q = e % nown;
      const int c = g + q * G;
      if (c >= b1) continue;
      float x;
      if (c >= b0) {
        x = Xbb[jj * ib + (c - b0)];
      } else {
        x = 0.f;
        for (int kk = 0; kk <= jj; ++kk) x = fmaf(-Xbb[jj * ib + kk], T[kk * nown + q], x);
      }
      Xo[(int64_t)q * w + b0 + jj] = x;
    }
    __syncthreads();
  }

  // write-back: the lanes, the mask of the pivot lanes, their rows of L11
  // (L11[j, k] = panel[k, piv[j]], k < j; 1 on the diagonal, 0 above)
  for (int64_t e = tid; e < (int64_t)w * cs; e += NT) {
    const int i = (int)(e / cs), l = (int)(e % cs);
    if (l < nl) in[(int64_t)i * ld + (lane[l] >= 0 ? lane[l] : ~lane[l])] = S[e];
  }
  for (int l = tid; l < nl; l += NT)
    if (lane[l] < 0) p.act[~lane[l]] = 0.f;
  for (int64_t e = tid; e < (int64_t)nl * w; e += NT) {
    const int l = (int)(e / w), k = (int)(e % w), j = blk[l];
    if (j >= 0)
      p.l11[(int64_t)j * w + k] = k < j ? S[(int64_t)k * cs + l] : (k == j ? 1.f : 0.f);
  }
  for (int64_t e = tid; e < (int64_t)nown * w; e += NT) {
    const int q = (int)(e / w), r = (int)(e % w);
    const int c = g + q * G;
    if (c < w) p.linv[(int64_t)r * w + c] = Xo[e];
  }
}

// ---------------------------------------------------------------------------
// The trailing products
// ---------------------------------------------------------------------------

// One 128 × 128 output tile of A·B with inner dimension K (a multiple of
// 16), in slabs of 16 through two shared buffers and two register sets, as
// tri_grid.cuh's tile_gemm: A(i, k) = A[i·lda + k] for the tile's rows
// (staged k-fastest), B(k, j) = B[k·ldb + col[j]] for its columns, col in
// shared memory (the gathered lanes; staged j-fastest).  The tile must be
// whole: the caller points a column past the matrix at any column inside
// it and drops it in the epilogue.  epi(i, js, v) once for each of the
// thread's eight rows i of the tile, with its eight columns js and their
// sums v (so that an epilogue can issue its eight loads before its
// stores); each sum runs over k ascending by fmaf from zero.  Ends with
// every thread past the last read of sm (2·16·132·2 floats).
template <class Epi>
__device__ void gather_tile(float* sm, int K, const float* A, int64_t lda, const float* B,
                            int64_t ldb, const int* col, Epi epi) {
  constexpr int BM = TT, BN = TT, BK = 16, TM = 8, TN = 8, PAD = tri_grid::PAD;
  constexpr int RA = NT / BK, RB = NT / BN, LA_ = BM / RA, LB_ = BK / RB;
  constexpr int SA = BK * (BM + PAD), SB = BK * (BN + PAD);
  static_assert(2 * (SA + SB) <= TILE_FLOATS, "tile slabs fit");
  float* As = sm;
  float* Bs = sm + 2 * SA;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int ak = tid % BK, ai = tid / BK, bj = tid % BN, bk = tid / BN;
  // this thread loads A's column ak of rows ai + r·RA and B's column
  // col[bj] of rows bk + r·RB
  const float* pa = A + (int64_t)ai * lda + ak;
  const float* pb = B + (int64_t)bk * ldb + col[bj];

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  float ra[2][LA_], rb[2][LB_];
  auto load = [&](int k0, float (&xa)[LA_], float (&xb)[LB_]) {
#pragma unroll
    for (int r = 0; r < LA_; ++r) xa[r] = __ldcg(pa + (int64_t)r * RA * lda + k0);
#pragma unroll
    for (int r = 0; r < LB_; ++r) xb[r] = __ldcg(pb + (int64_t)(k0 + r * RB) * ldb);
  };
  auto store = [&](int buf, const float (&xa)[LA_], const float (&xb)[LB_]) {
#pragma unroll
    for (int r = 0; r < LA_; ++r) As[buf * SA + ak * (BM + PAD) + ai + r * RA] = xa[r];
#pragma unroll
    for (int r = 0; r < LB_; ++r) Bs[buf * SB + (bk + r * RB) * (BN + PAD) + bj] = xb[r];
  };
  auto multiply = [&](int buf) {
    const float* as = As + buf * SA;
    const float* bs = Bs + buf * SB;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
      tri_grid::frag_load<TM, BM>(as + k * (BM + PAD), ty, a);
      tri_grid::frag_load<TN, BN>(bs + k * (BN + PAD), tx, b);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  };
  auto slab = [&](int k0, int cur, float (&na)[LA_], float (&nb_)[LB_],
                  const float (&sa)[LA_], const float (&sb)[LB_]) {
    if (k0 + 2 * BK < K) load(k0 + 2 * BK, na, nb_);
    multiply(cur);
    if (k0 + BK < K) store(cur ^ 1, sa, sb);
    __syncthreads();
  };

  load(0, ra[0], rb[0]);
  store(0, ra[0], rb[0]);
  if (BK < K) load(BK, ra[1], rb[1]);
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += 2 * BK) {
    slab(k0, 0, ra[0], rb[0], ra[1], rb[1]);
    if (k0 + BK < K) slab(k0 + BK, 1, ra[1], rb[1], ra[0], rb[0]);
  }
  int js[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) js[j] = tri_grid::frag_idx<TN, BN>(tx, j);
#pragma unroll
  for (int i = 0; i < TM; ++i) epi(tri_grid::frag_idx<TM, BM>(ty, i), js, acc[i]);
}

// One 128 × 128 tile of the rank-nb update, C[i, col[j]] −= Σ_k
// U[i, k]·L[k, col[j]] for the tile's rows (crow: its first row of the
// carry, urow: its first row of U) and the cols (≤ 128) active lanes from
// `lanes`, by the block; tl: TT ints of shared memory.  Not inlined, so
// that its registers are allocated for it alone.
__device__ __noinline__ void update_tile(float* crow, int64_t ld, const float* urow,
                                         const float* L, const int* lanes, int cols,
                                         int nb, int* tl, float* sm) {
  const int tid = threadIdx.x;
  // a column past the active lanes repeats the tile's first lane
  if (tid < TT) tl[tid] = __ldcg(lanes + (tid < cols ? tid : 0));
  __syncthreads();
  gather_tile(sm, nb, urow, nb, L, ld, tl,
              [&](int i, const int (&js)[8], const float (&v)[8]) {
                float* c = crow + (int64_t)i * ld;
                float old[8];
#pragma unroll
                for (int j = 0; j < 8; ++j) old[j] = __ldcg(c + tl[js[j]]);
#pragma unroll
                for (int j = 0; j < 8; ++j)
                  if (js[j] < cols) c[tl[js[j]]] = old[j] - v[j];
              });
  __syncthreads();
}

// Tile (R, J) of U = C[:, piv]·X₂ᵀ (rows nt, nb wide; cpiv the gathered
// C[:, piv]): U[r, j] sums k ≤ j (X₂ lower), X₂ read transposed.  Not
// inlined, as update_tile.
__device__ __noinline__ void u_tile(float* sm, int R, int J, int nt, int nb, const float* cpiv,
                                    const float* x2, float* u) {
  tri_grid::tile_gemm<TT, TT, tri_grid::FULL, tri_grid::UPPER, true, true>(
      sm, R * TT, J * TT, nt, nb, nb, cpiv, nb, x2, nb,
      [&](int i, int j, float v) { u[(int64_t)i * nb + j] = v; });
}

// The step's pivot lanes into shared memory, once a block.
__device__ inline int* load_piv(const Params& p, int k0, float* sm) {
  int* spiv = reinterpret_cast<int*>(sm + TILE_FLOATS);
  for (int k = threadIdx.x; k < p.nb; k += NT)
    spiv[k] = (int)__ldcg(reinterpret_cast<const long long*>(step_piv(p, k0) + k));
  __syncthreads();
  return spiv;
}

// The products of the step at k0, after its panel and a grid barrier:
// T, X₂ and U.  `list` holds the step's active lanes (na); the compaction
// writes the lanes still active into `next` (their count into *nnext).
// Three grid barriers inside, the last at the end.
__device__ inline void products(const Params& p, int k0, const int* list, int na, int* next,
                                int* nnext, float* sm, cg::grid_group& grid) {
  using namespace tri_grid;
  const int g = blockIdx.x, G = p.G, tid = threadIdx.x;
  const int nb = p.nb, r0 = k0 + nb, nt = p.n_rows - r0;
  const int64_t ld = p.ld;
  const float* X = p.linv;
  const int nst = nb / TS, nlow = nst * (nst + 1) / 2;

  const int* spiv = load_piv(p, k0, sm);
  // the blocks that gather C[:, piv] into p.cpiv during phases 1 and 2: the
  // ones without a product tile or the compaction, else all of them
  const bool few = G - 1 <= nlow;
  const int hb = few ? g : g - nlow, nh = few ? G : G - 1 - nlow;
  auto gather = [&](int ra, int rb) {
    if (hb < 0 || (!few && g == G - 1)) return;
    copy_batched((int64_t)ra * nb + (int64_t)hb * NT + tid, (int64_t)rb * nb, (int64_t)nh * NT,
                 [&](int64_t e) {
                   return __ldcg(p.carry + (int64_t)(r0 + e / nb) * ld + spiv[e % nb]);
                 },
                 [&](int64_t e, float v) { p.cpiv[e] = v; });
  };

  // 1. T = L11·X on the lower 32-tiles; the last block lists the lanes
  //    still active for the update and the next panel
  if (g == G - 1) compact(p.act, list, na, next, nnext, reinterpret_cast<int*>(sm));
  for (int u = g; u < nlow; u += G) {
    const int I = tri_row(u), J = u - I * (I + 1) / 2;
    tile_gemm<TS, TS, LOWER, LOWER>(sm, I * TS, J * TS, nb, nb, nb, p.l11, nb, X, nb,
                                    [&](int i, int j, float v) { p.t[(int64_t)i * nb + j] = v; });
  }
  gather(0, nt / 2);
  grid.sync();

  // 2. X₂ = 2X − X·T on the lower 32-tiles
  for (int u = g; u < nlow; u += G) {
    const int I = tri_row(u), J = u - I * (I + 1) / 2;
    tile_gemm<TS, TS, LOWER, LOWER>(
        sm, I * TS, J * TS, nb, nb, nb, X, nb, p.t, nb, [&](int i, int j, float v) {
          const int64_t e = (int64_t)i * nb + j;
          p.x2[e] = 2.f * __ldcg(X + e) - v;
        });
  }
  gather(nt / 2, nt);
  grid.sync();

  // 3. U = C[:, piv]·X₂ᵀ: U[r, j] sums k ≤ j (X₂ lower), B read transposed
  const int nrt = ceildiv(nt, TT), nbt = nb / TT;
  for (int u = g; u < nrt * nbt; u += G) u_tile(sm, u / nbt, u % nbt, nt, nb, p.cpiv, p.x2, p.u);
  grid.sync();
}

// 4. The rank-nb update of the lanes active after the panel (`next`,
// *nnext of them; skipped when `rank` is false, the fused_trsm depth) and
// the scatter of U into the step's pivot lanes (disjoint lanes), over the
// whole grid after the products.  No barrier.
__device__ inline void update(const Params& p, int k0, const int* next, const int* nnext,
                              float* sm, bool rank = true) {
  const int g = blockIdx.x, G = p.G;
  const int* spiv = load_piv(p, k0, sm);
  int* tl = const_cast<int*>(spiv) + p.nb;
  const int nt = p.n_rows - k0 - p.nb;
  const int nact = rank ? __ldcg(nnext) : 0, nlt = ceildiv(nact, TT), nrt = nt / TT;
  const float* L = p.carry + (int64_t)k0 * p.ld;   // the factored panel rows
  for (int u = g; u < nrt * nlt; u += G) {
    const int R = u / nlt, Lt = u % nlt;
    update_tile(p.carry + (int64_t)(k0 + p.nb + R * TT) * p.ld, p.ld,
                p.u + (int64_t)R * TT * p.nb, L, next + Lt * TT, min(TT, nact - Lt * TT),
                p.nb, tl, sm);
  }
  copy_batched((int64_t)g * NT + threadIdx.x, (int64_t)nt * p.nb, (int64_t)G * NT,
               [&](int64_t e) { return __ldcg(p.u + e); },
               [&](int64_t e, float v) {
                 p.carry[(int64_t)(k0 + p.nb + e / p.nb) * p.ld + spiv[e % p.nb]] = v;
               });
}

}  // namespace lu_full
