// Grid-level building blocks of the triangular kernels that spread over the
// whole card (lu_u12_panel.cu, lu_inv_panel.cu, chol_inv_panel.cu,
// trtri_panel.cu; potrf_grid.cuh's kernels and lu_full.cuh's products): the
// cooperative kernels of tri_panel.cuh's single-block algorithms, with the
// same arithmetic.
//
// Execution model: one cooperative grid of NTH-thread blocks, as many as are
// co-resident (plan_grid) and no more than the widest phase has tiles of
// work.  A phase hands its output tiles to the blocks in turn (tile u to
// block u mod G) and ends with grid.sync().  Each block stages its operands
// through shared memory.  Data that other blocks wrote in the same launch is
// read through L2 (__ldcg: ld.global.cg), never through an SM's L1, which is
// not coherent across SMs; so every global read here is __ldcg, and no
// pointer is __restrict__.
//
// The pieces:
//   * tile_gemm<BM, BN>: one (BM, BN) output tile of A·B, K in slabs of BK
//     staged through two shared buffers and two register sets (slab t + 2
//     is loaded while slab t multiplies; cp.async.cg would need 16-byte
//     aligned rows, and the kernels take views of any row stride),
//     K slabs that a triangular operand zeroes skipped, B read as it is or
//     as the transpose of a row-major (N, K) operand, and an epilogue
//     functor that writes each element;
//   * the recursive doubling of a lower or an upper triangular inverse, one
//     level's two products at a time, over 32 × 32 tiles, so that the narrow
//     levels are not mostly padding;
//   * the 32 × 32 diagonal work: the no-pivot LU and the Cholesky on one
//     warp holding the block in registers (pivot rows or scaled columns by
//     shuffle, no block barrier), and the inverses of a triangle on one warp
//     each with the substitution carried in registers (the right-looking
//     order of the same sums, so each entry is rounded as the row-wise
//     substitution of tri_panel.cuh rounds it), the Cholesky's inverse one
//     column behind the factor on a second warp; 32³ products on a block in
//     2 × 2 register fragments;
//   * chol_inv_grid: (L, L⁻¹) of an SPD block by the whole grid, the blocked
//     Cholesky of the reference's _chol_inv_kernel with each step's trailing
//     32 × 32 tiles spread over the blocks, rounded as one block rounds it.
//
// Arithmetic: FFMA in full fp32.  Single-pass TF32 tensor-core products fail
// the drivers' residual gates; matmul.cu's 3xTF32 tile is the product these
// kernels' 128² tiles could adopt (not done here).  The triangular chains are
// bound by latency (a grid barrier and a 32 × 32 factorization a step), the
// wide products by the FFMA tile's issue rate.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tri_grid {

namespace cg = cooperative_groups;

constexpr int IB = 32;     // the diagonal block, as the reference's ib
constexpr int NTH = 256;   // threads of a block: a 16 × 16 grid of fragments
constexpr int PAD = 4;     // row padding of a staged slab (keeps float4 rows)
constexpr int LDB = IB + 1;  // row stride of a 32 × 32 block for one warp's work
constexpr int LDT = IB + PAD;  // row stride of a 32 × 32 product operand

// Shared floats a kernel reserves: eight 32 × 36 blocks, which also hold the
// 32-tile's two 64-deep slabs of A and B.
constexpr int SMEM_FLOATS = 8 * IB * LDT;

enum Tri { FULL = 0, LOWER = 1, UPPER = 2 };

// Zero-based element t·TM + i of a thread's TM-fragment of a BM-wide tile;
// an 8-fragment is two float4 halves BM/2 apart (no bank conflicts).
template <int TM, int BM>
__device__ __forceinline__ int frag_idx(int t, int i) {
  if constexpr (TM == 8) return (i / 4) * (BM / 2) + t * 4 + (i % 4);
  else return t * TM + i;
}

template <int TM, int BM>
__device__ __forceinline__ void frag_load(const float* row, int t, float (&v)[TM]) {
  if constexpr (TM == 8) {
    const float4 a = *reinterpret_cast<const float4*>(row + t * 4);
    const float4 b = *reinterpret_cast<const float4*>(row + BM / 2 + t * 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else if constexpr (TM == 4) {
    const float4 a = *reinterpret_cast<const float4*>(row + t * 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
    const float2 a = *reinterpret_cast<const float2*>(row + t * 2);
    v[0] = a.x; v[1] = a.y;
  }
}

// One (BM, BN) output tile at (i0, j0) of the (M, N) product A·B with inner
// dimension K, by the whole block: A(i, k) = A[i·lda + k], B(k, j) =
// B[k·ldb + j], or with TRANSB B(k, j) = B[j·ldb + k] (the transpose of a
// row-major (N, K) operand, staged as A is: K fastest).  TA / TB say which
// triangle of A / B may be nonzero (LOWER: A(i, k) = 0 for k > i, B(k, j) =
// 0 for k < j; UPPER the other way); K slabs the triangle zeroes for the whole tile are skipped.  With
// CHECK the zeros inside a slab are masked (the other triangle is never
// read) and so are the rows, columns and K past the operands' edges;
// without it the caller vouches that the tile is whole, K is a multiple of
// the slab depth and the skipped triangle holds stored zeros.
// epi(i, j, acc) is called once for each element of the tile with i < M and
// j < N.  Each element's sum runs over k in ascending order by fmaf from
// init(i, j) (default 0), which is read before the first slab, so that its
// loads overlap the slab's instead of waiting in the epilogue.
// Shared memory: sm, SMEM_FLOATS.  Ends with every thread past the last
// read of sm.
struct Zero {
  __device__ float operator()(int, int) const { return 0.f; }
};

template <int BM, int BN, int TA, int TB, bool CHECK = true, bool TRANSB = false,
          class Epi, class Init = Zero>
__device__ void tile_gemm(float* sm, int i0, int j0, int M, int N, int K,
                          const float* A, int64_t lda, const float* B, int64_t ldb,
                          Epi epi, Init init = Init()) {
  // slab depth: 64 for the latency-bound 32-tiles, 8 for the 128-tile's
  // registers
  constexpr int BK = BM >= 128 ? 8 : BM >= 64 ? 16 : 64;
  constexpr int TM = BM / 16, TN = BN / 16;
  // rows of a slab one pass loads, and passes
  constexpr int RA = NTH / BK, RB = TRANSB ? NTH / BK : NTH / BN;
  constexpr int LA = BM / RA, LB = TRANSB ? BN / RB : BK / RB;
  constexpr int SA = BK * (BM + PAD), SB = BK * (BN + PAD);
  static_assert(2 * (SA + SB) <= SMEM_FLOATS, "tile slabs fit");
  static_assert(LA >= 1 && LB >= 1 && BM % RA == 0, "slab split");
  static_assert(TRANSB ? BN % RB == 0 : BK % RB == 0, "slab split");
  float* As = sm;               // As[buf][k][i] at sm[buf·SA + k·(BM+PAD) + i]
  float* Bs = sm + 2 * SA;      // Bs[buf][k][j]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // this thread loads A's column ak of rows ai + r·RA, B's column bj of
  // rows bk + r·RB (TRANSB: B's column bk of stored rows bj + r·RB)
  const int ak = tid % BK, ai = tid / BK;
  const int bj = TRANSB ? tid / BK : tid % BN, bk = TRANSB ? tid % BK : tid / BN;
  const float* pa = A + (int64_t)(i0 + ai) * lda + ak;
  const float* pb = TRANSB ? B + (int64_t)(j0 + bj) * ldb + bk
                           : B + (int64_t)bk * ldb + j0 + bj;

  int kb = 0, ke = K;
  if (TA == LOWER) ke = min(ke, i0 + BM);
  if (TA == UPPER) kb = max(kb, i0);
  if (TB == LOWER) kb = max(kb, j0);
  if (TB == UPPER) ke = min(ke, j0 + BN);
  kb = kb / BK * BK;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gi = i0 + frag_idx<TM, BM>(ty, i);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gj = j0 + frag_idx<TN, BN>(tx, j);
      acc[i][j] = (!CHECK || (gi < M && gj < N)) ? init(gi, gj) : 0.f;
    }
  }

  // two register sets of a slab: slab t + 2 loads into one while slab t
  // multiplies from shared memory and slab t + 1 goes from the other set to
  // shared memory.  So a load has a whole slab's products to arrive, wherever
  // the compiler schedules it (it sinks loads toward their first use).
  float ra[2][LA], rb[2][LB];
  auto load = [&](int k0, float (&xa)[LA], float (&xb)[LB]) {
    const int gk = k0 + ak;
#pragma unroll
    for (int r = 0; r < LA; ++r) {
      const int gi = i0 + ai + r * RA;
      const bool z = (TA == LOWER && gk > gi) || (TA == UPPER && gk < gi);
      xa[r] = (!CHECK || (gi < M && gk < ke && !z))
                  ? __ldcg(pa + (int64_t)r * RA * lda + k0) : 0.f;
    }
    if constexpr (TRANSB) {
      const int g = k0 + bk;
#pragma unroll
      for (int r = 0; r < LB; ++r) {
        const int gj = j0 + bj + r * RB;
        const bool z = (TB == LOWER && g < gj) || (TB == UPPER && g > gj);
        xb[r] = (!CHECK || (gj < N && g < ke && !z))
                    ? __ldcg(pb + (int64_t)r * RB * ldb + k0) : 0.f;
      }
    } else {
      const int gj = j0 + bj;
#pragma unroll
      for (int r = 0; r < LB; ++r) {
        const int g = k0 + bk + r * RB;
        const bool z = (TB == LOWER && g < gj) || (TB == UPPER && g > gj);
        xb[r] = (!CHECK || (gj < N && g < ke && !z))
                    ? __ldcg(pb + (int64_t)(k0 + r * RB) * ldb) : 0.f;
      }
    }
  };
  auto store = [&](int buf, const float (&xa)[LA], const float (&xb)[LB]) {
#pragma unroll
    for (int r = 0; r < LA; ++r) As[buf * SA + ak * (BM + PAD) + ai + r * RA] = xa[r];
#pragma unroll
    for (int r = 0; r < LB; ++r) {
      if constexpr (TRANSB) Bs[buf * SB + bk * (BN + PAD) + bj + r * RB] = xb[r];
      else Bs[buf * SB + (bk + r * RB) * (BN + PAD) + bj] = xb[r];
    }
  };
  auto multiply = [&](int buf) {
    const float* as = As + buf * SA;
    const float* bs = Bs + buf * SB;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
      frag_load<TM, BM>(as + k * (BM + PAD), ty, a);
      frag_load<TN, BN>(bs + k * (BN + PAD), tx, b);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  };
  // slab t in buffer t % 2 from set t % 2; one barrier a slab
  auto slab = [&](int k0, int cur, float (&na)[LA], float (&nb_)[LB],
                  const float (&sa)[LA], const float (&sb)[LB]) {
    if (k0 + 2 * BK < ke) load(k0 + 2 * BK, na, nb_);
    multiply(cur);
    if (k0 + BK < ke) store(cur ^ 1, sa, sb);
    __syncthreads();
  };

  if (kb < ke) {
    load(kb, ra[0], rb[0]);
    store(0, ra[0], rb[0]);
    if (kb + BK < ke) load(kb + BK, ra[1], rb[1]);
    __syncthreads();
    for (int k0 = kb; k0 < ke; k0 += 2 * BK) {
      slab(k0, 0, ra[0], rb[0], ra[1], rb[1]);
      if (k0 + BK < ke) slab(k0 + BK, 1, ra[1], rb[1], ra[0], rb[0]);
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gi = i0 + frag_idx<TM, BM>(ty, i);
    if (CHECK && gi >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gj = j0 + frag_idx<TN, BN>(tx, j);
      if (!CHECK || gj < N) epi(gi, gj, acc[i][j]);
    }
  }
}

// Tiles of one product of level w of the recursive doubling of an (nb, nb)
// triangular inverse: nb/(2w) pairs of (w/32)² tiles of 32 × 32.
__host__ __device__ inline int doubling_tiles(int nb, int w) {
  return nb / (2 * w) * (w / IB) * (w / IB);
}

// Tile u of product ph (0 or 1) of level w of the recursive doubling of the
// inverse X (row stride ldx) of the triangle T (row stride ldt), whose
// diagonal 32-blocks X holds on entry, with the other triangle of X zero:
//   lower: [[L11, 0], [L21, L22]]⁻¹ = [[X11, 0], [−X22·(L21·X11), X22]]
//          ph 0: W_p = L21·X11;  ph 1: X21 = −X22·W_p
//   upper: [[U11, U12], [0, U22]]⁻¹ = [[X11, −X11·(U12·X22)], [0, X22]]
//          ph 0: W_p = U12·X22;  ph 1: X12 = −X11·W_p
// (the reference's _block_inv_doubling and _block_uinv_doubling, each the
// same association).  W: scratch of nb·w/2 floats, pair p's (w, w) block
// at W + p·w².  Only T's blocks off the diagonal blocks are read.
template <bool LOW>
__device__ void doubling_tile_t(float* sm, int ph, int w, int u, const float* T,
                                int64_t ldt, float* X, int64_t ldx, float* W) {
  constexpr int TRI = LOW ? LOWER : UPPER;
  const int q = w / IB, p = u / (q * q), r = u % (q * q);
  const int i0 = (r / q) * IB, j0 = (r % q) * IB, o = p * 2 * w;
  float* wp = W + (int64_t)p * w * w;
  if (ph == 0) {
    const float* t = LOW ? T + (int64_t)(o + w) * ldt + o : T + (int64_t)o * ldt + o + w;
    const float* x = X + (int64_t)(LOW ? o : o + w) * (ldx + 1);
    tile_gemm<IB, IB, FULL, TRI>(sm, i0, j0, w, w, w, t, ldt, x, ldx,
                                 [&](int i, int j, float v) { wp[(int64_t)i * w + j] = v; });
  } else {
    const float* x = X + (int64_t)(LOW ? o + w : o) * (ldx + 1);
    float* out = LOW ? X + (int64_t)(o + w) * ldx + o : X + (int64_t)o * ldx + o + w;
    tile_gemm<IB, IB, TRI, FULL>(sm, i0, j0, w, w, w, x, ldx, wp, w,
                                 [&](int i, int j, float v) { out[(int64_t)i * ldx + j] = -v; });
  }
}

__device__ inline void doubling_tile(float* sm, bool lower, int ph, int w, int u,
                                     const float* T, int64_t ldt, float* X,
                                     int64_t ldx, float* W) {
  if (lower) doubling_tile_t<true>(sm, ph, w, u, T, ldt, X, ldx, W);
  else doubling_tile_t<false>(sm, ph, w, u, T, ldt, X, ldx, W);
}

// Inverse of the lower triangle of the 32 × 32 block a (shared, row stride
// LDB; unit: the diagonal taken as 1, not read) into x, by ONE warp: lane c
// owns column c and carries the 32 partial sums of its substitution in
// registers, adding each x(k, c) to the rows below as soon as it is known.
// Entry (i, c) = (δ_ic − Σ_{k<i} a(i, k)·x(k, c)) / a(i, i), the sum by fmaf in
// ascending k: the rounding of tri_panel.cuh's trtri_unblocked_warp, with a
// dependent chain of 32 steps instead of 528.  The entries above the
// diagonal are stored as 0 without the division of their zero sums (a zero
// dividend takes the division's slow path).  With FOLLOW, step k first meets
// the warp that factors a at named barrier 1 (chol32_warp), past which
// column k of a is in place.
template <bool FOLLOW = false>
__device__ inline void lower_inv_warp(const float* a, float* x, bool unit) {
  const int c = threadIdx.x % 32;
  float acc[IB];
#pragma unroll
  for (int i = 0; i < IB; ++i) acc[i] = (i == c) ? 1.f : 0.f;
#pragma unroll
  for (int k = 0; k < IB; ++k) {
    if (FOLLOW) asm volatile("bar.sync 1, 64;" ::: "memory");
    float xk = 0.f;
    if (k >= c) xk = unit ? acc[k] : acc[k] / a[k * LDB + k];
    x[k * LDB + c] = xk;
#pragma unroll
    for (int i = k + 1; i < IB; ++i) acc[i] = fmaf(-a[i * LDB + k], xk, acc[i]);
  }
  __syncwarp();
}

// Inverse of the upper triangle of a (diagonal included) into x by one warp,
// back substitution from the last row: (δ_ic − Σ_{k>i} a(i, k)·x(k, c)) / a(i, i),
// the sum by fmaf in descending k; the entries below the diagonal stored as 0.
__device__ inline void upper_inv_warp(const float* a, float* x) {
  const int c = threadIdx.x % 32;
  float acc[IB];
#pragma unroll
  for (int i = 0; i < IB; ++i) acc[i] = (i == c) ? 1.f : 0.f;
#pragma unroll
  for (int k = IB - 1; k >= 0; --k) {
    float xk = 0.f;
    if (k <= c) xk = acc[k] / a[k * LDB + k];
    x[k * LDB + c] = xk;
#pragma unroll
    for (int i = 0; i < k; ++i) acc[i] = fmaf(-a[i * LDB + k], xk, acc[i]);
  }
  __syncwarp();
}

// No-pivot LU of the 32 × 32 block a (shared, row stride LDB) in place,
// packed (unit L strictly below the diagonal, U on and above), by ONE warp
// holding it in registers: lane r owns row r, and pivot row j reaches the
// other lanes by shuffles.  Lane r applies a(r, c) = fmaf(−l, a(j, c),
// a(r, c)), l = a(r, j) / a(j, j), for j = 0, 1, … in order: the arithmetic
// of the reference's _lu_unblocked, with no block barrier on the chain.
__device__ inline void lu32_warp(float* a) {
  const int r = threadIdx.x % 32;
  float row[IB];
#pragma unroll
  for (int c = 0; c < IB; ++c) row[c] = a[r * LDB + c];
#pragma unroll
  for (int j = 0; j < IB - 1; ++j) {
    const float l = row[j] / __shfl_sync(0xffffffffu, row[j], j);
#pragma unroll
    for (int c = j + 1; c < IB; ++c) {
      const float ajc = __shfl_sync(0xffffffffu, row[c], j);
      if (r > j) row[c] = fmaf(-l, ajc, row[c]);
    }
    if (r > j) row[j] = l;
  }
#pragma unroll
  for (int c = 0; c < IB; ++c) a[r * LDB + c] = row[c];
  __syncwarp();
}

// Right-looking Cholesky of the lower triangle of the 32 × 32 block a
// (shared, row stride LDB) in place by ONE warp holding it in registers:
// lane r owns row r, and column j's scaled entries reach the other lanes by
// shuffles.  Column j: inv = 1/√a(j, j), a(j, j)·inv on the diagonal, v_r =
// a(r, j)·inv below it, then a(r, c) = fmaf(−v_r, v_c, a(r, c)) for
// j < c ≤ r: the arithmetic of tri_panel.cuh's chol_unblocked_warp (the
// reference's _chol_unblocked).  Every lane also keeps the diagonal,
// updated by the same fmaf as its owner's, so the next column's pivot needs
// no shuffle.  Each finished column goes to a at once, and the warp then
// meets the one inverting the factor (lower_inv_warp<true>, warp 1) at
// named barrier 1, so that the inverse follows one column behind.  The
// entries above the diagonal are not read; they are stored as 0.
__device__ inline void chol32_warp(float* a) {
  const int r = threadIdx.x % 32;
  float row[IB], dg[IB];
#pragma unroll
  for (int c = 0; c < IB; ++c) {
    row[c] = c <= r ? a[r * LDB + c] : 0.f;
    dg[c] = a[c * LDB + c];
  }
  __syncwarp();
#pragma unroll
  for (int c = r + 1; c < IB; ++c) a[r * LDB + c] = 0.f;
#pragma unroll
  for (int j = 0; j < IB; ++j) {
    const float ajj = dg[j];
    const float inv = 1.f / sqrtf(ajj);
    const float v = row[j] * inv;
    if (r == j) row[j] = ajj * inv;
    else if (r > j) row[j] = v;
    if (r >= j) a[r * LDB + j] = row[j];
    asm volatile("bar.sync 1, 64;" ::: "memory");
#pragma unroll
    for (int c = j + 1; c < IB; ++c) {
      const float vc = __shfl_sync(0xffffffffu, v, c);
      if (r >= c) row[c] = fmaf(-v, vc, row[c]);
      dg[c] = fmaf(-vc, vc, dg[c]);
    }
  }
  __syncwarp();
}

// A 32 × 32 block of global memory (row stride ld) into registers: v[q] is
// element (tid/32 + 8q, tid%32); every load is issued before any is used.
__device__ __forceinline__ void load_block_regs(const float* g, int64_t ld, float (&v)[4]) {
  const int r0 = threadIdx.x / 32, c = threadIdx.x % 32;
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = __ldcg(g + (int64_t)(r0 + 8 * q) * ld + c);
}

// The registers of load_block_regs into shared memory at row stride lds,
// transposed (element (r, c) at s[c·lds + r]) or not; lower: zeros above
// the diagonal.
__device__ __forceinline__ void put_block(float* s, int lds, const float (&v)[4],
                                          bool trans = false, bool lower = false) {
  const int r0 = threadIdx.x / 32, c = threadIdx.x % 32;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = r0 + 8 * q;
    s[trans ? c * lds + r : r * lds + c] = (lower && c > r) ? 0.f : v[q];
  }
}

// A 32 × 32 block of shared memory (row stride lds) to global memory.
__device__ __forceinline__ void store_block(const float* s, int lds, float* g, int64_t ld) {
  const int r0 = threadIdx.x / 32, c = threadIdx.x % 32;
#pragma unroll
  for (int q = 0; q < 4; ++q) g[(int64_t)(r0 + 8 * q) * ld + c] = s[(r0 + 8 * q) * lds + c];
}

// acc += (32 × 32) product AT-transposed × B for this thread's 2 × 2
// fragment (rows 2·(tid/16) + i, columns 2·(tid%16) + j): AT[t][i] = A(i, t)
// and B[t][j], both shared at row stride LDT; the sum over t ascending.
__device__ __forceinline__ void mm32(const float* AT, const float* B, float (&acc)[2][2]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int t = 0; t < IB; ++t) {
    const float2 a = *reinterpret_cast<const float2*>(AT + t * LDT + 2 * ty);
    const float2 b = *reinterpret_cast<const float2*>(B + t * LDT + 2 * tx);
    acc[0][0] = fmaf(a.x, b.x, acc[0][0]);
    acc[0][1] = fmaf(a.x, b.y, acc[0][1]);
    acc[1][0] = fmaf(a.y, b.x, acc[1][0]);
    acc[1][1] = fmaf(a.y, b.y, acc[1][1]);
  }
}

// ---------------------------------------------------------------------------
// chol_inv_grid: (L, L⁻¹) of an SPD block by the whole grid
// ---------------------------------------------------------------------------

// The 32 × 32 blocks of a step in shared memory: the products' operands
// transposed at row stride LDT, the diagonal block and its inverse at LDB.
struct CholBufs {
  float *binvT, *aIT, *aJT, *lIT, *lJT, *blk, *inv;
  __device__ explicit CholBufs(float* sm)
      : binvT(sm), aIT(sm + 1 * IB * LDT), aJT(sm + 2 * IB * LDT), lIT(sm + 3 * IB * LDT),
        lJT(sm + 4 * IB * LDT), blk(sm + 5 * IB * LDT), inv(sm + 6 * IB * LDT) {}
};

// Factor the 32 × 32 block in s.blk, diagonal block d: its Cholesky on
// warp 0 and its inverse on warp 1, one column behind; into L and Linv
// (row stride nb) at rows and columns d·32.  Ends with __syncthreads.
__device__ inline void chol_factor_diag(const CholBufs& s, float* L, float* Linv, int nb,
                                        int d) {
  if (threadIdx.x < 32) chol32_warp(s.blk);
  else if (threadIdx.x < 64) lower_inv_warp<true>(s.blk, s.inv, false);
  __syncthreads();
  const int64_t o = (int64_t)d * IB * (nb + 1);
  store_block(s.blk, LDB, L + o, nb);
  store_block(s.inv, LDB, Linv + o, nb);
  __syncthreads();
}

// Tile (I, J), I ≥ J > k, of step k: L21_I = S_Ik·B⁻ᵀ and L21_J = S_Jk·B⁻ᵀ
// (B the step's diagonal block, B⁻¹ in Linv), then S_IJ − L21_I·L21_Jᵀ.  S
// is read at src (row stride lds; a diagonal tile's lower triangle only)
// and written to the scratch S (row stride nb), but tile (k+1, k+1), which
// goes to s.blk and is factored at once; the tiles of column k + 1 store
// L21_I into L.  Each product is 32³ in 2 × 2 register fragments, its sum
// in ascending order from zero, and the update c − Σ: the rounding of the
// blocked algorithm's W = A21·B⁻ᵀ and A22 −= W·Wᵀ on one block.
__device__ inline void chol_step_tile(const CholBufs& s, const float* src, int64_t lds,
                                      float* S, float* L, float* Linv, int nb, int k,
                                      int I, int J) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool diag = I == J;
  float bi[4], aI[4], aJ[4], c[2][2];
  load_block_regs(Linv + (int64_t)k * IB * (nb + 1), nb, bi);
  load_block_regs(src + (int64_t)I * IB * lds + k * IB, lds, aI);
  if (!diag) load_block_regs(src + (int64_t)J * IB * lds + k * IB, lds, aJ);
  const float* cij = src + (int64_t)(I * IB + 2 * ty) * lds + J * IB + 2 * tx;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      c[i][j] = (!diag || 2 * tx + j <= 2 * ty + i) ? __ldcg(cij + i * lds + j) : 0.f;
  put_block(s.binvT, LDT, bi, true);
  put_block(s.aIT, LDT, aI, true);
  if (!diag) put_block(s.aJT, LDT, aJ, true);
  __syncthreads();
  float lI[2][2] = {}, lJ[2][2] = {};
  mm32(s.aIT, s.binvT, lI);                // L21_I = S_Ik·B⁻ᵀ
  if (!diag) mm32(s.aJT, s.binvT, lJ);     // L21_J = S_Jk·B⁻ᵀ
  float* l21 = L + (int64_t)(I * IB + 2 * ty) * nb + k * IB + 2 * tx;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      s.lIT[(2 * tx + j) * LDT + 2 * ty + i] = lI[i][j];
      if (!diag) s.lJT[(2 * tx + j) * LDT + 2 * ty + i] = lJ[i][j];
      if (J == k + 1) l21[i * nb + j] = lI[i][j];
    }
  __syncthreads();
  float t[2][2] = {};
  mm32(s.lIT, diag ? s.lIT : s.lJT, t);    // S_IJ −= L21_I·L21_Jᵀ
  const bool next = diag && I == k + 1;
  float* out = next ? s.blk + 2 * ty * LDB + 2 * tx
                    : S + (int64_t)(I * IB + 2 * ty) * nb + J * IB + 2 * tx;
  const int ldo = next ? LDB : nb;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) out[i * ldo + j] = c[i][j] - t[i][j];
  __syncthreads();
  if (next) chol_factor_diag(s, L, Linv, nb, k + 1);
}

// Row i of entry u of the row-major list of a lower triangle's entries
// (i, j), j ≤ i: i(i+1)/2 ≤ u < (i+1)(i+2)/2.
__device__ __forceinline__ int tri_row(int u) {
  int i = (int)((sqrtf(8.f * u + 1.f) - 1.f) * 0.5f);
  while (i * (i + 1) / 2 > u) --i;
  while ((i + 1) * (i + 2) / 2 <= u) ++i;
  return i;
}

// The most 32 × 32 tiles a phase of chol_inv_grid hands out for an (nb, nb)
// block: the first step's lower trailing tiles, or the last doubling level's.
__host__ __device__ inline int chol_inv_grid_tiles(int nb) {
  const int m = nb / IB - 1;
  const int dbl = nb >= 2 * IB ? doubling_tiles(nb, nb / 2) : 0;
  return m * (m + 1) / 2 > dbl ? m * (m + 1) / 2 : dbl;
}

// (L, L⁻¹) of the (nb, nb) SPD block at A (row stride lda; only its lower
// triangle is read) into the contiguous L and Linv, zeros above their
// diagonals, by every block of the cooperative grid: the blocked
// right-looking Cholesky of the reference's _chol_inv_kernel, ib = 32, in
// the rounding of one block running it.
//   * Block 0 factors the first diagonal block (the Cholesky on one warp,
//     its inverse on another one column behind) while the grid zeroes the
//     blocks of L and L⁻¹ above their diagonal blocks.
//   * Step k (one grid barrier): the trailing tiles (I, J), I ≥ J > k, go
//     over the blocks.  A tile's block forms L21_I = S_Ik·B⁻ᵀ itself, and
//     L21_J if J ≠ I, and writes S_IJ − L21_I·L21_Jᵀ; the blocks of column
//     k + 1 store L21 into L.  The running Schur complement S lives in
//     scratch (A itself at step 0), not in L, so no block overwrites what
//     another still reads.  Tile (k+1, k+1) is block 0's, which factors it
//     at once (a one-step look-ahead).
//   * Last, the lower recursive doubling over doubling_tile_t<true>'s
//     32 × 32 tiles, two barriers a level.
// S: scratch of nb² floats (the Schur complement, then the doubling's
// products).  nb a power of two ≥ 32.  Every block passes the same grid
// barriers; the last phase ends with none.
__device__ inline void chol_inv_grid(float* sm, cg::grid_group& grid, const float* A,
                                     int64_t lda, float* L, float* Linv, float* S, int nb) {
  const int g = blockIdx.x, G = gridDim.x, tid = threadIdx.x;
  const int nt = nb / IB;
  const CholBufs s(sm);

  // the blocks above the diagonal blocks; the factors write those
  const int64_t nn = (int64_t)nb * nb;
  for (int64_t e = (int64_t)g * NTH + tid; e < nn; e += (int64_t)G * NTH) {
    if ((int)(e % nb) / IB > (int)(e / nb) / IB) {
      L[e] = 0.f;
      Linv[e] = 0.f;
    }
  }
  if (g == 0) {
    const int r0 = tid / 32, c = tid % 32;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = r0 + 8 * q;
      s.blk[r * LDB + c] = c <= r ? __ldcg(A + (int64_t)r * lda + c) : 0.f;
    }
    __syncthreads();
    chol_factor_diag(s, L, Linv, nb, 0);
  }
  grid.sync();

  // the steps: the Schur complement in S (A at step 0)
  for (int k = 0; k + 1 < nt; ++k) {
    const int m = nt - k - 1;
    const float* src = k == 0 ? A : S;
    const int64_t lds = k == 0 ? lda : nb;
    for (int u = g; u < m * (m + 1) / 2; u += G) {
      const int i = tri_row(u);
      const int j = u - i * (i + 1) / 2;
      chol_step_tile(s, src, lds, S, L, Linv, nb, k, k + 1 + i, k + 1 + j);
    }
    grid.sync();
  }

  // L⁻¹ by recursive doubling; S is free now
  for (int w = IB; w < nb; w *= 2) {
    const int tiles = doubling_tiles(nb, w);
    for (int ph = 0; ph < 2; ++ph) {
      for (int u = g; u < tiles; u += G)
        doubling_tile_t<true>(sm, ph, w, u, L, nb, Linv, nb, S);
      if (w * 2 < nb || ph == 0) grid.sync();
    }
  }
}

// The cooperative grid: as many NTH-thread blocks as are co-resident, and
// no more than `want` (the widest phase's tiles).  Returns a CUDA error code.
inline int plan_grid(const void* kernel, int want, int* G_out) {
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
  const int g = occ * sms;
  *G_out = want < 1 ? 1 : (want < g ? want : g);
  return 0;
}

}  // namespace tri_grid
