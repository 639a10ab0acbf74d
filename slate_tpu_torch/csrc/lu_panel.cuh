// Device code of the partial-pivot LU panel kernels, getrf_panel_linv.cu
// and getrf_panel_fused.cu, and the pieces the other LU kernels share with
// them: the block shape, the argmax comparison, the grid barrier, and the
// step and full kernels' grid plan and panel share (lu_full.cuh runs its
// own panel over a list of lanes with this file's arithmetic), as the
// Pallas kernels share _factor_block_lane_major / _trtri_unblocked /
// _block_inv_doubling (slate_tpu/ops/pallas_kernels.py:315-363, :690-771).
//
// The function: TRUE partial-pivot LU of a TRANSPOSED, lane-major (w, m)
// panel.  Panel row j is column j of A's panel; lane l is row l of A.
// Rows never move.  For each column j the pivot is the lowest lane among
// the maxima of |x[j, l]| over the active lanes; a zero pivot divides by
// 1; the live lanes (active, not the pivot) take multipliers
// x[j, l] / x[j, p] in row j and rows i > j lose x[i, p]·mult[l]; the
// pivot lane keeps its U entries and leaves the active set.  Outputs: the
// factored panel, the w pivots in factorization order, the active mask
// after the panel, and linv = L11⁻¹ where L11[i, j] = panel[j, piv[i]]
// (i > j), unit diagonal.  The elimination is blocked by ib columns: the
// rank-1 updates of a column reach only the rows of its inner block; the
// rows past the block take one delayed rank-ib update at its end, after
// U12 = L11⁻¹·(pivot rows) by forward substitution.
//
// Execution model.  On the TPU the whole panel sits in one core's VMEM.
// Here the panel stays in device memory (the (512, 8192) fp32 panel is 16
// MB, inside the 50 MB L2), factored in place (getrf_panel_linv first
// copies its slab into `out`), by ONE COOPERATIVE LAUNCH OF THREAD-BLOCK
// CLUSTERS (cudaLaunchKernelEx with both attributes: the runtime refuses
// a grid that is not co-resident), one block an SM, in two roles:
//   * cluster 0, the LEAF: C = 16 blocks hold the ib rows of the
//     current inner block for every lane active on entry (listed in
//     ascending order by the cluster first, split in equal runs over its
//     blocks): in registers, two lanes a thread, where ⌈na / C⌉ ≤ 512
//     (m ≤ 8192 at C = 16), else in shared memory.  Per column each block
//     finds its argmax, pushes its candidate (the slot's ib rows, |value|,
//     lane) into the shared memory of every block of the cluster, 16 bytes
//     a store, and one cluster barrier (release/acquire) later every block
//     picks the same winner from its own copies and updates its lanes: no
//     grid-wide barrier and no round trip through L2 inside a leaf.  The
//     shared-memory path applies each column's update to the rows past
//     the next one while the cluster barrier is in flight, the pushed
//     candidate taking it on the fly.  At the leaf's end the cluster
//     writes its rows back, then one grid barrier; then it computes the
//     next inner block's rows itself (their U12 by forward substitution,
//     the rank-ib update of its live lanes from the multipliers it holds),
//     raises a counter, and starts the next leaf.
//   * every other block, the UPDATERS: after the same grid barrier, the
//     U12 rows of the previous block's pivot lanes (one thread a row,
//     written one inner block late, once no one reads those lanes' old
//     rows), the block row of L11⁻¹, and, once the counter says the leaf
//     has read its next rows, the delayed rank-ib update of the rows past
//     them in tiles of 32 rows × 1024 lanes (each tile solves the U12 of
//     its rows itself).  This runs beside the next leaf.
// So a panel costs one grid barrier per inner block, w/ib in all.  Cross-
// block data goes through L2 (__ldcg), ordered by the grid barrier or the
// counter (release/acquire) or, inside the leaf, by the cluster barrier.
//
// The arithmetic is lu_full.cuh's panel's, element by element: the
// multiplier x / safe, the in-leaf update __fsub_rn(x, __fmul_rn(pc,
// mult)), U12 and the delayed update as fmaf sums over ascending jj, the
// linv block row T = L[b, c:b0]·X[c:b0, c] over ascending k, then
// X[b, c] = -X[b, b]·T; so a panel is bitwise the step kernels' panel.

#pragma once

#include <algorithm>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "grid_sync.cuh"

namespace lu_panel {

namespace cg = cooperative_groups;
using grid_sync::cluster_arrive;
using grid_sync::cluster_wait;
using grid_sync::ColumnBarrier;
using grid_sync::wait_at_least;

constexpr int NT = 256;          // threads of one block
constexpr int NWARP = NT / 32;
constexpr int MIN_LANES = 32;    // fewest lanes a block takes (lu_full.cuh's grid)
constexpr int MAX_IB = 32;       // widest inner block
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline int ceildiv(int a, int b) { return (a + b - 1) / b; }

// Dynamic shared memory of one block of lu_full.cuh's panel on a grid of
// G, in floats (smem.lu_panel_bytes / 4): its lanes' w rows, the ib pivot
// columns, its owned columns of L11⁻¹, the block inverse and products,
// its lanes and their pivot marks, 64 spare words.
__host__ __device__ inline int64_t smem_floats(int m, int w, int ib, int G) {
  const int64_t chunk = ceildiv(m, G), nown = ceildiv(w, G);
  return (int64_t)w * chunk + (int64_t)ib * w + nown * w + (int64_t)ib * ib +
         (int64_t)ib * nown + 2 * chunk + 64;
}

// (|value|, lane) comparison: larger magnitude first, then the lower lane.
__device__ __forceinline__ bool better(float v, int l, float bv, int bl) {
  return v > bv || (v == bv && l < bl);
}

__device__ __forceinline__ void warp_best(float& v, int& l, int& g) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const float ov = __shfl_down_sync(FULL, v, off);
    const int ol = __shfl_down_sync(FULL, l, off);
    const int og = __shfl_down_sync(FULL, g, off);
    if (better(ov, ol, v, l)) { v = ov; l = ol; g = og; }
  }
}

// dst(e, src(e)) for e = e0, e0 + step, … below e1, eight loads issued
// before their eight stores (a store between two loads would keep the
// second waiting: the compiler cannot tell that they do not overlap).
template <class Src, class Dst>
__device__ __forceinline__ void copy_batched(int64_t e0, int64_t e1, int64_t step, Src src,
                                             Dst dst) {
  constexpr int B = 8;
  for (int64_t e = e0; e < e1; e += B * step) {
    float v[B];
#pragma unroll
    for (int t = 0; t < B; ++t) v[t] = e + t * step < e1 ? src(e + t * step) : 0.f;
#pragma unroll
    for (int t = 0; t < B; ++t)
      if (e + t * step < e1) dst(e + t * step, v[t]);
  }
}

// The dynamic shared memory of one lu_full.cuh block on a grid of G: the
// panel's smem_floats, or `min_floats` for its trailing phases from the
// same memory, whichever is larger.
inline int64_t dyn_floats(int m, int w, int ib, int G, int64_t min_floats) {
  return std::max(smem_floats(m, w, ib, G), min_floats);
}

// The cooperative grid of `kernel` (blocks of NT threads running
// lu_full.cuh's panel): one block per SM first; if its share of shared
// memory lets more blocks share an SM, as many as are co-resident, never
// fewer than MIN_LANES lanes a block.  Returns a CUDA error code.
inline int plan_grid_for(const void* kernel, int m, int w, int ib,
                         int64_t min_floats, int* G_out) {
  if (m < 1 || w < 1 || ib < 1 || ib > MAX_IB || w % ib != 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, optin = 0, coop = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  // the dynamic share is what the opt-in limit leaves after the kernel's
  // static shared memory (its reduction scratch)
  cudaFuncAttributes fa;
  if ((err = cudaFuncGetAttributes(&fa, kernel)) != cudaSuccess) return (int)err;
  const int dyn_max = optin - (int)fa.sharedSizeBytes;
  const int g1 = std::max(1, std::min(sms, ceildiv(m, MIN_LANES)));
  const int64_t b1 = 4 * dyn_floats(m, w, ib, g1, min_floats);
  if (b1 > dyn_max) return (int)cudaErrorInvalidValue;
  if ((err = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)b1)) != cudaSuccess)
    return (int)err;
  int occ = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, NT,
                                                           (size_t)b1)) !=
      cudaSuccess)
    return (int)err;
  if (occ < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *G_out = std::max(1, std::min(occ * sms, ceildiv(m, MIN_LANES)));
  return 0;
}

// Launch `kernel` cooperatively on G blocks with `args`, its dynamic share
// dyn_floats(m, w, ib, G, min_floats).  A grid larger than co-residency
// allows is refused by the launch (an error code, never a hang).
inline int launch_for(const void* kernel, void** args, int m, int w, int ib,
                      int G, int64_t min_floats, cudaStream_t stream) {
  if (m < 1 || w < 1 || ib < 1 || ib > MAX_IB || w % ib != 0 || G < 1)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = 4 * (size_t)dyn_floats(m, w, ib, G, min_floats);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchCooperativeKernel(kernel, dim3(G), dim3(NT), args, bytes,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The panel kernels: the leaf cluster and the updaters
// ---------------------------------------------------------------------------

constexpr int MAX_CLUSTER = 16;  // the widest leaf cluster (non-portable)
constexpr int RG = 32;           // rows of an update tile
constexpr int SPT = 4;           // lanes a thread takes in an update tile
constexpr int SG = SPT * NT;     // lanes of an update tile
constexpr int LC = 64;           // linv columns of a block
constexpr int LJ = NT / LC;      // threads sharing a linv column's ib sums
constexpr int KC = 64;           // rows of X a linv block stages at once
constexpr int HEAD = 160;        // words of per-block scalars (below)

struct Params {
  const float* in;     // the panel on entry: row i, lane l at in[i·ld_in + l]
  int64_t ld_in;
  float* out;          // the factored panel; may equal in (getrf_panel_fused's carry)
  int64_t ld_out;
  const float* act_in; // (m) active mask, > 0 means active
  float* act_out;      // (m)
  int64_t* piv;        // (w) pivot lanes in factorization order
  float* linv;         // (w, w) row-major L11⁻¹
  int* lanes;          // (m) the lanes active on entry, ascending (their slots)
  int* rcol;           // (m) per slot: the column its lane was pivoted at, w if none
  int* nact;           // (1) how many lanes are active on entry
  float* lblk;         // [3][ib][ib] an inner block's pivot lanes' leaf rows
  unsigned* bar;       // (2) zeroed: the grid barrier's counter, then the
                       // leaf's count of next rows read
  int m, w, ib, G, C;
};

// The per-block scalars at the head of the dynamic shared memory (HEAD
// words; the kernel has no static shared memory).
struct Head {
  float red_v[NWARP];
  int red_l[NWARP];
  int wcnt[NWARP];
  int psl[MAX_IB];     // the leaf: this block's slot pivoted at column jj, or -1
  int pvl[MAX_IB];     // the pivot lanes of the current inner block (m: none)
  int pvp[MAX_IB];     // the updaters: the previous inner block's
  int ccnt[MAX_CLUSTER];
};
static_assert(sizeof(Head) <= HEAD * 4, "the head fits its words");

// Words of a leaf slot's rows in shared memory: the least power of two
// ≥ max(4, ib).
__host__ __device__ inline int slot_words(int ib) {
  int r = 4;
  while (r < ib) r *= 2;
  return r;
}

// Where row i of leaf slot l lies: slot-major, SR words a slot, its
// 16-byte chunk c at chunk c ^ key(l), key(l) = (l·SR / 32) mod (SR / 4),
// so that one chunk of eight neighbouring slots falls in eight different
// bank groups without padding.
__device__ __forceinline__ int slot_at(int l, int i, int SR) {
  const int key = ((l * SR) >> 5) & ((SR >> 2) - 1);
  return l * SR + ((((i >> 2) ^ key) << 2) | (i & 3));
}

// Words of a candidate the leaf's blocks push to each other: its slot's
// rows, then |value| (-1: none) and lane in 16 more bytes.
__host__ __device__ inline int rec_words(int ib) { return slot_words(ib) + 4; }

// Dynamic shared memory of a leaf block, in floats: the head, three
// buffers of the C candidates pushed per column (a column's pivot rows are
// read until the next column's update is done, while the blocks push the
// column after), the inner block's L and the next rows' U12 (ib × ib
// each, in ib × SR words to keep 16-byte alignment), the rows of its
// ⌈m / C⌉ slots (slot_at), their lanes and pivot columns.
__host__ __device__ inline int64_t leaf_floats(int m, int ib, int C) {
  const int64_t cs = ceildiv(m, C);
  return HEAD + 3 * (int64_t)C * rec_words(ib) + 2 * ib * slot_words(ib) +
         (int64_t)slot_words(ib) * cs + 2 * cs;
}

// Dynamic shared memory of an updater, in floats: the head, a tile's U12
// rows, the L of the current and previous inner blocks, the block
// inverse, the pivot lanes' rows before the block, the linv sums and a
// staged KC × LC block of X.
__host__ __device__ inline int64_t update_floats(int w, int ib) {
  return HEAD + (int64_t)ib * RG + 3 * ib * ib + (int64_t)ib * w + (int64_t)ib * LC + KC * LC;
}

// Both roles run in one launch: a block's share is the larger
// (smem.lu_panel_cluster_bytes / 4).
__host__ __device__ inline int64_t panel_floats(int m, int w, int ib, int C) {
  const int64_t a = leaf_floats(m, ib, C), b = update_floats(w, ib);
  return a > b ? a : b;
}

// The (|value|, index) best of the warp in every lane, in better()'s
// order (the largest value, then the lowest index; value -1: none, index
// INT_MAX), by two redux reductions: a value v ≥ 0 compares as its bits.
__device__ __forceinline__ void warp_best_redux(float& v, int& l) {
  const unsigned key = v >= 0.f ? __float_as_uint(v) + 1u : 0u;
  const unsigned kmax = __reduce_max_sync(FULL, key);
  const unsigned lmin = __reduce_min_sync(FULL, key == kmax ? (unsigned)l : 0xffffffffu);
  v = kmax ? __uint_as_float(kmax - 1u) : -1.f;
  l = kmax ? (int)lmin : INT_MAX;
}

// u[jj] -= Σ_{kk<jj} L[jj, kk]·u[kk] for jj = 1 … ib − 1 in place, each sum
// an fmaf chain over ascending kk (U12 of one row; L row-major ib × ib).
template <int IBT>
__device__ __forceinline__ void forward_sub(float (&u)[IBT], const float* L, int ib) {
#pragma unroll
  for (int jj = 1; jj < IBT; ++jj) {
    if (jj >= ib) break;
#pragma unroll
    for (int kk = 0; kk < jj; ++kk) u[jj] = fmaf(-L[jj * ib + kk], u[kk], u[jj]);
  }
}

// Panel row i in lanes pv[jj] (0 for a column without a pivot), through L2.
template <int IBT>
__device__ __forceinline__ void gather_rows(float (&u)[IBT], const Params& p, int i,
                                            const int* pv) {
  const float* row = p.out + (int64_t)i * p.ld_out;
#pragma unroll
  for (int jj = 0; jj < IBT; ++jj)
    if (jj < p.ib) u[jj] = pv[jj] < p.m ? __ldcg(row + pv[jj]) : 0.f;
}

// U12 of panel row i for the pivot lanes pv (ib rows, L row-major ib × ib)
// into u[jj·ib], jj < ib.  Not inlined, so that its registers are
// allocated for it alone.
template <int IBT>
__device__ __noinline__ void next_u12(const Params p, int i, const int* pv, const float* L,
                                      float* u_out) {
  float u[IBT];
  gather_rows(u, p, i, pv);
  forward_sub(u, L, p.ib);
#pragma unroll
  for (int jj = 0; jj < IBT; ++jj)
    if (jj < p.ib) u_out[jj * p.ib] = u[jj];
}

// The sum over the block; every thread gets it.  Ends with __syncthreads.
__device__ inline int block_sum(int x, int* wcnt) {
  x = __reduce_add_sync(FULL, x);
  if ((threadIdx.x & 31) == 0) wcnt[threadIdx.x >> 5] = x;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int q = 0; q < NWARP; ++q) s += wcnt[q];
  __syncthreads();
  return s;
}

// The next leaf's rows [b1, b1 + ib) of live slot l (its rows in S, the
// multipliers on entry; `x_in`: its column of the
// panel from row b1, as the grid left it) take the rank-ib update from the
// multipliers and the rows' U12 in Un, row by row over ascending jj (four
// rows of Un at once where ib is a multiple of 4), and replace them.
template <int IBT>
__device__ __noinline__ void next_rows(float* S, int l, int SR, const float* x_in, int64_t ld,
                                       const float* Un, int ib) {
  float x[IBT], mv[IBT];
#pragma unroll
  for (int i = 0; i < IBT; ++i)
    if (i < ib) x[i] = __ldcg(x_in + (int64_t)i * ld);
#pragma unroll
  for (int c = 0; c < IBT; c += 4)
    if (c < ib) {
      const float4 t = *reinterpret_cast<const float4*>(S + slot_at(l, c, SR));
      mv[c] = t.x, mv[c + 1] = t.y, mv[c + 2] = t.z, mv[c + 3] = t.w;
    }
#pragma unroll
  for (int jj = 0; jj < IBT; ++jj) {
    if (jj >= ib) break;
    if (ib % 4 == 0) {
#pragma unroll
      for (int i = 0; i < IBT; i += 4) {
        if (i >= ib) break;
        const float4 u = *reinterpret_cast<const float4*>(Un + jj * ib + i);
        x[i] = fmaf(-u.x, mv[jj], x[i]);
        x[i + 1] = fmaf(-u.y, mv[jj], x[i + 1]);
        x[i + 2] = fmaf(-u.z, mv[jj], x[i + 2]);
        x[i + 3] = fmaf(-u.w, mv[jj], x[i + 3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < IBT; ++i)
        if (i < ib) x[i] = fmaf(-Un[jj * ib + i], mv[jj], x[i]);
    }
  }
#pragma unroll
  for (int c = 0; c < IBT; c += 4)
    if (c < ib)
      *reinterpret_cast<float4*>(S + slot_at(l, c, SR)) = make_float4(x[c], x[c + 1], x[c + 2], x[c + 3]);
}

// The block's best live slot in leaf row `row`: (|value|, slot) in every
// thread (-1, INT_MAX: none); the ascending scan keeps the lowest slot, so
// the lowest lane, among equal maxima, and a NaN never wins.
__device__ __forceinline__ void block_best(const float* S, int SR, const int* lane, int nl,
                                           int row, Head& h, float& bv, int& bl) {
  bv = -1.f;
  bl = INT_MAX;
  for (int l = threadIdx.x; l < nl; l += NT) {
    if (lane[l] >= 0) {
      const float v = fabsf(S[slot_at(l, row, SR)]);
      if (v > bv) { bv = v; bl = l; }
    }
  }
  warp_best_redux(bv, bl);
  if ((threadIdx.x & 31) == 0) { h.red_v[threadIdx.x >> 5] = bv; h.red_l[threadIdx.x >> 5] = bl; }
  __syncthreads();
  bv = (threadIdx.x & 31) < NWARP ? h.red_v[threadIdx.x & 31] : -1.f;
  bl = (threadIdx.x & 31) < NWARP ? h.red_l[threadIdx.x & 31] : INT_MAX;
  warp_best_redux(bv, bl);
}

// The leaf's columns with every slot in registers: thread t holds slots t
// and t + NT of the block (the path for ⌈na / C⌉ ≤ 2·NT slots a block,
// m ≤ 8192 at C = 16).  The same arithmetic, column by column, as the
// path below, which holds the slots in shared memory: each update reaches
// the rows past the column at once, in registers; the candidate's owner
// stages its rows in `stg`, from where the block pushes them.
template <int IBT>
__device__ __noinline__ void leaf_regs(const Params p, Head& h, float* rec, float* Lb, float* Un,
                                       float* stg, int s0, int nl, ColumnBarrier& grid) {
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, r = (int)cluster.block_rank(), C = p.C;
  const int m = p.m, w = p.w, ib = p.ib, SR = slot_words(ib), RW = rec_words(ib), NV = RW / 4;
  const int ta = tid, tb = tid + NT;
  // the slots' lanes (-1: no slot) and the columns they were pivoted at
  // (-1: still active)
  const int lane_a = ta < nl ? __ldcg(p.lanes + s0 + ta) : -1;
  const int lane_b = tb < nl ? __ldcg(p.lanes + s0 + tb) : -1;
  int col_a = -1, col_b = -1;
  float ra[IBT], rb[IBT];
#pragma unroll
  for (int i = 0; i < IBT; ++i) {
    if (i >= ib) break;
    ra[i] = lane_a >= 0 ? p.in[(int64_t)i * p.ld_in + lane_a] : 0.f;
    rb[i] = lane_b >= 0 ? p.in[(int64_t)i * p.ld_in + lane_b] : 0.f;
  }
  if (lane_a >= 0) p.rcol[s0 + ta] = w;
  if (lane_b >= 0) p.rcol[s0 + tb] = w;

  for (int b0 = 0; b0 < w; b0 += ib) {
    const int b1 = b0 + ib;
    __syncthreads();  // the leaf of inner block b0 / ib starts
#pragma unroll
    for (int jj = 0; jj < IBT; ++jj) {
      if (jj >= ib) break;
      const int j = b0 + jj, buf = j % 3;
      // 1. the block's best live slot in row jj (slot a before b on ties)
      float bv = -1.f;
      int bl = INT_MAX;
      if (lane_a >= 0 && col_a < 0 && fabsf(ra[jj]) > bv) { bv = fabsf(ra[jj]); bl = ta; }
      if (lane_b >= 0 && col_b < 0 && fabsf(rb[jj]) > bv) { bv = fabsf(rb[jj]); bl = tb; }
      warp_best_redux(bv, bl);
      if ((tid & 31) == 0) { h.red_v[tid >> 5] = bv; h.red_l[tid >> 5] = bl; }
      __syncthreads();
      bv = (tid & 31) < NWARP ? h.red_v[tid & 31] : -1.f;
      bl = (tid & 31) < NWARP ? h.red_l[tid & 31] : INT_MAX;
      warp_best_redux(bv, bl);
      const int lc = bv >= 0.f ? bl : -1;
      // 2. its owner stages the candidate (rows, |value|, lane) and the
      //    block pushes it into every block's buffer `buf`
      if (tid == (lc >= 0 ? lc % NT : 0)) {
        if (lc >= 0) {
#pragma unroll
          for (int c = 0; c < IBT; c += 4)
            if (c < ib)
              *reinterpret_cast<float4*>(stg + c) =
                  lc < NT ? make_float4(ra[c], ra[c + 1], ra[c + 2], ra[c + 3])
                          : make_float4(rb[c], rb[c + 1], rb[c + 2], rb[c + 3]);
        }
        stg[RW - 4] = lc >= 0 ? bv : -1.f;
        stg[RW - 3] = __int_as_float(lc >= 0 ? (lc < NT ? lane_a : lane_b) : m);
      }
      __syncthreads();
      for (int e = tid; e < C * NV; e += NT) {
        const int d = e / NV, c = (e - d * NV) * 4;
        *reinterpret_cast<float4*>(cluster.map_shared_rank(rec, d) + (buf * C + r) * RW + c) =
            *reinterpret_cast<const float4*>(stg + c);
      }
      cluster_arrive();
      cluster_wait();  // the column's one cluster barrier
      // 3. every warp picks the winner of the C candidates alike
      const int q = tid & 31;
      float v = -1.f;
      int ml = INT_MAX;
      if (q < C && rec[(buf * C + q) * RW + RW - 4] >= 0.f) {
        v = rec[(buf * C + q) * RW + RW - 4];
        ml = __float_as_int(rec[(buf * C + q) * RW + RW - 3]);
      }
      int pl = ml;
      warp_best_redux(v, pl);
      const int pg = v >= 0.f ? __ffs(__ballot_sync(FULL, ml == pl)) - 1 : -1;
      const float* pc = rec + (buf * C + max(pg, 0)) * RW;
      if (tid < ib) Lb[jj * ib + tid] = pg >= 0 ? pc[tid] : 0.f;
      if (tid == 0) {
        h.pvl[jj] = pg >= 0 ? pl : m;
        if (r == 0) p.piv[j] = pg >= 0 ? (int64_t)pl : (int64_t)m;
      }
      // 4. the slots: row jj takes the multipliers, the rows past it the
      //    rank-1 update (unfused, as the plain version)
      const float pval = pg >= 0 ? pc[jj] : 0.f;
      const float safe = pval == 0.f ? 1.f : pval;
      const bool piv_a = pg == r && lc == ta, piv_b = pg == r && lc == tb;
      if (piv_a) col_a = j;
      if (piv_b) col_b = j;
      const bool live_a = lane_a >= 0 && col_a < 0, live_b = lane_b >= 0 && col_b < 0;
      const float ma = live_a ? ra[jj] / safe : 0.f, mb = live_b ? rb[jj] / safe : 0.f;
      if (live_a) ra[jj] = ma;
      if (live_b) rb[jj] = mb;
#pragma unroll
      for (int c = (jj + 1) / 4 * 4; c < IBT; c += 4) {
        if (c >= ib) break;
        float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
        if (pg >= 0) q = *reinterpret_cast<const float4*>(pc + c);
        const float pq[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int i = c + t;
          if (i <= jj || i >= ib) continue;
          if (live_a) ra[i] = __fsub_rn(ra[i], __fmul_rn(pq[t], ma));
          if (live_b) rb[i] = __fsub_rn(rb[i], __fmul_rn(pq[t], mb));
        }
      }
    }
    // the leaf's rows of the slots active at its start, the pivot slots'
    // column, L into lblk for the updaters
    const bool wa = lane_a >= 0 && (col_a < 0 || col_a >= b0);
    const bool wb = lane_b >= 0 && (col_b < 0 || col_b >= b0);
#pragma unroll
    for (int i = 0; i < IBT; ++i) {
      if (i >= ib) break;
      if (wa) p.out[(int64_t)(b0 + i) * p.ld_out + lane_a] = ra[i];
      if (wb) p.out[(int64_t)(b0 + i) * p.ld_out + lane_b] = rb[i];
    }
    if (col_a >= b0) p.rcol[s0 + ta] = col_a;
    if (col_b >= b0) p.rcol[s0 + tb] = col_b;
    // the slots' rows wait in `stg` (slot-major, as the shared-memory path
    // holds them) while the registers serve the next rows
    const int sa = lane_a >= 0 ? ta : 0, sb = lane_b >= 0 ? tb : 0;
#pragma unroll
    for (int c = 0; c < IBT; c += 4) {
      if (c >= ib) break;
      if (lane_a >= 0)
        *reinterpret_cast<float4*>(stg + slot_at(sa, c, SR)) = make_float4(ra[c], ra[c + 1], ra[c + 2], ra[c + 3]);
      if (lane_b >= 0)
        *reinterpret_cast<float4*>(stg + slot_at(sb, c, SR)) = make_float4(rb[c], rb[c + 1], rb[c + 2], rb[c + 3]);
    }
    __syncthreads();
    if (r == 0)
      for (int e = tid; e < ib * ib; e += NT) p.lblk[(b0 / ib % 3) * ib * ib + e] = Lb[e];
    grid.sync();  // the leaf is in out: the updaters take the block's end
    if (b1 == w) break;
    // the next leaf's rows: their U12 (each block alike), then each live
    // slot's rows from the panel and their rank-ib update from the
    // multipliers it holds
    if (tid < ib) next_u12<IBT>(p, b1 + tid, h.pvl, Lb, Un + tid);
    __syncthreads();
    if (lane_a >= 0 && col_a < 0)
      next_rows<IBT>(stg, sa, SR, p.out + (int64_t)b1 * p.ld_out + lane_a, p.ld_out, Un, ib);
    if (lane_b >= 0 && col_b < 0)
      next_rows<IBT>(stg, sb, SR, p.out + (int64_t)b1 * p.ld_out + lane_b, p.ld_out, Un, ib);
    // back into registers (a missing slot reads slot 0's words, unused)
#pragma unroll
    for (int c = 0; c < IBT; c += 4) {
      if (c >= ib) break;
      const float4 ta4 = *reinterpret_cast<const float4*>(stg + slot_at(sa, c, SR));
      const float4 tb4 = *reinterpret_cast<const float4*>(stg + slot_at(sb, c, SR));
      ra[c] = ta4.x, ra[c + 1] = ta4.y, ra[c + 2] = ta4.z, ra[c + 3] = ta4.w;
      rb[c] = tb4.x, rb[c + 1] = tb4.y, rb[c + 2] = tb4.z, rb[c + 3] = tb4.w;
    }
    // the next rows are read: the updaters may stream the panel again
    __syncthreads();
    if (tid == 0)
      asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p.bar + 1), "r"(1u) : "memory");
  }
}

// The leaf cluster (blocks 0 … C − 1).
template <int IBT>
__device__ __noinline__ void leaf_role(const Params p, float* smem, ColumnBarrier& grid) {
  cg::cluster_group cluster = cg::this_cluster();
  Head& h = *reinterpret_cast<Head*>(smem);
  const int tid = threadIdx.x, r = (int)cluster.block_rank(), C = p.C;
  const int m = p.m, w = p.w, ib = p.ib, SR = slot_words(ib), RW = rec_words(ib), NV = RW / 4;
  const int csmax = ceildiv(m, C);
  float* rec = smem + HEAD;                        // [3][C][RW] pushed candidates
  float* Lb = rec + 3 * C * RW;                    // [ib][ib] the inner block's L
  float* Un = Lb + ib * SR;                        // [ib][ib] the next rows' U12
  float* S = Un + ib * SR;                         // row i of slot l at S[slot_at(l, i)]
  int* lane = reinterpret_cast<int*>(S + (int64_t)SR * csmax);  // ~lane once pivoted
  int* blk = lane + csmax;                         // the column a slot was pivoted at

  // 1. out of place: rows [0, ib) of the lanes inactive on entry into out
  //    (the leaf writes the active ones, the updaters copy rows [ib, w));
  //    lanes [lo, hi) are this block's
  const int ch = ceildiv(m, C), lo = min(m, r * ch), hi = min(m, lo + ch);
  if (p.in != p.out)
    for (int l = lo + tid; l < hi; l += NT)
      if (!(p.act_in[l] > 0.f))
        for (int i = 0; i < ib; ++i)
          p.out[(int64_t)i * p.ld_out + l] = p.in[(int64_t)i * p.ld_in + l];
  // 2. the lanes active on entry, ascending: count each block's range,
  //    push the counts to every block, then place the lanes
  int cnt = 0;
  for (int l = lo + tid; l < hi; l += NT) cnt += p.act_in[l] > 0.f;
  cnt = block_sum(cnt, h.wcnt);
  if (tid < C) cluster.map_shared_rank(h.ccnt, tid)[r] = cnt;
  cluster.sync();
  int off = 0, na = 0;
  for (int q = 0; q < C; ++q) {
    off += q < r ? h.ccnt[q] : 0;
    na += h.ccnt[q];
  }
  for (int base = lo; base < hi; base += NT) {
    const int l = base + tid;
    const bool a = l < hi && p.act_in[l] > 0.f;
    const unsigned bal = __ballot_sync(FULL, a);
    if ((tid & 31) == 0) h.wcnt[tid >> 5] = __popc(bal);
    __syncthreads();
    int before = 0, all = 0;
    for (int q = 0; q < NWARP; ++q) {
      before += q < (tid >> 5) ? h.wcnt[q] : 0;
      all += h.wcnt[q];
    }
    if (a) p.lanes[off + before + __popc(bal & ((1u << (tid & 31)) - 1u))] = l;
    off += all;
    __syncthreads();
  }
  if (r == 0 && tid == 0) *p.nact = na;
  __threadfence();
  cluster.sync();
  // 3. this block's slots [s0, s0 + nl) of the list, and their first rows
  const int cs = max(1, ceildiv(na, C)), s0 = r * cs;
  const int nl = max(0, min(cs, na - s0));
  if (cs <= 2 * NT) {
    leaf_regs<IBT>(p, h, rec, Lb, Un, S, s0, nl, grid);
    return;
  }
  for (int l = tid; l < nl; l += NT) {
    lane[l] = __ldcg(p.lanes + s0 + l);
    blk[l] = -1;
    p.rcol[s0 + l] = w;
  }
  __syncthreads();
  copy_batched(tid, (int64_t)ib * nl, NT,
               [&](int64_t e) { return p.in[(int)e / nl * p.ld_in + lane[(int)e % nl]]; },
               [&](int64_t e, float v) { S[slot_at((int)e % nl, (int)e / nl, SR)] = v; });

  for (int b0 = 0; b0 < w; b0 += ib) {
    const int b1 = b0 + ib;
    if (tid < ib) h.psl[tid] = -1;
    __syncthreads();  // the leaf of inner block b0 / ib starts
    float bv;
    int bl, pgp = -1;
    block_best(S, SR, lane, nl, 0, h, bv, bl);
    for (int jj = 0; jj < ib; ++jj) {
      const int j = b0 + jj, buf = j % 3;
      const int lc = bv >= 0.f ? bl : -1;
      // the previous column's pivot rows: rows (jj, ib) of every live slot
      // still lack its update
      const float* pcp = rec + ((j + 2) % 3 * C + max(pgp, 0)) * RW;
      const bool lazy = jj > 0 && pgp >= 0;
      // 1. push the candidate (its slot's rows with that update, |value|,
      //    lane) into every block's buffer `buf`, 16 bytes a store
      const float mc = jj > 0 && lc >= 0 ? S[slot_at(lc, jj - 1, SR)] : 0.f;
      for (int e = tid; e < C * NV; e += NT) {
        const int d = e / NV, c = (e - d * NV) * 4;
        float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c == RW - 4) {
          q.x = lc >= 0 ? bv : -1.f;
          q.y = __int_as_float(lc >= 0 ? lane[lc] : m);
        } else if (lc >= 0) {
          q = *reinterpret_cast<const float4*>(S + slot_at(lc, c, SR));
          if (jj > 0) {
            if (c > jj) q.x = __fsub_rn(q.x, __fmul_rn(lazy ? pcp[c] : 0.f, mc));
            if (c + 1 > jj) q.y = __fsub_rn(q.y, __fmul_rn(lazy ? pcp[c + 1] : 0.f, mc));
            if (c + 2 > jj) q.z = __fsub_rn(q.z, __fmul_rn(lazy ? pcp[c + 2] : 0.f, mc));
            if (c + 3 > jj) q.w = __fsub_rn(q.w, __fmul_rn(lazy ? pcp[c + 3] : 0.f, mc));
          }
        }
        *reinterpret_cast<float4*>(cluster.map_shared_rank(rec, d) + (buf * C + r) * RW + c) = q;
      }
      __syncthreads();
      cluster_arrive();
      // 2. meanwhile rows (jj, ib) of the live slots take the previous
      //    column's update, four rows a load
      if (jj > 0)
        for (int l = tid; l < nl; l += NT) {
          if (lane[l] < 0) continue;
          const float mu = S[slot_at(l, jj - 1, SR)];
#pragma unroll
          for (int c = 0; c < IBT; c += 4) {
            if (c >= ib) break;
            if (c + 3 <= jj) continue;
            float4& cw = *reinterpret_cast<float4*>(S + slot_at(l, c, SR));
            float4 t = cw;
            if (c > jj) t.x = __fsub_rn(t.x, __fmul_rn(lazy ? pcp[c] : 0.f, mu));
            if (c + 1 > jj) t.y = __fsub_rn(t.y, __fmul_rn(lazy ? pcp[c + 1] : 0.f, mu));
            if (c + 2 > jj) t.z = __fsub_rn(t.z, __fmul_rn(lazy ? pcp[c + 2] : 0.f, mu));
            if (c + 3 > jj) t.w = __fsub_rn(t.w, __fmul_rn(lazy ? pcp[c + 3] : 0.f, mu));
            cw = t;
          }
        }
      cluster_wait();  // the column's one cluster barrier
      // 3. every warp picks the winner of the C candidates alike
      const int q = tid & 31;
      float v = -1.f;
      int ml = INT_MAX;
      if (q < C && rec[(buf * C + q) * RW + RW - 4] >= 0.f) {
        v = rec[(buf * C + q) * RW + RW - 4];
        ml = __float_as_int(rec[(buf * C + q) * RW + RW - 3]);
      }
      int pl = ml;
      warp_best_redux(v, pl);
      const int pg = v >= 0.f ? __ffs(__ballot_sync(FULL, ml == pl)) - 1 : -1;
      const float* pc = rec + (buf * C + max(pg, 0)) * RW;
      if (tid < ib) Lb[jj * ib + tid] = pg >= 0 ? pc[tid] : 0.f;
      if (tid == 0) {
        h.pvl[jj] = pg >= 0 ? pl : m;
        if (r == 0) p.piv[j] = pg >= 0 ? (int64_t)pl : (int64_t)m;
      }
      // 4. this block's slots: row jj takes the multipliers and row jj + 1
      //    this column's update (unfused, as the plain version); the rows
      //    past it take it in the next column's step 2
      const float pval = pg >= 0 ? pc[jj] : 0.f;
      const float safe = pval == 0.f ? 1.f : pval;
      const float pcn = pg >= 0 && jj + 1 < ib ? pc[jj + 1] : 0.f;
      const int lp = pg == r ? lc : -1;
      if (lp >= 0 && tid == 0) h.psl[jj] = lp;
      for (int l = tid; l < nl; l += NT) {
        if (l == lp) { lane[l] = ~lane[l]; blk[l] = j; continue; }
        if (lane[l] < 0) continue;
        float& xj = S[slot_at(l, jj, SR)];
        const float mult = xj / safe;
        xj = mult;
        if (jj + 1 < ib) {
          float& xn = S[slot_at(l, jj + 1, SR)];
          xn = __fsub_rn(xn, __fmul_rn(pcn, mult));
        }
      }
      pgp = pg;
      if (jj + 1 < ib) block_best(S, SR, lane, nl, jj + 1, h, bv, bl);
    }
    __syncthreads();
    // the leaf's rows of the slots active at its start; the pivot slots'
    // column; L into lblk for the updaters
    for (int l = tid; l < nl; l += NT) {
      const int ln = lane[l];
      if (ln < 0 && blk[l] < b0) continue;
      float* col = p.out + (int64_t)b0 * p.ld_out + (ln >= 0 ? ln : ~ln);
#pragma unroll
      for (int c = 0; c < IBT; c += 4) {
        if (c >= ib) break;
        const float4 t = *reinterpret_cast<const float4*>(S + slot_at(l, c, SR));
        col[(int64_t)c * p.ld_out] = t.x;
        if (c + 1 < ib) col[(int64_t)(c + 1) * p.ld_out] = t.y;
        if (c + 2 < ib) col[(int64_t)(c + 2) * p.ld_out] = t.z;
        if (c + 3 < ib) col[(int64_t)(c + 3) * p.ld_out] = t.w;
      }
    }
    if (tid < ib && h.psl[tid] >= 0) p.rcol[s0 + h.psl[tid]] = b0 + tid;
    if (r == 0)
      for (int e = tid; e < ib * ib; e += NT) p.lblk[(b0 / ib % 3) * ib * ib + e] = Lb[e];
    grid.sync();  // the leaf is in out: the updaters take the block's end
    if (b1 == w) break;
    // the next leaf's rows: their U12 (each block alike), then each live
    // slot's rows from the panel at once and their rank-ib update from the
    // multipliers held here
    if (tid < ib) next_u12<IBT>(p, b1 + tid, h.pvl, Lb, Un + tid);
    __syncthreads();
    for (int l = tid; l < nl; l += NT)
      if (lane[l] >= 0)
        next_rows<IBT>(S, l, SR, p.out + (int64_t)b1 * p.ld_out + lane[l], p.ld_out, Un, ib);
    // the next rows are read: the updaters may stream the panel again
    __syncthreads();
    if (tid == 0)
      asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p.bar + 1), "r"(1u) : "memory");
  }
}

// The updaters (blocks C … G − 1).
template <int IBT>
__device__ __noinline__ void update_role(const Params p, float* smem, ColumnBarrier& grid) {
  Head& h = *reinterpret_cast<Head*>(smem);
  const int tid = threadIdx.x, m = p.m, w = p.w, ib = p.ib;
  const int u0 = blockIdx.x - p.C, U = p.G - p.C;  // this updater, of U
  float* us = smem + HEAD;                         // [ib][RG] a tile's U12
  float* Lc = us + ib * RG;                        // [ib][ib] the block's L
  float* Lp = Lc + ib * ib;                        // [ib][ib] the previous block's
  float* Xbb = Lp + ib * ib;                       // [ib][ib] X[b, b]
  float* Lrow = Xbb + ib * ib;                     // [ib][w] L[b, :b0]
  float* Ts = Lrow + (int64_t)ib * w;              // [ib][LC] the linv sums
  float* Xs = Ts + ib * LC;                        // [KC][LC] rows of X
  const int64_t gt = (int64_t)u0 * NT + tid, gs = (int64_t)U * NT;

  // out of place: rows [ib, w) into out; the mask on entry into act_out
  if (p.in != p.out)
    copy_batched(gt, (int64_t)(w - ib) * m, gs,
                 [&](int64_t e) { return p.in[(ib + (int)e / m) * p.ld_in + (int)e % m]; },
                 [&](int64_t e, float v) { p.out[(ib + (int)e / m) * p.ld_out + (int)e % m] = v; });
  copy_batched(gt, m, gs, [&](int64_t l) { return p.act_in[l]; },
               [&](int64_t l, float v) { p.act_out[l] = v; });

  for (int b0 = 0; b0 < w; b0 += ib) {
    const int b1 = b0 + ib, bk = b0 / ib;
    grid.sync();  // leaf b0 / ib is in out, the previous block's end done
    const int na = __ldcg(p.nact);
    if (tid < ib) {
      h.pvp[tid] = b0 ? (int)__ldcg(p.piv + b0 - ib + tid) : m;
      h.pvl[tid] = (int)__ldcg(p.piv + b0 + tid);
    }
    for (int e = tid; e < ib * ib; e += NT) {
      Lc[e] = __ldcg(p.lblk + bk % 3 * ib * ib + e);
      Lp[e] = b0 ? __ldcg(p.lblk + (bk + 2) % 3 * ib * ib + e) : 0.f;
    }
    __syncthreads();
    // the previous block's pivot lanes take their U12 rows [b0, w), one
    // thread a row; their old rows are read by no one else now
    if (b0)
      for (int i = b0 + u0 + U * tid; i < w; i += U * NT) {   // rows spread over the blocks
        float u[IBT];
        gather_rows(u, p, i, h.pvp);
        forward_sub(u, Lp, ib);
        float* row = p.out + (int64_t)i * p.ld_out;
#pragma unroll
        for (int jj = 0; jj < IBT; ++jj)
          if (jj < ib && h.pvp[jj] < m) row[h.pvp[jj]] = u[jj];
      }
    if (u0 == 0 && tid < ib && h.pvl[tid] < m) p.act_out[h.pvl[tid]] = 0.f;
    // the block row of linv, LC columns a block from the last updater
    // down: X[b, c] = -X[b, b]·T with T = L[b, c:b0]·X[c:b0, c] for
    // c < b0, X[b, b] for c in [b0, b1), 0 past it
    const int nlc = ceildiv(b1, LC);
    if (U - 1 - u0 < nlc) {
      copy_batched(tid, (int64_t)ib * b0, NT,
                   [&](int64_t e) {
                     const int jj = (int)e / b0;
                     return h.pvl[jj] < m ? __ldcg(p.out + (int64_t)((int)e % b0) * p.ld_out + h.pvl[jj])
                                          : 0.f;
                   },
                   [&](int64_t e, float v) { Lrow[(int)e / b0 * w + (int)e % b0] = v; });
      if (tid < ib) {
        const int c = tid;
        float x[IBT];
#pragma unroll
        for (int jj = 0; jj < IBT; ++jj) {
          if (jj >= ib) break;
          float acc = jj == c ? 1.f : 0.f;
#pragma unroll
          for (int kk = 0; kk < jj; ++kk)
            if (kk >= c) acc = fmaf(-Lc[jj * ib + kk], x[kk], acc);
          x[jj] = jj >= c ? acc : 0.f;
          Xbb[jj * ib + c] = x[jj];
        }
      }
      __syncthreads();
      for (int lb = U - 1 - u0; lb < nlc; lb += U) {
        const int c0 = lb * LC, cl = tid % LC, jg = tid / LC, c = c0 + cl;
        float T[(IBT + LJ - 1) / LJ];
#pragma unroll
        for (int q = 0; q < (IBT + LJ - 1) / LJ; ++q) T[q] = 0.f;
        // X[k, c] for k in [c, b0), KC rows of the block's columns at once
        for (int k0 = c0; k0 < b0; k0 += KC) {
          const int nk = min(KC, b0 - k0);
          copy_batched(tid, nk * LC, NT,
                       [&](int64_t e) {
                         const int cc = c0 + (int)e % LC;
                         return cc < w ? __ldcg(p.linv + (int64_t)(k0 + (int)e / LC) * w + cc) : 0.f;
                       },
                       [&](int64_t e, float v) { Xs[e] = v; });
          __syncthreads();
          if (c < b0)
            for (int kk = max(0, c - k0); kk < nk; ++kk) {
              const float x = Xs[kk * LC + cl];
#pragma unroll
              for (int q = 0; q < (IBT + LJ - 1) / LJ; ++q)
                if (jg + q * LJ < ib)
                  T[q] = fmaf(Lrow[(int64_t)(jg + q * LJ) * w + k0 + kk], x, T[q]);
            }
          __syncthreads();
        }
        if (c < b0)
#pragma unroll
          for (int q = 0; q < (IBT + LJ - 1) / LJ; ++q)
            if (jg + q * LJ < ib) Ts[(jg + q * LJ) * LC + cl] = T[q];
        __syncthreads();
        if (c < b0)
          for (int jj = jg; jj < ib; jj += LJ) {
            float x = 0.f;
            for (int kk = 0; kk <= jj; ++kk) x = fmaf(-Xbb[jj * ib + kk], Ts[kk * LC + cl], x);
            p.linv[(int64_t)(b0 + jj) * w + c] = x;
          }
        if (lb == 0)
          for (int e = tid; e < ib * (w - b0); e += NT) {
            const int jj = e / (w - b0), c2 = b0 + e % (w - b0);
            p.linv[(int64_t)(b0 + jj) * w + c2] = c2 < b1 ? Xbb[jj * ib + c2 - b0] : 0.f;
          }
        __syncthreads();
      }
    }
    // the delayed rank-ib update of the live slots' rows past the next
    // leaf's, tile by tile (RG rows × SG slots), once the leaf has read
    // its next rows
    const int r0 = b1 + ib;
    const int nrg = r0 < w ? ceildiv(w - r0, RG) : 0, nsg = ceildiv(na, SG);
    if (u0 < nrg * nsg) {
      if (tid == 0) wait_at_least(p.bar + 1, (unsigned)(p.C * (bk + 1)));
      __syncthreads();
    }
    for (int t = u0; t < nrg * nsg; t += U) {
      const int i0 = r0 + t / nsg * RG, ni = min(RG, w - i0), sg = t % nsg;
      if (tid < ni) {
        float u[IBT];
        gather_rows(u, p, i0 + tid, h.pvl);
        forward_sub(u, Lc, ib);
#pragma unroll
        for (int jj = 0; jj < IBT; ++jj)
          if (jj < ib) us[jj * RG + tid] = u[jj];
      }
      __syncthreads();
      for (int k = 0; k < SPT; ++k) {
        const int s = sg * SG + k * NT + tid;
        if (s >= na) break;
        if (__ldcg(p.rcol + s) < b1) continue;  // pivoted in this block or before
        // the slot's multipliers and its ni rows at once, then the sums
        float* col = p.out + __ldcg(p.lanes + s);
        float mv[IBT], acc[RG];
#pragma unroll
        for (int jj = 0; jj < IBT; ++jj)
          if (jj < ib) mv[jj] = __ldcg(col + (int64_t)(b0 + jj) * p.ld_out);
#pragma unroll
        for (int q = 0; q < RG; ++q)
          if (q < ni) acc[q] = __ldcg(col + (int64_t)(i0 + q) * p.ld_out);
#pragma unroll
        for (int jj = 0; jj < IBT; ++jj) {
          if (jj >= ib) break;
#pragma unroll
          for (int q = 0; q < RG; q += 4) {
            const float4 u = *reinterpret_cast<const float4*>(us + jj * RG + q);
            acc[q] = fmaf(-u.x, mv[jj], acc[q]);
            acc[q + 1] = fmaf(-u.y, mv[jj], acc[q + 1]);
            acc[q + 2] = fmaf(-u.z, mv[jj], acc[q + 2]);
            acc[q + 3] = fmaf(-u.w, mv[jj], acc[q + 3]);
          }
        }
#pragma unroll
        for (int q = 0; q < RG; ++q)
          if (q < ni) col[(int64_t)(i0 + q) * p.ld_out] = acc[q];
      }
      __syncthreads();
    }
  }
}

// IBT: the inner block's register arrays, 16 for ib ≤ 16, else 32.
template <int IBT>
__global__ void __launch_bounds__(NT, 1) lu_panel_cluster_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  ColumnBarrier grid{p.bar, (unsigned)p.G, 0u};
  if ((int)blockIdx.x < p.C) leaf_role<IBT>(p, smem, grid);
  else update_role<IBT>(p, smem, grid);
}

inline const void* kernel_for(int ib) {
  return ib <= 16 ? (const void*)lu_panel_cluster_kernel<16>
                  : (const void*)lu_panel_cluster_kernel<32>;
}

// The dynamic shared memory a launch asks for: the roles' share, and at
// least half an SM's, so that no two blocks share an SM (the leaf's SMs
// run nothing else).
inline int launch_bytes(int m, int w, int ib, int C, int sm_bytes) {
  return (int)std::max<int64_t>(4 * panel_floats(m, w, ib, C), sm_bytes / 2);
}

// The launch configuration: a cooperative launch of clusters of C blocks.
struct LaunchConfig {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];
  LaunchConfig(int G, int C, int bytes, cudaStream_t stream) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeCooperative;
    attr[1].val.cooperative = 1;
    cfg.gridDim = dim3(G);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 2;
  }
};

// The kernel's attributes for a launch of `bytes` of dynamic shared memory.
inline cudaError_t set_attributes(const void* kernel, int bytes) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The plan of a panel: clusters of C = MAX_CLUSTER blocks, the size the
// shared-memory gate (smem.lu_panel_fits) checks, and the grid G, every
// cluster the card can hold at once (at least two: the leaf and one of
// updaters).  Returns a CUDA error code; the launch refuses a grid that is
// not co-resident.
inline int plan(int m, int w, int ib, int* G_out, int* C_out) {
  if (m < 1 || w < 1 || ib < 1 || ib > MAX_IB || w % ib != 0)
    return (int)cudaErrorInvalidValue;
  const void* kernel = kernel_for(ib);
  int dev = 0, optin = 0, per_sm = 0, coop = 0, clusters = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&clusters, cudaDevAttrClusterLaunch, dev);
  if (!coop || !clusters) return (int)cudaErrorNotSupported;
  const int C = MAX_CLUSTER, bytes = launch_bytes(m, w, ib, C, per_sm);
  if (bytes > optin) return (int)cudaErrorInvalidValue;
  if ((err = set_attributes(kernel, bytes)) != cudaSuccess) return (int)err;
  LaunchConfig lc(C, C, bytes, 0);
  int n = 0;
  if ((err = cudaOccupancyMaxActiveClusters(&n, kernel, &lc.cfg)) != cudaSuccess)
    return (int)err;
  if (n < 2) return (int)cudaErrorCooperativeLaunchTooLarge;
  *G_out = n * C;
  *C_out = C;
  return 0;
}

// One cooperative launch of clusters of C blocks on G blocks (G from the
// plan).  A grid the card cannot hold at once is refused with an error
// code, never run.
inline int launch(const Params& p, cudaStream_t stream) {
  if (p.m < 1 || p.w < 1 || p.ib < 1 || p.ib > MAX_IB || p.w % p.ib != 0 || p.C < 1 ||
      p.C > MAX_CLUSTER || p.G < 2 * p.C || p.G % p.C != 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  const int bytes = launch_bytes(p.m, p.w, p.ib, p.C, per_sm);
  if ((err = set_attributes(kernel_for(p.ib), bytes)) != cudaSuccess) return (int)err;
  LaunchConfig lc(p.G, p.C, bytes, stream);
  err = p.ib <= 16 ? cudaLaunchKernelEx(&lc.cfg, lu_panel_cluster_kernel<16>, p)
                   : cudaLaunchKernelEx(&lc.cfg, lu_panel_cluster_kernel<32>, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace lu_panel
