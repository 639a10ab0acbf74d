// B partial-pivot LUs in one launch: the port of the Pallas kernel
// `getrf_batched` (slate_tpu/ops/pallas_kernels.py:2346-2458:
// _lu_scattered_value, _getrf_batched_kernel).
//
// The function, per problem: TRUE partial-pivot LU of the TRANSPOSED,
// lane-major (n, n) problem (row j is column j of A, lane l is row l of
// A).  Rows never move.  For each column j the pivot is the lowest lane
// among the maxima of |x[j, l]| over the still-active lanes; a zero pivot
// divides by 1, so a singular problem gives finite output; the live lanes
// (active, not the pivot) take multipliers x[j, l] / x[j, p] in row j and
// rows (j, b1) of the ib = 32 block lose x[i, p]·mult[l]; the pivot lane
// leaves the active set.  At each block end the rows past it take
// U12 = L11⁻¹·(pivot columns) by forward substitution with the block's
// unit-lower L11 and the rank-32 update over all lanes; lanes pivoted in
// the block take their U12 rows.  Outputs: the factored problem (packed
// factor rows in the pivot lanes, so out[:, piv]ᵀ is the LAPACK-packed LU
// of A) and piv, the n pivot lanes in factorization order.  The per-column
// argmax, the unfused in-block rank-1 update (__fsub_rn(x, __fmul_rn(pc,
// mult)), so that pivot sequences follow the plain version's), the U12
// substitution and the delayed update as fmaf sums over ascending jj are
// lu_panel.cuh's arithmetic with the panel width equal to the problem.
//
// What bounds it on an H100: at B = 64, n = 256 the batch moves 33.6 MB
// and does 7.2e8 FLOP, ~0.01 ms at the card's rates, but each problem is a
// chain of n dependent column steps, each a masked argmax over n lanes.
// What decides the time is how short one column step is and whether the
// data it touches is on chip.  The TPU kernel keeps whole problems in VMEM;
// one fp32 problem at n = 256 is 256 KB, more than one SM's 227 KB.  Two
// routes (slate_getrf_batched_plan decides from n; ops/smem.py
// getrf_batched_plan restates it and ops/kernels.py checks the two agree
// when it loads this library):
//
//   * `smem` (n ≤ 800 on the H100): ONE THREAD-BLOCK CLUSTER OWNS ONE
//     PROBLEM, which lives in its blocks' shared memory.  Block r of the
//     cluster's C owns the contiguous 32-row blocks [r·R, (r+1)·R) across
//     all n lanes (a range of A's columns), read once with cp.async; C is
//     the smallest cluster whose shares fit (cluster_floats): C = 1 to
//     n = 224, 2 at 256, 13 at 800.  Per 32-row block b:
//       - the column loop runs entirely inside b's owner block, 256
//         threads, lane l = q·256 + t on thread t, each thread holding its
//         lanes' 32 values of the row block in registers.  Per column the
//         masked argmax is a warp reduction (lu_panel.cuh warp_best_redux:
//         the lowest lane among equal maxima; no candidate gives p = n),
//         each warp's winner publishes its 32-value column with its
//         magnitude into a slot (two sets, by the column's parity), and
//         ONE __syncthreads follows: every thread then picks the best of
//         the warps' candidates and reads the pivot's column from that
//         slot, so a column step has no other block or cluster barrier.
//         The finished row block is written to the output at once and
//         kept in the owner's shared memory;
//       - ONE CLUSTER BARRIER (the owner's arrival a release, the others'
//         relaxed: they publish nothing);
//       - every block with rows past the row block reads its pivots and
//         L11 over distributed shared memory and, by chunks of 64 rows,
//         forms U12 of its rows by forward substitution (four threads a
//         row, each final u[kk] passed by a shuffle: the right-looking
//         order of the same fmaf sums) and applies the delayed rank-32
//         update to them, a lane a thread, each multiplier read once from
//         the owner's shared memory; pivot lanes of the row block take
//         their U12 rows.  The owner of the next row block updates
//         those rows first (the rows ascend), but its other rows follow
//         before its next column loop: overlapping them would need warp
//         specialisation.  The other blocks' updates run beside the
//         owner's next column loop.
//     Input read once, output written once, no __device__ state.  A launch
//     the card refuses (a cluster it cannot place) returns its error.
//   * `l2` (n = 832, 864): the kernel before the smem route, unchanged: one
//     block of 256 threads per problem, which lives in its output buffer in
//     device memory (L2 holds it, 16 MB at B = 64); the current 32-row
//     block and the block's U12 rows in shared memory ((2·32·n + 2n + 52)·4
//     bytes, all dynamic), three block barriers a column.  Its shared
//     memory bounds n: n ≤ 864 (ops/smem.py getrf_batched_bytes is the
//     same formula, the shape gate of both routes).

#include <atomic>

#include "lu_panel.cuh"

// perf/kernel_phases.py defines BATCHED_MARK(k) in its stamped copy: thread
// 0 of each of the first blocks stamps the time at each mark (Mark below).
#ifndef BATCHED_MARK
#define BATCHED_MARK(k)
#endif

namespace {

namespace cg = cooperative_groups;
using grid_sync::cluster_arrive;
using grid_sync::cluster_arrive_relaxed;
using grid_sync::cluster_wait;
using lu_panel::better;
using lu_panel::NT;
using lu_panel::NWARP;
using lu_panel::warp_best;
using lu_panel::warp_best_redux;

constexpr int IB = 32;

// ---------------------------------------------------------------------------
// The smem route: one cluster a problem
// ---------------------------------------------------------------------------

constexpr int MAX_CLUSTER = 16;  // the widest cluster (non-portable)
constexpr int MAX_LPT = 4;       // lanes a thread holds: n ≤ 1024
constexpr int UC = 64;           // rows of a U12 chunk
constexpr int UCS = UC + 4;      // its row stride (16-byte rows, 4-way gather)
constexpr int SLOT = IB + 4;     // a warp's candidate: 32 values, |value|, lane
// the H100's opt-in shared memory a block may take: the route's limit
constexpr int64_t SMEM_MAX = 232448;

// The smem route's marks (BATCHED_MARK): the start, the rows read, each
// column, the row block stored, the cluster barrier passed, a chunk's U12
// and its update, the end.
enum Mark { M_START, M_LOADED, M_COLUMN, M_STORED, M_WAITED, M_U12, M_UPDATED, M_END };

// Floats of dynamic shared memory of a block that owns R row blocks: its
// rows, a chunk's U12, the row block's L11, each lane's pivot column and
// each of its columns' pivot lane, two sets of the warps' candidates, the
// row block's 32 pivots (smem.getrf_batched_cluster_bytes / 4).
__host__ __device__ inline int64_t cluster_floats(int n, int R) {
  return (int64_t)R * IB * n + (int64_t)IB * UCS + IB * (IB + 1) + 2 * (int64_t)n +
         2 * NWARP * SLOT + IB;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}

// This thread's best live lane in row j of its registers: ascending lanes
// keep the lowest among equal maxima, and a NaN never wins.
template <int LPT>
__device__ __forceinline__ void thread_best(const float (&x)[LPT][IB], unsigned live, int j,
                                            float& bv, int& bl, int& bq) {
  bv = -1.f;
  bl = INT_MAX;
  bq = 0;
#pragma unroll
  for (int q = 0; q < LPT; ++q) {
    const float v = fabsf(x[q][j]);
    if ((live >> q & 1u) && v > bv) { bv = v; bl = q * NT + threadIdx.x; bq = q; }
  }
}

// The better of two candidates (|value|, lane, warp) in better()'s order.
__device__ __forceinline__ void pick(float& v, int& l, int& w, float v2, int l2, int w2) {
  if (better(v2, l2, v, l)) { v = v2; l = l2; w = w2; }
}

// The column loop of one 32-row block in its owner: Xb its rows in shared
// memory (row stride n), outb in the output, pivg and pvs its 32 pivots in
// the output and in shared memory, pivcol each lane's pivot column (n:
// active).  One __syncthreads a column.  The column's dependent chain is
// written out in the order it runs: the warp's argmax, the candidate's
// column published (16-byte stores), the barrier, the warps' candidates
// compared as a tournament of depth 3, the pivot's column read (16-byte
// loads), the multipliers, row j + 1 updated and the next column's argmax
// begun before rows j + 2 … 31 are updated, so that the reduction's latency
// hides behind them.
template <int LPT>
__device__ __forceinline__ void column_loop(float* Xb, float* outb, int64_t* pivg, int* pvs,
                                            const int* pivcol, float* slots, int n) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float x[LPT][IB];
  unsigned live = 0;
#pragma unroll
  for (int q = 0; q < LPT; ++q) {
    const int l = q * NT + tid;
    if (l < n && pivcol[l] == n) live |= 1u << q;
#pragma unroll
    for (int i = 0; i < IB; ++i) x[q][i] = l < n ? Xb[(int64_t)i * n + l] : 0.f;
  }
  float bv;
  int bl, bq;
  thread_best(x, live, 0, bv, bl, bq);
  float wv = bv;
  int wl = bl;
  warp_best_redux(wv, wl);
#pragma unroll
  for (int jj = 0; jj < IB; ++jj) {
    float* set = slots + (jj & 1) * NWARP * SLOT;
    float* sl = set + warp * SLOT;
    if (wv >= 0.f) {
      if (wl == bl) {  // this thread holds the warp's candidate: rows jj … 31
#pragma unroll
        for (int i = jj & ~3; i < IB; i += 4) {
          float v[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            v[c] = x[0][i + c];
#pragma unroll
            for (int q = 1; q < LPT; ++q)
              if (bq == q) v[c] = x[q][i + c];
          }
          *reinterpret_cast<float4*>(sl + i) = make_float4(v[0], v[1], v[2], v[3]);
        }
        *reinterpret_cast<float2*>(sl + IB) = make_float2(wv, __int_as_float(wl));
      }
    } else if (lane == 0) {
      *reinterpret_cast<float2*>(sl + IB) = make_float2(-1.f, __int_as_float(INT_MAX));
    }
    __syncthreads();  // the column's one block barrier
    float cv[NWARP];
    int cl[NWARP], cw[NWARP];
#pragma unroll
    for (int w2 = 0; w2 < NWARP; ++w2) {
      const float2 c = *reinterpret_cast<const float2*>(set + w2 * SLOT + IB);
      cv[w2] = c.x;
      cl[w2] = __float_as_int(c.y);
      cw[w2] = w2;
    }
#pragma unroll
    for (int h = 1; h < NWARP; h *= 2)
#pragma unroll
      for (int w2 = 0; w2 < NWARP; w2 += 2 * h) pick(cv[w2], cl[w2], cw[w2], cv[w2 + h], cl[w2 + h], cw[w2 + h]);
    const int p = cv[0] >= 0.f ? cl[0] : n;  // n: no candidate (a NaN column)
    const float* ps = set + cw[0] * SLOT;
    float pc[IB];
#pragma unroll
    for (int i = jj & ~3; i < IB; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(ps + i);
      pc[i] = t.x, pc[i + 1] = t.y, pc[i + 2] = t.z, pc[i + 3] = t.w;
    }
    const bool has = p < n;
    const float pval = has ? pc[jj] : 0.f;
    const float safe = pval == 0.f ? 1.f : pval;
    if (tid == 0) {
      pvs[jj] = p;
      pivg[jj] = (int64_t)p;
    }
#pragma unroll
    for (int q = 0; q < LPT; ++q) {
      if (q * NT + tid == p) live &= ~(1u << q);
      else if (live >> q & 1u) x[q][jj] = x[q][jj] / safe;
    }
    // the lanes the rank-1 update reaches (none without a pivot)
    const unsigned upd = has ? live : 0u;
    if (jj + 1 < IB) {
#pragma unroll
      for (int q = 0; q < LPT; ++q)
        if (upd >> q & 1u) x[q][jj + 1] = __fsub_rn(x[q][jj + 1], __fmul_rn(pc[jj + 1], x[q][jj]));
      thread_best(x, live, jj + 1, bv, bl, bq);
      wv = bv;
      wl = bl;
      warp_best_redux(wv, wl);
    }
#pragma unroll
    for (int i = jj + 2; i < IB; ++i)
#pragma unroll
      for (int q = 0; q < LPT; ++q)
        if (upd >> q & 1u) x[q][i] = __fsub_rn(x[q][i], __fmul_rn(pc[i], x[q][jj]));
    BATCHED_MARK(M_COLUMN);
  }
  // the row block is final: into the owner's shared rows and the output
#pragma unroll
  for (int q = 0; q < LPT; ++q) {
    const int l = q * NT + tid;
    if (l < n) {
#pragma unroll
      for (int i = 0; i < IB; ++i) {
        Xb[(int64_t)i * n + l] = x[q][i];
        outb[(int64_t)i * n + l] = x[q][i];
      }
    }
  }
}

// The rank-32 update of a chunk of nr rows (Xc, row stride n; their U12 in
// U): live lanes lose Σ_jj U12[jj]·mult[jj], an fmaf chain over ascending
// jj; the row block's pivot lanes take their U12 rows; lanes pivoted before
// it stay.  A thread a lane: its 32 multipliers (Mo, in the owner's shared
// memory, read over distributed shared memory unless this block is the
// owner) read once and held in registers, the rows eight at a time, so
// that each multiplier crosses the cluster once a chunk.  The owner takes
// the same form: 8 × 8 tiles from its own shared memory timed 1.6–6 %
// slower on an H100 (the U12 loads, not the products, set the pace).
template <int LPT>
__device__ __forceinline__ void update_lanes(float* Xc, const float* U, const float* Mo,
                                             const int* pivcol, int n, int b0, int nr) {
  const int b1 = b0 + IB;
  for (int q = 0; q < LPT; ++q) {
    const int l = q * NT + threadIdx.x;
    if (l >= n) break;
    const int pc = pivcol[l];
    if (pc < b0) continue;
    float* xl = Xc + l;
    if (pc < b1) {
      for (int i = 0; i < nr; ++i) xl[(int64_t)i * n] = U[(pc - b0) * UCS + i];
      continue;
    }
    float mv[IB];
#pragma unroll
    for (int jj = 0; jj < IB; ++jj) mv[jj] = Mo[(int64_t)jj * n + l];
    for (int i = 0; i < nr; i += 8) {
      float a[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) a[k] = xl[(int64_t)(i + k) * n];
      float4 u0 = *reinterpret_cast<const float4*>(U + i);
      float4 u1 = *reinterpret_cast<const float4*>(U + i + 4);
#pragma unroll
      for (int jj = 0; jj < IB; ++jj) {
        const float4 c0 = u0, c1 = u1;  // jj + 1's are loaded while jj's run
        if (jj + 1 < IB) {
          u0 = *reinterpret_cast<const float4*>(U + (jj + 1) * UCS + i);
          u1 = *reinterpret_cast<const float4*>(U + (jj + 1) * UCS + i + 4);
        }
        a[0] = fmaf(-c0.x, mv[jj], a[0]);
        a[1] = fmaf(-c0.y, mv[jj], a[1]);
        a[2] = fmaf(-c0.z, mv[jj], a[2]);
        a[3] = fmaf(-c0.w, mv[jj], a[3]);
        a[4] = fmaf(-c1.x, mv[jj], a[4]);
        a[5] = fmaf(-c1.y, mv[jj], a[5]);
        a[6] = fmaf(-c1.z, mv[jj], a[6]);
        a[7] = fmaf(-c1.w, mv[jj], a[7]);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) xl[(int64_t)(i + k) * n] = a[k];
    }
  }
}

// The end of row block b in a block with rows past it: the block's pivots
// (pvb) and pivot columns, L11, then by chunks of UC rows each row's U12
// and the rank-32 update.  Mo: the row block in its owner's shared memory
// (generic: distributed shared memory unless this block is the owner).
template <int LPT>
__device__ __forceinline__ void block_end(float* X, float* U, float* L11, int* pivcol, int* pvb,
                                          const float* Mo, const int* pvo, int n, int b0,
                                          int row0, int row1) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, b1 = b0 + IB;
  if (tid < IB) {
    const int p = pvo[tid];
    pvb[tid] = p;
    if (p < n) pivcol[p] = b0 + tid;
  }
  __syncthreads();
  // L11[jj][kk] = Mo[kk][p_jj], kk < jj: pivot lanes keep the values they
  // had when they were chosen
  for (int e = tid; e < IB * IB; e += NT) {
    const int jj = e >> 5, kk = e & 31, p = pvb[jj];
    L11[jj * (IB + 1) + kk] = (kk < jj && p < n) ? Mo[(int64_t)kk * n + p] : 0.f;
  }
  for (int c0 = max(b1, row0); c0 < row1; c0 += UC) {
    const int nr = min(UC, row1 - c0);
    float* Xc = X + (int64_t)(c0 - row0) * n;
    {  // the pivot lanes' entries of the chunk, a warp a row, a lane a pivot
      const int p = pvb[lane];
      for (int i = warp; i < nr; i += NWARP) U[lane * UCS + i] = p < n ? Xc[(int64_t)i * n + p] : 0.f;
    }
    __syncthreads();
    if (tid < 4 * nr) {  // U12 by forward substitution, four threads a row
      // thread s of a row holds u[jj] for jj ≡ s (mod 4); u[kk] reaches the
      // other three by a shuffle once it is final (nr is a multiple of 32,
      // so whole warps take part)
      const int i = tid >> 2, s = tid & 3;
      float u[IB / 4];
#pragma unroll
      for (int m = 0; m < IB / 4; ++m) u[m] = U[(s + 4 * m) * UCS + i];
#pragma unroll
      for (int kk = 0; kk < IB - 1; ++kk) {
        const float uk = __shfl_sync(0xffffffffu, u[kk >> 2], (lane & ~3) | (kk & 3));
#pragma unroll
        for (int m = kk >> 2; m < IB / 4; ++m) {
          const int jj = s + 4 * m;
          if (jj > kk) u[m] = fmaf(-L11[jj * (IB + 1) + kk], uk, u[m]);
        }
      }
#pragma unroll
      for (int m = 0; m < IB / 4; ++m) U[(s + 4 * m) * UCS + i] = pvb[s + 4 * m] < n ? u[m] : 0.f;
    }
    __syncthreads();
    BATCHED_MARK(M_U12);
    update_lanes<LPT>(Xc, U, Mo, pivcol, n, b0, nr);
    __syncthreads();  // U is rewritten by the next chunk
    BATCHED_MARK(M_UPDATED);
  }
}

// One problem on one cluster: block r owns row blocks [r·R, r·R + R).
template <int LPT>
__global__ void __launch_bounds__(NT, 1)
getrf_batched_cluster_kernel(const float* in, float* out, int64_t* piv, int n, int R) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int C = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  const int nt = n / IB, prob = blockIdx.x / C;
  const int row0 = r * R * IB, row1 = min(nt, (r + 1) * R) * IB;  // my rows
  const int64_t nn = (int64_t)n * n;
  in += prob * nn;
  out += prob * nn;
  piv += (int64_t)prob * n;

  float* X = sm;                             // my rows: X[(i − row0)·n + l]
  float* U = X + (int64_t)R * IB * n;        // a chunk's U12: U[jj·UCS + i]
  float* L11 = U + IB * UCS;                 // the row block's L11, row stride 33
  int* pivcol = reinterpret_cast<int*>(L11 + IB * (IB + 1));  // n: still active
  int* pvs = pivcol + n;                     // pvs[j]: the pivot of my column j
  float* slots = reinterpret_cast<float*>(pvs + n);
  int* pvb = reinterpret_cast<int*>(slots + 2 * NWARP * SLOT);

  BATCHED_MARK(M_START);
  {  // my rows in, 16 bytes a copy
    const float* src = in + (int64_t)row0 * n;
    const int64_t nv = (int64_t)(row1 - row0) * n / 4;
    for (int64_t e = tid; e < nv; e += NT) cp_async16(X + 4 * e, src + 4 * e);
  }
  for (int l = tid; l < n; l += NT) pivcol[l] = n;
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  BATCHED_MARK(M_LOADED);

  for (int b = 0; b < nt; ++b) {
    const int owner = b / R, b0 = b * IB;
    if (owner == r) {
      column_loop<LPT>(X + (int64_t)(b0 - row0) * n, out + (int64_t)b0 * n, piv + b0, pvs + b0,
                       pivcol, slots, n);
      BATCHED_MARK(M_STORED);
      cluster_arrive();  // release: the row block and its pivots
    } else {
      cluster_arrive_relaxed();
    }
    cluster_wait();  // the row block's one cluster barrier
    BATCHED_MARK(M_WAITED);
    if (row1 > b0 + IB) {
      const float* Xo = cluster.map_shared_rank(X, owner);
      const int* pvo = cluster.map_shared_rank(pvs, owner);
      block_end<LPT>(X, U, L11, pivcol, pvb, Xo + (int64_t)(b0 - owner * R * IB) * n, pvo + b0,
                     n, b0, row0, row1);
    }
  }
  BATCHED_MARK(M_END);
}

const void* cluster_kernel(int lpt) {
  switch (lpt) {
    case 1: return (const void*)getrf_batched_cluster_kernel<1>;
    case 2: return (const void*)getrf_batched_cluster_kernel<2>;
    case 3: return (const void*)getrf_batched_cluster_kernel<3>;
    default: return (const void*)getrf_batched_cluster_kernel<4>;
  }
}

// ---------------------------------------------------------------------------
// The l2 route: one block a problem, the problem in device memory (the
// kernel before the smem route, unchanged)
// ---------------------------------------------------------------------------

// Dynamic shared memory of one block, in floats (smem.getrf_batched_bytes / 4,
// checked at load through the plan's l2 route).
__host__ __device__ inline int64_t smem_floats(int n) {
  return 2 * (int64_t)IB * n + 2 * (int64_t)n + IB + 2 * NWARP + 4;
}

__global__ void __launch_bounds__(NT)
getrf_batched_kernel(const float* in, float* out, int64_t* piv, int n) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int64_t nn = (int64_t)n * n;
  const float* A = in + blockIdx.x * nn;
  float* X = out + blockIdx.x * nn;
  int64_t* pv = piv + (int64_t)blockIdx.x * n;

  float* S = smem;                             // S[jj·n + l]: rows [b0, b1)
  float* U = S + (int64_t)IB * n;              // U[jj·n + i]: U12, rows i ≥ b1
  float* act = U + (int64_t)IB * n;            // act[l] > 0: lane l active
  int* blk = reinterpret_cast<int*>(act + n);  // jj if pivoted in this block
  int* pl = blk + n;                           // pl[jj]: pivot of column b0 + jj
  float* red_v = reinterpret_cast<float*>(pl + IB);
  int* red_l = reinterpret_cast<int*>(red_v + NWARP);
  int* s_p = red_l + NWARP;

  if (A != X)
    for (int64_t e = tid; e < nn; e += NT) X[e] = A[e];
  for (int l = tid; l < n; l += NT) {
    act[l] = 1.f;
    blk[l] = -1;
  }
  __syncthreads();

  for (int b0 = 0; b0 < n; b0 += IB) {
    const int b1 = b0 + IB;
    for (int e = tid; e < IB * n; e += NT) S[e] = X[(int64_t)b0 * n + e];
    __syncthreads();
    for (int jj = 0; jj < IB; ++jj) {
      // masked argmax over the active lanes (the ascending scan keeps the
      // lowest lane among equal maxima)
      float bv = -1.f;
      int bl = INT_MAX, bg = 0;
      for (int l = tid; l < n; l += NT) {
        if (act[l] > 0.f) {
          const float v = fabsf(S[jj * n + l]);
          if (v > bv) { bv = v; bl = l; }
        }
      }
      warp_best(bv, bl, bg);
      if ((tid & 31) == 0) { red_v[tid >> 5] = bv; red_l[tid >> 5] = bl; }
      __syncthreads();
      if (tid < 32) {
        bv = tid < NWARP ? red_v[tid] : -1.f;
        bl = tid < NWARP ? red_l[tid] : INT_MAX;
        warp_best(bv, bl, bg);
        if (tid == 0) {
          const int p = bv >= 0.f ? bl : n;    // n: no candidate (NaN column)
          *s_p = p;
          pl[jj] = p;
          pv[b0 + jj] = (int64_t)p;
        }
      }
      __syncthreads();
      // row jj takes the multipliers, rows (jj, IB) the rank-1 update
      // (unfused, as the plain version)
      const int p = *s_p;
      const bool has = p < n;
      const float pval = has ? S[jj * n + p] : 0.f;
      const float safe = pval == 0.f ? 1.f : pval;
      for (int l = tid; l < n; l += NT) {
        if (l == p) { act[l] = 0.f; blk[l] = jj; continue; }
        if (!(act[l] > 0.f)) continue;
        const float mult = S[jj * n + l] / safe;
        S[jj * n + l] = mult;
        if (has)
          for (int i = jj + 1; i < IB; ++i)
            S[i * n + l] = __fsub_rn(S[i * n + l], __fmul_rn(S[i * n + p], mult));
      }
      __syncthreads();
    }

    for (int e = tid; e < IB * n; e += NT) X[(int64_t)b0 * n + e] = S[e];
    if (b1 < n) {
      // U12 of the rows past the block by forward substitution with the
      // unit-lower L11[jj][kk] = S[kk·n + pl[jj]] (pivot lanes keep the
      // values they had when they were chosen)
      for (int i = b1 + tid; i < n; i += NT) {
        for (int jj = 0; jj < IB; ++jj) {
          const int p = pl[jj];
          float u = 0.f;
          if (p < n) {
            u = X[(int64_t)i * n + p];
            for (int kk = 0; kk < jj; ++kk) u = fmaf(-S[kk * n + p], U[kk * n + i], u);
          }
          U[jj * n + i] = u;
        }
      }
      __syncthreads();
      // delayed rank-32 update of rows [b1, n): each thread a 4-row ×
      // 4-lane tile (lanes tl + k·ntl, so neighbouring threads read
      // neighbouring lanes); n % 32 == 0, so no tile is ragged
      const int nti = (n - b1) / 4, ntl = n / 4;
      for (int t = tid; t < nti * ntl; t += NT) {
        const int i0 = b1 + (t / ntl) * 4, tl = t % ntl;
        int ln[4];
        bool live[4];
        float acc[4][4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          ln[k] = tl + k * ntl;
          live[k] = act[ln[k]] > 0.f;
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[r][k] = live[k] ? X[(int64_t)(i0 + r) * n + ln[k]] : 0.f;
        }
        for (int jj = 0; jj < IB; ++jj) {
          float mv[4], uv[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) mv[k] = live[k] ? S[jj * n + ln[k]] : 0.f;
#pragma unroll
          for (int r = 0; r < 4; ++r) uv[r] = U[jj * n + i0 + r];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[r][k] = fmaf(-uv[r], mv[k], acc[r][k]);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int bj = blk[ln[k]];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            float* x = &X[(int64_t)(i0 + r) * n + ln[k]];
            if (live[k]) *x = acc[r][k];
            else if (bj >= 0) *x = U[bj * n + i0 + r];
          }
        }
      }
    }
    __syncthreads();   // every tile has read blk before it is reset
    for (int l = tid; l < n; l += NT) blk[l] = -1;
    __syncthreads();
  }
}

// The dynamic shared memory a block may take on the current device, the
// kernel's limit raised to it on the first call there and cached after, so
// a launch costs no attribute query.  Two threads racing the first call
// set the same limit.
constexpr int MAX_DEVICES = 64;
std::atomic<int> dyn_max_of[MAX_DEVICES];   // 0: not set up yet

cudaError_t dyn_smem_max(int* dyn_max) {
  int dev = 0, optin = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev < MAX_DEVICES && (*dyn_max = dyn_max_of[dev].load()) > 0)
    return cudaSuccess;
  if ((err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) != cudaSuccess)
    return err;
  cudaFuncAttributes fa;
  if ((err = cudaFuncGetAttributes(&fa, getrf_batched_kernel)) != cudaSuccess)
    return err;
  *dyn_max = optin - (int)fa.sharedSizeBytes;
  if ((err = cudaFuncSetAttribute(getrf_batched_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  *dyn_max)) != cudaSuccess)
    return err;
  if (dev < MAX_DEVICES) dyn_max_of[dev].store(*dyn_max);
  return cudaSuccess;
}


// The cluster kernels' attributes (non-portable clusters, dynamic shared
// memory up to the device's opt-in limit less their static shared memory),
// set on the first launch of each
// on a device and cached after, so a launch costs no attribute call.  Two
// threads racing the first call set the same attributes.
std::atomic<int> cluster_optin_of[MAX_LPT][MAX_DEVICES];   // 0: not set up yet

cudaError_t cluster_limit(int lpt, int* optin) {
  int dev = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  std::atomic<int>* slot = dev < MAX_DEVICES ? &cluster_optin_of[lpt - 1][dev] : nullptr;
  if (slot && (*optin = slot->load()) > 0) return cudaSuccess;
  if ((err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return err;
  const void* k = cluster_kernel(lpt);
  cudaFuncAttributes fa;
  if ((err = cudaFuncGetAttributes(&fa, k)) != cudaSuccess) return err;
  *optin -= (int)fa.sharedSizeBytes;
  if ((err = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
      cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, *optin)) !=
      cudaSuccess)
    return err;
  if (slot) slot->store(*optin);
  return cudaSuccess;
}

enum Route { SMEM = 0, L2 = 1 };

}  // namespace

// The plan at n: the route (0 smem, 1 l2), the cluster (the smallest C
// ≤ 16 whose blocks' shares of ⌈n/32 / C⌉ row blocks fit; 1 on the l2
// route) and one block's dynamic shared memory in bytes.  ops/smem.py
// getrf_batched_plan is checked equal to it at every n on the 32 grid to
// 1024 when the library is loaded.
extern "C" int slate_getrf_batched_plan(int n, int* route, int* cluster, int* bytes) {
  if (n < IB || n % IB != 0) return (int)cudaErrorInvalidValue;
  const int nt = n / IB;
  int rmax = 0;  // the most row blocks a block can hold
  while (rmax < nt && 4 * cluster_floats(n, rmax + 1) <= SMEM_MAX) ++rmax;
  const int C = rmax ? (nt + rmax - 1) / rmax : MAX_CLUSTER + 1;
  if (C <= MAX_CLUSTER) {
    *route = SMEM;
    *cluster = C;
    *bytes = (int)(4 * cluster_floats(n, (nt + C - 1) / C));
  } else {
    *route = L2;
    *cluster = 1;
    *bytes = (int)(4 * smem_floats(n));
  }
  return 0;
}

// in, out: (batch, n, n) contiguous, each problem transposed (lane-major);
// out may equal in.  piv: (batch, n) int64.  n a multiple of 32 whose
// problem fits one of the routes (n ≤ 864 on the H100).
extern "C" int slate_getrf_batched_f32(const float* in, float* out,
                                       int64_t* piv, int batch, int n,
                                       cudaStream_t stream) {
  int route = 0, C = 1, bytes = 0;
  if (batch < 1 || slate_getrf_batched_plan(n, &route, &C, &bytes) != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (route == SMEM) {
    const int lpt = (n + NT - 1) / NT, R = (n / IB + C - 1) / C;
    int optin = 0;
    if (lpt > MAX_LPT) return (int)cudaErrorInvalidValue;
    if ((err = cluster_limit(lpt, &optin)) != cudaSuccess) return (int)err;
    if (bytes > optin) return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(batch * C);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    void* args[] = {(void*)&in, (void*)&out, (void*)&piv, (void*)&n, (void*)&R};
    if ((err = cudaLaunchKernelExC(&cfg, cluster_kernel(lpt), args)) != cudaSuccess)
      return (int)err;
    return (int)cudaGetLastError();
  }
  int dyn_max = 0;
  if ((err = dyn_smem_max(&dyn_max)) != cudaSuccess) return (int)err;
  if (bytes > dyn_max) return (int)cudaErrorInvalidValue;
  getrf_batched_kernel<<<batch, NT, (size_t)bytes, stream>>>(in, out, piv, n);
  return (int)cudaGetLastError();
}
