// Device code shared by the partial-pivot LU panel kernels,
// getrf_panel_linv.cu and getrf_panel_fused.cu (the step and full kernels'
// panel, lu_full.cuh, is this one over a list of lanes, and their launch
// and grid plan are this file's), as the Pallas kernels share
// _factor_block_lane_major / _trtri_unblocked / _block_inv_doubling
// (slate_tpu/ops/pallas_kernels.py:315-363, :690-771).
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
// (i > j), unit diagonal.
//
// Execution model.  On the TPU the whole panel sits in one core's VMEM;
// the (512, 8192) fp32 panel is 16 MB, far past one SM's 227 KB, so here
// ONE COOPERATIVE GRID of co-resident blocks splits the lanes: block g
// owns lanes [g·chunk, (g+1)·chunk) and keeps all w rows of them in
// shared memory from the first column to the last (one read and one
// write of the panel in all).  Per column:
//   1. each block finds its own masked argmax (ties: lowest lane);
//   2. it publishes (|value|, lane) and the candidate lane's whole column
//      (w values) to a double-buffered global array;
//   3. grid.sync() — the only grid-wide barrier of the column;
//   4. every block reduces the G candidates identically, copies the
//      winner's column into shared memory, and updates its own lanes
//      in the current ib-row block.
// Rows past the current ib block are updated once per block (delayed,
// right-looking): every block solves U12 = L11⁻¹·(pivot rows) redundantly
// from the ib published pivot columns (a forward substitution on ib
// rows) and applies the rank-ib update to its own lanes from registers;
// lanes pivoted in the block take their U12 rows.  The block row of
// linv is built at the same moment from the same published columns:
// X[b, b] by forward substitution, X[b, :b0] = -X[b, b]·L[b, :b0]·X[:b0, :b0]
// for the linv columns a block owns (column c belongs to block c mod G).
// So the grid needs one barrier per column and no second pass.
//
// Cross-block data goes through L2 with .cg loads and stores (no L1
// caching of anything another block wrote).

#pragma once

#include <algorithm>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace lu_panel {

namespace cg = cooperative_groups;

constexpr int NT = 256;          // threads of one block
constexpr int NWARP = NT / 32;
constexpr int MIN_LANES = 32;    // fewest lanes a block takes
constexpr int MAX_IB = 32;       // widest inner block
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const float* in;     // panel row i, lane l at in[i·ld_in + l]
  int64_t ld_in;
  float* out;          // may equal in (getrf_panel_fused's in-place carry)
  int64_t ld_out;
  const float* act_in; // (m) active mask, > 0 means active
  float* act_out;      // (m)
  int64_t* piv;        // (w) pivot lanes in factorization order
  float* linv;         // (w, w) row-major L11⁻¹
  float* cand;         // [2][G][w] published candidate columns
  float* cval;         // [2][G] candidate |value| (-1: no candidate)
  int* clane;          // [2][G] candidate lane (m: none)
  int m, w, ib, G;
};

__host__ __device__ inline int ceildiv(int a, int b) { return (a + b - 1) / b; }

// Dynamic shared memory of one block, in floats (smem.lu_panel_bytes / 4).
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

// The whole panel by every block of the cooperative grid, from `smem`
// (the block's dynamic shared memory, smem_floats(m, w, ib, G) floats).
// Ends after the write-back of the block's lanes, its act lanes and its
// linv columns, with no grid barrier: a caller that reads them from
// another block syncs the grid first.
__device__ void panel_phase(const Params& p, float* smem) {
  __shared__ float red_v[NWARP];
  __shared__ int red_l[NWARP];
  __shared__ int s_lc, s_p, s_g;

  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, g = blockIdx.x, G = p.G;
  const int m = p.m, w = p.w, ib = p.ib;
  const int cs = ceildiv(m, G), nown = ceildiv(w, G);
  const int lane0 = g * cs;
  const int nl = max(0, min(cs, m - lane0));   // lanes this block owns

  float* S = smem;                             // S[i·cs + l]: own lanes
  float* P = S + (int64_t)w * cs;              // P[jj·w + i]: pivot columns
  float* Xo = P + (int64_t)ib * w;             // Xo[q·w + r]: owned linv cols
  float* Xbb = Xo + (int64_t)nown * w;         // Xbb[jj·ib + kk]
  float* T = Xbb + ib * ib;                    // T[jj·nown + q]
  float* act = T + ib * nown;                  // act[l]
  int* blk = reinterpret_cast<int*>(act + cs); // jj if pivoted in this block

  for (int64_t e = tid; e < (int64_t)w * cs; e += NT) {
    const int i = (int)(e / cs), l = (int)(e % cs);
    S[e] = l < nl ? p.in[(int64_t)i * p.ld_in + lane0 + l] : 0.f;
  }
  for (int l = tid; l < cs; l += NT) {
    act[l] = l < nl ? p.act_in[lane0 + l] : 0.f;
    blk[l] = -1;
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
        if (act[l] > 0.f) {
          const float v = fabsf(S[(int64_t)j * cs + l]);
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
          const bool has = bv >= 0.f;
          s_lc = has ? bl : -1;
          __stcg(&p.cval[buf * G + g], has ? bv : -1.f);
          __stcg(&p.clane[buf * G + g], has ? lane0 + bl : m);
        }
      }
      __syncthreads();
      // 2. publish the candidate lane's column
      const int lc = s_lc;
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
          if (ov >= 0.f && better(ov, ol, v, l)) { v = ov; l = ol; q = r; }
        }
        warp_best(v, l, q);
        if (tid == 0) {
          s_p = v >= 0.f ? l : m;
          s_g = v >= 0.f ? q : -1;
          if (g == 0) p.piv[j] = (int64_t)s_p;
        }
      }
      __syncthreads();
      const int pl = s_p, pg = s_g;
      float* pc = P + (int64_t)jj * w;
      const float* src = p.cand + ((int64_t)buf * G + (pg < 0 ? 0 : pg)) * w;
      for (int i = tid; i < w; i += NT) pc[i] = pg >= 0 ? __ldcg(&src[i]) : 0.f;
      __syncthreads();
      // in-block update of this block's lanes: row j takes the multipliers,
      // rows (j, b1) the rank-1 update (unfused, as the plain version)
      const float pval = pc[j];
      const float safe = pval == 0.f ? 1.f : pval;
      const int lp = pl - lane0;
      for (int l = tid; l < nl; l += NT) {
        if (l == lp) { act[l] = 0.f; blk[l] = jj; continue; }
        if (!(act[l] > 0.f)) continue;
        const float mult = S[(int64_t)j * cs + l] / safe;
        S[(int64_t)j * cs + l] = mult;
        for (int i = j + 1; i < b1; ++i)
          S[(int64_t)i * cs + l] = __fsub_rn(S[(int64_t)i * cs + l],
                                             __fmul_rn(pc[i], mult));
      }
      __syncthreads();
    }

    // ---- block end: U12 of the rows past the block, by forward
    //      substitution with the unit-lower L11 of the block (redundant in
    //      every block: ib²/2 · (w - b1) FMA)
    for (int i = b1 + tid; i < w; i += NT)
      for (int jj = 1; jj < ib; ++jj) {
        float u = P[(int64_t)jj * w + i];
        for (int kk = 0; kk < jj; ++kk)
          u = fmaf(-P[(int64_t)jj * w + b0 + kk], P[(int64_t)kk * w + i], u);
        P[(int64_t)jj * w + i] = u;
      }
    // the block inverse X[b, b] (warp 0, lane c owns column c)
    if (tid < 32 && tid < ib) {
      const int c = tid;
      for (int jj = 0; jj < ib; ++jj) {
        float acc = jj == c ? 1.f : 0.f;
        for (int kk = c; kk < jj; ++kk)
          acc = fmaf(-P[(int64_t)jj * w + b0 + kk], Xbb[kk * ib + c], acc);
        Xbb[jj * ib + c] = jj >= c ? acc : 0.f;
      }
    }
    __syncthreads();
    // delayed rank-ib update of this block's lanes, rows [b1, w): each
    // thread a 4-row × 4-lane tile (lanes tl + k·ntl, so neighbouring
    // threads read neighbouring lanes)
    {
      const int nr = w - b1;
      const int nti = ceildiv(nr, 4), ntl = ceildiv(nl, 4);
      for (int t = tid; t < nti * ntl; t += NT) {
        const int i0 = b1 + (t / ntl) * 4, tl = t % ntl;
        int ln[4];
        bool live[4];
        float acc[4][4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          ln[k] = tl + k * ntl;
          live[k] = ln[k] < nl && act[ln[k]] > 0.f;
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[r][k] = (live[k] && i0 + r < w) ? S[(int64_t)(i0 + r) * cs + ln[k]] : 0.f;
        }
        for (int jj = 0; jj < ib; ++jj) {
          float mv[4], uv[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            mv[k] = live[k] ? S[(int64_t)(b0 + jj) * cs + ln[k]] : 0.f;
#pragma unroll
          for (int r = 0; r < 4; ++r)
            uv[r] = i0 + r < w ? P[(int64_t)jj * w + i0 + r] : 0.f;
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[r][k] = fmaf(-uv[r], mv[k], acc[r][k]);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (ln[k] >= nl) continue;
          const int bj = blk[ln[k]];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if (i0 + r >= w) continue;
            float* s = &S[(int64_t)(i0 + r) * cs + ln[k]];
            if (live[k]) *s = acc[r][k];
            else if (bj >= 0) *s = P[(int64_t)bj * w + i0 + r];
          }
        }
      }
    }
    // linv block row b for the owned columns c = g + q·G < b1:
    // T = L[b, c:b0]·X[c:b0, c], then X[b, c] = -X[b, b]·T
    for (int e = tid; e < ib * nown; e += NT) {
      const int jj = e / nown, q = e % nown;
      const int c = g + q * G;
      float acc = 0.f;
      if (c < b0)
        for (int k = c; k < b0; ++k)
          acc = fmaf(P[(int64_t)jj * w + k], Xo[(int64_t)q * w + k], acc);
      T[jj * nown + q] = acc;
    }
    __syncthreads();
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
    for (int l = tid; l < nl; l += NT) blk[l] = -1;
    __syncthreads();
  }

  for (int64_t e = tid; e < (int64_t)w * cs; e += NT) {
    const int i = (int)(e / cs), l = (int)(e % cs);
    if (l < nl) p.out[(int64_t)i * p.ld_out + lane0 + l] = S[e];
  }
  for (int l = tid; l < nl; l += NT) p.act_out[lane0 + l] = act[l];
  for (int64_t e = tid; e < (int64_t)nown * w; e += NT) {
    const int q = (int)(e / w), r = (int)(e % w);
    const int c = g + q * G;
    if (c < w) p.linv[(int64_t)r * w + c] = Xo[e];
  }
}

__global__ void __launch_bounds__(NT) lu_panel_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  panel_phase(p, smem);
}

// The dynamic shared memory of one block on a grid of G: the panel's
// smem_floats, or `min_floats` for a kernel that goes on to phases of its
// own from the same memory (lu_full.cuh), whichever is larger.
inline int64_t dyn_floats(int m, int w, int ib, int G, int64_t min_floats) {
  return std::max(smem_floats(m, w, ib, G), min_floats);
}

// The grid `kernel` (blocks of NT threads running the panel phase) is
// launched on: one block per SM first; if its share of shared memory lets
// more blocks share an SM, as many as are co-resident, never fewer than
// MIN_LANES lanes a block.  Returns a CUDA error code.
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

// The panel kernel alone (getrf_panel_linv.cu, getrf_panel_fused.cu).
inline int plan_grid(int m, int w, int ib, int* G_out) {
  return plan_grid_for((const void*)lu_panel_kernel, m, w, ib, 0, G_out);
}

inline int launch(Params p, cudaStream_t stream) {
  void* args[] = {&p};
  return launch_for((const void*)lu_panel_kernel, args, p.m, p.w, p.ib, p.G, 0,
                    stream);
}

}  // namespace lu_panel
