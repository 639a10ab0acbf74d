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
// of A) and piv, the n pivot lanes in factorization order.  This is the
// elimination of lu_panel.cuh with the panel width equal to the problem;
// the per-column argmax (warp_best), the unfused in-block rank-1 update,
// the U12 substitution and the 4 × 4-tiled delayed update repeat its
// arithmetic step for step.
//
// What bounds it on an H100: at B = 64, n = 256 the batch moves 33.6 MB
// and does 7.2e8 FLOP, ~0.01 ms at the card's rates, but each problem is a
// chain of n dependent column steps, each a masked argmax over n lanes.
// The TPU kernel keeps whole problems in VMEM; one fp32 problem at
// n = 256 is 256 KB, more than a block's 227 KB.  So ONE BLOCK OWNS ONE
// PROBLEM, and the argmax is a block reduction: no grid-wide barrier, no
// cooperative launch (the LU panels' ~4.7 µs per column barrier does not
// arise).  The problem lives in its output buffer in device memory, which
// L2 holds (16 MB at B = 64); the current 32-row block and the block's
// U12 rows stay in shared memory ((2·32·n + 2n + 52)·4 bytes, all
// dynamic), so the column loop touches only shared memory and the rows
// past the block are read and written once per block.  The shared memory
// bounds n: n ≤ 864 (ops/smem.py repeats the same formula as its gate, and
// ops/kernels.py checks the two agree when it loads this library).

#include <atomic>

#include "lu_panel.cuh"

namespace {

using lu_panel::NT;
using lu_panel::NWARP;
using lu_panel::warp_best;

constexpr int IB = 32;

// Dynamic shared memory of one block, in floats (smem.getrf_batched_bytes / 4,
// checked at load through slate_getrf_batched_smem_bytes).
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

}  // namespace

// Dynamic shared memory of one block at n, in bytes: ops/smem.py's gate
// (getrf_batched_bytes) is checked against it when the library is loaded.
extern "C" int64_t slate_getrf_batched_smem_bytes(int n) {
  return 4 * smem_floats(n);
}

// in, out: (batch, n, n) contiguous, each problem transposed (lane-major);
// out may equal in.  piv: (batch, n) int64.  n a multiple of 32 whose
// shared memory fits one block.
extern "C" int slate_getrf_batched_f32(const float* in, float* out,
                                       int64_t* piv, int batch, int n,
                                       cudaStream_t stream) {
  if (batch < 1 || n < IB || n % IB != 0) return (int)cudaErrorInvalidValue;
  int dyn_max = 0;
  cudaError_t err;
  if ((err = dyn_smem_max(&dyn_max)) != cudaSuccess) return (int)err;
  const int64_t bytes = 4 * smem_floats(n);
  if (bytes > dyn_max) return (int)cudaErrorInvalidValue;
  getrf_batched_kernel<<<batch, NT, (size_t)bytes, stream>>>(in, out, piv, n);
  return (int)cudaGetLastError();
}
