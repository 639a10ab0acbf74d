// Device code shared by the bulge-chase kernels (hb2st_wavefront.cu and
// tb2bd_wavefront.cu): the block-level task arithmetic of one chase
// window, worked directly on band storage in global memory, and the
// cooperative grid that runs the wavefront.
//
// Why global memory.  The TPU kernel (slate_tpu/ops/pallas_kernels.py
// :1914-2011) copies each task's dense (2kd+2)² Hermitian patch into VMEM
// by a shear gather.  At kd = 256 that patch is 1.06 MB in fp32 and 2.1 MB
// in fp64; an SM has 227 KB.  So a task here works on the band in place,
// as the host task bodies do (slate_tpu/native/runtime.cc hb_sweep_start
// :766, hb_sweep_step :786, hh_two_sided :686), and only the reflectors,
// the work vectors and the reduction buffers (about 4·kd + NT values) live
// in shared memory.  A band of 8192 × 514 fp32 (16.8 MB) stays in L2.
//
// Band addressing.  A block A[ra + i, ca + c] of the matrix lies in the
// row-major band at base + c·(ld − 1) + i, base = ab + ca·ld + (ra − ca):
// consecutive i are consecutive in memory, so a warp reads a column of A
// (a row of the band) in one transaction.  Only entries on or below the
// diagonal are addressed.
//
// Coherence.  A task reads rows that another block wrote at an earlier
// stagger of the same launch, and L1 is not coherent across SMs: every
// read of the band or the log goes through L2 (__ldcg).  Writes go to L2
// (L1 is write-through); __syncthreads orders a block's own writes and
// reads, grid.sync() everyone's.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace chase {

namespace cg = cooperative_groups;

constexpr int NT = 1024;         // threads per block: one block runs one task
constexpr int NW = NT / 32;
// Entries a thread loads before it uses any: a task is bound by the L2
// round trips of its passes (one SM, ~20 block barriers), so each
// thread keeps U loads in flight.
constexpr int U = 8;

// The shared memory of one block: four kd-vectors, the NT partial sums of
// the row dots and the NW warp sums of the block reductions.
template <typename T>
struct Smem {
  T *u, *v, *y, *y2, *part, *red;
  __device__ Smem(unsigned char* raw, int kd) {
    u = reinterpret_cast<T*>(raw);
    v = u + kd;
    y = v + kd;
    y2 = y + kd;
    part = y2 + kd;
    red = part + NT;
  }
};

template <typename T>
inline size_t smem_bytes(int kd) {
  return (size_t)(4 * kd + NT + NW) * sizeof(T);
}

// A column-major view of a block of A in band storage: M(i, c) =
// base[c·cs + i], cs = ld − 1.
template <typename T>
struct Blk {
  T* base;
  int64_t cs;
  __device__ T ld(int i, int c) const { return __ldcg(base + c * cs + i); }
  __device__ T& at(int i, int c) const { return base[c * cs + i]; }
};

template <typename T>
__device__ Blk<T> block_at(T* ab, int64_t ld, int64_t ra, int64_t ca) {
  return Blk<T>{ab + ca * ld + (ra - ca), ld - 1};
}

// The same view of the TRANSPOSE of a block of the row-major general band
// of tb2bd (st[r·ld + (c − r + kd)] = A[r, c]): M(i, c) = A[ra + c, ca + i]
// = base[c·(ld − 1) + i], base = st + ra·(ld − 1) + ca + kd.  A row of A is
// a column of M, contiguous, so the column-contiguous helpers below keep
// a warp on consecutive addresses; a left reflection of A is a right
// reflection of M and the other way round.  Every c − r of the block must
// lie in [−kd, 2kd + 1].
template <typename T>
__device__ Blk<T> gen_block_t(T* st, int64_t ld, int kd, int64_t ra, int64_t ca) {
  return Blk<T>{st + ra * (ld - 1) + ca + kd, ld - 1};
}

// Sum of x over the block, the same value (same order) in every thread.
template <typename T>
__device__ T block_sum(T x, T* red) {
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  __syncthreads();                       // red may still be read
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  T s = 0;
  for (int w = 0; w < NW; ++w) s += red[w];
  return s;
}

// out[i] = Σ_c M(i, c)·x[c] over c < C (LOWER: c ≤ i), i < R.  Thread
// (i, p) sums the columns c ≡ p (mod P), U at a time, so a warp reads one
// column of M per load; the P partial sums meet in shared memory.
template <bool LOWER, typename T>
__device__ void row_dot(const Blk<T>& m, int R, int C, const T* x, T* out,
                        T* part) {
  const int tid = threadIdx.x;
  if (2 * R > NT) {
    for (int i = tid; i < R; i += NT) {
      T acc = 0;
      const int ce = LOWER ? min(C, i + 1) : C;
      for (int c = 0; c < ce; ++c) acc += m.ld(i, c) * x[c];
      out[i] = acc;
    }
  } else {
    const int P = NT / R, i = tid % R, p = tid / R;
    if (p < P) {
      T acc = 0;
      const int ce = LOWER ? min(C, i + 1) : C;
      for (int c = p; c < ce; c += P * U) {
        T val[U];
#pragma unroll
        for (int k = 0; k < U; ++k) val[k] = c + k * P < ce ? m.ld(i, c + k * P) : T(0);
#pragma unroll
        for (int k = 0; k < U; ++k)
          if (c + k * P < ce) acc += val[k] * x[c + k * P];
      }
      part[p * R + i] = acc;
    }
    __syncthreads();
    for (int r = tid; r < R; r += NT) {
      T s = 0;
      for (int q = 0; q < P; ++q) s += part[q * R + r];
      out[r] = s;
    }
  }
  __syncthreads();
}

// out[c] = Σ_i x[i]·M(i, c) over i < R (STRICT: i > c), for c0 ≤ c < C:
// one warp per column, two columns at a time.
template <bool STRICT, typename T>
__device__ void col_dot(const Blk<T>& m, int R, int c0, int C, const T* x,
                        T* out) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int c = c0 + wid; c < C; c += 2 * NW) {
    const int c2 = c + NW;                 // a second column, if any
    const bool two = c2 < C;
    T acc = 0, acc2 = 0;
#pragma unroll 4
    for (int i = (STRICT ? c + 1 : 0) + lane; i < R; i += 32) {
      acc += x[i] * m.ld(i, c);
      if (two && (!STRICT || i > c2)) acc2 += x[i] * m.ld(i, c2);
    }
    for (int o = 16; o; o >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
      acc2 += __shfl_xor_sync(0xffffffffu, acc2, o);
    }
    if (lane == 0) {
      out[c] = acc;
      if (two) out[c2] = acc2;
    }
  }
  __syncthreads();
}

// M(i, c) −= f(i, c) over i < R, c0 ≤ c < C (LOWER: only c ≤ i).  Thread
// (i, p) takes rows i ≡ tid (mod RB) and columns c ≡ c0 + p (mod P), so
// its row and column come from one division, not one per entry (the
// passes run on one SM), and a warp stores one column of M per step.
// Each thread loads U entries before it stores any.
template <bool LOWER, typename T, typename F>
__device__ void update(const Blk<T>& m, int R, int c0, int C, F f) {
  const int RB = R < NT ? R : NT, P = NT / RB, p = threadIdx.x / RB;
  if (p < P) {
    for (int i = threadIdx.x % RB; i < R; i += RB) {
      const int ce = LOWER ? min(C, i + 1) : C;
      T* row = m.base + i;
      for (int c = c0 + p; c < ce; c += P * U) {
        T old[U];
#pragma unroll
        for (int k = 0; k < U; ++k)
          old[k] = c + k * P < ce ? __ldcg(row + (c + k * P) * m.cs) : T(0);
#pragma unroll
        for (int k = 0; k < U; ++k)
          if (c + k * P < ce) row[(c + k * P) * m.cs] = old[k] - f(i, c + k * P);
      }
    }
  }
  __syncthreads();
}

// larfg as the TPU kernel's _wf_larfg (pallas_kernels.py:1801-1831), real:
// on the live x[0, L) in shared memory, β = −sign(α)·‖x‖, τ = (β − α)/β;
// a zero tail gives τ = 0 and β = α; no safmin rescaling.  x becomes the
// reflector v (v[0] = 1), zero on [L, kd).  Returns τ; *beta gets β.
template <typename T>
__device__ T larfg(T* x, int L, int kd, T* red, T* beta_out) {
  const int tid = threadIdx.x;
  T s = 0;
  for (int i = 1 + tid; i < L; i += NT) s += x[i] * x[i];
  const T xnorm2 = block_sum(s, red);
  const T alpha = x[0];
  const T anorm = sqrt(alpha * alpha + xnorm2);
  const T beta = alpha >= 0 ? -anorm : anorm;
  const bool zero = xnorm2 == 0;
  const T tau = zero ? T(0) : (beta - alpha) / (beta == 0 ? T(1) : beta);
  T denom = alpha - beta;
  if (zero || denom == 0) denom = 1;
  __syncthreads();                       // every thread has read x[0]
  for (int i = tid; i < kd; i += NT)
    x[i] = i == 0 ? T(1) : (i < L ? x[i] / denom : T(0));
  __syncthreads();
  *beta_out = zero ? alpha : beta;
  return tau;
}

// S ← H·S·H on the symmetric block S = A[r, r + L)² (lower triangle
// stored), H = I − τ·v·vᵀ (hh_two_sided, as the TPU kernel's
// _wf_two_sided): w = τ·S·v with S·v from the stored triangle (rows'
// lower parts plus the columns' strictly lower parts), w −= ½·τ·(vᵀw)·v,
// S −= v·wᵀ + w·vᵀ on the stored triangle.
template <typename T>
__device__ void two_sided(T* ab, int64_t ld, int64_t r, int L, const T* v,
                          T tau, Smem<T>& s) {
  const int tid = threadIdx.x;
  const Blk<T> m = block_at(ab, ld, r, r);
  row_dot<true>(m, L, L, v, s.y, s.part);
  col_dot<true>(m, L, 0, L, v, s.y2);
  T d = 0;
  for (int i = tid; i < L; i += NT) {
    const T w = tau * (s.y[i] + s.y2[i]);
    s.y[i] = w;
    d += v[i] * w;
  }
  const T half = T(0.5) * tau * block_sum(d, s.red);
  for (int i = tid; i < L; i += NT) s.y[i] -= half * v[i];
  __syncthreads();
  const T* w = s.y;
  update<true>(m, L, 0, L, [=](int i, int c) { return v[i] * w[c] + w[i] * v[c]; });
}

// The length-1 trailing coupling (hb_sweep_tail): the single row
// A[row, r + c), c < L, past the window takes the right-apply of H.
template <typename T>
__device__ void tail(T* ab, int64_t ld, int64_t row, int64_t r, int L,
                     const T* v, T tau, T* red) {
  const int tid = threadIdx.x;
  const Blk<T> m = block_at(ab, ld, row, r);
  T acc = 0;
  for (int c = tid; c < L; c += NT) acc += m.ld(0, c) * v[c];
  acc = tau * block_sum(acc, red);
  for (int c = tid; c < L; c += NT) m.at(0, c) = m.ld(0, c) - acc * v[c];
  __syncthreads();
}

// The cooperative grid: min(want, co-resident blocks of NT threads with
// `smem` bytes of dynamic shared memory).  Returns a CUDA error code.
inline int plan_grid(const void* kernel, size_t smem, int want, int* G_out) {
  int dev = 0, sms = 0, coop = 0, occ = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, NT, smem)) !=
      cudaSuccess)
    return (int)err;
  if (occ < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *G_out = want < occ * sms ? want : occ * sms;
  return 0;
}

}  // namespace chase
