// Device code shared by the bulge-chase kernels (hb2st_wavefront.cu and
// tb2bd_wavefront.cu): the wavefront over the staggers, the cluster that
// runs one chase task, and the passes of a task over its window.
//
// The TPU kernels (slate_tpu/ops/pallas_kernels.py :1914-2011 and
// :2084-2208) copy each task's dense patch into one core's VMEM: at
// kd = 256 that is 1.06 MB in fp32 and 2.1 MB in fp64, and an SM has
// 227 KB.  Here ONE TASK RUNS ON ONE THREAD-BLOCK CLUSTER of C blocks
// (C ≤ 16, one block an SM), and the task's window is split between the
// blocks' shared memory:
//   * hb2st: the (Lt, kd) bulge block B by columns, and the stored lower
//     triangle of the symmetric S = A[r : r+L]² by pairs of columns
//     (c, L−1−c), so that every block holds as many entries;
//   * tb2bd (on a transposed view M of the row-major band, in
//     which a row of A is a contiguous column): the off-diagonal block by
//     columns, the diagonal block D by rows.
// Each block copies its share from the band once (cp.async, a warp on
// consecutive entries along the band's contiguous direction), runs every
// pass of the task on it, and writes it back once.  Where the share at
// C = 16 does not fit a block (fp64 from kd = 453 / 528, fp32 from 657 /
// 757, tb2bd / hb2st), the same split runs with the window left in the
// band (route L2): the passes read (__ldcg) and write it there.
//
// A pass that sums along the split (B·u, S·v, the off block's u apply,
// vᵀ·D) is an EXCHANGE: each block writes its partial vector into its own
// shared memory, one cluster barrier, and every block sums the C partials
// of the cluster in rank order, so every block holds the same bits.  A
// pass that sums across the split stays in its block.  Each block runs
// the reflector's larfg itself on the same inputs (the source column or
// row is read by every block, and its update uses the exchanged vector),
// so no broadcast is needed: two exchanges a task in the middle of a
// sweep, one at its start.  The two applies a block takes in a row (the
// previous reflector and the new one) are one rank-2 update.  The second
// barrier of an exchange (every block done reading the partials) is a
// relaxed arrival whose wait is deferred to just before the next exchange
// writes them, so one buffer serves every exchange.
//
// Coherence.  A task reads band entries and log rows that other clusters
// wrote at earlier staggers.  The staggers are ordered by a
// release/acquire barrier over the grid (grid_sync.cuh), whose acquire
// invalidates the SM's L1 (ptxas emits CCTL.IVALL after it, as after the
// cluster barrier's wait): so the window's cp.async copies, which may
// leave L1 lines, and the __ldcg reads of the vectors see them.  The
// entries of a window are each owned by one block, and the entries every
// block reads (a reflector's source) are overwritten by their owner only
// after an exchange that follows every block's read.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_sync.cuh"

// perf/kernel_phases.py defines CHASE_PHASE(k) in its stamped copies: the
// time since the previous mark goes to phase k (Phase below).
#ifndef CHASE_PHASE
#define CHASE_PHASE(k)
#endif

namespace chase {

namespace cg = cooperative_groups;
using grid_sync::cluster_arrive;
using grid_sync::cluster_arrive_relaxed;
using grid_sync::cluster_wait;
using grid_sync::ColumnBarrier;

constexpr int NT = 512;          // threads of a block
constexpr int NW = NT / 32;
constexpr int PRE = 2;           // registers a thread prefetches D's row 0 into
constexpr int MAX_CLUSTER = 16;

enum Kind { HB = 0, TB = 1 };
enum Route { SMEM = 0, L2 = 1 };
// the phases CHASE_PHASE attributes time to
enum Phase { PH_LOAD = 0, PH_PASS = 1, PH_X1 = 2, PH_X2 = 3, PH_SUM = 4, PH_STORE = 5,
             PH_STAGGER = 6, PH_TRAIL = 7, PH_ROWDOT = 8, PH_COLDOT = 9, PH_UPDATE = 10,
             PH_LARFG = 11 };

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Columns (or rows) of a kd-wide block one block of C owns, and pairs of
// S's columns.
__host__ __device__ inline int share(int kd, int C) { return cdiv(kd, C); }
__host__ __device__ inline int pairs(int kd, int C) { return cdiv(cdiv(kd, 2), C); }

// The window values one block keeps in shared memory on route SMEM:
// hb2st its B columns (kd rows each) and S pairs (kd + 1 slots each);
// tb2bd its off-diagonal columns and its D rows (a row stride of share + 1
// for the transposed passes' bank spread).
__host__ __device__ inline int64_t window_values(int kind, int kd, int C) {
  const int64_t s = share(kd, C);
  return kind == HB ? s * kd + (int64_t)pairs(kd, C) * (kd + 1) : s * kd + (int64_t)kd * (s + 1);
}

// The vectors of a block: u, v, y and the exchange buffer x (kd each), the
// local dots y2 (share), the row partials (NT) and the block reduction (NW).
__host__ __device__ inline int64_t vector_values(int kd, int C) {
  return 4 * (int64_t)kd + share(kd, C) + NT + NW;
}

// Dynamic shared memory of one block (ops/smem.py chase_block_bytes).
inline int64_t smem_bytes(int kind, int kd, int dsize, int C, int route) {
  return dsize * (vector_values(kd, C) + (route == SMEM ? window_values(kind, kd, C) : 0));
}

// The route of a shape (ops/smem.py chase_route): SMEM when a block's
// share at the largest cluster fits the opt-in limit.
inline int route_for(int kind, int kd, int dsize, int optin) {
  return smem_bytes(kind, kd, dsize, MAX_CLUSTER, SMEM) <= optin ? SMEM : L2;
}

template <typename T>
struct Smem {
  T *u, *v, *y, *x, *y2, *part, *red, *win;
  __device__ Smem(unsigned char* raw, int kd, int C) {
    u = reinterpret_cast<T*>(raw);
    v = u + kd;
    y = v + kd;
    x = y + kd;
    y2 = x + kd;
    part = y2 + share(kd, C);
    red = part + NT;
    win = red + NW;
  }
};

template <bool SM, typename T>
__device__ __forceinline__ T ldw(const T* p) {
  if (SM) return *p;
  return __ldcg(p);
}

// Column k of a block's share: entry i at p[i·es] for lo ≤ i, its index
// c into the vector it meets (lo past the rows: not a column here).
template <typename T>
struct Col {
  T* p;
  int c, lo;
};

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

// e = tid, tid + NT, … as (k, t) = (e / len, e % len), one division to
// start and none a step.
struct Walk {
  int k, t, dk, dt, len;
  __device__ Walk(int len_) : len(len_ > 0 ? len_ : 1) {
    k = (int)threadIdx.x / len;
    t = (int)threadIdx.x % len;
    dk = NT / len;
    dt = NT % len;
  }
  __device__ void next() {
    k += dk;
    t += dt;
    if (t >= len) {
      t -= len;
      ++k;
    }
  }
};

// A part of a window a block copies: E entries, entry (k, t) of run k at
// band(k, t) and at slot(k, t) in shared memory (band answers nullptr
// for no entry).
template <typename Band, typename Slot>
struct Part {
  int E, len;
  Band band;
  Slot slot;
};
template <typename Band, typename Slot>
__device__ Part<Band, Slot> part(int E, int len, Band band, Slot slot) {
  return Part<Band, Slot>{E, len, band, slot};
}

// One element from the band into shared memory, asynchronously
// (cp.async: no register holds it).  The L1 copy it may leave is safe:
// the staggers' barrier and the cluster barriers acquire with an L1
// invalidation (CCTL.IVALL), and no block writes an entry another block
// reads in the same stagger after that block has read it.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (sizeof(T) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

// Both parts from the band into shared memory, every copy in flight at
// once; vec() runs while they are (its own loads go out beside them).
template <typename T, typename P1, typename P2, typename Vec>
__device__ void copy_in(P1 p1, P2 p2, Vec vec) {
  Walk w1(p1.len);
  for (int e = threadIdx.x; e < p1.E; e += NT, w1.next())
    if (const T* g = p1.band(w1.k, w1.t)) cp_async<T>(p1.slot(w1.k, w1.t), g);
  Walk w2(p2.len);
  for (int e = threadIdx.x; e < p2.E; e += NT, w2.next())
    if (const T* g = p2.band(w2.k, w2.t)) cp_async<T>(p2.slot(w2.k, w2.t), g);
  vec();
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// A part from shared memory back into the band.
template <typename P>
__device__ void copy_out(P p) {
  Walk w(p.len);
  for (int e = threadIdx.x; e < p.E; e += NT, w.next())
    if (auto* q = p.band(w.k, w.t)) *q = *p.slot(w.k, w.t);
}

// Σ over the columns k ≡ k0 (mod P) below K with lo_k ≤ i of M_k[i]·x[c_k],
// four columns in flight.
template <bool SM, typename T, typename ColF>
__device__ __forceinline__ T row_sum(int i, int k0, int P, int K, ColF col, int es,
                                     const T* x) {
  T acc[4] = {0, 0, 0, 0};
  int k = k0;
  for (; k + 3 * P < K; k += 4 * P) {
    Col<T> m[4];
    T val[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) m[j] = col(k + j * P);
#pragma unroll
    for (int j = 0; j < 4; ++j) val[j] = m[j].lo <= i ? ldw<SM>(m[j].p + i * es) : T(0);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] += val[j] * x[m[j].c];
  }
  for (; k < K; k += P) {
    const Col<T> m = col(k);
    if (m.lo <= i) acc[0] += ldw<SM>(m.p + i * es) * x[m.c];
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// out[i] = Σ over columns k < K with lo_k ≤ i of M_k[i]·x[c_k], i < R:
// P = NT / R threads share a row (their sums meet in part, in order).
template <bool SM, typename T, typename ColF>
__device__ void rowdot(int R, int K, ColF col, int es, const T* x, T* out, T* part) {
  const int tid = threadIdx.x;
  if (R > NT / 2) {
    for (int i = tid; i < R; i += NT) out[i] = row_sum<SM>(i, 0, 1, K, col, es, x);
  } else if (R > 0) {
    const int P = NT / R, i = tid % R, q = tid / R;
    if (q < P) part[q * R + i] = row_sum<SM>(i, q, P, K, col, es, x);
    __syncthreads();
    for (int r = tid; r < R; r += NT) {
      T s = 0;
      for (int h = 0; h < P; ++h) s += part[h * R + r];
      out[r] = s;
    }
  }
  __syncthreads();
  CHASE_PHASE(PH_ROWDOT);
}

// sink(k, c_k, Σ_{lo_k + shift ≤ i < R} x[i]·M_k[i]) for each column k < K
// with lo_k < R: one warp a column.
template <bool SM, typename T, typename ColF, typename Sink>
__device__ void coldot(int R, int K, ColF col, int es, int shift, const T* x, Sink sink) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int k = wid; k < K; k += NW) {
    const Col<T> m = col(k);
    if (m.lo >= R) continue;             // the same in the whole warp
    T acc = 0;
#pragma unroll 4
    for (int i = m.lo + shift + lane; i < R; i += 32) acc += x[i] * ldw<SM>(m.p + i * es);
    for (int o = 16; o; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) sink(k, m.c, acc);
  }
  __syncthreads();
  CHASE_PHASE(PH_COLDOT);
}

// The coefficients of one column in a rank-2 update.
template <typename T>
struct Coef {
  T b, d;
};

// M_k[i] −= a[i]·b_k + c[i]·d_k for lo_k ≤ i < R, k < K, with (b_k, d_k)
// = coef(k, c_k): thread (i, q) takes rows i ≡ tid (mod RB) of the
// columns k ≡ q (mod P), four columns in flight.
template <bool SM, typename T, typename ColF, typename CoefF>
__device__ void update(int R, int K, ColF col, int es, const T* a, const T* c, CoefF coef) {
  if (R > 0) {
    const int RB = R < NT ? R : NT, P = NT / RB, q = threadIdx.x / RB;
    if (q < P)
      for (int i = threadIdx.x % RB; i < R; i += RB) {
        const T ai = a[i], ci = c[i];
        int k = q;
        for (; k + 3 * P < K; k += 4 * P) {
          Col<T> m[4];
          T val[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) m[j] = col(k + j * P);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (i >= m[j].lo) val[j] = ldw<SM>(m[j].p + i * es);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (i >= m[j].lo) {
              const Coef<T> f = coef(k + j * P, m[j].c);
              m[j].p[i * es] = val[j] - (ai * f.b + ci * f.d);
            }
        }
        for (; k < K; k += P) {
          const Col<T> m = col(k);
          if (i >= m.lo) {
            const Coef<T> f = coef(k, m.c);
            T* e = m.p + i * es;
            *e = ldw<SM>(e) - (ai * f.b + ci * f.d);
          }
        }
      }
  }
  __syncthreads();
  CHASE_PHASE(PH_UPDATE);
}

// larfg as the TPU kernel's _wf_larfg (pallas_kernels.py:1801-1831), real:
// on the live x[0, L) in shared memory, β = −sign(α)·‖x‖, τ = (β − α)/β;
// a zero tail gives τ = 0 and β = α; no safmin rescaling.  x becomes the
// reflector v (v[0] = 1), zero on [L, kd).  Returns τ; *beta gets β.
// Every block of a cluster runs it on the same x and gets the same bits.
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
  CHASE_PHASE(PH_LARFG);
  *beta_out = zero ? alpha : beta;
  return tau;
}

// The cluster's exchanges: the partial each block writes into x, summed
// over the cluster's blocks in rank order.
template <typename T>
struct Exchange {
  T* buf;
  int C, k;            // the cluster's blocks; exchanges so far in this task
  bool pending;        // the last exchange's trailing arrival still waits
  // Before a block writes its partial: every block is done reading the
  // last ones.
  __device__ void ready() {
    if (pending) {
      CHASE_PHASE(PH_PASS);
      cluster_wait();
      CHASE_PHASE(PH_TRAIL);
      pending = false;
    }
  }
  // dst[i] = Σ_r partial_r[i] for i < n, r in rank order: the same bits
  // in every block of the cluster.
  __device__ void sum(T* dst, int n) {
    CHASE_PHASE(PH_PASS);
    cluster_arrive();
    cluster_wait();
    CHASE_PHASE(k == 0 ? PH_X1 : PH_X2);
    ++k;
    cg::cluster_group cl = cg::this_cluster();
    for (int i = threadIdx.x; i < n; i += NT) {
      T s = 0;                           // 0 + p0 is p0: the order is the ranks'
      for (int r0 = 0; r0 < C; r0 += 8) {  // eight loads in flight
        T part[8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          if (r0 + r < C) part[r] = *cl.map_shared_rank(buf + i, r0 + r);
#pragma unroll
        for (int r = 0; r < 8; ++r)
          if (r0 + r < C) s += part[r];
      }
      dst[i] = s;
    }
    cluster_arrive_relaxed();            // the partials are read
    pending = true;
    __syncthreads();
    CHASE_PHASE(PH_SUM);
  }
  __device__ void finish() {
    if (pending) cluster_wait();
    pending = false;
  }
};

// The launch configuration: a cooperative launch of clusters of C blocks.
struct LaunchConfig {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];
  LaunchConfig(int blocks, int C, size_t bytes, cudaStream_t stream) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeCooperative;
    attr[1].val.cooperative = 1;
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 2;
  }
};

inline int set_attributes(const void* kernel, int64_t bytes) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  return (int)err;
}

inline int device_attribute(cudaDeviceAttr attr, int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(out, attr, dev);
  return (int)err;
}

inline int optin_bytes(int* optin) {
  return device_attribute(cudaDevAttrMaxSharedMemoryPerBlockOptin, optin);
}

// The dynamic shared memory a launch asks for: a block's share, and at
// least half an SM's, so that no two blocks share an SM.
inline int launch_bytes(int64_t bytes, int64_t* out) {
  int per_sm = 0;
  const int err = device_attribute(cudaDevAttrMaxSharedMemoryPerMultiprocessor, &per_sm);
  *out = bytes > per_sm / 2 ? bytes : per_sm / 2;
  return err;
}

// Clusters of C blocks of `kernel` the card holds at once with `bytes` of
// dynamic shared memory a block.
inline int clusters(const void* kernel, int C, int64_t bytes, int* out) {
  int err = launch_bytes(bytes, &bytes);
  if (!err) err = set_attributes(kernel, bytes);
  if (err) return err;
  LaunchConfig lc(C, C, (size_t)bytes, 0);
  return (int)cudaOccupancyMaxActiveClusters(out, kernel, &lc.cfg);
}

// The plan of a chase with nl live tasks (ops/smem.py chase_plan): the
// shape's route; then, of the cluster sizes C = 16, 8, 4, 2, 1 whose share
// fits a block, the one that runs every stagger's tasks in the fewest
// rounds (⌈nl / clusters the card holds⌉), the larger on a tie; G =
// min(nl, clusters) clusters.  kernel_for(route) is the kernel it runs.
template <typename KernelFor>
int plan(int kind, int kd, int dsize, int nl, KernelFor kernel_for, int* G, int* C,
         int* route) {
  int optin = 0, err;
  if ((err = optin_bytes(&optin)) != 0) return err;
  *route = route_for(kind, kd, dsize, optin);
  int best = 0;
  for (int c = MAX_CLUSTER; c >= 1; c /= 2) {
    const int64_t bytes = smem_bytes(kind, kd, dsize, c, *route);
    if (bytes > optin) continue;
    int n = 0;
    if ((err = clusters(kernel_for(*route), c, bytes, &n)) != 0) return err;
    if (n < 1) continue;
    const int rounds = cdiv(nl, n);
    if (best == 0 || rounds < best) {
      best = rounds;
      *C = c;
      *G = n < nl ? n : nl;
    }
  }
  return best ? 0 : (int)cudaErrorCooperativeLaunchTooLarge;
}

// The staggers' barrier counter of one launch: zeroed, allocated and
// freed in the order of `stream` (cudaMallocAsync), so that launches on
// different streams never count on one counter.  The C entries keep their
// arguments: the counter is not the caller's.
inline int new_counter(unsigned** ctr, cudaStream_t stream) {
  cudaError_t e = cudaMallocAsync((void**)ctr, sizeof(unsigned), stream);
  if (e == cudaSuccess) e = cudaMemsetAsync(*ctr, 0, sizeof(unsigned), stream);
  return (int)e;
}

// Launch `kernel` on G clusters of C blocks, each block's share of shared
// memory `bytes`, then free the staggers' counter `ctr` after it on
// `stream`.  A grid the card cannot hold at once is refused with an error
// code, never run.
inline int launch(const void* kernel, void* params, int G, int C, int64_t bytes,
                  unsigned* ctr, cudaStream_t stream) {
  int err = launch_bytes(bytes, &bytes);
  if (!err) err = set_attributes(kernel, bytes);
  if (!err) {
    LaunchConfig lc(G * C, C, (size_t)bytes, stream);
    void* args[] = {params};
    err = (int)cudaLaunchKernelExC(&lc.cfg, kernel, args);
    if (!err) err = (int)cudaGetLastError();
  }
  const cudaError_t e = cudaFreeAsync(ctr, stream);
  return err ? err : (int)e;
}

}  // namespace chase
