// B lower Cholesky factors in one launch: the port of the Pallas kernel
// `potrf_batched` (slate_tpu/ops/pallas_kernels.py:2288-2343:
// _chol_blocked_value, _potrf_batched_kernel).  Same blocked algorithm per
// problem, ib = 32: an unblocked Cholesky of the diagonal block and its
// inverse B⁻¹, L21 = A21·B⁻ᵀ, the rank-32 trailing update, and the upper
// triangle zeroed.
//
// What bounds it on an H100: at B = 64, n = 256 the batch moves 25.2 MB
// (each input's lower triangle read, each factor written whole) and does
// 3.6e8 FLOP, ~0.0075 ms at the card's memory rate, but each problem is a
// chain of n/32 dependent steps, and one step is a 32² Cholesky, its
// inverse and two small products.  So what decides the time is how short a
// step is and whether the data it touches is on chip.  The TPU kernel keeps
// whole problems in VMEM.  Here ONE BLOCK OWNS ONE PROBLEM, two routes
// (slate_potrf_batched_plan decides from n; ops/smem.py potrf_batched_plan
// restates it and ops/kernels.py checks the two agree when it loads this
// library):
//
//   * `smem` (n ≤ 288 on the H100): the problem's lower triangle lives in
//     the block's shared memory as (n/32)(n/32+1)/2 tiles of 32 × 32 (rows
//     padded to 33 floats, so a warp reading one column of 32 rows, or one
//     row of 32 columns, touches 32 banks), beside one tile for the
//     diagonal block's inverse: 156,288 B at n = 256.  It is read once from
//     device memory (cp.async, four bytes a copy: the padded rows are not
//     16-byte aligned) and the factor written once, the upper triangle's
//     zeros written straight out.  512 threads (16 warps) and two
//     __syncthreads a step:
//       - the diagonal block: its Cholesky on warp 0 holding it in
//         registers (lane r owns row r; column j's scaled entries reach the
//         other lanes by shuffles) and its inverse on warp 1, one column
//         behind at named barrier 1 (tri_grid.cuh chol32_warp,
//         lower_inv_warp<true>): no serial shared-memory chain;
//       - L21 = A21·B⁻ᵀ over all warps, a warp a quarter tile (8 rows × 32
//         columns, 2 × 4 outputs a lane), in place: each warp reads and
//         writes only its own rows;
//       - the rank-32 update of the trailing triangle over all warps, a
//         warp a 32 × 32 tile (4 × 8 outputs a lane).  The next diagonal
//         tile goes to warps 0 and 1 (half its rows each, then named
//         barrier 2), which factor and invert it at once while the other
//         14 warps update the rest: the look-ahead that keeps the diagonal
//         chain beside the update's path.
//     Products are full fp32 FFMA (single-pass TF32 fails the gates), each
//     sum over ascending k from zero, the trailing update c − Σ.
//   * `l2` (n ≥ 320): the working set does not fit a block, so one block
//     of 1024 threads works from its output buffer in device memory (L2
//     holds it) with tri_panel.cuh's single-block phases: the 32² Cholesky
//     and its inverse on one warp in shared memory, L21 and the trailing
//     update as 128 × 128-tiled block_gemm calls through the scratch W.
//
// The problems run side by side on the SMs with no barrier between blocks;
// a batch of fewer problems than SMs leaves SMs idle.  Reads only the lower
// triangle.

#include <atomic>

#include "tri_grid.cuh"
#include "tri_panel.cuh"

// perf/kernel_phases.py defines BATCHED_MARK(k) in its stamped copy: thread
// 0 of each of the first blocks stamps the time at each mark (Mark below).
#ifndef BATCHED_MARK
#define BATCHED_MARK(k)
#endif

namespace {

// ---------------------------------------------------------------------------
// The smem route
// ---------------------------------------------------------------------------

constexpr int IB = 32;
constexpr int SNT = 512;              // threads of a smem-route block
constexpr int SNW = SNT / 32;
constexpr int LDS = tri_grid::LDB;    // row stride of a shared tile (33)
constexpr int TILE = IB * LDS;        // floats of a shared tile
// the H100's opt-in shared memory a block may take: the route's limit
constexpr int64_t SMEM_MAX = 232448;

// The smem route's marks (BATCHED_MARK, all on warp 0): the start, the
// triangle read, a diagonal block factored and inverted, a step begun (its
// barrier passed; the last one before the store), its L21 done, warp 0's
// SYRK of the next diagonal tile done, the factor written.
enum Mark { M_START, M_LOADED, M_DIAG, M_STEP, M_L21, M_SYRK_DIAG, M_END };

// Tiles of the lower triangle of an (n, n) problem: (n/32)(n/32 + 1)/2.
__host__ __device__ inline int tri_tiles(int n) {
  const int nt = n / IB;
  return nt * (nt + 1) / 2;
}

// Dynamic shared memory of a smem-route block: the triangle's tiles and
// the inverse's tile (smem.potrf_batched_plan).
__host__ inline int64_t smem_route_bytes(int n) {
  return 4 * (int64_t)(tri_tiles(n) + 1) * TILE;
}

// Tile (i, j), j ≤ i, of the triangle.
__device__ __forceinline__ float* tile(float* sm, int i, int j) {
  return sm + (i * (i + 1) / 2 + j) * TILE;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

// A (i, k) quarter q of L21: rows 8q … 8q + 7 of tile a take a·B⁻ᵀ (B⁻¹
// in inv), in place, by one warp: lane l the rows 8q + 2(l/8) + {0, 1} and
// the columns 4(l%8) + {0 … 3}.  Each sum over ascending t from zero.
__device__ __noinline__ void l21_quarter(float* a, const float* inv, int q) {
  const int lane = threadIdx.x & 31;
  const int r0 = 8 * q + 2 * (lane >> 3), c0 = 4 * (lane & 7);
  float acc[2][4] = {};
#pragma unroll 8
  for (int t = 0; t < IB; ++t) {
    const float a0 = a[r0 * LDS + t], a1 = a[(r0 + 1) * LDS + t];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float b = inv[(c0 + j) * LDS + t];
      acc[0][j] = fmaf(a0, b, acc[0][j]);
      acc[1][j] = fmaf(a1, b, acc[1][j]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[(r0 + i) * LDS + c0 + j] = acc[i][j];
}

// Tile c −= a·bᵀ by one warp (a, b the step's L21 tiles of c's row and
// column): lane l the rows 4(l/4) + {0 … 3} and the columns 8(l%4) +
// {0 … 7}.  A diagonal tile's upper part is computed too and never read.
__device__ __noinline__ void syrk_tile(float* c, const float* a, const float* b) {
  const int lane = threadIdx.x & 31;
  const int r0 = 4 * (lane >> 2), c0 = 8 * (lane & 3);
  float acc[4][8] = {};
#pragma unroll 4
  for (int t = 0; t < IB; ++t) {
    float av[4], bv[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(r0 + i) * LDS + t];
#pragma unroll
    for (int j = 0; j < 8; ++j) bv[j] = b[(c0 + j) * LDS + t];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* e = c + (r0 + i) * LDS + c0 + j;
      *e = *e - acc[i][j];
    }
}

// Rows 16h … 16h + 15 of tile c −= a·aᵀ by one warp (the next diagonal
// tile, split between warps 0 and 1): lane l the rows 16h + 2(l/4) +
// {0, 1} and the columns 8(l%4) + {0 … 7}.
__device__ __noinline__ void syrk_half(float* c, const float* a, int h) {
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * h + 2 * (lane >> 2), c0 = 8 * (lane & 3);
  float acc[2][8] = {};
#pragma unroll 4
  for (int t = 0; t < IB; ++t) {
    const float a0 = a[r0 * LDS + t], a1 = a[(r0 + 1) * LDS + t];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float b = a[(c0 + j) * LDS + t];
      acc[0][j] = fmaf(a0, b, acc[0][j]);
      acc[1][j] = fmaf(a1, b, acc[1][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* e = c + (r0 + i) * LDS + c0 + j;
      *e = *e - acc[i][j];
    }
}

// The diagonal block's Cholesky (warp 0) and inverse (warp 1).  These and
// the two products above are not inlined, so that each is allocated its
// registers alone under the 128 that 512 threads leave (inlined, the
// kernel spills).
__device__ __noinline__ void diag_chol(float* a) { tri_grid::chol32_warp(a); }
__device__ __noinline__ void diag_inv(const float* a, float* inv) {
  tri_grid::lower_inv_warp<true>(a, inv, false);
}

__global__ void __launch_bounds__(SNT, 1)
potrf_batched_smem_kernel(const float* A, float* L, int n) {
  extern __shared__ __align__(16) float sm[];
  const int nt = n / IB, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* inv = sm + tri_tiles(n) * TILE;
  A += (int64_t)blockIdx.x * n * n;
  L += (int64_t)blockIdx.x * n * n;
  BATCHED_MARK(M_START);

  // the lower triangle in, a warp a row, a lane a column of each tile
  for (int i = w; i < n; i += SNW) {
    const int ti = i >> 5, r = i & 31;
    for (int tj = 0; tj <= ti; ++tj)
      if (tj < ti || lane <= r)
        cp_async4(tile(sm, ti, tj) + r * LDS + lane, A + (int64_t)i * n + tj * IB + lane);
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  BATCHED_MARK(M_LOADED);
  if (w == 0) {
    diag_chol(tile(sm, 0, 0));
    BATCHED_MARK(M_DIAG);
  } else if (w == 1) {
    diag_inv(tile(sm, 0, 0), inv);
  }

  for (int k = 0; k < nt - 1; ++k) {
    const int m = nt - 1 - k;   // tiles below the diagonal block k
    __syncthreads();            // L_kk and its inverse are in place
    BATCHED_MARK(M_STEP);
    for (int u = w; u < 4 * m; u += SNW) l21_quarter(tile(sm, k + 1 + u / 4, k), inv, u % 4);
    __syncthreads();            // column k of L is in place
    BATCHED_MARK(M_L21);
    if (w < 2) {
      // the next diagonal tile's update, half on each of warps 0 and 1,
      // then its Cholesky on warp 0 and inverse on warp 1
      syrk_half(tile(sm, k + 1, k + 1), tile(sm, k + 1, k), w);
      asm volatile("bar.sync 2, 64;" ::: "memory");
      BATCHED_MARK(M_SYRK_DIAG);
      if (w == 0) {
        diag_chol(tile(sm, k + 1, k + 1));
        BATCHED_MARK(M_DIAG);
      } else {
        diag_inv(tile(sm, k + 1, k + 1), inv);
      }
    } else {
      // the other tiles (i, j), k < j ≤ i, of the trailing triangle, in
      // the order v = a(a + 1)/2 + b of their offsets (a, b) = (i, j) − k − 1
      for (int v = w - 1; v < m * (m + 1) / 2; v += SNW - 2) {
        int a = 1;
        while ((a + 1) * (a + 2) / 2 <= v) ++a;
        const int i = k + 1 + a, j = k + 1 + v - a * (a + 1) / 2;
        syrk_tile(tile(sm, i, j), tile(sm, i, k), tile(sm, j, k));
      }
    }
  }
  __syncthreads();
  BATCHED_MARK(M_STEP);

  // the factor out, zeros above the diagonal written straight
  for (int i = w; i < n; i += SNW) {
    const int ti = i >> 5, r = i & 31;
    float* row = L + (int64_t)i * n;
    for (int tj = 0; tj < nt; ++tj) {
      const bool low = tj < ti || (tj == ti && lane <= r);
      row[tj * IB + lane] = low ? tile(sm, ti, tj)[r * LDS + lane] : 0.f;
    }
  }
  BATCHED_MARK(M_END);
}

// The smem kernel's dynamic shared memory limit, raised to the device's
// opt-in maximum (less its static shared memory) on the first call there
// and cached after, so a launch
// costs no attribute call.  Two threads racing the first call set the same
// limit.
constexpr int MAX_DEVICES = 64;
std::atomic<int> optin_of[MAX_DEVICES];   // 0: not set up yet

cudaError_t smem_limit(int* optin) {
  int dev = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev < MAX_DEVICES && (*optin = optin_of[dev].load()) > 0) return cudaSuccess;
  if ((err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return err;
  cudaFuncAttributes fa;
  if ((err = cudaFuncGetAttributes(&fa, potrf_batched_smem_kernel)) != cudaSuccess) return err;
  *optin -= (int)fa.sharedSizeBytes;
  if ((err = cudaFuncSetAttribute(potrf_batched_smem_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, *optin)) !=
      cudaSuccess)
    return err;
  if (dev < MAX_DEVICES) optin_of[dev].store(*optin);
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// The l2 route (the kernel before the smem route, unchanged)
// ---------------------------------------------------------------------------

using tri_panel::block_gemm;
using tri_panel::chol_unblocked_warp;
using tri_panel::load_lower_block_warp;
using tri_panel::NTH;
using tri_panel::Smem;
using tri_panel::trtri_unblocked_warp;

__global__ void __launch_bounds__(NTH, 1)
potrf_batched_kernel(const float* A, float* L, float* W, int n) {
  __shared__ __align__(16) Smem s;
  const int tid = threadIdx.x;
  const int64_t nn = (int64_t)n * n;
  A += blockIdx.x * nn;
  L += blockIdx.x * nn;
  W += blockIdx.x * (int64_t)(n - IB) * IB;
  for (int64_t e = tid; e < nn; e += NTH) {
    const int i = (int)(e / n), j = (int)(e % n);
    L[e] = (i >= j) ? A[e] : 0.f;
  }
  __syncthreads();

  for (int k0 = 0; k0 < n; k0 += IB) {
    float* lkk = L + (int64_t)k0 * n + k0;
    const int m = n - k0 - IB;
    if (tid < 32) {
      load_lower_block_warp(s, lkk, n);
      chol_unblocked_warp(s);
      if (m > 0) trtri_unblocked_warp(s);
    }
    __syncthreads();
    {
      const int r = tid / IB, c = tid % IB;
      if (r >= c) lkk[(int64_t)r * n + c] = s.blk[r][c];
    }
    if (m > 0) {
      float* a21 = L + (int64_t)(k0 + IB) * n + k0;
      __syncthreads();
      // W (m, IB) = A21 · B⁻ᵀ, B⁻¹ read from shared memory
      block_gemm(s, m, IB, IB, 1.f, a21, n, 1, false, &s.inv[0][0], 1, IB + 1,
                 false, 0.f, W, IB, false);
      for (int e = tid; e < m * IB; e += NTH)
        a21[(int64_t)(e / IB) * n + e % IB] = W[e];
      // A22 -= W · Wᵀ on the lower triangle
      block_gemm(s, m, m, IB, -1.f, W, IB, 1, false, W, 1, IB, false, 1.f,
                 a21 + IB, n, true);
    }
  }
}

enum Route { SMEM = 0, L2 = 1 };

}  // namespace

// The plan at n: the route (0 smem, 1 l2) and one block's shared memory in
// bytes (the smem route's dynamic share, or the l2 route's static staging
// tiles).  ops/smem.py potrf_batched_plan is checked equal to it at every n
// on the 32 grid to 1024 when the library is loaded.
extern "C" int slate_potrf_batched_plan(int n, int* route, int* bytes) {
  if (n < IB || n % IB != 0) return (int)cudaErrorInvalidValue;
  const int64_t b = smem_route_bytes(n);
  *route = b <= SMEM_MAX ? SMEM : L2;
  *bytes = b <= SMEM_MAX ? (int)b : (int)sizeof(tri_panel::Smem);
  return 0;
}

// A: (batch, n, n) contiguous, only each problem's lower triangle is read.
// L: (batch, n, n) contiguous output.  W: scratch of batch·(n - 32)·32
// floats for the l2 route (unused, and may be null, on the smem route).  n
// a multiple of 32.
extern "C" int slate_potrf_batched_f32(const float* A, float* L, float* W,
                                       int batch, int n, cudaStream_t stream) {
  int route = 0, bytes = 0;
  if (batch < 1 || slate_potrf_batched_plan(n, &route, &bytes) != 0)
    return (int)cudaErrorInvalidValue;
  if (route == SMEM) {
    int optin = 0;
    cudaError_t err;
    if ((err = smem_limit(&optin)) != cudaSuccess) return (int)err;
    if (bytes > optin) return (int)cudaErrorInvalidValue;
    potrf_batched_smem_kernel<<<batch, SNT, (size_t)bytes, stream>>>(A, L, n);
  } else {
    if (W == nullptr) return (int)cudaErrorInvalidValue;
    potrf_batched_kernel<<<batch, tri_panel::NTH, 0, stream>>>(A, L, W, n);
  }
  return (int)cudaGetLastError();
}
