// pgetrf's fused block-row solve in one launch: the port of the Pallas kernel
// `lu_u12_panel` (slate_tpu/ops/pallas_kernels.py:646, body _lu_u12_kernel
// :629).  For the unit-lower (nb, nb) L11 (unit diagonal stored) and the
// (nb, w) block row B it returns U = u1 + L⁻¹·r1, where u1 = L⁻¹·B and
// r1 = B − L11·u1 (one residual correction), and the departure
// dev = max|r1| / max(max|B|, FLT_MIN) of the uncorrected solve, which the
// caller guards on (the exact trsm takes over past 1e-2).  L⁻¹ is the
// trtri_panel inverse of L11's lower triangle (ib = 32 block inverses,
// recursive doubling); the correction multiplies by L11 as given, as the TPU
// kernel does.
//
// What bounds it on an H100: at the widest call of the distributed path
// (nb = 256, w = 16384) the three products by triangles (L⁻¹ twice and the
// unit-lower L11 the caller stores) and the inverse need 3·nb²·w + nb³/3 ≈
// 3.23e9 FLOP over 34 MB: bound by operations (≈ 0.048 ms at 67 TFLOP/s
// fp32).  At the ring call (256, 256) the bound is under a microsecond, and
// the time is the inverse's chain of dependent steps.  The TPU kernel keeps
// B, U and r1 in VMEM; here one cooperative grid of 256-thread blocks
// (tri_grid.cuh) runs every phase over the whole card, a grid barrier after
// each:
//   A. the nb/32 diagonal 32-blocks of L11 inverted at once, one block each
//      (a warp's lanes carry the substitution in registers), while the grid
//      zeroes the strictly upper part of L⁻¹ and the two maxima;
//   then the doubling, level by level: W = L21·X11, barrier,
//      X21 = −X22·W, barrier, over 32 × 32 tiles (log2(nb/32) levels);
//   B. u1 = L⁻¹·B into U; r1 = B − L11·u1 into scratch (its sum seeded
//      with −B, so B's loads overlap the products), with max|r1| and
//      max|B| folded into two device words by atomicMax on the bit patterns
//      (|x| is non-negative, so its bits order as integers; a NaN's bits are
//      the largest, so a NaN propagates as the TPU kernel's max does);
//      U += L⁻¹·r1, while block 0 writes dev.  Each product's output tiles
//      (edge 128, 64 or 32 by the block row's size, so that the tiles cover
//      the grid) go over the blocks; the L⁻¹ products skip the K slabs above
//      the triangle.
// FFMA in full fp32; no library call.

#include <cfloat>

#include "tri_grid.cuh"

namespace {

using namespace tri_grid;

__device__ __forceinline__ int abs_bits(float v) { return __float_as_int(fabsf(v)); }

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Output tile edge of phase B: the largest whose tiles number at least 128
// (about the card's SM count), so that a tile's extra FMA per load pays; at
// most nb (w is a multiple of 128).
__host__ __device__ inline int u12_edge(int nb, int w) {
  const int64_t a = (int64_t)nb * w;
  const int e = a >= 128LL * 128 * 128 ? 128 : a >= 64LL * 64 * 128 ? 64 : 32;
  return e < nb ? e : nb;
}

template <int E>
__device__ void phase_b(float* sm, cg::grid_group& grid, const float* L, int64_t ldl,
                        const float* B, int64_t ldb, float* U, const float* Linv,
                        float* R, int* mx, float* dev, int nb, int w) {
  const int g = blockIdx.x, G = gridDim.x, tid = threadIdx.x;
  const int nj = w / E, tiles = (nb / E) * nj;
  // whole tiles, and K = nb a multiple of the slab depth but for nb = 32
  // under the 32-tile's 64-deep slab: masks only there
  constexpr bool CHECK = E == IB;
  // u1 = L⁻¹·B
  for (int u = g; u < tiles; u += G)
    tile_gemm<E, E, LOWER, FULL, CHECK>(
        sm, u / nj * E, u % nj * E, nb, w, nb, Linv, nb, B, ldb,
        [&](int i, int j, float v) { U[(int64_t)i * w + j] = v; });
  grid.sync();
  // r1 = B − L11·u1 as −(−B + L11·u1), the sum seeded with −B (B read
  // before the products, not after them), and the two maxima
  int rmax = 0, bmax = 0;
  for (int u = g; u < tiles; u += G)
    tile_gemm<E, E, FULL, FULL, CHECK>(
        sm, u / nj * E, u % nj * E, nb, w, nb, L, ldl, U, w,
        [&](int i, int j, float v) {
          R[(int64_t)i * w + j] = -v;
          rmax = max(rmax, abs_bits(v));
        },
        [&](int i, int j) {
          const float b = __ldcg(B + (int64_t)i * ldb + j);
          bmax = max(bmax, abs_bits(b));
          return -b;
        });
  rmax = warp_max(rmax);
  bmax = warp_max(bmax);
  if ((tid & 31) == 0) {
    atomicMax(mx, rmax);
    atomicMax(mx + 1, bmax);
  }
  grid.sync();
  if (g == 0 && tid == 0) {
    const float r = __int_as_float(__ldcg(mx));
    const float bm = __int_as_float(__ldcg(mx + 1));
    dev[0] = r / (bm != bm ? bm : fmaxf(bm, FLT_MIN));
  }
  // U = u1 + L⁻¹·r1
  for (int u = g; u < tiles; u += G)
    tile_gemm<E, E, LOWER, FULL, CHECK>(
        sm, u / nj * E, u % nj * E, nb, w, nb, Linv, nb, R, w, [&](int i, int j, float v) {
          float* p = U + (int64_t)i * w + j;
          *p = v + __ldcg(p);
        });
}

__global__ void __launch_bounds__(NTH, 2)
lu_u12_panel_kernel(const float* L, int64_t ldl, const float* B, int64_t ldb,
                    float* U, float* Linv, float* W, float* R, int* mx,
                    float* dev, int nb, int w) {
  __shared__ __align__(16) float sm[SMEM_FLOATS];
  cg::grid_group grid = cg::this_grid();
  const int g = blockIdx.x, G = gridDim.x, tid = threadIdx.x;

  // A. the diagonal inverses; the strictly upper blocks of L⁻¹ zeroed
  if (g == 0 && tid < 2) mx[tid] = 0;
  const int64_t nn = (int64_t)nb * nb;
  for (int64_t e = (int64_t)g * NTH + tid; e < nn; e += (int64_t)G * NTH)
    if ((e % nb) / IB > (e / nb) / IB) Linv[e] = 0.f;
  float* blk = sm;
  float* inv = sm + IB * LDT;
  for (int d = g; d < nb / IB; d += G) {
    const int64_t k0 = (int64_t)d * IB;
    float v[4];
    load_block_regs(L + k0 * ldl + k0, ldl, v);
    put_block(blk, LDB, v, false, true);
    __syncthreads();
    if (tid < 32) lower_inv_warp(blk, inv, false);
    __syncthreads();
    store_block(inv, LDB, Linv + k0 * nb + k0, nb);
    __syncthreads();
  }
  grid.sync();
  for (int lw = IB; lw < nb; lw *= 2) {
    const int tiles = doubling_tiles(nb, lw);
    for (int ph = 0; ph < 2; ++ph) {
      for (int u = g; u < tiles; u += G)
        doubling_tile(sm, true, ph, lw, u, L, ldl, Linv, nb, W);
      grid.sync();
    }
  }

  // B. the block row
  const int e = u12_edge(nb, w);
  if (e == 128) phase_b<128>(sm, grid, L, ldl, B, ldb, U, Linv, R, mx, dev, nb, w);
  else if (e == 64) phase_b<64>(sm, grid, L, ldl, B, ldb, U, Linv, R, mx, dev, nb, w);
  else phase_b<32>(sm, grid, L, ldl, B, ldb, U, Linv, R, mx, dev, nb, w);
}

}  // namespace

// The grid for (nb, w): co-resident blocks, capped at the widest phase's
// tiles (the block row's, the last doubling level's, the diagonal blocks).
extern "C" int slate_lu_u12_panel_plan(int nb, int w, int* G) {
  const int e = u12_edge(nb, w);
  int want = (nb / e) * (w / e);
  const int dbl = nb >= 2 * IB ? doubling_tiles(nb, nb / 2) : 0;
  if (dbl > want) want = dbl;
  if (nb / IB > want) want = nb / IB;
  return plan_grid((const void*)lu_u12_panel_kernel, want, G);
}

// L: (nb, nb) unit lower with row stride ldl (unit diagonal and zeros above
// it stored).  B: (nb, w) with row stride ldb.  U: contiguous (nb, w)
// output; Linv: (nb, nb) scratch; W: (nb/2)² floats of scratch (the
// doubling's products of one level); R: (nb, w) scratch; mx: two ints of
// scratch; dev: one float, the output departure.  nb a power of two in
// [32, 1024], w a multiple of 128.  G from the plan.
extern "C" int slate_lu_u12_panel_f32(const float* L, int64_t ldl, const float* B,
                                      int64_t ldb, float* U, float* Linv, float* W,
                                      float* R, int* mx, float* dev, int nb, int w,
                                      int G, cudaStream_t stream) {
  if (nb < IB || nb > 1024 || (nb & (nb - 1)) != 0 || w < 128 || w % 128 != 0 ||
      ldl < nb || ldb < w || G < 1)
    return (int)cudaErrorInvalidValue;
  void* args[] = {&L, &ldl, &B, &ldb, &U, &Linv, &W, &R, &mx, &dev, &nb, &w};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)lu_u12_panel_kernel, dim3(G), dim3(NTH), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
