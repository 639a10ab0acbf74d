// No-pivot LU of an (nb, nb) block and the inverses of both factors in one
// launch: the port of the Pallas kernel `lu_inv_panel`
// (slate_tpu/ops/pallas_kernels.py:417-557: _lu_unblocked,
// _triu_tri_unblocked, _block_uinv_doubling, _lu_inv_kernel).  Same blocked
// algorithm, ib = 32: per inner block an unblocked LU and the inverses of its
// unit-lower and upper triangles, L21 = A21·U11⁻¹, U12 = L11⁻¹·A12, the
// trailing update A22 −= L21·U12; then L⁻¹ and U⁻¹ by recursive doubling.
// Its caller is the Householder reconstruction of the CholQR² QR panel
// (slate_tpu_torch/linalg/qr.py:_cholqr2_panel), whose block needs no
// pivoting.
//
// What bounds it on an H100: ~4/3·nb³ FLOP (1.8e8 at nb = 512) over 4 MB of
// inputs and outputs, a few microseconds at the card's fp32 peak; but the
// algorithm is a chain of nb/32 dependent steps, each starting from a 32 × 32
// factorization, that the TPU ran inside one core's VMEM.  Latency bounds it:
// the chain's length and a grid barrier a step.  So one cooperative grid of
// 256-thread blocks (tri_grid.cuh) runs it over the card:
//   * block 0 factors the first diagonal block from A (the LU on one warp in
//     registers, then the two triangle inverses at once on two warps) while
//     the grid zeroes the far triangles of L⁻¹ and U⁻¹;
//   * step k (one grid barrier each): the trailing 32 × 32 tiles (I, J),
//     I, J > k, go over the blocks.  A tile's block forms L21_I = A21_I·U11⁻¹
//     and U12_J = L11⁻¹·A12_J itself (32³ FMA each, from the step's block
//     inverses), and writes A22_IJ − L21_I·U12_J; the blocks of the first
//     trailing column and row store L21 and U12 into LU.  The running Schur
//     complement lives in scratch (A itself at step 0), not in LU, so no
//     block overwrites what another still reads.  The block of tile
//     (k+1, k+1), block 0, factors that updated block at once (a one-step
//     look-ahead): the next step's diagonal work is done by the step's
//     barrier.  nb/32 barriers in all;
//   * the two recursive doublings at the same time, their 32 × 32 tiles over
//     one list: L⁻¹ as [[X11, 0], [−X22·(L21·X11), X22]] and U⁻¹ directly
//     as [[X11, −X11·(U12·X22)], [0, X22]] (the reference's
//     _block_uinv_doubling), two barriers a level.
// Every global read is __ldcg (other blocks wrote the data in the launch).
// FFMA in full fp32; no library call.

#include "tri_grid.cuh"

namespace {

using namespace tri_grid;

// The 32 × 32 blocks of a step in shared memory: the products' operands at
// row stride LDT (left operands transposed), the diagonal work's at LDB.
struct Bufs {
  float *liT, *ui, *a21T, *a12, *l21T, *u12, *blk, *xu, *xl;
  __device__ explicit Bufs(float* sm)
      : liT(sm), ui(sm + 1 * IB * LDT), a21T(sm + 2 * IB * LDT), a12(sm + 3 * IB * LDT),
        l21T(sm + 4 * IB * LDT), u12(sm + 5 * IB * LDT), blk(sm + 6 * IB * LDT),
        xu(sm + 7 * IB * LDT), xl(sm) {}   // xl reuses liT once the products are done
};

// Factor the 32 × 32 block in s.blk (diagonal block d): the LU on warp 0,
// then the unit-lower inverse on warp 0 and the upper inverse on warp 1 at
// once; packed LU into LU, the inverses into Linv and Uinv, all at rows and
// columns d·32.  Ends with __syncthreads.
__device__ void factor_diag(const Bufs& s, float* LU, float* Linv, float* Uinv, int nb,
                            int d) {
  if (threadIdx.x < 32) lu32_warp(s.blk);
  __syncthreads();
  if (threadIdx.x < 32) lower_inv_warp(s.blk, s.xl, true);
  else if (threadIdx.x < 64) upper_inv_warp(s.blk, s.xu);
  __syncthreads();
  const int64_t o = (int64_t)d * IB * (nb + 1);
  store_block(s.blk, LDB, LU + o, nb);
  store_block(s.xl, LDB, Linv + o, nb);
  store_block(s.xu, LDB, Uinv + o, nb);
  __syncthreads();
}

// Tile (I, J) of step k: S_IJ −= (S_Ik·U11⁻¹)·(L11⁻¹·S_kJ), S read at src
// (row stride lds), written to the scratch S (row stride nb).  Each product
// is 32³ in 2 × 2 register fragments, the sums in ascending order.
__device__ void step_tile(const Bufs& s, const float* src, int64_t lds, float* S,
                          float* LU, float* Linv, float* Uinv, int nb, int k, int I,
                          int J) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t kk = (int64_t)k * IB * (nb + 1);
  float li[4], ui[4], a21[4], a12[4], c[2][2];
  load_block_regs(Linv + kk, nb, li);
  load_block_regs(Uinv + kk, nb, ui);
  load_block_regs(src + (int64_t)I * IB * lds + k * IB, lds, a21);
  load_block_regs(src + (int64_t)k * IB * lds + J * IB, lds, a12);
  const float* cij = src + (int64_t)(I * IB + 2 * ty) * lds + J * IB + 2 * tx;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) c[i][j] = __ldcg(cij + i * lds + j);
  put_block(s.liT, LDT, li, true);
  put_block(s.ui, LDT, ui);
  put_block(s.a21T, LDT, a21, true);
  put_block(s.a12, LDT, a12);
  __syncthreads();
  float l[2][2] = {}, u[2][2] = {};
  mm32(s.a21T, s.ui, l);      // L21 = A21·U11⁻¹
  mm32(s.liT, s.a12, u);      // U12 = L11⁻¹·A12
  float* l21 = LU + (int64_t)(I * IB + 2 * ty) * nb + k * IB + 2 * tx;
  float* u12 = LU + (int64_t)(k * IB + 2 * ty) * nb + J * IB + 2 * tx;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      s.l21T[(2 * tx + j) * LDT + 2 * ty + i] = l[i][j];
      s.u12[(2 * ty + i) * LDT + 2 * tx + j] = u[i][j];
      if (J == k + 1) l21[i * nb + j] = l[i][j];
      if (I == k + 1) u12[i * nb + j] = u[i][j];
    }
  __syncthreads();
  float t[2][2] = {};
  mm32(s.l21T, s.u12, t);     // A22 −= L21·U12
  const bool diag = I == k + 1 && J == k + 1;
  float* out = diag ? s.blk + 2 * ty * LDB + 2 * tx
                    : S + (int64_t)(I * IB + 2 * ty) * nb + J * IB + 2 * tx;
  const int ldo = diag ? LDB : nb;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) out[i * ldo + j] = c[i][j] - t[i][j];
  __syncthreads();
  if (diag) factor_diag(s, LU, Linv, Uinv, nb, k + 1);
}

__global__ void __launch_bounds__(NTH, 2)
lu_inv_panel_kernel(const float* A, int64_t lda, float* LU, float* Linv,
                    float* Uinv, float* W, int nb) {
  __shared__ __align__(16) float sm[SMEM_FLOATS];
  cg::grid_group grid = cg::this_grid();
  const int g = blockIdx.x, G = gridDim.x, tid = threadIdx.x;
  const int nt = nb / IB;
  const Bufs s(sm);

  // the far triangles of the inverses; the doublings write the near ones
  const int64_t nn = (int64_t)nb * nb;
  for (int64_t e = (int64_t)g * NTH + tid; e < nn; e += (int64_t)G * NTH) {
    const int bi = (int)(e / nb) / IB, bj = (int)(e % nb) / IB;
    if (bj > bi) Linv[e] = 0.f;
    else if (bj < bi) Uinv[e] = 0.f;
  }
  if (g == 0) {
    float v[4];
    load_block_regs(A, lda, v);
    put_block(s.blk, LDB, v);
    __syncthreads();
    factor_diag(s, LU, Linv, Uinv, nb, 0);
  }
  grid.sync();

  // the steps: the Schur complement in W (A at step 0)
  for (int k = 0; k + 1 < nt; ++k) {
    const int m = nt - k - 1;
    const float* src = k == 0 ? A : W;
    const int64_t lds = k == 0 ? lda : nb;
    for (int u = g; u < m * m; u += G)
      step_tile(s, src, lds, W, LU, Linv, Uinv, nb, k, k + 1 + u / m, k + 1 + u % m);
    grid.sync();
  }

  // both doublings: L⁻¹'s tiles then U⁻¹'s on one list; W is free now
  float* wl = W;
  float* wu = W + nn / 4;
  for (int w = IB; w < nb; w *= 2) {
    const int tiles = doubling_tiles(nb, w);
    for (int ph = 0; ph < 2; ++ph) {
      for (int u = g; u < 2 * tiles; u += G) {
        if (u < tiles) doubling_tile(sm, true, ph, w, u, LU, nb, Linv, nb, wl);
        else doubling_tile(sm, false, ph, w, u - tiles, LU, nb, Uinv, nb, wu);
      }
      if (w * 2 < nb || ph == 0) grid.sync();
    }
  }
}

}  // namespace

// The grid for nb: co-resident blocks, capped at the widest phase's tiles
// (the first step's (nb/32 − 1)², the last doubling level's two lists).
extern "C" int slate_lu_inv_panel_plan(int nb, int* G) {
  const int m = nb / IB - 1;
  int want = m * m;
  const int dbl = nb >= 2 * IB ? 2 * doubling_tiles(nb, nb / 2) : 0;
  if (dbl > want) want = dbl;
  return tri_grid::plan_grid((const void*)lu_inv_panel_kernel, want, G);
}

// A: (nb, nb) with row stride lda.  LU, Linv, Uinv: contiguous (nb, nb)
// outputs.  W: scratch of nb² floats (the Schur complement, then the
// doublings' products).  nb a power of two ≥ 32.  G from the plan.
extern "C" int slate_lu_inv_panel_f32(const float* A, int64_t lda, float* LU,
                                      float* Linv, float* Uinv, float* W,
                                      int nb, int G, cudaStream_t stream) {
  if (nb < IB || (nb & (nb - 1)) != 0 || lda < nb || G < 1)
    return (int)cudaErrorInvalidValue;
  void* args[] = {&A, &lda, &LU, &Linv, &Uinv, &W, &nb};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)lu_inv_panel_kernel, dim3(G), dim3(NTH), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
