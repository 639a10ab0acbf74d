// The whole right-looking Cholesky factorization of the (n, n) carry in
// ONE launch, IN PLACE: the port of the Pallas kernel `potrf_full_fused`
// (slate_tpu/ops/pallas_kernels.py:1738, body _potrf_full_fused_kernel
// :1676, phases _potrf_panel_phase and _potrf_trailing_stream :1542-1601).
// It is the `full` depth of the Cholesky driver
// (slate_tpu_torch/ops/blocks.py:potrf_full): one launch per posv.
//
// The function is the chain of potrf_step_fused.cu's steps for k0 = 0, nb,
// 2·nb, …, with the carry contract of potrf_step.cuh (the diagonal block
// becomes L11 with zeros above it, the rows below it L21 = A21·L11⁻ᵀ, the
// trailing (tc, tc) tile pairs on and below the diagonal lose L21_i·L21_jᵀ,
// the rest passes through), and it rounds every element as that chain
// does: the two depths give the same factor, bit for bit.
//
// What bounds it on an H100: n³/3 fp32 FLOP (1.8e11 at n = 8192) over a
// 0.27 GB carry: bound by operations at ~2.7 ms.  Each step is three
// phases of one cooperative grid of 256-thread blocks (tri_grid.cuh), one
// an SM (at two, 128 registers, the 128 × 128 tile spills), separated by
// grid.sync():
//   A. (L11, L11⁻¹) of the diagonal block by the whole grid
//      (chol_inv_grid: its 32 × 32 trailing tiles over the blocks, one grid
//      barrier a 32-step, then the doubling's tiles), into scratch;
//   B. L11 into the carry, and L21 = A21·L11⁻ᵀ in 128 × 128 tile_gemm tiles
//      (8 × 8 fragments, two slab buffers; L11⁻ᵀ read as the transpose of
//      L11⁻¹, its zero slabs skipped) into a scratch (n, nb) copy: in place
//      would race, since a tile's rows are read by the other tiles of its
//      row;
//   C. L21 into the carry's block column, and the trailing update, 128 ×
//      128 tiles of the lower (tc, tc) pairs, each C − L21_I·L21_Jᵀ with
//      K = nb read from the copy, block column k + 1's tiles first (the TPU
//      kernel's look-ahead order).
// Each element's sum runs over k ascending by fmaf from zero and the
// epilogues are c − Σ and Σ, as in potrf_step.cuh's block_gemm; slabs of
// stored zeros are skipped, which changes no sum.  Overlapping the next
// diagonal factor with the rest of the update (flags per tile column in
// place of the grid barrier) is later work.  Every global read is __ldcg.
// FFMA in full fp32; no library call.

#include "tri_grid.cuh"

namespace {

using namespace tri_grid;

constexpr int T = 128;   // the L21 and trailing tile edge

struct Params {
  float* a;        // (n, n) carry, row stride ld
  int64_t ld;
  float* lkk;      // (nb, nb) scratch: L11
  float* linv;     // (nb, nb) scratch: L11⁻¹
  float* s;        // nb² floats: chol_inv_grid's scratch
  float* l21;      // (n - nb, nb) scratch: L21, row r - (k0 + nb)
  int n, nb, tc;
};

// Shapes the kernel takes: nb a power of two ≥ 128, tc a multiple of 128
// dividing nb, nb dividing n, row stride ≥ n.
bool shape_ok(const Params& p) {
  return p.nb >= T && (p.nb & (p.nb - 1)) == 0 && p.tc >= T && p.tc % T == 0 &&
         p.nb % p.tc == 0 && p.n >= p.nb && p.n % p.nb == 0 && p.ld >= p.n;
}

// Trailing tiles of nrt × nrt at tile pair height per: column J holds the
// tiles I ≥ (J / per)·per.
__host__ __device__ inline int trailing_tiles(int nrt, int per) {
  int total = 0;
  for (int J = 0; J < nrt; ++J) total += nrt - J / per * per;
  return total;
}

// Tile u of that list, column by column (so block column k + 1 first).
__device__ inline void trailing_tile(int u, int nrt, int per, int& I, int& J) {
  J = 0;
  for (int c = nrt; u >= c; c = nrt - J / per * per) {
    u -= c;
    ++J;
  }
  I = J / per * per + u;
}

__global__ void __launch_bounds__(NTH, 1) potrf_full_fused_kernel(Params p) {
  __shared__ __align__(16) float sm[SMEM_FLOATS];
  cg::grid_group grid = cg::this_grid();
  const int g = blockIdx.x, G = gridDim.x, tid = threadIdx.x;
  const int n = p.n, nb = p.nb, per = p.tc / T;
  const int64_t ld = p.ld;
  for (int k0 = 0; k0 < n; k0 += nb) {
    float* akk = p.a + (int64_t)k0 * ld + k0;
    // A. the diagonal block, by the whole grid
    chol_inv_grid(sm, grid, akk, ld, p.lkk, p.linv, p.s, nb);
    grid.sync();

    // B. L11 into the carry; L21 = A21·L11⁻ᵀ: B(k, j) = L11⁻¹[j, k], zero
    //    for k > j
    for (int64_t e = (int64_t)g * NTH + tid; e < (int64_t)nb * nb; e += (int64_t)G * NTH)
      akk[(e / nb) * ld + e % nb] = __ldcg(p.lkk + e);
    const int r0 = k0 + nb, nt = n - r0;
    if (nt == 0) break;
    // (the tiles of column ct run ct + 1 slabs of 128: the widest first)
    const int nrt = nt / T, nct = nb / T;
    float* l21 = p.l21;
    for (int u = g; u < nrt * nct; u += G)
      tile_gemm<T, T, FULL, UPPER, false, true>(
          sm, u % nrt * T, (nct - 1 - u / nrt) * T, nt, nb, nb, p.a + (int64_t)r0 * ld + k0,
          ld, p.linv, nb, [&](int i, int j, float v) { l21[(int64_t)i * nb + j] = v; });
    grid.sync();

    // C. L21 into the carry's block column, and the trailing tiles whose
    //    (tc, tc) pair lies on or below the diagonal
    for (int64_t e = (int64_t)g * NTH + tid; e < (int64_t)nt * nb; e += (int64_t)G * NTH)
      p.a[(r0 + e / nb) * ld + k0 + e % nb] = __ldcg(l21 + e);
    float* c = p.a + (int64_t)r0 * ld + r0;
    const int tiles = trailing_tiles(nrt, per);
    for (int u = g; u < tiles; u += G) {
      int I, J;
      trailing_tile(u, nrt, per, I, J);
      tile_gemm<T, T, FULL, FULL, false, true>(
          sm, I * T, J * T, nt, nt, nb, l21, nb, l21, nb, [&](int i, int j, float v) {
            float* x = c + (int64_t)i * ld + j;
            *x = __ldcg(x) - v;
          });
    }
    grid.sync();
  }
}

}  // namespace

// Static shared memory of one block (ops/smem.py checks its formula
// against this when the library loads).
extern "C" int64_t slate_potrf_full_fused_smem_bytes() {
  return (int64_t)sizeof(float) * SMEM_FLOATS;
}

// The grid for (n, nb, tc): co-resident blocks, capped at the widest
// phase's tiles (the diagonal block's, or the first step's L21 or trailing
// tiles).
extern "C" int slate_potrf_full_fused_plan(int n, int nb, int tc, int* G) {
  const int nrt = (n - nb) / T;
  int want = chol_inv_grid_tiles(nb);
  if (nrt * (nb / T) > want) want = nrt * (nb / T);
  if (tc >= T && trailing_tiles(nrt, tc / T) > want) want = trailing_tiles(nrt, tc / T);
  return plan_grid((const void*)potrf_full_fused_kernel, want, G);
}

// a: (n, n) carry with row stride ld, updated in place.  lkk, linv: (nb,
// nb) scratch; s: nb² floats; l21: (n - nb)·nb floats (at least one
// float).  G from the plan.
extern "C" int slate_potrf_full_fused_f32(float* a, int64_t ld, float* lkk,
                                          float* linv, float* s, float* l21,
                                          int n, int nb, int tc, int G,
                                          cudaStream_t stream) {
  Params p{a, ld, lkk, linv, s, l21, n, nb, tc};
  if (!shape_ok(p) || G < 1) return (int)cudaErrorInvalidValue;
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)potrf_full_fused_kernel, dim3(G), dim3(NTH), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
