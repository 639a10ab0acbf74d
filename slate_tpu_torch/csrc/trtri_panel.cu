// Inverse of a lower non-unit (nb, nb) triangle in one launch: the port of
// the Pallas kernel `trtri_panel` (slate_tpu/ops/pallas_kernels.py:571,
// body :560): per-ib forward-substitution inverses of the diagonal blocks,
// then the recursive-doubling assembly (_trtri_unblocked,
// _block_inv_doubling).  Its callers: the trtri recursion at n ≤ nb
// (ops/blocks.py), the T block of each CholQR² panel of geqrf
// (linalg/qr.py, nb = 512) and pgesv's L11 (parallel/dist_lu.py, 256).
//
// What bounds it on an H100: ~nb³/3 FLOP (4.5e7 at nb = 512) over 1.5 MB
// of inputs and outputs: at the card's peaks a microsecond, so latency
// bounds it: the nb/32 diagonal inverses (a dependent chain of 32 steps
// each) and log2(nb/32) doubling levels of two dependent products.  So the
// work is spread over many SMs (tri_grid.cuh):
//   * the diagonal 32 × 32 inverses go one warp each over the blocks
//     (lower_inv_warp: the substitution in registers, rounded as
//     tri_panel.cuh's trtri_unblocked_warp rounds it), all at once;
//   * each doubling product's 32 × 32 tiles go over the blocks, with a
//     barrier after each product (2·log2(nb/32) − 1 in all, the last
//     product ends the launch).
// The barrier is a cooperative grid's grid.sync() (trtri_panel_kernel),
// or for at most MAX_CLUSTER blocks the hardware barrier of one
// thread-block cluster (trtri_panel_cluster_kernel).  The wrapper picks
// (ops/kernels.py TRTRI_CLUSTER_NB): the cluster up to nb = 256, where the
// barriers' cost tells and 16 blocks hold every phase, the grid above,
// where the last levels' products want more blocks than a cluster has.
// The products' sums are tile_gemm's ascending fmaf sums from zero, which
// skip only slabs of stored zeros: the rounding of the reference's
// _block_inv_doubling (slate_tpu/ops/pallas_kernels.py:340).  FFMA in full
// fp32.
//
// Reads only the lower triangle of the input; the output has exact zeros
// above its diagonal.

#include "tri_grid.cuh"

namespace {

using namespace tri_grid;

// warps of a block that invert diagonal blocks, each with its own two
// 32 × 33 blocks of shared memory
constexpr int INV_WARPS = SMEM_FLOATS / (2 * IB * LDB);
// the most blocks of one cluster (16 needs the non-portable size)
constexpr int MAX_CLUSTER = 16;

// L⁻¹ by the whole grid (Group: the cooperative grid or the one cluster
// the launch is).  Ends with no barrier.
template <class Group>
__device__ void trtri_grid(Group& grid, float* sm, const float* L, int64_t ldl,
                           float* Linv, float* W, int nb) {
  const int g = blockIdx.x, G = gridDim.x, tid = threadIdx.x;
  const int nt = nb / IB;
  // the blocks above the diagonal blocks; the doubling writes those below
  const int64_t nn = (int64_t)nb * nb;
  for (int64_t e = (int64_t)g * NTH + tid; e < nn; e += (int64_t)G * NTH)
    if ((int)(e % nb) / IB > (int)(e / nb) / IB) Linv[e] = 0.f;
  // the diagonal inverses, warp v of block g taking blocks g + (v + k·4)·G
  const int v = tid / 32, c = tid % 32;
  if (v < INV_WARPS) {
    float* a = sm + v * 2 * IB * LDB;
    float* x = a + IB * LDB;
    for (int d = g + v * G; d < nt; d += INV_WARPS * G) {
      const float* ld = L + (int64_t)d * IB * (ldl + 1);
#pragma unroll 4
      for (int r = 0; r < IB; ++r) a[r * LDB + c] = c <= r ? __ldcg(ld + (int64_t)r * ldl + c) : 0.f;
      __syncwarp();
      lower_inv_warp(a, x, false);
      float* out = Linv + (int64_t)d * IB * (nb + 1);
#pragma unroll 4
      for (int r = 0; r < IB; ++r) out[(int64_t)r * nb + c] = x[r * LDB + c];
      __syncwarp();
    }
  }
  grid.sync();
  // L⁻¹ by recursive doubling
  for (int w = IB; w < nb; w *= 2) {
    const int tiles = doubling_tiles(nb, w);
    for (int ph = 0; ph < 2; ++ph) {
      for (int u = g; u < tiles; u += G)
        doubling_tile_t<true>(sm, ph, w, u, L, ldl, Linv, nb, W);
      if (w * 2 < nb || ph == 0) grid.sync();
    }
  }
}

// The most tiles a phase hands out: the diagonal inverses or the last
// doubling level's products.
int widest(int nb) {
  const int nt = nb / IB, dbl = nb >= 2 * IB ? doubling_tiles(nb, nb / 2) : 0;
  return nt > dbl ? nt : dbl;
}

// One block an SM: the widest phase at nb = 512 has 64 tiles.
__global__ void __launch_bounds__(NTH, 1)
trtri_panel_cluster_kernel(const float* L, int64_t ldl, float* Linv, float* W, int nb) {
  __shared__ __align__(16) float sm[SMEM_FLOATS];
  cg::cluster_group grid = cg::this_cluster();
  trtri_grid(grid, sm, L, ldl, Linv, W, nb);
}

__global__ void __launch_bounds__(NTH, 1)
trtri_panel_kernel(const float* L, int64_t ldl, float* Linv, float* W, int nb) {
  __shared__ __align__(16) float sm[SMEM_FLOATS];
  cg::grid_group grid = cg::this_grid();
  trtri_grid(grid, sm, L, ldl, Linv, W, nb);
}

}  // namespace

// The launch for nb: cluster = 1 asks for one cluster of up to MAX_CLUSTER
// blocks (capped at the widest phase's tiles), 0 for a cooperative grid of
// co-resident blocks (capped the same way).  G: its blocks.  Returns a CUDA
// error code; a cluster the card cannot schedule is an error, never a
// fallback.
extern "C" int slate_trtri_panel_plan(int nb, int cluster, int* G) {
  if (nb < IB || (nb & (nb - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (!cluster) return plan_grid((const void*)trtri_panel_kernel, widest(nb), G);
  const int want = widest(nb) < MAX_CLUSTER ? widest(nb) : MAX_CLUSTER;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)trtri_panel_cluster_kernel,
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = want;
  attr[0].val.clusterDim.y = attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(want);
  cfg.blockDim = dim3(NTH);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int nclusters = 0;
  err = cudaOccupancyMaxActiveClusters(&nclusters, (const void*)trtri_panel_cluster_kernel,
                                       &cfg);
  if (err != cudaSuccess) return (int)err;
  if (nclusters < 1) return (int)cudaErrorLaunchOutOfResources;
  *G = want;
  return 0;
}

// L: (nb, nb) lower triangle with row stride ldl (only i ≥ j is read).
// Linv: contiguous (nb, nb) output.  W: scratch of (nb/2)² floats.  nb a
// power of two ≥ 32.  G and cluster from the plan.
extern "C" int slate_trtri_panel_f32(const float* L, int64_t ldl, float* Linv,
                                     float* W, int nb, int G, int cluster,
                                     cudaStream_t stream) {
  if (nb < IB || (nb & (nb - 1)) != 0 || ldl < nb || G < 1 ||
      (cluster && G > MAX_CLUSTER))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (cluster) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = G;
    attr[0].val.clusterDim.y = attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(G);
    cfg.blockDim = dim3(NTH);
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, trtri_panel_cluster_kernel, L, ldl, Linv, W, nb);
  } else {
    void* args[] = {&L, &ldl, &Linv, &W, &nb};
    err = cudaLaunchCooperativeKernel((const void*)trtri_panel_kernel, dim3(G),
                                      dim3(NTH), args, 0, stream);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
