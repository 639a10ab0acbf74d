// Inverse of a lower non-unit (nb, nb) triangle in one launch: the port of
// the Pallas kernel `trtri_panel` (slate_tpu/ops/pallas_kernels.py:560-588):
// per-ib forward-substitution inverses of the diagonal blocks, then the
// recursive-doubling assembly.  It shares its device code with
// potrf_batched.cu and potrf_step.cuh (tri_panel.cuh).
//
// What bounds it on an H100: ~nb³/3 FLOP (5.6 MFLOP at nb = 256, the
// potri diagonal tiles) over 0.4 MB of inputs and outputs: at the card's
// peaks it is bound by bytes and takes ~0.1 µs, but one block on one SM
// does the whole chain (see tri_panel.cuh), so in practice one SM's FFMA
// rate and the launch bound it.  The block inverses run on one warp each
// in shared memory; the doubling products are 128×128-tiled block_gemm
// calls that skip the zero slabs of the triangular factors.
//
// Reads only the lower triangle of the input, and zeroes the whole
// inverse before the doubling, which needs clean zeros outside the
// diagonal blocks (the reference's pallas_kernels.py:561).

#include "tri_panel.cuh"

namespace {

using namespace tri_panel;

__global__ void __launch_bounds__(NTH, 1)
trtri_panel_kernel(const float* L, int64_t ldl, float* Linv, float* W, int nb) {
  __shared__ __align__(16) Smem s;
  const int tid = threadIdx.x;
  const int64_t nn = (int64_t)nb * nb;
  for (int64_t e = tid; e < nn; e += NTH) Linv[e] = 0.f;
  __syncthreads();
  for (int k0 = 0; k0 < nb; k0 += IB) {
    if (tid < 32) {
      load_lower_block_warp(s, L + (int64_t)k0 * ldl + k0, ldl);
      trtri_unblocked_warp(s);
    }
    __syncthreads();
    const int r = tid / IB, c = tid % IB;
    Linv[(int64_t)(k0 + r) * nb + k0 + c] = s.inv[r][c];
    __syncthreads();
  }
  block_inv_doubling(s, L, ldl, Linv, nb, W, nb);
}

}  // namespace

// L: (nb, nb) lower triangle with row stride ldl (only i ≥ j is read).
// Linv: contiguous (nb, nb) output.  W: scratch of (nb/2)² floats.
// nb a power of two ≥ 32.
extern "C" int slate_trtri_panel_f32(const float* L, int64_t ldl, float* Linv,
                                     float* W, int nb, cudaStream_t stream) {
  if (nb < IB || (nb & (nb - 1)) != 0 || ldl < nb)
    return (int)cudaErrorInvalidValue;
  trtri_panel_kernel<<<1, NTH, 0, stream>>>(L, ldl, Linv, W, nb);
  return (int)cudaGetLastError();
}
