// Per-tile partial norms of an (nt, mb, nb) tile batch: the port of the
// Pallas kernel `tile_norms` (slate_tpu/ops/pallas_kernels.py:133-162,
// `_norm_max_kernel` / `_norm_fro_kernel`): out[t] = max|x| over tile t,
// or Σx² over it (unsquared, in the tile's dtype; the caller reduces
// across tiles and takes the root).
//
// What bounds it on an H100: bytes, nt·mb·nb elements read once (one
// flop or compare each).  The TPU grid runs one tile a step; here ONE
// BLOCK OWNS ONE TILE: its 256 threads stride over the tile's mb·nb
// contiguous elements (a warp reads 128 contiguous bytes in fp32), each
// keeps a private max or sum, then a warp-shuffle and a shared-memory
// step reduce the block.  The max propagates NaN as jnp.max does, where
// fmaxf/fmax would drop it: a tile holding a NaN gives NaN.  The max is
// exact in any order, so it equals its plain version bitwise; the sum's
// order differs from the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a || a > b) ? a : b;   // a NaN in either operand wins
}

__device__ __forceinline__ float abs_of(float v) { return fabsf(v); }
__device__ __forceinline__ double abs_of(double v) { return fabs(v); }

template <typename T, bool FRO>
__device__ __forceinline__ T combine(T a, T b) {
  return FRO ? a + b : nan_max(a, b);
}

template <typename T, bool FRO>
__global__ void __launch_bounds__(NT)
tile_norms_kernel(const T* __restrict__ x, T* __restrict__ out,
                  int64_t tile) {
  __shared__ T part[NT / 32];
  const T* p = x + (int64_t)blockIdx.x * tile;
  T acc = 0;
  for (int64_t e = threadIdx.x; e < tile; e += NT) {
    const T v = p[e];
    acc = FRO ? acc + v * v : nan_max(acc, abs_of(v));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc = combine<T, FRO>(acc, __shfl_down_sync(0xffffffffu, acc, o));
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < NT / 32 ? part[lane] : T(0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc = combine<T, FRO>(acc, __shfl_down_sync(0xffffffffu, acc, o));
    if (lane == 0) out[blockIdx.x] = acc;
  }
}

template <typename T>
int launch(const T* x, T* out, int nt, int64_t tile, int fro,
           cudaStream_t stream) {
  if (nt <= 0 || tile <= 0) return (int)cudaErrorInvalidValue;
  if (fro)
    tile_norms_kernel<T, true><<<nt, NT, 0, stream>>>(x, out, tile);
  else
    tile_norms_kernel<T, false><<<nt, NT, 0, stream>>>(x, out, tile);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (nt, mb, nb) contiguous, tile = mb·nb; out: (nt,).  fro = 0 for the
// max-abs partials, 1 for the sums of squares.
extern "C" int slate_tile_norms_f32(const float* x, float* out, int nt,
                                    int64_t tile, int fro,
                                    cudaStream_t stream) {
  return launch<float>(x, out, nt, tile, fro, stream);
}

extern "C" int slate_tile_norms_f64(const double* x, double* out, int nt,
                                    int64_t tile, int fro,
                                    cudaStream_t stream) {
  return launch<double>(x, out, nt, tile, fro, stream);
}
