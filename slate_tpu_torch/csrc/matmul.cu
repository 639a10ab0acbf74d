// C = A·B in fp32 with fp32 accumulation: the port of the Pallas kernel
// `matmul` (slate_tpu/ops/pallas_kernels.py:78-129), which accumulates at
// Precision.HIGHEST in VMEM over a (M/bm, N/bn, K/bk) grid.
//
// What bounds it on an H100: at the main path's shapes (K = 512, M and N
// in the thousands) it does ~100-500 FLOP per byte it must move, far
// above the fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte), so it
// is bound by the fp32 FFMA rate.  TF32 tensor cores would be faster but keep
// ~1e-3 relative error, which fails the 3·eps residual gates, so this is
// an FFMA kernel: 128×128 output tile per 256-thread block, each thread an
// 8×8 register block (64 FFMA per 4 shared-memory vector loads), K staged
// through shared memory 16 at a time.  Operands arrive as transposed views
// (L21ᵀ in the strip update), so each operand takes a row and a column
// stride and the tile loader walks the unit-stride dimension across
// neighbouring threads; nothing is copied to make it contiguous.  No
// double buffering, no cp.async/TMA, no wgmma: a first, simple kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 16, NT = 256, PAD = 4;

__global__ void __launch_bounds__(NT)
matmul_f32_kernel(const float* __restrict__ A, int64_t sam, int64_t sak,
                  const float* __restrict__ B, int64_t sbk, int64_t sbn,
                  float* __restrict__ C, int N, int K) {
  __shared__ __align__(16) float As[BK][BM + PAD];   // As[k][m]
  __shared__ __align__(16) float Bs[BK][BN + PAD];   // Bs[k][n]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t m0 = (int64_t)blockIdx.y * BM, n0 = (int64_t)blockIdx.x * BN;
  const bool a_kfast = (sak == 1);
  const bool b_nfast = (sbn == 1);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / NT; ++i) {
      const int e = tid + i * NT;
      int m, k;
      if (a_kfast) { k = e % BK; m = e / BK; } else { m = e % BM; k = e / BM; }
      As[k][m] = A[(m0 + m) * sam + (int64_t)(k0 + k) * sak];
    }
#pragma unroll
    for (int i = 0; i < (BN * BK) / NT; ++i) {
      const int e = tid + i * NT;
      int k, n;
      if (b_nfast) { n = e % BN; k = e / BN; } else { k = e % BK; n = e / BK; }
      Bs[k][n] = B[(int64_t)(k0 + k) * sbk + (n0 + n) * sbn];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    float* crow = C + row * N + n0;
    *reinterpret_cast<float4*>(crow + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(crow + 64 + tx * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

}  // namespace

// A is (M, K) with strides (sam, sak), B is (K, N) with strides (sbk, sbn),
// both in elements; C is a contiguous (M, N) output.  M and N must be
// multiples of 128 and K of 16.  Returns the CUDA error of the launch.
extern "C" int slate_matmul_f32(const float* A, int64_t sam, int64_t sak,
                                const float* B, int64_t sbk, int64_t sbn,
                                float* C, int M, int N, int K,
                                cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M % BM || N % BN || K % BK)
    return (int)cudaErrorInvalidValue;
  dim3 grid(N / BN, M / BM);
  matmul_f32_kernel<<<grid, NT, 0, stream>>>(A, sam, sak, B, sbk, sbn, C, N, K);
  return (int)cudaGetLastError();
}
