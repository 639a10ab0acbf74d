// fp64 C from int8 slice planes: the pair products and the fp64 combine of
// the Ozaki-style fp64 gemm (slate_tpu/ops/ozaki.py _chunk_matmul). It
// replaces no Pallas kernel: the JAX package computes the pairs with XLA
// int8 dots (preferred_element_type int32) and combines them with XLA
// elementwise ops. It is written by hand because no library call fuses the
// pair products with the fp64 diagonal combine and the exponent rescale.
//
// Inputs (ops/ozaki.py): UA, the nsl int8 planes of the row-scaled A, each
// (M, KP) with K fast; VB, the planes of the column-scaled B laid K-major,
// each (N, KP); ea (M) and eb (N), the integer-valued fp64 exponents; KP a
// multiple of 32, the slices zero past K. For each diagonal tot = 0 … nsl−1
// in ascending order:
//   1. the pairs (t, tot − t), t = 0 … tot, summed over K in ONE int32
//      accumulator — exact, since the caller keeps KP within _KMAX and
//      every product of two slices is at most 2¹² in magnitude;
//   2. that sum converted to fp64, times 2^(−6(tot+2)) (exact), added to
//      the fp64 tile.
// Then C = acc · 2^e1 · 2^(e − e1), e = ea[i] + eb[j], e1 = trunc(e/2)
// (ozaki._mul_pow2's half-split). Every fp64 operation is written out with
// its rounding (__dadd_rn, __dmul_rn) and in the plain version's order, so
// the result is bitwise ops/kernels.py ozaki_matmul_plain's, whose pair
// sums are exact fp64 products of the integer-valued planes. No flag here
// flushes subnormals (no --use_fast_math): the rescaled fp64 values may be
// subnormal.
//
// What bounds it on an H100: (nsl(nsl+1)/2)·2mnk int8 operations, 36
// passes at the default 8 slices, against 1,979 TOP/s, at the main paths'
// shapes; the planes are read once a pair from L2. This first kernel uses
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (wgmma and TMA are later
// work): 64 × 64 output tiles on 128 threads (4 warps of 32 × 32), the
// contraction of a diagonal streamed as (pair, 64-byte slab of K) through a
// ring of three cp.async stages, rows of 64 + 16 bytes so that the
// fragment reads hit distinct banks. Any M, N: rows past an edge are
// zero-filled and stores past it dropped.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 64, NT = 128, STAGES = 3;
constexpr int WM = 32, WN = 32, MI = WM / 16, NI = WN / 8;   // warps 2 × 2
constexpr int LD = BK + 16;          // bytes of a staged row
constexpr int SLAB = BM * LD;        // bytes of one operand's slab (BM == BN)
constexpr int CH = BM * BK / 16 / NT;   // 16-byte chunks a thread copies
static_assert(BM == BN, "A's and B's slabs share one staging rule");

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// d += a·b on one m16n8k32 int8 tile, int32 accumulate (exact: no
// saturation is asked for, and the sums stay below 2³¹)
__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// pair index p of the stream -> its diagonal tot and A's plane t (B's is
// tot − t); the pairs of diagonal tot are tot(tot+1)/2 … tot(tot+1)/2 + tot
__device__ __forceinline__ void pair_of(int p, int& tot, int& t) {
  tot = 0;
  while ((tot + 1) * (tot + 2) / 2 <= p) ++tot;
  t = p - tot * (tot + 1) / 2;
}

__global__ void __launch_bounds__(NT)
ozaki_matmul_kernel(const int8_t* __restrict__ UA, const int8_t* __restrict__ VB,
                    const double* __restrict__ ea, const double* __restrict__ eb,
                    double* __restrict__ C, int M, int N, int KP, int nsl) {
  __shared__ __align__(16) int8_t sm[STAGES][2][SLAB];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;   // the mma's groupID, thread in group
  const int wm = (warp % 2) * WM, wn = (warp / 2) * WN;
  const int64_t m0 = (int64_t)blockIdx.y * BM, n0 = (int64_t)blockIdx.x * BN;
  const int nks = (KP + BK - 1) / BK;           // slabs of one pair
  const int total = nsl * (nsl + 1) / 2 * nks;  // slabs of the whole stream

  // slab s of the stream into stage st: A's plane t and B's plane tot − t,
  // K from ks·BK; rows past M or N and K past KP zero-filled
  auto fetch = [&](int st, int s) {
    int tot, t;
    pair_of(s / nks, tot, t);
    const int k0 = (s % nks) * BK;
    const int8_t* a = UA + (int64_t)t * M * KP;
    const int8_t* b = VB + (int64_t)(tot - t) * N * KP;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = tid + i * NT;
      const int r = c / (BK / 16), k = c % (BK / 16) * 16;
      const bool kin = k0 + k < KP;
      const bool ain = kin && m0 + r < M, bin = kin && n0 + r < N;
      cp_async16(&sm[st][0][r * LD + k], ain ? a + (m0 + r) * KP + k0 + k : a,
                 ain ? 16 : 0);
      cp_async16(&sm[st][1][r * LD + k], bin ? b + (n0 + r) * KP + k0 + k : b,
                 bin ? 16 : 0);
    }
  };

  int acc[MI][NI][4];
  double out[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[i][j][q] = 0;
        out[i][j][q] = 0.0;
      }

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < total) fetch(st, st);
    cp_async_commit();
  }
  for (int s = 0; s < total; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // slab s is in; every warp is past slab s − 1
    if (s + STAGES - 1 < total) fetch((s + STAGES - 1) % STAGES, s + STAGES - 1);
    cp_async_commit();
    const int8_t* as = sm[s % STAGES][0];
    const int8_t* bs = sm[s % STAGES][1];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      // a0 … a3 at (m, k) = (g, 4t), (g + 8, 4t), (g, 4t + 16), (g + 8,
      // 4t + 16); b0, b1 at (k, n) = (4t, g), (4t + 16, g); four k a register
      uint32_t bf[NI][2];
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          bf[j][q] = *reinterpret_cast<const uint32_t*>(
              bs + (wn + j * 8 + g) * LD + kk + 4 * t4 + q * 16);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        uint32_t af[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          af[q] = *reinterpret_cast<const uint32_t*>(
              as + (wm + i * 16 + g + (q & 1) * 8) * LD + kk + 4 * t4 + (q >> 1) * 16);
#pragma unroll
        for (int j = 0; j < NI; ++j) mma(acc[i][j], af, bf[j]);
      }
    }
    // the diagonal's last slab: its int32 sum into the fp64 tile
    int tot, t;
    pair_of(s / nks, tot, t);
    if (t == tot && s % nks == nks - 1) {
      const double w = ldexp(1.0, -6 * (tot + 2));
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            out[i][j][q] = __dadd_rn(out[i][j][q], __dmul_rn((double)acc[i][j][q], w));
            acc[i][j][q] = 0;
          }
    }
  }

  // c0, c1 at (g, 2t + 0/1), c2, c3 eight rows below: the rescale
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = m0 + wm + i * 16 + g + h * 8;
        if (row >= M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int64_t col = n0 + wn + j * 8 + 2 * t4 + e;
          if (col >= N) continue;
          const double ex = __dadd_rn(ea[row], eb[col]);
          const double e1 = trunc(__dmul_rn(ex, 0.5));
          C[row * N + col] = __dmul_rn(__dmul_rn(out[i][j][2 * h + e], exp2(e1)),
                                       exp2(__dsub_rn(ex, e1)));
        }
      }
}

}  // namespace

// UA: nsl contiguous (M, KP) int8 planes; VB: nsl contiguous (N, KP) int8
// planes; ea (M), eb (N) fp64; C a contiguous (M, N) fp64 output. KP a
// multiple of 32 and at most 2^(31 − 12 − ⌈log2 nsl⌉) (the exact int32
// sums), 1 ≤ nsl ≤ 9. Returns the CUDA error of the launch.
extern "C" int slate_ozaki_matmul(const int8_t* UA, const int8_t* VB, const double* ea,
                                  const double* eb, double* C, int M, int N, int KP,
                                  int nsl, cudaStream_t stream) {
  int lg = 1;
  while ((1 << lg) < nsl) ++lg;
  if (M <= 0 || N <= 0 || KP <= 0 || KP % 32 || nsl < 1 || nsl > 9 ||
      (int64_t)KP > ((int64_t)1 << (31 - 12 - lg)))
    return (int)cudaErrorInvalidValue;
  ozaki_matmul_kernel<<<dim3((N + BN - 1) / BN, (M + BM - 1) / BM), NT, 0, stream>>>(
      UA, VB, ea, eb, C, M, N, KP, nsl);
  return (int)cudaGetLastError();
}
