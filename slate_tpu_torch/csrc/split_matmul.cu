// fp32 C = Σ pairs sᵢ(A)·sⱼ(B) from bf16 slice planes: the products of the
// split-precision fp32 gemm (slate_tpu/ops/split_gemm.py). It replaces no
// Pallas kernel: the JAX package computes these pairs with XLA dots of
// K-folded concatenations (matmul_sliced3 / matmul_sliced6). It is written
// by hand because the slice-pair structure is the function being ported
// and a library bf16 product rounds its output to bf16.
//
// Each operand arrives as three bf16 planes s0, s1, s2 of one shape and one
// set of strides (ops/split_gemm.py split_slices). Every product of two
// slices has at most 16 significant bits, so it is exact in fp32 and only
// the sums round.
//
//   split3: s0a·s0b + s0a·s1b + s1a·s0b into one fp32 accumulator (planes
//           0 and 1 of each operand are read);
//   split6: the diagonals i + j = 0, 1, 2 into three accumulators d0, d1,
//           d2, returned as (d2 + d1) + d0.
//
// What bounds it on an H100: at the main paths' shapes it does hundreds of
// operations per byte it must move, so it is bound by the bf16 tensor
// cores, 3 (or 6) passes of 2mnk at 989 TFLOP/s. This first kernel uses
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (wgmma and TMA are
// later work). The products of one 32-deep slab run into a zeroed
// fragment, which fp32 adds (round to nearest) then take into the
// accumulator: the tensor core's own accumulation truncates, and a sum
// carried in it over all of K drifts (csrc/matmul.cu found that for TF32).
//
// The tiling follows csrc/matmul.cu: 256 threads, 8 warps as 2 × 4, K in
// slabs of 32 through a ring of three shared stages, each operand staged in
// the layout it arrives in (K-fast [r][32 + 8] or row-fast [32][R + 8]
// bf16, padded so that the fragment reads hit distinct banks), by
// cp.async.cg 16-byte copies where every plane has a unit stride along the
// staged dimension, a row stride that is a multiple of 8 and a 16-byte
// aligned base, and for any other view by loads into registers stored at
// once (the ragged shapes' route: no overlap of load and multiply). split3
// takes 128 × 128 output tiles (warps of 64 × 32); split6 keeps three
// accumulators, so it takes 64 × 128 tiles (warps of 32 × 32) rather than
// spill. Any M, N, K ≥ 1: copies past an edge are zero-filled and stores
// past it are dropped.
//
// Split-K: where the output has fewer tiles than the card has SMs the
// wrapper (ops/kernels.py matmul_splits) cuts K into s parts of `per`
// slabs; part z writes its fp32 partial tile to W[z] and a second kernel
// sums the parts in order z = 0, 1, …, the same from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128, BK = 32, NT = 256, STAGES = 3;
constexpr int WN = 32, NI = WN / 8;   // a warp's columns: 4 mma tiles
constexpr int LDK = BK + 8;           // K-fast slab row, bf16

template <int G>
struct Grade {
  static constexpr int P = G == 3 ? 2 : 3;    // planes read of each operand
  static constexpr int BM = G == 3 ? 128 : 64;
  static constexpr int WM = BM / 2;           // warps 2 (rows) × 4 (columns)
  static constexpr int MI = WM / 16;          // a warp's row tiles
};

// bf16 elements of one staged slab of R rows, the larger of its layouts
template <int R>
__host__ __device__ constexpr int slab_elems() {
  return R * LDK > BK * (R + 8) ? R * LDK : BK * (R + 8);
}

template <int G>
constexpr int smem_bytes() {
  return STAGES * Grade<G>::P * (slab_elems<Grade<G>::BM>() + slab_elems<BN>()) * 2;
}

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

// d += a·b on one m16n8k16 bf16 tile, fp32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One operand's planes as the kernel reads them: Op(r, k) = p[r·sr + k·sk],
// r the row of the output it feeds (m for A, n for B), `rows` its extent.
// KF: staged K-fast. R: the rows of a slab.
template <bool KF, int R>
struct Operand {
  const uint16_t* p[3];
  int64_t sr, sk;
  int rows;
  static constexpr int LDR = R + 8;
  static constexpr int CH = R * BK / 8 / NT;   // 8-element chunks a thread copies

  // chunk c of the slab: its row/k origin and its place in shared memory
  __device__ __forceinline__ void chunk(int c, int& r, int& k, int& at) const {
    if (KF) { r = c / (BK / 8); k = c % (BK / 8) * 8; at = r * LDK + k; }
    else { k = c / (R / 8); r = c % (R / 8) * 8; at = k * LDR + r; }
  }
  // plane `pl` of the slab at (r0, k0) by cp.async, zero-filled past the
  // edges (unit stride along the staged dimension)
  __device__ __forceinline__ void copy(uint16_t* s, int pl, int64_t r0, int k0,
                                       int K) const {
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      int r, k, at;
      chunk(threadIdx.x + i * NT, r, k, at);
      const int64_t rr = r0 + r;
      const int kk = k0 + k;
      const int64_t left = KF ? (rr < rows ? (int64_t)K - kk : 0)
                              : (kk < K ? (int64_t)rows - rr : 0);
      const int n = left <= 0 ? 0 : left >= 8 ? 8 : (int)left;
      cp_async16(s + at, n ? (const void*)(p[pl] + rr * sr + (int64_t)kk * sk)
                           : (const void*)p[pl], 2 * n);
    }
  }
  // plane `pl` of the slab into registers (any strides), zero past the edges
  __device__ __forceinline__ void load(uint16_t (&v)[CH][8], int pl, int64_t r0,
                                       int k0, int K) const {
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      int r, k, at;
      chunk(threadIdx.x + i * NT, r, k, at);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int64_t rr = r0 + (KF ? r : r + e);
        const int kk = k0 + (KF ? k + e : k);
        v[i][e] = rr < rows && kk < K ? __ldg(p[pl] + rr * sr + (int64_t)kk * sk)
                                      : (uint16_t)0;
      }
    }
  }
  __device__ __forceinline__ void store(uint16_t* s, const uint16_t (&v)[CH][8]) const {
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      int r, k, at;
      chunk(threadIdx.x + i * NT, r, k, at);
      uint4 w;
      w.x = v[i][0] | (uint32_t)v[i][1] << 16;
      w.y = v[i][2] | (uint32_t)v[i][3] << 16;
      w.z = v[i][4] | (uint32_t)v[i][5] << 16;
      w.w = v[i][6] | (uint32_t)v[i][7] << 16;
      *reinterpret_cast<uint4*>(s + at) = w;
    }
  }
  // Op(r, k) and Op(r, k + 1) of a staged slab, k even, as one register
  // (the lower half the smaller k, as the mma reads it)
  __device__ __forceinline__ uint32_t pair(const uint16_t* s, int r, int k) const {
    if (KF) return *reinterpret_cast<const uint32_t*>(s + r * LDK + k);
    return s[k * LDR + r] | (uint32_t)s[(k + 1) * LDR + r] << 16;
  }
};

// The block's tile of part blockIdx.z: slabs [z·per, min((z+1)·per, ⌈K/BK⌉)).
// out: C (one part) or the part's slice of W, row stride N.
template <int G, bool ASYNC, bool AKF, bool BKF>
__global__ void __launch_bounds__(NT, 1)
split_matmul_kernel(Operand<AKF, Grade<G>::BM> A, Operand<BKF, BN> B, float* out,
                    int M, int N, int K, int per) {
  using GR = Grade<G>;
  constexpr int BM = GR::BM, WM = GR::WM, MI = GR::MI, P = GR::P;
  constexpr int SA = slab_elems<BM>(), SB = slab_elems<BN>();
  constexpr int STAGE = P * (SA + SB);
  extern __shared__ __align__(16) uint16_t sm[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;   // the mma's groupID, thread in group
  const int wm = (warp % 2) * WM, wn = (warp / 2) * WN;
  const int64_t m0 = (int64_t)blockIdx.y * BM, n0 = (int64_t)blockIdx.x * BN;
  const int slabs = (K + BK - 1) / BK;
  const int s0 = blockIdx.z * per;
  const int ns = min(slabs, s0 + per) - s0;
  out += (int64_t)blockIdx.z * M * N;

  // split3 uses acc[0]; split6 acc[d] for the diagonal i + j = d
  constexpr int NACC = G == 3 ? 1 : 3;
  float acc[NACC][MI][NI][4];
#pragma unroll
  for (int d = 0; d < NACC; ++d)
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[d][i][j][q] = 0.f;

  auto sa = [&](int st, int pl) { return sm + st * STAGE + pl * SA; };
  auto sb = [&](int st, int pl) { return sm + st * STAGE + P * SA + pl * SB; };
  // the slab into stage st: by cp.async (ASYNC), else plane by plane
  // through registers and stored at once
  auto fetch = [&](int st, int slab) {
    const int k0 = (s0 + slab) * BK;
#pragma unroll
    for (int pl = 0; pl < P; ++pl) {
      if constexpr (ASYNC) {
        A.copy(sa(st, pl), pl, m0, k0, K);
        B.copy(sb(st, pl), pl, n0, k0, K);
      } else {
        uint16_t ra[Operand<AKF, BM>::CH][8], rb[Operand<BKF, BN>::CH][8];
        A.load(ra, pl, m0, k0, K);
        B.load(rb, pl, n0, k0, K);
        A.store(sa(st, pl), ra);
        B.store(sb(st, pl), rb);
      }
    }
  };

  // fragments of plane pl at k step kk: a0 … a3 at (m, k) = (g, 2t),
  // (g + 8, 2t), (g, 2t + 8), (g + 8, 2t + 8); b0, b1 at (k, n) = (2t, g),
  // (2t + 8, g), each two consecutive k
  auto frag_a = [&](int st, int pl, int i, int kk, uint32_t (&a)[4]) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      a[q] = A.pair(sa(st, pl), wm + i * 16 + g + (q & 1) * 8, kk + 2 * t + (q >> 1) * 8);
  };
  auto frag_b = [&](int st, int pl, int j, int kk, uint32_t (&b)[2]) {
#pragma unroll
    for (int q = 0; q < 2; ++q) b[q] = B.pair(sb(st, pl), wn + j * 8 + g, kk + 2 * t + q * 8);
  };

  // the slab of stage st into zeroed fragments, then added to the
  // accumulators (round to nearest)
  auto multiply = [&](int st) {
#pragma unroll
    for (int d = 0; d < NACC; ++d) {
      float part[MI][NI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) part[i][j][q] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        if constexpr (G == 3) {
          // the small pairs first, then s0·s0
          uint32_t b0[NI][2], b1[NI][2];
#pragma unroll
          for (int j = 0; j < NI; ++j) {
            frag_b(st, 0, j, kk, b0[j]);
            frag_b(st, 1, j, kk, b1[j]);
          }
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            uint32_t a0[4], a1[4];
            frag_a(st, 0, i, kk, a0);
            frag_a(st, 1, i, kk, a1);
#pragma unroll
            for (int j = 0; j < NI; ++j) {
              mma(part[i][j], a0, b1[j]);
              mma(part[i][j], a1, b0[j]);
              mma(part[i][j], a0, b0[j]);
            }
          }
        } else {
          // the pairs (ia, d − ia) of diagonal d
#pragma unroll
          for (int ia = 0; ia <= d; ++ia) {
            uint32_t bf[NI][2];
#pragma unroll
            for (int j = 0; j < NI; ++j) frag_b(st, d - ia, j, kk, bf[j]);
#pragma unroll
            for (int i = 0; i < MI; ++i) {
              uint32_t af[4];
              frag_a(st, ia, i, kk, af);
#pragma unroll
              for (int j = 0; j < NI; ++j) mma(part[i][j], af, bf[j]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[d][i][j][q] += part[i][j][q];
    }
  };

  if constexpr (ASYNC) {
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < ns) fetch(st, st);
      cp_async_commit();
    }
    for (int s = 0; s < ns; ++s) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();   // slab s is in; every warp is past slab s − 1
      if (s + STAGES - 1 < ns) fetch((s + STAGES - 1) % STAGES, s + STAGES - 1);
      cp_async_commit();
      multiply(s % STAGES);
    }
  } else {
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st)
      if (st < ns) fetch(st, st);
    for (int s = 0; s < ns; ++s) {
      __syncthreads();   // slab s is stored; every warp is past slab s − 1
      if (s + STAGES - 1 < ns) fetch((s + STAGES - 1) % STAGES, s + STAGES - 1);
      multiply(s % STAGES);
    }
  }

  // c0, c1 at (g, 2t + 0/1), c2, c3 eight rows below; split6 sums its
  // diagonals smallest first
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = m0 + wm + i * 16 + g + h * 8;
        const int64_t col = n0 + wn + j * 8 + 2 * t;
        if (row >= M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (col + e >= N) continue;
          float v = acc[0][i][j][2 * h + e];
          if constexpr (G == 6)
            v = (acc[2][i][j][2 * h + e] + acc[1][i][j][2 * h + e]) + v;
          out[row * N + col + e] = v;
        }
      }
}

// C = Σ_z W[z] over the s parts in order
__global__ void __launch_bounds__(256)
split_matmul_sum(const float* __restrict__ W, float* __restrict__ C, int64_t n, int s) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float c = W[i];
    for (int z = 1; z < s; ++z) c += W[z * n + i];
    C[i] = c;
  }
}

// 16-byte rows for every plane: a unit stride on the staged dimension, the
// other stride a multiple of 8 elements, 16-byte aligned bases
bool rows16(const uint16_t* const* p, int np, int64_t unit, int64_t other) {
  if (unit != 1 || other % 8) return false;
  for (int i = 0; i < np; ++i)
    if ((uintptr_t)p[i] & 15) return false;
  return true;
}

// each operand K-fast unless the other dimension has the unit stride
bool kfast(int64_t sr, int64_t sk) { return sr != 1 || sk == 1; }

bool async_rows(const uint16_t* const* a, int64_t sam, int64_t sak,
                const uint16_t* const* b, int64_t sbn, int64_t sbk, int np) {
  return (kfast(sam, sak) ? rows16(a, np, sak, sam) : rows16(a, np, sam, sak)) &&
         (kfast(sbn, sbk) ? rows16(b, np, sbk, sbn) : rows16(b, np, sbn, sbk));
}

template <int G, bool ASYNC, bool AKF, bool BKF>
cudaError_t launch(const uint16_t* const* a, int64_t sam, int64_t sak,
                   const uint16_t* const* b, int64_t sbk, int64_t sbn, float* out,
                   int M, int N, int K, int splits, int per, cudaStream_t stream) {
  constexpr int BM = Grade<G>::BM;
  Operand<AKF, BM> A{{a[0], a[1], a[2]}, sam, sak, M};
  Operand<BKF, BN> B{{b[0], b[1], b[2]}, sbn, sbk, N};
  auto kernel = split_matmul_kernel<G, ASYNC, AKF, BKF>;
  constexpr int bytes = smem_bytes<G>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((N + BN - 1) / BN, (M + BM - 1) / BM, splits), NT, bytes, stream>>>(
      A, B, out, M, N, K, per);
  return cudaGetLastError();
}

template <int G, bool ASYNC>
cudaError_t dispatch(const uint16_t* const* a, int64_t sam, int64_t sak,
                     const uint16_t* const* b, int64_t sbk, int64_t sbn, float* out,
                     int M, int N, int K, int splits, int per, cudaStream_t stream) {
  const bool akf = kfast(sam, sak), bkf = kfast(sbn, sbk);
  if (akf && bkf)
    return launch<G, ASYNC, true, true>(a, sam, sak, b, sbk, sbn, out, M, N, K, splits,
                                        per, stream);
  if (akf)
    return launch<G, ASYNC, true, false>(a, sam, sak, b, sbk, sbn, out, M, N, K, splits,
                                         per, stream);
  if (bkf)
    return launch<G, ASYNC, false, true>(a, sam, sak, b, sbk, sbn, out, M, N, K, splits,
                                         per, stream);
  return launch<G, ASYNC, false, false>(a, sam, sak, b, sbk, sbn, out, M, N, K, splits,
                                        per, stream);
}

template <int G>
cudaError_t run(const uint16_t* const* a, int64_t sam, int64_t sak,
                const uint16_t* const* b, int64_t sbk, int64_t sbn, float* out, int M,
                int N, int K, int splits, int per, cudaStream_t stream) {
  return async_rows(a, sam, sak, b, sbn, sbk, Grade<G>::P)
             ? dispatch<G, true>(a, sam, sak, b, sbk, sbn, out, M, N, K, splits, per,
                                 stream)
             : dispatch<G, false>(a, sam, sak, b, sbk, sbn, out, M, N, K, splits, per,
                                  stream);
}

}  // namespace

// 1 where slate_split_matmul stages these planes through registers, 0
// where it copies them by cp.async
extern "C" int slate_split_matmul_staging(const uint16_t* A0, const uint16_t* A1,
                                          const uint16_t* A2, int64_t sam, int64_t sak,
                                          const uint16_t* B0, const uint16_t* B1,
                                          const uint16_t* B2, int64_t sbk, int64_t sbn,
                                          int passes) {
  const uint16_t* a[3] = {A0, A1, A2};
  const uint16_t* b[3] = {B0, B1, B2};
  return async_rows(a, sam, sak, b, sbn, sbk, passes == 6 ? 3 : 2) ? 0 : 1;
}

// A's planes A0, A1, A2 are (M, K) with strides (sam, sak), B's planes
// (K, N) with strides (sbk, sbn), all in elements, bf16 (A2 and B2 unused
// and may be null at passes = 3); C is a contiguous (M, N) fp32 output.
// passes: 3 (split3) or 6 (split6). K is cut into `splits` parts of `per`
// slabs of 32 (the last part ends at K, none is empty); W: splits·M·N
// floats of workspace (unused at 1). Returns the CUDA error of the launches.
extern "C" int slate_split_matmul(const uint16_t* A0, const uint16_t* A1,
                                  const uint16_t* A2, int64_t sam, int64_t sak,
                                  const uint16_t* B0, const uint16_t* B1,
                                  const uint16_t* B2, int64_t sbk, int64_t sbn, float* C,
                                  int M, int N, int K, float* W, int splits, int per,
                                  int passes, cudaStream_t stream) {
  const int slabs = (K + BK - 1) / BK;
  if (M <= 0 || N <= 0 || K <= 0 || (passes != 3 && passes != 6) || !A0 || !A1 ||
      !B0 || !B1 || (passes == 6 && (!A2 || !B2)) || splits < 1 || per < 1 ||
      (int64_t)(splits - 1) * per >= slabs || (int64_t)splits * per < slabs ||
      (splits > 1 && W == nullptr))
    return (int)cudaErrorInvalidValue;
  // an unused third plane reads as the first (never dereferenced)
  const uint16_t* a[3] = {A0, A1, passes == 6 ? A2 : A0};
  const uint16_t* b[3] = {B0, B1, passes == 6 ? B2 : B0};
  float* out = splits > 1 ? W : C;
  cudaError_t err =
      passes == 6 ? run<6>(a, sam, sak, b, sbk, sbn, out, M, N, K, splits, per, stream)
                  : run<3>(a, sam, sak, b, sbk, sbn, out, M, N, K, splits, per, stream);
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int64_t n = (int64_t)M * N;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  split_matmul_sum<<<blocks, 256, 0, stream>>>(W, C, n, splits);
  return (int)cudaGetLastError();
}
