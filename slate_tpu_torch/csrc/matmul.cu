// C = A·B for fp32 operands at fp32-class accuracy: the port of the Pallas
// kernel `matmul` (slate_tpu/ops/pallas_kernels.py:78-129), which
// accumulates at Precision.HIGHEST (several bf16 passes on the MXU) in VMEM
// over a (M/bm, N/bn, K/bk) grid.
//
// What bounds it on an H100: at the main paths' shapes (K = 512 and M, N in
// the thousands; geqrf's Gram products at K up to 32768) it does hundreds of
// FLOP per byte it must move, so it is bound by operations.  Full fp32 FFMA
// peaks at 67 TFLOP/s, and a register tile of FFMAs is capped below that by
// shared-memory bandwidth; single-pass TF32 keeps ~1e-3 relative error and
// fails the drivers' 3·ε residual gates.  So this is the Hopper counterpart
// of Precision.HIGHEST, 3xTF32 on the tensor cores: every operand element x
// splits in registers into big = tf32(x), rounded as cvt.rna.tf32.f32
// rounds a finite x, and small = x − big, whose 13 low bits the tensor
// core drops, and each fragment pair takes three
// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32: small·big and big·small
// first, then big·big (small·small, ~2⁻²² relative, is dropped).  The
// products of one 32-deep slab run into a zeroed fragment, which fp32
// adds then take into the accumulator: the tensor core's accumulation
// does not round to nearest, and a sum carried in it over all of K drifts
// toward zero (a build that did so failed chip_smoke.py's gate of 4×
// torch.matmul's error to fp64); this way only a slab's partial sums see
// it.
//
// The tiling: a 128 × 128 output tile per block of 256 threads, 8 warps of
// 64 × 32 (4 × 4 mma tiles, 64 fp32 accumulators a thread); K in slabs of
// 32 through a ring of three shared stages, so slabs t + 1 and t + 2 are in
// flight while slab t multiplies.  Each operand is staged in the layout it
// arrives in: K-fast ([row][32 + 4]) or row-fast ([32][128 + 8]); the pads
// make every fragment read free of bank conflicts (lanes hit banks 4g + t
// and 8t + g), so a transposed view (L21ᵀ, L⁻ᵀ, Yᵀ) is read where it lies.
// Two instantiations stage the slabs: cp.async.cg 16-byte copies where each
// operand has a unit stride, a row stride that is a multiple of 4 floats
// and a 16-byte aligned base, and loads through registers for any other
// view (same ring, same arithmetic, the loads of slab t + 2 issued before
// slab t multiplies).  The entry picks one from the pointers and strides
// (slate_matmul_f32_staging says which).  A partial last slab (K a
// multiple of 16) is zero-filled.
//
// Split-K: where the output has fewer 128² tiles than the card has SMs the
// wrapper (ops/kernels.py matmul_splits) cuts K into s parts of `per` whole
// slabs; part z writes its fp32 partial tile to W[z] and a second kernel
// sums the parts in order z = 0, 1, …, so the result is the same from run
// to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 32, NT = 256, STAGES = 3;
constexpr int WM = 64, WN = 32;            // a warp's tile: 2 × 4 warps
constexpr int MI = WM / 16, NI = WN / 8;   // its mma tiles: 4 × 4
constexpr int LDK = BK + 4;                // K-fast slab: [128][LDK]
constexpr int LDR = BM + 8;                // row-fast slab: [BK][LDR]
constexpr int SLAB = BM * LDK;             // floats of the larger layout
static_assert(BM == BN, "A's and B's slabs share one staging rule");
static_assert(BK * LDR <= SLAB, "a row-fast slab fits the K-fast one's room");
constexpr int SMEM_BYTES = STAGES * 2 * SLAB * (int)sizeof(float);
constexpr int CHUNKS = BM * BK / 4 / NT;   // 16-byte chunks a thread copies

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds a finite x: half the weight of the 13 dropped
// bits added to the magnitude, then those bits cleared (two integer
// operations at full rate, where the conversion instruction was slower on
// the card).  A NaN may come out of it as ±0 or ±inf (the add carries its
// mantissa into the exponent or the sign).
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x into big = tf32(x) and small = x − big, exact, which the mma reads to
// TF32 by dropping its 13 low bits.  A NaN x gives a NaN small whatever
// tf32 made of it, so the small·big term keeps the NaN in the product; an
// inf x gives inf − inf, a NaN, too.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a·b on one m16n8k8 TF32 tile
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// One operand as the kernel reads it: Op(r, k) = p[r·sr + k·sk], r the row
// of the output it feeds (m for A, n for B).  KF: staged K-fast.
template <bool KF>
struct Operand {
  const float* p;
  int64_t sr, sk;

  // chunk c of the slab at (r0, k0): its row/k origin in the slab and
  // its place in shared memory
  __device__ __forceinline__ void chunk(int c, int& r, int& k, int& at) const {
    if (KF) { r = c / (BK / 4); k = c % (BK / 4) * 4; at = r * LDK + k; }
    else { k = c / (BM / 4); r = c % (BM / 4) * 4; at = k * LDR + r; }
  }
  // the slab by cp.async (unit stride along the staged fast dimension)
  __device__ __forceinline__ void copy(float* s, int64_t r0, int k0, int K) const {
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      int r, k, at;
      chunk(threadIdx.x + i * NT, r, k, at);
      const bool valid = k0 + k < K;
      cp_async16(s + at, valid ? p + (r0 + r) * sr + (int64_t)(k0 + k) * sk : p, valid);
    }
  }
  // the slab into registers (any strides), then into shared memory
  __device__ __forceinline__ void load(float (&v)[CHUNKS][4], int64_t r0, int k0,
                                       int K) const {
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      int r, k, at;
      chunk(threadIdx.x + i * NT, r, k, at);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = KF ? r : r + e, kk = k0 + (KF ? k + e : k);
        v[i][e] = kk < K ? __ldg(p + (r0 + rr) * sr + (int64_t)kk * sk) : 0.f;
      }
    }
  }
  __device__ __forceinline__ void store(float* s, const float (&v)[CHUNKS][4]) const {
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      int r, k, at;
      chunk(threadIdx.x + i * NT, r, k, at);
      *reinterpret_cast<float4*>(s + at) = make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
    }
  }
  // Op(r, k) of a staged slab
  __device__ __forceinline__ float at(const float* s, int r, int k) const {
    return KF ? s[r * LDK + k] : s[k * LDR + r];
  }
};

// The block's tile of part blockIdx.z: slabs [z·per, min((z+1)·per, ⌈K/BK⌉)).
// out: C (one part) or the part's slice of W, row stride N.
template <bool ASYNC, bool AKF, bool BKF>
__global__ void __launch_bounds__(NT, 1)
matmul_f32_kernel(Operand<AKF> A, Operand<BKF> B, float* out, int M, int N, int K,
                  int per) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;   // the mma's groupID, thread in group
  const int wm = (warp % 2) * WM, wn = (warp / 2) * WN;
  const int64_t m0 = (int64_t)blockIdx.y * BM, n0 = (int64_t)blockIdx.x * BN;
  const int slabs = (K + BK - 1) / BK;
  const int s0 = blockIdx.z * per;
  const int ns = min(slabs, s0 + per) - s0;
  out += (int64_t)blockIdx.z * M * N;

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  auto sa = [&](int st) { return sm + st * 2 * SLAB; };
  auto sb = [&](int st) { return sm + st * 2 * SLAB + SLAB; };
  float ra[CHUNKS][4], rb[CHUNKS][4];
  auto fetch = [&](int st, int slab) {   // ASYNC: into the stage; else registers
    const int k0 = (s0 + slab) * BK;
    if constexpr (ASYNC) {
      A.copy(sa(st), m0, k0, K);
      B.copy(sb(st), n0, k0, K);
    } else {
      A.load(ra, m0, k0, K);
      B.load(rb, n0, k0, K);
    }
  };

  // the slab of stage st: 4 steps of 8, three mma a tile pair each, into
  // a zeroed fragment that is then added to the accumulator
  auto multiply = [&](int st) {
    const float* as = sa(st);
    const float* bs = sb(st);
    float d[MI][NI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) d[i][j][q] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      // b0, b1 at (k, n) = (t, g), (t + 4, g); a0 … a3 at (m, k) = (g, t),
      // (g + 8, t), (g, t + 4), (g + 8, t + 4)
      uint32_t bb[NI][2], bsm[NI][2];
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          split(B.at(bs, wn + j * 8 + g, kk + t + q * 4), bb[j][q], bsm[j][q]);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        uint32_t ab[4], asm_[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split(A.at(as, wm + i * 16 + g + (q & 1) * 8, kk + t + (q >> 1) * 4), ab[q],
                asm_[q]);
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          mma(d[i][j], asm_, bb[j]);
          mma(d[i][j], ab, bsm[j]);
          mma(d[i][j], ab, bb[j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] += d[i][j][q];
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
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < ns) {
        fetch(st, st);
        A.store(sa(st), ra);
        B.store(sb(st), rb);
      }
    }
    for (int s = 0; s < ns; ++s) {
      __syncthreads();   // slab s is stored; every warp is past slab s − 1
      const bool next = s + STAGES - 1 < ns;
      if (next) fetch(0, s + STAGES - 1);
      multiply(s % STAGES);
      if (next) {
        const int st = (s + STAGES - 1) % STAGES;
        A.store(sa(st), ra);
        B.store(sb(st), rb);
      }
    }
  }

  // c0, c1 at (g, 2t + 0/1), c2, c3 eight rows below
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = m0 + wm + i * 16 + g + h * 8;
        const int64_t col = n0 + wn + j * 8 + 2 * t;
        *reinterpret_cast<float2*>(out + row * N + col) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
}

// C = Σ_z W[z] over the s parts in order, four floats a thread
__global__ void __launch_bounds__(256)
matmul_f32_kernel_sum(const float4* __restrict__ W, float4* __restrict__ C, int64_t n4,
                      int s) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * blockDim.x) {
    float4 c = W[i];
    for (int z = 1; z < s; ++z) {
      const float4 w = W[z * n4 + i];
      c.x += w.x;
      c.y += w.y;
      c.z += w.z;
      c.w += w.w;
    }
    C[i] = c;
  }
}

// 16-byte rows: a unit stride on the staged dimension, the other stride a
// multiple of 4 floats, a 16-byte aligned base
bool rows16(const float* p, int64_t unit, int64_t other) {
  return unit == 1 && other % 4 == 0 && ((uintptr_t)p & 15) == 0;
}

// each operand K-fast unless the other dimension has the unit stride
bool a_kfast(int64_t sam, int64_t sak) { return sam != 1 || sak == 1; }
bool b_kfast(int64_t sbk, int64_t sbn) { return sbn != 1 || sbk == 1; }

// cp.async needs 16-byte rows along both operands' staged dimensions
bool async_rows(const float* A, int64_t sam, int64_t sak, const float* B,
                int64_t sbk, int64_t sbn) {
  return (a_kfast(sam, sak) ? rows16(A, sak, sam) : rows16(A, sam, sak)) &&
         (b_kfast(sbk, sbn) ? rows16(B, sbk, sbn) : rows16(B, sbn, sbk));
}

template <bool ASYNC, bool AKF, bool BKF>
cudaError_t launch(Operand<AKF> a, Operand<BKF> b, float* out, int M, int N, int K,
                   int splits, int per, cudaStream_t stream) {
  auto kernel = matmul_f32_kernel<ASYNC, AKF, BKF>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(N / BN, M / BM, splits), NT, SMEM_BYTES, stream>>>(a, b, out, M, N, K, per);
  return cudaGetLastError();
}

template <bool ASYNC>
cudaError_t dispatch(const float* A, int64_t sam, int64_t sak, const float* B,
                     int64_t sbk, int64_t sbn, float* out, int M, int N, int K,
                     int splits, int per, cudaStream_t stream) {
  const bool akf = a_kfast(sam, sak), bkf = b_kfast(sbk, sbn);
  const Operand<true> ak{A, sam, sak}, bk{B, sbn, sbk};
  const Operand<false> ar{A, sam, sak}, br{B, sbn, sbk};
  if (akf && bkf) return launch<ASYNC>(ak, bk, out, M, N, K, splits, per, stream);
  if (akf) return launch<ASYNC>(ak, br, out, M, N, K, splits, per, stream);
  if (bkf) return launch<ASYNC>(ar, bk, out, M, N, K, splits, per, stream);
  return launch<ASYNC>(ar, br, out, M, N, K, splits, per, stream);
}

}  // namespace

// 1 where slate_matmul_f32 stages these operands through registers, 0
// where it copies them by cp.async
extern "C" int slate_matmul_f32_staging(const float* A, int64_t sam, int64_t sak,
                                        const float* B, int64_t sbk, int64_t sbn) {
  return async_rows(A, sam, sak, B, sbk, sbn) ? 0 : 1;
}

// A is (M, K) with strides (sam, sak), B is (K, N) with strides (sbk, sbn),
// both in elements; C is a contiguous (M, N) output.  M and N must be
// multiples of 128 and K of 16.  K is cut into `splits` parts of `per`
// slabs of 32 (the last part ends at K, none is empty; splits = 1: one
// part of all); W: splits·M·N floats of workspace (unused at 1).  Returns
// the CUDA error of the launches.
extern "C" int slate_matmul_f32(const float* A, int64_t sam, int64_t sak,
                                const float* B, int64_t sbk, int64_t sbn,
                                float* C, int M, int N, int K, float* W,
                                int splits, int per, cudaStream_t stream) {
  const int slabs = (K + BK - 1) / BK;
  if (M <= 0 || N <= 0 || K <= 0 || M % BM || N % BN || K % 16 || splits < 1 ||
      per < 1 || (int64_t)(splits - 1) * per >= slabs || (int64_t)splits * per < slabs ||
      (splits > 1 && W == nullptr))
    return (int)cudaErrorInvalidValue;
  float* out = splits > 1 ? W : C;
  cudaError_t err = async_rows(A, sam, sak, B, sbk, sbn)
                        ? dispatch<true>(A, sam, sak, B, sbk, sbn, out, M, N, K,
                                         splits, per, stream)
                        : dispatch<false>(A, sam, sak, B, sbk, sbn, out, M, N, K,
                                          splits, per, stream);
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int64_t n4 = (int64_t)M * N / 4;
  const int blocks = (int)((n4 + 255) / 256 < 4096 ? (n4 + 255) / 256 : 4096);
  matmul_f32_kernel_sum<<<blocks, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(W), reinterpret_cast<float4*>(C), n4, splits);
  return (int)cudaGetLastError();
}
