// Householder upper band → bidiagonal bulge chase over sweeps [s0, s1) in
// ONE cooperative launch, IN PLACE on the row-major general band: the port
// of the Pallas kernel `tb2bd_wavefront` (slate_tpu/ops/pallas_kernels.py
// :2226, body _tb2bd_wave_kernel :2084-2208), stage 2 of the two-stage SVD
// (slate_tpu_torch/linalg/svd.py, one launch per svd).
//
// The function (the TPU kernel's contract): the band st (n, 3kd + 2),
// st[r·ld + (c − r + kd)] = A[r, c], after the sweeps of SLATE's gebr1/2/3
// schedule, and the two logs ut (left, U) and vt (right, V), each
// (nsweeps, nblk_max, kd + 1) with [s, b, 0] = τ and [s, b, 1:] = the
// reflector (its first entry 1) of block b of sweep s0 + s; the caller
// zeroes both, and the rows past a sweep's nblk(s) = (n−2−s)/kd + 1 blocks
// stay zero.  The window of block b starts at row (U) and column (V)
// s + 1 + b·kd.
//
// Schedule.  Task (sweep js, block b) runs at stagger t = 3·js + b; task
// (s, b) touches rows and columns [s+1+(b−1)kd, s+1+(b+1)kd)
// (runtime.cc:1024-1026), so same-t tasks are disjoint and every
// dependence crosses a t boundary, as in hb2st_wavefront.cu.  The grid walks
// t = 0 … tmax with a grid.sync() after each stagger, block g running the
// live tasks js ≡ g (mod G); at most nl = nblk_max/3 + 2 tasks are live, so
// the grid is min(nl, co-resident blocks): 12 blocks and about 24,600
// barriers at n = 8192, kd = 256.  The left reflector a block carries to
// the next, which the TPU kernel keeps in a VMEM ring (state_u,
// state_tau), is read back from the U log row some block wrote at t − 1.
//
// Each task body works on the band in global memory, every read through
// L2 (__ldcg), with only the reflectors, the work vectors and the
// reduction buffers in shared memory (the TPU's dense (2kd+2)² patch is
// 1.06 MB in fp32 at kd = 256).  A row of A is contiguous in this band, so
// the tasks work on the transposed view of chase.cuh's gen_block_t: a
// left reflection of A is a right reflection there.  What bounds it on an
// H100: about 16·kd² FLOP a block task and 8·kd² a start task (each a
// one-sided kd×kd apply: a dot and a rank-1 update per reflector), 1.1e11
// FLOP at n = 8192, kd = 256 by the count of chip_smoke.py's
// tb2bd_flops, ~1.6 ms at the fp32 peak; but the tasks of a stagger are
// chains of dependent L2 round trips on ≤ 12 SMs, and the barriers cost
// microseconds each; see PERF.md.

#include "chase.cuh"

namespace {

using namespace chase;

template <typename T>
struct Params {
  T* st;         // (n, 3kd + 2) band, row stride ld
  int64_t ld;
  T* ut;         // (nsweeps, nblk_max, kd + 1) left log, zeroed
  T* vt;         // the right log, zeroed
  int n, kd, s0, nsweeps, nblk_max, tmax;
};

template <typename T>
__device__ void put_log(T* row, T tau, const T* x, int kd) {
  for (int i = threadIdx.x; i <= kd; i += NT) row[i] = i == 0 ? tau : x[i - 1];
}

// The left apply of u (length ≤ C, zero past it) to the columns of A that
// are the rows [1, R) of the transposed view m: A_blk ← (I − τ·u·uᵀ)·A_blk.
template <typename T>
__device__ void left_rows_from1(const Blk<T>& m, int R, int C, T tau, Smem<T>& s) {
  if (R <= 1) return;
  const Blk<T> m1{m.base + 1, m.cs};
  row_dot<false>(m1, R - 1, C, s.u, s.y, s.part);
  const T *y = s.y, *u = s.u;
  update<false>(m1, R - 1, 0, C, [=](int i, int c) { return tau * y[i] * u[c]; });
}

// The right apply of v (length R) to the rows c0 ≤ c < C of A, columns of
// the transposed view m: A_blk ← A_blk·(I − τ·v·vᵀ).
template <typename T>
__device__ void right_cols(const Blk<T>& m, int R, int c0, int C, T tau, Smem<T>& s) {
  col_dot<false>(m, R, c0, C, s.v, s.y2);
  const T *y2 = s.y2, *v = s.v;
  update<false>(m, R, c0, C, [=](int i, int c) { return v[i] * tau * y2[c]; });
}

// Block 0 of sweep s (tb_sweep_start): the right reflector v from row s
// beyond the superdiagonal, applied to rows s+1 … s+lv; then the left
// reflector u from column s+1 below the diagonal, applied to columns
// s+2 … s+lv.
template <typename T>
__device__ void sweep_start(const Params<T>& p, Smem<T>& s, int sw, T* urow, T* vrow) {
  const int tid = threadIdx.x, n = p.n, kd = p.kd;
  const int lv = min(kd, n - 1 - sw);
  T* row = p.st + (int64_t)sw * p.ld + kd + 1;          // A[s, s + 1 + c]
  for (int c = tid; c < lv; c += NT) s.v[c] = __ldcg(row + c);
  __syncthreads();
  T beta;
  const T tauv = larfg(s.v, lv, kd, s.red, &beta);
  for (int c = tid; c < lv; c += NT) row[c] = c == 0 ? beta : T(0);
  __syncthreads();
  const Blk<T> m = gen_block_t(p.st, p.ld, kd, sw + 1, sw + 1);
  right_cols(m, lv, 0, lv, tauv, s);
  for (int r = tid; r < lv; r += NT) s.u[r] = m.ld(0, r);
  __syncthreads();
  const T tauu = larfg(s.u, lv, kd, s.red, &beta);
  for (int r = tid; r < lv; r += NT) m.at(0, r) = r == 0 ? beta : T(0);
  __syncthreads();
  left_rows_from1(m, lv, lv, tauu, s);
  put_log(vrow, tauv, s.v, kd);
  put_log(urow, tauu, s.u, kd);
}

// Block b ≥ 1 (tb_sweep_block): left-apply the previous block's u to the
// off-diagonal block A[i_lo : i_lo+li, j_lo : j_lo+lj]; generate the next v
// from its first row and right-apply it to the other rows and to the
// diagonal block A[j_lo : j_lo+lj]²; generate the next u from the diagonal
// block's first column and left-apply it to the other columns.
template <typename T>
__device__ void sweep_block(const Params<T>& p, Smem<T>& s, int sw, int b, T* urow,
                            T* vrow) {
  const int tid = threadIdx.x, n = p.n, kd = p.kd;
  const int64_t i_lo = (int64_t)(b - 1) * kd + 1 + sw, j_lo = i_lo + kd;
  const int li = (int)min((int64_t)kd, n - i_lo), lj = (int)min((int64_t)kd, n - j_lo);
  const T* prev = urow - (kd + 1);
  for (int c = tid; c < kd; c += NT) s.u[c] = __ldcg(prev + 1 + c);
  const T tau_p = __ldcg(prev);
  __syncthreads();
  // gebr2: the previous u on the off-diagonal block (rows of off^T)
  const Blk<T> off = gen_block_t(p.st, p.ld, kd, i_lo, j_lo);
  row_dot<false>(off, lj, li, s.u, s.y, s.part);
  {
    const T *y = s.y, *u = s.u;
    update<false>(off, lj, 0, li, [=](int i, int c) { return tau_p * y[i] * u[c]; });
  }
  for (int i = tid; i < lj; i += NT) s.v[i] = off.ld(i, 0);
  __syncthreads();
  T beta;
  const T tauv = larfg(s.v, lj, kd, s.red, &beta);
  for (int i = tid; i < lj; i += NT) off.at(i, 0) = i == 0 ? beta : T(0);
  __syncthreads();
  right_cols(off, lj, 1, li, tauv, s);
  // gebr3: v on the diagonal block, then the next u from its first column
  const Blk<T> dg = gen_block_t(p.st, p.ld, kd, j_lo, j_lo);
  right_cols(dg, lj, 0, lj, tauv, s);
  for (int r = tid; r < lj; r += NT) s.u[r] = dg.ld(0, r);
  __syncthreads();
  const T tauu = larfg(s.u, lj, kd, s.red, &beta);
  for (int r = tid; r < lj; r += NT) dg.at(0, r) = r == 0 ? beta : T(0);
  __syncthreads();
  left_rows_from1(dg, lj, lj, tauu, s);
  put_log(vrow, tauv, s.v, kd);
  put_log(urow, tauu, s.u, kd);
}

// TASKS = false runs the same grid and barriers with every task skipped:
// the barriers' share of the chase.
template <typename T, bool TASKS>
__global__ void __launch_bounds__(NT, 1) tb2bd_wavefront_kernel(Params<T> p) {
  extern __shared__ __align__(16) unsigned char raw[];
  Smem<T> s(raw, p.kd);
  cg::grid_group grid = cg::this_grid();
  for (int t = 0; t <= p.tmax; ++t) {
    const int js_lo = max((t - p.nblk_max + 3) / 3, 0);
    const int js_hi = min(t / 3, p.nsweeps - 1);
    if (TASKS) {
      for (int js = js_lo + (int)blockIdx.x; js <= js_hi; js += (int)gridDim.x) {
        const int sw = p.s0 + js, b = t - 3 * js;
        const int nblk = (p.n - 2 - sw) / p.kd + 1;
        if (b < 0 || b >= nblk) continue;
        const int64_t off = ((int64_t)js * p.nblk_max + b) * (p.kd + 1);
        if (b == 0)
          sweep_start(p, s, sw, p.ut + off, p.vt + off);
        else
          sweep_block(p, s, sw, b, p.ut + off, p.vt + off);
        __syncthreads();
      }
    }
    grid.sync();
  }
}

// The geometry of _tb_wave_meta (pallas_kernels.py:2211-2222); returns
// nblk_max, or 0 with no sweep.
int wave_meta(int n, int kd, int s0, int s1, int* nsweeps, int* tmax, int* nl) {
  if (s1 > n - 2) s1 = n - 2;
  *nsweeps = s1 > s0 ? s1 - s0 : 0;
  int nblk_max = 0;
  *tmax = 0;
  for (int js = 0; js < *nsweeps; ++js) {
    const int nb = (n - 2 - (s0 + js)) / kd + 1;
    nblk_max = nb > nblk_max ? nb : nblk_max;
    *tmax = 3 * js + nb - 1 > *tmax ? 3 * js + nb - 1 : *tmax;
  }
  *nl = nblk_max / 3 + 2 < *nsweeps ? nblk_max / 3 + 2 : *nsweeps;
  return nblk_max;
}

template <typename T>
int launch(T* st, int64_t ld, int n, int kd, int s0, int s1, T* ut, T* vt,
           int nblk_max, int tasks, cudaStream_t stream) {
  int nsweeps, tmax, nl;
  if (kd < 4 || ld < 3 * kd + 2 || s0 < 0 ||
      wave_meta(n, kd, s0, s1, &nsweeps, &tmax, &nl) != nblk_max)
    return (int)cudaErrorInvalidValue;
  if (nsweeps == 0) return 0;
  Params<T> p{st, ld, ut, vt, n, kd, s0, nsweeps, nblk_max, tmax};
  const void* kernel = tasks ? (const void*)tb2bd_wavefront_kernel<T, true>
                             : (const void*)tb2bd_wavefront_kernel<T, false>;
  const size_t smem = smem_bytes<T>(kd);
  int G = 0, err;
  if ((err = plan_grid(kernel, smem, nl, &G)) != 0) return err;
  void* args[] = {&p};
  cudaError_t e = cudaLaunchCooperativeKernel(kernel, dim3(G), dim3(NT), args, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// st: (n, 3kd + 2) band, row stride ld ≥ 3kd + 2.  ut, vt: the zeroed logs
// of (s1 − s0, nblk_max, kd + 1) values each, s1 clipped to n − 2 and
// nblk_max as _tb_wave_meta gives it (checked).  tasks = 0 runs the
// barriers only.  kd ≥ 4.
extern "C" int slate_tb2bd_wavefront_f32(float* st, int64_t ld, int n, int kd, int s0,
                                         int s1, float* ut, float* vt, int nblk_max,
                                         int tasks, cudaStream_t stream) {
  return launch<float>(st, ld, n, kd, s0, s1, ut, vt, nblk_max, tasks, stream);
}

extern "C" int slate_tb2bd_wavefront_f64(double* st, int64_t ld, int n, int kd, int s0,
                                         int s1, double* ut, double* vt, int nblk_max,
                                         int tasks, cudaStream_t stream) {
  return launch<double>(st, ld, n, kd, s0, s1, ut, vt, nblk_max, tasks, stream);
}
