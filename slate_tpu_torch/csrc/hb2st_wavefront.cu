// Householder band → tridiagonal bulge chase over sweeps [j0, j1) in ONE
// cooperative launch, IN PLACE on the wide lower band: the port of the
// Pallas kernel `hb2st_wavefront` (slate_tpu/ops/pallas_kernels.py:2033,
// body _hb2st_wave_kernel :1914-2011), stage 2 of the two-stage Hermitian
// eigensolver (slate_tpu_torch/linalg/eig.py, one launch per heev).
//
// The function (the TPU kernel's contract): the band ab (n, 2kd + 2),
// ab[c·ld + d] = A[c + d, c], after the sweeps of SLATE's hebr1/2/3
// schedule, and the log vt (nsweeps, nwin_max, kd + 1) with vt[s, w, 0] =
// τ and vt[s, w, 1:] = v (v[0] = 1) of window w of sweep j0 + s; the
// caller zeroes vt, and the rows past a sweep's nwin_j = (n−3−j)/kd + 1
// windows stay zero.
//
// Schedule.  Task (sweep js, window w) runs at stagger t = 3·js + w.
// Same-t tasks touch disjoint band rows, and every dependence crosses a t
// boundary: (js, w−1) at t−1, (js−1, w+2) at t−1, (js−1, w+1) at t−2
// (runtime.cc:714-725).  So the grid walks t = 0 … tmax with a grid.sync()
// after each stagger, and block g runs the live tasks js ≡ g (mod G) of
// it.  At most nl = nwin_max/3 + 2 tasks are live at once, so the grid is
// min(nl, co-resident blocks): at n = 8192, kd = 256, 12 blocks and
// 24,568 barriers.  The previous window's reflector, which the TPU kernel
// keeps in a VMEM ring (state_v, state_tau), is read back from the log
// row it wrote at t − 1.
//
// Each task body (chase.cuh) works on the band in global memory, L2-
// resident at the main path's sizes; one block of 1024 threads, the
// reductions in shared memory.  What bounds it on an H100: about 12·kd²
// FLOP a task (4 passes over kd² entries) — 1.06e11 FLOP at n = 8192,
// kd = 256, ~1.6 ms at the fp32 peak — but the tasks of a stagger form a
// chain of dependent L2 round trips on ≤ 12 SMs, and the barriers alone
// cost microseconds each; see PERF.md.

#include "chase.cuh"

namespace {

using namespace chase;

template <typename T>
struct Params {
  T* ab;         // (n, 2kd + 2) band, row stride ld
  int64_t ld;
  T* vt;         // (nsweeps, nwin_max, kd + 1) log, zeroed
  int n, kd, j0, nsweeps, nwin_max, tmax;
};

// Window 0 of sweep j (hb_sweep_start): annihilate A[j+2 : j+1+L, j] and
// apply the reflector two-sidedly to A[j+1 : j+1+L]².
template <typename T>
__device__ void sweep_start(const Params<T>& p, Smem<T>& s, int j, int nwin,
                            T* logrow) {
  const int tid = threadIdx.x, n = p.n, kd = p.kd;
  const int L = min(kd, n - 1 - j);
  T* col = p.ab + (int64_t)j * p.ld + 1;            // A[j + 1 + i, j]
  for (int i = tid; i < L; i += NT) s.v[i] = __ldcg(col + i);
  __syncthreads();
  T beta;
  const T tau = larfg(s.v, L, kd, s.red, &beta);
  for (int i = tid; i < L; i += NT) col[i] = i == 0 ? beta : T(0);
  __syncthreads();
  two_sided(p.ab, p.ld, j + 1, L, s.v, tau, s);
  for (int i = tid; i <= kd; i += NT) logrow[i] = i == 0 ? tau : s.v[i - 1];
  if (nwin == 1 && n - (j + 1 + L) == 1) tail(p.ab, p.ld, j + 1 + L, j + 1, L, s.v, tau, s.red);
}

// Window w ≥ 1 (hb_sweep_step): right-apply the previous window's
// reflector to the (Lt, kd) bulge block A[r1 : r1+Lt, r0 : r0+kd], generate
// the next reflector from its first column, left-apply it to the other
// columns and two-sidedly to A[r1 : r1+Lt]².
template <typename T>
__device__ void sweep_step(const Params<T>& p, Smem<T>& s, int j, int w, int nwin,
                           T* logrow) {
  const int tid = threadIdx.x, n = p.n, kd = p.kd;
  const int64_t r0 = j + 1 + (int64_t)(w - 1) * kd, r1 = r0 + kd;
  const int Lt = min((int64_t)kd, n - r1);
  const T* prev = logrow - (kd + 1);
  for (int c = tid; c < kd; c += NT) s.u[c] = __ldcg(prev + 1 + c);
  const T tau_p = __ldcg(prev);
  __syncthreads();
  const Blk<T> b = block_at(p.ab, p.ld, r1, r0);
  row_dot<false>(b, Lt, kd, s.u, s.y, s.part);
  const T *y = s.y, *u = s.u, *v = s.v, *y2 = s.y2;
  update<false>(b, Lt, 0, kd, [=](int i, int c) { return tau_p * y[i] * u[c]; });
  for (int i = tid; i < Lt; i += NT) s.v[i] = b.ld(i, 0);
  __syncthreads();
  T beta;
  const T tau = larfg(s.v, Lt, kd, s.red, &beta);
  for (int i = tid; i < Lt; i += NT) b.at(i, 0) = i == 0 ? beta : T(0);
  __syncthreads();
  col_dot<false>(b, Lt, 1, kd, s.v, s.y2);
  update<false>(b, Lt, 1, kd, [=](int i, int c) { return v[i] * tau * y2[c]; });
  two_sided(p.ab, p.ld, r1, Lt, s.v, tau, s);
  for (int i = tid; i <= kd; i += NT) logrow[i] = i == 0 ? tau : s.v[i - 1];
  if (w == nwin - 1 && n - (r1 + Lt) == 1) tail(p.ab, p.ld, r1 + Lt, r1, Lt, s.v, tau, s.red);
}

// TASKS = false runs the same grid and barriers with every task skipped:
// the barriers' share of the chase.
template <typename T, bool TASKS>
__global__ void __launch_bounds__(NT, 1) hb2st_wavefront_kernel(Params<T> p) {
  extern __shared__ __align__(16) unsigned char raw[];
  Smem<T> s(raw, p.kd);
  cg::grid_group grid = cg::this_grid();
  for (int t = 0; t <= p.tmax; ++t) {
    const int js_lo = max((t - p.nwin_max + 3) / 3, 0);
    const int js_hi = min(t / 3, p.nsweeps - 1);
    if (TASKS) {
      for (int js = js_lo + (int)blockIdx.x; js <= js_hi; js += (int)gridDim.x) {
        const int j = p.j0 + js, w = t - 3 * js;
        const int nwin = (p.n - 3 - j) / p.kd + 1;
        if (w < 0 || w >= nwin) continue;
        T* logrow = p.vt + ((int64_t)js * p.nwin_max + w) * (p.kd + 1);
        if (w == 0)
          sweep_start(p, s, j, nwin, logrow);
        else
          sweep_step(p, s, j, w, nwin, logrow);
        __syncthreads();
      }
    }
    grid.sync();
  }
}

// The geometry of _hb_wave_meta (pallas_kernels.py:2014-2030); returns
// nwin_max, or 0 with no sweep.
int wave_meta(int n, int kd, int j0, int j1, int* nsweeps, int* tmax, int* nl) {
  if (j1 > n - 2) j1 = n - 2;
  *nsweeps = j1 > j0 ? j1 - j0 : 0;
  int nwin_max = 0;
  *tmax = 0;
  for (int js = 0; js < *nsweeps; ++js) {
    const int nw = (n - 3 - (j0 + js)) / kd + 1;
    nwin_max = nw > nwin_max ? nw : nwin_max;
    *tmax = 3 * js + nw - 1 > *tmax ? 3 * js + nw - 1 : *tmax;
  }
  *nl = nwin_max / 3 + 2 < *nsweeps ? nwin_max / 3 + 2 : *nsweeps;
  return nwin_max;
}

template <typename T>
int launch(T* ab, int64_t ld, int n, int kd, int j0, int j1, T* vt,
           int nwin_max, int tasks, cudaStream_t stream) {
  int nsweeps, tmax, nl;
  if (kd < 4 || ld < 2 * kd + 2 || j0 < 0 ||
      wave_meta(n, kd, j0, j1, &nsweeps, &tmax, &nl) != nwin_max)
    return (int)cudaErrorInvalidValue;
  if (nsweeps == 0) return 0;
  Params<T> p{ab, ld, vt, n, kd, j0, nsweeps, nwin_max, tmax};
  const void* kernel = tasks ? (const void*)hb2st_wavefront_kernel<T, true>
                             : (const void*)hb2st_wavefront_kernel<T, false>;
  const size_t smem = smem_bytes<T>(kd);
  int G = 0, err;
  if ((err = plan_grid(kernel, smem, nl, &G)) != 0) return err;
  void* args[] = {&p};
  cudaError_t e = cudaLaunchCooperativeKernel(kernel, dim3(G), dim3(NT), args, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// ab: (n, 2kd + 2) band, row stride ld ≥ 2kd + 2.  vt: the zeroed log of
// (j1 − j0, nwin_max, kd + 1) values, nwin_max as _hb_wave_meta gives it
// (checked).  tasks = 0 runs the barriers only.  kd ≥ 4.
extern "C" int slate_hb2st_wavefront_f32(float* ab, int64_t ld, int n, int kd, int j0,
                                         int j1, float* vt, int nwin_max, int tasks,
                                         cudaStream_t stream) {
  return launch<float>(ab, ld, n, kd, j0, j1, vt, nwin_max, tasks, stream);
}

extern "C" int slate_hb2st_wavefront_f64(double* ab, int64_t ld, int n, int kd, int j0,
                                         int j1, double* vt, int nwin_max, int tasks,
                                         cudaStream_t stream) {
  return launch<double>(ab, ld, n, kd, j0, j1, vt, nwin_max, tasks, stream);
}
