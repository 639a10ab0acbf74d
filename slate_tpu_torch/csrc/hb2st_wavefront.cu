// Householder band → tridiagonal bulge chase over sweeps [j0, j1) in ONE
// cooperative launch of thread-block clusters, IN PLACE on the wide lower
// band: the port of the Pallas kernel `hb2st_wavefront`
// (slate_tpu/ops/pallas_kernels.py:2033, body _hb2st_wave_kernel
// :1914-2011), stage 2 of the two-stage Hermitian eigensolver
// (slate_tpu_torch/linalg/eig.py, one launch per heev).
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
// (runtime.cc:714-725).  So the grid walks t = 0 … tmax with one
// release/acquire grid barrier after each stagger, and cluster g runs the
// live tasks js ≡ g (mod G) of it.  At most nl = nwin_max/3 + 2 tasks are
// live at once: at n = 8192, kd = 256, 12 tasks and 24,568 staggers.  The
// previous window's reflector, which the TPU kernel keeps in a VMEM ring
// (state_v, state_tau), is read back from the log row it wrote at t − 1.
//
// A task (chase.cuh) runs on a cluster of C blocks, its window split
// between their shared memory: the bulge block B = A[r : r+Lt, r−kd : r]
// by columns, the stored triangle of S = A[r : r+Lt]² by pairs of columns.
// Window w ≥ 1 (hb_sweep_step): y = B·u (exchange 1); every block updates
// B's first column by τ'·y·uᵀ and runs larfg on it; the previous
// reflector's right apply and the new one's left apply to B's other
// columns stay in each block, as one rank-2 update; then S ← H·S·H with
// S·v as exchange 2.  Window 0 (hb_sweep_start) has no
// B.  What bounds it on an H100: about 12·kd² FLOP a task, 1.06e11 FLOP at
// n = 8192, kd = 256, ~1.6 ms at the fp32 peak; but the 24,568 dependent
// staggers, each a grid barrier, set a floor of their own (PERF.md).

#include "chase.cuh"

namespace {

using namespace chase;

template <typename T>
struct Params {
  T* ab;         // (n, 2kd + 2) band, row stride ld
  int64_t ld;
  T* vt;         // (nsweeps, nwin_max, kd + 1) log, zeroed
  int n, kd, j0, nsweeps, nwin_max, tmax, C;
  unsigned* bar;  // the staggers' barrier counter, zeroed
};

// The length-1 trailing coupling (hb_sweep_tail), on one block: the
// single row A[row, r + c), c < L, past the window takes the right-apply
// of H.
template <typename T>
__device__ void tail(T* ab, int64_t ld, int64_t row, int64_t r, int L, const T* v, T tau,
                     T* red) {
  const int tid = threadIdx.x;
  T* base = ab + r * ld + (row - r);
  const int64_t cs = ld - 1;
  T acc = 0;
  for (int c = tid; c < L; c += NT) acc += __ldcg(base + c * cs) * v[c];
  acc = tau * block_sum(acc, red);
  for (int c = tid; c < L; c += NT) base[c * cs] = __ldcg(base + c * cs) - acc * v[c];
  __syncthreads();
}

// Task (sweep j, window w) on block `rank` of its cluster.
template <typename T, bool SM>
__device__ void task(const Params<T>& p, Smem<T>& s, Exchange<T>& ex, int rank, int j, int w,
                     int nwin, T* logrow) {
  const int tid = threadIdx.x, n = p.n, kd = p.kd, C = p.C;
  const int sh = share(kd, C), pp = pairs(kd, C);
  const int64_t cs = p.ld - 1;
  // S = A[r : r+L]², column c at gS + c·cs (entry i at + i)
  const int64_t r = w == 0 ? j + 1 : j + 1 + (int64_t)w * kd;
  const int L = (int)min((int64_t)kd, w == 0 ? n - 1 - j : n - r);
  T* gS = p.ab + r * p.ld;
  // window w ≥ 1: B = A[r : r+L, r−kd : r], column c at gB + c·cs; this
  // block's columns [b0, b0 + nb)
  T* gB = p.ab + (r - kd) * p.ld + kd;
  const int b0 = rank * sh, nb = w == 0 ? 0 : max(0, min(sh, kd - b0));
  T* Bs = s.win;
  T* Ss = s.win + (int64_t)sh * kd;
  // this block's pairs (c, L−1−c) of S's columns, c in [q0, q0 + nq)
  const int q0 = rank * pp, nq = max(0, min(pp, (L + 1) / 2 - q0));
  auto scol = [=](int k) {
    const int q = k >> 1, a = q0 + q, c = (k & 1) ? L - 1 - a : a;
    if ((k & 1) && c == a) return Col<T>{gS, 0, L};   // the middle column, once
    if (!SM) return Col<T>{gS + c * cs, c, c};
    T* slot = Ss + (int64_t)q * (kd + 1);
    return Col<T>{(k & 1) ? slot + 1 : slot - a, c, c};
  };
  // this block's share of the window: B's columns (runs of L), S's pairs
  // (runs of L + 1: column a = q0 + k from its diagonal, then column
  // L−1−a), in shared memory on route SMEM
  const auto b_part = part(
      nb * L, L, [=](int k, int t) { return gB + (b0 + k) * cs + t; },
      [=](int k, int t) { return Bs + k * kd + t; });
  const auto s_part = part(
      nq * (L + 1), L + 1,
      [=](int k, int t) -> T* {
        const int a = q0 + k, b = L - 1 - a;
        if (t < L - a) return gS + a * cs + a + t;
        return b == a ? nullptr : gS + b * cs + b + (t - (L - a));
      },
      [=](int k, int t) { return Ss + k * (kd + 1) + t; });
  ex.k = 0;
  T tau, beta, tau_p = 0;
  const T* prev = logrow - (kd + 1);
  if (w > 0) tau_p = __ldcg(prev);
  // the reflector's source (window 0: A[j+1 : j+1+L, j]; else B's first
  // column) and the previous reflector, beside the window's loads
  const T* src = w == 0 ? p.ab + (int64_t)j * p.ld + 1 : gB;
  auto vec = [&] {
    const T a = tid < L ? __ldcg(src + tid) : T(0);
    const T b = w > 0 && tid < kd ? __ldcg(prev + 1 + tid) : T(0);
    for (int i = tid + NT; i < L; i += NT) s.v[i] = __ldcg(src + i);
    for (int c = tid + NT; w > 0 && c < kd; c += NT) s.u[c] = __ldcg(prev + 1 + c);
    if (tid < L) s.v[tid] = a;
    if (w > 0 && tid < kd) s.u[tid] = b;
  };
  if (SM)
    copy_in<T>(b_part, s_part, vec);
  else
    vec();
  __syncthreads();
  CHASE_PHASE(PH_LOAD);
  if (w == 0) {
    tau = larfg(s.v, L, kd, s.red, &beta);
  } else {
    // from1: column 0 is left out (every block updates its copy in v)
    auto bcol = [=](int k) {
      const int c = b0 + k;
      return Col<T>{SM ? Bs + (int64_t)k * kd : gB + c * cs, c, 0};
    };
    auto bcol1 = [=](int k) {
      Col<T> m = bcol(k);
      if (m.c == 0) m.lo = L;
      return m;
    };
    // the previous reflector from the right, B' = B − τ'·y·uᵀ with y = B·u,
    // then the new one from the left on B's other columns, B' − v·τ·y2ᵀ
    // with y2 = vᵀB' = vᵀB − τ'·(vᵀy)·uᵀ: one rank-2 update of B
    ex.ready();
    rowdot<SM>(L, nb, bcol, 1, s.u, s.x, s.part);
    ex.sum(s.y, L);
    const T *y = s.y, *u = s.u, *v = s.v, *y2 = s.y2;
    for (int i = tid; i < L; i += NT) s.v[i] = s.v[i] - tau_p * y[i] * u[0];
    __syncthreads();
    tau = larfg(s.v, L, kd, s.red, &beta);
    T vy = 0;
    for (int i = tid; i < L; i += NT) vy += v[i] * y[i];
    vy = tau_p * block_sum(vy, s.red);
    T* y2w = s.y2;
    coldot<SM>(L, nb, bcol1, 1, 0, s.v, [=](int k, int c, T d) { y2w[k] = d - vy * u[c]; });
    update<SM>(L, nb, bcol1, 1, s.y, s.v,
               [=](int k, int c) { return Coef<T>{tau_p * u[c], tau * y2[k]}; });
    if (rank == 0)
      for (int i = tid; i < L; i += NT) bcol(0).p[i] = i == 0 ? beta : T(0);
  }
  // S ← H·S·H: S·v from this block's columns (their lower parts along
  // the rows, their strictly lower parts as the columns' dots) summed
  // over the cluster; w = τ·S·v − ½·τ²·(vᵀS·v)·v; S −= v·wᵀ + w·vᵀ
  ex.ready();
  rowdot<SM>(L, 2 * nq, scol, 1, s.v, s.x, s.part);
  T* x = s.x;
  coldot<SM>(L, 2 * nq, scol, 1, 1, s.v, [=](int, int c, T d) { x[c] += d; });
  ex.sum(s.y, L);
  if (w == 0 && rank == 0) {
    T* col = p.ab + (int64_t)j * p.ld + 1;        // every block has read it
    for (int i = tid; i < L; i += NT) col[i] = i == 0 ? beta : T(0);
  }
  T d = 0;
  for (int i = tid; i < L; i += NT) {
    const T wi = tau * s.y[i];
    s.y[i] = wi;
    d += s.v[i] * wi;
  }
  const T half = T(0.5) * tau * block_sum(d, s.red);
  for (int i = tid; i < L; i += NT) s.y[i] -= half * s.v[i];
  __syncthreads();
  {
    const T *v = s.v, *wv = s.y;
    update<SM>(L, 2 * nq, scol, 1, s.v, s.y, [=](int, int c) { return Coef<T>{wv[c], v[c]}; });
  }
  CHASE_PHASE(PH_PASS);
  if (SM) {
    copy_out(b_part);
    copy_out(s_part);
  }
  if (rank == 0) {
    for (int i = tid; i <= kd; i += NT) logrow[i] = i == 0 ? tau : s.v[i - 1];
    if (w == nwin - 1 && n - (r + L) == 1) tail(p.ab, p.ld, r + L, r, L, s.v, tau, s.red);
  }
  __syncthreads();
  CHASE_PHASE(PH_STORE);
}

// TASKS = false runs the same grid and barriers with every task skipped:
// the barriers' share of the chase.
template <typename T, bool SM, bool TASKS>
__global__ void __launch_bounds__(NT, 1) hb2st_wavefront_kernel(Params<T> p) {
  extern __shared__ __align__(16) unsigned char raw[];
  Smem<T> s(raw, p.kd, p.C);
  const int rank = (int)cg::this_cluster().block_rank();
  const int g = (int)blockIdx.x / p.C, G = (int)gridDim.x / p.C;
  ColumnBarrier stagger{p.bar, gridDim.x, 0u};
  Exchange<T> ex{s.x, p.C, 0, false};
  for (int t = 0; t <= p.tmax; ++t) {
    const int js_lo = max((t - p.nwin_max + 3) / 3, 0);
    const int js_hi = min(t / 3, p.nsweeps - 1);
    if (TASKS) {
      for (int js = js_lo + g; js <= js_hi; js += G) {
        const int j = p.j0 + js, w = t - 3 * js;
        const int nwin = (p.n - 3 - j) / p.kd + 1;
        if (w < 0 || w >= nwin) continue;
        T* logrow = p.vt + ((int64_t)js * p.nwin_max + w) * (p.kd + 1);
        task<T, SM>(p, s, ex, rank, j, w, nwin, logrow);
      }
    }
    stagger.sync();
    CHASE_PHASE(PH_STAGGER);
  }
  ex.finish();
}

template <typename T>
const void* kernel_for(int route, bool tasks) {
  if (route == SMEM)
    return tasks ? (const void*)hb2st_wavefront_kernel<T, true, true>
                 : (const void*)hb2st_wavefront_kernel<T, true, false>;
  return tasks ? (const void*)hb2st_wavefront_kernel<T, false, true>
               : (const void*)hb2st_wavefront_kernel<T, false, false>;
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
int plan_for(int n, int kd, int j0, int j1, int* G, int* C, int* route) {
  int nsweeps, tmax, nl;
  if (kd < 4 || j0 < 0) return (int)cudaErrorInvalidValue;
  wave_meta(n, kd, j0, j1, &nsweeps, &tmax, &nl);
  if (nsweeps == 0) nl = 1;
  return plan(HB, kd, (int)sizeof(T), nl,
                     [](int rt) { return kernel_for<T>(rt, true); }, G, C, route);
}

template <typename T>
int run(T* ab, int64_t ld, int n, int kd, int j0, int j1, T* vt, int nwin_max, int tasks,
           cudaStream_t stream) {
  int nsweeps, tmax, nl;
  if (kd < 4 || ld < 2 * kd + 2 || j0 < 0 ||
      wave_meta(n, kd, j0, j1, &nsweeps, &tmax, &nl) != nwin_max)
    return (int)cudaErrorInvalidValue;
  if (nsweeps == 0) return 0;
  int G = 0, C = 0, route = 0, err;
  if ((err = plan_for<T>(n, kd, j0, j1, &G, &C, &route)) != 0) return err;
  unsigned* bar = nullptr;
  if ((err = new_counter(&bar, stream)) != 0) return err;
  Params<T> p{ab, ld, vt, n, kd, j0, nsweeps, nwin_max, tmax, C, bar};
  return launch(kernel_for<T>(route, tasks != 0), &p, G, C,
                smem_bytes(HB, kd, (int)sizeof(T), C, route), bar, stream);
}

}  // namespace

// Dynamic shared memory of one block at cluster size C on `route` (0: the
// window in shared memory, 1: in the band), dsize = 4 or 8
// (ops/smem.py chase_block_bytes).
extern "C" int64_t slate_hb2st_wavefront_smem_bytes(int kd, int dsize, int C, int route) {
  return smem_bytes(HB, kd, dsize, C, route);
}

// Clusters of C blocks the card holds at once on `route`.
extern "C" int slate_hb2st_wavefront_clusters(int kd, int dsize, int C, int route, int* count) {
  const void* k = dsize == 8 ? kernel_for<double>(route, true) : kernel_for<float>(route, true);
  return clusters(k, C, smem_bytes(HB, kd, dsize, C, route), count);
}

// The launch's plan for sweeps [j0, j1): G clusters of C blocks, route.
extern "C" int slate_hb2st_wavefront_plan(int n, int kd, int j0, int j1, int dsize, int* G,
                                          int* C, int* route) {
  return dsize == 8 ? plan_for<double>(n, kd, j0, j1, G, C, route)
                    : plan_for<float>(n, kd, j0, j1, G, C, route);
}

// ab: (n, 2kd + 2) band, row stride ld ≥ 2kd + 2.  vt: the zeroed log of
// (j1 − j0, nwin_max, kd + 1) values, nwin_max as _hb_wave_meta gives it
// (checked).  tasks = 0 runs the barriers only.  kd ≥ 4.
extern "C" int slate_hb2st_wavefront_f32(float* ab, int64_t ld, int n, int kd, int j0,
                                         int j1, float* vt, int nwin_max, int tasks,
                                         cudaStream_t stream) {
  return run<float>(ab, ld, n, kd, j0, j1, vt, nwin_max, tasks, stream);
}

extern "C" int slate_hb2st_wavefront_f64(double* ab, int64_t ld, int n, int kd, int j0,
                                         int j1, double* vt, int nwin_max, int tasks,
                                         cudaStream_t stream) {
  return run<double>(ab, ld, n, kd, j0, j1, vt, nwin_max, tasks, stream);
}
