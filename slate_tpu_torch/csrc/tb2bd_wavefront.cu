// Householder upper band → bidiagonal bulge chase over sweeps [s0, s1) in
// ONE cooperative launch of thread-block clusters, IN PLACE on the
// row-major general band: the port of the Pallas kernel `tb2bd_wavefront`
// (slate_tpu/ops/pallas_kernels.py :2226, body _tb2bd_wave_kernel
// :2084-2208), stage 2 of the two-stage SVD (slate_tpu_torch/linalg/svd.py,
// one launch per svd).
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
// dependence crosses a t boundary, as in hb2st_wavefront.cu.  The grid
// walks t = 0 … tmax with one release/acquire grid barrier after each
// stagger, cluster g running the live tasks js ≡ g (mod G); at most
// nl = nblk_max/3 + 2 tasks are live: 12 and about 24,600 staggers at
// n = 8192, kd = 256.  The left reflector a block carries to the next,
// which the TPU kernel keeps in a VMEM ring (state_u, state_tau), is read
// back from the U log row some cluster wrote at t − 1.
//
// A task (chase.cuh) runs on a cluster of C blocks on the transposed view
// of chase.cuh (a row of A is a contiguous column there, so a left
// reflection of A is a right reflection of the view): the off-diagonal
// block O = A[i_lo : i_lo+kd, d0 : d0+L] split by A's rows, the diagonal
// block D = A[d0 : d0+L]² by A's columns.  Block b ≥ 1 (tb_sweep_block):
// the previous u on O (O·u as exchange 1); every block updates O's first
// row the same way and runs larfg on it for v; the u and v applies to O's
// other rows stay in each block, as one rank-2 update; v on D (vᵀ·D as
// exchange 2); every block updates D's first column from the exchanged
// vector and runs larfg on it for the next u; the v and u applies to D's
// other columns stay in each block, as one rank-2 update.  Block 0
// (tb_sweep_start) has no O: v comes from row s of A.  What bounds it on
// an H100: about 16·kd² FLOP a block task and 8·kd² a start task, 1.1e11
// FLOP at n = 8192, kd = 256 (chip_smoke.py's tb2bd_flops), ~1.6 ms at the
// fp32 peak; but the ~24,600 dependent staggers, each a grid barrier, set
// a floor of their own (PERF.md).

#include "chase.cuh"

namespace {

using namespace chase;

template <typename T>
struct Params {
  T* st;         // (n, 3kd + 2) band, row stride ld
  int64_t ld;
  T* ut;         // (nsweeps, nblk_max, kd + 1) left log, zeroed
  T* vt;         // the right log, zeroed
  int n, kd, s0, nsweeps, nblk_max, tmax, C;
  unsigned* bar;  // the staggers' barrier counter, zeroed
};

template <typename T>
__device__ void put_log(T* row, T tau, const T* x, int kd) {
  for (int i = threadIdx.x; i <= kd; i += NT) row[i] = i == 0 ? tau : x[i - 1];
}

// Task (sweep sw, block b) on block `rank` of its cluster.
template <typename T, bool SM>
__device__ void task(const Params<T>& p, Smem<T>& s, Exchange<T>& ex, int rank, int sw, int b,
                     T* urow, T* vrow) {
  const int tid = threadIdx.x, n = p.n, kd = p.kd, sh = share(kd, p.C);
  const int64_t cs = p.ld - 1;
  // D = A[d0 : d0+L]² as the view M(i, c) = A[d0 + c, d0 + i]: entry
  // (i, c) at gD + c·cs + i; this block's view rows [r0, r0 + nr), in
  // shared memory at Ds + c·(sh + 1) + i − r0
  const int64_t i_lo = (int64_t)(b - 1) * kd + 1 + sw, d0 = b == 0 ? sw + 1 : i_lo + kd;
  const int L = (int)min((int64_t)kd, b == 0 ? n - 1 - sw : n - d0);
  T* gD = p.st + d0 * cs + d0 + kd;
  T* Os = s.win;
  T* Ds = s.win + (int64_t)sh * kd;
  const int r0 = rank * sh, nr = max(0, min(sh, L - r0));
  const int des = SM ? sh + 1 : (int)cs;
  // view row r0 + k as a column of the transposed passes: entry c at p[c·des]
  auto drow = [=](int k) {
    return Col<T>{SM ? Ds + k : gD + r0 + k, r0 + k, 0};
  };
  auto drow1 = [=](int k) {
    Col<T> m = drow(k);
    if (m.c == 0) m.lo = L;
    return m;
  };
  // O = A[i_lo : i_lo+kd, d0 : d0+L] as the view: entry (i, c) at gO + c·cs + i;
  // this block's view columns [b0, b0 + nb), in shared memory at Os + (c − b0)·kd + i
  T* gO = p.st + i_lo * cs + d0 + kd;
  const int b0 = rank * sh, nb = b == 0 ? 0 : max(0, min(sh, kd - b0));
  auto ocol = [=](int k) {
    const int c = b0 + k;
    return Col<T>{SM ? Os + (int64_t)k * kd : gO + c * cs, c, 0};
  };
  auto ocol1 = [=](int k) {
    Col<T> m = ocol(k);
    if (m.c == 0) m.lo = L;
    return m;
  };
  ex.k = 0;
  // D's view row 0 (A's column d0), which every block needs for the next u
  T pre[PRE];
#pragma unroll
  for (int q = 0; q < PRE; ++q) {
    const int c = tid + q * NT;
    pre[q] = c < L ? __ldcg(gD + c * cs) : T(0);
  }
  T* row = p.st + (int64_t)sw * p.ld + kd + 1;       // A[s, s + 1 + c]
  const T* prev = urow - (kd + 1);
  const T tau_p = b > 0 ? __ldcg(prev) : T(0);
  // this block's share of the window: O's view columns (runs of L), D's
  // view rows (for each column c, a run of nr), in shared memory on route
  // SMEM
  const auto o_part = part(
      nb * L, L, [=](int k, int t) { return gO + (b0 + k) * cs + t; },
      [=](int k, int t) { return Os + k * kd + t; });
  const auto d_part = part(
      L * nr, nr, [=](int c, int t) { return gD + c * cs + r0 + t; },
      [=](int c, int t) { return Ds + c * (sh + 1) + t; });
  // the right reflector's source (block 0: row s of A; else O's first view
  // column) and the previous u, beside the window's loads
  const T* src = b == 0 ? row : gO;
  auto vec = [&] {
    const T x = tid < L ? __ldcg(src + tid) : T(0);
    const T y = b > 0 && tid < kd ? __ldcg(prev + 1 + tid) : T(0);
    for (int i = tid + NT; i < L; i += NT) s.v[i] = __ldcg(src + i);
    for (int c = tid + NT; b > 0 && c < kd; c += NT) s.u[c] = __ldcg(prev + 1 + c);
    if (tid < L) s.v[tid] = x;
    if (b > 0 && tid < kd) s.u[tid] = y;
  };
  if (SM)
    copy_in<T>(o_part, d_part, vec);
  else
    vec();
  __syncthreads();
  CHASE_PHASE(PH_LOAD);
  T tauv, beta;
  if (b == 0) {
    tauv = larfg(s.v, L, kd, s.red, &beta);
  } else {
    // the previous u on O's rows (the view's columns): y = O·u summed over
    // the cluster, O −= τ'·y·uᵀ; every block updates its copy of row 0
    ex.ready();
    rowdot<SM>(L, nb, ocol, 1, s.u, s.x, s.part);
    ex.sum(s.y, L);
    const T *y = s.y, *u = s.u, *v = s.v, *y2 = s.y2;
    for (int i = tid; i < L; i += NT) s.v[i] = s.v[i] - tau_p * y[i] * u[0];
    __syncthreads();
    tauv = larfg(s.v, L, kd, s.red, &beta);
    // v on O's other rows, O' − v·τv·y2ᵀ with y2 = vᵀO' = vᵀO − τ'·(vᵀy)·uᵀ:
    // with the u apply, one rank-2 update of O
    T vy = 0;
    for (int i = tid; i < L; i += NT) vy += v[i] * y[i];
    vy = tau_p * block_sum(vy, s.red);
    T* y2w = s.y2;
    coldot<SM>(L, nb, ocol1, 1, 0, s.v, [=](int k, int c, T d) { y2w[k] = d - vy * u[c]; });
    update<SM>(L, nb, ocol1, 1, s.y, s.v,
               [=](int k, int c) { return Coef<T>{tau_p * u[c], tauv * y2[k]}; });
    if (rank == 0)
      for (int i = tid; i < L; i += NT) ocol(0).p[i] = i == 0 ? beta : T(0);
  }
  // v on D: y = vᵀ·D summed over the cluster (each block its view rows),
  // D −= v·τv·yᵀ; every block updates its copy of D's view row 0
#pragma unroll
  for (int q = 0; q < PRE; ++q)
    if (tid + q * NT < L) s.u[tid + q * NT] = pre[q];
  for (int c = tid + PRE * NT; c < L; c += NT) s.u[c] = __ldcg(gD + c * cs);
  ex.ready();
  rowdot<SM>(L, nr, drow, des, s.v, s.x, s.part);
  ex.sum(s.y, L);
  if (b == 0 && rank == 0)
    for (int c = tid; c < L; c += NT) row[c] = c == 0 ? beta : T(0);   // every block has read it
  // the next u from D's view row 0 after the update, the same in every
  // block; then its apply to the other view rows, D' − τu·y2·uᵀ with
  // y2 = D'u = D·u − v·τv·(yᵀu): with the v apply, one rank-2 update of D
  for (int c = tid; c < L; c += NT) s.u[c] = s.u[c] - s.v[0] * tauv * s.y[c];
  __syncthreads();
  T betau;
  const T tauu = larfg(s.u, L, kd, s.red, &betau);
  T yu = 0;
  for (int c = tid; c < L; c += NT) yu += s.y[c] * s.u[c];
  yu = tauv * block_sum(yu, s.red);
  {
    const T *v = s.v, *y2 = s.y2;
    T* y2w = s.y2;
    coldot<SM>(L, nr, drow1, des, 0, s.u,
               [=](int k, int i, T d) { y2w[k] = d - v[i] * yu; });
    update<SM>(L, nr, drow1, des, s.y, s.u,
               [=](int k, int i) { return Coef<T>{tauv * v[i], tauu * y2[k]}; });
  }
  if (rank == 0)
    for (int c = tid; c < L; c += NT) drow(0).p[c * des] = c == 0 ? betau : T(0);
  CHASE_PHASE(PH_PASS);
  if (SM) {
    copy_out(o_part);
    copy_out(d_part);
  }
  if (rank == 0) {
    put_log(vrow, tauv, s.v, kd);
    put_log(urow, tauu, s.u, kd);
  }
  __syncthreads();
  CHASE_PHASE(PH_STORE);
}

// TASKS = false runs the same grid and barriers with every task skipped:
// the barriers' share of the chase.
template <typename T, bool SM, bool TASKS>
__global__ void __launch_bounds__(NT, 1) tb2bd_wavefront_kernel(Params<T> p) {
  extern __shared__ __align__(16) unsigned char raw[];
  Smem<T> s(raw, p.kd, p.C);
  const int rank = (int)cg::this_cluster().block_rank();
  const int g = (int)blockIdx.x / p.C, G = (int)gridDim.x / p.C;
  ColumnBarrier stagger{p.bar, gridDim.x, 0u};
  Exchange<T> ex{s.x, p.C, 0, false};
  for (int t = 0; t <= p.tmax; ++t) {
    const int js_lo = max((t - p.nblk_max + 3) / 3, 0);
    const int js_hi = min(t / 3, p.nsweeps - 1);
    if (TASKS) {
      for (int js = js_lo + g; js <= js_hi; js += G) {
        const int sw = p.s0 + js, b = t - 3 * js;
        const int nblk = (p.n - 2 - sw) / p.kd + 1;
        if (b < 0 || b >= nblk) continue;
        const int64_t off = ((int64_t)js * p.nblk_max + b) * (p.kd + 1);
        task<T, SM>(p, s, ex, rank, sw, b, p.ut + off, p.vt + off);
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
    return tasks ? (const void*)tb2bd_wavefront_kernel<T, true, true>
                 : (const void*)tb2bd_wavefront_kernel<T, true, false>;
  return tasks ? (const void*)tb2bd_wavefront_kernel<T, false, true>
               : (const void*)tb2bd_wavefront_kernel<T, false, false>;
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
int plan_for(int n, int kd, int s0, int s1, int* G, int* C, int* route) {
  int nsweeps, tmax, nl;
  if (kd < 4 || s0 < 0) return (int)cudaErrorInvalidValue;
  wave_meta(n, kd, s0, s1, &nsweeps, &tmax, &nl);
  if (nsweeps == 0) nl = 1;
  return plan(TB, kd, (int)sizeof(T), nl, [](int rt) { return kernel_for<T>(rt, true); }, G, C,
              route);
}

template <typename T>
int run(T* st, int64_t ld, int n, int kd, int s0, int s1, T* ut, T* vt, int nblk_max,
        int tasks, cudaStream_t stream) {
  int nsweeps, tmax, nl;
  if (kd < 4 || ld < 3 * kd + 2 || s0 < 0 ||
      wave_meta(n, kd, s0, s1, &nsweeps, &tmax, &nl) != nblk_max)
    return (int)cudaErrorInvalidValue;
  if (nsweeps == 0) return 0;
  int G = 0, C = 0, route = 0, err;
  if ((err = plan_for<T>(n, kd, s0, s1, &G, &C, &route)) != 0) return err;
  unsigned* bar = nullptr;
  if ((err = new_counter(&bar, stream)) != 0) return err;
  Params<T> p{st, ld, ut, vt, n, kd, s0, nsweeps, nblk_max, tmax, C, bar};
  return launch(kernel_for<T>(route, tasks != 0), &p, G, C,
                smem_bytes(TB, kd, (int)sizeof(T), C, route), bar, stream);
}

}  // namespace

// Dynamic shared memory of one block at cluster size C on `route` (0: the
// window in shared memory, 1: in the band), dsize = 4 or 8
// (ops/smem.py chase_block_bytes).
extern "C" int64_t slate_tb2bd_wavefront_smem_bytes(int kd, int dsize, int C, int route) {
  return smem_bytes(TB, kd, dsize, C, route);
}

// Clusters of C blocks the card holds at once on `route`.
extern "C" int slate_tb2bd_wavefront_clusters(int kd, int dsize, int C, int route, int* count) {
  const void* k = dsize == 8 ? kernel_for<double>(route, true) : kernel_for<float>(route, true);
  return clusters(k, C, smem_bytes(TB, kd, dsize, C, route), count);
}

// The launch's plan for sweeps [s0, s1): G clusters of C blocks, route.
extern "C" int slate_tb2bd_wavefront_plan(int n, int kd, int s0, int s1, int dsize, int* G,
                                          int* C, int* route) {
  return dsize == 8 ? plan_for<double>(n, kd, s0, s1, G, C, route)
                    : plan_for<float>(n, kd, s0, s1, G, C, route);
}

// st: (n, 3kd + 2) band, row stride ld ≥ 3kd + 2.  ut, vt: the zeroed logs
// of (s1 − s0, nblk_max, kd + 1) values each, s1 clipped to n − 2 and
// nblk_max as _tb_wave_meta gives it (checked).  tasks = 0 runs the
// barriers only.  kd ≥ 4.
extern "C" int slate_tb2bd_wavefront_f32(float* st, int64_t ld, int n, int kd, int s0,
                                         int s1, float* ut, float* vt, int nblk_max,
                                         int tasks, cudaStream_t stream) {
  return run<float>(st, ld, n, kd, s0, s1, ut, vt, nblk_max, tasks, stream);
}

extern "C" int slate_tb2bd_wavefront_f64(double* st, int64_t ld, int n, int kd, int s0,
                                         int s1, double* ut, double* vt, int nblk_max,
                                         int tasks, cudaStream_t stream) {
  return run<double>(st, ld, n, kd, s0, s1, ut, vt, nblk_max, tasks, stream);
}
