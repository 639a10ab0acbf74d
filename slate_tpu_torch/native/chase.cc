// Host bulge chases of the two-stage Hermitian eigensolver and SVD: the
// routes of slate_tpu_torch/linalg/eig.py and svd.py that do not take the
// hb2st_wavefront / tb2bd_wavefront kernels — values-only calls, complex
// input, kd < 4, and real fp64 with vectors when the device chase is not
// chosen — copied from the JAX package's host runtime
// (slate_tpu/native/runtime.cc: hb2st_impl :547-625, the Householder task
// bodies and their serial and OpenMP wavefront drivers :634-907, the
// bidiagonal Householder chase :921-1169, the Givens tb2bd_impl
// :1172-1245, apply_rot_seq and apply_rot_skewed :1247-1370, and their C
// entries).  Nothing here calls BLAS or LAPACK.
//
// Build: g++ -O3 -mfma -fopenmp -shared -fPIC chase.cc -o libchase.so (at first
// use, by slate_tpu_torch/native/__init__.py, into build/slate_tpu_torch/).
//
// Layouts (row j of the band array holds column j of the band):
//   hb2st:     lower Hermitian band, ab[j*ldab + d] = A[j+d, j], d in
//              [0, kd+1] (one extra diagonal holds the chase bulge).
//   hb2st_hh:  the same, WIDE: ldab >= 2kd+1 (the bulge block).
//   tb2bd:     upper band, ab[c*ldab + (c-r)+1] = A[r, c], ldab = kd+3.
//   tb2bd_hh:  row-major general band, st[r*ldw + (c-r+kd)] = A[r, c],
//              ldw = 3kd+2 (row r holds row r of the band).

#include <algorithm>
#include <cmath>
#include <complex>
#include <cstdint>
#include <cstdlib>
#include <vector>

#include <omp.h>

namespace {

using cplx = std::complex<double>;

inline double conj_s(double x) { return x; }
inline cplx conj_s(const cplx& x) { return std::conj(x); }
inline double abs_s(double x) { return std::fabs(x); }
inline double abs_s(const cplx& x) { return std::abs(x); }

// Complex-safe Givens: [[c, s], [-conj(s), c]] . [f, g]^T = [r', 0]
// (matches slate_tpu.linalg.eig._givens).
template <typename T>
inline void givens(const T& f, const T& g, double& c, T& s) {
    double absf = abs_s(f), absg = abs_s(g);
    if (absg == 0.0) { c = 1.0; s = T(0); return; }
    double r = std::hypot(absf, absg);
    T signf = absf != 0.0 ? f / absf : T(1);
    c = absf / r;
    s = signf * conj_s(g) / r;
}

// Hermitian two-sided plane rotation in plane (i-1, i) on lower band
// storage, annihilating A[i, i-bw-1] (or the initial A[i, i-bw]).
template <typename T>
inline void hb_rotate(T* ab, int64_t ldab, int64_t n, int64_t bw,
                      int64_t i, double c, const T& s) {
    const T sc = conj_s(s);
    // row pairs: columns left of the plane
    int64_t clo = i - bw - 1; if (clo < 0) clo = 0;
    for (int64_t col = clo; col <= i - 2; ++col) {
        T& x = ab[(i - 1 - col) + col * ldab];
        T& y = ab[(i - col) + col * ldab];
        T nx = c * x + s * y;
        T ny = -sc * x + c * y;
        x = nx; y = ny;
    }
    // 2x2 diagonal block: M' = G M G^H with M = [[a, conj(b)], [b, d]]
    {
        T& aa = ab[0 + (i - 1) * ldab];
        T& bb = ab[1 + (i - 1) * ldab];
        T& dd = ab[0 + i * ldab];
        T a0 = aa, b0 = bb, d0 = dd;
        // row-apply G
        T r00 = c * a0 + s * b0;
        T r01 = c * conj_s(b0) + s * d0;
        T r10 = -sc * a0 + c * b0;
        T r11 = -sc * conj_s(b0) + c * d0;
        // col-apply G^H: (x, y) -> (c x + conj(s) y, -s x + c y)
        aa = c * r00 + sc * r01;
        bb = c * r10 + sc * r11;
        dd = -s * r10 + c * r11;
    }
    // column pairs: rows below the plane
    int64_t rhi = i + bw; if (rhi > n - 1) rhi = n - 1;
    for (int64_t row = i + 1; row <= rhi; ++row) {
        T& x = ab[(row - i + 1) + (i - 1) * ldab];
        T& y = ab[(row - i) + i * ldab];
        T nx = c * x + sc * y;
        T ny = -s * x + c * y;
        x = nx; y = ny;
    }
}

// One full hb2st run; logs (plane, c, s) per rotation when log != null.
//
// Direct-to-tridiagonal schedule (LAPACK sbtrd-style): per column j the
// sub-band entries (j+d, j) are annihilated bottom-up and each bulge is
// chased at stride kd — O(n^2/2) rotations total, vs the O(n^2·ln kd)
// of a diagonal-by-diagonal (Rutishauser) sweep; the back-transform
// cost is proportional to the rotation count, so the schedule choice
// is what makes eigenvectors affordable.
// Per-column log reordering: rotations are generated chase-major
// (d = dmax..2, each chased to the end) but logged chase-DEPTH-major —
// all depth-t rotations of a column are adjacent in the log, forming a
// staircase on kd+1 consecutive rows.  Rotations at different depths
// act on disjoint row pairs (they commute), so the stable reorder keeps
// the factorization Q₂ = Π G_i^H exact while making the back-transform
// walk contiguous row blocks (L1-resident chains instead of stride-kd
// jumps).
template <typename T>
struct RotBuf {
    std::vector<int32_t> plane;
    std::vector<int32_t> depth;
    std::vector<double> c;
    std::vector<T> s;
    std::vector<int64_t> counts;

    void clear() { plane.clear(); depth.clear(); c.clear(); s.clear(); }

    void push(int64_t i, int64_t t, double cc, const T& sv) {
        plane.push_back((int32_t)i);
        depth.push_back((int32_t)t);
        c.push_back(cc);
        s.push_back(sv);
    }

    // stable counting sort by depth into the global log at base
    void flush(int32_t* planes, double* cs, T* ss, int64_t base) {
        int32_t tmax = 0;
        for (int32_t t : depth) tmax = std::max(tmax, t);
        counts.assign((size_t)tmax + 2, 0);
        for (int32_t t : depth) ++counts[(size_t)t + 1];
        for (size_t t = 1; t < counts.size(); ++t) counts[t] += counts[t - 1];
        for (size_t idx = 0; idx < plane.size(); ++idx) {
            int64_t pos = base + counts[(size_t)depth[idx]]++;
            planes[pos] = plane[idx];
            cs[pos] = c[idx];
            ss[pos] = s[idx];
        }
    }
};

template <typename T>
int64_t hb2st_impl(T* ab, int64_t n, int64_t kd, int64_t ldab,
                   int32_t* planes, double* cs, T* ss) {
    int64_t nrot = 0;
    RotBuf<T> buf;
    for (int64_t j = 0; j <= n - 3; ++j) {
        const int64_t dmax = std::min(kd, n - 1 - j);
        if (planes) buf.clear();
        for (int64_t d = dmax; d >= 2; --d) {
            int64_t col = j, i = j + d, t = 0;
            for (;;) {
                double c; T s;
                const T f = ab[(i - 1 - col) + col * ldab];
                const T g = ab[(i - col) + col * ldab];
                givens(f, g, c, s);
                hb_rotate(ab, ldab, n, kd, i, c, s);
                if (planes) buf.push(i, t, c, s);
                if (i + kd >= n) break;
                col = i - 1; i += kd; ++t;
            }
        }
        if (planes) {
            buf.flush(planes, cs, ss, nrot);
            nrot += (int64_t)buf.plane.size();
        } else {
            for (int64_t d = dmax; d >= 2; --d)
                nrot += 1 + (n - 1 - j - d) / kd;
        }
    }
    return nrot;
}

// Upper band storage of the Givens tb2bd chase: ab[c*ldab + (c-r)+1] =
// A[r, c], c-r in [-1, kd+1] (row 0 holds the subdiagonal bulge).
template <typename T>
inline T& ub(T* ab, int64_t ldab, int64_t r, int64_t c) {
    return ab[(c - r + 1) + c * ldab];
}

// Givens band→bidiagonal chase, the direct schedule of hb2st_impl: per
// row j the entries at distance d = dmax..2 are killed by a right
// rotation, whose (p+1, p) bulge a left rotation kills, chased at stride
// kd; both logs depth-major per row.
template <typename T>
int64_t tb2bd_impl(T* ab, int64_t n, int64_t kd, int64_t ldab,
                   int32_t* lplanes, double* lcs, T* lss,
                   int32_t* rplanes, double* rcs, T* rss) {
    int64_t nrot = 0;
    RotBuf<T> lbuf, rbuf;
    for (int64_t j = 0; j <= n - 3; ++j) {
        const int64_t dmax = std::min(kd, n - 1 - j);
        if (lplanes) { lbuf.clear(); rbuf.clear(); }
        for (int64_t d = dmax; d >= 2; --d) {
            int64_t row = j, p = j + d - 1, t = 0;
            for (;;) {
                // right rotation on columns (p, p+1): kill A[row, p+1]
                double c; T s;
                givens(ub(ab, ldab, row, p), ub(ab, ldab, row, p + 1), c, s);
                {
                    const T sc = conj_s(s);
                    int64_t rlo = row; if (rlo < 0) rlo = 0;
                    int64_t rhi = p + 1; if (rhi > n - 1) rhi = n - 1;
                    for (int64_t r2 = rlo; r2 <= rhi; ++r2) {
                        T& x = ub(ab, ldab, r2, p);
                        T& y = ub(ab, ldab, r2, p + 1);
                        // col-apply G^T: (x, y) -> (c x + s y, -s̄ x + c y)
                        // (the right factor is G^T, not G^H: the kill
                        // identity -s̄f + cg = 0 needs the unconjugated s
                        // in the first slot)
                        T nx = c * x + s * y;
                        T ny = -sc * x + c * y;
                        x = nx; y = ny;
                    }
                }
                if (rplanes) rbuf.push(p + 1, t, c, s);
                // left rotation on rows (p, p+1): kill the (p+1, p) bulge
                givens(ub(ab, ldab, p, p), ub(ab, ldab, p + 1, p), c, s);
                {
                    const T sc = conj_s(s);
                    int64_t chi = p + kd + 1; if (chi > n - 1) chi = n - 1;
                    for (int64_t c2 = p; c2 <= chi; ++c2) {
                        T& x = ub(ab, ldab, p, c2);
                        T& y = ub(ab, ldab, p + 1, c2);
                        T nx = c * x + s * y;
                        T ny = -sc * x + c * y;
                        x = nx; y = ny;
                    }
                }
                if (lplanes) lbuf.push(p + 1, t, c, s);
                if (p + 1 + kd >= n) break;
                row = p; p += kd; ++t;
            }
        }
        if (lplanes) {
            lbuf.flush(lplanes, lcs, lss, nrot);
            rbuf.flush(rplanes, rcs, rss, nrot);
            nrot += (int64_t)lbuf.plane.size();
        } else {
            for (int64_t d = dmax; d >= 2; --d)
                nrot += 1 + (n - 1 - j - d) / kd;
        }
    }
    return nrot;
}

// ---------------------------------------------------------------------
// Householder-based band→tridiagonal chase (SLATE's hebr1/2/3 schedule,
// src/internal/internal_hebr.cc; Bischof–Lang SBR): one length-≤kd
// reflector per chase step instead of kd Givens rotations.  Same
// O(n²·kd) band work, but the logged reflectors of one sweep occupy
// DISJOINT adjacent row windows — so the eigenvector back-transform
// becomes per-sweep batched WY gemms on the accelerator (the reference
// applies its V blocks the same way in unmtr_hb2st.cc), instead of
// 6-flop rotation streaming on the host.
//
// Storage: lower band, ab[c*ldab + (i-c)] = A[i, c]; the bulge block
// spans i-c ≤ 2·kd−1, so callers hand a WIDE band with ldab ≥ 2kd+1.
// Real double only (the complex path keeps the Givens chase).
// ---------------------------------------------------------------------

inline double real_s(double x) { return x; }
inline double real_s(const cplx& x) { return x.real(); }
inline double imag_s(double) { return 0.0; }
inline double imag_s(const cplx& x) { return x.imag(); }

// larfg, LAPACK convention (zlarfg for complex: H^H x = beta e1 with
// beta REAL — the property that makes the chased tridiagonal real)
template <typename T>
static inline void larfg_t(int64_t L, T* x, T& tau) {
    double xnorm = 0.0;
    for (int64_t i = 1; i < L; ++i) xnorm = std::hypot(xnorm, abs_s(x[i]));
    T alpha = x[0];
    if (xnorm == 0.0 && imag_s(alpha) == 0.0) { tau = T(0); return; }
    double beta = -std::copysign(std::hypot(abs_s(alpha), xnorm),
                                 real_s(alpha));
    tau = (T(beta) - alpha) / T(beta);
    T scal = T(1.0) / (alpha - T(beta));
    for (int64_t i = 1; i < L; ++i) x[i] *= scal;
    x[0] = T(beta);
}

template <typename T>
struct HhLogT {
    T* v;             // (cap, kd) row-major; v[0] stores beta's slot = 1
    T* tau;           // (cap,)
    int32_t* row0;    // (cap,)
    int32_t* len;     // (cap,)
    int64_t kd;
    int64_t count = 0;

    void push(int64_t r0, int64_t L, const T* vv, T tv) {
        put(count, r0, L, vv, tv);
        ++count;
    }

    // positional write (wavefront scheduling: per-sweep bases keep the
    // serial log layout while tasks complete out of sweep order)
    void put(int64_t idx, int64_t r0, int64_t L, const T* vv, T tv) {
        if (!v) return;
        T* dst = v + idx * kd;
        for (int64_t i = 0; i < L; ++i) dst[i] = vv[i];
        for (int64_t i = L; i < kd; ++i) dst[i] = T(0);
        tau[idx] = tv;
        row0[idx] = (int32_t)r0;
        len[idx] = (int32_t)L;
    }
};

using HhLog = HhLogT<double>;

// Hermitian two-sided reflector application on the stored lower band:
// S ← Hᴴ·S·H over rows/cols [r, r+L), H = I − τ·v·vᴴ.  Derivation:
// with x = τ·S·v and w = x − ½·τ̄·(vᴴx)·v, the update is
// S −= w·vᴴ + v·wᴴ (vᴴSv is real, so τ̄(vᴴx) is real up to rounding).
template <typename T>
static void hh_two_sided(T* ab, int64_t ldab, int64_t r, int64_t L,
                         const T* v, T tau, T* w) {
    auto Sv = [&](int64_t i, int64_t c) -> T {
        return (i >= c) ? ab[(r + c) * ldab + (i - c)]
                        : conj_s(ab[(r + i) * ldab + (c - i)]);
    };
    for (int64_t i = 0; i < L; ++i) {
        T acc = T(0);
        for (int64_t c = 0; c < L; ++c) acc += Sv(i, c) * v[c];
        w[i] = tau * acc;
    }
    T dot = T(0);
    for (int64_t i = 0; i < L; ++i) dot += conj_s(v[i]) * w[i];
    T half = 0.5 * conj_s(tau) * dot;
    for (int64_t i = 0; i < L; ++i) w[i] -= half * v[i];
    for (int64_t c = 0; c < L; ++c)
        for (int64_t i = c; i < L; ++i)
            ab[(r + c) * ldab + (i - c)] -=
                v[i] * conj_s(w[c]) + w[i] * conj_s(v[c]);
}

// Sweep-range serial chase: see hb2st_hh_impl_range below the shared
// per-window task bodies (it drives the SAME hb_sweep_start/step code
// the wavefront runs — a separate textual copy of those loops lets the
// compiler contract complex multiply-adds into FMAs differently per
// copy, which broke the serial-vs-wavefront BITWISE identity for c128).

// ---------------------------------------------------------------------
// OpenMP wavefront for the Householder chase (reference: the task-DAG
// wavefront of src/hb2st.cc:23-90).  Decomposition recorded in STATUS
// r4: task (sweep j, window w) touches band rows
// [j+1+(w-1)kd, j+1+(w+1)kd) (+1 row for the trailing length-1
// coupling apply, which still leaves a >= kd-2 row gap); with stagger
// t = 3j + w, same-t tasks are disjoint and every conflicting pair is
// ordered — deps (j, w-1) at t-1, (j-1, w+2) at t-1, (j-1, w+1) at
// t-2 — so a per-t `omp parallel for` over j is BITWISE-identical to
// the serial chase (each task's arithmetic is unchanged; only disjoint
// tasks reorder).  Log slots are written positionally at per-sweep
// bases, reproducing the serial log layout exactly.
// ---------------------------------------------------------------------

static int64_t hb_sweep_nwin(int64_t n, int64_t kd, int64_t j) {
    int64_t L = std::min(kd, n - 1 - j);
    if (L < 2) return 0;
    int64_t cnt = 1, r0 = j + 1;
    for (;;) {
        int64_t r1 = r0 + L;
        int64_t Lt = std::min(kd, n - r1);
        if (Lt < 2) break;
        ++cnt; r0 = r1; L = Lt;
    }
    return cnt;
}

template <typename T>
struct HbSweepT {
    std::vector<T> v;
    T tau = T(0);
    int64_t r0 = 0, L = 0, base = 0, nwin = 0;
};

// trailing coupling apply for a finished window when the next block is
// a single row (the serial loop's Lt==1 right-apply-then-break)
template <typename T>
static void hb_sweep_tail(T* ab, int64_t n, int64_t kd, int64_t ldab,
                          HbSweepT<T>& st) {
    auto BA = [&](int64_t i, int64_t c) -> T& {
        return ab[c * ldab + (i - c)];
    };
    int64_t r1 = st.r0 + st.L;
    int64_t Lt = std::min(kd, n - r1);
    if (Lt != 1) return;
    T acc = T(0);
    for (int64_t c = 0; c < st.L; ++c) acc += BA(r1, st.r0 + c) * st.v[c];
    acc *= st.tau;
    for (int64_t c = 0; c < st.L; ++c)
        BA(r1, st.r0 + c) -= acc * conj_s(st.v[c]);
}

template <typename T>
static void hb_sweep_start(T* ab, int64_t n, int64_t kd, int64_t ldab,
                           HhLogT<T>& log, int64_t j, HbSweepT<T>& st,
                           T* wbuf) {
    auto BA = [&](int64_t i, int64_t c) -> T& {
        return ab[c * ldab + (i - c)];
    };
    int64_t L = std::min(kd, n - 1 - j);
    int64_t r0 = j + 1;
    for (int64_t i = 0; i < L; ++i) st.v[i] = BA(r0 + i, j);
    larfg_t(L, st.v.data(), st.tau);
    BA(r0, j) = st.v[0];
    for (int64_t i = 1; i < L; ++i) BA(r0 + i, j) = T(0);
    st.v[0] = T(1);
    hh_two_sided(ab, ldab, r0, L, st.v.data(), st.tau, wbuf);
    log.put(st.base, r0, L, st.v.data(), st.tau);
    st.r0 = r0; st.L = L;
    if (st.nwin == 1) hb_sweep_tail(ab, n, kd, ldab, st);
}

template <typename T>
static void hb_sweep_step(T* ab, int64_t n, int64_t kd, int64_t ldab,
                          HhLogT<T>& log, int64_t w, HbSweepT<T>& st,
                          T* wbuf, T* colbuf) {
    auto BA = [&](int64_t i, int64_t c) -> T& {
        return ab[c * ldab + (i - c)];
    };
    int64_t r0 = st.r0, L = st.L;
    int64_t r1 = r0 + L;
    int64_t Lt = std::min(kd, n - r1);   // >= 2 by nwin scheduling
    for (int64_t i = 0; i < Lt; ++i) {
        T acc = T(0);
        for (int64_t c = 0; c < L; ++c) acc += BA(r1 + i, r0 + c) * st.v[c];
        acc *= st.tau;
        for (int64_t c = 0; c < L; ++c)
            BA(r1 + i, r0 + c) -= acc * conj_s(st.v[c]);
    }
    for (int64_t i = 0; i < Lt; ++i) colbuf[i] = BA(r1 + i, r0);
    T tau2;
    larfg_t(Lt, colbuf, tau2);
    BA(r1, r0) = colbuf[0];
    for (int64_t i = 1; i < Lt; ++i) BA(r1 + i, r0) = T(0);
    colbuf[0] = T(1);
    for (int64_t c = 1; c < L; ++c) {
        T acc = T(0);
        for (int64_t i = 0; i < Lt; ++i)
            acc += conj_s(colbuf[i]) * BA(r1 + i, r0 + c);
        acc *= conj_s(tau2);
        for (int64_t i = 0; i < Lt; ++i)
            BA(r1 + i, r0 + c) -= acc * colbuf[i];
    }
    hh_two_sided(ab, ldab, r1, Lt, colbuf, tau2, wbuf);
    log.put(st.base + w, r1, Lt, colbuf, tau2);
    for (int64_t i = 0; i < Lt; ++i) st.v[i] = colbuf[i];
    st.tau = tau2; st.r0 = r1; st.L = Lt;
    if (w == st.nwin - 1) hb_sweep_tail(ab, n, kd, ldab, st);
}

// Sweep-range variant: factors sweeps j in [j0, j1) only.  The band is
// the complete state between calls, so a caller can checkpoint it and
// regenerate any chunk's reflector log later — the streaming that keeps
// the O(n^2/2) chase log off the host (pheev's distributed middle).
// Runs the wavefront's task bodies in serial (sweep-major) order: one
// compiled copy of the window arithmetic, so the wavefront's bitwise
// identity to this path cannot be broken by per-copy FMA contraction.
template <typename T>
static int64_t hb2st_hh_impl_range(T* ab, int64_t n, int64_t kd,
                                   int64_t ldab, HhLogT<T>& log,
                                   int64_t j0, int64_t j1) {
    if (j1 > n - 2) j1 = n - 2;
    std::vector<T> scratch((size_t)(2 * kd));
    T* wbuf = scratch.data();
    T* colbuf = wbuf + kd;
    HbSweepT<T> st;
    int64_t total = 0;
    for (int64_t j = j0; j < j1; ++j) {
        int64_t nwin = hb_sweep_nwin(n, kd, j);
        if (nwin == 0) continue;
        st.base = total;
        st.nwin = nwin;
        st.v.assign((size_t)kd, T(0));
        hb_sweep_start(ab, n, kd, ldab, log, j, st, wbuf);
        for (int64_t w = 1; w < nwin; ++w)
            hb_sweep_step(ab, n, kd, ldab, log, w, st, wbuf, colbuf);
        total += nwin;
    }
    log.count = total;
    return total;
}

template <typename T>
static int64_t hb2st_hh_wave(T* ab, int64_t n, int64_t kd,
                             int64_t ldab, HhLogT<T>& log,
                             int64_t j0, int64_t j1) {
    if (j1 > n - 2) j1 = n - 2;
    if (j0 >= j1) return 0;
    const int64_t nsweep = j1 - j0;
    std::vector<HbSweepT<T>> st((size_t)nsweep);
    int64_t total = 0, nwin_max = 0, tmax = -1;
    for (int64_t js = 0; js < nsweep; ++js) {
        auto& s = st[(size_t)js];
        s.base = total;
        s.nwin = hb_sweep_nwin(n, kd, j0 + js);
        s.v.assign((size_t)kd, T(0));
        total += s.nwin;
        nwin_max = std::max(nwin_max, s.nwin);
        if (s.nwin) tmax = std::max(tmax, 3 * js + s.nwin - 1);
    }
    const int nthr = omp_get_max_threads();
    std::vector<T> scratch((size_t)nthr * 2 * (size_t)kd);
    for (int64_t t = 0; t <= tmax; ++t) {
        const int64_t js_hi = std::min(nsweep - 1, t / 3);
        const int64_t js_lo = std::max<int64_t>(
            0, (t - nwin_max + 1 + 2) / 3);
        #pragma omp parallel for schedule(static)
        for (int64_t js = js_lo; js <= js_hi; ++js) {
            const int64_t w = t - 3 * js;
            auto& s = st[(size_t)js];
            if (w < 0 || w >= s.nwin) continue;
            T* wbuf = scratch.data()
                + (size_t)omp_get_thread_num() * 2 * (size_t)kd;
            T* colbuf = wbuf + kd;
            if (w == 0)
                hb_sweep_start(ab, n, kd, ldab, log, j0 + js, s, wbuf);
            else
                hb_sweep_step(ab, n, kd, ldab, log, w, s, wbuf, colbuf);
        }
    }
    log.count = total;
    return total;
}

static bool chase_serial() {
    const char* e = getenv("SLATE_TPU_TORCH_CHASE_SERIAL");
    return e && e[0] && e[0] != '0';
}

static int64_t hb2st_hh_impl(double* ab, int64_t n, int64_t kd,
                             int64_t ldab, HhLog& log) {
    if (chase_serial())
        return hb2st_hh_impl_range(ab, n, kd, ldab, log, 0, n - 2);
    return hb2st_hh_wave(ab, n, kd, ldab, log, 0, n - 2);
}

// ---------------------------------------------------------------------
// Householder band→bidiagonal chase (SLATE's gebr1/2/3 task partition,
// src/internal/internal_gebr.cc + src/tb2bd.cc block slicing): per sweep
// s, a right reflector kills row s beyond the superdiagonal, a left
// reflector kills the resulting first-column bulge, then per chase block
// b: left-apply the previous U to the off-diagonal block, generate the
// next right reflector from its first row, right-apply it to the
// diagonal block, generate the next left reflector from its first
// column.  Both logs have the per-sweep disjoint kd-strided window
// structure (U rows and V columns from s+1) that the batched WY
// back-transform needs.
//
// Storage: row-major general band st[r*ldw + (c-r+kd)], c-r in
// [-kd, 2kd+1], ldw = 3kd+2.  Real double only.
//
// The wavefront has the structure of hb2st_hh_wave: task (s, b) touches
// rows and columns [s+1+(b-1)kd, s+1+(b+1)kd) at stagger t = 3s + b,
// with two positional logs.  The serial range runs the same task bodies
// in sweep order, so the two are bitwise equal.
// ---------------------------------------------------------------------

static int64_t tb_sweep_nblk(int64_t n, int64_t kd, int64_t s) {
    int64_t c_lo = s + 1, c_hi = std::min(s + kd, n - 1);
    int64_t r_hi = std::min(s + kd, n - 1);
    if (c_hi <= c_lo && r_hi <= s + 1) return 0;
    int64_t cnt = 1;
    for (int64_t b = 1; b * kd + 1 + s <= n - 1; ++b) ++cnt;
    return cnt;
}

struct TbSweep {
    std::vector<double> u;
    double tauu = 0.0;
    int64_t base = 0, nblk = 0;
};

static void tb_sweep_start(double* stm, int64_t n, int64_t kd, int64_t ldw,
                           HhLog& ulog, HhLog& vlog, int64_t s,
                           TbSweep& sw, double* xbuf) {
    auto A = [&](int64_t r, int64_t c) -> double& {
        return stm[r * ldw + (c - r + kd)];
    };
    int64_t c_lo = s + 1, c_hi = std::min(s + kd, n - 1);
    int64_t r_hi = std::min(s + kd, n - 1);
    int64_t Lv = c_hi - c_lo + 1;
    double tauv = 0.0;
    // right reflector v0 from row s (keep A[s, s+1])
    for (int64_t c = 0; c < Lv; ++c) xbuf[c] = A(s, c_lo + c);
    larfg_t(Lv, xbuf, tauv);
    A(s, c_lo) = xbuf[0];
    for (int64_t c = 1; c < Lv; ++c) A(s, c_lo + c) = 0.0;
    xbuf[0] = 1.0;
    for (int64_t r = s + 1; r <= r_hi; ++r) {
        double acc = 0.0;
        for (int64_t c = 0; c < Lv; ++c) acc += A(r, c_lo + c) * xbuf[c];
        acc *= tauv;
        for (int64_t c = 0; c < Lv; ++c) A(r, c_lo + c) -= acc * xbuf[c];
    }
    vlog.put(sw.base, c_lo, Lv, xbuf, tauv);
    // left reflector u0 from column s+1 below the diagonal
    int64_t Lu = r_hi - s;
    for (int64_t r = 0; r < Lu; ++r) sw.u[(size_t)r] = A(s + 1 + r, c_lo);
    larfg_t(Lu, sw.u.data(), sw.tauu);
    A(s + 1, c_lo) = sw.u[0];
    for (int64_t r = 1; r < Lu; ++r) A(s + 1 + r, c_lo) = 0.0;
    sw.u[0] = 1.0;
    for (int64_t c = c_lo + 1; c <= c_hi; ++c) {
        double acc = 0.0;
        for (int64_t r = 0; r < Lu; ++r) acc += sw.u[(size_t)r] * A(s + 1 + r, c);
        acc *= sw.tauu;
        for (int64_t r = 0; r < Lu; ++r) A(s + 1 + r, c) -= acc * sw.u[(size_t)r];
    }
    ulog.put(sw.base, s + 1, Lu, sw.u.data(), sw.tauu);
}

static void tb_sweep_block(double* stm, int64_t n, int64_t kd, int64_t ldw,
                           HhLog& ulog, HhLog& vlog, int64_t s, int64_t b,
                           TbSweep& sw, double* xbuf) {
    auto A = [&](int64_t r, int64_t c) -> double& {
        return stm[r * ldw + (c - r + kd)];
    };
    int64_t i_lo = (b - 1) * kd + 1 + s;
    int64_t i_hi = std::min(i_lo + kd - 1, n - 1);
    int64_t j_lo = b * kd + 1 + s;
    int64_t j_hi = std::min(j_lo + kd - 1, n - 1);
    int64_t Li = i_hi - i_lo + 1, Lj = j_hi - j_lo + 1;
    double tauv = 0.0;
    // gebr2: left-apply u_{b-1} to the off-diagonal block
    for (int64_t c = j_lo; c <= j_hi; ++c) {
        double acc = 0.0;
        for (int64_t r = 0; r < Li; ++r) acc += sw.u[(size_t)r] * A(i_lo + r, c);
        acc *= sw.tauu;
        for (int64_t r = 0; r < Li; ++r) A(i_lo + r, c) -= acc * sw.u[(size_t)r];
    }
    // next right reflector from the block's first row
    for (int64_t c = 0; c < Lj; ++c) xbuf[c] = A(i_lo, j_lo + c);
    larfg_t(Lj, xbuf, tauv);
    A(i_lo, j_lo) = xbuf[0];
    for (int64_t c = 1; c < Lj; ++c) A(i_lo, j_lo + c) = 0.0;
    xbuf[0] = 1.0;
    for (int64_t r = i_lo + 1; r <= i_hi; ++r) {
        double acc = 0.0;
        for (int64_t c = 0; c < Lj; ++c) acc += A(r, j_lo + c) * xbuf[c];
        acc *= tauv;
        for (int64_t c = 0; c < Lj; ++c) A(r, j_lo + c) -= acc * xbuf[c];
    }
    vlog.put(sw.base + b, j_lo, Lj, xbuf, tauv);
    // gebr3: right-apply it to the diagonal block
    for (int64_t r = j_lo; r <= j_hi; ++r) {
        double acc = 0.0;
        for (int64_t c = 0; c < Lj; ++c) acc += A(r, j_lo + c) * xbuf[c];
        acc *= tauv;
        for (int64_t c = 0; c < Lj; ++c) A(r, j_lo + c) -= acc * xbuf[c];
    }
    // next left reflector from the block's first column
    for (int64_t r = 0; r < Lj; ++r) sw.u[(size_t)r] = A(j_lo + r, j_lo);
    larfg_t(Lj, sw.u.data(), sw.tauu);
    A(j_lo, j_lo) = sw.u[0];
    for (int64_t r = 1; r < Lj; ++r) A(j_lo + r, j_lo) = 0.0;
    sw.u[0] = 1.0;
    for (int64_t c = j_lo + 1; c <= j_hi; ++c) {
        double acc = 0.0;
        for (int64_t r = 0; r < Lj; ++r) acc += sw.u[(size_t)r] * A(j_lo + r, c);
        acc *= sw.tauu;
        for (int64_t r = 0; r < Lj; ++r) A(j_lo + r, c) -= acc * sw.u[(size_t)r];
    }
    ulog.put(sw.base + b, j_lo, Lj, sw.u.data(), sw.tauu);
}

// Sweeps s in [s0, s1) in serial sweep order (the band is the whole
// state between calls: a caller can checkpoint it and regenerate any
// chunk's two logs later).
static int64_t tb2bd_hh_impl_range(double* stm, int64_t n, int64_t kd,
                                   int64_t ldw, HhLog& ulog, HhLog& vlog,
                                   int64_t s0, int64_t s1) {
    if (s1 > n - 1) s1 = n - 1;
    std::vector<double> xbuf((size_t)kd);
    TbSweep sw;
    int64_t total = 0;
    for (int64_t s = s0; s < s1; ++s) {
        int64_t nblk = tb_sweep_nblk(n, kd, s);
        if (nblk == 0) continue;
        sw.base = total;
        sw.nblk = nblk;
        sw.u.assign((size_t)kd, 0.0);
        tb_sweep_start(stm, n, kd, ldw, ulog, vlog, s, sw, xbuf.data());
        for (int64_t b = 1; b < nblk; ++b)
            tb_sweep_block(stm, n, kd, ldw, ulog, vlog, s, b, sw, xbuf.data());
        total += nblk;
    }
    ulog.count = total;
    vlog.count = total;
    return total;
}

static int64_t tb2bd_hh_wave(double* stm, int64_t n, int64_t kd,
                             int64_t ldw, HhLog& ulog, HhLog& vlog,
                             int64_t s0, int64_t s1) {
    if (s1 > n - 1) s1 = n - 1;   // sweeps s in [s0, s1) ⊆ [0, n-2]
    if (s0 >= s1) return 0;
    const int64_t nsweep = s1 - s0;
    std::vector<TbSweep> sw((size_t)nsweep);
    int64_t total = 0, nblk_max = 0, tmax = -1;
    for (int64_t ss = 0; ss < nsweep; ++ss) {
        auto& w = sw[(size_t)ss];
        w.base = total;
        w.nblk = tb_sweep_nblk(n, kd, s0 + ss);
        w.u.assign((size_t)kd, 0.0);
        total += w.nblk;
        nblk_max = std::max(nblk_max, w.nblk);
        if (w.nblk) tmax = std::max(tmax, 3 * ss + w.nblk - 1);
    }
    const int nthr = omp_get_max_threads();
    std::vector<double> scratch((size_t)nthr * (size_t)kd);
    for (int64_t t = 0; t <= tmax; ++t) {
        const int64_t ss_hi = std::min(nsweep - 1, t / 3);
        const int64_t ss_lo = std::max<int64_t>(
            0, (t - nblk_max + 1 + 2) / 3);
        #pragma omp parallel for schedule(static)
        for (int64_t ss = ss_lo; ss <= ss_hi; ++ss) {
            const int64_t b = t - 3 * ss;
            auto& w = sw[(size_t)ss];
            if (b < 0 || b >= w.nblk) continue;
            double* xbuf = scratch.data()
                + (size_t)omp_get_thread_num() * (size_t)kd;
            if (b == 0)
                tb_sweep_start(stm, n, kd, ldw, ulog, vlog, s0 + ss, w,
                               xbuf);
            else
                tb_sweep_block(stm, n, kd, ldw, ulog, vlog, s0 + ss, b, w,
                               xbuf);
        }
    }
    ulog.count = total;
    vlog.count = total;
    return total;
}

static int64_t tb2bd_hh(double* st, int64_t n, int64_t kd, int64_t ldw,
                        HhLog& ulog, HhLog& vlog, int64_t s0, int64_t s1) {
    if (chase_serial())
        return tb2bd_hh_impl_range(st, n, kd, ldw, ulog, vlog, s0, s1);
    return tb2bd_hh_wave(st, n, kd, ldw, ulog, vlog, s0, s1);
}

// Apply a logged rotation sequence in reverse to Z (n x k, row-major):
// mode 0: G^H = [[c, -s], [s̄, c]]   (unmtr_hb2st / unmbr_tb2bd Left)
// mode 1:       [[c, -s̄], [s, c]]   (unmbr_tb2bd Right)
// OpenMP-parallel over column blocks; each thread streams the whole
// rotation log over its block (rows of Z are contiguous).
template <typename T, int MODE>
void apply_rot_seq_t(int64_t n, int64_t k, T* z, const int32_t* planes,
                     const double* cs, const T* ss, int64_t nrot) {
    const int64_t blk = 512;
#pragma omp parallel for schedule(dynamic)
    for (int64_t b0 = 0; b0 < k; b0 += blk) {
        const int64_t w = std::min(blk, k - b0);
        for (int64_t idx = nrot - 1; idx >= 0; --idx) {
            const int64_t i = planes[idx];
            const double c = cs[idx];
            const T s = ss[idx];
            const T m01 = (MODE == 0) ? -s : -conj_s(s);
            const T m10 = (MODE == 0) ? conj_s(s) : s;
            T* __restrict zu = z + (i - 1) * k + b0;
            T* __restrict zl = z + i * k + b0;
            for (int64_t t = 0; t < w; ++t) {
                T u = zu[t], v = zl[t];
                zu[t] = c * u + m01 * v;
                zl[t] = m10 * u + c * v;
            }
        }
    }
}

template <typename T>
void apply_rot_seq(int64_t n, int64_t k, T* z, const int32_t* planes,
                   const double* cs, const T* ss, int64_t nrot, int mode) {
    if (mode == 0)
        apply_rot_seq_t<T, 0>(n, k, z, planes, cs, ss, nrot);
    else
        apply_rot_seq_t<T, 1>(n, k, z, planes, cs, ss, nrot);
}

// Skewed-wavefront applier for logs produced by hb2st_impl / tb2bd_impl
// (direct schedule, depth-major per column).  The flat reverse sweep
// streams every active row of Z once per band column — L3-bandwidth
// bound.  Here a block of B columns advances bottom-up in lockstep,
// column j trailing column j+1 by two chase depths, so a row window is
// revisited B times while still cache-resident.
//
// Legality: rotations of groups (j2,t2), (j1,t1) with j2 > j1 conflict
// only when their row windows [j+1+t·kd, j+kd+t·kd] overlap, which
// forces t1−t2 < Δj/kd + 1; the schedule time g(j,t) = (tmax_j − t) +
// 2·(jhi−1−j) then gives g2 − g1 ≤ (Δj/kd + 1) − 2Δj < 0, i.e. the
// higher column is always applied first, exactly as in the flat
// reverse order.  Groups at equal g are provably row-disjoint, and
// same-column groups at different depths are row-disjoint too, so the
// remaining ordering freedom is genuine commutation.
template <typename T, int MODE>
void apply_rot_skewed_t(int64_t n, int64_t k, T* z, const int32_t* planes,
                        const double* cs, const T* ss, int64_t kd) {
    const int64_t ncols = std::max<int64_t>(n - 2, 0);
    std::vector<int64_t> coloff((size_t)ncols + 1, 0);
    for (int64_t j = 0; j < ncols; ++j) {
        const int64_t dmax = std::min(kd, n - 1 - j);
        int64_t tot = 0;
        for (int64_t d = dmax; d >= 2; --d) tot += 1 + (n - 1 - j - d) / kd;
        coloff[(size_t)j + 1] = coloff[(size_t)j] + tot;
    }
    auto cnt_jt = [&](int64_t j, int64_t t) {
        int64_t dtop = std::min(std::min(kd, n - 1 - j), n - 1 - j - t * kd);
        return std::max<int64_t>(dtop - 1, 0);
    };
    const int64_t W = 512;
    const int64_t B = 64;
#pragma omp parallel for schedule(dynamic)
    for (int64_t w0 = 0; w0 < k; w0 += W) {
        const int64_t w = std::min(W, k - w0);
        std::vector<int64_t> gstart;
        for (int64_t jhi = ncols; jhi > 0; jhi -= B) {
            const int64_t jlo = std::max<int64_t>(jhi - B, 0);
            const int64_t nb = jhi - jlo;
            const int64_t ntg = (n - 3 - jlo) / kd + 1;
            gstart.assign((size_t)(nb * ntg), 0);
            for (int64_t j = jlo; j < jhi; ++j) {
                int64_t acc = coloff[(size_t)j];
                const int64_t tmax_j = (n - 3 - j) / kd;
                for (int64_t t = 0; t <= tmax_j; ++t) {
                    gstart[(size_t)((j - jlo) * ntg + t)] = acc;
                    acc += cnt_jt(j, t);
                }
            }
            const int64_t gmax = (n - 3 - jlo) / kd + 2 * (jhi - 1 - jlo);
            for (int64_t g = 0; g <= gmax; ++g) {
                for (int64_t j = jhi - 1; j >= jlo; --j) {
                    const int64_t tmax_j = (n - 3 - j) / kd;
                    const int64_t t = tmax_j - (g - 2 * (jhi - 1 - j));
                    if (t < 0 || t > tmax_j) continue;
                    const int64_t cnt = cnt_jt(j, t);
                    if (cnt <= 0) continue;
                    const int64_t s0 = gstart[(size_t)((j - jlo) * ntg + t)];
                    for (int64_t e = s0 + cnt - 1; e >= s0; --e) {
                        const int64_t i = planes[e];
                        const double c = cs[e];
                        const T s = ss[e];
                        const T m01 = (MODE == 0) ? -s : -conj_s(s);
                        const T m10 = (MODE == 0) ? conj_s(s) : s;
                        T* __restrict zu = z + (i - 1) * k + w0;
                        T* __restrict zl = z + i * k + w0;
                        for (int64_t x = 0; x < w; ++x) {
                            T u = zu[x], v = zl[x];
                            zu[x] = c * u + m01 * v;
                            zl[x] = m10 * u + c * v;
                        }
                    }
                }
            }
        }
    }
}

template <typename T>
void apply_rot_skewed(int64_t n, int64_t k, T* z, const int32_t* planes,
                      const double* cs, const T* ss, int64_t kd, int mode) {
    if (mode == 0)
        apply_rot_skewed_t<T, 0>(n, k, z, planes, cs, ss, kd);
    else
        apply_rot_skewed_t<T, 1>(n, k, z, planes, cs, ss, kd);
}

}  // namespace

extern "C" {

int slate_host_num_threads() { return omp_get_max_threads(); }

// test hook: the wavefront-chase identity sweeps thread counts in one
// process (OMP_NUM_THREADS is read once at startup)
void slate_set_num_threads(int n) { omp_set_num_threads(n > 0 ? n : 1); }

int64_t slate_hb2st_f64(double* ab, int64_t n, int64_t kd, int64_t ldab,
                        int32_t* planes, double* cs, double* ss) {
    return hb2st_impl<double>(ab, n, kd, ldab, planes, cs, ss);
}

int64_t slate_hb2st_c128(void* ab, int64_t n, int64_t kd, int64_t ldab,
                         int32_t* planes, double* cs, void* ss) {
    return hb2st_impl<cplx>((cplx*)ab, n, kd, ldab, planes, cs, (cplx*)ss);
}

int64_t slate_hb2st_hh_range_f64(double* ab, int64_t n, int64_t kd,
                                 int64_t ldab, double* v, double* tau,
                                 int32_t* row0, int32_t* length,
                                 int64_t j0, int64_t j1) {
    HhLog log{v, tau, row0, length, kd};
    if (chase_serial())
        return hb2st_hh_impl_range(ab, n, kd, ldab, log, j0, j1);
    return hb2st_hh_wave(ab, n, kd, ldab, log, j0, j1);
}

int64_t slate_hb2st_hh_f64(double* ab, int64_t n, int64_t kd, int64_t ldab,
                           double* v, double* tau, int32_t* row0,
                           int32_t* len) {
    HhLog log{v, tau, row0, len, kd};
    return hb2st_hh_impl(ab, n, kd, ldab, log);
}

// Complex-Hermitian Householder chase (zhbtrd-equivalent): zlarfg makes
// every chased sub-diagonal beta REAL, so the tridiagonal is real.
int64_t slate_hb2st_hh_range_c128(void* ab, int64_t n, int64_t kd,
                                  int64_t ldab, void* v, void* tau,
                                  int32_t* row0, int32_t* length,
                                  int64_t j0, int64_t j1) {
    HhLogT<cplx> log{(cplx*)v, (cplx*)tau, row0, length, kd};
    if (chase_serial())
        return hb2st_hh_impl_range<cplx>((cplx*)ab, n, kd, ldab, log,
                                         j0, j1);
    return hb2st_hh_wave<cplx>((cplx*)ab, n, kd, ldab, log, j0, j1);
}

int64_t slate_tb2bd_hh_f64(double* st, int64_t n, int64_t kd, int64_t ldw,
                           double* uv, double* utau, int32_t* urow0,
                           int32_t* ulen, double* vv, double* vtau,
                           int32_t* vrow0, int32_t* vlen) {
    HhLog ulog{uv, utau, urow0, ulen, kd};
    HhLog vlog{vv, vtau, vrow0, vlen, kd};
    return tb2bd_hh(st, n, kd, ldw, ulog, vlog, 0, n - 1);
}

// Sweeps [s0, s1) of the bidiagonal chase: the band is the whole state
// between calls.
int64_t slate_tb2bd_hh_range_f64(double* st, int64_t n, int64_t kd,
                                 int64_t ldw, double* uv, double* utau,
                                 int32_t* urow0, int32_t* ulen,
                                 double* vv, double* vtau,
                                 int32_t* vrow0, int32_t* vlen,
                                 int64_t s0, int64_t s1) {
    HhLog ulog{uv, utau, urow0, ulen, kd};
    HhLog vlog{vv, vtau, vrow0, vlen, kd};
    return tb2bd_hh(st, n, kd, ldw, ulog, vlog, s0, s1);
}

int64_t slate_tb2bd_f64(double* ab, int64_t n, int64_t kd, int64_t ldab,
                        int32_t* lplanes, double* lcs, double* lss,
                        int32_t* rplanes, double* rcs, double* rss) {
    return tb2bd_impl<double>(ab, n, kd, ldab, lplanes, lcs, lss,
                              rplanes, rcs, rss);
}

int64_t slate_tb2bd_c128(void* ab, int64_t n, int64_t kd, int64_t ldab,
                         int32_t* lplanes, double* lcs, void* lss,
                         int32_t* rplanes, double* rcs, void* rss) {
    return tb2bd_impl<cplx>((cplx*)ab, n, kd, ldab, lplanes, lcs,
                            (cplx*)lss, rplanes, rcs, (cplx*)rss);
}

void slate_apply_rot_seq_f64(int64_t n, int64_t k, double* z,
                             const int32_t* planes, const double* cs,
                             const double* ss, int64_t nrot, int mode) {
    apply_rot_seq<double>(n, k, z, planes, cs, ss, nrot, mode);
}

void slate_apply_rot_seq_c128(int64_t n, int64_t k, void* z,
                              const int32_t* planes, const double* cs,
                              const void* ss, int64_t nrot, int mode) {
    apply_rot_seq<cplx>(n, k, (cplx*)z, planes, cs, (const cplx*)ss,
                        nrot, mode);
}

void slate_apply_rot_skewed_f64(int64_t n, int64_t k, double* z,
                                const int32_t* planes, const double* cs,
                                const double* ss, int64_t kd, int mode) {
    apply_rot_skewed<double>(n, k, z, planes, cs, ss, kd, mode);
}

void slate_apply_rot_skewed_c128(int64_t n, int64_t k, void* z,
                                 const int32_t* planes, const double* cs,
                                 const void* ss, int64_t kd, int mode) {
    apply_rot_skewed<cplx>(n, k, (cplx*)z, planes, cs, (const cplx*)ss,
                           kd, mode);
}

}  // extern "C"
