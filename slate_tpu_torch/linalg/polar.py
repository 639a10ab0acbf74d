"""QDWH polar decomposition and the spectral drivers on it — the
counterpart of ``slate_tpu/linalg/polar.py``.

:func:`polar` computes A = U_p·H (U_p a partial isometry, H Hermitian
positive semidefinite) by the dynamically weighted Halley iteration of
Nakatsukasa, Bai & Gygi (2010): at most six iterations for κ up to 1/ε,
each a QR factorization of the stacked ``[√c·X; I]`` (backward stable at
any conditioning) or, once the weight c makes ``I + c·XᴴX``
well-conditioned, a Cholesky factorization and two triangular solves.
Which of the two is the ``qdwh_step`` site's answer.  Every product runs
through the ``matmul`` site (the ``matmul`` kernel for 128-aligned fp32
on the card), the factorizations through ``qr.geqrf_rec``,
``blocks.potrf_rec`` and ``blocks.trsm_rec``.

On it, QDWH-eig and QDWH-SVD (Nakatsukasa & Higham, 2013):

* :func:`heev_qdwh` — spectral divide and conquer: the polar factor of
  A − σI is a matrix sign, its projector splits the spectrum at σ, an
  orthonormal basis from one geqrf rotates A into block-diagonal form,
  and the halves recurse down to a crossover where the two-stage solver
  finishes the small blocks;
* :func:`svd_qdwh` — the polar factor first, then ``heev_qdwh`` of H:
  Σ are H's eigenvalues, V its eigenvectors, U = U_p·V.

The iteration starts from :func:`~slate_tpu_torch.linalg.condest.
spectral_interval`'s ``(alpha, smin)``.  Each divide step mixes with a
matrix drawn on the host from the JAX package's numpy generator and
seed; the draw runs on a worker thread while the card runs the node's
polar iteration.  Timers (metrics on; each waits for the card before it
stops): ``stage.<ns>.qr``, ``.gemm``, ``.chol`` and ``.draw`` (the wait
for the mixing matrix and its upload) with ``<ns>`` ``polar``, ``heev``
or ``svd``, and ``qdwh.draw_host`` (the draw itself, on its thread);
counters ``qdwh.step.qr``, ``qdwh.step.chol`` and
``qdwh.dc.degenerate``.
"""

from __future__ import annotations

import math
import time
from contextlib import contextmanager
from typing import Optional, Tuple

import numpy as np
import torch

from ..enums import Diag, MethodEig, Op, Side, Uplo
from ..ops import blocks
from ..ops.blocks import _ct, matmul
from ..options import Options, get_option
from ..perf import metrics
from ..perf.metrics import instrument_driver
from .blas3 import _arr, _device_of, _nb
from .cholesky import _hermitian_full
from .condest import spectral_interval
from .qr import geqrf_rec, unmqr_rec

__all__ = ["polar", "heev_qdwh", "svd_qdwh"]

#: depth backstop of the divide and conquer: 2^64 exceeds any dimension,
#: so reaching it means a degenerate split loop, and the block goes to
#: the two-stage solver instead
_DC_MAX_DEPTH = 64

#: Halley iterations of one polar decomposition at most: QDWH's bound for
#: κ up to 1/ε (the JAX package's ``qdwh_maxiter`` default)
QDWH_MAXITER = 6

#: block size at or under which the divide and conquer hands a block to
#: the two-stage solver (the ``qdwh_crossover`` option's default)
QDWH_CROSSOVER = 128


@contextmanager
def _timer(ns: str, stage: str, ref):
    """The stage timer ``stage.<ns>.<stage>``; with metrics on it waits
    for ``ref``'s card before it stops, so the stage's device work is in
    it."""
    with metrics.timer("stage.%s.%s" % (ns, stage)):
        yield
        if metrics.enabled() and ref.is_cuda:
            torch.cuda.synchronize(ref.device)


_draws = None


def _draw(n: int, depth: int, np_dtype):
    """The mixing matrix of a divide step at ``depth``: the JAX package's
    generator and seed, drawn in fp64 and rounded to ``np_dtype``."""
    t0 = time.perf_counter()
    g = np.random.default_rng(0x0D_5EED + depth).standard_normal((n, n))
    g = g.astype(np_dtype, copy=False)
    metrics.observe_time("qdwh.draw_host", time.perf_counter() - t0)
    return g


def _start_draw(n: int, depth: int, dt):
    """Start a node's mixing draw on a worker thread, so the host draws
    (512 MB of normals at n = 8192) while the card runs the node's polar
    iteration; returns a future of the host array."""
    global _draws
    if _draws is None:
        from concurrent.futures import ThreadPoolExecutor

        _draws = ThreadPoolExecutor(max_workers=1,
                                    thread_name_prefix="qdwh-draw")
    rdt = torch.empty(0, dtype=dt).real.dtype
    return _draws.submit(_draw, n, depth, np.float32 if rdt == torch.float32
                         else np.float64)


def _halley_weights(l: float) -> Tuple[float, float, float]:
    """Dynamical Halley weights (a, b, c) from the lower bound ``l`` of
    σ_min(X) — Nakatsukasa–Bai–Gygi eq. (2.4); at ``l = 1`` the classical
    Halley (3, 1, 3)."""
    l = min(max(l, 1e-17), 1.0)
    l2 = l * l
    dd = (4.0 * (1.0 - l2) / (l2 * l2)) ** (1.0 / 3.0)
    sq = math.sqrt(1.0 + dd)
    a = sq + 0.5 * math.sqrt(8.0 - 4.0 * dd
                             + 8.0 * (2.0 - l2) / (l2 * sq))
    b = (a - 1.0) ** 2 / 4.0
    return a, b, a + b - 1.0


def _qr_step(x, a_k: float, b_k: float, c_k: float, nb: int, ns: str):
    """One QR-based Halley step: X' = (b/c)·X + (a − b/c)/√c · Q₁Q₂ᴴ from
    the thin QR of ``[√c·X; I]``."""
    m, n = x.shape
    sc = math.sqrt(c_k)
    with _timer(ns, "qr", x):
        stacked = torch.cat([sc * x, torch.eye(n, dtype=x.dtype,
                                               device=x.device)])
        f, taus = geqrf_rec(stacked, nb)
        q = unmqr_rec(f, taus, torch.eye(m + n, n, dtype=x.dtype,
                                         device=x.device),
                      Side.Left, Op.NoTrans, nb)
    with _timer(ns, "gemm", x):
        return ((a_k - b_k / c_k) / sc) * matmul(q[:m], _ct(q[m:])) \
            + (b_k / c_k) * x


def _chol_step(x, a_k: float, b_k: float, c_k: float, nb: int, ns: str):
    """One Cholesky-based Halley step: Z = I + c·XᴴX = WWᴴ, then
    X' = (b/c)·X + (a − b/c)·X·Z⁻¹ by two triangular solves.  A factor
    that fails comes back NaN, as the JAX package's ``lax.linalg.
    cholesky`` returns it, with no host read."""
    n = x.shape[1]
    with _timer(ns, "gemm", x):
        z = c_k * matmul(_ct(x), x) + torch.eye(n, dtype=x.dtype,
                                                device=x.device)
        z = 0.5 * (z + _ct(z))
    with _timer(ns, "chol", x):
        w = blocks.potrf_rec(z, nb, nan_on_fail=True)
        # X·Z⁻¹ = (Z⁻¹·Xᴴ)ᴴ — two left solves on the factor
        t = blocks.trsm_rec(Side.Left, Uplo.Lower, Diag.NonUnit, w, _ct(x),
                            nb)
        s = blocks.trsm_rec(Side.Left, Uplo.Upper, Diag.NonUnit, _ct(w), t,
                            nb)
    return (b_k / c_k) * x + (a_k - b_k / c_k) * _ct(s)


def _polar_u(av, nb: int, opts, ns: str,
             interval: Optional[Tuple[float, float]] = None):
    """The Halley iteration: the polar factor U_p of ``av`` (m ≥ n), its
    timers under ``stage.<ns>.*``."""
    from ..perf import autotune

    m, n = av.shape
    if n == 0:
        return av
    eps = float(torch.finfo(av.dtype).eps)
    if interval is None:
        alpha, smin = spectral_interval(av, opts, device=av.device)
    else:
        alpha, smin = float(interval[0]), float(interval[1])
    if not (alpha > 0.0) or not math.isfinite(alpha):
        # the zero matrix: U_p is any isometry; the canonical one
        return torch.eye(m, n, dtype=av.dtype, device=av.device)
    # l underestimates σ_min(X₀) by design; the ε floor keeps the weight
    # recurrence finite within QDWH's six-iteration bound
    l = min(max(smin / alpha, eps), 1.0)
    x = av / alpha
    it = 0
    while it < QDWH_MAXITER and abs(1.0 - l) > 10.0 * eps:
        a_k, b_k, c_k = _halley_weights(l)
        if autotune.select("qdwh_step", n=n, c=c_k, dtype=av.dtype,
                           device=av.device) == "chol":
            x = _chol_step(x, a_k, b_k, c_k, nb, ns)
            metrics.inc("qdwh.step.chol")
        else:
            x = _qr_step(x, a_k, b_k, c_k, nb, ns)
            metrics.inc("qdwh.step.qr")
        l = l * (a_k + b_k * l * l) / (1.0 + c_k * l * l)
        it += 1
    return x


@instrument_driver("polar")
def polar(a, opts: Optional[Options] = None, *,
          interval: Optional[Tuple[float, float]] = None, device=None):
    """QDWH polar decomposition A = U_p·H: returns ``(U_p, H)``, U_p an
    m×n partial isometry (UᴴU = I) and H = UᴴA symmetrized, Hermitian
    positive semidefinite.  ``interval`` may give ``(alpha ≥ σ_max,
    σ_min estimate)`` (:func:`~slate_tpu_torch.linalg.condest.
    spectral_interval`'s contract); otherwise it is estimated here."""
    dev = _device_of(a, device=device)
    av = _arr(a, dev)
    if av.ndim != 2:
        raise ValueError("polar expects a 2-D matrix")
    m, n = av.shape
    if m < n:
        raise ValueError("polar expects m >= n (factor Aᴴ instead)")
    u = _polar_u(av, _nb(a, opts), opts, "polar", interval)
    with _timer("polar", "gemm", av):
        uh_a = matmul(_ct(u), av)
        h = 0.5 * (uh_a + _ct(uh_a))
    return u, h


# ---------------------------------------------------------------------------
# QDWH-eig: spectral divide and conquer
# ---------------------------------------------------------------------------

def _small_heev(av, opts):
    """Crossover leaf: the two-stage solver on a dense block, past the
    ``eig_driver`` site (a qdwh pin must not recurse back here)."""
    from .eig import _heev_twostage

    return _heev_twostage(av, _nb(av, opts), True,
                          get_option(opts, "method_eig", MethodEig.Auto))


def _dc(av, nb: int, crossover: int, opts, ns: str, depth: int):
    """One divide step: polar of the shifted block → sign projector →
    orthonormal split basis from one geqrf → rotate and recurse on the
    diagonal blocks.  Returns ``(w ascending, Z)``.  The host reads a
    node's diagonal and row sums once, and trace(U_s) once a shift."""
    n = av.shape[-1]
    if n <= crossover or depth >= _DC_MAX_DEPTH:
        return _small_heev(av, opts)
    dt = av.dtype
    draw = _start_draw(n, depth, dt)
    eye = torch.eye(n, dtype=dt, device=av.device)
    diag = torch.diagonal(av)
    host = torch.stack([diag.real, diag.abs(), av.abs().sum(dim=1)]).cpu() \
        .double().numpy()
    dvec, off = host[0], host[2] - host[1]
    # shifts: the mean eigenvalue (trace/n splits any non-constant
    # spectrum), then the Gershgorin midpoint and the diagonal median
    # where the projector degenerates
    shifts = [float(dvec.mean()),
              0.5 * (float((dvec - off).min()) + float((dvec + off).max())),
              float(np.median(dvec))]
    u_s, k = None, 0
    for sigma in shifts:
        u_s = _polar_u(av - sigma * eye, nb, opts, ns)
        # U_s ≈ sign(A − σI): its trace counts (#λ>σ) − (#λ<σ)
        k = int(round((float(torch.diagonal(u_s).sum().real) + n) / 2.0))
        if 0 < k < n:
            break
    else:
        # a flat or fully clustered spectrum: no shift separates it
        metrics.inc("qdwh.dc.degenerate")
        return _small_heev(av, opts)
    p = 0.5 * (u_s + eye)        # spectral projector onto λ > σ
    # deterministic mixing, the JAX package's generator and seed: P·G₁
    # spans range(P) and (I−P)·G₂ its complement almost surely; one QR
    # orthonormalizes both and keeps the leading columns' span
    with _timer(ns, "draw", av):
        g = torch.from_numpy(draw.result()).to(device=av.device).to(dt)
    with _timer(ns, "gemm", av):
        basis = torch.cat([matmul(p, g[:, :k]),
                           g[:, k:] - matmul(p, g[:, k:])], dim=1)
    with _timer(ns, "qr", av):
        f, taus = geqrf_rec(basis, nb)
        v = unmqr_rec(f, taus, eye, Side.Left, Op.NoTrans, nb)
    with _timer(ns, "gemm", av):
        b = matmul(_ct(v), matmul(av, v))
    a1, a2 = b[:k, :k], b[k:, k:]
    w1, z1 = _dc(0.5 * (a1 + _ct(a1)), nb, crossover, opts, ns, depth + 1)
    w2, z2 = _dc(0.5 * (a2 + _ct(a2)), nb, crossover, opts, ns, depth + 1)
    with _timer(ns, "gemm", av):
        zz1 = matmul(v[:, :k], z1)
        zz2 = matmul(v[:, k:], z2)
    return torch.cat([w2, w1]), torch.cat([zz2, zz1], dim=1)


def _heev_qdwh(a, jobz: bool, opts, ns: str, device=None):
    av = _hermitian_full(a, _device_of(a, device=device))
    crossover = max(2, int(get_option(opts, "qdwh_crossover",
                                      QDWH_CROSSOVER)))
    w, z = _dc(av, _nb(a, opts), crossover, opts, ns, 0)
    order = torch.argsort(w)
    return w[order], (z[:, order] if jobz else None)


def heev_qdwh(a, jobz: bool = True, opts: Optional[Options] = None, *,
              device=None):
    """QDWH-eig: the Hermitian eigensolver by spectral divide and conquer
    over the polar factor (Nakatsukasa & Higham, 2013).  The contract of
    :func:`~slate_tpu_torch.linalg.eig.heev` — ``(w ascending, Z | None)``
    — and reachable from it through the ``eig_driver`` site."""
    return _heev_qdwh(a, jobz, opts, "heev", device)


# ---------------------------------------------------------------------------
# QDWH-SVD
# ---------------------------------------------------------------------------

def svd_qdwh(a, jobu: bool = True, jobvt: bool = True,
             opts: Optional[Options] = None, *, device=None):
    """QDWH-SVD: A = U_p·H, then QDWH-eig of the positive semidefinite
    H = VΣVᴴ, so A = (U_p·V)·Σ·Vᴴ.  The contract of
    :func:`~slate_tpu_torch.linalg.svd.svd` — ``(σ descending, U, Vᴴ)``,
    economy, None for a factor not asked for — and reachable from it
    through the ``svd_driver`` site."""
    dev = _device_of(a, device=device)
    av = _arr(a, dev)
    m, n = av.shape
    if m < n:
        s, u, vh = svd_qdwh(_ct(av).resolve_conj(), jobu=jobvt, jobvt=jobu,
                            opts=opts, device=dev)
        return (s, None if vh is None else _ct(vh).resolve_conj(),
                None if u is None else _ct(u).resolve_conj())
    u_p = _polar_u(av, _nb(a, opts), opts, "svd")
    with _timer("svd", "gemm", av):
        uh_a = matmul(_ct(u_p), av)
        h = 0.5 * (uh_a + _ct(uh_a))
    w, v = _heev_qdwh(h, True, opts, "svd", dev)
    # H is positive semidefinite: its eigenvalues reversed are σ
    s = torch.clamp(w.flip(0), min=0)
    vd = v.flip(1)
    u = vh = None
    if jobu:
        with _timer("svd", "gemm", av):
            u = matmul(u_p, vd)
    if jobvt:
        vh = _ct(vd).resolve_conj()
    return s, u, vh
