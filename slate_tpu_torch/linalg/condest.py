"""Condition estimation: norm1est, gecondest, pocondest, trcondest, and
the shared probes refine_kappa_eps and spectral_interval — the
counterpart of ``slate_tpu/linalg/condest.py`` (reference
``internal_norm1est.cc``, ``src/gecondest.cc``, ``src/trcondest.cc``).

The estimator is host-driven, as in the JAX package: a handful of
data-dependent iterations whose bookkeeping is numpy in fp64 (complex128
for complex factors), each one solve on the card.  A closure takes the
host probe to the factor's device and dtype and brings its answer back
(the JAX package casts at the closure boundary in refine_kappa_eps and
spectral_interval, ``condest.py:147-150, 211-219``; the port must cast
in every closure, since torch's triangular solves take one dtype).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..enums import Diag, Norm, Op, Side, Uplo  # noqa: F401
from ..ops import blocks
from ..ops.blocks import _ct
from ..options import Options
from .blas3 import _arr, _device_of, _nb
from .norms import norm as _norm


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().resolve_conj().numpy()
    return np.asarray(getattr(t, "array", t))


def _on(ref):
    """A closure argument: the host probe as a tensor of ``ref``'s dtype
    on ``ref``'s device."""
    def to(v):
        return torch.as_tensor(np.asarray(v)).to(device=ref.device,
                                                 dtype=ref.dtype)
    return to


def norm1est(apply_a: Callable, apply_ah: Callable, n: int,
             dtype=np.float64, maxiter: int = 5) -> float:
    """Estimate ‖A‖₁ given closures x ↦ A·x and x ↦ Aᴴ·x over host
    (n, 1) numpy probes — Higham–Tisseur power iteration on the 1-norm
    dual (LAPACK ``lacn2``; reference ``internal::norm1est``)."""
    x = np.ones((n, 1), dtype=dtype) / n
    est = 0.0
    for _ in range(maxiter):
        y = _host(apply_a(x))
        est_new = float(np.abs(y).sum())
        xi = np.where(y == 0, 1.0, np.sign(y.real) +
                      (1j * np.sign(y.imag) if np.iscomplexobj(y) else 0))
        z = _host(apply_ah(xi.astype(x.dtype)))
        j = int(np.argmax(np.abs(z.real)))
        if est_new <= est:
            break
        est = est_new
        if np.abs(z.real[j]) <= np.abs(np.vdot(z.ravel(), x.ravel())):
            break
        x = np.zeros((n, 1), dtype=dtype)
        x[j] = 1.0
    return est


def _est_dtype(t):
    return np.dtype(np.complex128 if t.is_complex() else np.float64)


def gecondest(norm_type: Norm, lu, perm, anorm: Optional[float] = None,
              opts: Optional[Options] = None, *, device=None) -> float:
    """Reciprocal condition estimate from an LU factorization — reference
    ``slate::gecondest``: rcond = 1/(‖A‖₁·est‖A⁻¹‖₁)."""
    from .lu import getrs

    dev = _device_of(lu, device=device)
    luv = _arr(lu, dev)
    n = luv.shape[-1]
    if anorm is None:
        raise ValueError("gecondest requires anorm (norm of the original A)")
    if anorm == 0 or n == 0:
        return 0.0 if n else 1.0
    to = _on(luv)

    def solve(x):
        return getrs(luv, perm, to(x), opts=opts, device=dev)

    def solve_h(x):
        return getrs(luv, perm, to(x), op=Op.ConjTrans, opts=opts, device=dev)

    ainv_norm = norm1est(solve, solve_h, n, dtype=_est_dtype(luv))
    return 1.0 / (float(anorm) * ainv_norm) if ainv_norm else 0.0


def pocondest(norm_type: Norm, chol_factor, anorm: Optional[float] = None,
              opts: Optional[Options] = None, *, device=None) -> float:
    """Reciprocal condition estimate from a Cholesky factorization —
    reference ``slate::pocondest``."""
    from .cholesky import potrs

    if anorm is None:
        raise ValueError("pocondest requires anorm")
    dev = _device_of(chol_factor, device=device)
    lv = _arr(chol_factor, dev)
    n = lv.shape[-1]
    if anorm == 0 or n == 0:
        return 0.0 if n else 1.0
    to = _on(lv)

    def solve(x):
        return potrs(chol_factor, to(x), opts, device=dev)

    ainv_norm = norm1est(solve, solve, n, dtype=_est_dtype(lv))
    return 1.0 / (float(anorm) * ainv_norm) if ainv_norm else 0.0


def trcondest(norm_type: Norm, a, uplo: Optional[Uplo] = None,
              diag: Diag = Diag.NonUnit, opts: Optional[Options] = None, *,
              device=None) -> float:
    """Reciprocal condition estimate of a triangular matrix — reference
    ``slate::trcondest``."""
    dev = _device_of(a, device=device)
    av = _arr(a, dev)
    n = av.shape[-1]
    if n == 0:
        return 1.0
    uplo = uplo or getattr(a, "logical_uplo", Uplo.Upper)
    nb = _nb(a, opts)
    anorm = float(_norm(norm_type, a, opts, device=dev))
    if anorm == 0:
        return 0.0
    to = _on(av)

    def solve(x):
        return blocks.trsm_rec(Side.Left, uplo, diag, av, to(x), nb)

    def solve_h(x):
        flip = Uplo.Lower if uplo is Uplo.Upper else Uplo.Upper
        return blocks.trsm_rec(Side.Left, flip, diag, _ct(av), to(x), nb)

    ainv_norm = norm1est(solve, solve_h, n, dtype=_est_dtype(av))
    return 1.0 / (anorm * ainv_norm) if ainv_norm else 0.0


# ---------------------------------------------------------------------------
# Shared condition probes: the mixed-precision split legs and QDWH
# ---------------------------------------------------------------------------

def refine_kappa_eps(apply_inv, apply_inv_h, n: int, anorm: float, lo,
                     power: int = 1) -> float:
    """κ·ε condition probe of the mixed-precision split-factor legs:
    estimate ‖A⁻¹‖₁ with :func:`norm1est` from solve closures whose host
    probes are cast to the low precision ``lo`` (a torch dtype) HERE,
    form κ = anorm·est and return κ**power · n · ε(lo); a non-finite
    estimate collapses to ``inf``.  The closures place the probe on
    their factor's device."""
    def _cast(fn):
        return lambda v: fn(torch.as_tensor(np.asarray(v)).to(lo))

    dt = np.dtype(np.complex128 if lo.is_complex else np.float64)
    ainv = norm1est(_cast(apply_inv), _cast(apply_inv_h), n, dtype=dt)
    kappa = float(anorm) * float(ainv)
    ke = (kappa ** power) * float(n) * float(torch.finfo(lo).eps)
    return ke if math.isfinite(ke) else math.inf


def spectral_interval(a, opts: Optional[Options] = None, *, device=None,
                      ) -> Tuple[float, float]:
    """Two-sided singular-spectrum interval ``(alpha, smin_est)``:
    alpha ≥ σ_max(A) (√(‖A‖₁·‖A‖∞), raised to a two-pass power-iteration
    lower bound where that is larger) and smin_est a deliberately LOW
    estimate of σ_min(A), 1/(√n·est‖R⁻¹‖₁) from the triangular QR factor
    R of A.  Costs one ``geqrf_rec`` of A plus O(n²) estimator sweeps.
    Its caller in the JAX package is QDWH (``polar.py``)."""
    from .qr import geqrf_rec

    dev = _device_of(a, device=device)
    av = _arr(a, dev)
    if av.ndim != 2:
        raise ValueError("spectral_interval expects a 2-D matrix")
    m, n = av.shape
    if m < n:                      # σ(A) = σ(Aᴴ); factor the tall side
        av = _ct(av)
        m, n = n, m
    if n == 0:
        return 0.0, 0.0
    nb = _nb(a, opts)
    abs_a = av.abs()
    n1 = float(abs_a.sum(dim=0).amax())
    ninf = float(abs_a.sum(dim=1).amax())
    alpha = math.sqrt(n1 * ninf)
    if alpha == 0.0 or not math.isfinite(alpha):
        return alpha, 0.0
    x = torch.as_tensor(1.0 + np.cos(np.arange(n, dtype=np.float64))).to(
        device=av.device, dtype=av.dtype)
    low = 0.0
    for _ in range(2):
        y = av @ x
        nx = float(torch.linalg.vector_norm(x))
        if nx == 0.0:
            break
        low = float(torch.linalg.vector_norm(y)) / nx
        x = _ct(av) @ y
    alpha = max(alpha, low)
    f, _taus = geqrf_rec(av.resolve_conj(), nb)
    r = torch.triu(f[:n])
    to = _on(r)

    def solve(v):
        return blocks.trsm_rec(Side.Left, Uplo.Upper, Diag.NonUnit, r,
                               to(v), nb)

    def solve_h(v):
        return blocks.trsm_rec(Side.Left, Uplo.Lower, Diag.NonUnit, _ct(r),
                               to(v), nb)

    rinv = norm1est(solve, solve_h, n, dtype=_est_dtype(av))
    if not (rinv > 0.0) or not math.isfinite(rinv):
        return alpha, 0.0
    smin = 1.0 / (rinv * math.sqrt(n))
    return alpha, min(smin, alpha)
