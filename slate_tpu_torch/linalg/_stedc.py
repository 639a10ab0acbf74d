"""Divide-and-conquer symmetric tridiagonal eigensolver (Cuppen).

Re-design of the reference's distributed ``stedc`` stack —
``src/stedc.cc`` (driver), ``src/stedc_solve.cc`` (recursion),
``src/stedc_merge.cc`` (rank-one merge), ``src/stedc_deflate.cc`` (595
LoC, deflation of tiny/duplicate z-components), ``src/stedc_secular.cc``
(271 LoC, secular-equation roots), ``src/stedc_sort.cc`` (eigenvalue
ordering), ``src/stedc_z_vector.cc`` (coupling vector) — with the same
stage decomposition as public functions.

Numerical scheme (LAPACK ``dlaed1/2/3/4`` lineage):

* split T at the midpoint and tear the coupling ``e_m`` into a rank-one
  update ``T = diag(T₁', T₂') + ρ·z·zᵀ`` with ``ρ = 2|e_m| > 0``, the
  sign of ``e_m`` folded into z's second half;
* deflate z-components below ``8·ε·max(|d|,|ρ z|)`` and near-duplicate
  poles (a Givens rotation zeroes one of the two z-components);
* solve the secular equation ``1 + ρ·Σ zⱼ²/(dⱼ−λ) = 0`` for all k roots
  *simultaneously* with a vectorized bisection — the stage the reference
  distributes over ranks (``stedc_secular.cc``) becomes a data-parallel
  (k,k) iteration, unconditionally convergent and branch-free;
* recompute ẑ from the computed roots by the Gu–Eisenstat interlacing
  product (LAPACK ``dlaed3``) so eigenvectors stay orthogonal to machine
  precision even for clustered spectra;
* assemble Q = diag(Q₁,Q₂)·P·[S | deflated columns], then sort.

Everything is float64 host NumPy (the reference's tridiagonal stages
also run per-rank on the host, ``src/heev.cc:141-176``); the (k,k)
vectorized stages are the shape a jnp port shards over the mesh.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = [
    "stedc", "stedc_deflate", "stedc_merge", "stedc_secular",
    "stedc_solve", "stedc_sort", "stedc_z_vector",
]

#: below this size the QR algorithm beats a merge step (SMLSIZ analog,
#: reference stedc.cc)
_SMLSIZ = 32


def _steqr_base(d, e):
    from scipy.linalg import eigh_tridiagonal
    if d.size == 1:
        return d.copy(), np.ones((1, 1))
    return eigh_tridiagonal(d, e)


def stedc_z_vector(q1_last_row: np.ndarray, q2_first_row: np.ndarray,
                   sign: float = 1.0) -> np.ndarray:
    """Rank-one coupling vector from the boundary rows of the sub-problem
    eigenvector matrices — reference ``stedc_z_vector.cc``:
    ``z = (1/√2)·[Q₁ᵀ·e_last; ±Q₂ᵀ·e_first]`` (the ± carries the sign of
    the torn off-diagonal so that ρ = 2|e_m| stays positive).  ‖z‖ = 1.
    """

    return np.concatenate([q1_last_row, sign * q2_first_row]) / np.sqrt(2.0)


def stedc_sort(d: np.ndarray, q: Optional[np.ndarray] = None):
    """Ascending eigenvalue sort with matching column permutation of Q —
    reference ``stedc_sort.cc``.  Returns ``(d_sorted, Q_sorted)``."""

    order = np.argsort(d, kind="stable")
    return (d[order], q[:, order] if q is not None else None)


def stedc_deflate(d: np.ndarray, z: np.ndarray, rho: float):
    """Deflation stage — reference ``stedc_deflate.cc`` (LAPACK
    ``dlaed2``).

    Given ascending poles ``d`` and unit-norm coupling ``z``, returns
    ``(keep, d_upd, z_upd, givens)``:

    * ``keep``  — boolean mask of entries that stay in the secular
      problem (a pole with negligible coupling is already an eigenpair);
      ``d_upd[keep] / z_upd[keep]`` is the reduced secular problem and
      ``d_upd[~keep]`` are finished eigenvalues,
    * ``d_upd, z_upd`` — poles/couplings after the deflation rotations
      (a rotation updates *both* diagonal entries of the pair, dlaed2),
    * ``givens`` — ``(i, j, c, s)`` rotations applied; the caller
      applies the same rotations to the corresponding Q columns.
    """

    n = d.size
    absd = np.abs(d).max() if n else 0.0
    absz = np.abs(z).max() if n else 0.0
    tol = 8.0 * np.finfo(np.float64).eps * max(absd, abs(rho) * absz, 1e-300)

    keep = np.abs(rho * z) > tol
    d = d.copy()
    z = z.copy()
    givens = []
    # rotate near-duplicate poles (ascending d ⇒ only live neighbours can
    # collide).  dlaed2's criterion: the rotation that merges the two
    # couplings leaves an off-diagonal element c·s·(d_b − d_a); the pair
    # deflates iff that element is negligible (absolute tol).  The
    # rotated 2×2 diagonal block replaces both d's; the kept value stays
    # inside (d_a, d_b), so the ascending order of live poles survives.
    live = np.flatnonzero(keep)
    for a, b in zip(live[:-1], live[1:]):
        r = np.hypot(z[a], z[b])
        if r == 0.0:
            continue
        c, s = z[b] / r, z[a] / r
        if abs(c * s * (d[b] - d[a])) <= tol:
            z[b], z[a] = r, 0.0
            keep[a] = False
            da, db = d[a], d[b]
            d[a] = c * c * da + s * s * db
            d[b] = s * s * da + c * c * db
            givens.append((int(a), int(b), float(c), float(s)))
    return keep, d, z, givens


def stedc_secular(dk: np.ndarray, zk: np.ndarray, rho: float,
                  iters: int = 110):
    """Secular-equation roots — reference ``stedc_secular.cc`` (LAPACK
    ``dlaed4``), vectorized over all k roots at once.

    Solves ``f(λ) = 1 + ρ·Σⱼ zⱼ²/(dⱼ−λ) = 0`` with ``ρ > 0`` and
    ascending ``dk``; root i lies in ``(d_i, d_{i+1})``, the last in
    ``(d_k, d_k + ρ‖z‖²)``.

    Each root is computed in a *shifted frame* ``λᵢ = σᵢ + μᵢ`` with the
    origin σᵢ at the nearer interval end (chosen by the sign of f at the
    midpoint, as in dlaed4), so pole differences ``dⱼ − λᵢ`` are formed
    as ``(dⱼ − σᵢ) − μᵢ`` without catastrophic cancellation.  f is
    increasing on each interval, so bisection over the whole batch —
    a branch-free (k,k) dense iteration, the shape the reference
    distributes over ranks — converges unconditionally.  110 halvings
    (not ~55) because a barely-undeflated root can sit within
    ~ρ·z²_min ≈ 1e-28·gap of its pole: resolving μ down to that scale is
    what keeps the recomputed ẑ (and hence the residual) at ε; stopping
    at fp64-ulp-of-λ accuracy perturbs ẑ by √μ_err ≈ 1e-9.

    Returns ``(lam, dmat)`` where ``dmat[j, i] = dⱼ − λᵢ`` is the
    stably-computed difference matrix that the eigenvector stage
    (``dlaed3``) consumes.
    """

    k = dk.size
    if k == 0:
        return np.empty(0), np.empty((0, 0))
    z2 = zk * zk
    upper = np.empty(k)                      # upper interval end per root
    upper[:-1] = dk[1:]
    upper[-1] = dk[-1] + rho * z2.sum()
    gap = upper - dk

    # choose the shift origin: evaluate f at the interval midpoint
    mid = dk + 0.5 * gap
    with np.errstate(divide="ignore"):
        fmid = 1.0 + rho * (z2[None, :]
                            / (dk[None, :] - mid[:, None])).sum(axis=1)
    from_lower = fmid >= 0.0                 # root in the lower half
    sigma = np.where(from_lower, dk, upper)
    # μ-interval relative to σ (root strictly inside the open interval)
    lo = np.where(from_lower, 0.0, -0.5 * gap)
    hi = np.where(from_lower, 0.5 * gap, 0.0)

    # pole offsets in each root's frame: delta[j, i] = d_j − σ_i
    delta = dk[:, None] - sigma[None, :]
    for _ in range(iters):
        mu = 0.5 * (lo + hi)
        with np.errstate(divide="ignore", invalid="ignore"):
            f = 1.0 + rho * (z2[:, None]
                             / (delta - mu[None, :])).sum(axis=0)
        # at an exact pole hit the sum is ±inf − ∓inf = nan; resolve by
        # treating it as "above the root" (shrinks the interval safely)
        up = np.where(np.isnan(f), False, f < 0.0)
        lo = np.where(up, mu, lo)
        hi = np.where(up, hi, mu)
    mu = 0.5 * (lo + hi)
    lam = sigma + mu
    dmat = delta - mu[None, :]               # d_j − λ_i, cancellation-free
    return lam, dmat


def _gu_eisenstat_z(dk: np.ndarray, dmat: np.ndarray,
                    zk: np.ndarray) -> np.ndarray:
    """Recompute ẑ from the computed roots (LAPACK ``dlaed3``): by the
    interlacing product formula ``ẑⱼ² ∝ Πᵢ(λᵢ−dⱼ) / Πᵢ≠ⱼ(dᵢ−dⱼ)``, the
    vector whose *exact* secular roots are the computed ``lam``;
    eigenvectors built from ẑ are orthogonal to working precision.
    ``dmat[j, i] = dⱼ − λᵢ`` comes from :func:`stedc_secular`.  (The
    uniform 1/ρ factor is dropped — it cancels in the normalization.)"""

    diff_d = dk[None, :] - dk[:, None]
    np.fill_diagonal(diff_d, 1.0)
    # interleave each (λᵢ−dⱼ) with its (dᵢ−dⱼ): the ratios are O(1) by
    # interlacing, so the product cannot under/overflow the way the two
    # raw Π's do on graded spectra (dlaed3 does the same)
    ratio = -dmat / diff_d
    np.fill_diagonal(ratio, 1.0)
    zhat2 = np.abs(np.prod(ratio, axis=1) * (-np.diagonal(dmat)))
    return np.where(zk < 0, -1.0, 1.0) * np.sqrt(zhat2)


def stedc_merge(d1: np.ndarray, q1: np.ndarray, d2: np.ndarray,
                q2: np.ndarray, e_mid: float):
    """Rank-one merge of two solved sub-problems — reference
    ``stedc_merge.cc`` (LAPACK ``dlaed1``).

    The caller has already subtracted ``|e_mid|`` from the two boundary
    diagonals, so ``T = diag(T₁', T₂') + ρ·z·zᵀ`` exactly, with
    ``ρ = 2|e_mid|`` and z from :func:`stedc_z_vector`.  Returns the
    merged ``(w, Q)`` ascending.
    """

    n1 = d1.size
    n = n1 + d2.size
    rho = 2.0 * abs(e_mid)
    if rho == 0.0:                            # decoupled: just interleave
        d = np.concatenate([d1, d2])
        qbig = np.zeros((n, n))
        qbig[:n1, :n1] = q1
        qbig[n1:, n1:] = q2
        return stedc_sort(d, qbig)
    z = stedc_z_vector(q1[-1, :], q2[0, :], sign=np.sign(e_mid))
    d = np.concatenate([d1, d2])

    # sort the poles ascending (the reference's stedc_sort pre-pass)
    order = np.argsort(d, kind="stable")
    d_s, z_s = d[order], z[order]

    keep, d_u, z_u, givens = stedc_deflate(d_s, z_s, rho)
    dk, zk = d_u[keep], z_u[keep]

    qbig = np.zeros((n, n))
    qbig[:n1, :n1] = q1
    qbig[n1:, n1:] = q2
    qperm = qbig[:, order]
    for (a, b, c, s) in givens:
        qa, qb = qperm[:, a].copy(), qperm[:, b].copy()
        qperm[:, a] = c * qa - s * qb
        qperm[:, b] = s * qa + c * qb

    k = int(keep.sum())
    w = np.empty(n)
    qout = np.empty((n, n))
    # deflated pairs pass through (with their rotated diagonal values)
    w[k:] = d_u[~keep]
    qout[:, k:] = qperm[:, ~keep]

    if k:
        lam, dmat = stedc_secular(dk, zk, rho)
        zhat = _gu_eisenstat_z(dk, dmat, zk)
        # secular eigenvectors: v_i ∝ ẑⱼ/(dⱼ−λᵢ), then normalize; the
        # difference matrix comes from the shifted frames (stable).
        # Clamp |dmat| away from exact zero: a bisection interval that
        # collapses to zero width (mu underflow next to a pole) would
        # otherwise turn a column into inf/nan.  The floor is
        # sqrt(tiny)·scale (~1e-154·scale) — far below the deflation
        # tolerance (~eps·scale) that bounds legitimate gaps, so it
        # cannot perturb undeflated roots; the max-abs prescale keeps
        # the 2-norm from overflowing for near-pole columns (the column
        # limits to the pole coordinate axis).
        tiny = np.finfo(dmat.dtype).tiny ** 0.5 * max(np.abs(dk).max(), 1.0)
        gap = np.abs(dmat).min(axis=0)
        pole = np.abs(dmat).argmin(axis=0)
        dmat = np.where(np.abs(dmat) < tiny,
                        np.where(dmat < 0, -tiny, tiny), dmat)
        vs = zhat[:, None] / dmat
        vs /= np.abs(vs).max(axis=0, keepdims=True)
        vs /= np.linalg.norm(vs, axis=0, keepdims=True)
        # A root whose interval collapsed onto its pole (gap below the
        # floor) has eigenvector → the pole coordinate axis; the clamped
        # quotient cannot represent that (zhat at the pole is 0 too), so
        # substitute e_pole explicitly.
        collapsed = gap < tiny
        if collapsed.any():
            for i in np.flatnonzero(collapsed):
                vs[:, i] = 0.0
                vs[pole[i], i] = 1.0
        w[:k] = lam
        qout[:, :k] = qperm[:, keep] @ vs

    return stedc_sort(w, qout)


def stedc_solve(d: np.ndarray, e: np.ndarray):
    """Recursive D&C driver — reference ``stedc_solve.cc``.  Returns
    ``(w, Q)`` ascending."""

    n = d.size
    if n <= _SMLSIZ:
        return _steqr_base(d, e)
    m = n // 2
    em = e[m - 1]
    # tear: T = diag(T1', T2') + |e_m|·u·uᵀ, u = [e_last; sign(e_m)·e_first]
    d1 = d[:m].copy()
    d2 = d[m:].copy()
    d1[-1] -= abs(em)
    d2[0] -= abs(em)
    w1, q1 = stedc_solve(d1, e[:m - 1])
    w2, q2 = stedc_solve(d2, e[m:])
    return stedc_merge(w1, q1, w2, q2, em)


def stedc(d: np.ndarray, e: np.ndarray, want_z: bool = True):
    """Divide-and-conquer tridiagonal eigensolver — reference
    ``slate::stedc`` (``src/stedc.cc``).  Returns ``(w, Q)`` or ``w``."""

    d = np.asarray(d, dtype=np.float64)
    e = np.asarray(e, dtype=np.float64)
    if not want_z:
        # values-only: skip the O(n³) vector recursion entirely (the
        # reference's heev likewise switches to sterf when no vectors
        # are wanted, src/heev.cc:141-176)
        from scipy.linalg import eigvalsh_tridiagonal
        if d.size == 1:
            return d.copy()
        return eigvalsh_tridiagonal(d, e)
    w, q = stedc_solve(d, e)
    return w, q
