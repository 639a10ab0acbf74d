"""Hermitian eigensolver family — the two-stage path, the counterpart of
``slate_tpu/linalg/eig.py`` (reference ``src/heev.cc`` driver chain
``:104-176``, ``src/hegv.cc``, ``src/hegst.cc``):

* **Stage 1** (:func:`he2hb`, dense → band) carries the O(n³) FLOP: per
  panel a compact-WY Householder QR (:func:`~slate_tpu_torch.linalg.qr.
  geqrf_rec`) and the two-sided trailing update as whole-matrix products
  through the ``matmul`` site (the kernel for 128-aligned fp32 on the
  card; ``torch.matmul`` for fp64 and complex).
* **Stage 2** (band → tridiagonal) by the ``chase`` site
  (:mod:`~slate_tpu_torch.linalg._chase`): on the card, real fp32/fp64
  with vectors, ONE launch of the ``hb2st_wavefront`` kernel, the band
  and the reflector log staying on the card; otherwise the host chase of
  :mod:`slate_tpu_torch.native` (Givens for values-only and complex
  input, Householder for real fp64 with vectors on the card).
* **Stage 3**: the O(n) (d, e) go to the host tridiagonal solve (scipy,
  as the reference calls LAPACK on rank 0), then the back-transforms
  run on the operand's device — :func:`unmtr_hb2st_hh` (a batched WY
  apply per sweep) and :func:`unmtr_he2hb` (a chain of block
  reflectors).

``w`` and ``Z`` come back as tensors on the operand's device, ``w`` in
its real dtype.  The tridiagonal eigenvectors enter the back-transform in
the band's dtype (the JAX package's CPU tests run it in fp64 with x64 on).
The ``eig_driver`` site's other answer, ``"qdwh"``, is QDWH-eig
(:func:`slate_tpu_torch.linalg.polar.heev_qdwh`).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..enums import Diag, MethodEig, Op, Side, Uplo
from ..exceptions import SlateError
from ..matrix import as_array
from ..ops import blocks
from ..ops.blocks import _ct, matmul
from ..options import Options, get_option
from ..perf import metrics
from ..perf.metrics import instrument_driver
from .blas3 import _arr, _device_of, _nb
from .cholesky import _hermitian_full
from .qr import _unit_lower, apply_reflector_chain, geqrf_rec, larft_rec


def _sync(t) -> None:
    """With metrics on, wait for the card inside a stage timer."""
    if metrics.enabled() and t.is_cuda:
        torch.cuda.synchronize(t.device)


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().resolve_conj().cpu().numpy()
    return np.asarray(x)


class He2hbFactors(NamedTuple):
    """Stage-1 output: the band and the block reflectors that made it.

    ``band`` is the dense Hermitian tensor with lower bandwidth ``kd``;
    ``panels`` holds one ``(row0, V, T)`` triple per panel with
    Q_k = I − V·T·Vᴴ acting on rows ``row0:``.
    """

    band: torch.Tensor
    kd: int
    panels: Tuple[Tuple[int, torch.Tensor, torch.Tensor], ...]


def he2hb(a, opts: Optional[Options] = None, *, device=None) -> He2hbFactors:
    """Reduce a Hermitian matrix to Hermitian band form (bandwidth = nb)
    by a unitary congruence A = Q₁·B·Q₁ᴴ — reference ``slate::he2hb``
    (``src/he2hb.cc:53-177``).  A raw array is taken as already full."""
    full = _hermitian_full(a, _device_of(a, device=device))
    return _he2hb(full, _nb(a, opts))


def _he2hb(full, nb: int) -> He2hbFactors:
    n = full.shape[-1]
    if full.ndim != 2 or full.shape[-2] != n:
        raise SlateError(f"he2hb requires square, got {tuple(full.shape)}")
    band, vts = _he2hb_impl(full, nb)
    panels = tuple((n - v.shape[0], v, t) for v, t in vts)
    return He2hbFactors(band=band, kd=nb, panels=panels)


def _he2hb_impl(full, nb: int):
    """The panel loop: per panel the QR of the block column below the
    band, [R; 0] written back (both triangles), then the two-sided
    trailing update B ← Qᴴ·B·Q in her2k form — Y = B·V·T,
    S = Tᴴ·(Vᴴ·Y), W = Y − ½·V·S, B −= V·Wᴴ + W·Vᴴ."""
    n = full.shape[-1]
    full = full.clone()
    vts = []
    for j0 in range(0, max(n - nb, 0), nb):
        r0 = j0 + nb
        w = min(nb, n - j0)
        p = full[r0:, j0:j0 + w]
        f, tau = geqrf_rec(p, nb)
        k = min(p.shape[0], w)
        v = _unit_lower(f, k)
        t = larft_rec(v, tau)
        newp = torch.zeros_like(p)
        newp[:min(f.shape[0], w)] = torch.triu(f[:w])
        full[r0:, j0:j0 + w] = newp
        full[j0:j0 + w, r0:] = _ct(newp)
        b = full[r0:, r0:]
        y = matmul(b, matmul(v, t))
        s = matmul(_ct(t), matmul(_ct(v), y))
        wmat = y - 0.5 * matmul(v, s)
        full[r0:, r0:] = b - matmul(v, _ct(wmat)) - matmul(wmat, _ct(v))
        vts.append((v, t))
    # clamp to the band (numerical zeros outside) and re-hermitize
    i = torch.arange(n, device=full.device)
    band = torch.where((i[:, None] - i[None, :]).abs() <= nb, full,
                       torch.zeros((), dtype=full.dtype, device=full.device))
    return 0.5 * (band + _ct(band)), tuple(vts)


def unmtr_he2hb(side: Side, op: Op, factors: He2hbFactors, c,
                opts: Optional[Options] = None):
    """Apply Q₁ (or Q₁ᴴ) from :func:`he2hb` — reference
    ``slate::unmtr_he2hb``: a chain of block reflectors, three full-fp32
    products each."""
    cv = as_array(c, factors.band.device)
    if side is not Side.Left:
        # C·Q = (Qᴴ·Cᴴ)ᴴ
        flip = Op.NoTrans if op is not Op.NoTrans else Op.ConjTrans
        return _ct(unmtr_he2hb(Side.Left, flip, factors, _ct(cv),
                               opts)).resolve_conj()
    vts = tuple((v, t) for _, v, t in factors.panels)
    return apply_reflector_chain(vts, cv, op is Op.NoTrans)


# ---------------------------------------------------------------------------
# Stage 2 on the host: band → tridiagonal by Givens or Householder chasing
# ---------------------------------------------------------------------------

class Hb2stRotations(NamedTuple):
    """Rotation log of :func:`hb2st`: Q₂ = G₁ᴴ·G₂ᴴ⋯G_Nᴴ·diag(phase);
    each Gₗ acts in plane (iₗ−1, iₗ)."""

    planes: np.ndarray   # int32[N] — the i of each rotation
    cs: np.ndarray       # real[N]
    ss: np.ndarray       # scalar[N] (complex for Hermitian input)
    phase: np.ndarray    # complex[n] diagonal making the tridiagonal real
    kd: int = 0          # chase bandwidth (0 = generic log)


def _givens(f, g):
    """Complex-safe Givens: returns (c real, s) with
    [[c, s], [−s̄, c]]·[f, g]ᵀ = [r, 0]."""
    absf, absg = abs(f), abs(g)
    if absg == 0.0:
        return 1.0, 0.0 * g
    r = np.hypot(absf, absg)
    signf = f / absf if absf != 0 else 1.0
    c = absf / r
    s = signf * np.conj(g) / r
    return c, s


def _phase_tridiag(e_c, n, dt):
    """Phase-normalize a complex subdiagonal to real (LAPACK hbtrd's last
    step), in place on ``e_c``; returns the phase diagonal."""
    phase = np.ones((n,), dtype=dt)
    if np.iscomplexobj(np.zeros((), dtype=dt)):
        for j in range(n - 1):
            val = e_c[j] * phase[j]
            absv = abs(val)
            phase[j + 1] = val / absv if absv != 0 else 1.0
            e_c[j] = absv
    return phase


def _hb2st_ab(ab: np.ndarray, kd_eff: int, want_rots: bool = True):
    """Compiled Givens stage 2 on prepared lower-band storage
    ``ab[(n, kd_eff+2)]`` (modified in place)."""
    from .. import native

    n = ab.shape[0]
    with metrics.timer("chase.hb2st"):
        planes, cs, ss = native.hb2st_banded(ab, n, kd_eff, want_rots)
    d = np.real(ab[:, 0]).copy()
    e_c = ab[:n - 1, 1].copy()
    phase = _phase_tridiag(e_c, n, ab.dtype)
    return d, np.real(e_c), Hb2stRotations(planes=planes, cs=cs, ss=ss,
                                           phase=phase, kd=kd_eff)


def _hb2st_native(a: np.ndarray, kd: int, want_rots: bool = True):
    """Compiled stage 2 from a dense band matrix: pack the band storage
    and run :func:`_hb2st_ab`."""
    n = a.shape[0]
    dt = np.complex128 if np.iscomplexobj(a) else np.float64
    kd_eff = min(kd, n - 1)
    ab = np.zeros((n, kd_eff + 2), dtype=dt, order="C")
    for dd in range(kd_eff + 1):
        ab[:n - dd, dd] = np.diagonal(a, -dd)
    return _hb2st_ab(ab, kd_eff, want_rots)


def hb2st(band, kd: int, want_rots: bool = True
          ) -> Tuple[np.ndarray, np.ndarray, Hb2stRotations]:
    """Reduce a Hermitian band matrix (lower bandwidth ``kd``) to real
    symmetric tridiagonal on the host — reference ``slate::hb2st``
    (``src/hb2st.cc:23-90``): the compiled Givens chase of
    :mod:`slate_tpu_torch.native` where it builds, else the same schedule
    in Python.  Returns ``(d, e, rotations)`` with A_band = Q₂·T·Q₂ᴴ."""
    from .. import native

    a = np.array(_numpy(band))
    n = a.shape[0]
    if native.available() and n > 2 and kd >= 2:
        return _hb2st_native(a, kd, want_rots)
    planes: List[int] = []
    cs: List[float] = []
    ss: List[complex] = []
    for bw in range(kd, 1, -1):
        for j in range(0, n - bw):
            col, i = j, j + bw
            while True:
                c, s = _givens(a[i - 1, col], a[i, col])
                g = np.array([[c, s], [-np.conj(s), c]])
                lo = max(0, i - 1 - bw - 1)
                hi = min(n, i + bw + 2)
                a[[i - 1, i], lo:hi] = g @ a[[i - 1, i], lo:hi]
                a[lo:hi, [i - 1, i]] = a[lo:hi, [i - 1, i]] @ np.conj(g.T)
                planes.append(i)
                cs.append(c)
                ss.append(s)
                if i + bw >= n:
                    break
                col, i = i - 1, i + bw
    d = np.real(np.diagonal(a)).copy()
    e_c = np.diagonal(a, -1).copy()
    phase = _phase_tridiag(e_c, n, a.dtype)
    rots = Hb2stRotations(planes=np.asarray(planes, dtype=np.int32),
                          cs=np.asarray(cs, dtype=np.float64),
                          ss=np.asarray(ss), phase=phase)
    return d, np.real(e_c), rots


def _hb_sweep_counts(n, kd, j0: int = 0, j1=None):
    """Per-sweep reflector counts of the Householder chase over sweeps
    ``[j0, j1)``."""
    counts = []
    if j1 is None:
        j1 = max(n - 2, 0)
    for j in range(j0, min(j1, max(n - 2, 0))):
        L = min(kd, n - 1 - j)
        if L < 2:
            continue
        cnt, r0 = 1, j + 1
        while True:
            r1 = r0 + L
            lt = min(kd, n - r1)
            if lt < 2:
                break
            cnt += 1
            r0, L = r1, lt
        counts.append(cnt)
    return counts


def _pack_hh_log(v, tau, row0, length, n, kd, counts=None):
    """Group the flat host reflector log by sweep into padded (nsweeps,
    tmax, kd) arrays: within one sweep the windows are adjacent disjoint
    kd-strided rows from the sweep's first row — the property that makes
    a sweep one batched WY apply."""
    row0 = np.asarray(row0)
    if len(row0) == 0:
        return (np.zeros((0, 1, kd)), np.zeros((0, 1)),
                np.zeros((0,), np.int32))
    if counts is None:
        counts = _hb_sweep_counts(n, kd)
    counts = np.asarray(counts)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    assert counts.sum() == len(row0), (counts.sum(), len(row0))
    tmax = int(counts.max())
    v3 = np.zeros((len(starts), tmax, kd), dtype=v.dtype)
    t2 = np.zeros((len(starts), tmax), dtype=tau.dtype)
    s0 = np.zeros((len(starts),), dtype=np.int32)
    for s, (b, c) in enumerate(zip(starts, counts)):
        v3[s, :c] = v[b:b + c]
        t2[s, :c] = tau[b:b + c]
        s0[s] = row0[b]
    return v3, t2, s0


def unmtr_hb2st_hh(v3, t2, s0, z, kd: int):
    """Back-transform through the Householder chase on Z's device:
    Z ← Q₂·Z, the sweeps in reverse, each a batched WY apply — two
    batched contractions over the sweep's disjoint windows,
    u = vᴴ·Z_w and Z_w −= v·(τ·u) (reference ``src/unmtr_hb2st.cc``).
    Windows that start past row n hold no reflector and are skipped.
    ``v3``/``t2``/``s0`` may be host arrays or tensors; returns a new
    tensor."""
    z = torch.as_tensor(z)
    dev = z.device
    v3 = torch.as_tensor(v3, device=dev)
    t2 = torch.as_tensor(t2, device=dev)
    if v3.shape[0] == 0:
        return z.clone()
    # complex reflectors (the zhbtrd-style chase) promote a real Z
    zdt = torch.promote_types(z.dtype, v3.dtype)
    v3, t2 = v3.to(zdt), t2.to(zdt)
    n, ncols = z.shape
    tmax = v3.shape[1]
    zp = torch.zeros((n + kd, ncols), dtype=zdt, device=dev)
    zp[:n] = z
    starts = [int(x) for x in _numpy(s0)]
    for s in range(len(starts) - 1, -1, -1):
        start = starts[s]
        cnt = min(tmax, -(-(n - start) // kd))
        zw = zp[start:start + cnt * kd].view(cnt, kd, ncols)
        vj = v3[s, :cnt, :, None]                             # (cnt, kd, 1)
        u = torch.bmm(vj.mH, zw)                              # (cnt, 1, ncols)
        zw.baddbmm_(vj, t2[s, :cnt, None, None] * u, alpha=-1)
    return zp[:n]


def _hb2st_hh_ab(abw: np.ndarray, kd_eff: int):
    """Compiled Householder stage 2 on WIDE band storage
    ``abw[(n, 2·kd+2)]`` (in place): the real-fp64 host route whose log
    back-transforms on the card.  Returns ``(d, e, (v3, t2, s0))``."""
    from .. import native
    from . import _chase

    n = abw.shape[0]
    with metrics.timer("chase.hb2st"):
        v, tau, row0, length = native.hb2st_hh_banded(abw, n, kd_eff)
    d = abw[:, 0].copy()
    e = abw[:n - 1, 1].copy()
    log = _pack_hh_log(v, tau, row0, length, n, kd_eff)
    _chase.mark_host_path("hb2st", log)
    return d, e, log


def unmtr_hb2st(rots: Hb2stRotations, z: np.ndarray) -> np.ndarray:
    """Back-transform tridiagonal eigenvectors through the Givens chase
    on the host: Z_band = Q₂·Z — reference ``slate::unmtr_hb2st``."""
    from .. import native

    if native.available():
        cplx = (np.iscomplexobj(rots.phase) or np.iscomplexobj(rots.ss)
                or np.iscomplexobj(np.asarray(z)))
        dt = np.complex128 if cplx else np.float64
        zz = np.asarray(z, dtype=dt) * rots.phase[:, None].astype(dt)
        if len(rots.planes):
            zz = native.apply_rot_seq(zz, rots.planes, rots.cs, rots.ss, 0,
                                      kd=rots.kd)
        return zz
    z = np.asarray(z).astype(rots.phase.dtype if np.iscomplexobj(rots.phase)
                             else np.asarray(z).dtype)
    z = rots.phase[:, None] * z
    for idx in range(len(rots.planes) - 1, -1, -1):
        i = int(rots.planes[idx])
        c, s = rots.cs[idx], rots.ss[idx]
        # apply Gᴴ = [[c, −s], [s̄, c]] to rows (i−1, i)
        gh = np.array([[c, -s], [np.conj(s), c]])
        z[[i - 1, i], :] = gh @ z[[i - 1, i], :]
    return z


# ---------------------------------------------------------------------------
# Tridiagonal solvers (host LAPACK through scipy, like the reference's
# rank-0 calls)
# ---------------------------------------------------------------------------

def sterf(d, e) -> np.ndarray:
    """Eigenvalues of a real symmetric tridiagonal (no vectors) —
    LAPACK ``sterf``."""
    from scipy.linalg import eigvalsh_tridiagonal

    d = np.asarray(d, dtype=np.float64)
    e = np.asarray(e, dtype=np.float64)
    if d.size == 1:
        return d
    return eigvalsh_tridiagonal(d, e, lapack_driver="sterf")


def steqr(d, e, want_z: bool = True):
    """Implicit-QR tridiagonal eigensolver — reference ``steqr2``."""
    return _tridiag_solve(d, e, want_z, "stev")


def stedc(d, e, want_z: bool = True):
    """Divide-and-conquer tridiagonal eigensolver — reference ``stedc``
    (``src/stedc.cc``), in :mod:`slate_tpu_torch.linalg._stedc`."""
    from ._stedc import stedc as _dc_stedc

    return _dc_stedc(d, e, want_z)


def stemr(d, e, want_z: bool = True):
    """MRRR tridiagonal eigensolver (LAPACK ``stemr``)."""
    return _tridiag_solve(d, e, want_z, "stemr")


def stebz_stein(d, e):
    """Bisection + inverse iteration (LAPACK ``stebz`` + ``stein``)."""
    return _tridiag_solve(d, e, True, "stebz")


def _tridiag_solve(d, e, want_z, driver):
    from scipy.linalg import eigh_tridiagonal, eigvalsh_tridiagonal

    d = np.asarray(d, dtype=np.float64)
    e = np.asarray(e, dtype=np.float64)
    if d.size == 1:
        return (d, np.ones((1, 1))) if want_z else d

    def call(fn, drv):
        try:
            return fn(d, e, lapack_driver=drv)
        except ValueError as err:
            # scipy >= 1.14 dropped stevd/stevr from the accepted driver
            # set; 'auto' (stemr/stebz) is always valid and numerically
            # interchangeable here
            if "lapack_driver" not in str(err) or drv == "auto":
                raise
            return fn(d, e, lapack_driver="auto")

    if not want_z:
        vdriver = driver if driver in ("stev", "stevd", "stebz") else "auto"
        return call(eigvalsh_tridiagonal, vdriver)
    return call(eigh_tridiagonal, driver)


_EIG_DRIVERS = {
    MethodEig.QR: steqr,
    MethodEig.DC: stedc,
    MethodEig.MRRR: stemr,
    MethodEig.Bisection: lambda d, e, want_z=True: stebz_stein(d, e),
}


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

#: above this size heev's Auto solves the band with one scipy hbevd call
#: where the compiled host chase is unavailable
_BAND_SOLVER_MIN_N = 512


def _band_eig(band, kd: int, jobz: bool, method, auto: bool):
    """Stages 2 and 3 on the band tensor: band → tridiagonal → solve →
    back-transform through the chase.  Returns ``(w, z_band)`` — ``w`` a
    host float64 array, ``z_band`` None without ``jobz``, a tensor on the
    band's device on the kernel route, a host array otherwise.

    The ``chase`` site decides first: ``"kernel"`` keeps the band on its
    device end to end (packed there, chased by one ``hb2st_wavefront``
    launch, its log consumed by the WY back-transform where it lies —
    only the O(n) tridiagonal visits the host); ``"host_native"`` is the
    host chase below."""
    from .. import native
    from . import _chase

    n = int(band.shape[0])
    kd_dev = min(kd, n - 1)
    if n > 2 and kd_dev >= 2 and _chase.backend(
            "hb2st", n, kd_dev, band.dtype, band.device,
            jobz and not band.is_complex()) == "kernel":
        abw, log = _chase.hb2st_device(
            _chase.hb2st_abw_from_dense(band, kd_dev), kd_dev)
        d, e = _chase.hb2st_d_e(abw, n)
        return _stage3_eig_hh(d, e, log, kd_dev, method, auto, band.device)
    band_np = _numpy(band)
    if auto and n > _BAND_SOLVER_MIN_N and not native.available():
        from scipy.linalg import eig_banded, eigvals_banded

        bands = np.asarray(
            [np.concatenate([np.diagonal(band_np, -k),
                             np.zeros(k, band_np.dtype)])
             for k in range(kd_dev + 1)])
        if not jobz:
            return np.sort(np.real(eigvals_banded(bands, lower=True))), None
        w, z_band = eig_banded(bands, lower=True)
        return np.real(w), z_band
    if jobz and band_np.dtype == np.float64 and native.available() \
            and n > 2 and kd_dev >= 2 and band.is_cuda:
        # the band-storage route, so real fp64 gets the Householder chase
        # and the WY back-transform on the card
        ab = np.zeros((n, kd_dev + 2), dtype=np.float64)
        for dd in range(kd_dev + 1):
            ab[:n - dd, dd] = np.diagonal(band_np, -dd)
        return _band_eig_ab(ab, kd_dev, jobz, method, auto, band.device)
    d, e, rots = hb2st(band_np, kd, want_rots=jobz)
    return _stage3_eig(d, e, rots, jobz, method, auto)


def _stage3_eig(d, e, rots, jobz, method, auto):
    """Tridiagonal solve + Givens back-transform on the host."""
    if not jobz:
        if method in (MethodEig.QR, MethodEig.Bisection):
            w = sterf(d, e)
        elif method is MethodEig.MRRR:
            w = _tridiag_solve(d, e, False, "stemr")
        else:
            w = _tridiag_solve(d, e, False, "stevd")
        return np.sort(w), None
    with metrics.timer("stage.heev.tridiag"):
        if auto:
            # Auto = fastest correct: LAPACK D&C (stevd) for the tridiagonal
            w, z_tri = _tridiag_solve(d, e, True, "stevd")
        else:
            w, z_tri = _EIG_DRIVERS[method](d, e)
    return np.asarray(w), unmtr_hb2st(rots, z_tri)


def _stage3_eig_hh(d, e, log, kd_eff: int, method, auto: bool, device):
    """Tridiagonal solve + batched-WY back-transform on ``device`` for
    the Householder-chase routes; ``log`` is the ``(v3, t2, s0)`` triple,
    tensors on the card (kernel route) or host arrays (host chase, one
    upload).  The tridiagonal eigenvectors enter in the log's dtype."""
    with metrics.timer("stage.heev.tridiag"):
        if auto or method not in _EIG_DRIVERS:
            w, z_tri = _tridiag_solve(d, e, True, "stevd")
        else:
            w, z_tri = _EIG_DRIVERS[method](d, e)
    v3 = torch.as_tensor(log[0], device=device)
    z = torch.from_numpy(np.ascontiguousarray(z_tri)).to(device=device,
                                                          dtype=v3.dtype)
    return np.asarray(w), unmtr_hb2st_hh(v3, log[1], log[2], z, kd_eff)


def _band_eig_ab(ab, kd_eff: int, jobz: bool, method, auto: bool, device):
    """Stages 2 and 3 from O(n·kd) band storage ``ab[(n, kd+2)]`` on the
    host: real fp64 with vectors takes the Householder chase whose log
    back-transforms on ``device`` (the kernel when the ``chase`` site
    answers so, else the host chase with one log upload); the rest the
    Givens chase."""
    from .. import native
    from . import _chase

    n = ab.shape[0]
    if not (native.available() and n > 2 and kd_eff >= 2):
        # no toolchain or tiny n: rebuild the dense band (small here)
        dense = np.zeros((n, n), dtype=ab.dtype)
        idx = np.arange(n)
        for dd in range(min(kd_eff, n - 1) + 1):
            dense[idx[:n - dd] + dd, idx[:n - dd]] = ab[:n - dd, dd]
        dense = dense + np.tril(dense, -1).conj().T
        return _band_eig(torch.from_numpy(dense).to(device), kd_eff, jobz,
                         method, auto)
    if jobz and ab.dtype == np.float64 and _chase.backend(
            "hb2st", n, kd_eff, torch.float64, device, True) == "kernel":
        abw, log = _chase.hb2st_device(
            _chase.hb2st_abw_from_ab(ab, kd_eff, device), kd_eff)
        d, e = _chase.hb2st_d_e(abw, n)
        return _stage3_eig_hh(d, e, log, kd_eff, method, auto, device)
    if jobz and ab.dtype == np.float64 and torch.device(device).type == "cuda":
        # Householder chase + WY back-transform on the card: a win only
        # where the card applies the log
        abw = np.zeros((n, 2 * kd_eff + 2), dtype=np.float64)
        w = min(ab.shape[1], kd_eff + 1)
        abw[:, :w] = ab[:, :w]
        d, e, log = _hb2st_hh_ab(abw, kd_eff)
        return _stage3_eig_hh(d, e, log, kd_eff, method, auto, device)
    d, e, rots = _hb2st_ab(ab, kd_eff, want_rots=jobz)
    return _stage3_eig(d, e, rots, jobz, method, auto)


@instrument_driver("heev")
def heev(a, jobz: bool = True, opts: Optional[Options] = None, *,
         device=None):
    """Hermitian eigensolver — reference ``slate::heev`` (``src/heev.cc``).

    Returns ``(w, Z)``, eigenvalues ascending, both tensors on the
    operand's device (``w`` in its real dtype); ``Z`` is None when
    ``jobz`` is False.  ``method_eig`` picks the tridiagonal solver
    (``MethodEig``: D&C under Auto, QR, MRRR, Bisection).  The
    ``eig_driver`` site (or an ``eig_driver`` option) picks the driver:
    ``"twostage"``, the chain below, or ``"qdwh"``, the spectral divide
    and conquer of :func:`~slate_tpu_torch.linalg.polar.heev_qdwh`."""
    from ..perf import autotune

    dev = _device_of(a, device=device)
    method = get_option(opts, "method_eig", MethodEig.Auto)
    full = _hermitian_full(a, dev)
    driver = get_option(opts, "eig_driver", None)
    if driver is None:
        driver = autotune.select("eig_driver", n=full.shape[-1],
                                 dtype=full.dtype, device=dev,
                                 eligible=method is MethodEig.Auto)
    if driver == "qdwh":
        from .polar import _heev_qdwh

        return _heev_qdwh(a, jobz, opts, "heev", dev)
    return _heev_twostage(full, _nb(a, opts), jobz, method)


def _heev_twostage(full, nb: int, jobz: bool, method):
    """The two-stage chain (he2hb → band eig → back-transform)."""
    auto = method is MethodEig.Auto
    if auto:
        method = MethodEig.DC
    with metrics.timer("stage.heev.stage1"):
        factors = _he2hb(full, nb)
        _sync(factors.band)
    band = factors.band
    with metrics.timer("stage.heev.stage2"):
        w, z_band = _band_eig(band, factors.kd, jobz, method, auto)
    w = torch.from_numpy(np.ascontiguousarray(w)).to(
        device=band.device, dtype=band.real.dtype)
    if not jobz:
        return w, None
    with metrics.timer("stage.heev.stage3"):
        z_band = torch.as_tensor(z_band).to(device=band.device,
                                            dtype=band.dtype)
        z = unmtr_he2hb(Side.Left, Op.NoTrans, factors, z_band)
        _sync(z)
    return w, z


def syev(a, jobz: bool = True, opts: Optional[Options] = None, *,
         device=None):
    """Real-symmetric alias — reference ``slate::syev``."""
    return heev(a, jobz, opts, device=device)


def heev_vals(a, opts: Optional[Options] = None, *, device=None):
    """Eigenvalues only (reference simplified API ``eig_vals``)."""
    return heev(a, jobz=False, opts=opts, device=device)[0]


def hegst(itype: int, a, b_factor, opts: Optional[Options] = None, *,
          device=None):
    """Reduce a generalized Hermitian-definite eigenproblem to standard
    form — reference ``slate::hegst`` (``src/hegst.cc``).

    itype 1:  A ← L⁻¹·A·L⁻ᴴ   (for A·x = λ·B·x)
    itype 2/3: A ← Lᴴ·A·L      (for A·B·x = λ·x / B·A·x = λ·x)

    ``b_factor`` is the lower Cholesky factor of B.  Two whole-matrix
    triangular solves or multiplies over :mod:`slate_tpu_torch.ops.blocks`.
    """
    dev = _device_of(a, b_factor, device=device)
    nb = _nb(a, opts)
    av = _hermitian_full(a, dev)
    lv = torch.tril(_arr(b_factor, dev))
    if itype == 1:
        w = blocks.trsm_rec(Side.Left, Uplo.Lower, Diag.NonUnit, lv, av, nb)
        out = blocks.trsm_rec(Side.Right, Uplo.Upper, Diag.NonUnit,
                              _ct(lv), w, nb)
    elif itype in (2, 3):
        w = blocks.trmm_rec(Side.Left, Uplo.Upper, Diag.NonUnit, _ct(lv), av,
                            nb)
        out = blocks.trmm_rec(Side.Right, Uplo.Lower, Diag.NonUnit, lv, w, nb)
    else:
        raise SlateError(f"hegst: invalid itype {itype}")
    return 0.5 * (out + _ct(out))


def hegv(a, b, itype: int = 1, jobz: bool = True,
         opts: Optional[Options] = None, *, device=None):
    """Generalized Hermitian-definite eigensolver — reference
    ``slate::hegv`` (``src/hegv.cc``): potrf(B) → hegst → heev →
    back-substitute the eigenvectors."""
    from .cholesky import potrf

    dev = _device_of(a, b, device=device)
    lv = torch.tril(as_array(potrf(b, opts, device=dev)))
    nb = _nb(a, opts)
    w, z = heev(hegst(itype, a, lv, opts, device=dev), jobz, opts,
                device=dev)
    if not jobz:
        return w, None
    if itype in (1, 2):
        # x = L⁻ᴴ·y
        return w, blocks.trsm_rec(Side.Left, Uplo.Upper, Diag.NonUnit,
                                  _ct(lv), z, nb)
    return w, blocks.trmm_rec(Side.Left, Uplo.Lower, Diag.NonUnit, lv, z, nb)


def sygv(a, b, itype: int = 1, jobz: bool = True,
         opts: Optional[Options] = None, *, device=None):
    """Real-symmetric generalized alias — reference ``slate::sygv``."""
    return hegv(a, b, itype, jobz, opts, device=device)


def sygst(itype: int, a, b_factor, opts: Optional[Options] = None, *,
          device=None):
    """Real-symmetric alias of :func:`hegst` — reference ``slate::sygst``."""
    return hegst(itype, a, b_factor, opts, device=device)
