"""Two-stage SVD — the counterpart of ``slate_tpu/linalg/svd.py``
(reference ``src/svd.cc:207-372``):

* **Stage 1** (:func:`ge2tb`, dense → upper triangular band) carries the
  O(mn²) FLOP: per panel a compact-WY Householder QR of the block column
  and an LQ of the block row (QR of its adjoint, :func:`~slate_tpu_torch.
  linalg.qr.geqrf_rec`), the trailing updates as whole-matrix products
  through the ``matmul`` site (the kernel for 128-aligned fp32 on the
  card; ``torch.matmul`` for fp64 and complex).
* **Stage 2** (band → bidiagonal) by the ``chase`` site
  (:mod:`~slate_tpu_torch.linalg._chase`): on the card, real fp32/fp64
  with vectors, ONE launch of the ``tb2bd_wavefront`` kernel, the band
  and both reflector logs staying on the card; otherwise the host chases
  of :mod:`slate_tpu_torch.native` (Givens for values-only and complex
  input, Householder for real fp64 with vectors on the card).
* **Stage 3**: the O(n) (d, e) go to the host bidiagonal solve (LAPACK
  ``bdsdc`` from scipy, as the reference calls LAPACK on rank 0), then
  the back-transforms run on the operand's device —
  :func:`~slate_tpu_torch.linalg.eig.unmtr_hb2st_hh` over the U and the V
  log (a batched WY apply per sweep) and :func:`unmbr_ge2tb` on both
  sides (chains of block reflectors).

``σ``, ``U`` and ``Vᴴ`` come back as tensors on the operand's device, σ
in its real dtype (economy sizes).  The bidiagonal's singular vectors
enter the back-transform in the log's dtype (the JAX package's CPU tests
run it in fp64 with x64 on).  The ``svd_driver`` site's other answer,
``"qdwh"``, is QDWH-SVD (:func:`slate_tpu_torch.linalg.polar.svd_qdwh`).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..enums import MethodSVD, Op, Side
from ..exceptions import SlateError
from ..matrix import as_array
from ..ops.blocks import _ct, matmul
from ..options import Options, get_option
from ..perf import metrics
from ..perf.metrics import instrument_driver
from .blas3 import _arr, _device_of, _nb
from .eig import _givens, _numpy, _pack_hh_log, _sync, sterf, unmtr_hb2st_hh
from .qr import _unit_lower, apply_reflector_chain, geqrf_rec, larft_rec


class Ge2tbFactors(NamedTuple):
    """Stage-1 output: A = Q₁·B·P₁ᴴ with B upper triangular band of
    superdiagonal width ``kd``; ``qpanels``/``ppanels`` hold one
    ``(offset, V, T)`` block reflector per panel of Q₁ (row space) and P₁
    (column space)."""

    band: torch.Tensor
    kd: int
    qpanels: Tuple[Tuple[int, torch.Tensor, torch.Tensor], ...]
    ppanels: Tuple[Tuple[int, torch.Tensor, torch.Tensor], ...]


def ge2tb(a, opts: Optional[Options] = None, *, device=None) -> Ge2tbFactors:
    """Reduce a general m×n (m ≥ n) matrix to upper triangular band form
    — reference ``slate::ge2tb`` (``src/ge2tb.cc``).  Per panel: QR of
    the block column from the diagonal down, Q̂ᴴ applied to the trailing
    columns; then LQ of the block row right of the band, P̂ applied from
    the right — each application two large products."""
    return _ge2tb(_arr(a, _device_of(a, device=device)), _nb(a, opts))


def _ge2tb(av, nb: int) -> Ge2tbFactors:
    m, n = av.shape
    if m < n:
        raise SlateError("ge2tb requires m >= n (drivers transpose)")
    band, qvts, pvts = _ge2tb_impl(av, nb)
    qpanels = tuple((m - v.shape[0], v, t) for v, t in qvts)
    ppanels = tuple((n - v.shape[0], v, t) for v, t in pvts)
    return Ge2tbFactors(band=band, kd=nb, qpanels=qpanels, ppanels=ppanels)


def _ge2tb_impl(av, nb: int):
    """The two-sided panel loop, on a copy of ``av``."""
    m, n = av.shape
    av = av.clone()
    qpanels, ppanels = [], []
    for j0 in range(0, n, nb):
        w = min(nb, n - j0)
        # QR panel on rows j0: of block column j0:j0+w
        if m - j0 > 1:
            p = av[j0:, j0:j0 + w]
            f, tau = geqrf_rec(p, nb)
            v = _unit_lower(f, min(p.shape[0], w))
            t = larft_rec(v, tau)
            r_part = torch.triu(f[:w])
            av[j0:, j0:j0 + w] = 0
            av[j0:j0 + r_part.shape[0], j0:j0 + w] = r_part
            if j0 + w < n:
                c = av[j0:, j0 + w:]
                av[j0:, j0 + w:] = c - matmul(v, matmul(_ct(t),
                                                        matmul(_ct(v), c)))
            qpanels.append((v, t))
        # LQ panel on the block row, columns right of the band:
        # LQ(row) = (QR(rowᴴ))ᴴ
        c0 = j0 + nb
        if c0 < n and n - c0 > 1:
            row = av[j0:j0 + w, c0:]
            f, tau = geqrf_rec(_ct(row).resolve_conj(), nb)
            v = _unit_lower(f, min(f.shape))
            t = larft_rec(v, tau)
            l_part = _ct(torch.triu(f[:w]))
            av[j0:j0 + w, c0:] = 0
            av[j0:j0 + w, c0:c0 + l_part.shape[1]] = l_part
            # P̂ = I − V·T·Vᴴ from the right on the trailing rows
            if j0 + w < m:
                c = av[j0 + w:, c0:]
                av[j0 + w:, c0:] = c - matmul(matmul(matmul(c, v), t), _ct(v))
            ppanels.append((v, t))
    # clamp to the upper band
    i = torch.arange(m, device=av.device)[:, None]
    j = torch.arange(n, device=av.device)[None, :]
    band = torch.where((j - i >= 0) & (j - i <= nb), av,
                       torch.zeros((), dtype=av.dtype, device=av.device))
    return band, tuple(qpanels), tuple(ppanels)


def unmbr_ge2tb(side: Side, op: Op, factors: Ge2tbFactors, c):
    """Apply Q₁ (``side`` Left) or P₁ (Right, applied as P₁·C to the row
    space of C) from :func:`ge2tb` — reference ``slate::unmbr_ge2tb``.
    ``op`` NoTrans applies the factor, ConjTrans its adjoint; C is
    multiplied from the left.  Returns a new tensor."""
    cv = as_array(c, factors.band.device)
    panels = factors.qpanels if side is Side.Left else factors.ppanels
    return apply_reflector_chain(tuple((v, t) for _, v, t in panels), cv,
                                 op is Op.NoTrans)


# ---------------------------------------------------------------------------
# Stage 2 on the host: triangular band → bidiagonal
# ---------------------------------------------------------------------------

class Tb2bdRotations(NamedTuple):
    """Rotation logs of :func:`tb2bd`: B = U₂·B_bd·V₂ᴴ with
    U₂ = L₁ᴴ⋯L_qᴴ·diag(uphase), V₂ = M₁⋯M_p·diag(vphase)."""

    lplanes: np.ndarray
    lcs: np.ndarray
    lss: np.ndarray
    rplanes: np.ndarray
    rcs: np.ndarray
    rss: np.ndarray
    uphase: np.ndarray
    vphase: np.ndarray
    kd: int = 0          # chase bandwidth (0 = generic log)


def _phase_bidiag(d_c, e_c, n, dt):
    """Phase-normalize a complex bidiagonal to real (LAPACK gebrd's last
    step), in place on ``d_c``/``e_c``; returns the two phase
    diagonals."""
    uphase = np.ones((n,), dtype=dt)
    vphase = np.ones((n,), dtype=dt)
    if np.iscomplexobj(np.zeros((), dtype=dt)):
        for j in range(n):
            val = d_c[j] * vphase[j]
            absv = abs(val)
            uphase[j] = val / absv if absv != 0 else 1.0
            d_c[j] = absv
            if j < n - 1:
                val = np.conj(uphase[j]) * e_c[j]
                absv = abs(val)
                vphase[j + 1] = np.conj(val) / absv if absv != 0 else 1.0
                e_c[j] = absv
    return uphase, vphase


def _tb2bd_ab(ab: np.ndarray, kd_eff: int, want_rots: bool = True):
    """Compiled Givens stage 2 on prepared upper-band storage
    ``ab[(n, kd_eff+3)]`` (modified in place)."""
    from .. import native

    n = ab.shape[0]
    with metrics.timer("chase.tb2bd"):
        lrot, rrot = native.tb2bd_banded(ab, n, kd_eff, want_rots)
    d_c = ab[:, 1].copy()
    e_c = ab[1:, 2].copy()
    uphase, vphase = _phase_bidiag(d_c, e_c, n, ab.dtype)
    rots = Tb2bdRotations(
        lplanes=lrot[0], lcs=lrot[1], lss=lrot[2],
        rplanes=rrot[0], rcs=rrot[1], rss=rrot[2],
        uphase=uphase, vphase=vphase, kd=kd_eff)
    return np.real(d_c), np.real(e_c), rots


def _tb2bd_native(b: np.ndarray, kd: int, want_rots: bool = True):
    """Compiled stage 2 from a dense band matrix: pack the band storage
    and run :func:`_tb2bd_ab`."""
    n = b.shape[0]
    dt = np.complex128 if np.iscomplexobj(b) else np.float64
    kd_eff = min(kd, n - 1)
    ab = np.zeros((n, kd_eff + 3), dtype=dt, order="C")
    for dd in range(kd_eff + 1):
        ab[dd:, dd + 1] = np.diagonal(b, dd)
    return _tb2bd_ab(ab, kd_eff, want_rots)


def tb2bd(band, kd: int, want_rots: bool = True
          ) -> Tuple[np.ndarray, np.ndarray, Tb2bdRotations]:
    """Reduce an upper triangular band matrix (superdiagonal width
    ``kd``) to real upper bidiagonal on the host — reference
    ``slate::tb2bd`` (``src/tb2bd.cc``, the bulge-chasing sweeps of
    ``gebr1/2/3``): the compiled Givens chase of
    :mod:`slate_tpu_torch.native` where it builds, else the same schedule
    in Python.  Returns ``(d, e, rotations)`` with
    B = U₂·bidiag(d, e)·V₂ᴴ."""
    from .. import native

    b = np.array(_numpy(band))
    n = b.shape[1]
    b = b[:n, :n].copy()
    if native.available() and n > 2 and kd >= 2:
        return _tb2bd_native(b, kd, want_rots)
    ll: List[Tuple[int, float, complex]] = []
    rl: List[Tuple[int, float, complex]] = []
    for bw in range(kd, 1, -1):
        for j in range(0, n - bw):
            row, p = j, j + bw - 1
            while True:
                # right rotation on columns (p, p+1) kills B[row, p+1]
                c, s = _givens(b[row, p], b[row, p + 1])
                gt = np.array([[c, s], [-np.conj(s), c]]).T
                lo, hi = max(0, p - bw - 1), min(n, p + 2)
                b[lo:hi, [p, p + 1]] = b[lo:hi, [p, p + 1]] @ gt
                rl.append((p + 1, c, s))
                # the bulge at (p+1, p): a left rotation on rows (p, p+1)
                c, s = _givens(b[p, p], b[p + 1, p])
                gm = np.array([[c, s], [-np.conj(s), c]])
                lo, hi = max(0, p - 1), min(n, p + bw + 2)
                b[[p, p + 1], lo:hi] = gm @ b[[p, p + 1], lo:hi]
                ll.append((p + 1, c, s))
                # the bulge now at (p, p+1+bw), if inside
                if p + 1 + bw >= n:
                    break
                row, p = p, p + bw
    d_c = np.diagonal(b).copy()
    e_c = np.diagonal(b, 1).copy()
    uphase, vphase = _phase_bidiag(d_c, e_c, n, b.dtype)
    rots = Tb2bdRotations(
        lplanes=np.asarray([x[0] for x in ll], dtype=np.int32),
        lcs=np.asarray([x[1] for x in ll], dtype=np.float64),
        lss=np.asarray([x[2] for x in ll]),
        rplanes=np.asarray([x[0] for x in rl], dtype=np.int32),
        rcs=np.asarray([x[1] for x in rl], dtype=np.float64),
        rss=np.asarray([x[2] for x in rl]),
        uphase=uphase, vphase=vphase)
    return np.real(d_c), np.real(e_c), rots


def unmbr_tb2bd(side: Side, rots: Tb2bdRotations, z) -> np.ndarray:
    """Back-transform through the Givens chase on the host — reference
    ``slate::unmbr_tb2bd`` (``src/unmbr_tb2bd.cc``): Z ← U₂·Z (``side``
    Left) or Z ← V₂·Z (Right)."""
    from .. import native

    z = np.asarray(_numpy(z))
    if side is Side.Left:
        phase, planes, cs, ss = rots.uphase, rots.lplanes, rots.lcs, rots.lss
    else:
        phase, planes, cs, ss = rots.vphase, rots.rplanes, rots.rcs, rots.rss
    if native.available():
        cplx = (np.iscomplexobj(phase) or np.iscomplexobj(ss)
                or np.iscomplexobj(z))
        dt = np.complex128 if cplx else np.float64
        zz = np.asarray(z, dtype=dt) * phase[:z.shape[0], None].astype(dt)
        if len(planes):
            zz = native.apply_rot_seq(zz, planes, cs, ss,
                                      0 if side is Side.Left else 1,
                                      kd=rots.kd)
        return zz
    if np.iscomplexobj(phase):
        z = z.astype(phase.dtype)
    z = phase[:z.shape[0], None] * z
    for idx in range(len(planes) - 1, -1, -1):
        i = int(planes[idx])
        c, s = cs[idx], ss[idx]
        if side is Side.Left:
            # L = [[c, s], [−s̄, c]] on rows; apply Lᴴ (reverse order)
            m2 = np.array([[c, -s], [np.conj(s), c]])
        else:
            # M = Gᵀ = [[c, −s̄], [s, c]] on the plane
            m2 = np.array([[c, -np.conj(s)], [s, c]])
        z[[i - 1, i], :] = m2 @ z[[i - 1, i], :]
    return z


# ---------------------------------------------------------------------------
# The bidiagonal solve (host LAPACK, like the reference's rank-0 bdsqr)
# ---------------------------------------------------------------------------

def bdsqr(d, e, want_uv: bool = False, method: MethodSVD = MethodSVD.Auto):
    """Singular values (and vectors) of a real upper bidiagonal matrix.
    Values only: the Golub–Kahan tridiagonal (zero diagonal, interleaved
    (d₁, e₁, d₂, …) off-diagonal, eigenvalues ±σ) through LAPACK
    ``sterf``; with vectors the dense bidiagonal through
    ``np.linalg.svd`` (gesdd), or scipy's ``gesvd`` under
    ``MethodSVD.QR``.  σ descending."""
    d = np.asarray(d, dtype=np.float64)
    e = np.asarray(e, dtype=np.float64)
    n = d.shape[0]
    if not want_uv:
        if n == 0:
            return d
        gk_off = np.zeros((2 * n - 1,))
        gk_off[0::2] = d
        if n > 1:
            gk_off[1::2] = e
        w = sterf(np.zeros((2 * n,)), gk_off)
        return np.sort(w[n:])[::-1]
    b = np.diag(d) + (np.diag(e, 1) if n > 1 else 0)
    if method is MethodSVD.QR:
        import scipy.linalg as sla

        return sla.svd(b, lapack_driver="gesvd")
    return np.linalg.svd(b)


# ---------------------------------------------------------------------------
# Stages 2 and 3
# ---------------------------------------------------------------------------

#: above this size svd's Auto solves the band with one dense host SVD
#: where the compiled host chase is unavailable
_BAND_SOLVER_MIN_N = 512


def _band_svd(band_sq, kd: int, want_u: bool, want_vt: bool, method,
              auto: bool):
    """Stages 2 and 3 on the n×n upper band tensor: band → bidiagonal →
    solve → back-transform through the chase.  Returns ``(s, u_b,
    vh_b)`` — ``s`` a host float64 array, ``u_b``/``vh_b`` None where not
    wanted, tensors on the band's device on the Householder routes, host
    arrays on the Givens route.

    The ``chase`` site decides first: ``"kernel"`` keeps the band on its
    device end to end (packed there, chased by one ``tb2bd_wavefront``
    launch, both logs consumed by the WY back-transforms where they lie —
    only the O(n) bidiagonal visits the host); ``"host_native"`` is the
    host chase below."""
    from .. import native
    from . import _chase

    n = int(band_sq.shape[0])
    want_uv = want_u or want_vt
    kd_dev = min(kd, n - 1)
    dev = band_sq.device
    if n > 2 and kd_dev >= 2 and _chase.backend(
            "tb2bd", n, kd_dev, band_sq.dtype, dev,
            want_uv and not band_sq.is_complex()) == "kernel":
        st = _chase.tb2bd_st_from_dense(band_sq, kd_dev)
        st, ulog, vlog = _chase.tb2bd_device(st, kd_dev)
        d, e = _chase.tb2bd_d_e(st, kd_dev, n)
        return _stage3_svd_hh(d, e, ulog, vlog, kd_dev, want_u, want_vt,
                              method, auto, dev)
    band_np = _numpy(band_sq)
    if auto and n > _BAND_SOLVER_MIN_N and not native.available():
        if not want_uv:
            return np.linalg.svd(band_np, compute_uv=False), None, None
        u_b, s, vh_b = np.linalg.svd(band_np, full_matrices=False)
        return s, (u_b if want_u else None), (vh_b if want_vt else None)
    if want_uv and not np.iscomplexobj(band_np) and native.available() \
            and n > 2 and kd_dev >= 2 and band_sq.is_cuda:
        # real with vectors: the Householder chase, whose logs
        # back-transform on the card
        st = np.zeros((n, 3 * kd_dev + 2), dtype=np.float64)
        for dd in range(kd_dev + 1):
            st[:n - dd, dd + kd_dev] = np.real(np.diagonal(band_np, dd))
        return _band_svd_hh_ab(st, kd_dev, want_u, want_vt, method, auto,
                               dev)
    d, e, rots = tb2bd(band_np, kd, want_rots=want_uv)
    return _stage3_svd(d, e, rots, want_u, want_vt, method, auto)


def _bidiag_solve(d, e, method, auto: bool):
    """``(u, s, vt)`` of the bidiagonal: LAPACK ``bdsdc`` under Auto (the
    reference's rank-0 slot, ``src/svd.cc:300+``), else :func:`bdsqr`."""
    from .. import native

    with metrics.timer("stage.svd.bidiag"):
        if auto and np.asarray(d).shape[0] > 1:
            u_bd, s, vh_bd = native.bdsdc(d, e)
            return np.ascontiguousarray(u_bd), s, np.ascontiguousarray(vh_bd)
        return bdsqr(d, e, want_uv=True, method=method)


def _stage3_svd(d, e, rots, want_u, want_vt, method, auto):
    """Bidiagonal solve + Givens back-transforms on the host."""
    if not (want_u or want_vt):
        return bdsqr(d, e).copy(), None, None
    u_bd, s, vh_bd = _bidiag_solve(d, e, method, auto)
    u_b = unmbr_tb2bd(Side.Left, rots, u_bd) if want_u else None
    vh_b = None
    if want_vt:
        vh_b = unmbr_tb2bd(Side.Right, rots, vh_bd.conj().T).conj().T
    return s, u_b, vh_b


def _bd_sweep_counts(n, kd, s0: int = 0, s1=None):
    """Per-sweep reflector counts of the bidiagonal Householder chase
    over sweeps ``[s0, s1)`` (the window logic of
    ``native.bd_step_count``, sweep by sweep)."""
    if s1 is None:
        s1 = max(n - 1, 0)
    counts = []
    for s in range(s0, min(s1, max(n - 1, 0))):
        if min(s + kd, n - 1) <= s + 1:
            continue
        cnt, b = 1, 1
        while b * kd + 1 + s <= n - 1:
            cnt += 1
            b += 1
        counts.append(cnt)
    return counts


def _stage3_svd_hh(d, e, ulog, vlog, kd_eff: int, want_u: bool,
                   want_vt: bool, method, auto: bool, device):
    """Bidiagonal solve + batched-WY back-transforms on ``device`` for
    the Householder-chase routes; each log is a ``(v3, t2, s0)`` triple,
    tensors on the card (kernel route) or host arrays (host chase, one
    upload each).  The bidiagonal's singular vectors enter in the log's
    dtype."""
    u_bd, s, vh_bd = _bidiag_solve(d, e, method, auto)

    def back(log, z):
        v3 = torch.as_tensor(log[0], device=device)
        z = torch.from_numpy(np.ascontiguousarray(z)).to(device=device,
                                                          dtype=v3.dtype)
        return unmtr_hb2st_hh(v3, log[1], log[2], z, kd_eff)

    u_b = back(ulog, u_bd) if want_u else None
    vh_b = back(vlog, vh_bd.T).T if want_vt else None
    return s, u_b, vh_b


def _band_svd_hh_ab(st: np.ndarray, kd_eff: int, want_u: bool,
                    want_vt: bool, method, auto: bool, device):
    """Real-fp64 stages 2 and 3 through the HOST Householder bidiagonal
    chase on general-band storage ``st[(n, 3·kd+2)]`` (in place): the U
    and V logs back-transform on ``device`` as batched WY products — the
    ``host_native`` route of the ``chase`` site on the card."""
    from .. import native
    from . import _chase

    n = st.shape[0]
    with metrics.timer("chase.tb2bd"):
        ulog, vlog = native.tb2bd_hh_banded(st, n, kd_eff)
    d = st[:, kd_eff].copy()
    e = st[:n - 1, kd_eff + 1].copy()
    counts = _bd_sweep_counts(n, kd_eff)
    pu = _pack_hh_log(*ulog, n, kd_eff, counts=counts)
    pv = _pack_hh_log(*vlog, n, kd_eff, counts=counts)
    _chase.mark_host_path("tb2bd", pu + pv)
    return _stage3_svd_hh(d, e, pu, pv, kd_eff, want_u, want_vt, method,
                          auto, device)


def _band_svd_ab(ab, kd_eff: int, want_u: bool, want_vt: bool, method,
                 auto: bool, device):
    """Stages 2 and 3 from O(n·kd) upper band storage ``ab[(n, kd+3)]``
    (``ab[c, (c−r)+1]`` = A[r, c]) on the host — the distributed drivers'
    entry.  Real fp64 with vectors takes the Householder chase whose logs
    back-transform on ``device`` (the kernel when the ``chase`` site
    answers so, else the host chase with one upload of each log on the
    card); the rest the Givens chase."""
    from .. import native
    from . import _chase

    n = ab.shape[0]
    want_uv = want_u or want_vt
    if not (native.available() and n > 2 and kd_eff >= 2):
        # no toolchain or tiny n: rebuild the dense band (small here)
        dense = np.zeros((n, n), dtype=ab.dtype)
        idx = np.arange(n)
        for dd in range(min(kd_eff, n - 1) + 1):
            dense[idx[:n - dd], idx[:n - dd] + dd] = ab[dd:, dd + 1]
        return _band_svd(torch.from_numpy(dense).to(device), kd_eff, want_u,
                         want_vt, method, auto)
    if want_uv and ab.dtype == np.float64 and _chase.backend(
            "tb2bd", n, kd_eff, torch.float64, device, True) == "kernel":
        st, ulog, vlog = _chase.tb2bd_device(
            _chase.tb2bd_st_from_ab(ab, kd_eff, device), kd_eff)
        d, e = _chase.tb2bd_d_e(st, kd_eff, n)
        return _stage3_svd_hh(d, e, ulog, vlog, kd_eff, want_u, want_vt,
                              method, auto, device)
    if want_uv and ab.dtype == np.float64 \
            and torch.device(device).type == "cuda":
        # the WY back-transform pays off only where the card applies it
        st = np.zeros((n, 3 * kd_eff + 2), dtype=np.float64)
        for dd in range(kd_eff + 1):
            st[:n - dd, dd + kd_eff] = ab[dd:, dd + 1]
        return _band_svd_hh_ab(st, kd_eff, want_u, want_vt, method, auto,
                               device)
    d, e, rots = _tb2bd_ab(ab, kd_eff, want_rots=want_uv)
    return _stage3_svd(d, e, rots, want_u, want_vt, method, auto)


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

def svd_vals(a, opts: Optional[Options] = None, *, device=None):
    """Singular values, descending — reference ``slate::svd_vals``."""
    return svd(a, jobu=False, jobvt=False, opts=opts, device=device)[0]


@instrument_driver("svd")
def svd(a, jobu: bool = True, jobvt: bool = True,
        opts: Optional[Options] = None, *, device=None):
    """Two-stage SVD — reference ``slate::svd`` (``src/svd.cc:207-372``).

    Returns ``(σ, U, Vᴴ)``, economy sizes (U is m×k, Vᴴ is k×n,
    k = min(m, n)), tensors on the operand's device, σ descending in its
    real dtype; U/Vᴴ are None when not wanted.  For m < n it works on Aᴴ
    and swaps.  ``method_svd`` picks the bidiagonal solver (``MethodSVD``:
    LAPACK ``bdsdc`` under Auto).  The ``svd_driver`` site (or an
    ``svd_driver`` option) picks the driver: ``"twostage"``, the chain
    below, or ``"qdwh"``, the polar factor and QDWH-eig of its Hermitian
    factor (:func:`~slate_tpu_torch.linalg.polar.svd_qdwh`)."""
    from ..perf import autotune

    dev = _device_of(a, device=device)
    av = _arr(a, dev)
    m, n = av.shape
    if m < n:
        # Aᴴ = V·Σ·Uᴴ — reference src/svd.cc:207
        s, u, vh = svd(_ct(av).resolve_conj(), jobu=jobvt, jobvt=jobu,
                       opts=opts, device=dev)
        return (s, None if vh is None else _ct(vh).resolve_conj(),
                None if u is None else _ct(u).resolve_conj())
    method = get_option(opts, "method_svd", MethodSVD.Auto)
    driver = get_option(opts, "svd_driver", None)
    if driver is None:
        driver = autotune.select("svd_driver", m=m, n=n, dtype=av.dtype,
                                 device=dev,
                                 eligible=method is MethodSVD.Auto)
    if driver == "qdwh":
        from .polar import svd_qdwh

        return svd_qdwh(a, jobu=jobu, jobvt=jobvt, opts=opts, device=dev)
    return _svd_twostage(av, _nb(a, opts), jobu, jobvt, method)


def _svd_twostage(av, nb: int, jobu: bool, jobvt: bool, method):
    """The two-stage chain (ge2tb → band SVD → back-transforms); m ≥ n."""
    m, n = av.shape
    auto = method is MethodSVD.Auto
    with metrics.timer("stage.svd.stage1"):
        factors = _ge2tb(av, nb)
        _sync(factors.band)
    band = factors.band
    # ge2tb leaves the band in the top n rows: stage 2 works on the n×n
    # head, on its device
    with metrics.timer("stage.svd.stage2"):
        s, u_b, vh_b = _band_svd(band[:n], factors.kd, jobu, jobvt, method,
                                 auto)
    s = torch.from_numpy(np.ascontiguousarray(s)).to(
        device=band.device, dtype=band.real.dtype)
    if not (jobu or jobvt):
        return s, None, None
    u = vh = None
    with metrics.timer("stage.svd.stage3"):
        if jobu:
            u2 = torch.as_tensor(u_b).to(device=band.device, dtype=band.dtype)
            if m > n:
                u2 = torch.cat([u2, u2.new_zeros((m - n, u2.shape[1]))])
            u = unmbr_ge2tb(Side.Left, Op.NoTrans, factors, u2)
        if jobvt:
            v2 = _ct(torch.as_tensor(vh_b)).resolve_conj().to(
                device=band.device, dtype=band.dtype)
            vh = _ct(unmbr_ge2tb(Side.Right, Op.NoTrans, factors,
                                 v2)).resolve_conj()
        _sync(u if u is not None else vh)
    return s, u, vh


#: Deprecated alias kept by the reference (``slate.hh``: ``gesvd``).
gesvd = svd
