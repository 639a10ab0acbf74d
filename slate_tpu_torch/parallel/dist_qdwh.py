"""Distributed QDWH spectral tier — ``ppolar``, ``pheev_qdwh`` and
``psvd_qdwh``, the counterpart of ``slate_tpu/parallel/dist_qdwh.py``.

The grid mirror of :mod:`slate_tpu_torch.linalg.polar`: the polar
decomposition by the dynamically weighted Halley iteration, then
spectral divide and conquer, every O(n³) term on the grid through the
distributed primitives — ``pgeqrf`` + ``punmqr_conj`` for the stacked-QR
steps, ``ppotrf`` + ``ptrsm`` for the Cholesky steps, ``pgemm`` for the
Halley epilogues, the projector products and the similarity transforms.

As in the JAX package the iterate is replicated between the steps (each
rank takes its own blocks of it, nothing communicated, and every grid
product comes back replicated through :func:`~.dist.undistribute`), and
the stacked-QR step recovers the thin factors from the full Qᴴ
(``punmqr_conj`` of the identity) rather than the unstable X·(RᴴR)⁻¹.
Every decision the ranks take on the host reads a value agreed over the
grid first (:func:`_agree`, rank (0, 0)'s value through one ``psum``):
the spectral interval and with it the whole weight loop, each shift and
each trace count k.  The leaf test reads only the block's size.  A leaf
(at or below ``max(polar.QDWH_CROSSOVER·p, nb)``, or the
``qdwh_crossover`` option) and a degenerate split are solved once, on
rank (0, 0), by the single-device driver (:func:`polar._heev_qdwh`), and
handed to every rank with one ``psum`` — the JAX package solves them on
its one addressable chip.  The mixing matrices are the JAX package's
(``np.random.default_rng(0x0D_5EED + depth)``), so the vectors agree up
to a sign or phase a column.

Operands are square (the eigensolver path); a rectangular ``psvd_qdwh``
falls back to the single-device ``svd_qdwh`` with a ``RuntimeWarning``.
Counters (metrics on): ``qdwh.step.qr``, ``qdwh.step.chol``,
``qdwh.dc.degenerate``, ``collective.qdwh_agree``; timers
``stage.pqdwh.qr``, ``.chol``, ``.gemm``, ``.leaf``.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from ..enums import Diag, Op, Side, Uplo
from ..options import get_option
from ..perf import metrics
from .dist import DistMatrix, distribute, undistribute
from .dist_aux import ptrsm
from .dist_blas3 import pgemm
from .dist_factor import ppotrf
from .dist_qr import pgeqrf, punmqr_conj
from .dist_util import _stage, agree_values, peye
from .mesh import BOTH, mesh_grid_shape

__all__ = ["pheev_qdwh", "ppolar", "psvd_qdwh"]


def _ct(x):
    return x.mH


def _eye(n: int, x):
    return torch.eye(n, dtype=x.dtype, device=x.device)


def _dist(av, mesh, nb):
    p, q = mesh_grid_shape(mesh)
    return distribute(av, mesh, nb, row_mult=q, col_mult=p)


def _agree(mesh, *values):
    """Rank (0, 0)'s ``values`` on every rank (:func:`~.dist_util.
    agree_values`, counted as ``collective.qdwh_agree``)."""
    return agree_values(mesh, *values, kind="qdwh_agree")


def _pgemm_dense(alpha, a_h, b_h, beta, c_h, mesh, nb):
    """One grid gemm of replicated operands: distribute, pgemm, gather."""
    cd = _dist(c_h, mesh, nb) if c_h is not None else None
    out = pgemm(alpha, _dist(a_h, mesh, nb), _dist(b_h, mesh, nb),
                beta if c_h is not None else 0.0, cd)
    return undistribute(out)


def _pqr_step(x, a_k, b_k, c_k, mesh, nb):
    """One distributed QR-based Halley step (square x): the full Qᴴ of
    [√c·X; I] from ``pgeqrf`` and ``punmqr_conj`` of the identity, then
    X' = (b/c)·X + (a − b/c)/√c · Q₁Q₂ᴴ."""
    n = x.shape[0]
    sc = math.sqrt(c_k)
    with _stage("stage.pqdwh.qr", mesh):
        stacked = torch.cat([sc * x, _eye(n, x)])
        qr, tmats, _taus = pgeqrf(_dist(stacked, mesh, nb))
        qh = undistribute(punmqr_conj(qr, tmats, peye(2 * n, nb, mesh,
                                                      dtype=x.dtype)))
        q1, q2h = _ct(qh[:n, :n]), qh[:n, n:2 * n]
    with _stage("stage.pqdwh.gemm", mesh):
        return _pgemm_dense((a_k - b_k / c_k) / sc, q1, q2h, b_k / c_k, x,
                            mesh, nb)


def _pchol_step(x, a_k, b_k, c_k, mesh, nb):
    """One distributed Cholesky-based Halley step (square x):
    Z = I + c·XᴴX = W·Wᴴ by ``ppotrf``, X·Z⁻¹ = X·W⁻ᴴ·W⁻¹ by two right
    ``ptrsm``, X' = (b/c)·X + (a − b/c)·X·Z⁻¹."""
    n = x.shape[0]
    p, q = mesh_grid_shape(mesh)
    with _stage("stage.pqdwh.gemm", mesh):
        z = _pgemm_dense(c_k, _ct(x), x, 0.0, None, mesh, nb)
        z = 0.5 * (z + _ct(z)) + _eye(n, x)
    with _stage("stage.pqdwh.chol", mesh):
        w = ppotrf(distribute(z, mesh, nb, diag_pad=1.0, row_mult=q,
                              col_mult=p))
        t1 = ptrsm(Side.Right, Uplo.Lower, Op.ConjTrans, Diag.NonUnit, w,
                   _dist(x, mesh, nb))
        y = undistribute(ptrsm(Side.Right, Uplo.Lower, Op.NoTrans,
                               Diag.NonUnit, w, t1))
    return (b_k / c_k) * x + (a_k - b_k / c_k) * y


def _ppolar_u(av, mesh, nb, opts, interval=None):
    """The distributed Halley iteration: the polar factor of the square,
    replicated ``av`` (replicated in, replicated out; grid flops).  The
    interval, and so every weight and step variant, is agreed over the
    grid."""
    from ..linalg.condest import spectral_interval
    from ..linalg.polar import QDWH_MAXITER, _halley_weights
    from ..perf import autotune

    n = av.shape[0]
    eps = float(torch.finfo(av.dtype).eps)
    if interval is None:
        # O(n²) estimators and one blocked QR on this rank's device:
        # cheap next to the grid iteration
        interval = spectral_interval(av, opts, device=av.device)
    alpha, smin = _agree(mesh, *interval)
    if not (alpha > 0.0) or not math.isfinite(alpha):
        return _eye(n, av)
    l = min(max(smin / alpha, eps), 1.0)
    x = av / alpha
    it = 0
    while it < QDWH_MAXITER and abs(1.0 - l) > 10.0 * eps:
        a_k, b_k, c_k = _halley_weights(l)
        if autotune.select("qdwh_step", n=n, c=c_k, dtype=av.dtype,
                           device=av.device) == "chol":
            x = _pchol_step(x, a_k, b_k, c_k, mesh, nb)
            metrics.inc("qdwh.step.chol")
        else:
            x = _pqr_step(x, a_k, b_k, c_k, mesh, nb)
            metrics.inc("qdwh.step.qr")
        l = l * (a_k + b_k * l * l) / (1.0 + c_k * l * l)
        it += 1
    return x


def _square_dense(a, mesh, nb, who):
    """(replicated square tensor, mesh, nb) of a dense or DistMatrix
    operand; the distributed QDWH drivers are square-only."""
    if isinstance(a, DistMatrix):
        mesh, nb = a.mesh, a.nb
        av = undistribute(a)
    else:
        if mesh is None:
            raise ValueError(f"{who} needs a mesh for dense input")
        av = torch.as_tensor(a, device=mesh.device)
    if av.ndim != 2 or av.shape[0] != av.shape[1]:
        raise ValueError(f"{who} requires a square matrix, got "
                         f"{tuple(av.shape)}")
    return av, mesh, nb


def ppolar(a, mesh=None, nb: int = 256, opts=None):
    """Distributed polar decomposition A = U·H of a square operand (a
    dense array with ``mesh``, or a DistMatrix).  Returns ``(u, h)``,
    replicated tensors on the mesh's device; every O(n³) step runs on the
    grid."""
    av, mesh, nb = _square_dense(a, mesh, nb, "ppolar")
    u = _ppolar_u(av, mesh, nb, opts)
    with _stage("stage.pqdwh.gemm", mesh):
        uh_a = _pgemm_dense(1.0, _ct(u), av, 0.0, None, mesh, nb)
    return u, 0.5 * (uh_a + _ct(uh_a))


def _leaf(av, mesh, opts):
    """A leaf block's eigenpairs: the single-device QDWH driver on rank
    (0, 0), handed to every rank with one psum."""
    from ..linalg.polar import _heev_qdwh

    n = av.shape[0]
    buf = torch.zeros(n + n * n, dtype=av.dtype, device=av.device)
    with _stage("stage.pqdwh.leaf", mesh):
        if (mesh.r, mesh.c) == (0, 0):
            w, z = _heev_qdwh(av, True, opts, "heev", device=av.device)
            buf[:n] = w
            buf[n:] = z.reshape(-1)
        mesh.psum(buf, BOTH)
    w = buf[:n]
    return (w.real if w.is_complex() else w), buf[n:].view(n, n)


def _pdc(av, mesh, nb, leaf_n, opts, depth):
    """Distributed spectral divide and conquer on a replicated Hermitian
    block: the grid polar of the shifted block, the invariant subspaces
    from a grid QR of the projected mixing matrix, the similarity by
    ``pgemm``; blocks at or below ``leaf_n`` go to :func:`_leaf`.
    Returns ``(w, Z)`` unsorted, replicated."""
    from ..linalg.polar import _DC_MAX_DEPTH, _start_draw

    n = av.shape[0]
    dt = av.dtype
    if n <= leaf_n or depth >= _DC_MAX_DEPTH:
        return _leaf(av, mesh, opts)
    draw = _start_draw(n, depth, dt)
    eye = _eye(n, av)
    host = torch.stack([torch.diagonal(av).real, av.abs().sum(dim=1)]) \
        .double().cpu().numpy()
    dvec, off = host[0], host[1] - np.abs(host[0])
    # the mean eigenvalue, then the Gershgorin midpoint and the diagonal
    # median where the projector degenerates
    shifts = _agree(mesh, dvec.mean(),
                    0.5 * ((dvec - off).min() + (dvec + off).max()),
                    np.median(dvec))
    us, k = None, 0
    for sigma in shifts:
        us = _ppolar_u(av - sigma * eye, mesh, nb, opts)
        # U_s ≈ sign(A − σI): its trace counts (#λ>σ) − (#λ<σ)
        tr, = _agree(mesh, torch.diagonal(us).sum().real)
        k = int(round((tr + n) / 2.0))
        if 0 < k < n:
            break
    else:
        # a clustered spectrum at every shift: the leaf solver owns it
        metrics.inc("qdwh.dc.degenerate")
        return _leaf(av, mesh, opts)
    proj = 0.5 * (us + eye)      # spectral projector onto λ > σ, rank k
    g = torch.from_numpy(draw.result()).to(device=av.device, dtype=dt)
    with _stage("stage.pqdwh.gemm", mesh):
        span = torch.cat([
            _pgemm_dense(1.0, proj, g[:, :k], 0.0, None, mesh, nb),
            _pgemm_dense(-1.0, proj, g[:, k:], 1.0, g[:, k:], mesh, nb)],
            dim=1)
    with _stage("stage.pqdwh.qr", mesh):
        qr, tmats, _taus = pgeqrf(_dist(span, mesh, nb))
        v = _ct(undistribute(punmqr_conj(qr, tmats,
                                         peye(n, nb, mesh, dtype=dt))))
    with _stage("stage.pqdwh.gemm", mesh):
        b = _pgemm_dense(1.0, _ct(v),
                         _pgemm_dense(1.0, av, v, 0.0, None, mesh, nb),
                         0.0, None, mesh, nb)
    a1, a2 = b[:k, :k], b[k:, k:]
    w1, z1 = _pdc(0.5 * (a1 + _ct(a1)), mesh, nb, leaf_n, opts, depth + 1)
    w2, z2 = _pdc(0.5 * (a2 + _ct(a2)), mesh, nb, leaf_n, opts, depth + 1)
    with _stage("stage.pqdwh.gemm", mesh):
        zz1 = _pgemm_dense(1.0, v[:, :k], z1, 0.0, None, mesh, nb)
        zz2 = _pgemm_dense(1.0, v[:, k:], z2, 0.0, None, mesh, nb)
    return torch.cat([w2, w1]), torch.cat([zz2, zz1], dim=1)


def pheev_qdwh(a, mesh=None, nb: int = 256, jobz: bool = True, opts=None):
    """Distributed QDWH-eig: spectral divide and conquer over the grid
    polar factor.  Returns ``(w, Z)``, ``w`` ascending (a replicated
    tensor of the input's real dtype) and ``Z`` a DistMatrix (None when
    not ``jobz``) — the ``pheev`` contract.  Blocks at or below
    ``polar.QDWH_CROSSOVER`` × the grid's row count (at least nb), or the
    ``qdwh_crossover`` option, are solved by the single-device driver."""
    from ..linalg.polar import QDWH_CROSSOVER

    av, mesh, nb = _square_dense(a, mesh, nb, "pheev_qdwh")
    p, _q = mesh_grid_shape(mesh)
    leaf_n = int(get_option(opts, "qdwh_crossover",
                            max(QDWH_CROSSOVER * p, nb)))
    av = 0.5 * (av + _ct(av))
    w, z = _pdc(av, mesh, nb, max(2, leaf_n), opts, 0)
    order = torch.argsort(w)
    w = w[order]
    if not jobz:
        return w, None
    return w, _dist(z[:, order], mesh, nb)


def psvd_qdwh(a, mesh=None, nb: int = 256, jobu: bool = True,
              jobvt: bool = True, opts=None):
    """Distributed QDWH-SVD: the grid polar factor, then
    :func:`pheev_qdwh` of the positive semidefinite factor.  Returns
    ``(s, U, Vᴴ)``, σ descending (replicated), U and Vᴴ DistMatrices
    (None where not asked for).  Square operands only: a rectangular one
    is gathered to the single-device ``svd_qdwh`` with a warning."""
    if isinstance(a, DistMatrix):
        rect = a.m != a.n
    else:
        shape = tuple(torch.as_tensor(a).shape)
        rect = len(shape) == 2 and shape[0] != shape[1]
    if rect:
        from ..linalg.polar import svd_qdwh

        warnings.warn(
            "psvd_qdwh: rectangular operand — falling back to the "
            "single-device QDWH driver (the distributed tier is "
            "square-only)", RuntimeWarning, stacklevel=2)
        if isinstance(a, DistMatrix):
            mesh, nb, a = a.mesh, a.nb, undistribute(a)
        if mesh is None:
            raise ValueError("psvd_qdwh needs a mesh for dense input")
        s, u, vh = svd_qdwh(torch.as_tensor(a, device=mesh.device), jobu,
                            jobvt, opts, device=mesh.device)
        return (s, None if u is None else _dist(u, mesh, nb),
                None if vh is None else _dist(vh, mesh, nb))
    av, mesh, nb = _square_dense(a, mesh, nb, "psvd_qdwh")
    u_p = _ppolar_u(av, mesh, nb, opts)
    with _stage("stage.pqdwh.gemm", mesh):
        uh_a = _pgemm_dense(1.0, _ct(u_p), av, 0.0, None, mesh, nb)
    h = 0.5 * (uh_a + _ct(uh_a))
    w, zd = pheev_qdwh(h, mesh, nb, True, opts)
    s = torch.clamp(w.flip(0), min=0)
    z = undistribute(zd).flip(1)
    ud = vd = None
    if jobu:
        with _stage("stage.pqdwh.gemm", mesh):
            ud = _dist(_pgemm_dense(1.0, u_p, z, 0.0, None, mesh, nb),
                       mesh, nb)
    if jobvt:
        vd = _dist(_ct(z).resolve_conj(), mesh, nb)
    return s, ud, vd
