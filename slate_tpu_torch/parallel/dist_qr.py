"""Distributed Householder QR and least squares over the ('p', 'q') grid —
the counterpart of ``slate_tpu/parallel/dist_qr.py`` (``pgeqrf``,
``punmqr_conj``, ``pgels``, ``pgelqf``, ``punmlq``; reference
``src/geqrf.cc``, ``unmqr.cc``, ``gels_qr.cc``, ``gelqf.cc``,
``unmlq.cc``).

The JAX package's design, step for step: the block column k arrives
replicated through ONE fused broadcast
(:func:`~.dist_util.bcast_block_col`); every rank factors the (M, nb)
panel redundantly, the ``dist_panel`` site choosing the Householder
panel and its compact-WY T (``xla``) or the CholQR² panel with the
Householder reconstruction (``pallas_panel``: ``chol_inv_panel`` twice,
``lu_inv_panel`` and ``trtri_panel`` once a step, guarded by its
departure); the trailing update C ← (I − V·Tᴴ·Vᴴ)·C is one ``psum`` along
'p' of Vᴴ·C and one local product over the stage's window
(:func:`~.dist_util.staged_fori`); a ring of D panels in flight takes
step k's reflector correction from replicated operands alone, and block
column k + D is brought up to date and broadcast before the wide
trailing update.  ``pgels`` is Qᴴ·B (:func:`punmqr_conj`) and the
distributed upper solve of :mod:`.dist_lu`.

The factor is LAPACK's: R on and above the diagonal, V below, with the
per-panel T blocks and τ returned replicated on every rank.  Each rank
runs this in its own process with its own (r, c); the JAX package's masks
on ``k % q == c`` are Python branches here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..grid import ceildiv
from ..linalg.qr import _cholqr2_panel, _panel_geqrf, _unit_lower, larft_rec
from ..ops.blocks import matmul as _mm
from ..perf import metrics
from .dist import DistMatrix, distribute, like
from .dist_aux import index_maps
from .dist_lu import _plu_trsm
from .dist_twostage import _papply_q
from .dist_util import (bcast_block_col, dist_chunk_slices,
                        dist_lookahead_depth, dist_panel_backend,
                        local_grows, ptranspose, stage_bounds, staged_fori)
from .mesh import AXIS_P, BOTH, mesh_grid_shape


def _householder_panel(masked):
    packed, taus = _panel_geqrf(masked)
    return packed, taus, larft_rec(_unit_lower(packed, packed.shape[1]),
                                   taus)


def _panel_factor(mesh, backend: str, masked):
    """(packed, τ, T) of the replicated masked (M, nb) panel.  Under
    ``pallas_panel`` the CholQR² panel, kept while its first-pass
    departure is under 0.25 (past it CholQR² no longer restores
    orthogonality) and else replaced by the Householder panel.  The
    departure is the maximum over the grid (one ``pmax`` of a scalar),
    read on the host: every rank takes the same branch, as the JAX
    package's ``lax.cond`` on a replicated value does
    (``slate_tpu/parallel/dist_qr.py:96-101``), so no rank reruns the
    panel while another goes on to the next collective."""
    if backend != "pallas_panel":
        return _householder_panel(masked)
    nb = masked.shape[1]
    y, rprime, taus, tmat, dev = _cholqr2_panel(masked)
    packed = torch.cat([rprime + torch.tril(y[:nb], -1), y[nb:]])
    devv = torch.where(torch.isfinite(dev), dev, torch.full_like(dev, 2.0))
    devv = mesh.pmax(devv.reshape(1).to(torch.float32), BOTH)
    dm = float(devv)
    metrics.set_gauge("pgeqrf.cholqr2.devmax", dm)
    if dm < 0.25:
        return packed, taus, tmat
    metrics.inc("pgeqrf.cholqr2.reruns")
    return _householder_panel(masked)


def _pgeqrf(mesh, a_loc, nb: int, nt: int, backend: str, depth: int,
            chunks: int):
    """The step loop on this rank's shard ``a_loc``, in place; returns
    ``(a_loc, tmats, taus)``."""
    p, q = mesh_grid_shape(mesh)
    r, c = mesh.r, mesh.c
    ml, nl = a_loc.shape[0] // nb, a_loc.shape[1] // nb
    M = p * ml * nb
    dt, dev = a_loc.dtype, a_loc.device
    grows_h = local_grows(ml, nb, p, r)
    depth = max(1, min(depth, nt))
    tmats = torch.zeros((nt, nb, nb), dtype=dt, device=dev)
    taus = torch.zeros((nt, nb), dtype=dt, device=dev)

    def getcol(k):
        return a_loc[:, (k // q) * nb:(k // q + 1) * nb]

    def make_body(row0, col0):
        # global block of each local column block of the window
        wblk = np.arange(col0 // nb, nl) * q + c

        def body(k, ring):
            # ring[j]: the replicated panel of step k + j, updated through
            # step k − 1; the factored rows (wrapped to the end by the JAX
            # package's roll) are zero
            panel = ring[0]
            valid = M - k * nb
            masked = torch.zeros_like(panel)
            masked[:valid] = panel[k * nb:]
            packed, tau, tmat = _panel_factor(mesh, backend, masked)
            v_full = _unit_lower(packed, nb)
            # ---- the packed factor into column k; my rows of V
            rel = grows_h - k * nb
            lo = int(np.searchsorted(rel, 0))
            idx = torch.as_tensor(rel[lo:], device=dev)
            if k % q == c and lo < len(rel):
                getcol(k)[lo:] = packed.index_select(0, idx)
            v_loc = torch.zeros((ml * nb, nb), dtype=dt, device=dev)
            v_loc[lo:] = v_full.index_select(0, idx)
            v_win = v_loc[row0:]
            # ---- W = Vᴴ·C over the window's columns of blocks > k, one
            # psum along 'p'
            cs = col0 + int(np.searchsorted(wblk, k, side="right")) * nb
            wide = cs < a_loc.shape[1]       # alike along 'p' (same c)
            if wide:
                w = mesh.psum(_mm(v_win.mH, a_loc[row0:, cs:]), AXIS_P)
                tw = _mm(tmat.mH, w)
            new_ring = []
            # ---- deep lookahead: the in-flight panels take step k's
            # block-reflector correction from replicated operands only
            live = [j for j in range(1, depth) if k + j < nt]
            if live:
                v_glob = torch.zeros((M, nb), dtype=dt, device=dev)
                v_glob[k * nb:] = v_full[:valid]
                for j in live:
                    pj = ring[j]
                    new_ring.append(pj - _mm(v_glob, _mm(
                        tmat.mH, _mm(v_glob.mH, pj))))
            # ---- lookahead broadcast: block column k + D with step k's
            # update (a narrow product off W), before the wide update
            kn = k + depth
            if kn < nt:
                own = kn % q == c
                coln = getcol(kn)[row0:]
                if own:
                    jn = (kn // q) * nb - cs
                    coln = coln - _mm(v_win, tw[:, jn:jn + nb])
                new_ring.append(bcast_block_col(mesh, coln, grows_h[row0:],
                                                own, M, chunks))
            # ---- the wide trailing update on the window
            if wide:
                a_loc[row0:, cs:] -= _mm(v_win, tw)
            tmats[k] = tmat
            taus[k] = tau
            return new_ring

        return body

    ring = [bcast_block_col(mesh, getcol(j), grows_h, j % q == c, M, chunks)
            for j in range(depth)]
    staged_fori(stage_bounds(nt), p, q, nb, make_body, ring)
    return a_loc, tmats, taus


def pgeqrf(a: DistMatrix):
    """Distributed blocked Householder QR (reference ``slate::geqrf``,
    ``src/geqrf.cc``): ``(qr, tmats, taus)`` with R in the upper triangle
    of ``qr``, the V's packed below, and the compact-WY T of each panel
    (``tmats[k]``, (nt, nb, nb)) and its τ (``taus``, (nt, nb)) replicated
    tensors on every rank.  Distribute the operand with ``row_mult=q,
    col_mult=p`` (see :func:`pgels`).  The ``dist_panel``,
    ``dist_lookahead`` and ``dist_chunk`` sites pick the panel, the ring
    depth and the broadcast slices."""
    if a.m < a.n:
        raise ValueError("pgeqrf requires m >= n (tall); use gelqf "
                         "semantics for wide problems")
    if a.row_nb != a.nb:
        raise ValueError("pgeqrf needs square tiles (mb == nb)")
    nt = ceildiv(a.n, a.nb)
    if a.mtp < nt or a.ntp < nt:
        raise ValueError("padded grid too small for the panel count")
    backend = dist_panel_backend("geqrf", a.nb, a.dtype, a.device)
    depth = dist_lookahead_depth("geqrf", nt, a.nb, a.dtype, a.device)
    chunks = dist_chunk_slices("geqrf", a.nb, a.dtype, a.mesh)
    qr, tmats, taus = _pgeqrf(a.mesh, a.data.clone(), a.nb, nt, backend,
                              depth, chunks)
    return like(a, qr), tmats, taus


def _check_rows(name: str, qr: DistMatrix, b: DistMatrix) -> None:
    if b.mtp != qr.mtp or b.nb != qr.nb or b.row_nb != qr.nb:
        raise ValueError(f"{name}: B row padding/tile size must match the "
                         "factor")
    if b.mesh is not qr.mesh:
        raise ValueError(f"{name}: operands must live on the same mesh")


def punmqr_conj(qr: DistMatrix, tmats, b: DistMatrix) -> DistMatrix:
    """B ← Qᴴ·B from a :func:`pgeqrf` factor (reference ``unmqr``,
    ``src/unmqr.cc``): the panels first to last, each a ``psum`` of the
    factor's block column along 'q' and of Vᴴ·B along 'p'."""
    _check_rows("punmqr_conj", qr, b)
    nt = ceildiv(qr.n, qr.nb)
    return like(b, _papply_q(qr.mesh, qr.data, tmats, b.data, qr.nb, nt, 0,
                             False))


def _patch_diag_tail(qr: DistMatrix, n_true: int):
    """A copy of the factor's shard with R[j, j] = 1 on the pad columns
    j ≥ ``n_true``, so the padded upper solve stays nonsingular (the pad
    rows of X are junk and sliced off; a zero diagonal would make them
    NaN, and NaN·0 would reach the true rows)."""
    grows, gcols = index_maps(qr)
    mask = (grows[:, None] == gcols[None, :]) & (grows[:, None] >= n_true)
    return torch.where(mask, torch.ones((), dtype=qr.dtype,
                                        device=qr.device), qr.data)


def pgels(a, b, mesh, nb: int = 256):
    """Distributed least squares through QR (reference ``slate::gels_qr``,
    ``src/gels_qr.cc``): minimizes ‖A·X − B‖ for tall full-rank A.  Dense
    replicated operands are distributed first (A with ``diag_pad=1``).
    Returns ``(qr, tmats, x)`` with ``x`` an n×nrhs DistMatrix."""
    p, q = mesh_grid_shape(mesh)
    if isinstance(a, DistMatrix):
        n = a.n
        ad = a
    else:
        n = a.shape[1]
        ad = distribute(a, mesh, nb, diag_pad=1.0, row_mult=q, col_mult=p)
    bd = b if isinstance(b, DistMatrix) else \
        distribute(b, mesh, nb, row_mult=q)
    qr, tmats, taus = pgeqrf(ad)
    cb = punmqr_conj(qr, tmats, bd)
    nt = ceildiv(n, ad.nb)
    x = _plu_trsm(qr.mesh, _patch_diag_tail(qr, n), cb.data.clone(), qr.nb,
                  nt, True)
    return qr, tmats, like(cb, x, m=n)


def pgelqf(a: DistMatrix):
    """Distributed LQ factorization (reference ``slate::gelqf``,
    ``src/gelqf.cc``): the QR of Aᴴ, transposed back
    (:func:`~.dist_util.ptranspose`).  Returns ``(lq, tmats, taus)`` with L
    on and below the diagonal and the reflectors' Vᴴ packed above
    (LAPACK's ``gelqf`` layout)."""
    qr, tmats, taus = pgeqrf(ptranspose(a, conj=True))
    return ptranspose(qr, conj=True), tmats, taus


def punmlq(lq: DistMatrix, tmats, b: DistMatrix,
           adjoint: bool = False) -> DistMatrix:
    """Apply the LQ's Q̃ (A = L·Q̃) to a matrix whose rows live in A's
    column space: B ← Q̃·B, or Q̃ᴴ·B where ``adjoint`` (reference
    ``slate::unmlq``, ``src/unmlq.cc``).  Q̃ = Q_qrᴴ of the underlying
    QR of Aᴴ, so Q̃·B is :func:`punmqr_conj` and Q̃ᴴ·B the forward chain
    (:func:`~.dist_twostage._papply_q`)."""
    qr = ptranspose(lq, conj=True)
    if not adjoint:
        return punmqr_conj(qr, tmats, b)
    _check_rows("punmlq", qr, b)
    return like(b, _papply_q(qr.mesh, qr.data, tmats, b.data, qr.nb,
                             ceildiv(qr.n, qr.nb), 0, True))
