"""The distributed SVD middle — the counterpart of
``slate_tpu/parallel/dist_svd.py`` (``dist_band_svd``).

The reference runs stages 2 and 3 of ``slate::svd`` on rank 0
(``src/svd.cc:207-372``: the tb2bd chase, the bidiagonal solve, then the
distributed ``unmbr_tb2bd`` / ``unmbr_ge2tb``).  Here, as in the JAX
package, three moves with no O(n²) host array:

1. the checkpointed bidiagonal chase on every rank's copy of the band, in
   sweep chunks (``dist_twostage.chase_chunk_bounds``), a snapshot kept
   at each chunk's start and both reflector logs dropped;
2. the bidiagonal SVD as the Golub–Kahan tridiagonal of order 2n,
   T_GK = tridiag(0; d₁, e₁, d₂, e₂, …), the perfect shuffle of
   [[0, Bᵀ], [B, 0]]: :func:`~.dist_stedc.pstedc` solves it with Q's rows
   spread over the ranks; its eigenvalues pair ±σ and the positive ones'
   vectors carry V (even rows) and U (odd rows), each scaled by 1/√2 —
   :func:`~.dist_stedc.pstedc_rows` deals the rows in pairs, so a rank
   holds the same rows of U and of V;
3. the near-null repair and the CholQR² polish on those rows (the Gram
   matrix one ``psum``), one move from rows to column slabs, and each
   chunk's logs regenerated in reverse and applied to this rank's
   columns of U and V.

Near-zero σ need the repair: stedc may deflate a +σ against its −σ twin
(they differ by ~2σ), returning an orthonormal mix whose u and v halves
are no longer orthonormal.  Those columns move the reconstruction by
≤ σ ≈ n·ε·σ₁, so they are rebuilt from the whole ±cluster: the 2c
near-null GK vectors' odd and even halves span null(Bᴴ) and null(B), and
a pivoted QR of each (host, O(n·c²), scipy) gives orthonormal
replacements.
"""

from __future__ import annotations

import numpy as np
import torch

from .dist_util import _rows_to_cols, _stage
from .mesh import BOTH


def _cholqr2(mesh, x):
    """Two CholQR passes on a row-distributed x (this rank's rows): the
    Gram matrix xᵀx summed over the grid (one psum a pass), its Cholesky
    factor L replicated, x ← x·L⁻ᵀ on the local rows."""
    for _ in range(2):
        g = mesh.psum(torch.matmul(x.mT, x), BOTH)
        low = torch.linalg.cholesky(g)
        x = torch.linalg.solve_triangular(low, x.mT, upper=False).mT
    return x


def dist_band_svd(ab, kd_eff: int, mesh, want_u: bool, want_vt: bool):
    """Distributed stages 2 and 3 from O(n·kd) upper-band storage
    (``ab[c, (c−r)+1]`` = A[r, c]): singular values and vectors with no
    O(n²) host array.  The chase is one ``tb2bd_wavefront`` launch a
    chunk and pass where the ``chase`` site answers ``kernel`` (the
    snapshots on the card while they fit, else on the host), the host
    chase of :mod:`slate_tpu_torch.native` otherwise.

    Returns ``(s, u_cols, v_cols)``: σ descending (host, replicated) and
    this rank's column slabs (``dist_util._col_bounds``) of U and V,
    n rows, fp64, columns the left and right singular vectors; None where
    not asked for."""
    import scipy.linalg as sla

    from .. import native
    from ..linalg import _chase
    from ..linalg.eig import _pack_hh_log, unmtr_hb2st_hh
    from ..linalg.svd import _bd_sweep_counts
    from .dist_stedc import pstedc, pstedc_rows
    from .dist_twostage import chase_chunk_bounds

    n = ab.shape[0]
    dev = mesh.device
    bnds = chase_chunk_bounds(_bd_sweep_counts(n, kd_eff), max(n - 1, 0), n,
                              kd_eff)
    kernel = _chase.backend("tb2bd", n, kd_eff, torch.float64, dev,
                            True) == "kernel"
    snaps = []
    with _stage("stage.dist_svd.chase1", mesh):
        if kernel:
            st = _chase.tb2bd_st_from_ab(ab, kd_eff, dev)
            spill = not _chase.snapshots_fit_device(
                n * (3 * kd_eff + 2) * 8, len(bnds) - 1)
            for s0, s1 in zip(bnds[:-1], bnds[1:]):
                snaps.append(_chase.snapshot_store(st) if spill
                             else st.clone())
                st, _, _ = _chase.tb2bd_device(st, kd_eff, s0, s1,
                                               want_log=False)
            d, e = _chase.tb2bd_d_e(st, kd_eff, n)
            del st
        else:
            # row-major general-band storage st[r, c-r+kd] = A[r, c]
            st = np.zeros((n, 3 * kd_eff + 2), dtype=np.float64)
            for dd in range(min(kd_eff, max(n - 1, 1)) + 1):
                st[:n - dd, dd + kd_eff] = ab[dd:, dd + 1]
            for s0, s1 in zip(bnds[:-1], bnds[1:]):
                snaps.append(st.copy())
                native.tb2bd_hh_banded_range(st, n, kd_eff, s0, s1)
            d = st[:, kd_eff].copy()
            e = st[:n - 1, kd_eff + 1].copy()

    # Golub–Kahan tridiagonal of order 2n: off-diagonals interleave d, e
    egk = np.zeros(2 * n - 1)
    egk[0::2] = d
    egk[1::2] = e
    with _stage("stage.dist_svd.stedc", mesh):
        w_gk, z_rows = pstedc(np.zeros(2 * n), egk, mesh)
    rows = pstedc_rows(2 * n, mesh)            # pairs (2i, 2i + 1)
    uv_rows = rows[0::2] // 2
    # top n eigenvalues descending = σ; GK eigenvalues of a near-singular
    # B straddle 0 by ~n·ε·σ₁: clamp to σ ≥ 0 (LAPACK does the same)
    order = np.argsort(w_gk)[::-1][:n]
    s = np.maximum(w_gk[order], 0.0)
    sqrt2 = np.sqrt(2.0)
    with _stage("stage.dist_svd.polish", mesh):
        zsel = z_rows[:, torch.as_tensor(order.copy(), device=dev)] * sqrt2
        v_loc, u_loc = zsel[0::2], zsel[1::2]
        del zsel
        # near-null repair (host O(n·c²), c the cluster's size)
        tol = 4.0 * n * np.finfo(np.float64).eps * max(abs(s[0]), 1e-300)
        fix_pos = np.nonzero(s <= tol)[0]
        if fix_pos.size:
            cl = np.nonzero(np.abs(w_gk) <= tol)[0]       # both signs
            buf = torch.zeros((2 * n, cl.size), dtype=torch.float64,
                              device=dev)
            buf[torch.as_tensor(rows, device=dev)] = \
                z_rows[:, torch.as_tensor(cl, device=dev)]
            z_cl = mesh.psum(buf, BOTH).cpu().numpy()     # (2n, 2c) host
            c = fix_pos.size
            qu, _, _ = sla.qr(z_cl[1::2, :], mode="economic", pivoting=True)
            qv, _, _ = sla.qr(z_cl[0::2, :], mode="economic", pivoting=True)
            pos = torch.as_tensor(fix_pos, device=dev)
            u_loc[:, pos] = torch.from_numpy(
                np.ascontiguousarray(qu[uv_rows, :c])).to(dev)
            v_loc[:, pos] = torch.from_numpy(
                np.ascontiguousarray(qv[uv_rows, :c])).to(dev)
        del z_rows
        # CholQR² polish: beyond the exactly mixed cluster a σ_j pair mixes
        # by δ_j ≈ ε·σ₁/(2σ_j); re-orthonormalizing moves the
        # reconstruction by δ_j·σ_j ≈ ε·σ₁ a column and restores
        # orthonormality to O(ε) in two passes
        u_loc = _cholqr2(mesh, u_loc) if want_u else u_loc
        v_loc = _cholqr2(mesh, v_loc) if want_vt else v_loc
        u = _rows_to_cols(mesh, u_loc, uv_rows, n, n) if want_u else None
        v = _rows_to_cols(mesh, v_loc, uv_rows, n, n) if want_vt else None
        del u_loc, v_loc

    # pass 2: each chunk's logs regenerated from its snapshot in reverse
    with _stage("stage.dist_svd.chase2", mesh):
        for ci in range(len(snaps) - 1, -1, -1):
            s0, s1 = bnds[ci], bnds[ci + 1]
            snap, snaps[ci] = snaps[ci], None     # free as consumed
            if kernel:
                if isinstance(snap, np.ndarray):
                    snap = _chase.snapshot_restore(snap, dev)
                _, ulog, vlog = _chase.tb2bd_device(snap, kd_eff, s0, s1)
            else:
                ulog, vlog = native.tb2bd_hh_banded_range(snap, n, kd_eff,
                                                          s0, s1)
                counts = _bd_sweep_counts(n, kd_eff, s0, s1)
                packed = []
                for log, want in ((ulog, want_u), (vlog, want_vt)):
                    if want and len(log[2]):
                        log = _pack_hh_log(*log, n, kd_eff, counts=counts)
                        _chase.mark_host_path("tb2bd", log)
                        packed.append(log)
                    else:
                        packed.append(None)
                ulog, vlog = packed
            del snap
            if want_u and ulog is not None and ulog[0].shape[0]:
                u = unmtr_hb2st_hh(*ulog, u, kd_eff)
            if want_vt and vlog is not None and vlog[0].shape[0]:
                v = unmtr_hb2st_hh(*vlog, v, kd_eff)
            del ulog, vlog
    return s, u, v
