"""Distributed band solvers and band multiplies — the counterpart of
``slate_tpu/parallel/dist_band.py`` (reference ``src/pbsv.cc``,
``src/gbsv.cc``, ``src/gbmm.cc``, ``src/hbmm.cc``, ``src/tbsm.cc``).

A band factorization with bandwidth ≤ nb is a serial chain over block
columns, O(n·nb²) flops on O(n·nb) data, so the JAX package's design is
kept: ONE collective (a ``psum`` of each rank's own tiles, placed)
replicates the band as an (ntp, 3, nb, nb) stack of super, diagonal and
sub tiles, and every rank runs the chain on its own device — redundantly,
which at these flops costs less than a collective a step.  The factor
stays on the device; the solves replicate the right-hand sides
(:func:`~.dist.undistribute`), sweep the block-bidiagonal chains, and
hand the solution back block-cyclic.  The chains' products go through
:func:`slate_tpu_torch.ops.blocks.matmul` (the ``matmul`` kernel for
128-aligned fp32 on the card); a product whose band operand lies wholly
in the padding is structurally zero and is skipped, so at n = nt·nb each
chain launches nt − 1 products.  The panel factorizations are stock
calls, as ``lax.linalg`` is in the JAX package (``cholesky_ex``,
``solve_triangular``, ``lu_factor_ex``).

The band multiplies and the triangular band solve mask the band on each
rank's shard (nothing communicated) and ride ``pgemm`` / ``ptrsm``;
``ptbsm``'s pivots permute B's rows on the device with its block-cyclic
layout kept (:func:`~.dist_lu._permute_rows`).  Timers (metrics on):
``stage.pband.factor``, ``stage.pband.solve``.
"""

from __future__ import annotations

import torch

from ..enums import Uplo
from ..grid import ceildiv
from ..ops import blocks
from ..ops.blocks import matmul as _mm
from .dist import DistMatrix, distribute, undistribute
from .dist_aux import index_maps
from .dist_util import _stage
from .mesh import BOTH, mesh_grid_shape


def _band_tile_stack(a: DistMatrix):
    """Replicated (ntp, 3, nb, nb) stack of the tiles (j−1, j), (j, j) and
    (j+1, j) of every column block j — any band with max(kl, ku) ≤ nb —
    one psum of each rank's own tiles placed (O(n·nb) data), with the
    identity on the padded diagonal so the factorizations stay well
    posed (``slate_tpu/parallel/dist_band.py:31-61``, ``:115-130``)."""
    if a.row_nb != a.nb:
        raise ValueError("the band solvers need square tiles (mb == nb)")
    mesh = a.mesh
    p, q = mesh_grid_shape(mesh)
    nb, mtp, ntp = a.nb, a.mtp, a.ntp
    loc = a.data
    out = torch.zeros((ntp, 3, nb, nb), dtype=a.dtype, device=a.device)
    for jl in range(loc.shape[1] // nb):
        jg = jl * q + mesh.c
        for s, off in enumerate((-1, 0, 1)):
            ig = jg + off
            if 0 <= ig < mtp and ig % p == mesh.r:
                il = ig // p
                out[jg, s] = loc[il * nb:(il + 1) * nb, jl * nb:(jl + 1) * nb]
    mesh.psum(out, BOTH)
    for k in range(a.n // nb, ntp):
        i0 = max(a.n - k * nb, 0)
        out[k, 1].diagonal()[i0:] += 1
    return out


def _check_band(width: int, nb: int) -> None:
    if width > nb:
        raise ValueError(f"band width {width} exceeds tile size {nb}; "
                         "re-tile with a larger nb")


def ppbtrf(a: DistMatrix, kd: int, lower: bool = True):
    """Distributed SPD band Cholesky — reference ``slate::pbtrf``
    (``src/pbtrf.cc``).  Returns ``(l_diag, l_sub)``, replicated (ntp, nb,
    nb) tile stacks on the mesh's device: L's diagonal blocks and its
    sub-diagonal band blocks.  kd ≤ nb; A is stored whole (the diagonal
    blocks are symmetrized, as ``symmetrize_input`` does there), and
    ``lower=False`` takes the sub tiles from the super tiles' adjoints."""
    _check_band(kd, a.nb)
    nb = a.nb
    nt = ceildiv(a.n, nb)
    with _stage("stage.pband.factor", a.mesh):
        tiles = _band_tile_stack(a)
        ntp = tiles.shape[0]
        if not lower:
            # A[k+1, k] = A[k, k+1]ᴴ: the super tile of column k + 1
            tiles[:-1, 2] = tiles[1:, 0].mH
            tiles[-1, 2] = 0
        l_diag = torch.empty((ntp, nb, nb), dtype=a.dtype, device=a.device)
        l_sub = torch.zeros_like(l_diag)
        dk = tiles[0, 1]
        for k in range(ntp):
            lkk = blocks.potrf_rec(0.5 * (dk + dk.mH), nb, nan_on_fail=True)
            l_diag[k] = lkk
            if k + 1 == ntp:
                break
            dk = tiles[k + 1, 1]
            if k + 1 < nt:     # else A[k+1, k] lies in the padding
                lsub = torch.linalg.solve_triangular(
                    lkk.mH, tiles[k, 2], upper=True, left=False)
                l_sub[k] = lsub
                dk = dk - _mm(lsub, lsub.mH)
    return l_diag, l_sub


def _rhs(a: DistMatrix, b: DistMatrix, extra: int = 0):
    """B's row count, and B replicated and padded to the band's ntp·nb
    (+ ``extra``) rows."""
    bg = undistribute(b)
    bp = torch.zeros((a.ntp * a.nb + extra, bg.shape[1]), dtype=bg.dtype,
                     device=bg.device)
    bp[:bg.shape[0]] = bg
    return bg.shape[0], bp


def _as_dist(x, b: DistMatrix):
    p, q = b.grid_shape
    return distribute(x.to(b.dtype), b.mesh, b.nb, row_mult=q)


def ppbsv(a: DistMatrix, kd: int, b: DistMatrix,
          lower: bool = True) -> DistMatrix:
    """Distributed SPD band solve — reference ``slate::pbsv``
    (``src/pbsv.cc``): :func:`ppbtrf`, then the forward and backward
    block-bidiagonal sweeps over the replicated right-hand sides on every
    rank.  Returns X block-cyclic like B."""
    l_diag, l_sub = ppbtrf(a, kd, lower)
    nb = a.nb
    nt = ceildiv(a.n, nb)
    with _stage("stage.pband.solve", a.mesh):
        m, bp = _rhs(a, b)
        y = torch.empty((nt * nb, bp.shape[1]), dtype=bp.dtype,
                        device=bp.device)
        for k in range(nt):
            bk = bp[k * nb:(k + 1) * nb]
            if k:
                bk = bk - _mm(l_sub[k - 1], y[(k - 1) * nb:k * nb])
            y[k * nb:(k + 1) * nb] = torch.linalg.solve_triangular(
                l_diag[k], bk, upper=False)
        x = torch.empty_like(y)
        for k in range(nt - 1, -1, -1):
            yk = y[k * nb:(k + 1) * nb]
            if k + 1 < nt:
                yk = yk - _mm(l_sub[k].mH, x[(k + 1) * nb:(k + 2) * nb])
            x[k * nb:(k + 1) * nb] = torch.linalg.solve_triangular(
                l_diag[k].mH, yk, upper=True)
    return _as_dist(x[:m], b)


def _lu_perm(lu, piv):
    """The row order ``perm`` of ``lu_factor``'s pivots, A[perm] = L·U (the
    permutation ``lax.linalg.lu`` returns), on the device."""
    p = torch.lu_unpack(lu, piv, unpack_data=False)[0]
    return (p.real if p.is_complex() else p).argmax(dim=0)


def pgbtrf(a: DistMatrix, kl: int, ku: int):
    """Distributed general band LU with partial pivoting — reference
    ``slate::gbtrf`` (``src/gbtrf.cc``).  kl, ku ≤ nb.  A sliding
    (2nb × 3nb) dense window steps down the replicated band (pivoting
    stays within the next kl ≤ nb rows; U's fill reaches kl + ku ≤ 2nb).
    Returns replicated stacks ``(lu_pan, u12, piv)``: a block column's
    packed (2nb, nb) panel (unit L below, U_kk above), its (nb, 2nb) U
    fill rows and its (2nb,) row order over the window rows."""
    nb = a.nb
    _check_band(max(kl, ku), nb)
    nt = ceildiv(a.n, nb)
    with _stage("stage.pband.factor", a.mesh):
        tiles = _band_tile_stack(a)
        ntp = tiles.shape[0]
        dt, dev = tiles.dtype, tiles.device

        def blk(r, c_off):
            # A[r, r + c_off] (slot 1 − c_off of column tile r + c_off)
            j = r + c_off
            if 0 <= j < ntp:
                return tiles[j, 1 - c_off]
            return torch.zeros((nb, nb), dtype=dt, device=dev)

        w = torch.zeros((2 * nb, 3 * nb), dtype=dt, device=dev)
        for i in range(min(2, ntp)):
            for j in range(min(3, ntp)):
                if abs(i - j) <= 1:
                    w[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb] = \
                        tiles[j, 1 + (i - j)]
        lu_pan = torch.empty((ntp, 2 * nb, nb), dtype=dt, device=dev)
        u12 = torch.empty((ntp, nb, 2 * nb), dtype=dt, device=dev)
        piv = torch.empty((ntp, 2 * nb), dtype=torch.int64, device=dev)
        for k in range(ntp):
            lu, pv, _ = torch.linalg.lu_factor_ex(w[:, :nb])
            perm = _lu_perm(lu, pv)
            wp = w.index_select(0, perm)
            u = torch.linalg.solve_triangular(lu[:nb], wp[:nb, nb:],
                                              upper=False, unitriangular=True)
            w22 = wp[nb:, nb:]
            if k + 1 < nt:     # else L's lower block lies in the padding
                w22 = w22 - _mm(lu[nb:], u)
            lu_pan[k], u12[k], piv[k] = lu, u, perm
            new_row = torch.cat([blk(k + 2, -1), blk(k + 2, 0),
                                 blk(k + 2, 1)], dim=1)
            w = torch.cat([torch.cat([w22, torch.zeros(
                (nb, nb), dtype=dt, device=dev)], dim=1), new_row])
    return lu_pan, u12, piv


def pgbsv(a: DistMatrix, kl: int, ku: int, b: DistMatrix) -> DistMatrix:
    """Distributed general band solve — reference ``slate::gbsv``
    (``src/gbsv.cc``): :func:`pgbtrf`, the pivoted forward sweep over
    (2nb)-row windows of the replicated right-hand sides, then the banded
    back substitution.  Returns X block-cyclic like B."""
    nb = a.nb
    lu_pan, u12, piv = pgbtrf(a, kl, ku)
    nt = ceildiv(a.n, nb)
    with _stage("stage.pband.solve", a.mesh):
        m, bp = _rhs(a, b, extra=nb)
        nrhs = bp.shape[1]
        y = torch.empty((nt * nb, nrhs), dtype=bp.dtype, device=bp.device)
        carry = bp[:2 * nb]
        for k in range(nt):
            bw = carry.index_select(0, piv[k])
            yk = torch.linalg.solve_triangular(lu_pan[k, :nb], bw[:nb],
                                               upper=False,
                                               unitriangular=True)
            rem = bw[nb:]
            if k + 1 < nt:
                rem = rem - _mm(lu_pan[k, nb:], yk)
            y[k * nb:(k + 1) * nb] = yk
            carry = torch.cat([rem, bp[(k + 2) * nb:(k + 3) * nb]])
        x = torch.empty_like(y)
        for k in range(nt - 1, -1, -1):
            rhs = y[k * nb:(k + 1) * nb]
            if k + 1 < nt:
                nxt = x[(k + 1) * nb:(k + 3) * nb]
                if nxt.shape[0] < 2 * nb:      # x past nt·nb is zero
                    nxt = torch.cat([nxt, torch.zeros(
                        (2 * nb - nxt.shape[0], nrhs), dtype=x.dtype,
                        device=x.device)])
                rhs = rhs - _mm(u12[k], nxt)
            x[k * nb:(k + 1) * nb] = torch.linalg.solve_triangular(
                lu_pan[k, :nb], rhs, upper=True)
    return _as_dist(x[:m], b)


# ---------------------------------------------------------------------------
# Band multiplies and the triangular band solve
# ---------------------------------------------------------------------------

def _pband_mask(a: DistMatrix, kl: int, ku: int) -> DistMatrix:
    """Zero everything outside the (kl, ku) band on this rank's shard
    (global indices from the block-cyclic maps; nothing communicated)."""
    from .dist import like

    grows, gcols = index_maps(a)
    d = gcols[None, :] - grows[:, None]
    keep = (d <= ku) & (d >= -kl)
    return like(a, torch.where(keep, a.data,
                               torch.zeros((), dtype=a.dtype,
                                           device=a.device)))


def pgbmm(alpha, a: DistMatrix, kl: int, ku: int, b: DistMatrix,
          beta=0.0, c: DistMatrix = None) -> DistMatrix:
    """C ← α·A·B + β·C with A banded — reference ``slate::gbmm``
    (``src/gbmm.cc``): the band masked on each shard, then the SUMMA
    ``pgemm`` (a 2-D block-cyclic layout spreads every row over the
    ranks, so no whole tile is skipped: the mask is the guarantee)."""
    from .dist_blas3 import pgemm

    return pgemm(alpha, _pband_mask(a, kl, ku), b, beta, c)


def phbmm(alpha, a: DistMatrix, kd: int, b: DistMatrix, beta=0.0,
          c: DistMatrix = None, lower: bool = True) -> DistMatrix:
    """C ← α·A·B + β·C with A Hermitian banded, its ``lower`` (else upper)
    triangle stored — reference ``slate::hbmm`` (``src/hbmm.cc``): the
    stored triangle's band masked and mirrored
    (:func:`~.dist_util.phermitize`), then ``pgemm``."""
    from .dist_blas3 import pgemm
    from .dist_util import phermitize

    masked = _pband_mask(a, kd if lower else 0, 0 if lower else kd)
    full = phermitize(masked, Uplo.Lower if lower else Uplo.Upper)
    return pgemm(alpha, full, b, beta, c)


def ptbsm(side, uplo, op, diag, a: DistMatrix, kd: int, b: DistMatrix,
          pivots=None) -> DistMatrix:
    """Triangular band solve — reference ``slate::tbsm``
    (``src/tbsm.cc``): the triangle's band masked on each shard, then the
    distributed ``ptrsm`` sweep (the band's zero blocks multiply through
    as zeros).  ``pivots``, a row order of B's first rows, permutes B
    before the solve, as the reference applies a band LU's pivots — on
    the device, B's block-cyclic layout kept."""
    from .dist import like
    from .dist_aux import ptrsm
    from .dist_lu import _permute_rows

    lower = uplo is Uplo.Lower
    masked = _pband_mask(a, kd if lower else 0, 0 if lower else kd)
    bb = b
    if pivots is not None:
        pv = torch.as_tensor(pivots, device=b.device).long()
        rows = b.mtp * b.row_nb
        full = torch.cat([pv, torch.arange(pv.shape[0], rows,
                                           device=b.device)])
        bb = like(b, _permute_rows(b.mesh, b.data, full, b.row_nb))
    return ptrsm(side, uplo, op, diag, masked, bb)
