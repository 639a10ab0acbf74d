"""Distributed two-stage eigensolver and SVD over the ('p', 'q') grid —
the counterpart of ``slate_tpu/parallel/dist_twostage.py``:

* ``phe2hb`` — Hermitian dense → band of lower bandwidth nb (reference
  ``slate::he2hb``, ``src/he2hb.cc:53-177``): per panel a Householder QR
  of the block column below the band and the two-sided trailing update
  B ← B − V·Wᴴ − W·Vᴴ;
* ``pge2tb`` — general dense → upper triangular band (reference
  ``slate::ge2tb``): QR panels on block columns, LQ panels on block rows;
* their back-transforms ``punmtr_he2hb``, ``punmbr_ge2tb_q`` and
  ``punmbr_ge2tb_p``, the band gathers ``band_tiles_to_dense`` /
  ``band_tiles_to_banded``, and the drivers ``pheev`` and ``psvd``.

The JAX package's design, step for step, in the port's idiom: the panel
arrives replicated through one fused broadcast
(:func:`~.dist_util.bcast_block_col` / ``bcast_block_row``), every rank
factors it redundantly (``linalg.qr._panel_geqrf`` + ``larft_rec``),
the packed factor is written in place (R in the first sub-band tile, the
V's below it, as the reference zeroes them), the T blocks stay
replicated, and the trailing update is local products on the step's
window of local rows and columns — the JAX package's masks on the whole
shard, which here are Python-int ranges.  The band comes back as a
replicated (nt, 2, nb, nb) tile stack (O(n·nb) data, the reference's
``he2hbGather``), assembled on the host into LAPACK band storage.

Stage 2 runs either replicated on each rank's device (``_band_eig_ab`` /
``_band_svd_ab``, below n = 2048) or through the distributed middle
(:func:`dist_band_eig`, :mod:`.dist_svd`): the checkpointed chase on
every rank's copy of the band, :func:`~.dist_stedc.pstedc` with Q's rows
spread over the ranks, one move of Q from rows to columns, and the
regenerated reflector logs applied to each rank's columns.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..grid import ceildiv
from ..linalg.eig import _numpy as _host
from ..linalg.qr import _panel_geqrf, _unit_lower, larft_rec
from ..ops.blocks import matmul as _mm
from .dist import DistMatrix, distribute, like, local_indices, padded_tiles
from .dist_util import (_col_bounds, _move, _rows_to_cols, _stage,
                        bcast_block_col, bcast_block_row, local_grows)
from .mesh import AXIS_P, AXIS_Q, BOTH, mesh_grid_shape


def _ss(idx: np.ndarray, g: int) -> int:
    """First position of ``idx`` (ascending) at or past global index g."""
    return int(np.searchsorted(idx, g))


# ---------------------------------------------------------------------------
# phe2hb: Hermitian dense → band
# ---------------------------------------------------------------------------

def _phe2hb(mesh, a_loc, nb: int, nt: int, n_true: int):
    """The step loop on this rank's shard, in place; returns the T blocks
    (max(nt − 1, 1), nb, nb), replicated."""
    p, q = mesh_grid_shape(mesh)
    r, c = mesh.r, mesh.c
    ml, nl = a_loc.shape[0] // nb, a_loc.shape[1] // nb
    M = p * ml * nb
    dt, dev = a_loc.dtype, a_loc.device
    grows = local_grows(ml, nb, p, r)
    gcols = local_grows(nl, nb, q, c)
    tmats = torch.zeros((max(nt - 1, 1), nb, nb), dtype=dt, device=dev)
    for k in range(nt - 1):
        r0 = (k + 1) * nb
        own = k % q == c
        colk = a_loc[:, (k // q) * nb:(k // q + 1) * nb]
        # ---- block column k on every rank (src/he2hb.cc:86-101); rows
        # from r0 on, the rows past n zero
        panel = bcast_block_col(mesh, colk, grows, own, M)
        valid = n_true - r0
        masked = torch.zeros_like(panel)
        masked[:valid] = panel[r0:n_true]
        packed, taus = _panel_geqrf(masked)
        v_full = _unit_lower(packed, nb)
        tmat = larft_rec(v_full, taus)
        # ---- the packed factor into my rows >= r0 of column block k
        lo = _ss(grows, r0)
        if own and lo < len(grows):
            colk[lo:] = packed[torch.as_tensor(grows[lo:] - r0, device=dev)]
        # ---- two-sided update of rows and columns in [r0, n):
        # Y = B·(V·T); S = Tᴴ·Vᴴ·Y; W = Y − ½·V·S; B ← B − V·Wᴴ − W·Vᴴ
        # (src/he2hb.cc:103-177), Y assembled with one psum
        r_lo, r_hi = lo, _ss(grows, n_true)
        c_lo, c_hi = _ss(gcols, r0), _ss(gcols, n_true)
        rrel = torch.as_tensor(grows[r_lo:r_hi] - r0, device=dev)
        crel = torch.as_tensor(gcols[c_lo:c_hi] - r0, device=dev)
        vt = _mm(v_full, tmat)
        ybuf = torch.zeros((M, nb), dtype=dt, device=dev)
        if r_hi > r_lo and c_hi > c_lo:
            ybuf[torch.as_tensor(grows[r_lo:r_hi], device=dev)] = _mm(
                a_loc[r_lo:r_hi, c_lo:c_hi], vt.index_select(0, crel))
        y = mesh.psum(ybuf, BOTH)[r0:n_true]
        v = v_full[:valid]
        s = _mm(tmat.mH, _mm(v.mH, y))
        w = y - 0.5 * _mm(v, s)
        if r_hi > r_lo and c_hi > c_lo:
            v_r, w_r = v.index_select(0, rrel), w.index_select(0, rrel)
            v_c, w_c = v.index_select(0, crel), w.index_select(0, crel)
            a_loc[r_lo:r_hi, c_lo:c_hi] -= (_mm(v_r, w_c.mH)
                                            + _mm(w_r, v_c.mH))
        tmats[k] = tmat
    return tmats


def _band_tiles(mesh, a_loc, nb: int, mtp: int, ntp: int, lower: bool):
    """The band's tile pairs as a replicated (ntiles, 2, nb, nb) stack —
    (j, j) and (j+1, j) for ``lower`` (he2hb), (i, i) and (i, i+1) else
    (ge2tb) — one psum of each rank's own tiles placed: O(n·nb) data, the
    reference's ``he2hbGather`` (``src/heev.cc:111``)."""
    p, q = mesh_grid_shape(mesh)
    r, c = mesh.r, mesh.c
    ml, nl = a_loc.shape[0] // nb, a_loc.shape[1] // nb

    def tile(il, jl):
        return a_loc[il * nb:(il + 1) * nb, jl * nb:(jl + 1) * nb]

    out = torch.zeros((ntp if lower else mtp, 2, nb, nb), dtype=a_loc.dtype,
                      device=a_loc.device)
    if lower:
        for jl in range(nl):
            jg = jl * q + c
            for s, ig in ((0, jg), (1, jg + 1)):
                if ig % p == r and ig < mtp:
                    out[jg, s] = tile(ig // p, jl)
    else:
        for il in range(ml):
            ig = il * p + r
            for s, jg in ((0, ig), (1, ig + 1)):
                if jg % q == c and jg < ntp:
                    out[ig, s] = tile(il, jg // q)
    return mesh.psum(out, BOTH)


def phe2hb(a: DistMatrix):
    """Distributed Hermitian → band reduction (reference ``slate::he2hb``,
    ``src/he2hb.cc:53-177``).

    Returns ``(factor, tmats, band_tiles)``: ``factor`` holds R/V packed
    in the sub-band block columns, ``tmats`` the replicated compact-WY T
    blocks (one per panel), and ``band_tiles`` the replicated (nt, 2, nb,
    nb) diagonal/sub-diagonal tile pairs (:func:`band_tiles_to_dense`,
    :func:`band_tiles_to_banded` assemble the stage-2 operand)."""
    if a.m != a.n:
        raise ValueError(f"phe2hb requires square, got {a.m}x{a.n}")
    if a.mtp != a.ntp:
        raise ValueError("phe2hb needs square padded storage "
                         "(distribute with row_mult=q, col_mult=p)")
    nt = ceildiv(a.n, a.nb)
    fac = a.data.clone()
    tmats = _phe2hb(a.mesh, fac, a.nb, nt, a.n)
    tiles = _band_tiles(a.mesh, fac, a.nb, a.mtp, a.ntp, True)
    return like(a, fac), tmats, tiles


def band_tiles_to_dense(tiles, n: int, nb: int, lower: bool = True):
    """Assemble the (nt, 2, nb, nb) replicated tile stack into a dense
    host band matrix (n×n, numpy): Hermitian with lower bandwidth nb when
    ``lower`` (the sub-diagonal tile's strict lower part holds packed V's
    and is masked off), general upper-banded otherwise."""
    tiles = _host(tiles)
    nt = ceildiv(n, nb)
    out = np.zeros((n, n), dtype=tiles.dtype)
    for k in range(nt):
        j0 = k * nb
        w = min(nb, n - j0)
        d = tiles[k, 0][:w, :w]
        if lower:
            out[j0:j0 + w, j0:j0 + w] = np.tril(d)
            r0 = j0 + nb
            if r0 < n:
                h = min(nb, n - r0)
                out[r0:r0 + h, j0:j0 + w] = np.triu(tiles[k, 1][:h, :w])
        else:
            out[j0:j0 + w, j0:j0 + w] = np.triu(d)
            c0 = j0 + nb
            if c0 < n:
                h = min(nb, n - c0)
                out[j0:j0 + w, c0:c0 + h] = np.tril(tiles[k, 1][:w, :h])
    if lower:
        out = out + out.conj().T - np.diag(np.diagonal(out))
    return out


def band_tiles_to_banded(tiles, n: int, nb: int, lower: bool = True):
    """Assemble the replicated tile stack straight into O(n·kd) LAPACK
    band storage on the host, promoted to fp64 / complex128 (so an fp32
    input's stage 2 runs in fp64): the operand of
    :func:`slate_tpu_torch.linalg.eig._band_eig_ab` (lower Hermitian,
    ``ab[j, d]`` = A[j+d, j], (n, kd+2)) or
    :func:`slate_tpu_torch.linalg.svd._band_svd_ab` (upper,
    ``ab[c, (c−r)+1]`` = A[r, c], (n, kd+3)).  No dense n×n host matrix
    is built."""
    tiles = _host(tiles)
    dt = (np.complex128 if np.issubdtype(tiles.dtype, np.complexfloating)
          else np.float64)
    kd_eff = min(nb, n - 1)
    nt = ceildiv(n, nb)
    ab = np.zeros((n, kd_eff + (2 if lower else 3)), dtype=dt, order="C")
    for k in range(nt):
        j0 = k * nb
        w = min(nb, n - j0)
        d_t = tiles[k, 0][:w, :w]
        s_t = tiles[k, 1]
        if lower:
            # diag tile: sub-diagonals dd of tril(d) → ab[j0+b, dd]
            for dd in range(min(w, kd_eff + 1)):
                ab[j0:j0 + w - dd, dd] = np.diagonal(d_t, -dd)
            # sub tile triu part: A[(k+1)nb+a, j0+b], a <= b
            r0 = j0 + nb
            if r0 < n:
                h = min(nb, n - r0)
                for dd2 in range(w):
                    dlen = min(w - dd2, h)
                    if dlen <= 0 or nb - dd2 > kd_eff:
                        continue
                    ab[j0 + dd2:j0 + dd2 + dlen, nb - dd2] = \
                        np.diagonal(s_t[:h, :w], dd2)[:dlen]
        else:
            for dd in range(min(w, kd_eff + 1)):
                ab[j0 + dd:j0 + w, dd + 1] = np.diagonal(d_t, dd)
            c0 = j0 + nb
            if c0 < n:
                h = min(nb, n - c0)
                for dd2 in range(w):
                    dlen = min(w - dd2, h)
                    if dlen <= 0 or nb - dd2 > kd_eff + 1:
                        continue
                    ab[c0:c0 + dlen, nb - dd2 + 1] = \
                        np.diagonal(s_t[:w, :h], -dd2)[:dlen]
    return ab


def _papply_q(mesh, fac_loc, tmats, z_loc, nb: int, npanels: int,
              shift_blocks: int, forward: bool):
    """Z ← Q·Z (``forward``: panels last to first with T) or Qᴴ·Z (first
    to last with Tᴴ) for the packed column panels of ``fac_loc`` (this
    rank's shard) and the replicated T blocks ``tmats``, on a
    row-distributed Z; returns the new local block of Z.  Panel k's V
    starts ``shift_blocks`` blocks below the diagonal (1 for he2hb, 0
    for ge2tb and QR).  A step: the factor's block column k along 'q'
    (one ``psum``), Vᴴ·Z along 'p' (one ``psum``), the local rank-nb
    update (``slate_tpu/parallel/dist_twostage.py:315-352``; reference
    ``unmtr_he2hb`` / ``unmbr_ge2tb`` fan-out)."""
    p, q = mesh_grid_shape(mesh)
    r, c = mesh.r, mesh.c
    ml = fac_loc.shape[0] // nb
    dt, dev = fac_loc.dtype, fac_loc.device
    grows = local_grows(ml, nb, p, r)
    cc = torch.arange(nb, device=dev)[None, :]
    one = torch.ones((), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    z_loc = z_loc.clone()
    for i in range(npanels):
        k = npanels - 1 - i if forward else i
        colk = torch.zeros((ml * nb, nb), dtype=dt, device=dev)
        if k % q == c:
            colk.copy_(fac_loc[:, (k // q) * nb:(k // q + 1) * nb])
        mesh.psum(colk, AXIS_Q)
        relc = torch.as_tensor(grows - (k + shift_blocks) * nb,
                               device=dev)[:, None]
        v_loc = torch.where(relc > cc, colk,
                            torch.where(relc == cc, one, zero))
        v_loc = v_loc * (relc >= 0).to(dt)
        tmat = tmats[k]
        tt = tmat if forward else tmat.mH
        w = mesh.psum(_mm(v_loc.mH, z_loc), AXIS_P)
        z_loc -= _mm(v_loc, _mm(tt, w))
    return z_loc


def _check_z(name: str, fac: DistMatrix, z: DistMatrix, mtp: int) -> None:
    if z.nb != fac.nb or z.row_nb != fac.nb:
        raise ValueError(f"{name}: Z tile size must match the factor")
    if z.mtp != mtp:
        raise ValueError(f"{name}: Z row padding/tile size must match the "
                         "factor")
    if z.mesh is not fac.mesh:
        raise ValueError(f"{name}: operands must live on the same mesh")


def punmtr_he2hb(fac: DistMatrix, tmats, z: DistMatrix,
                 forward: bool = True) -> DistMatrix:
    """Z ← Q₁·Z (forward) or Q₁ᴴ·Z from a :func:`phe2hb` factor —
    reference ``slate::unmtr_he2hb``."""
    _check_z("punmtr_he2hb", fac, z, fac.mtp)
    npanels = max(ceildiv(fac.n, fac.nb) - 1, 0)
    if npanels == 0:
        return z
    return like(z, _papply_q(fac.mesh, fac.data, tmats, z.data, fac.nb,
                             npanels, 1, forward))


# ---------------------------------------------------------------------------
# pge2tb: general dense → upper triangular band
# ---------------------------------------------------------------------------

def _pge2tb(mesh, a_loc, nb: int, nt: int, m_true: int, n_true: int):
    """The step loop on this rank's shard, in place; returns the QR and
    LQ panels' T blocks (nt, nb, nb) each, replicated."""
    p, q = mesh_grid_shape(mesh)
    r, c = mesh.r, mesh.c
    ml, nl = a_loc.shape[0] // nb, a_loc.shape[1] // nb
    M, N = p * ml * nb, q * nl * nb
    dt, dev = a_loc.dtype, a_loc.device
    grows = local_grows(ml, nb, p, r)
    gcols = local_grows(nl, nb, q, c)
    qtmats = torch.zeros((nt, nb, nb), dtype=dt, device=dev)
    ptmats = torch.zeros((nt, nb, nb), dtype=dt, device=dev)

    def t(x):
        return torch.as_tensor(x, device=dev)

    for k in range(nt):
        j0, c0 = k * nb, (k + 1) * nb
        # ======== QR panel: block column k, rows >= j0 ========
        own = k % q == c
        colk = a_loc[:, (k // q) * nb:(k // q + 1) * nb]
        panel = bcast_block_col(mesh, colk, grows, own, M)
        masked = torch.zeros_like(panel)
        masked[:m_true - j0] = panel[j0:m_true]
        packed, taus = _panel_geqrf(masked)
        vq = _unit_lower(packed, nb)
        tq = larft_rec(vq, taus)
        lo = _ss(grows, j0)
        if own and lo < len(grows):
            colk[lo:] = packed[t(grows[lo:] - j0)]
        # left-apply Qᴴ to rows [j0, m), columns [c0, n): Vᴴ·C along 'p'
        r_lo, r_hi = lo, _ss(grows, m_true)
        c_lo, c_hi = _ss(gcols, c0), _ss(gcols, n_true)
        if c_hi > c_lo:                     # alike along 'p' (same c)
            v_rows = vq.index_select(0, t(grows[r_lo:r_hi] - j0))
            wq = mesh.psum(_mm(v_rows.mH, a_loc[r_lo:r_hi, c_lo:c_hi]),
                           AXIS_P)
            a_loc[r_lo:r_hi, c_lo:c_hi] -= _mm(v_rows, _mm(tq.mH, wq))
        qtmats[k] = tq
        # ======== LQ panel: block row k, columns >= c0 ========
        own_r = k % p == r
        rowk = a_loc[(k // p) * nb:(k // p + 1) * nb]
        rowg = bcast_block_row(mesh, rowk, gcols, own_r, N)
        masked = torch.zeros((N, nb), dtype=dt, device=dev)
        if n_true > c0:
            masked[:n_true - c0] = rowg[:, c0:n_true].mH
        packed, taus = _panel_geqrf(masked)
        vp = _unit_lower(packed, nb)
        tp = larft_rec(vp, taus)
        if own_r and c_lo < len(gcols):
            rowk[:, c_lo:] = packed[t(gcols[c_lo:] - c0)].mH
        # right-apply P̂ to rows [c0, m), columns [c0, n): C ← C −
        # (C·V)·T·Vᴴ, C·V along 'q'
        r_lo2, r_hi2 = _ss(grows, c0), _ss(grows, m_true)
        if r_hi2 > r_lo2:                   # alike along 'q' (same r)
            vp_cols = vp.index_select(0, t(gcols[c_lo:c_hi] - c0))
            zc = mesh.psum(_mm(a_loc[r_lo2:r_hi2, c_lo:c_hi], vp_cols),
                           AXIS_Q)
            a_loc[r_lo2:r_hi2, c_lo:c_hi] -= _mm(_mm(zc, tp), vp_cols.mH)
        ptmats[k] = tp
    return qtmats, ptmats


def pge2tb(a: DistMatrix):
    """Distributed general → upper-triangular-band reduction (reference
    ``slate::ge2tb``, ``src/ge2tb.cc``).  Requires m ≥ n.

    Returns ``(factor, qtmats, ptmats, band_tiles)`` with Q's V packed
    below the diagonal of each block column, P's ct(V) packed right of
    the first super-diagonal block of each block row, and the band tile
    pairs replicated."""
    if a.m < a.n:
        raise ValueError("pge2tb requires m >= n")
    nt = ceildiv(a.n, a.nb)
    if a.mtp < nt:
        raise ValueError("padded grid too small for the panel count")
    fac = a.data.clone()
    qtmats, ptmats = _pge2tb(a.mesh, fac, a.nb, nt, a.m, a.n)
    tiles = _band_tiles(a.mesh, fac, a.nb, a.mtp, a.ntp, False)
    return like(a, fac), qtmats, ptmats, tiles


def punmbr_ge2tb_q(fac: DistMatrix, qtmats, z: DistMatrix,
                   forward: bool = True) -> DistMatrix:
    """Z ← Q₁·Z (forward) or Q₁ᴴ·Z from a :func:`pge2tb` factor —
    reference ``slate::unmbr_ge2tb`` (U side)."""
    _check_z("punmbr_ge2tb_q", fac, z, fac.mtp)
    return like(z, _papply_q(fac.mesh, fac.data, qtmats, z.data, fac.nb,
                             ceildiv(fac.n, fac.nb), 0, forward))


def _papply_p(mesh, fac_loc, tmats, z_loc, nb: int, npanels: int,
              forward: bool):
    """Apply the LQ-panel chain P₁ (packed as ct(V) in the factor's block
    rows) to a row-distributed Z whose rows live in A's column space: per
    panel the factor's block row k replicated (one broadcast), Vᴴ·Z
    along 'p' (one ``psum``), the local rank-nb update
    (``slate_tpu/parallel/dist_twostage.py:514-558``)."""
    p, q = mesh_grid_shape(mesh)
    r, c = mesh.r, mesh.c
    nl = fac_loc.shape[1] // nb
    N = q * nl * nb
    dt, dev = fac_loc.dtype, fac_loc.device
    gcols = local_grows(nl, nb, q, c)
    grows = local_grows(z_loc.shape[0] // nb, nb, p, r)
    g = torch.as_tensor(np.clip(grows, 0, N - 1), device=dev)
    cc = torch.arange(nb, device=dev)[None, :]
    one = torch.ones((), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    z_loc = z_loc.clone()
    for i in range(npanels):
        k = npanels - 1 - i if forward else i
        rowk = fac_loc[(k // p) * nb:(k // p + 1) * nb]
        packed = bcast_block_row(mesh, rowk, gcols, k % p == r, N).mH
        relc = torch.as_tensor(grows - (k + 1) * nb, device=dev)[:, None]
        v_loc = torch.where(relc > cc, packed.index_select(0, g),
                            torch.where(relc == cc, one, zero))
        v_loc = v_loc * (relc >= 0).to(dt)
        tt = tmats[k] if forward else tmats[k].mH
        w = mesh.psum(_mm(v_loc.mH, z_loc), AXIS_P)
        z_loc -= _mm(v_loc, _mm(tt, w))
    return z_loc


def punmbr_ge2tb_p(fac: DistMatrix, ptmats, z: DistMatrix,
                   forward: bool = True) -> DistMatrix:
    """Z ← P₁·Z (forward) or P₁ᴴ·Z from a :func:`pge2tb` factor, Z's rows
    in A's column space — reference ``slate::unmbr_ge2tb`` (V side)."""
    if z.nb != fac.nb or z.row_nb != fac.nb:
        raise ValueError("Z tile size must match the factor")
    if z.mtp != fac.ntp:
        raise ValueError("Z rows live in A's column space: z.mtp must "
                         "equal the factor's ntp")
    return like(z, _papply_p(fac.mesh, fac.data, ptmats, z.data, fac.nb,
                             ceildiv(fac.n, fac.nb), forward))


# ---------------------------------------------------------------------------
# Layout moves of the distributed middle
# ---------------------------------------------------------------------------

def _distribute_on_mesh(q_cols, n: int, mesh, nb: int, rows=None):
    """The block-cyclic DistMatrix (padded as ``distribute(..., row_mult=q,
    col_mult=p)`` pads) of an (m, n) matrix held as column slabs
    (:func:`_col_bounds`, every row on the slab's rank): one move.
    ``rows`` (psvd's m > n U) zero-pads the rows to that count."""
    import math

    m = q_cols.shape[0] if rows is None else rows
    p, q = mesh_grid_shape(mesh)
    lcm = math.lcm(p, q)
    mtp = padded_tiles(m, nb, lcm)
    ntp = padded_tiles(n, nb, lcm)
    b = _col_bounds(n, mesh)
    me = mesh.r * mesh.q + mesh.c

    def dst(d):
        return (local_indices(mtp, p, d // q, nb),
                local_indices(ntp, q, d % q, nb))

    data = _move(mesh, q_cols, np.arange(q_cols.shape[0]),
                 np.arange(b[me], b[me + 1]), dst)
    return DistMatrix(data, m, n, nb, mesh)


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

def chase_chunk_bounds(counts, sweep_hi: int, n: int, kd: int):
    """Sweep-chunk boundaries for the checkpointed chases (eig + svd):
    equalize reflector counts per chunk, balancing the band snapshots
    (nchunks·n·O(kd)) against one chunk's log (≈ 8n²/nchunks B) —
    nchunks ≈ √(n/(4·kd)), doubled to cover the log's padding."""
    counts = np.asarray(counts, dtype=np.int64)
    nchunks = max(2, 2 * int(np.sqrt(max(n // (4 * kd), 1))))
    if not counts.size:
        return [0, sweep_hi]
    cum = np.cumsum(counts)
    targets = [cum[-1] * (i + 1) / nchunks for i in range(nchunks)]
    cuts = [int(np.searchsorted(cum, t) + 1) for t in targets]
    bnds = [0] + sorted(set(min(c, sweep_hi) for c in cuts))
    if bnds[-1] != sweep_hi:
        bnds.append(sweep_hi)
    return bnds


def dist_band_eig(ab, kd_eff: int, mesh):
    """Distributed stages 2 and 3 from O(n·kd) band storage: eigenvalues
    and eigenvectors of the Hermitian band with no O(n²) host array.

    1. The checkpointed chase (reference ``src/hb2st.cc``'s schedule) on
       every rank's copy of the band, in sweep chunks of equal reflector
       counts (:func:`chase_chunk_bounds`), a band snapshot kept at each
       chunk's start and the logs dropped: one ``hb2st_wavefront`` launch
       a chunk where the ``chase`` site answers ``kernel`` (the
       snapshots on the card while they fit
       ``_chase.snapshots_fit_device``, else on the host), the host chase
       of :mod:`slate_tpu_torch.native` otherwise (complex input);
    2. :func:`~.dist_stedc.pstedc`, Q's rows spread over the ranks, then
       one move of Q from rows to column slabs (:func:`_col_bounds`);
    3. each chunk's log regenerated from its snapshot in reverse and
       applied to this rank's columns (``unmtr_hb2st_hh``; reference
       ``src/unmtr_hb2st.cc``).  Each rank regenerates its own logs: the
       band is replicated, so no log crosses between ranks.

    Returns ``(w, q_cols)``: the eigenvalues (host, replicated) and this
    rank's column slab of Q (n rows; fp64, or complex128 for a complex
    band — the zhbtrd-style chase leaves a diagonal phase, folded into
    Q's rows before the reflectors act)."""
    from .. import native
    from ..linalg import _chase
    from ..linalg.eig import (_hb_sweep_counts, _pack_hh_log,
                              _phase_tridiag, unmtr_hb2st_hh)
    from .dist_stedc import pstedc, pstedc_rows

    n = ab.shape[0]
    cplx = np.iscomplexobj(ab)
    dt = np.complex128 if cplx else np.float64
    tdt = torch.complex128 if cplx else torch.float64
    dev = mesh.device
    bnds = chase_chunk_bounds(_hb_sweep_counts(n, kd_eff), max(n - 2, 0), n,
                              kd_eff)
    kernel = _chase.backend("hb2st", n, kd_eff, tdt, dev, True) == "kernel"
    with _stage("stage.dist_eig.chase1", mesh):
        snaps = []
        if kernel:
            abw = _chase.hb2st_abw_from_ab(np.ascontiguousarray(ab, dt),
                                           kd_eff, dev)
            spill = not _chase.snapshots_fit_device(
                n * (2 * kd_eff + 2) * np.dtype(dt).itemsize, len(bnds) - 1)
            for j0, j1 in zip(bnds[:-1], bnds[1:]):
                snaps.append(_chase.snapshot_store(abw) if spill
                             else abw.clone())
                abw, _ = _chase.hb2st_device(abw, kd_eff, j0, j1,
                                             want_log=False)
            d_t, e_c = _chase.hb2st_d_e(abw, n)
            del abw
        else:
            abw = np.zeros((n, 2 * kd_eff + 2), dtype=dt)
            w_ = min(ab.shape[1], kd_eff + 1)
            abw[:, :w_] = ab[:, :w_]
            for j0, j1 in zip(bnds[:-1], bnds[1:]):
                snaps.append(abw.copy())
                native.hb2st_hh_banded_range(abw, n, kd_eff, j0, j1)
            d_t = abw[:, 0].real.copy()
            e_c = abw[:n - 1, 1].copy()
    phase = _phase_tridiag(e_c, n, dt)
    with _stage("stage.dist_eig.stedc", mesh):
        w, q_rows = pstedc(d_t, e_c.real.copy(), mesh)
        q = _rows_to_cols(mesh, q_rows, pstedc_rows(n, mesh), n, n)
        del q_rows
        if cplx:
            q = torch.from_numpy(phase).to(dev)[:, None] * q.to(tdt)
    with _stage("stage.dist_eig.chase2", mesh):
        for ci in range(len(snaps) - 1, -1, -1):
            j0, j1 = bnds[ci], bnds[ci + 1]
            snap, snaps[ci] = snaps[ci], None      # free as consumed
            if kernel:
                if isinstance(snap, np.ndarray):
                    snap = _chase.snapshot_restore(snap, dev)
                _, log = _chase.hb2st_device(snap, kd_eff, j0, j1)
            else:
                v, tau, row0, length = native.hb2st_hh_banded_range(
                    snap, n, kd_eff, j0, j1)
                if len(row0) == 0:
                    continue
                log = _pack_hh_log(v, tau, row0, length, n, kd_eff,
                                   counts=_hb_sweep_counts(n, kd_eff, j0, j1))
                _chase.mark_host_path("hb2st", log)
            del snap
            if log[0].shape[0]:
                q = unmtr_hb2st_hh(*log, q, kd_eff)
            del log
    return w, q


def _method(opts, key, enum_cls):
    from ..options import get_option

    method = get_option(opts, key, enum_cls.Auto)
    return method, method is enum_cls.Auto


def _operand(a, mesh, nb):
    """The distributed operand and its mesh: a DistMatrix as it is, a
    dense array distributed with ``row_mult=q, col_mult=p``."""
    if isinstance(a, DistMatrix):
        return a, a.mesh, a.nb
    p, q = mesh_grid_shape(mesh)
    return distribute(a, mesh, nb, row_mult=q, col_mult=p), mesh, nb


def _warn_replicated(name: str, what: str, dtype, method, flag: str,
                     value) -> None:
    """The scale-safe middle must not degrade silently: the replicated
    stage 2 holds O(n²) host arrays."""
    from .. import native

    warnings.warn(
        f"{name}: {what} unavailable for this input (dtype={dtype}, "
        f"method={method}, native={native.available()}, {flag}={value}); "
        "falling back to the replicated-host stage 2 (O(n^2) host memory)",
        RuntimeWarning, stacklevel=3)


def pheev(a, mesh=None, nb: int = 256, jobz: bool = True, opts=None):
    """Distributed Hermitian eigensolver — reference ``slate::heev``
    (``src/heev.cc:104-176``): distributed ``phe2hb`` stage 1, the band
    gathered (O(n·nb)) to every rank, stage 2 either through the
    distributed middle (:func:`dist_band_eig`; option ``stedc_dist``,
    default n ≥ 2048, fp64 and complex128 bands — an fp32 input's band is
    promoted — with vectors under the D&C method) or replicated on each
    rank's device, then the distributed back-transform.

    Returns ``(w, Z)``: ``w`` an fp64 tensor on the mesh's device, the
    same on every rank, and ``Z`` a DistMatrix in the input's dtype (None
    when not ``jobz``).  ``a`` may be a dense array (with ``mesh``) or a
    DistMatrix."""
    from .. import native
    from ..enums import MethodEig
    from ..linalg.eig import _band_eig_ab
    from ..options import get_option

    ad, mesh, nb = _operand(a, mesh, nb)
    n = ad.n
    with _stage("stage.pheev.stage1", mesh):
        fac, tmats, band_tiles = phe2hb(ad)
        ab = band_tiles_to_banded(band_tiles, n, nb, lower=True)
    method, auto = _method(opts, "method_eig", MethodEig)
    if auto:
        method = MethodEig.DC
    kd_eff = min(nb, n - 1)
    flag = get_option(opts, "stedc_dist", n >= 2048)
    use_dist = (jobz and ab.dtype in (np.float64, np.complex128)
                and method is MethodEig.DC and native.available() and n > 2
                and kd_eff >= 2 and bool(flag))
    if jobz and n >= 2048 and not use_dist:
        _warn_replicated("pheev", "distributed stedc", ab.dtype, method,
                         "stedc_dist", flag)
    dev = mesh.device
    if use_dist:
        w, q_cols = dist_band_eig(ab, kd_eff, mesh)
        with _stage("stage.pheev.back", mesh):
            zd = _distribute_on_mesh(q_cols.to(ad.dtype), n, mesh, nb)
            del q_cols
            z = punmtr_he2hb(fac, tmats, zd, forward=True)
        return torch.from_numpy(np.asarray(w, np.float64)).to(dev), z
    with _stage("stage.pheev.stage2", mesh):
        w, z_band = _band_eig_ab(ab, kd_eff, jobz, method, auto, dev)
    w = torch.from_numpy(np.asarray(w, np.float64)).to(dev)
    if not jobz:
        return w, None
    with _stage("stage.pheev.back", mesh):
        p, q = mesh_grid_shape(mesh)
        zd = distribute(torch.as_tensor(z_band).to(device=dev,
                                                   dtype=ad.dtype),
                        mesh, nb, row_mult=q, col_mult=p)
        z = punmtr_he2hb(fac, tmats, zd, forward=True)
    return w, z


def psvd(a, mesh=None, nb: int = 256, jobu: bool = True, jobvt: bool = True,
         opts=None):
    """Distributed two-stage SVD — reference ``slate::svd``
    (``src/svd.cc:207-372``): distributed ``pge2tb`` stage 1, the band
    gathered to every rank, stage 2 either through the distributed middle
    (:func:`~.dist_svd.dist_band_svd`; option ``svd_dist``, default
    n ≥ 2048, real bands, D&C or Auto) or replicated on each rank's
    device, then the distributed back-transforms.

    Returns ``(sigma, U, V)``: ``sigma`` an fp64 tensor on the mesh's
    device (descending), U an m×n DistMatrix and V the n×n DistMatrix of
    the right singular vectors as columns (undistribute and
    conj-transpose it for Vᴴ); None where not asked for.  Requires m ≥ n
    (transpose a wide input first)."""
    from .. import native
    from ..enums import MethodSVD
    from ..linalg.svd import _band_svd_ab
    from ..options import get_option

    ad, mesh, nb = _operand(a, mesh, nb)
    m, n = ad.m, ad.n
    if m < n:
        raise ValueError("psvd requires m >= n (transpose the input)")
    with _stage("stage.psvd.stage1", mesh):
        fac, qtmats, ptmats, band_tiles = pge2tb(ad)
        ab = band_tiles_to_banded(band_tiles, n, nb, lower=False)
    method, auto = _method(opts, "method_svd", MethodSVD)
    kd_eff = min(nb, max(n - 1, 1))
    flag = get_option(opts, "svd_dist", n >= 2048)
    use_dist = ((jobu or jobvt) and ab.dtype == np.float64
                and method in (MethodSVD.Auto, MethodSVD.DC)
                and native.available() and n > 2 and kd_eff >= 2
                and bool(flag))
    if (jobu or jobvt) and n >= 2048 and not use_dist:
        _warn_replicated("psvd", "distributed middle", ab.dtype, method,
                         "svd_dist", flag)
    dev = mesh.device
    u = v = None
    if use_dist:
        from .dist_svd import dist_band_svd

        s, u_cols, v_cols = dist_band_svd(ab, kd_eff, mesh, jobu, jobvt)
        with _stage("stage.psvd.back", mesh):
            if jobu:
                ud = _distribute_on_mesh(u_cols.to(ad.dtype), n, mesh, nb,
                                         rows=m)
                del u_cols
                u = punmbr_ge2tb_q(fac, qtmats, ud, forward=True)
            if jobvt:
                vd = _distribute_on_mesh(v_cols.to(ad.dtype), n, mesh, nb)
                del v_cols
                v = punmbr_ge2tb_p(fac, ptmats, vd, forward=True)
        return torch.from_numpy(np.asarray(s, np.float64)).to(dev), u, v
    with _stage("stage.psvd.stage2", mesh):
        s, u_b, vh_b = _band_svd_ab(ab, kd_eff, jobu, jobvt, method, auto,
                                    dev)
    s = torch.from_numpy(np.asarray(s, np.float64)).to(dev)
    p, q = mesh_grid_shape(mesh)
    with _stage("stage.psvd.back", mesh):
        if jobu:
            u2 = torch.as_tensor(u_b).to(device=dev, dtype=ad.dtype)
            if m > n:
                u2 = torch.cat([u2, torch.zeros((m - n, u2.shape[1]),
                                                dtype=u2.dtype, device=dev)])
            u = punmbr_ge2tb_q(fac, qtmats, distribute(
                u2, mesh, nb, row_mult=q, col_mult=p), forward=True)
        if jobvt:
            v2 = torch.as_tensor(vh_b).to(device=dev, dtype=ad.dtype).mH
            v = punmbr_ge2tb_p(fac, ptmats, distribute(
                v2.resolve_conj(), mesh, nb, row_mult=q, col_mult=p),
                forward=True)
    return s, u, v
