"""Distributed Hermitian-indefinite factor and solve — the counterpart of
``slate_tpu/parallel/dist_hesv.py`` (reference ``slate::hetrf`` /
``hetrs`` / ``hesv``, ``src/hetrf.cc``).

:func:`phetrf` runs the blocked Parlett–Reid (Aasen) L·T·Lᴴ of
:func:`slate_tpu_torch.linalg.hesv._hetrf_blocked` with the matrix
block-cyclic throughout:

* a panel's (n − j0) × (nb + 1) window arrives replicated on every rank
  through one placed ``psum``; every rank runs the panel's column steps
  on its copy, so each pivot is read from values that are the same on
  every rank (the window is a placed sum with one contributor an entry,
  then the same operations on the same data);
* each column's two-sided swap crosses ranks with ONE collective: rows
  jt+1 and p and column p, placed by their owners into one buffer and
  summed, after which each rank writes its own pieces back swapped —
  every index a device tensor, so the pivot never visits the host.  The
  window is the only current copy of its columns mid-panel: an in-window
  pivot swaps window columns only, a trailing one takes its column from
  the trailing matrix and leaves the window's outgoing column there;
* at a panel's end the deferred two-sided update V·Uᴴ + C·Vᴴ (masked by
  each column's watermark) is one local product on each rank's trailing
  shard — :func:`slate_tpu_torch.ops.blocks.matmul`, so with nb a
  multiple of 128 it is the ``matmul`` kernel for fp32 on the card; at
  the JAX package's default nb = 32 it is stock — and the trailing
  square is re-hermitized against its adjoint, gathered with one placed
  ``psum`` of the square;
* L's rows move with every swap.  Here each row of L keeps its place
  while the rank-replicated map from rows to places follows the swaps;
  the rows are put in order once, at the end.

Collectives (metrics on): ``collective.hetrf_swap`` (one a column),
``collective.hetrf_window`` and ``collective.hetrf_hermitize`` (one each
a panel), ``collective.hetrf_gather`` (two a call: L, T).  Timers
``stage.phetrf.columns``, ``stage.phetrf.update``, ``stage.phetrs``.

:func:`phetrs` applies the interleaved pivots to the replicated
right-hand sides, runs both unit-L solves as distributed ``ptrsm``
sweeps, and solves with T on the host (``scipy.linalg.solve_banded``,
O(n·nrhs), the reference's banded gbtrf/gbtrs slot).
"""

from __future__ import annotations

import numpy as np
import torch

from ..enums import Diag, Op, Side, Uplo
from ..ops.blocks import matmul as _mm
from .dist import DistMatrix, distribute, like, undistribute
from .dist_util import _stage, count_collective, local_grows
from .mesh import BOTH, mesh_grid_shape


def _ss(idx: np.ndarray, g: int) -> int:
    """First position of the ascending ``idx`` at or past g."""
    return int(np.searchsorted(idx, g))


def phetrf(a, mesh=None, nb: int = 32):
    """Distributed blocked Aasen L·T·Lᴴ: P·A·Pᴴ = L·T·Lᴴ, T Hermitian
    tridiagonal, L unit lower with first column e₁ (the row-swapped
    multipliers of :func:`slate_tpu_torch.linalg.hesv.hetrf`, so
    :func:`phetrs` shares its pivot algebra).

    ``a`` is a dense Hermitian array (with ``mesh``) or a DistMatrix with
    square padded storage.  Returns ``(l, d, e, ipiv)``: ``l`` a
    DistMatrix of the strict multipliers (no unit diagonal), ``d`` (real),
    ``e`` and ``ipiv`` replicated tensors on the mesh's device."""
    if isinstance(a, DistMatrix):
        ad = a
    else:
        p, q = mesh_grid_shape(mesh)
        ad = distribute(a, mesh, nb, row_mult=q, col_mult=p)
    if ad.mtp != ad.ntp or ad.row_nb != ad.nb:
        raise ValueError("phetrf needs square padded storage and square "
                         "tiles (distribute with row_mult=q, col_mult=p)")
    n = ad.n
    a_loc, l_loc, ipiv = _phetrf(ad.mesh, ad.data.clone(), n, ad.nb)
    d, e = _tridiagonal(ad.mesh, a_loc, n, ad.nb)
    return like(ad, l_loc), d, e, ipiv[:max(n - 2, 0)]


def _owner_table(M: int, nb: int, p: int, q: int, r: int, c: int,
                 ml: int, nl: int) -> np.ndarray:
    """For each global index g: (the local row to read, to write, the
    local column to read, to write) of this rank — where it holds row or
    column g its local index, else the work array's zero row (column),
    which reads as zeros, and its trash row (column), which takes writes
    no one reads.  So every rank runs the same operations with the
    pivot's indices on the device."""
    g = np.arange(M)
    blk = g // nb
    lrow = (blk // p) * nb + g % nb
    lcol = (blk // q) * nb + g % nb
    own_r, own_c = blk % p == r, blk % q == c
    return np.stack([np.where(own_r, lrow, ml * nb),
                     np.where(own_r, lrow, ml * nb + 1),
                     np.where(own_c, lcol, nl * nb),
                     np.where(own_c, lcol, nl * nb + 1)], axis=1)


def _phetrf(mesh, a_loc, n: int, nb: int):
    """The panel loop on this rank's shard; returns ``(a_loc, l_loc,
    ipiv)``.  Window rows are the global rows [j0, M), window index i ↔
    global row j0 + i.  The shard lives in a work array with two more
    rows and columns (:func:`_owner_table`'s zero and trash lines)."""
    p, q, r, c = mesh.p, mesh.q, mesh.r, mesh.c
    ml, nl = a_loc.shape[0] // nb, a_loc.shape[1] // nb
    mr, nc = ml * nb, nl * nb
    M = p * mr
    dt, dev = a_loc.dtype, a_loc.device
    work = torch.zeros((mr + 2, nc + 2), dtype=dt, device=dev)
    work[:mr, :nc] = a_loc
    a_loc = work[:mr, :nc]
    grows_h = local_grows(ml, nb, p, r)
    gcols_h = local_grows(nl, nb, q, c)
    grows = torch.as_tensor(grows_h, device=dev)
    gcols = torch.as_tensor(gcols_h, device=dev)
    tab = torch.as_tensor(_owner_table(M, nb, p, q, r, c, ml, nl),
                          device=dev)
    trash_col = torch.full((1,), nc + 1, dtype=torch.int64, device=dev)
    lmat = torch.zeros_like(a_loc)
    ipiv = torch.zeros(max(n - 2, 1), dtype=torch.int64, device=dev)
    cur2lab = torch.arange(M, device=dev)   # L's row at each place
    ar = torch.arange(nb + 2, device=dev)
    isz = a_loc.element_size()
    # one swap buffer for the whole call, zeroed each column
    swap = torch.empty(3 * M, dtype=dt, device=dev)
    for j0 in range(0, max(n - 2, 0), nb):
        w = min(nb, n - 2 - j0)
        wide = min(w + 1, n - j0)
        mw = M - j0
        rs, cs = _ss(grows_h, j0), _ss(gcols_h, j0)
        rows_w = grows[rs:] - j0            # window index of local rows
        cols_w = gcols[cs:] - j0            # and of local columns
        a_r, a_rc = work[rs:mr], work[:, cs:nc]
        tab_w = tab[j0:]
        # ---- the window, replicated: one placed psum
        wl = np.flatnonzero((gcols_h >= j0) & (gcols_h < j0 + wide))
        win0 = torch.zeros((mw, wide), dtype=dt, device=dev)
        if len(wl) and len(rows_w):
            wl_t = torch.as_tensor(wl, device=dev)
            win0[rows_w[:, None], gcols[wl_t][None, :] - j0] = \
                a_r.index_select(1, wl_t)
        count_collective("hetrf_window", win0.numel() * isz)
        mesh.psum(win0, BOTH)
        # one row-swappable store: [window | trash column | U | V | C |
        # the incoming column], and [watermark | L's row] for the ints
        wv = torch.zeros((mw, wide + 2 + 3 * w), dtype=dt, device=dev)
        wv[:, :wide] = win0
        del win0
        win, vuc = wv[:, :wide], wv[:, wide + 1:wide + 1 + 3 * w]
        U, V, C = vuc[:, :w], vuc[:, w:2 * w], vuc[:, 2 * w:]
        inc = wv[:, -1]
        wmc = torch.zeros((mw, 2), dtype=torch.int64, device=dev)
        wmc[:, 1] = cur2lab[j0:]
        wm = wmc[:, 0]
        steps2 = torch.arange(w, device=dev).repeat(2)
        ipw = torch.empty(w, dtype=torch.int64, device=dev)
        nw = M - j0                          # global columns [j0, M)
        buf = swap[:2 * nw + mw]
        brows, bcol = buf[:2 * nw].view(2, nw), buf[2 * nw:]
        with _stage("stage.phetrf.columns", mesh):
            for t in range(w):
                i1 = t + 1                   # window index of row jt + 1
                pw = torch.argmax(win[i1:, t].abs()) + i1
                pair = torch.cat([ar[i1:i1 + 1], pw.view(1), ar[i1:i1 + 1]])
                ix = tab_w.index_select(0, pair)   # (jt+1, p, jt+1)
                # ---- rows jt+1 and p, column p: one psum
                buf.zero_()
                brows.index_copy_(1, cols_w, a_rc.index_select(0, ix[:2, 0]))
                bcol.index_copy_(0, rows_w,
                                 a_r.index_select(1, ix[1:2, 2])[:, 0])
                count_collective("hetrf_swap", buf.numel() * isz)
                mesh.psum(buf, BOTH)
                # the swapped rows back (trailing columns are current;
                # the window's are overwritten at the panel's end)
                a_rc.index_copy_(0, ix[1:, 1], brows.index_select(1, cols_w))
                # ---- the window side of the swap
                inc.copy_(bcol)
                it, pt = pair[:2], pair[1:]
                wv.index_copy_(0, it, wv.index_select(0, pt))
                wmc.index_copy_(0, it, wmc.index_select(0, pt))
                inwin = pw < wide
                pc = torch.where(inwin, pw, wide).view(1)
                out_col = win[:, t + 1].clone()
                old = wv.index_select(1, pc)[:, 0]
                wv.index_copy_(1, pc, out_col.view(-1, 1))
                # a trailing pivot's slot takes the outgoing column
                a_r.index_copy_(1, torch.where(inwin, trash_col, ix[1:2, 3]),
                                out_col.index_select(0, rows_w).view(-1, 1))
                # the incoming column: the window's for an in-window
                # pivot, the trailing matrix's (rows swapped) else; then
                # the panel terms it missed (steps wm .. t−1: the later
                # columns of V, U, C are still zero)
                col = torch.where(inwin, old, inc)
                if t:
                    col.addmv_(vuc[:, w:], vuc[i1, :2 * w].conj()
                               * (steps2 >= wm[i1]), alpha=-1)
                win[:, t + 1] = col
                U[:, t] = col
                aj1 = win[i1, t]
                torch.div(win[i1 + 1:, t], aj1 + (aj1 == 0),
                          out=V[i1 + 1:, t])
                lcol = V[:, t]
                win[i1 + 1:].addr_(lcol[i1 + 1:], win[i1], alpha=-1)
                C[:, t] = win[:, t + 1]
                if t + 2 < wide:
                    win[:, t + 2:].addr_(win[:, t + 1],
                                         lcol[t + 2:wide].conj(), alpha=-1)
                ipw[t] = pw
                wm[:wide] = t + 1
        ipiv[j0:j0 + w] = ipw + j0
        cur2lab[j0:] = wmc[:, 1]
        with _stage("stage.phetrf.update", mesh):
            # ---- the window back into this rank's shard
            if len(wl) and len(rows_w):
                a_r.index_copy_(1, wl_t, win.index_select(0, rows_w)
                                .index_select(1, gcols[wl_t] - j0))
            tail = (j0 + wide) // nb * nb    # tile-aligned, ≤ j0 + wide
            rt, ct = _ss(grows_h, tail), _ss(gcols_h, tail)
            if j0 + wide < n:
                # the deferred V·Uᴴ + C·Vᴴ on columns ≥ j0 + wide, each
                # column masked by its watermark
                keep = ((steps2[None, :] >= wm[:, None])
                        & (torch.arange(mw, device=dev)
                           >= wide)[:, None]).to(dt)
                x = vuc[:, w:].index_select(0, rows_w)
                y = (vuc[:, :2 * w] * keep).index_select(0, gcols[ct:] - j0)
                if len(x) and len(y):
                    a_loc[rs:, ct:] -= _mm(x, y.mH)
                # re-hermitize the trailing square against its adjoint
                # (the deferred product's rounding asymmetry is otherwise
                # amplified by every later elimination's growth)
                sq = torch.zeros((M - tail, M - tail), dtype=dt, device=dev)
                ri, ci = grows[rt:] - tail, gcols[ct:] - tail
                blkt = a_loc[rt:, ct:]
                if len(ri) and len(ci):
                    sq[ri[:, None], ci[None, :]] = blkt
                count_collective("hetrf_hermitize", sq.numel() * isz)
                mesh.psum(sq, BOTH)
                adj = sq.index_select(0, ci).index_select(1, ri).mH
                both = ((grows[rt:] >= j0 + wide)[:, None]
                        & (gcols[ct:] >= j0 + wide)[None, :])
                a_loc[rt:, ct:] = torch.where(both, 0.5 * (blkt + adj), blkt)
            # ---- this panel's multipliers as L's columns j0+1 … j0+w,
            # at each of this rank's rows' places
            lab2cur = torch.empty_like(cur2lab)
            lab2cur.index_copy_(0, cur2lab, torch.arange(M, device=dev))
            idx = lab2cur.index_select(0, grows) - j0
            vr = torch.where((idx >= 0)[:, None],
                             V.index_select(0, idx.clamp(min=0)),
                             torch.zeros((), dtype=dt, device=dev))
            lc_h = np.flatnonzero((gcols_h > j0) & (gcols_h <= j0 + w))
            if len(lc_h):
                lc_t = torch.as_tensor(lc_h, device=dev)
                lmat.index_copy_(1, lc_t, vr.index_select(
                    1, gcols[lc_t] - (j0 + 1)))
    # L's rows in their final order: one placed psum of L
    full = torch.zeros((M, M), dtype=dt, device=dev)
    full[grows[:, None], gcols[None, :]] = lmat
    count_collective("hetrf_gather", full.numel() * isz)
    mesh.psum(full, BOTH)
    lmat = full.index_select(0, cur2lab.index_select(0, grows)) \
        .index_select(1, gcols)
    return a_loc, lmat, ipiv


def _tridiagonal(mesh, a_loc, n: int, nb: int):
    """T's diagonal (real) and subdiagonal, replicated: each rank places
    the entries it holds, one psum."""
    p, q = mesh.p, mesh.q
    ml, nl = a_loc.shape[0] // nb, a_loc.shape[1] // nb
    grows_h = local_grows(ml, nb, p, mesh.r)
    gcols_h = local_grows(nl, nb, q, mesh.c)
    dev = a_loc.device
    buf = torch.zeros(2 * n, dtype=a_loc.dtype, device=dev)
    for off, base in ((0, 0), (1, n)):
        g = grows_h[(grows_h < n) & (grows_h >= off)]
        pos = np.searchsorted(gcols_h, g - off)
        hit = (pos < len(gcols_h)) & (gcols_h[np.minimum(
            pos, len(gcols_h) - 1)] == g - off)
        li = np.searchsorted(grows_h, g[hit])
        if len(li):
            buf[torch.as_tensor(base + g[hit] - off, device=dev)] = a_loc[
                torch.as_tensor(li, device=dev),
                torch.as_tensor(pos[hit], device=dev)]
    count_collective("hetrf_gather", buf.numel() * a_loc.element_size())
    mesh.psum(buf, BOTH)
    d = buf[:n]
    return (d.real if d.is_complex() else d).clone(), buf[n:2 * n - 1].clone()


def _unit_diag(l: DistMatrix):
    """This rank's shard of the identity on the whole padded diagonal
    (padded rows too, so the triangular sweeps stay nonsingular)."""
    p, q = l.grid_shape
    ml, nl = l.data.shape[0] // l.nb, l.data.shape[1] // l.nb
    gr = torch.as_tensor(local_grows(ml, l.nb, p, l.mesh.r), device=l.device)
    gc = torch.as_tensor(local_grows(nl, l.nb, q, l.mesh.c), device=l.device)
    return (gr[:, None] == gc[None, :]).to(l.dtype)


def _swap_order(ipiv, n: int) -> np.ndarray:
    """The row order the interleaved swaps (rows j+1 and ipiv[j], in turn)
    make, from one read of the replicated pivots."""
    perm = np.arange(n)
    for j, pv in enumerate(torch.as_tensor(ipiv).cpu().numpy().tolist()):
        perm[j + 1], perm[pv] = perm[pv], perm[j + 1]
    return perm


def phetrs(l: DistMatrix, d, e, ipiv, b, mesh=None):
    """Solve with the :func:`phetrf` factors — reference ``slate::hetrs``:
    the pivots on the replicated B, the distributed unit-L solve
    (``ptrsm``), T's Hermitian tridiagonal solve on the host
    (O(n·nrhs)), the distributed Lᴴ solve, the pivots back.  Returns X,
    replicated, on the mesh's device."""
    from scipy.linalg import solve_banded

    from .dist_aux import ptrsm

    mesh = l.mesh
    p, q = l.grid_shape
    n = l.n
    with _stage("stage.phetrs", mesh):
        bv = torch.as_tensor(b, device=l.device)
        squeeze = bv.ndim == 1
        if squeeze:
            bv = bv[:, None]
        bv = bv.to(l.dtype)
        perm = torch.as_tensor(_swap_order(ipiv, n), device=l.device)
        bd = distribute(bv.index_select(0, perm), mesh, l.nb, row_mult=q)
        lfull = like(l, l.data + _unit_diag(l))
        y = ptrsm(Side.Left, Uplo.Lower, Op.NoTrans, Diag.Unit, lfull, bd)
        yh = undistribute(y).cpu().numpy()
        ab = np.zeros((3, n), dtype=yh.dtype)
        ab[1] = torch.as_tensor(d).cpu().numpy()
        if n > 1:
            en = torch.as_tensor(e).cpu().numpy()
            ab[0, 1:] = np.conj(en)
            ab[2, :-1] = en
        wv = solve_banded((1, 1), ab, yh)
        wd = distribute(torch.from_numpy(np.ascontiguousarray(wv)).to(
            device=l.device, dtype=l.dtype), mesh, l.nb, row_mult=q)
        v = undistribute(ptrsm(Side.Left, Uplo.Lower, Op.ConjTrans,
                               Diag.Unit, lfull, wd))
        x = torch.empty_like(v)
        x[perm] = v
    return x[:, 0] if squeeze else x


def phesv(a, b, mesh=None, nb: int = 32):
    """Distributed factor and solve — reference ``slate::hesv``.  Returns
    ``((l, d, e, ipiv), x)``, ``x`` replicated on the mesh's device."""
    l, d, e, ipiv = phetrf(a, mesh, nb)
    x = phetrs(l, d, e, ipiv, b)
    return (l, d, e, ipiv), x
