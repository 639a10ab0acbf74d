"""Distributed LU with partial pivoting over the ('p', 'q') grid — the
counterpart of ``slate_tpu/parallel/dist_lu.py`` (``pgetrf``, ``pgetrs``,
``pgesv``).

The JAX package's design, step for step: the block column k arrives
replicated through ONE fused broadcast; every rank factors the (M, nb)
panel redundantly, pivots chosen by the ``dist_pivot`` site (``maxloc``,
the per-column argmax chain, or ``tournament``, CALU's per-grid-row
candidates and pairwise tournament), both eliminating through the shared
:func:`_elim_col`; the row swaps move at most 2·nb rows in one
vectorized fetch (a ``psum`` along 'p') and one scatter, and the first
nb fetched rows are the post-swap block row k; U12 = L11⁻¹·A12 by the
``dist_panel`` site (``xla``: the triangular solve; ``pallas_panel``: the
``trtri_panel`` kernel, products and a guarded correction;
``pallas_fused``: one ``lu_u12_panel`` launch, its departure read on the
host for the guard); a ring of D panels in flight mirrors each step's
swaps and receives its rank-nb correction, the in-flight panels' block
rows solved in ONE concatenated call; the trailing update is one
product over the stage's static window.

Pivots are a replicated global permutation ``gperm`` (int64, on the
device) with ``A[gperm] = L·U``.  Each rank runs this in its own process
with its own (r, c): the JAX package's ``jnp.where(k % p == r, ...)``
masks are Python branches here, and its traced index arithmetic (row
rolls, the drop-mode scatter) plain index arithmetic on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..grid import ceildiv
from ..ops import kernels
from ..ops.blocks import matmul as _mm
from ..perf import blackbox
from ..resilience import checkpoint as _ckpt
from .dist import DistMatrix, distribute, like, undistribute
from .dist_util import (_natural_padded, agree_flag, agree_values,
                        bcast_block_col, dist_chunk_slices,
                        dist_lookahead_depth, dist_panel_backend,
                        dist_pivot_backend, local_grows, peye,
                        run_timeline, stage_bounds, staged_fori)
from .mesh import AXIS_P, AXIS_Q, BOTH, mesh_grid_shape


def _elim_col(j: int, a) -> None:
    """One right-looking elimination step, in place, on an (M, nb) panel
    whose step-``j`` pivot row sits at row ``j``: multipliers below the
    pivot (a zero pivot divides by 1), the rank-1 update of the rows and
    columns past j.  Both pivot backends eliminate through it, so their
    factors agree bitwise wherever their pivots do."""
    piv = a[j, j]
    denom = torch.where(piv == 0, torch.ones_like(piv), piv)
    l = a[j + 1:, j] / denom
    a[j + 1:, j + 1:].addr_(l, a[j, j + 1:], alpha=-1)
    a[j + 1:, j] = l


def _nopivot_lu_panel(a):
    """Unpivoted elimination of an (M, nb) panel whose pivot rows already
    sit in the top nb rows (the tournament path), in place."""
    for j in range(a.shape[1]):
        _elim_col(j, a)
    return a


def _maxloc_lu_panel(a):
    """``(lu, piv, perm)`` of the (M, nb) panel by classic partial
    pivoting, in place: per column the first maximum of |·| over the rows
    not yet eliminated (LAPACK's isamax tie-break), the row swap, then
    :func:`_elim_col`.  ``perm`` is the full row permutation
    (``new[i] = old[perm[i]]``) and ``piv`` the LAPACK-style swap
    targets, both device tensors."""
    M, nb = a.shape
    dev = a.device
    pos = torch.arange(M, device=dev)
    piv = torch.empty(nb, dtype=torch.int64, device=dev)
    for j in range(nb):
        s = torch.argmax(a[j:, j].abs()) + j
        jj = torch.full_like(s, j)
        swap, back = torch.stack([jj, s]), torch.stack([s, jj])
        a.index_copy_(0, swap, a.index_select(0, back))
        pos.index_copy_(0, swap, pos.index_select(0, back))
        piv[j] = s
        _elim_col(j, a)
    return a, piv, pos


def _first_rows(pivots: np.ndarray, m: int, nb: int) -> np.ndarray:
    """The original rows LAPACK's swaps (1-based ``pivots``) bring to the
    top nb rows of an m-row matrix."""
    perm = np.arange(m)
    for j, t in enumerate(pivots[:nb] - 1):
        perm[j], perm[t] = perm[t], perm[j]
    return perm[:nb]


def _tournament_pivots(masked, p: int, ml: int, nb: int) -> np.ndarray:
    """Slot indices (elimination order) of the nb tournament pivot rows of
    the masked (M, nb) panel: the rows split into the p owner groups of
    the rolled panel (slot block b ↦ group b mod p), each group's
    partial-pivot LU nominates its top nb rows, then pairwise (2nb, nb)
    partial-pivot LUs reduce the candidate sets (CALU's tournament).
    Host array."""
    grp = masked.reshape(ml, p, nb, nb).transpose(0, 1).reshape(p, ml * nb,
                                                                nb)
    # one LU per group: a batched call takes the library's small-matrix
    # batched routines on the card
    pivs = torch.stack([torch.linalg.lu_factor_ex(g)[1] for g in grp])
    pivs = pivs.cpu().numpy()
    sets = []
    for rr in range(p):
        sel = _first_rows(pivs[rr], ml * nb, nb)
        cand = grp[rr].index_select(0, torch.as_tensor(sel, device=grp.device))
        sets.append((cand, ((sel // nb) * p + rr) * nb + sel % nb))
    while len(sets) > 1:
        nxt = []
        for i in range(0, len(sets) - 1, 2):
            v = torch.cat([sets[i][0], sets[i + 1][0]])
            slots = np.concatenate([sets[i][1], sets[i + 1][1]])
            _, pv, _ = torch.linalg.lu_factor_ex(v)
            win = _first_rows(pv.cpu().numpy(), 2 * nb, nb)
            nxt.append((v.index_select(0, torch.as_tensor(win, device=v.device)),
                        slots[win]))
        if len(sets) % 2 == 1:                # odd count: a bye
            nxt.append(sets[-1])
        sets = nxt
    return sets[0][1]


def _perm_from_targets(t: np.ndarray, M: int, nb: int):
    """Sequential-transposition form of "move rows ``t`` to the top nb
    slots": ``(perm, piv)`` host arrays with ``perm`` the full
    permutation and ``piv`` the LAPACK-style targets, as
    :func:`_maxloc_lu_panel` returns them."""
    pos = np.arange(M)
    where = np.arange(M)
    piv = np.zeros(nb, dtype=np.int64)
    for j in range(nb):
        s = where[t[j]]
        pj, ps = pos[j], pos[s]
        pos[j], pos[s] = ps, pj
        where[ps], where[pj] = j, s
        piv[j] = s
    return pos, piv


def _solve_unit(l11, rowblk):
    return torch.linalg.solve_triangular(l11, rowblk, upper=False,
                                         unitriangular=True)


def _u12_solve(backend: str, l11, rowblk):
    """U₁₂ = L₁₁⁻¹·A₁₂ on the replicated block row.  The kernel rungs are
    guarded as the JAX package guards them: past a 1e-2 departure of the
    uncorrected solve the exact triangular solve takes over.  The
    departure is read on the host (one sync a solve) where the JAX
    package branches in ``lax.cond``; the answers are the same."""
    if backend == "pallas_fused":
        u12, dev = kernels.lu_u12_panel(l11, rowblk)
        if float(dev.reshape(())) < 1e-2:
            return u12.to(l11.dtype)
        return _solve_unit(l11, rowblk)
    if backend != "pallas_panel":
        return _solve_unit(l11, rowblk)
    linv = kernels.trtri_panel(l11)
    u12 = _mm(linv, rowblk)
    r1 = rowblk - _mm(l11, u12)
    dev = r1.abs().max() / torch.clamp(rowblk.abs().max(),
                                       min=torch.finfo(l11.dtype).tiny)
    if float(dev) < 1e-2:
        return u12 + _mm(linv, r1)
    return _solve_unit(l11, rowblk)


def _pgetrf(mesh, a_loc, nb: int, nt: int, backend: str, pivot: str,
            depth: int, chunks: int, k_lo: int = 0, k_hi=None, gperm=None,
            ring=None):
    """Steps [k_lo, k_hi) of the step loop on this rank's shard ``a_loc``,
    in place, from the pivot vector ``gperm`` and panel ring ``ring`` a
    previous chunk returned (None: the identity and a fresh broadcast);
    returns ``(a_loc, gperm, ring)``."""
    p, q = mesh_grid_shape(mesh)
    r, c = mesh.r, mesh.c
    ml, nl = a_loc.shape[0] // nb, a_loc.shape[1] // nb
    mtp = p * ml
    M = mtp * nb
    dt, dev = a_loc.dtype, a_loc.device
    grows_h = local_grows(ml, nb, p, r)
    depth = max(1, min(depth, nt))
    eye = torch.eye(nb, dtype=dt, device=dev)

    def getcol(k):
        return a_loc[:, (k // q) * nb:(k // q + 1) * nb]

    def owned(g):
        """(ownership mask, local row) of the global rows ``g``."""
        blk = g // nb
        return blk % p == r, (blk // p) * nb + g % nb

    def make_body(row0, col0):
        # global block of each local column block of the window
        wblk = np.arange(col0 // nb, nl) * q + c

        def body(k, carry):
            gperm, ring = carry
            panel = ring[0]
            # the diagonal block leads; the factored rows (wrapped to the
            # end by the JAX package's roll) are zero, so never pivots
            valid = M - k * nb
            masked = torch.zeros_like(panel)
            masked[:valid] = panel[k * nb:]
            if pivot == "tournament":
                tslots = _tournament_pivots(masked, p, ml, nb)
                perm_h, piv_h = _perm_from_targets(tslots, M, nb)
                perm = torch.as_tensor(perm_h, device=dev)
                lu_p = _nopivot_lu_panel(masked.index_select(0, perm))
            else:
                lu_p, piv, perm = _maxloc_lu_panel(masked)
                piv_h, perm_h = piv.cpu().numpy(), perm.cpu().numpy()
            # ---- the row swaps: destinations = the top nb slots and the
            # pivot targets; the sources fetched with one psum along 'p'
            drel = np.concatenate([np.arange(nb), piv_h])
            dg, sg = k * nb + drel, k * nb + perm_h[drel]
            own_s, lr_s = owned(sg)
            fetched = torch.zeros((2 * nb, a_loc.shape[1]), dtype=dt,
                                  device=dev)
            if own_s.any():
                i = np.nonzero(own_s)[0]
                fetched[torch.as_tensor(i, device=dev)] = a_loc.index_select(
                    0, torch.as_tensor(lr_s[i], device=dev))
            mesh.psum(fetched, AXIS_P)
            own_d, lr_d = owned(dg)
            if own_d.any():
                i = np.nonzero(own_d)[0]
                a_loc[torch.as_tensor(lr_d[i], device=dev)] = \
                    fetched[torch.as_tensor(i, device=dev)]
            # ---- the factored panel column (L21 and L11\U11) into the
            # owner column; my rows of L21 for the updates
            rel = grows_h - k * nb
            lo0 = int(np.searchsorted(rel, 0))
            lo1 = int(np.searchsorted(rel, nb))
            if k % q == c and lo0 < len(rel):
                getcol(k)[lo0:] = lu_p.index_select(
                    0, torch.as_tensor(rel[lo0:], device=dev))
            myl = torch.zeros((ml * nb, nb), dtype=dt, device=dev)
            if lo1 < len(rel):
                myl[lo1:] = lu_p.index_select(
                    0, torch.as_tensor(rel[lo1:], device=dev))
            # ---- U12 = L11⁻¹·A12 on block row k: the post-swap block row
            # is the first nb fetched rows, replicated along 'p' by the
            # swap psum
            l11 = torch.tril(lu_p[:nb], -1) + eye
            u12 = _u12_solve(backend, l11, fetched[:nb, col0:])
            # window columns of blocks > k; columns ≤ k keep a_loc's (the
            # fetch predates the panel write-back)
            cs = int(np.searchsorted(wblk, k, side="right")) * nb
            cmask = torch.zeros((1, u12.shape[1]), dtype=dt, device=dev)
            cmask[:, cs:] = 1
            if k % p == r:
                a_loc[(k // p) * nb:(k // p + 1) * nb, col0 + cs:] = u12[:, cs:]
            new_ring = []
            # ---- deep lookahead: the in-flight panels mirror step k's
            # swaps and take its rank-nb correction, all from replicated
            # operands; their block rows are solved in ONE call
            live = [j for j in range(1, depth) if k + j < nt]
            if live:
                l_glob = torch.zeros((M, nb), dtype=dt, device=dev)
                l_glob[(k + 1) * nb:] = lu_p[nb:valid]
                dg_t = torch.as_tensor(dg, device=dev)
                sg_t = torch.as_tensor(sg, device=dev)
                swapped = []
                for j in live:
                    pj = ring[j]
                    pj[dg_t] = pj.index_select(0, sg_t)
                    swapped.append(pj)
                us = _u12_solve(backend, l11, torch.cat(
                    [pj[k * nb:(k + 1) * nb] for pj in swapped], dim=1))
                for i, pj in enumerate(swapped):
                    uj = us[:, i * nb:(i + 1) * nb]
                    new_ring.append(pj - _mm(l_glob, uj))
                    kj = k + 1 + i
                    if backend != "xla" and k % p == r and kj % q == c:
                        # the ring solve is authoritative for its own
                        # columns, so the stored U12 and the correction
                        # applied to the panel always agree
                        a_loc[(k // p) * nb:(k // p + 1) * nb,
                              (kj // q) * nb:(kj // q + 1) * nb] = uj
            # ---- lookahead broadcast of block column k + D, updated
            # with step k's correction, before the trailing update
            kn = k + depth
            if kn < nt:
                own = kn % q == c
                coln = getcol(kn)[row0:]
                if own:
                    jn = (kn // q) * nb - col0
                    coln = coln - _mm(myl[row0:], u12[:, jn:jn + nb])
                new_ring.append(bcast_block_col(mesh, coln, grows_h[row0:],
                                                own, M, chunks))
            # ---- the trailing update on the window
            win = a_loc[row0:, col0:]
            win -= _mm(myl[row0:], u12 * cmask)
            # ---- fold this panel's permutation into the global one
            gperm[k * nb:] = gperm[k * nb:].index_select(0, perm[:valid])
            return gperm, new_ring

        return body

    if ring is None:
        ring = [bcast_block_col(mesh, getcol(k_lo + j), grows_h,
                                (k_lo + j) % q == c, M, chunks)
                for j in range(min(depth, nt - k_lo))]
    if gperm is None:
        gperm = torch.arange(M, device=dev)
    gperm, ring = staged_fori(stage_bounds(nt), p, q, nb, make_body,
                              (gperm, ring), k_lo, k_hi)
    return a_loc, gperm, ring


def pgetrf(a: DistMatrix):
    """Distributed partial-pivot LU: ``(lu, gperm)`` with
    ``A[gperm] = (tril(LU, −1) + I)·triu(LU)`` (reference ``slate::getrf``,
    ``src/getrf.cc:23``), ``gperm`` an int64 tensor on every rank.
    Distribute the operand with ``diag_pad=1.0, row_mult=q, col_mult=p``
    (see :func:`pgesv`).  The ``dist_panel``, ``dist_pivot``,
    ``dist_lookahead`` and ``dist_chunk`` sites pick the U12 solve, the
    pivot search, the ring depth and the broadcast slices."""
    from .dist_factor import _check_square

    _check_square("pgetrf", a)
    p, q = a.grid_shape
    nl = a.ntp // q
    nt = ceildiv(a.n, a.nb)
    backend = dist_panel_backend("getrf", a.nb, a.dtype, a.device,
                                 w=nl * a.nb)
    pivot = dist_pivot_backend(a.nb, p, a.dtype, a.device)
    depth = dist_lookahead_depth("getrf", nt, a.nb, a.dtype, a.device)
    chunks = dist_chunk_slices("getrf", a.nb, a.dtype, a.mesh)
    knobs = (backend, pivot, depth, chunks)

    def run():
        return _pgetrf(a.mesh, a.data.clone(), a.nb, nt, *knobs)[:2]

    def run_chunk(carry, k0, k1):
        if carry is None:
            return _pgetrf(a.mesh, a.data.clone(), a.nb, nt, *knobs, 0, k1)
        # a restored carry is a host snapshot: back onto the device
        a_loc, gperm, ring = carry
        return _pgetrf(a.mesh, a_loc.to(a.device), a.nb, nt, *knobs, k0,
                       k1, gperm.to(a.device), [r.to(a.device) for r in ring])

    every = _ckpt.every_steps()
    if 0 < every < nt:
        # step-cadence checkpoint/restart: the same steps in every-step
        # chunks, the carry (window, pivots, panel ring) snapshotted at
        # each boundary; a loss on any rank rewinds every rank one chunk
        out = _ckpt.run_checkpointed(
            nt, every, run_chunk, label="pgetrf",
            agree=lambda lost: agree_flag(a.mesh, lost, "ckpt_agree"))
        lu, gperm = out[0], out[1]
    elif blackbox.timeline_wanted() and nt > 1:
        # the measured step timeline (checkpointing takes precedence)
        out = run_timeline("pgetrf", nt, blackbox.timeline_window(),
                           run_chunk, a.device)
        lu, gperm = out[0], out[1]
    else:
        lu, gperm = run()
    lu, gperm = _pgetrf_abft_check(a, lu, gperm, run)
    return like(a, lu), gperm


def _pgetrf_abft_check(a: DistMatrix, lu, gperm, run):
    """The distributed LU's ABFT envelope: with ``SLATE_TPU_TORCH_ABFT``
    on, verify ``(eᵀL)·U = eᵀA`` and ``L·(U·e) = (A·e)[gperm]`` on the
    padded natural-order operands (on every rank, the verdict agreed
    over the grid) and recompute once through ``run`` on a detection
    (``abft.recomputed``); a second failure flows to the caller's
    residual gates (``abft.unrecovered``).  Off: one environment read."""
    from ..resilience import abft as _abft

    if not _abft.enabled():
        return lu, gperm
    a_nat = _natural_padded(a)
    cs_row0, cs_col0 = a_nat.sum(dim=0), a_nat.sum(dim=1)
    del a_nat

    def verify(out):
        ok, detail = _abft.verify_lu_factors(
            cs_row0, cs_col0, _natural_padded(a, out[0]), out[1])
        return not agree_flag(a.mesh, not ok, "abft_agree"), detail

    return _abft._envelope("pgetrf", run, lambda out: out, verify,
                           out=(lu, gperm))


def _plu_trsm(mesh, lu_loc, b_loc, nb: int, nt: int, upper: bool,
              unit=None):
    """Forward lower (``upper`` False) or backward upper solve on this
    rank's shards, in place on ``b_loc`` (the two halves of getrs,
    reference ``src/getrs.cc``).  ``unit`` overrides the diagonal
    convention; the default is the LU factor's, lower unit and upper
    non-unit (``slate_tpu/parallel/dist_lu.py:598-606``)."""
    if unit is None:
        unit = not upper
    p, q = mesh_grid_shape(mesh)
    r, c = mesh.r, mesh.c
    ml = lu_loc.shape[0] // nb
    dt, dev = lu_loc.dtype, lu_loc.device
    iblk = np.arange(ml) * p + r
    nrhs = b_loc.shape[1]

    def get_diag(k):
        blk = torch.zeros((nb, nb), dtype=dt, device=dev)
        if k % p == r and k % q == c:
            blk.copy_(lu_loc[(k // p) * nb:(k // p + 1) * nb,
                             (k // q) * nb:(k // q + 1) * nb])
        mesh.psum(blk, BOTH)
        return torch.triu(blk) if upper else torch.tril(blk)

    def get_brow(k):
        blk = torch.zeros((nb, nrhs), dtype=dt, device=dev)
        if k % p == r:
            blk.copy_(b_loc[(k // p) * nb:(k // p + 1) * nb])
        return mesh.psum(blk, AXIS_P)

    def get_col(k):
        col = torch.zeros((ml * nb, nb), dtype=dt, device=dev)
        if k % q == c:
            col.copy_(lu_loc[:, (k // q) * nb:(k // q + 1) * nb])
        return mesh.psum(col, AXIS_Q)

    for t in range(nt):
        k = nt - 1 - t if upper else t
        x = torch.linalg.solve_triangular(get_diag(k), get_brow(k),
                                          upper=upper, unitriangular=unit)
        if k % p == r:
            b_loc[(k // p) * nb:(k // p + 1) * nb] = x
        keep = iblk < k if upper else iblk > k
        mask = torch.as_tensor(np.repeat(keep, nb), device=dev).to(dt)
        b_loc -= _mm(get_col(k) * mask[:, None], x)
    return b_loc


def _permute_rows(mesh, b_loc, gperm, nb: int):
    """B ← B[gperm] on a row-distributed matrix (reference
    ``internal::permuteRows``): the column's rows gathered by a ``psum``
    along 'p' of the placed shard (JAX's ``all_gather``), then each rank
    takes its permuted rows."""
    p = mesh.p
    ml = b_loc.shape[0] // nb
    dev = b_loc.device
    grows = torch.as_tensor(local_grows(ml, nb, p, mesh.r), device=dev)
    full = torch.zeros((p * ml * nb, b_loc.shape[1]), dtype=b_loc.dtype,
                       device=dev)
    full[grows] = b_loc
    mesh.psum(full, AXIS_P)
    return full.index_select(0, gperm.index_select(0, grows))


def pgetrs(lu: DistMatrix, gperm, b: DistMatrix) -> DistMatrix:
    """Solve A·X = B from the distributed LU factor: row permutation, then
    unit-lower forward and upper backward substitution (reference
    ``src/getrs.cc``)."""
    if b.nb != lu.nb:
        raise ValueError("pgetrs requires matching tile sizes")
    if b.mtp != lu.mtp:
        raise ValueError("B row padding must match the factor "
                         "(distribute with row_mult=q)")
    nt = ceildiv(lu.n, lu.nb)
    gperm = torch.as_tensor(gperm, device=lu.device).long()
    pb = _permute_rows(lu.mesh, b.data, gperm, lu.nb)
    y = _plu_trsm(lu.mesh, lu.data, pb, lu.nb, nt, False)
    return like(b, _plu_trsm(lu.mesh, lu.data, y, lu.nb, nt, True))


def pgesv(a, b, mesh, nb: int = 256):
    """Distributed LU factor + solve (reference ``slate::gesv``): dense
    replicated operands are distributed block-cyclic first.  Returns
    ``(lu, gperm, x)`` with ``x`` a DistMatrix."""
    p, q = mesh_grid_shape(mesh)
    ad = a if isinstance(a, DistMatrix) else \
        distribute(a, mesh, nb, diag_pad=1.0, row_mult=q, col_mult=p)
    bd = b if isinstance(b, DistMatrix) else \
        distribute(b, mesh, nb, row_mult=q)
    lu, gperm = pgetrf(ad)
    return lu, gperm, pgetrs(lu, gperm, bd)


def pgesv_mixed(a, b, mesh, nb: int = 256, *, tol=None, itermax: int = 30,
                use_fallback: bool = True):
    """Distributed mixed-precision LU solve with iterative refinement
    (reference ``src/gesv_mixed.cc``): one low-precision :func:`pgetrf`,
    working-precision residuals through ``pgemm``, corrections solved
    against the low factor, the loop
    :func:`~slate_tpu_torch.linalg._refine.ir_refine_core` with its norms
    agreed over the grid.  Returns ``(x, iters)``, ``x`` a DistMatrix."""
    from ..linalg._refine import ir_refine_core
    from .dist_blas3 import pgemm
    from .dist_factor import _grid_absmax, _mixed_setup

    ad, b, mesh, anorm, thresh, lo = _mixed_setup(a, b, mesh, nb, tol)
    bd = distribute(b if b.ndim == 2 else b[:, None], mesh, ad.nb,
                    row_mult=mesh_grid_shape(mesh)[1])
    lu_lo, gperm = pgetrf(like(ad, ad.data.to(lo)))

    def solve_lo(rd):
        xc = pgetrs(lu_lo, gperm, like(rd, rd.data.to(lo)))
        return like(rd, xc.data.to(ad.dtype))

    def solve_full(bd2):
        lu_full, gperm_f = pgetrf(ad)
        return pgetrs(lu_full, gperm_f, bd2)

    def residual(x):
        # diag_pad keeps the padded rows of r at exact zero
        return like(bd, bd.data - pgemm(1.0, ad, x).data)

    return ir_refine_core(
        bd, solve_lo, solve_full, residual, anorm=anorm, thresh=thresh,
        itermax=itermax, use_fallback=use_fallback,
        add=lambda x, d: like(x, x.data + d.data), absmax=_grid_absmax)


def pgetri(a: DistMatrix) -> DistMatrix:
    """Distributed inverse from LU (reference ``src/getri.cc``): factor,
    then solve A·X = I against the identity each rank builds for itself
    (:func:`~.dist_util.peye`)."""
    lu, gperm = pgetrf(a)
    eye = peye(a.n, a.nb, a.mesh, dtype=a.dtype, pad_mult=a.mtp)
    if eye.mtp != lu.mtp:
        raise ValueError("identity padding mismatch")
    return pgetrs(lu, gperm, eye)


def pgecondest(lu: DistMatrix, gperm, anorm: float, iters: int = 5):
    """1-norm reciprocal condition estimate from a distributed LU factor
    (reference ``src/gecondest.cc``): Hager/Higham iterations on ‖A⁻¹‖₁
    with distributed solves, A through :func:`pgetrs` and Aᴴ through
    :func:`~.dist_aux.ptrsm`.  The estimate, the stopping test and the
    next unit vector are rank (0, 0)'s, agreed over the grid
    (``collective.condest_agree``).  Returns ``(rcond, est)``."""
    from ..enums import Diag, Op, Side, Uplo
    from .dist_aux import ptrsm

    n = lu.n
    q = lu.grid_shape[1]
    mesh = lu.mesh
    dev = lu.device
    gperm = torch.as_tensor(gperm, device=dev).long()
    M = lu.mtp * lu.nb
    gp = torch.arange(M, device=dev)
    gp[:n] = torch.argsort(gperm[:n])

    def solve_ah(xd):
        # Aᴴ z = x with A[gperm] = L·U: Aᴴ = Uᴴ·Lᴴ·P, so w = U⁻ᴴ x,
        # v = L⁻ᴴ w, z = Pᵀ v = v[argsort(gperm)]
        w = ptrsm(Side.Left, Uplo.Upper, Op.ConjTrans, Diag.NonUnit, lu, xd)
        v = ptrsm(Side.Left, Uplo.Lower, Op.ConjTrans, Diag.Unit, lu, w)
        return like(v, _permute_rows(mesh, v.data, gp, lu.nb))

    def dvec(x):
        return distribute(torch.as_tensor(x, dtype=lu.dtype, device=dev),
                          mesh, lu.nb, row_mult=q)

    x = np.full((n, 1), 1.0 / n)
    est = 0.0
    for _ in range(max(iters, 1)):
        y = undistribute(pgetrs(lu, gperm, dvec(x))).cpu().numpy()
        xi = np.sign(y) + (y == 0)
        z = undistribute(solve_ah(dvec(xi))).cpu().numpy()
        j = int(np.argmax(np.abs(z)))
        stop = np.abs(z).max() <= float(np.real((z.conj() * x).sum()))
        est, j, stop = agree_values(mesh, float(np.abs(y).sum()), j,
                                    float(stop), kind="condest_agree")
        if stop:
            break
        x = np.zeros((n, 1))
        x[int(j)] = 1.0
    rcond = 0.0 if est == 0 or anorm == 0 else 1.0 / (est * float(anorm))
    return rcond, est
