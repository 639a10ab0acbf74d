"""Distributed right-looking Cholesky and its triangular solves — the
counterpart of ``slate_tpu/parallel/dist_factor.py`` (``ppotrf``,
``ppotrs``, ``pposv``).

The lookahead-pipelined form of the JAX package, step for step: the
block column k arrives replicated through ONE fused broadcast
(:func:`~.dist_util.bcast_block_col`); every rank factors the (M, nb)
panel redundantly (the ``dist_panel`` site: ``torch.linalg`` solves, the
``chol_inv_panel`` kernel and a product, or one ``chol_l21_panel``
launch); a ring of D panels in flight carries the next columns, each
brought up to date with step k's rank-nb correction from replicated
operands alone, and the column k + D is broadcast before the trailing
update; the trailing update is one product over the stage's static
window (:func:`~.dist_util.staged_fori`).  Every product goes through
:func:`slate_tpu_torch.ops.blocks.matmul`, unless the ``matmul`` site
answers a split backend for fp32 at the local trailing shape (``trail``
∈ split3/split6, ``slate_tpu/parallel/dist_factor.py:60-160``): then the
replicated panel splits into its bf16 slices once a step and the ring
corrections, the lookahead column and the trailing update all read
windows of those slices (:func:`~slate_tpu_torch.ops.split_gemm.
matmul_sliced`).

Each rank runs this in its own process with its own (r, c); the
JAX package's masks on ``k % q == c`` are Python branches here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..grid import ceildiv
from ..ops import kernels
from ..ops.blocks import matmul as _mm
from ..ops.split_gemm import matmul_sliced, split_slices
from ..perf.autotune import choose_matmul
from .dist import DistMatrix, distribute, like
from .dist_util import (bcast_block_col, bcast_block_row,
                        dist_chunk_slices, dist_lookahead_depth,
                        dist_panel_backend, local_grows, stage_bounds,
                        staged_fori)
from .mesh import AXIS_P, mesh_grid_shape


def _ct(x):
    return x.mH


def _panel_factor(backend: str, d, panel):
    """(L₁₁, panel·L₁₁⁻ᴴ) of the replicated (M, nb) panel, whose diagonal
    block is ``d``: the redundant per-rank panel solve."""
    if backend == "pallas_fused":
        return kernels.chol_l21_panel(d, panel)
    if backend == "pallas_panel":
        lkk, linv = kernels.chol_inv_panel(d)
        return lkk, _mm(panel, linv.mT)
    l11 = torch.linalg.cholesky(d)
    return l11, torch.linalg.solve_triangular(_ct(l11), panel, upper=True,
                                              left=False)


def _ppotrf(mesh, a_loc, nb: int, nt: int, backend: str, depth: int,
            chunks: int, trail: str = "stock"):
    """The step loop on this rank's shard ``a_loc``, in place; ``trail``
    ``"split3"``/``"split6"`` folds every product of a step off one split
    of its replicated panel."""
    p, q = mesh_grid_shape(mesh)
    r, c = mesh.r, mesh.c
    ml, nl = a_loc.shape[0] // nb, a_loc.shape[1] // nb
    mtp = p * ml
    M = mtp * nb
    dev = a_loc.device
    grows_h = local_grows(ml, nb, p, r)
    grows = torch.as_tensor(grows_h, device=dev)
    depth = max(1, min(depth, nt))
    split = trail in ("split3", "split6")

    def getcol(k):
        return a_loc[:, (k // q) * nb:(k // q + 1) * nb]

    def make_body(row0, col0):
        jblk = np.arange(col0 // nb, nl) * q + c

        def body(k, ring):
            # ring[j]: the replicated panel of step k + j, updated through
            # step k − 1
            panel = ring[0]
            l11, w_full = _panel_factor(backend, panel[k * nb:(k + 1) * nb],
                                        panel)
            w_full[:(k + 1) * nb] = 0                     # L21 rows only
            w_rows = w_full.index_select(0, grows)
            if split:
                # LP-GEMM operand folding: the replicated panel splits
                # once; the split is elementwise, so it commutes with the
                # row gathers and windows below
                s_full = split_slices(w_full)
                s_rows = tuple(x.index_select(0, grows) for x in s_full)

                def block_t(blk):
                    return tuple(_ct(x[blk * nb:(blk + 1) * nb])
                                 for x in s_full)
            new_ring = []
            for j in range(1, depth):
                if k + j < nt:
                    if split:
                        corr = matmul_sliced(trail, s_full, block_t(k + j))
                    else:
                        wj = w_full[(k + j) * nb:(k + j + 1) * nb]
                        corr = _mm(w_full, _ct(wj))
                    new_ring.append(ring[j] - corr)
            kn = k + depth
            if kn < nt:
                # lookahead: column k + D with step k's correction,
                # broadcast before the trailing update
                own = kn % q == c
                coln = getcol(kn)[row0:]
                if own:
                    if split:
                        coln = coln - matmul_sliced(
                            trail, tuple(x[row0:] for x in s_rows),
                            block_t(kn))
                    else:
                        wn = w_full[kn * nb:(kn + 1) * nb]
                        coln = coln - _mm(w_rows[row0:], _ct(wn))
                new_ring.append(bcast_block_col(mesh, coln, grows_h[row0:],
                                                own, M, chunks))
            if k % q == c:
                # the factored column: L21 below block k, L11 on it
                lo = max(0, -(-(k - r) // p)) * nb
                col = getcol(k)
                col[lo:] = w_full.index_select(0, grows[lo:])
                if k % p == r:
                    col[(k // p) * nb:(k // p + 1) * nb] = l11
            live = torch.as_tensor(jblk[jblk > k], device=dev)
            if len(live):
                def cols(x):
                    out = torch.zeros((len(jblk), nb, nb), dtype=x.dtype,
                                      device=dev)
                    out[len(jblk) - len(live):] = x.view(
                        mtp, nb, nb).index_select(0, live)
                    return _ct(out.view(-1, nb))
                win = a_loc[row0:, col0:]
                if split:
                    win -= matmul_sliced(
                        trail, tuple(x[row0:] for x in s_rows),
                        tuple(cols(x) for x in s_full))
                else:
                    win -= _mm(w_rows[row0:], cols(w_full))
            return new_ring

        return body

    ring = [bcast_block_col(mesh, getcol(j), grows_h, j % q == c, M, chunks)
            for j in range(depth)]
    staged_fori(stage_bounds(nt), p, q, nb, make_body, ring)
    return a_loc


def _check_square(name: str, a: DistMatrix) -> None:
    if a.m != a.n:
        raise ValueError(f"{name} requires a square matrix, got {a.m}x{a.n}")
    if a.mtp != a.ntp:
        raise ValueError(f"{name} needs square padded storage "
                         "(distribute with row_mult=q, col_mult=p)")
    if a.row_nb != a.nb:
        raise ValueError(f"{name} needs square tiles (mb == nb)")


def ppotrf(a: DistMatrix) -> DistMatrix:
    """Distributed lower Cholesky of a block-cyclic HPD matrix: the factor
    in place of the lower triangle (the blocks above the diagonal keep
    junk, as the reference's stored-triangle semantics allow).
    Distribute the operand with ``diag_pad=1.0`` and ``row_mult=q,
    col_mult=p`` (see :func:`pposv`).  The ``dist_panel``,
    ``dist_lookahead`` and ``dist_chunk`` sites pick the panel solve, the
    ring depth and the broadcast slices."""
    _check_square("ppotrf", a)
    nt = ceildiv(a.n, a.nb)
    backend = dist_panel_backend("potrf", a.nb, a.dtype, a.device,
                                 m=a.mtp * a.nb)
    depth = dist_lookahead_depth("potrf", nt, a.nb, a.dtype, a.device)
    chunks = dist_chunk_slices("potrf", a.nb, a.dtype, a.mesh)
    # the trailing product rides the matmul site at the local trailing
    # shape, asked before the step loop so that a split backend can fold
    # a step's products off one split of its panel
    trail = "stock"
    if a.dtype == torch.float32:
        ml, nl = a.mtp // a.grid_shape[0], a.ntp // a.grid_shape[1]
        bk = choose_matmul((ml * a.nb, a.nb), (a.nb, nl * a.nb), a.dtype,
                           a.device)
        if bk in ("split3", "split6"):
            trail = bk
    return like(a, _ppotrf(a.mesh, a.data.clone(), a.nb, nt, backend,
                           depth, chunks, trail))


def _ptrsm(mesh, l_loc, b_loc, nb: int, nt: int, trans: bool, chunks: int):
    """Left lower solve L·X = B (``trans``: Lᴴ·X = B) on this rank's
    shards, in place on ``b_loc``: the factor's block column (block row
    for Lᴴ) arrives through one fused broadcast a step with the diagonal
    block riding along, and the next step's B block row is carried with
    its rank-nb correction from replicated operands."""
    p, q = mesh_grid_shape(mesh)
    r, c = mesh.r, mesh.c
    ml, nl = l_loc.shape[0] // nb, l_loc.shape[1] // nb
    M, N = p * ml * nb, q * nl * nb
    dev = l_loc.device
    grows_h = local_grows(ml, nb, p, r)
    grows = torch.as_tensor(grows_h, device=dev)
    gblk = grows_h // nb
    gcols_h = local_grows(nl, nb, q, c)
    iblk = torch.as_tensor(np.arange(ml) * p + r, device=dev)
    nrhs = b_loc.shape[1]

    def fetch_brow(k):
        blk = torch.zeros((nb, nrhs), dtype=b_loc.dtype, device=dev)
        if k % p == r:
            blk.copy_(b_loc[(k // p) * nb:(k // p + 1) * nb])
        return mesh.psum(blk, AXIS_P)

    def put_brow(k, x):
        if k % p == r:
            b_loc[(k // p) * nb:(k // p + 1) * nb] = x

    def rowmask(keep):
        return torch.as_tensor(keep, device=dev).to(b_loc.dtype)[:, None]

    if not trans:
        bk = fetch_brow(0)
        for k in range(nt):
            col = l_loc[:, (k // q) * nb:(k // q + 1) * nb]
            lcol = bcast_block_col(mesh, col, grows_h, k % q == c, M, chunks)
            x = torch.linalg.solve_triangular(lcol[k * nb:(k + 1) * nb], bk,
                                              upper=False)
            put_brow(k, x)
            if k + 1 < nt:
                bk = fetch_brow(k + 1) - _mm(lcol[(k + 1) * nb:(k + 2) * nb], x)
            lmine = lcol.index_select(0, grows) * rowmask(gblk > k)
            b_loc -= _mm(lmine, x)
        return b_loc
    bk = fetch_brow(nt - 1)
    for t in range(nt):
        k = nt - 1 - t
        row = l_loc[(k // p) * nb:(k // p + 1) * nb]
        lrow = bcast_block_row(mesh, row, gcols_h, k % p == r, N, chunks)
        x = torch.linalg.solve_triangular(_ct(lrow[:, k * nb:(k + 1) * nb]), bk,
                                          upper=True)
        put_brow(k, x)
        if k > 0:
            bk = fetch_brow(k - 1) - _mm(_ct(lrow[:, (k - 1) * nb:k * nb]), x)
        sel = lrow.view(nb, N // nb, nb).index_select(1, iblk)
        mmat = sel.permute(1, 2, 0).conj().reshape(ml * nb, nb)
        b_loc -= _mm(mmat * rowmask(gblk < k), x)
    return b_loc


def ppotrs(l: DistMatrix, b: DistMatrix) -> DistMatrix:
    """Solve A·X = B from the distributed Cholesky factor: forward, then
    adjoint back substitution (reference ``src/potrs.cc``)."""
    if b.nb != l.nb:
        raise ValueError("ppotrs requires matching tile sizes")
    if l.mesh is not b.mesh:
        raise ValueError("ppotrs operands must live on the same mesh")
    if b.m != l.n:
        raise ValueError(f"B has {b.m} rows but the factor is {l.n}x{l.n}")
    if b.mtp != l.mtp:
        raise ValueError("B row padding must match the factor "
                         "(distribute with row_mult=q)")
    nt = ceildiv(l.n, l.nb)
    chunks = dist_chunk_slices("trsm", l.nb, l.dtype, l.mesh)
    y = _ptrsm(l.mesh, l.data, b.data.clone(), l.nb, nt, False, chunks)
    return like(b, _ptrsm(l.mesh, l.data, y, l.nb, nt, True, chunks))


def pposv(a, b, mesh, nb: int = 256):
    """Distributed factor + solve (reference ``slate::posv``): dense
    replicated operands are distributed block-cyclic first.  Returns
    ``(l_factor, x)`` as DistMatrices."""
    p, q = mesh_grid_shape(mesh)
    ad = a if isinstance(a, DistMatrix) else \
        distribute(a, mesh, nb, diag_pad=1.0, row_mult=q, col_mult=p)
    bd = b if isinstance(b, DistMatrix) else \
        distribute(b, mesh, nb, row_mult=q)
    l = ppotrf(ad)
    return l, ppotrs(l, bd)
