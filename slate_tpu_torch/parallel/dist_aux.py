"""Distributed norms, rank-k updates, triangular multiplies and solves —
the counterpart of ``slate_tpu/parallel/dist_aux.py`` (reference
``src/norm.cc``, ``colNorms.cc``, ``herk.cc``, ``syrk.cc``, ``her2k.cc``,
``syr2k.cc``, ``trmm.cc``, ``hemm.cc``, ``trsm.cc``).

Local partials are masked to the true (unpadded) region and reduced with
:meth:`~.mesh.Mesh.psum` (sums) and :meth:`~.mesh.Mesh.pmax` (maxima,
real values only: ``torch.distributed`` has no complex maximum).  The
rank-k updates broadcast A's block column with one ``psum`` over both
axes of its placed rows (:func:`~.dist_util.bcast_block_col`) and index
B's rows by global block, where the JAX package takes a ``psum`` along
'q' and an ``all_gather`` along 'p'.  The products go through
:func:`slate_tpu_torch.ops.blocks.matmul`, so fp32 128-aligned ones reach
the ``matmul`` kernel on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..enums import Diag, Norm, Op, Side, Uplo
from ..grid import ceildiv
from ..ops.blocks import matmul as _mm
from .dist import DistMatrix, like
from .dist_util import bcast_block_col, local_grows
from .mesh import AXIS_P, AXIS_Q, BOTH


def index_maps(a: DistMatrix):
    """(global rows, global columns) of this rank's shard, on its device
    (square tiles)."""
    if a.row_nb != a.nb:
        raise ValueError("needs square tiles (mb == nb)")
    p, q = a.grid_shape
    nb, dev = a.nb, a.device
    ml, nl = a.mtp // p, a.ntp // q
    return (torch.as_tensor(local_grows(ml, nb, p, a.mesh.r), device=dev),
            torch.as_tensor(local_grows(nl, nb, q, a.mesh.c), device=dev))


_NORM_KEY = {Norm.Max: "max", Norm.One: "one", Norm.Inf: "inf",
             Norm.Fro: "fro"}


def pnorm(a: DistMatrix, norm: Norm = Norm.Fro):
    """Distributed matrix norm (reference ``slate::norm``,
    ``src/norm.cc``): max, one, inf or fro over the true m×n region; the
    padding, a ``diag_pad`` identity included, is masked out.  A 0-d
    tensor of the real dtype, the same on every rank."""
    which = _NORM_KEY[norm]
    mesh = a.mesh
    grows, gcols = index_maps(a)
    valid = (grows < a.m)[:, None] & (gcols < a.n)[None, :]
    absa = a.data.abs() * valid
    if which == "max":
        v = absa.max().reshape(1)
        return mesh.pmax(v, BOTH)[0]
    if which == "one":
        colsums = mesh.psum(absa.sum(dim=0), AXIS_P)
        return mesh.pmax(colsums.max().reshape(1), BOTH)[0]
    if which == "inf":
        rowsums = mesh.psum(absa.sum(dim=1), AXIS_Q)
        return mesh.pmax(rowsums.max().reshape(1), BOTH)[0]
    return mesh.psum((absa * absa).sum().reshape(1), BOTH)[0].sqrt()


def pcolnorms(a: DistMatrix):
    """Per-column max-abs norms, replicated, of length n (reference
    ``slate::colNorms``, ``src/colNorms.cc``): local column maxima, a
    ``pmax`` down the grid rows, then a ``psum`` across the grid columns
    of each rank's columns placed at their global offsets."""
    mesh = a.mesh
    grows, gcols = index_maps(a)
    valid = (grows < a.m)[:, None] & (gcols < a.n)[None, :]
    mag = a.data.abs() * valid
    colmax = mesh.pmax(mag.max(dim=0).values, AXIS_P)
    full = torch.zeros((a.ntp * a.nb,), dtype=colmax.dtype, device=a.device)
    full[gcols] = colmax
    return mesh.psum(full, AXIS_Q)[:a.n]


def _pgemm_nt(alpha, a: DistMatrix, b: DistMatrix, beta, c: DistMatrix,
              conj: bool, same_operand: bool = False) -> DistMatrix:
    """C ← α·A·op(B)ᵀ + β·C for A and B sharing one row distribution (the
    herk/her2k shape, both m×k over the grid rows); ``op`` is the
    conjugate for the Hermitian forms (``conj``), the identity for the
    symmetric ones.  A step k: A's block column k replicated by one
    ``psum`` over both axes of its placed rows; this rank's rows of it
    times the rows of B's block column k at the global blocks of this
    rank's C columns (``same_operand``: B is A, and its column is A's).
    ``slate_tpu/parallel/dist_aux.py:86-133``."""
    mesh = a.mesh
    p, q = a.grid_shape
    nb, dev = a.nb, a.device
    ml, nl = a.mtp // p, c.ntp // q
    M = a.mtp * nb
    grows_h = local_grows(ml, nb, p, mesh.r)
    grows = torch.as_tensor(grows_h, device=dev)
    jblk = torch.as_tensor(np.arange(nl) * q + mesh.c, device=dev)
    acc = torch.zeros_like(c.data)
    for k in range(a.ntp):
        own = k % q == mesh.c
        acol = bcast_block_col(
            mesh, a.data[:, (k // q) * nb:(k // q + 1) * nb], grows_h, own, M)
        bcol = acol if same_operand else bcast_block_col(
            mesh, b.data[:, (k // q) * nb:(k // q + 1) * nb], grows_h, own, M)
        rows = bcol.view(a.mtp, nb, nb).index_select(0, jblk)
        if conj:
            rows = rows.conj()
        right = rows.permute(2, 0, 1).reshape(nb, nl * nb)
        acc += _mm(acol.index_select(0, grows), right)
    return like(c, alpha * acc + beta * c.data)


def _rank_update_c(a: DistMatrix, c, beta):
    """(C, β): a zero C made sharded, each rank its own shard (β = 0),
    where none is given; C's padding must be square and match A's rows."""
    p, q = a.grid_shape
    if c is None:
        if (a.mtp * a.nb) % (q * a.nb):
            raise ValueError("C padding must be square and match A's rows "
                             "(distribute A with row_mult=q)")
        data = torch.zeros((a.mtp * a.nb // p, a.mtp * a.nb // q),
                           dtype=a.dtype, device=a.device)
        c = DistMatrix(data, a.m, a.m, a.nb, a.mesh)
        beta = 0.0
    if c.mtp != a.mtp or c.ntp != a.mtp:
        raise ValueError("C padding must be square and match A's rows "
                         "(distribute A with row_mult=q, C with both mults)")
    return c, beta


def _check_nt_operands(a: DistMatrix, b: DistMatrix) -> None:
    if a.mesh is not b.mesh:
        raise ValueError("A and B must live on the same mesh")
    if (a.m, a.n) != (b.m, b.n) or a.dtype != b.dtype:
        raise ValueError(f"A ({a.m}x{a.n} {a.dtype}) and B ({b.m}x{b.n} "
                         f"{b.dtype}) must match in shape and dtype")
    if (a.mtp, a.ntp, a.nb) != (b.mtp, b.ntp, b.nb):
        raise ValueError("A and B must be distributed identically")


def pherk(alpha, a: DistMatrix, beta=0.0, c: DistMatrix = None):
    """C ← α·A·Aᴴ + β·C distributed (reference ``slate::herk``,
    ``src/herk.cc``); the full result is stored, both triangles."""
    c, beta = _rank_update_c(a, c, beta)
    return _pgemm_nt(alpha, a, a, beta, c, True, same_operand=True)


def psyrk(alpha, a: DistMatrix, beta=0.0, c: DistMatrix = None):
    """C ← α·A·Aᵀ + β·C distributed (reference ``slate::syrk``)."""
    c, beta = _rank_update_c(a, c, beta)
    return _pgemm_nt(alpha, a, a, beta, c, False, same_operand=True)


def pher2k(alpha, a: DistMatrix, b: DistMatrix, beta=0.0,
           c: DistMatrix = None):
    """C ← α·A·Bᴴ + ᾱ·B·Aᴴ + β·C distributed (reference ``slate::her2k``,
    ``src/her2k.cc``): two sweeps of :func:`_pgemm_nt`.  A and B must
    share shape and distribution."""
    _check_nt_operands(a, b)
    c, beta = _rank_update_c(a, c, beta)
    c1 = _pgemm_nt(alpha, a, b, beta, c, True)
    return _pgemm_nt(np.conj(alpha), b, a, 1.0, c1, True)


def psyr2k(alpha, a: DistMatrix, b: DistMatrix, beta=0.0,
           c: DistMatrix = None):
    """C ← α·A·Bᵀ + α·B·Aᵀ + β·C distributed (reference ``slate::syr2k``)."""
    _check_nt_operands(a, b)
    c, beta = _rank_update_c(a, c, beta)
    c1 = _pgemm_nt(alpha, a, b, beta, c, False)
    return _pgemm_nt(alpha, b, a, 1.0, c1, False)


def ptri_mask(a: DistMatrix, uplo: Uplo, diag: Diag = Diag.NonUnit
              ) -> DistMatrix:
    """Keep only the ``uplo`` triangle of a distributed square matrix (its
    diagonal written 1 within the true n for ``Diag.Unit``): a local
    pass over the block-cyclic index maps, nothing communicated."""
    grows, gcols = index_maps(a)
    gi, gj = grows[:, None], gcols[None, :]
    keep = (gi >= gj) if uplo is Uplo.Lower else (gi <= gj)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    out = torch.where(keep, a.data, zero)
    if diag is Diag.Unit:
        out = torch.where((gi == gj) & (gi < a.n),
                          torch.ones((), dtype=a.dtype, device=a.device), out)
    return like(a, out)


def ptrmm(uplo: Uplo, diag: Diag, a: DistMatrix, b: DistMatrix,
          alpha=1.0) -> DistMatrix:
    """B ← α·A·B with A the ``uplo`` triangle (reference ``slate::trmm``,
    ``src/trmm.cc``): the triangle masked (:func:`ptri_mask`), then the
    SUMMA product, as the JAX package does."""
    from .dist_blas3 import pgemm

    return pgemm(alpha, ptri_mask(a, uplo, diag), b)


def phemm(alpha, a: DistMatrix, b: DistMatrix, beta=0.0,
          c: DistMatrix = None) -> DistMatrix:
    """C ← α·A·B + β·C with Hermitian A stored whole (reference
    ``slate::hemm``, ``src/hemm.cc``): the SUMMA product, which does the
    reference's flops (it too multiplies both triangles)."""
    from .dist_blas3 import pgemm

    if a.m != a.n:
        raise ValueError("phemm: A must be square")
    if c is not None:
        return pgemm(alpha, a, b, beta, c)
    return pgemm(alpha, a, b)


def psymm(alpha, a: DistMatrix, b: DistMatrix, beta=0.0,
          c: DistMatrix = None) -> DistMatrix:
    """C ← α·A·B + β·C with symmetric A (reference ``slate::symm``); see
    :func:`phemm`."""
    return phemm(alpha, a, b, beta, c)


def ptrsm(side: Side, uplo: Uplo, op: Op, diag: Diag,
          a: DistMatrix, b: DistMatrix) -> DistMatrix:
    """Distributed triangular solve op(A)·X = B (Left) or X·op(A) = B
    (Right), reference ``slate::trsm`` (``src/trsm.cc``), every
    side/uplo/op/diag combination: the Right side and the transposed
    operators reduce to the four Left NoTrans sweeps through
    :func:`~.dist_util.ptranspose`, as in
    ``slate_tpu/parallel/dist_aux.py:290-348``.  Lower NonUnit (and its
    ConjTrans, with no transpose) is the Cholesky solve's sweep
    (:func:`~.dist_factor._ptrsm`), the other three the LU solves'
    (:func:`~.dist_lu._plu_trsm`)."""
    from .dist_factor import _ptrsm as _chol_trsm
    from .dist_lu import _plu_trsm
    from .dist_util import ptranspose

    if side is not Side.Left:
        # X·op(A) = B  ⟺  op(A)ᵀ·Xᵀ = Bᵀ
        if op is Op.NoTrans:
            a2, op2 = ptranspose(a), Op.NoTrans
            uplo2 = Uplo.Upper if uplo is Uplo.Lower else Uplo.Lower
        elif op is Op.Trans:
            a2, op2, uplo2 = a, Op.NoTrans, uplo
        else:       # ConjTrans: op(A)ᵀ = conj(A), the same layout
            a2 = like(a, a.data.conj().resolve_conj())
            op2, uplo2 = Op.NoTrans, uplo
        xt = ptrsm(Side.Left, uplo2, op2, diag, a2, ptranspose(b))
        return ptranspose(xt)
    nt = ceildiv(a.n, a.nb)
    native = (uplo, op, diag) == (Uplo.Lower, Op.ConjTrans, Diag.NonUnit)
    if op is not Op.NoTrans and not native:
        # op(A)·X = B with op(A) made once
        a = ptranspose(a, conj=op is Op.ConjTrans)
        uplo = Uplo.Upper if uplo is Uplo.Lower else Uplo.Lower
    if b.nb != a.nb or b.mtp != a.mtp:
        raise ValueError("B tiling must match A (distribute with "
                         "row_mult=q)")
    x = b.data.clone()
    if native:
        # the backward Lᴴ sweep of potrs, with no transpose
        return like(b, _chol_trsm(a.mesh, a.data, x, a.nb, nt, True, 1))
    if uplo is Uplo.Lower and diag is Diag.NonUnit:
        x = _chol_trsm(a.mesh, a.data, x, a.nb, nt, False, 1)
    else:
        x = _plu_trsm(a.mesh, a.data, x, a.nb, nt, uplo is Uplo.Upper,
                      unit=diag is Diag.Unit)
    return like(b, x)
