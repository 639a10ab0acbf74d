"""Distributed BLAS-3: SUMMA gemm over the ('p', 'q') grid — the
counterpart of ``slate_tpu/parallel/dist_blas3.py``.

Each SUMMA step broadcasts A's block column k along the grid rows and B's
block row k along the grid columns, each as one ``psum`` of the owner's
panel (zeros elsewhere), and adds their product to the local block of C
through :func:`slate_tpu_torch.ops.blocks.matmul`, so the products reach
the ``matmul`` kernel on the card.  The A-stationary layout
(:func:`pgemm_a`) gathers the narrow B with a ``psum`` of its placed
shard in place of JAX's ``all_gather``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..grid import ceildiv
from ..ops.blocks import matmul as _mm
from .dist import DistMatrix, _natural, _storage, like
from .mesh import AXIS_P, AXIS_Q, mesh_grid_shape


def _zeros_c(a: DistMatrix, b: DistMatrix) -> DistMatrix:
    p, q = a.grid_shape
    data = torch.zeros((a.data.shape[0], b.ntp // q * b.nb), dtype=a.dtype,
                       device=a.device)
    return DistMatrix(data, a.m, b.n, b.nb, a.mesh,
                      mb=a.row_nb if a.row_nb != b.nb else None)


def _check_inner(name: str, a: DistMatrix, b: DistMatrix) -> None:
    if a.n != b.m:
        raise ValueError(f"inner dimensions differ: A is {a.m}x{a.n}, "
                         f"B is {b.m}x{b.n}")
    if a.nb != b.row_nb:
        raise ValueError(f"{name} requires A's column tiles to match B's "
                         f"row tiles, got {a.nb} vs {b.row_nb}")
    if a.mesh is not b.mesh:
        raise ValueError(f"{name} operands must live on the same mesh")
    if a.ntp != b.mtp:
        raise ValueError(
            f"inner padded tile counts differ: {a.ntp} vs {b.mtp}; "
            "distribute A with col_mult=p and B with row_mult=q "
            "(or use pgemm_auto)")


def _summa(alpha, a: DistMatrix, b: DistMatrix, beta, c: DistMatrix):
    mesh = a.mesh
    p, q = mesh_grid_shape(mesh)
    r, cc = mesh.r, mesh.c
    kb = a.nb
    a_loc, b_loc = a.data, b.data
    acc = torch.zeros_like(c.data)
    for k in range(a.ntp):
        a_col = torch.zeros((a_loc.shape[0], kb), dtype=a.dtype,
                            device=a.device)
        if k % q == cc:
            a_col.copy_(a_loc[:, (k // q) * kb:(k // q + 1) * kb])
        mesh.psum(a_col, AXIS_Q)
        b_row = torch.zeros((kb, b_loc.shape[1]), dtype=b.dtype,
                            device=b.device)
        if k % p == r:
            b_row.copy_(b_loc[(k // p) * kb:(k // p + 1) * kb])
        mesh.psum(b_row, AXIS_P)
        acc += _mm(a_col, b_row)
    return alpha * acc + beta * c.data


def pgemm_auto(alpha, a, b, mesh, nb: int = 256) -> DistMatrix:
    """Distribute dense operands with matching inner padding and multiply
    (A's column tiles padded to a multiple of p, B's row tiles of q)."""
    from .dist import distribute

    p, q = mesh_grid_shape(mesh)
    da = distribute(a, mesh, nb, col_mult=p)
    db = distribute(b, mesh, nb, row_mult=q)
    return pgemm(alpha, da, db)


def pgemm(alpha, a: DistMatrix, b: DistMatrix, beta=0.0,
          c: DistMatrix = None, method: str = "auto") -> DistMatrix:
    """C ← α·A·B + β·C, all operands block-cyclic on the same mesh.
    ``method`` ∈ {"auto", "A", "C"} picks the stationary operand
    (:func:`select_pgemm`): "A" is :func:`pgemm_a`, "C" SUMMA."""
    if select_pgemm(a, b, method) == "A":
        return pgemm_a(alpha, a, b, beta, c)
    _check_inner("pgemm", a, b)
    if c is None:
        c = _zeros_c(a, b)
    return like(c, _summa(alpha, a, b, beta, c))


def pgemm_a(alpha, a: DistMatrix, b: DistMatrix, beta=0.0,
            c: DistMatrix = None) -> DistMatrix:
    """C ← α·A·B + β·C with the A-stationary layout (reference
    ``slate::gemmA``): A never moves; the narrow B is gathered onto every
    rank, each rank multiplies its resident A tiles by the matching B
    block rows, and the partial C blocks are summed along the grid rows'
    k-partition (one ``psum`` of the narrow C)."""
    _check_inner("pgemm_a", a, b)
    mesh = a.mesh
    p, q = a.grid_shape
    if c is None:
        c = _zeros_c(a, b)
    kb = a.nb
    # B in natural order on every rank (a psum of the placed shard)
    b_full = _natural(b, _storage(b), b.mtp * kb, b.ntp * b.nb)
    kal = a.data.shape[1]
    blocks = np.arange(kal // kb) * q + mesh.c
    sel = torch.as_tensor((blocks[:, None] * kb + np.arange(kb)).reshape(-1),
                          device=a.device)
    part = _mm(a.data, b_full.index_select(0, sel).contiguous())
    csum = mesh.psum(part, AXIS_Q)
    ntc_loc = c.ntp // q
    cb = np.arange(ntc_loc) * q + mesh.c
    cidx = torch.as_tensor((cb[:, None] * c.nb + np.arange(c.nb)).reshape(-1),
                           device=a.device)
    return like(c, alpha * csum.index_select(1, cidx) + beta * c.data)


def select_pgemm(a: DistMatrix, b: DistMatrix, method: str = "auto"):
    """A-stationary ("A") when B has a single column tile and pgemm_a's
    distribution preconditions hold, SUMMA ("C") otherwise, as
    ``MethodGemm::select_algo`` (``method.hh:77-126``)."""
    if method == "auto":
        ntb = ceildiv(b.n, b.nb) if b.n else 1
        if ntb < 2 and a.nb == b.row_nb and a.ntp == b.mtp:
            return "A"
        return "C"
    return method
