"""Block-cyclic distributed matrices over a :class:`~.mesh.Mesh` — the
counterpart of ``slate_tpu/parallel/dist.py``.

The layout is the JAX package's: an mt×nt tile grid padded so each grid
row owns as many tile rows as the others, tiles stored in
*cyclic-shuffled order* (:func:`slate_tpu_torch.grid.cyclic_permutation`)
so that grid position (r, c) owns one contiguous block of the storage,
exactly the tiles ``{(i, j) : i % p == r, j % q == c}``.  A
:class:`DistMatrix` holds that block — this rank's local shard — as a
tensor on the mesh's device; local row block ``il`` on grid row ``r`` is
global block ``il·p + r``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from ..grid import (ceildiv, cyclic_permutation, inverse_permutation,
                    map_permutation)
from .mesh import BOTH, Mesh, mesh_grid_shape


@dataclasses.dataclass(eq=False)
class DistMatrix:
    """An m×n matrix stored padded, cyclic-shuffled and split over a mesh.

    ``data`` is THIS rank's shard, (mtp/p·row_nb, ntp/q·nb), on the
    mesh's device.  ``mb`` is the row tile size (None: ``nb``); the
    factorizations and solves need mb == nb, pgemm takes rectangular
    tiles.  ``row_map`` / ``col_map`` are user tile maps (global block →
    grid coordinate, separable per axis); None is the block-cyclic
    default, and the drivers re-grid a mapped operand to it first
    (:func:`canonicalize`)."""

    data: torch.Tensor
    m: int
    n: int
    nb: int
    mesh: Mesh
    mb: Optional[int] = None
    row_map: Optional[object] = None
    col_map: Optional[object] = None

    @property
    def row_nb(self) -> int:
        return self.nb if self.mb is None else self.mb

    @property
    def grid_shape(self):
        return mesh_grid_shape(self.mesh)

    @property
    def mtp(self) -> int:
        return self.data.shape[0] * self.mesh.p // self.row_nb

    @property
    def ntp(self) -> int:
        return self.data.shape[1] * self.mesh.q // self.nb

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    def __repr__(self):
        p, q = self.grid_shape
        tile = (f"nb={self.nb}" if self.mb is None
                else f"mb={self.mb}, nb={self.nb}")
        return (f"DistMatrix({self.m}x{self.n}, {tile}, grid={p}x{q}, "
                f"padded=({self.mtp * self.row_nb}, {self.ntp * self.nb}), "
                f"local={tuple(self.data.shape)}, dtype={self.dtype})")


def padded_tiles(m: int, nb: int, p: int) -> int:
    """Tile count of m padded so every grid row owns equally many tiles."""
    return ceildiv(ceildiv(m, nb), p) * p


def _storage_perm(ntp: int, p: int, block_map) -> np.ndarray:
    if block_map is None:
        return cyclic_permutation(ntp, p)
    return map_permutation(ntp, p, block_map)


def _expand(blocks: np.ndarray, bs: int) -> np.ndarray:
    """Element indices of the size-``bs`` blocks ``blocks``."""
    return (blocks[:, None] * bs + np.arange(bs)).reshape(-1)


def local_indices(ntp: int, nranks: int, coord: int, bs: int,
                  block_map=None) -> np.ndarray:
    """Global element indices, in local order, of the rows (or columns)
    grid coordinate ``coord`` of ``nranks`` stores along an axis of
    ``ntp`` tiles of ``bs``.  Ascending within the coordinate."""
    nloc = ntp // nranks
    perm = _storage_perm(ntp, nranks, block_map)
    return _expand(perm[coord * nloc:(coord + 1) * nloc], bs)


def _take(a, rows: np.ndarray, cols: np.ndarray, m: int, n: int, out):
    """``out[i, j] = a[rows[i], cols[j]]`` where both lie in the m×n
    operand; the indices ascend, so those that do form a prefix."""
    nr = int(np.searchsorted(rows, m))
    nc = int(np.searchsorted(cols, n))
    if nr and nc:
        dev = out.device
        sub = a.index_select(0, torch.as_tensor(rows[:nr], device=dev))
        out[:nr, :nc] = sub.index_select(
            1, torch.as_tensor(cols[:nc], device=dev))
    return out


def distribute(a, mesh: Mesh, nb: int = 256, diag_pad: float = 0.0,
               row_mult: Optional[int] = None, col_mult: Optional[int] = None,
               mb: Optional[int] = None, row_map=None,
               col_map=None) -> DistMatrix:
    """This rank's shard of the replicated dense (m, n) ``a`` (numpy or a
    tensor; placed on the mesh's device), laid out as the JAX package's
    :func:`distribute` lays it out (``slate_tpu/parallel/dist.py:124-156``):
    padded to full tiles (zeros; ``diag_pad`` on the padded diagonal, so
    factorizations of blkdiag(A, I) extend A's), the tile counts padded
    to multiples of p (rows) and q (columns) — of lcm(p, row_mult) and
    lcm(q, col_mult) where given — and shuffled.  Each rank keeps its own
    residue-class blocks; nothing is communicated."""
    a = torch.as_tensor(a, device=mesh.device)
    m, n = a.shape
    p, q = mesh_grid_shape(mesh)
    rb = nb if mb is None else mb
    mtp = padded_tiles(m, rb, math.lcm(p, row_mult) if row_mult else p)
    ntp = padded_tiles(n, nb, math.lcm(q, col_mult) if col_mult else q)
    rows = local_indices(mtp, p, mesh.r, rb, row_map)
    cols = local_indices(ntp, q, mesh.c, nb, col_map)
    out = _take(a, rows, cols, m, n, torch.zeros(
        (len(rows), len(cols)), dtype=a.dtype, device=mesh.device))
    mp, np_ = mtp * rb, ntp * nb
    if diag_pad != 0.0 and mp > m and np_ > n:
        k = min(mp - m, np_ - n)
        where = np.full(np_, -1)
        where[cols] = np.arange(len(cols))
        i = np.nonzero((rows >= m) & (rows < m + k))[0]
        j = where[rows[i] - m + n]
        i, j = i[j >= 0], j[j >= 0]
        if len(i):
            out[torch.as_tensor(i, device=out.device),
                torch.as_tensor(j, device=out.device)] = diag_pad
    return DistMatrix(out, m, n, nb, mesh, mb=mb, row_map=row_map,
                      col_map=col_map)


def _storage(dm: DistMatrix):
    """The whole padded, shuffled storage on every rank: each rank's
    shard placed in a zero buffer, then one ``psum`` over both axes."""
    p, q = dm.grid_shape
    h, w = dm.data.shape
    full = torch.zeros((h * p, w * q), dtype=dm.dtype, device=dm.device)
    full[dm.mesh.r * h:(dm.mesh.r + 1) * h,
         dm.mesh.c * w:(dm.mesh.c + 1) * w] = dm.data
    return dm.mesh.psum(full, BOTH)


def _natural(dm: DistMatrix, full, m: int, n: int):
    """Rows [0, m) and columns [0, n) of the storage ``full`` in natural
    (unshuffled) order."""
    p, q = dm.grid_shape
    rb, nb = dm.row_nb, dm.nb
    rinv = inverse_permutation(_storage_perm(dm.mtp, p, dm.row_map))
    cinv = inverse_permutation(_storage_perm(dm.ntp, q, dm.col_map))
    g = np.arange(m)
    srow = rinv[g // rb] * rb + g % rb
    g = np.arange(n)
    scol = cinv[g // nb] * nb + g % nb
    dev = full.device
    return full.index_select(0, torch.as_tensor(srow, device=dev)) \
        .index_select(1, torch.as_tensor(scol, device=dev))


def undistribute(dm: DistMatrix):
    """The replicated dense (m, n) matrix, on every rank (inverse of
    :func:`distribute`): one ``psum`` of the placed shard, then the
    inverse shuffle."""
    return _natural(dm, _storage(dm), dm.m, dm.n)


def canonicalize(dm: DistMatrix) -> DistMatrix:
    """Re-grid a user-mapped DistMatrix into the block-cyclic layout every
    driver's local↔global index arithmetic assumes (the padded storage
    rides along whole, diagonal padding included).  One ``psum`` of the
    placed shard, then each rank keeps its canonical blocks."""
    if dm.row_map is None and dm.col_map is None:
        return dm
    p, q = dm.grid_shape
    nat = _natural(dm, _storage(dm), dm.mtp * dm.row_nb, dm.ntp * dm.nb)
    rows = local_indices(dm.mtp, p, dm.mesh.r, dm.row_nb)
    cols = local_indices(dm.ntp, q, dm.mesh.c, dm.nb)
    out = _take(nat, rows, cols, nat.shape[0], nat.shape[1],
                torch.empty(dm.data.shape, dtype=dm.dtype, device=dm.device))
    return DistMatrix(out, dm.m, dm.n, dm.nb, dm.mesh, mb=dm.mb)


def canonical_args(fn):
    """Driver-ingestion wrapper: re-grid every user-tile-mapped
    DistMatrix operand to the block-cyclic layout (:func:`canonicalize`)
    before the driver sees it; a no-op for canonical operands."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        args = tuple(canonicalize(x) if isinstance(x, DistMatrix) else x
                     for x in args)
        kwargs = {k: (canonicalize(v) if isinstance(v, DistMatrix) else v)
                  for k, v in kwargs.items()}
        return fn(*args, **kwargs)

    wrapper.__wrapped_driver__ = fn
    return wrapper


def like(dm: DistMatrix, data, m: Optional[int] = None,
         n: Optional[int] = None) -> DistMatrix:
    return DistMatrix(data, dm.m if m is None else m,
                      dm.n if n is None else n, dm.nb, dm.mesh, mb=dm.mb,
                      row_map=dm.row_map, col_map=dm.col_map)
