"""Matrix class hierarchy over torch tensors — the counterpart of
``slate_tpu/matrix.py`` (reference ``BaseMatrix.hh`` and its typed
headers).

Storage is one dense 2-D tensor on one device; what survives of the
reference's tile storage is the view algebra (``op``, ``transpose``,
``tile``) and the (mb, nb) blocking metadata that steers the drivers.

Placement: a constructor puts numpy data, and tensors on the host, on
``cuda`` unless the caller passes ``device=`` (the tests pass
``device="cpu"``).  A tensor already on the card stays where it is.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import resolve_device
from .enums import Diag, Op, Uplo
from .grid import ProcessGrid, ceildiv


def to_tensor(data, device=None) -> torch.Tensor:
    """``data`` as a tensor on the entry-point device (see module doc)."""
    if isinstance(data, torch.Tensor) and device is None \
            and data.device.type == "cuda":
        return data
    dev = resolve_device(device)
    if isinstance(data, torch.Tensor):
        return data.to(dev)
    return torch.tensor(np.asarray(data), device=dev)


def _resolve_op(data, op: Op):
    if op is Op.NoTrans:
        return data
    if op is Op.Trans:
        return data.mT
    return data.mH


class BaseMatrix:
    """A logical (op-tagged) view over a dense 2-D tensor.

    ``data`` is in storage orientation; :attr:`array` applies the op.
    ``mb``/``nb`` steer algorithm blocking.
    """

    uplo: Uplo = Uplo.General

    def __init__(self, data, mb: int = 256, nb: int = 256,
                 op: Op = Op.NoTrans, grid: Optional[ProcessGrid] = None,
                 device=None):
        self.data = to_tensor(data, device)
        self.mb = int(mb)
        self.nb = int(nb)
        self.op = op
        self.grid = grid

    @property
    def m(self) -> int:
        return self.data.shape[-1] if self.op is not Op.NoTrans \
            else self.data.shape[-2]

    @property
    def n(self) -> int:
        return self.data.shape[-2] if self.op is not Op.NoTrans \
            else self.data.shape[-1]

    @property
    def mt(self) -> int:
        return ceildiv(self.m, self.mb)

    @property
    def nt(self) -> int:
        return ceildiv(self.n, self.nb)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def array(self):
        """The dense tensor with the pending op applied (a view)."""
        return _resolve_op(self.data, self.op)

    def tile_mb(self, i: int) -> int:
        return min(self.mb, self.m - i * self.mb)

    def tile_nb(self, j: int) -> int:
        return min(self.nb, self.n - j * self.nb)

    def tile(self, i: int, j: int):
        """Tile (i, j) of the logical matrix (a view of the storage)."""
        if self.op is Op.NoTrans:
            return self.data[i * self.mb:i * self.mb + self.tile_mb(i),
                             j * self.nb:j * self.nb + self.tile_nb(j)]
        t = self.data[j * self.nb:j * self.nb + self.tile_nb(j),
                      i * self.mb:i * self.mb + self.tile_mb(i)]
        return _resolve_op(t, self.op)

    def _like(self, data, **kw):
        """Same class and metadata over new ``data`` (no re-placement)."""
        obj = type(self).__new__(type(self))
        obj.data = data
        obj.mb = kw.get("mb", self.mb)
        obj.nb = kw.get("nb", self.nb)
        obj.op = kw.get("op", self.op)
        obj.grid = kw.get("grid", self.grid)
        for f in ("uplo", "diag", "kl", "ku", "kd"):
            if hasattr(self, f):
                setattr(obj, f, kw.get(f, getattr(self, f)))
        return obj

    def transpose(self):
        if self.op is Op.ConjTrans:
            from .exceptions import SlateError
            raise SlateError("transpose of a ConjTrans view is unsupported "
                             "(would need conj-no-trans)")
        flip = {Op.NoTrans: Op.Trans, Op.Trans: Op.NoTrans}
        return self._like(self.data, op=flip[self.op], mb=self.nb, nb=self.mb)

    def conj_transpose(self):
        if self.op is Op.Trans:
            from .exceptions import SlateError
            raise SlateError("conj_transpose of a Trans view is unsupported "
                             "(would need conj-no-trans)")
        flip = {Op.NoTrans: Op.ConjTrans, Op.ConjTrans: Op.NoTrans}
        return self._like(self.data, op=flip[self.op], mb=self.nb, nb=self.mb)

    def __repr__(self):
        return (f"{type(self).__name__}({self.m}x{self.n}, mb={self.mb}, "
                f"nb={self.nb}, op={self.op.name}, dtype={self.dtype}, "
                f"device={self.device})")


class Matrix(BaseMatrix):
    """General rectangular matrix."""

    @classmethod
    def from_array(cls, a, *, mb: int = 256, nb: int = 256,
                   grid: Optional[ProcessGrid] = None, device=None):
        out = cls(a, mb=mb, nb=nb, grid=grid, device=device)
        if out.data.ndim != 2:
            raise ValueError("Matrix.from_array expects a 2-D array")
        return out


class BaseTrapezoidMatrix(BaseMatrix):
    """Trapezoid storage: one triangle (``uplo``) holds the matrix."""

    def __init__(self, data, uplo: Uplo, diag: Diag = Diag.NonUnit, **kw):
        super().__init__(data, **kw)
        self.uplo = uplo
        self.diag = diag

    @property
    def logical_uplo(self) -> Uplo:
        """uplo after applying the pending op (transpose swaps L/U)."""
        if self.op is Op.NoTrans or self.uplo is Uplo.General:
            return self.uplo
        return Uplo.Upper if self.uplo is Uplo.Lower else Uplo.Lower


    def tril_or_triu(self):
        """The stored triangle of the logical matrix, zeros elsewhere."""
        a = self.array
        return torch.tril(a) if self.logical_uplo is Uplo.Lower \
            else torch.triu(a)


class TrapezoidMatrix(BaseTrapezoidMatrix):
    """Trapezoid (possibly rectangular) matrix, one triangle stored
    (reference ``TrapezoidMatrix.hh``)."""


class TriangularMatrix(BaseTrapezoidMatrix):
    """Square triangular."""


class SymmetricMatrix(BaseTrapezoidMatrix):
    """A = Aᵀ with one triangle stored."""

    def full(self):
        from .ops.tile_ops import symmetrize
        return symmetrize(self.logical_uplo, self.array)


class HermitianMatrix(BaseTrapezoidMatrix):
    """A = Aᴴ with one triangle stored."""

    def full(self):
        from .ops.tile_ops import hermitize
        return hermitize(self.logical_uplo, self.array)


class BaseBandMatrix(BaseMatrix):
    """Band matrix with bandwidths (kl, ku), stored dense with implicit
    zeros outside the band, as in the JAX package
    (``slate_tpu/matrix.py:293-347``, less its pytree plumbing)."""

    def __init__(self, data, kl: int, ku: int, **kw):
        super().__init__(data, **kw)
        self.kl = int(kl)
        self.ku = int(ku)

    def transpose(self):
        """Band transpose also swaps the bandwidths (ku ↔ kl)."""
        out = super().transpose()
        out.kl, out.ku = self.ku, self.kl
        return out

    def conj_transpose(self):
        out = super().conj_transpose()
        out.kl, out.ku = self.ku, self.kl
        return out

    def band_mask(self):
        i = torch.arange(self.m, device=self.device)[:, None]
        j = torch.arange(self.n, device=self.device)[None, :]
        return (j - i <= self.ku) & (i - j <= self.kl)

    def banded(self):
        """The logical (op-applied) matrix with outside-band entries zeroed."""
        return torch.where(self.band_mask(), self.array,
                           torch.zeros((), dtype=self.dtype,
                                       device=self.device))


class BandMatrix(BaseBandMatrix):
    """General band matrix."""


class TriangularBandMatrix(BaseBandMatrix):
    """Triangular band of bandwidth kd in its ``uplo`` triangle."""

    def __init__(self, data, kd: int, uplo: Uplo, diag: Diag = Diag.NonUnit,
                 **kw):
        kl, ku = (kd, 0) if uplo is Uplo.Lower else (0, kd)
        super().__init__(data, kl, ku, **kw)
        self.uplo = uplo
        self.diag = diag
        self.kd = kd


class HermitianBandMatrix(BaseBandMatrix):
    """Hermitian band of bandwidth kd, one triangle stored."""

    def __init__(self, data, kd: int, uplo: Uplo, **kw):
        kl, ku = (kd, 0) if uplo is Uplo.Lower else (0, kd)
        super().__init__(data, kl, ku, **kw)
        self.uplo = uplo
        self.kd = kd


def as_array(a, device=None):
    """The logical tensor of a Matrix-family object, or ``a`` placed as
    :func:`to_tensor` places host inputs."""
    if isinstance(a, BaseMatrix):
        return a.array
    return to_tensor(a, device)
