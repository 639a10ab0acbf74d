"""Matrix norm drivers — the counterpart of ``slate_tpu/linalg/norms.py``
(reference ``src/norm.cc`` and the per-type ``internal_*norm.cc``).

One reduction over the (masked) logical tensor, as in the JAX package:
the per-class dispatch of :func:`_masked_array` applies band zeros,
unit diagonals and the Hermitian/symmetric mirror, then :func:`norm`
reduces.  The reductions are torch's own, as the JAX package's are XLA's;
the ``tile_norms`` kernel of :mod:`slate_tpu_torch.ops.kernels` computes
the per-tile partials of the same Max and Fro norms and is held to
:func:`norm` on the card by ``chip_smoke.py``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..enums import Diag, Norm
from ..matrix import (BaseBandMatrix, BaseTrapezoidMatrix,
                      HermitianBandMatrix, HermitianMatrix, SymmetricMatrix,
                      TriangularBandMatrix)
from ..ops.tile_ops import hermitize, symmetrize
from ..options import Options
from .blas3 import _arr, _device_of


def _unit_diag(t):
    eye = torch.eye(t.shape[-2], t.shape[-1], dtype=torch.bool,
                    device=t.device)
    return torch.where(eye, torch.ones((), dtype=t.dtype, device=t.device), t)


def _masked_array(a, device=None):
    """The logical tensor of a matrix-family object with its structural
    zeros and mirroring applied — the per-type dispatch the reference
    does by overloading ``slate::norm`` per matrix class."""
    if isinstance(a, (SymmetricMatrix, HermitianMatrix)):
        return a.full()
    if isinstance(a, HermitianBandMatrix):
        full = (hermitize if a.data.is_complex() else symmetrize)(
            a.uplo, a.array)
        n = full.shape[-1]
        i = torch.arange(n, device=full.device)[:, None]
        j = torch.arange(n, device=full.device)[None, :]
        return torch.where((i - j).abs() <= a.kd, full,
                           torch.zeros((), dtype=full.dtype,
                                       device=full.device))
    if isinstance(a, TriangularBandMatrix):
        base = a.banded()
        return _unit_diag(base) if a.diag is Diag.Unit else base
    if isinstance(a, BaseBandMatrix):
        return a.banded()
    if isinstance(a, BaseTrapezoidMatrix):
        t = a.tril_or_triu()
        return _unit_diag(t) if getattr(a, "diag", Diag.NonUnit) \
            is Diag.Unit else t
    return _arr(a, _device_of(a, device=device))


def norm(norm_type: Norm, a, opts: Optional[Options] = None, *,
         device=None):
    """‖A‖ for Max/One/Inf/Fro — reference ``slate::norm``.  Accepts any
    matrix-family object (triangle storage, band, Hermitian mirroring
    and unit diagonals are honoured) or a raw array.  Returns a real
    0-dim tensor of the matching real dtype on A's device."""
    av = _masked_array(a, device).abs()
    if norm_type is Norm.Max:
        return av.amax()
    if norm_type is Norm.One:
        return av.sum(dim=-2).amax()
    if norm_type is Norm.Inf:
        return av.sum(dim=-1).amax()
    if norm_type is Norm.Fro:
        # scaled sum of squares, as LAPACK lassq, to dodge overflow
        scale = av.amax()
        zero = torch.zeros((), dtype=av.dtype, device=av.device)
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        ssq = ((av / safe) ** 2).sum()
        return torch.where(scale > 0, scale * torch.sqrt(ssq), zero)
    raise ValueError(f"unsupported norm {norm_type}")


def col_norms(norm_type: Norm, a, opts: Optional[Options] = None, *,
              device=None):
    """Per-column norms — reference ``slate::colNorms`` (Norm.Max only,
    as there)."""
    if norm_type is not Norm.Max:
        raise ValueError("colNorms supports Norm.Max (like the reference)")
    return _masked_array(a, device).abs().amax(dim=-2)


# BLAS-style aliases matching the reference's per-type entry points.
def genorm(norm_type: Norm, a, opts: Optional[Options] = None, *,
           device=None):
    return norm(norm_type, a, opts, device=device)


synorm = henorm = trnorm = gbnorm = hbnorm = genorm
