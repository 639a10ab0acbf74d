"""Elementwise drivers: add, copy, scale, scale_row_col, set — the
counterpart of ``slate_tpu/linalg/util.py`` (reference ``src/add.cc``,
``copy.cc``, ``scale.cc``, ``scale_row_col.cc``, ``set.cc``).

Thin wrappers over the torch forms of :mod:`slate_tpu_torch.ops.tile_ops`,
as the JAX drivers wrap the jnp forms; the CUDA kernels ``geadd``,
``gescale_row_col`` and ``tzset`` of :mod:`slate_tpu_torch.ops.kernels`
compute the same functions and are held to these drivers on the card by
``chip_smoke.py``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..enums import Uplo
from ..matrix import BaseMatrix, BaseTrapezoidMatrix
from ..ops import tile_ops
from ..options import Options
from .blas3 import _arr, _device_of


def _wrap_like(template, data):
    """``data`` in ``template``'s class and metadata, as the JAX
    package's ``util._wrap_like`` (the op is kept)."""
    if isinstance(template, BaseMatrix):
        return template._like(data)
    return data


def _trapezoid_uplo(a):
    if isinstance(a, BaseTrapezoidMatrix) and a.logical_uplo is not Uplo.General:
        return a.logical_uplo
    return None


def add(alpha, a, beta, b, opts: Optional[Options] = None, *, device=None):
    """B ← α·A + β·B — reference ``slate::add``.  A trapezoid B updates
    only its stored triangle (``tzadd``)."""
    dev = _device_of(a, b, device=device)
    av, bv = _arr(a, dev), _arr(b, dev)
    uplo = _trapezoid_uplo(b)
    out = tile_ops.tzadd(uplo, alpha, av, beta, bv) if uplo is not None \
        else tile_ops.geadd(alpha, av, beta, bv)
    return _wrap_like(b, out)


def copy(a, dtype=None, opts: Optional[Options] = None, *, device=None):
    """Precision-converting copy — reference ``slate::copy``."""
    out = tile_ops.gecopy(_arr(a, _device_of(a, device=device)), dtype=dtype)
    return _wrap_like(a, out)


def scale(numer, denom, a, opts: Optional[Options] = None, *, device=None):
    """A ← (numer/denom)·A — reference ``slate::scale``."""
    out = tile_ops.gescale(numer, denom, _arr(a, _device_of(a, device=device)))
    return _wrap_like(a, out)


def scale_row_col(r, c, a, opts: Optional[Options] = None, *, device=None):
    """A ← diag(r)·A·diag(c) — reference ``slate::scale_row_col``, the
    equilibration primitive."""
    dev = _device_of(a, device=device)
    av = _arr(a, dev)
    r = torch.as_tensor(r, device=dev)
    c = torch.as_tensor(c, device=dev)
    return _wrap_like(a, tile_ops.gescale_row_col(r, c, av))


def set(offdiag_value, diag_value, a, opts: Optional[Options] = None, *,
        device=None):
    """A ← the offdiag constant with the diag constant — reference
    ``slate::set``; ``a`` supplies shape, dtype and wrapper.  A trapezoid
    ``a`` is set on its stored triangle and zeroed on the other."""
    av = _arr(a, _device_of(a, device=device))
    uplo = _trapezoid_uplo(a)
    if uplo is not None:
        out = tile_ops.tzset(av.shape, uplo, offdiag_value, diag_value,
                             av.dtype, av.device)
    else:
        out = tile_ops.geset(av.shape, offdiag_value, diag_value, av.dtype,
                             av.device)
    return _wrap_like(a, out)
