"""Elementwise tile helpers — the part of ``slate_tpu/ops/tile_ops.py``
that :mod:`~slate_tpu_torch.ops.blocks` and the drivers use."""

from __future__ import annotations

import torch

from ..enums import Uplo


def symmetrize(uplo: Uplo, a):
    """Reflect the stored triangle to form the full symmetric matrix."""
    t = torch.tril(a, -1) if uplo is Uplo.Lower else torch.triu(a, 1)
    return t + t.mT + torch.diag_embed(torch.diagonal(a, dim1=-2, dim2=-1))


def hermitize(uplo: Uplo, a):
    """Reflect with conjugation; the diagonal is forced real."""
    t = torch.tril(a, -1) if uplo is Uplo.Lower else torch.triu(a, 1)
    d = torch.diagonal(a, dim1=-2, dim2=-1)
    if d.is_complex():
        d = d.real.to(a.dtype)
    return t + t.mH + torch.diag_embed(d)
