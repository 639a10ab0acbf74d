"""Elementwise and norm tile helpers — the counterpart of
``slate_tpu/ops/tile_ops.py`` (reference ``device::geadd``, ``gecopy``,
``genorm``, ``gescale``, ``gescale_row_col``, ``geset``, ``henorm``,
``synorm``, ``transpose``, ``trnorm``, ``tzadd``, ``tzcopy``, ``tzset``,
``symmetrize``/``hermitize``).

Plain torch over tensors of shape ``(..., mb, nb)``, as the JAX
package's are jnp: the drivers (:mod:`slate_tpu_torch.linalg.util`,
:mod:`~slate_tpu_torch.linalg.norms`) use these forms, not the CUDA
kernels of :mod:`slate_tpu_torch.ops.kernels`.  Two differ from their
kernel namesakes by design: :func:`tzset` builds a new tensor and zeroes
the other triangle (``kernels.tzset`` keeps it), and :func:`genorm` with
``Norm.Fro`` returns the root (``kernels.tile_norms("fro")`` the sum of
squares).
"""

from __future__ import annotations

import torch

from ..enums import Norm, Uplo


def _keep(uplo: Uplo, m: int, n: int, device):
    i = torch.arange(m, device=device)[:, None]
    j = torch.arange(n, device=device)[None, :]
    return (i >= j) if uplo is Uplo.Lower else (i <= j)


def _eye(m: int, n: int, device):
    return torch.eye(m, n, dtype=torch.bool, device=device)


def geset(shape, offdiag_value, diag_value, dtype=torch.float32,
          device=None):
    """A new tensor of ``shape`` holding ``offdiag_value`` with
    ``diag_value`` on the diagonal (ref ``device::geset``)."""
    m, n = shape[-2], shape[-1]
    out = torch.full(tuple(shape), offdiag_value, dtype=dtype, device=device)
    return torch.where(_eye(m, n, out.device),
                       torch.tensor(diag_value, dtype=dtype,
                                    device=out.device), out)


def tzset(shape, uplo: Uplo, offdiag_value, diag_value, dtype=torch.float32,
          device=None):
    """Trapezoid set (ref ``device::tzset``): :func:`geset` on the
    ``uplo`` triangle, zero on the other."""
    m, n = shape[-2], shape[-1]
    full = geset(shape, offdiag_value, diag_value, dtype, device)
    return torch.where(_keep(uplo, m, n, full.device), full,
                       torch.zeros((), dtype=dtype, device=full.device))


def geadd(alpha, a, beta, b):
    """α·A + β·B (ref ``device::geadd``)."""
    return alpha * a + beta * b


def tzadd(uplo: Uplo, alpha, a, beta, b):
    """α·A + β·B on the ``uplo`` triangle, B elsewhere."""
    m, n = a.shape[-2], a.shape[-1]
    return torch.where(_keep(uplo, m, n, a.device), alpha * a + beta * b, b)


def gecopy(a, dtype=None):
    """Copy, optionally precision-converting (ref ``device::gecopy``)."""
    return a.to(dtype) if dtype is not None else a


def tzcopy(uplo: Uplo, a, b, dtype=None):
    """The ``uplo`` trapezoid of A over B, optionally converting
    precision (ref ``device::tzcopy``)."""
    m, n = a.shape[-2], a.shape[-1]
    out_dtype = dtype or b.dtype
    return torch.where(_keep(uplo, m, n, a.device), a.to(out_dtype),
                       b.to(out_dtype))


def gescale(numer, denom, a):
    """A·(numer/denom) (ref ``device::gescale``), the quotient formed in
    A's dtype."""
    q = torch.tensor(numer, dtype=a.dtype, device=a.device) \
        / torch.tensor(denom, dtype=a.dtype, device=a.device)
    return a * q


def gescale_row_col(r, c, a):
    """diag(r)·A·diag(c) (ref ``device::gescale_row_col``)."""
    return a * r[..., :, None] * c[..., None, :]


def transpose(a, conj: bool = False):
    """Batched (conjugate-)transpose (ref ``device::transpose``)."""
    return a.mH if conj else a.mT


def genorm(norm: Norm, a, axis=(-2, -1)):
    """Per-tile general-matrix norm (ref ``device::genorm``): Max → max|a|,
    One → column sums, Inf → row sums, Fro → ‖a‖_F (the root)."""
    if norm is Norm.Max:
        return torch.amax(a.abs(), dim=axis)
    if norm is Norm.One:
        return a.abs().sum(dim=-2)
    if norm is Norm.Inf:
        return a.abs().sum(dim=-1)
    if norm is Norm.Fro:
        return torch.sqrt((a.abs() ** 2).sum(dim=axis))
    raise ValueError(f"unsupported norm {norm}")


def trnorm(norm: Norm, uplo: Uplo, a, diag_one: bool = False):
    """Trapezoid/triangular tile norm (ref ``device::trnorm``)."""
    m, n = a.shape[-2], a.shape[-1]
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    masked = torch.where(_keep(uplo, m, n, a.device), a, zero)
    if diag_one:
        masked = torch.where(_eye(m, n, a.device),
                             torch.ones((), dtype=a.dtype, device=a.device),
                             masked)
    return genorm(norm, masked)


def synorm(norm: Norm, uplo: Uplo, a):
    """Symmetric tile norm over the stored triangle mirrored."""
    return genorm(norm, symmetrize(uplo, a))


def henorm(norm: Norm, uplo: Uplo, a):
    """Hermitian tile norm over the stored triangle mirrored."""
    return genorm(norm, hermitize(uplo, a))


def symmetrize(uplo: Uplo, a):
    """Reflect the stored triangle to form the full symmetric matrix."""
    t = torch.tril(a, -1) if uplo is Uplo.Lower else torch.triu(a, 1)
    return t + t.mT + torch.diag_embed(torch.diagonal(a, dim1=-2, dim2=-1))


def hermitize(uplo: Uplo, a):
    """Reflect with conjugation; the diagonal is forced real.  Two
    matrices at the peak (the triangle and the result), the diagonal
    written in place."""
    t = torch.tril(a, -1) if uplo is Uplo.Lower else torch.triu(a, 1)
    d = torch.diagonal(a, dim1=-2, dim2=-1)
    if d.is_complex():
        d = d.real.to(a.dtype)
    out = t + t.mH
    out.diagonal(dim1=-2, dim2=-1).copy_(d)
    return out
