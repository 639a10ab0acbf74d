"""Test matrix generation on a ``torch.Generator`` — the counterpart of
``slate_tpu/testing/matgen.py``: :func:`generate_matrix` (every named
kind) and :func:`random_spd` (reference kind ``poev``: A = V·Σ·Vᴴ with a
geometric spectrum from 1 to 1/cond).

The JAX package draws from ``jax.random``, which torch cannot
reproduce: tests that compare the two packages build their inputs with
numpy and hand the same arrays to both.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..config import resolve_device
from ..ops.blocks import matmul as _mm


def _spectrum(kind: str, n: int, cond: float) -> np.ndarray:
    """The named singular-value or eigenvalue distribution from 1 to
    1/cond (``slate_tpu/testing/matgen.py:38-55``)."""
    if kind in ("", "geo", "default"):
        return np.geomspace(1.0, 1.0 / cond, n)
    if kind == "arith":
        return np.linspace(1.0, 1.0 / cond, n)
    if kind == "cluster0":
        s = np.full(n, 1.0 / cond)
        s[0] = 1.0
        return s
    if kind == "cluster1":
        s = np.ones(n)
        s[-1] = 1.0 / cond
        return s
    if kind == "rgeo":
        return np.geomspace(1.0 / cond, 1.0, n)
    if kind == "rarith":
        return np.linspace(1.0 / cond, 1.0, n)
    raise ValueError(f"unknown spectrum {kind!r}")


def _haar(gen: torch.Generator, m: int, n: int, dtype, device) -> torch.Tensor:
    """Random orthonormal (m, n) columns: QR of a Gaussian (complex:
    real part, then imaginary part), phases fixed so the distribution is
    Haar."""
    if dtype.is_complex:
        real = torch.float64 if dtype == torch.complex128 else torch.float32
        g = torch.complex(
            torch.randn((m, n), generator=gen, dtype=real, device=device),
            torch.randn((m, n), generator=gen, dtype=real, device=device))
    else:
        g = torch.randn((m, n), generator=gen, dtype=dtype, device=device)
    q, r = torch.linalg.qr(g)
    d = torch.diagonal(r)
    ph = d / d.abs()
    return q * ph.conj()[None, :]


def generate_matrix(kind: str, m: int, n: int | None = None, *,
                    dtype=torch.float32, seed: int = 0, cond: float = 1e2,
                    sigma: Sequence[float] | None = None,
                    device=None) -> torch.Tensor:
    """An m×n test matrix of the named ``kind``
    (``slate_tpu/testing/matgen.py:74-134``; reference
    ``test/matrix_generator.cc``): ``zeros``, ``ones``, ``identity``,
    ``jordan``; ``rand`` (uniform [0, 1)), ``rands`` (uniform [-1, 1)),
    ``randn``, ``rand_dominant`` (``rands`` + 2·max(m, n)·I); ``svd``
    and ``cond`` (U·Σ·Vᴴ), ``heev`` (Hermitian V·Λ·Vᴴ, signs alternating)
    and ``poev`` (Hermitian positive definite), Σ from ``sigma`` or the
    spectrum named after a colon (``svd:arith``; ``geo`` by default, 1
    to 1/cond).  Complex dtypes get complex draws (an imaginary part
    uniform in [-1, 1) for the ``rand`` kinds).  Drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (default
    ``cuda``), in fp64 (complex128), then cast to ``dtype``.  The JAX
    package draws from ``jax.random``: the two give the same kinds, not
    the same bits."""
    n = m if n is None else n
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    base, _, spec = kind.partition(":")
    cplx = dtype.is_complex
    gen_dtype = torch.complex128 if cplx else torch.float64
    real = torch.float64
    k = min(m, n)

    def eye(offset=0):
        e = torch.zeros((m, n), dtype=gen_dtype, device=dev)
        i = torch.arange(max(0, -offset), min(m, n - offset), device=dev)
        e[i, i + offset] = 1
        return e

    if base == "zeros":
        a = torch.zeros((m, n), dtype=gen_dtype, device=dev)
    elif base == "ones":
        a = torch.ones((m, n), dtype=gen_dtype, device=dev)
    elif base == "identity":
        a = eye()
    elif base == "jordan":
        a = eye() + eye(-1)
    elif base in ("rand", "rands", "randn", "rand_dominant"):
        if base == "randn":
            a = torch.randn((m, n), generator=gen, dtype=real, device=dev)
        else:
            a = torch.rand((m, n), generator=gen, dtype=real, device=dev)
            if base != "rand":
                a = 2 * a - 1
        if cplx:
            b = 2 * torch.rand((m, n), generator=gen, dtype=real,
                               device=dev) - 1
            a = torch.complex(a, b)
        a = a.to(gen_dtype)
        if base == "rand_dominant":
            a = a + 2 * max(m, n) * eye()
    elif base in ("svd", "heev", "poev", "cond"):
        s = np.asarray(sigma, dtype=np.float64) if sigma is not None \
            else _spectrum(spec, k, cond)
        s = torch.as_tensor(s, dtype=gen_dtype, device=dev)
        u = _haar(gen, m, k, gen_dtype, dev)
        if base in ("heev", "poev"):
            if base == "heev":
                signs = torch.as_tensor(
                    np.where(np.arange(k) % 2 == 0, 1.0, -1.0),
                    dtype=gen_dtype, device=dev)
                s = s * signs
            a = _mm(u * s[None, :], u.mH.resolve_conj())
            a = (a + a.mH) / 2
        else:
            v = _haar(gen, n, k, gen_dtype, dev)
            a = _mm(u * s[None, :], v.mH.resolve_conj())
    else:
        raise ValueError(f"unknown matrix kind {kind!r}")
    return a.to(dtype)


def random_spd(n: int, *, dtype=torch.float32, seed: int = 0,
               cond: float = 1e2, device=None) -> torch.Tensor:
    """Symmetric positive-definite (n, n) test matrix with condition
    number ``cond``, generated in float64 and cast to ``dtype``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    s = torch.as_tensor(np.geomspace(1.0, 1.0 / cond, n), dtype=torch.float64,
                        device=dev)
    u = _haar(gen, n, n, torch.float64, dev)
    a = (u * s[None, :]) @ u.mT
    return ((a + a.mT) / 2).to(dtype)
