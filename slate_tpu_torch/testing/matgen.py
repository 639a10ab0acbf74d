"""Test matrix generation on a ``torch.Generator`` — the counterpart of
``slate_tpu/testing/matgen.py:136`` (``random_spd``, reference kind
``poev``: A = V·Σ·Vᴴ with a geometric spectrum from 1 to 1/cond).

The JAX package draws from ``jax.random``, which torch cannot
reproduce: tests that compare the two packages build their inputs with
numpy and hand the same arrays to both.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device


def _haar(gen: torch.Generator, n: int, dtype, device) -> torch.Tensor:
    """Random orthonormal columns (QR of a Gaussian, phases fixed)."""
    g = torch.randn((n, n), generator=gen, dtype=dtype, device=device)
    q, r = torch.linalg.qr(g)
    d = torch.diagonal(r)
    return q * torch.sign(d)[None, :]


def random_spd(n: int, *, dtype=torch.float32, seed: int = 0,
               cond: float = 1e2, device=None) -> torch.Tensor:
    """Symmetric positive-definite (n, n) test matrix with condition
    number ``cond``, generated in float64 and cast to ``dtype``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    s = torch.as_tensor(np.geomspace(1.0, 1.0 / cond, n), dtype=torch.float64,
                        device=dev)
    u = _haar(gen, n, torch.float64, dev)
    a = (u * s[None, :]) @ u.mT
    return ((a + a.mT) / 2).to(dtype)
