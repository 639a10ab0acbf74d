"""Backend selection for multi-backend op sites — the counterpart of
``slate_tpu/method.py:102-130``.  Drivers call :func:`select_backend`
instead of touching kernel modules, so every dispatch resolves in one
table (:mod:`slate_tpu_torch.perf.autotune`)."""

from __future__ import annotations


def select_backend(op: str, **key) -> str:
    """Resolved backend of site ``op`` for this key, e.g.
    ``select_backend("potrf_panel", n=8192, nb=512, dtype=torch.float32,
    device=a.device)``."""

    from .perf.autotune import select

    return select(op, **key)


def select_lu(method, distributed: bool = False):
    """LU variant (reference ``MethodLU::select_algo``,
    ``method.hh:298-311``): an explicit choice stands; ``Auto`` is
    PartialPiv on one device and CALU on a mesh, as in the JAX package."""

    from .enums import MethodLU

    if method is not MethodLU.Auto:
        return method
    return MethodLU.CALU if distributed else MethodLU.PartialPiv


def select_gels(method, m: int, n: int):
    """Least-squares method (reference ``MethodGels::select_algo``,
    ``method.hh:252-268``): an explicit choice stands; ``Auto`` is CholQR
    for strongly tall systems (m ≥ 3n), Householder QR otherwise."""

    from .enums import MethodGels

    if method is not MethodGels.Auto:
        return method
    return MethodGels.CholQR if m >= 3 * n else MethodGels.QR
