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
