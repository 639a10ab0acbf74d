"""The health tier and the safe backend — the part of
``slate_tpu/resilience/health.py`` the serving queue uses (``mode``,
``:56``; ``safe_backend``, ``:77``).  The driver post-condition gates,
quarantine and residual registry are not ported yet (ROADMAP.md, queue 1
item 10).

``SLATE_TPU_TORCH_HEALTH=1`` turns the check on (default off).  The port
has one behaviour for it, not the JAX package's warn/retry/strict tiers:
the serving queue treats a non-finite batch result as a failed dispatch,
retried and then served problem by problem on the safe backend."""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager

__all__ = ["ENV_HEALTH", "mode", "safe_backend"]

ENV_HEALTH = "SLATE_TPU_TORCH_HEALTH"


def mode() -> str:
    """``"on"`` when ``SLATE_TPU_TORCH_HEALTH`` is ``1``, else ``"off"``."""
    return "on" if os.environ.get(ENV_HEALTH, "").strip() == "1" else "off"


_safe_lock = threading.RLock()


@contextmanager
def safe_backend():
    """Force the stock backends for the body: ``config.use_kernels``,
    ``config.scattered_lu``, ``config.split_gemm`` and ``config.f64_mxu``
    off (``slate_tpu/resilience/health.py:86-96``), so every site resolves
    to its stock PyTorch op (cuBLAS/cuSOLVER) and no hand-written kernel
    or split product runs; the forced resolutions stay out of the census
    (:func:`~slate_tpu_torch.perf.autotune.suppress_knob_records`).
    Process-global, as the knobs are module globals: concurrent bodies
    serialize on one lock instead of racing the restore."""
    from .. import config
    from ..perf import autotune

    with _safe_lock:
        saved = (config.use_kernels, config.scattered_lu, config.split_gemm,
                 config.f64_mxu)
        config.use_kernels = False
        config.scattered_lu = False
        config.split_gemm = False
        config.f64_mxu = False
        try:
            with autotune.suppress_knob_records():
                yield
        finally:
            (config.use_kernels, config.scattered_lu, config.split_gemm,
             config.f64_mxu) = saved
