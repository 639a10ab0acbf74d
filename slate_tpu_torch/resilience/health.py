"""Driver health gates with graceful degradation — the port of
``slate_tpu/resilience/health.py``.

Every instrumented driver facade
(:func:`slate_tpu_torch.perf.metrics.instrument_driver`) runs
:func:`driver_gate` after the call while
:func:`~slate_tpu_torch.perf.metrics.resilience_wanted`::

    SLATE_TPU_TORCH_HEALTH=off|warn|retry|strict

* ``off`` (default) — no checks; the facade is unchanged.
* ``warn`` — a non-finite output, or a registered residual probe over its
  gate, counts ``resilience.health.fail`` and warns; the result flows.
* ``retry`` — a failed gate reruns the call ONCE on the stock backend
  (:func:`safe_backend`).  A clean stock answer is returned
  (``resilience.recovered``) and the driver's suspect site winners are
  quarantined (:func:`quarantine_driver`); both backends failing means the
  input is at fault, and the gate warns (``resilience.unrecovered``).
* ``strict`` — like ``retry``, but an unrecovered failure raises
  :class:`~slate_tpu_torch.exceptions.SlateError`.

The serving queue's non-finite batch check runs under every tier but
``off``.  Counters: ``resilience.health.checks`` / ``.fail``,
``resilience.retry``, ``resilience.recovered``, ``resilience.unrecovered``,
``resilience.reverify.ok`` / ``.fail``; each verdict is also a flight
recorder event (:mod:`slate_tpu_torch.perf.blackbox`).
"""

from __future__ import annotations

import os
import threading
import time
import warnings
from contextlib import contextmanager
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..exceptions import SlateError
from ..perf import blackbox, metrics
from .inject import iter_leaves

__all__ = [
    "ENV_HEALTH", "MODES", "driver_gate", "mode", "quarantine_driver",
    "register_residual", "reverify", "safe_backend",
]

ENV_HEALTH = "SLATE_TPU_TORCH_HEALTH"
MODES = ("off", "warn", "retry", "strict")


def mode() -> str:
    """The health tier ``SLATE_TPU_TORCH_HEALTH`` names (``off`` for
    anything else)."""
    raw = os.environ.get(ENV_HEALTH, "").strip().lower()
    return raw if raw in MODES else "off"


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


def reverify(n: int = 64, dtype="float32", device=None) -> bool:
    """Factor a small well-conditioned SPD problem ON ``device`` (default
    the card) through the kernel path — :func:`~slate_tpu_torch.ops.
    blocks.potrf_panels`, whose power-of-two fp32 panels are the
    ``chol_inv_panel`` kernel on the card — and gate its scaled residual:
    the check that a device which came back computes, not just answers.
    True for a finite answer under the gate; False on any failure (a dead
    device must read as unhealthy, never raise into its caller)."""
    try:
        from ..ops import blocks

        dev = torch.device("cuda" if device is None else device)
        dt = getattr(torch, str(np.dtype(dtype)))
        g = np.random.default_rng(0).standard_normal((n, n))
        a_h = (g @ g.T + n * np.eye(n)).astype(np.dtype(dtype))
        a = torch.as_tensor(a_h, device=dev, dtype=dt)
        nb = 1 << (min(n, 512).bit_length() - 1)
        l = torch.tril(blocks.potrf_panels(a, nb)).cpu().numpy()
        if not np.isfinite(l).all():
            metrics.inc("resilience.reverify.fail")
            return False
        eps = float(np.finfo(np.dtype(dtype)).eps)
        r = (np.linalg.norm(l.astype(np.float64) @ l.T - a_h)
             / (np.linalg.norm(a_h) * eps * n))
        ok = bool(r < 100.0)
        metrics.inc("resilience.reverify.ok" if ok
                    else "resilience.reverify.fail")
        return ok
    except Exception:
        metrics.inc("resilience.reverify.fail")
        return False


# ---------------------------------------------------------------------------
# Residual post-conditions (one a driver, opt-in)
# ---------------------------------------------------------------------------

#: driver name -> (fn(args, kwargs, out) -> scaled residual, gate)
_RESIDUALS: Dict[str, Tuple[Callable, float]] = {}


def register_residual(driver: str, fn: Callable, gate: float = 100.0
                      ) -> None:
    """Attach a scaled-residual probe to a driver facade: the gate fails
    when ``fn(args, kwargs, out) >= gate`` (units of ε·n).  A probe that
    raises is ignored: a broken check must not fail a healthy driver."""
    _RESIDUALS[driver] = (fn, float(gate))


def _resid_potrf_batched(args, kwargs, out) -> float:
    from ..linalg.batched import batched_factor_resid_potrf

    return batched_factor_resid_potrf(args[0], out)


def _resid_getrf_batched(args, kwargs, out) -> float:
    from ..linalg.batched import batched_factor_resid_lu

    return batched_factor_resid_lu(args[0], out)


def _tensor(x, device=None):
    x = getattr(x, "array", x)
    return torch.as_tensor(x, device=device)


def _probe_vec(n: int, like):
    """Deterministic probe vector ``1 + cos(i)`` (no generator: the gate
    must replay)."""
    x = 1.0 + torch.cos(torch.arange(n, dtype=torch.float64))
    return x.to(device=like.device,
                dtype=like.dtype if like.is_floating_point()
                else torch.float64)


def _resid_getrf(args, kwargs, out) -> float:
    """O(n²) matvec residual ‖L(Ux) − (PA)x‖∞ / (‖A‖max·‖x‖∞·ε·n) of the
    getrf facade: the gate must SEE finite corruption, which no finite
    census does."""
    lu = _tensor(out[0])
    a = _tensor(args[0], lu.device)
    perm = torch.as_tensor(out[1], device=lu.device).long()
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError("square-only probe")
    n = a.shape[0]
    x = _probe_vec(n, a)
    y = torch.triu(lu) @ x
    r = torch.tril(lu, -1) @ y + y - a[perm] @ x
    eps = torch.finfo(a.real.dtype).eps
    denom = float(a.abs().max() * x.abs().max()) * eps * n or 1.0
    return float(r.abs().max()) / denom


def _resid_potrf(args, kwargs, out) -> float:
    """Matvec residual ‖L(Lᴴx) − Ax‖∞ / (‖A‖max·‖x‖∞·ε·n) of the potrf
    facade (either stored triangle)."""
    from ..linalg.cholesky import _hermitian_full

    f = _tensor(out)
    full = _hermitian_full(args[0], f.device)
    if full.ndim != 2:
        raise ValueError("2-D-only probe")
    n = full.shape[0]
    lmat = torch.tril(f)
    # an Upper factor has an empty strict lower triangle
    if not bool(torch.tril(f, -1).abs().sum() > 0) \
            and bool(torch.triu(f, 1).abs().sum() > 0):
        lmat = torch.triu(f).mH
    x = _probe_vec(n, full)
    r = lmat @ (lmat.mH @ x) - full @ x
    eps = torch.finfo(full.real.dtype).eps
    denom = float(full.abs().max() * x.abs().max()) * eps * n or 1.0
    return float(r.abs().max()) / denom


register_residual("potrf_batched", _resid_potrf_batched)
register_residual("getrf_batched", _resid_getrf_batched)
register_residual("getrf", _resid_getrf)
register_residual("potrf", _resid_potrf)


def _finite(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        if not (leaf.is_floating_point() or leaf.is_complex()):
            return True
        return bool(torch.isfinite(leaf).all())
    try:
        a = np.asarray(leaf)
    except Exception:
        return True
    return a.dtype.kind not in "fc" or bool(np.isfinite(a).all())


def _healthy(name: str, args, kwargs, out) -> bool:
    """Every float leaf finite, and the driver's residual probe (if any)
    under its gate."""
    if not all(_finite(leaf) for leaf in iter_leaves(out)):
        return False
    probe = _RESIDUALS.get(name)
    if probe is not None:
        fn, gate = probe
        try:
            r = float(fn(args, kwargs, out))
        except Exception:
            return True
        if not (r < gate):                # a NaN residual fails too
            return False
    return True


# ---------------------------------------------------------------------------
# Quarantine: which sites feed which driver facade
# ---------------------------------------------------------------------------

_FACTOR_SITES = ("matmul", "trtri_panel")
_DRIVER_SITES: Dict[str, Tuple[str, ...]] = {
    "gemm": ("matmul",),
    "trsm": ("matmul",),
    "potrf": ("potrf_panel", "potrf_panel_f64", "potrf_step")
    + _FACTOR_SITES,
    "potrs": _FACTOR_SITES,
    "posv": ("potrf_panel", "potrf_panel_f64", "potrf_step")
    + _FACTOR_SITES,
    "potri": ("potrf_panel", "potrf_panel_f64") + _FACTOR_SITES,
    "trtri": _FACTOR_SITES,
    "getrf": ("lu_driver", "lu_panel", "lu_step") + _FACTOR_SITES,
    "getrs": _FACTOR_SITES,
    "gesv": ("lu_driver", "lu_panel", "lu_step") + _FACTOR_SITES,
    "getri": ("lu_driver", "lu_panel", "lu_step") + _FACTOR_SITES,
    "geqrf": ("geqrf_panel",) + _FACTOR_SITES,
    "gels": ("geqrf_panel",) + _FACTOR_SITES,
    "heev": ("chase", "eig_driver") + _FACTOR_SITES,
    "svd": ("chase", "svd_driver") + _FACTOR_SITES,
    "polar": ("qdwh_step",) + _FACTOR_SITES,
    "potrf_batched": ("batched_potrf",),
    "posv_batched": ("batched_potrf",),
    "getrf_batched": ("batched_lu",),
    "gesv_batched": ("batched_lu",),
    "geqrf_batched": ("batched_qr",),
    "gels_batched": ("batched_qr",),
}


def _quarantine_for(name: str, reason: str) -> int:
    """Demote the measured (timed, cached or bundled) non-safe winners of
    the sites feeding driver ``name``.  The JAX package demotes only such
    winners and never a heuristic one; every decision of the port's sites
    is a heuristic until the measured decision table exists (ROADMAP.md,
    queue 1, "Perf tooling"), so this demotes nothing and returns 0, as
    the JAX package does on a host with heuristic decisions alone."""
    return 0


def quarantine_driver(name: str, reason: str) -> int:
    """Demote driver ``name``'s measured non-safe site winners as a failed
    gate with a clean stock rerun would; returns the number demoted,
    ``resilience.sentinel.quarantined`` counting them (0 today, see
    :func:`_quarantine_for`)."""
    n = _quarantine_for(name, reason=reason)
    if n:
        metrics.inc("resilience.sentinel.quarantined", n)
    return n


# ---------------------------------------------------------------------------
# The driver post-condition pipeline
# ---------------------------------------------------------------------------

def driver_gate(name: str, fn, args, kwargs, out):
    """The resilience post-conditions of one driver call: fault injection
    at ``driver.output``, then the health gate of the current
    :func:`mode`.  Called by :func:`slate_tpu_torch.perf.metrics.
    instrument_driver`."""
    from . import inject

    kind = inject.poll("driver.output")
    if kind == "error":
        raise inject.InjectedFault("driver.output")
    if kind == "slow":
        time.sleep(inject.slow_seconds())
    if kind in ("nan", "inf"):
        out = inject.corrupt_outputs(out, kind)
    m = mode()
    if m == "off":
        return out
    metrics.inc("resilience.health.checks")
    if _healthy(name, args, kwargs, out):
        return out
    metrics.inc("resilience.health.fail")
    blackbox.record("health.fail", driver=name, mode=m)
    if m == "warn":
        warnings.warn(
            f"{name}: output failed the health gate (non-finite or "
            "residual over gate); SLATE_TPU_TORCH_HEALTH=warn passes it "
            "through", RuntimeWarning, stacklevel=3)
        return out
    # retry / strict: rerun on the stock backend; quarantine only when it
    # recovers (both failing means the input is at fault)
    metrics.inc("resilience.retry")
    blackbox.record("health.retry", driver=name)
    with safe_backend():
        out2 = fn(*args, **kwargs)
    if _healthy(name, args, kwargs, out2):
        _quarantine_for(name, reason=f"health gate failed in {name}; "
                        "stock backend recovered")
        metrics.inc("resilience.recovered")
        blackbox.record("health.recovered", driver=name)
        return out2
    metrics.inc("resilience.unrecovered")
    blackbox.record("health.unrecovered", driver=name, mode=m)
    if m == "strict":
        blackbox.trigger("health.strict",
                         f"{name}: unrecovered on the stock backend")
        raise SlateError(
            f"{name}: output failed the health gate even on the stock "
            "backend (SLATE_TPU_TORCH_HEALTH=strict)")
    warnings.warn(
        f"{name}: health gate still failing after the stock-backend "
        "rerun", RuntimeWarning, stacklevel=3)
    return out2
