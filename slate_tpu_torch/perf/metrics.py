"""Process-wide metrics registry — the minimal part of
``slate_tpu/perf/metrics.py`` that the drivers call: counters, named
timers, the driver decorator and :func:`snapshot`.

Off by default (``SLATE_TPU_TORCH_METRICS=1`` or :func:`on` enables it).
While off, every entry point is one attribute read and returns, and a
decorated driver calls straight through.  Timers are host wall time:
PyTorch returns before the card finishes, so a timer around CUDA work
measures enqueue, not device time.
"""

from __future__ import annotations

import functools
import os
import threading
import time

_ENV = "SLATE_TPU_TORCH_METRICS"

#: counter of materialized intermediates between the sub-stages of a
#: right-looking factorization step (the L21 write-back and one
#: read-modify-write per trailing strip), see :func:`count_hbm_roundtrips`.
STEP_HBM_ROUNDTRIPS = "step.hbm_roundtrips"


class _Registry:
    def __init__(self):
        self.enabled = os.environ.get(_ENV, "").strip().lower() in (
            "1", "true", "on", "yes")
        self.lock = threading.Lock()
        self.counters: dict = {}
        self.timers: dict = {}      # name -> [count, total, min, max]


_registry = _Registry()


def enabled() -> bool:
    return _registry.enabled


def on() -> None:
    _registry.enabled = True


def off() -> None:
    _registry.enabled = False


def reset() -> None:
    with _registry.lock:
        _registry.counters.clear()
        _registry.timers.clear()


def inc(name: str, value: float = 1.0) -> None:
    reg = _registry
    if not reg.enabled:
        return
    with reg.lock:
        reg.counters[name] = reg.counters.get(name, 0.0) + value


def observe_time(name: str, seconds: float) -> None:
    reg = _registry
    if not reg.enabled:
        return
    with reg.lock:
        t = reg.timers.get(name)
        if t is None:
            reg.timers[name] = [1, seconds, seconds, seconds]
        else:
            t[0] += 1
            t[1] += seconds
            t[2] = min(t[2], seconds)
            t[3] = max(t[3], seconds)


class _Timer:
    """Context manager recording its host wall time into a named timer."""

    __slots__ = ("name", "_t0")

    def __init__(self, name: str):
        self.name = name
        self._t0 = 0.0

    def __enter__(self):
        if _registry.enabled:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if _registry.enabled and self._t0:
            observe_time(self.name, time.perf_counter() - self._t0)
        return False


def step_timer(op: str, stage: str) -> _Timer:
    """Timer ``step.<op>.<stage>`` for one sub-stage of a factorization
    step (``panel`` / ``trsm`` / ``update``); dots in the parts become
    underscores so the key splits unambiguously on ``"."``."""
    return _Timer("step.%s.%s" % (op.replace(".", "_"),
                                  stage.replace(".", "_")))


def count_hbm_roundtrips(n: float = 1.0) -> None:
    """Count ``n`` materialized inter-stage intermediates."""
    inc(STEP_HBM_ROUNDTRIPS, n)


def snapshot() -> dict:
    """JSON-safe view of everything recorded so far."""
    reg = _registry
    with reg.lock:
        return {
            "enabled": reg.enabled,
            "counters": dict(reg.counters),
            "timers": {k: {"count": t[0], "total_s": t[1],
                           "min_s": t[2], "max_s": t[3]}
                       for k, t in reg.timers.items()},
        }


def instrument_driver(name: str):
    """Decorator for a public driver: counts calls (``driver.<name>.calls``)
    and host wall time (timer ``driver.<name>``) while the registry is
    on; a plain call-through while it is off."""

    label = "driver.%s" % name

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _registry.enabled:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            inc(label + ".calls")
            observe_time(label, time.perf_counter() - t0)
            return out

        wrapper.__metrics_driver__ = name
        return wrapper

    return deco
