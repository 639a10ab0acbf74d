"""Process-wide metrics registry — the part of
``slate_tpu/perf/metrics.py`` that the drivers and the serving queue
call: counters, gauges, named timers, log2 histograms with their
quantile readback, the driver decorator (which also runs the resilience
post-conditions when they are wanted, :func:`resilience_wanted`),
:func:`snapshot` and :func:`snapshot_delta`.

Off by default (``SLATE_TPU_TORCH_METRICS=1`` or :func:`on` enables it).
While off, every entry point is one attribute read and returns, and a
decorated driver calls straight through.  Timers are host wall time:
PyTorch returns before the card finishes, so a timer around CUDA work
measures enqueue, not device time.
"""

from __future__ import annotations

import functools
import math
import os
import threading
import time

_ENV = "SLATE_TPU_TORCH_METRICS"

#: counter of materialized intermediates between the sub-stages of a
#: right-looking factorization step (the L21 write-back and one
#: read-modify-write per trailing strip), see :func:`count_hbm_roundtrips`.
STEP_HBM_ROUNDTRIPS = "step.hbm_roundtrips"


def env_flag(name: str, default: str = "") -> bool:
    """A truthy environment knob (``1``/``true``/``on``/``yes``)."""
    return os.environ.get(name, default).strip().lower() in (
        "1", "true", "on", "yes")


class _Registry:
    def __init__(self):
        self.enabled = env_flag(_ENV)
        self.lock = threading.Lock()
        self.counters: dict = {}
        self.gauges: dict = {}
        self.timers: dict = {}      # name -> [count, total, min, max]
        self.hists: dict = {}       # name -> {count, total, buckets}


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
        _registry.gauges.clear()
        _registry.timers.clear()
        _registry.hists.clear()


def inc(name: str, value: float = 1.0) -> None:
    reg = _registry
    if not reg.enabled:
        return
    with reg.lock:
        reg.counters[name] = reg.counters.get(name, 0.0) + value


def set_gauge(name: str, value: float) -> None:
    reg = _registry
    if not reg.enabled:
        return
    with reg.lock:
        reg.gauges[name] = float(value)


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


def timer(name: str) -> _Timer:
    return _Timer(name)


def step_timer(op: str, stage: str) -> _Timer:
    """Timer ``step.<op>.<stage>`` for one sub-stage of a factorization
    step (``panel`` / ``trsm`` / ``update``); dots in the parts become
    underscores so the key splits unambiguously on ``"."``."""
    return _Timer("step.%s.%s" % (op.replace(".", "_"),
                                  stage.replace(".", "_")))


def count_hbm_roundtrips(n: float = 1.0) -> None:
    """Count ``n`` materialized inter-stage intermediates."""
    inc(STEP_HBM_ROUNDTRIPS, n)


def _bucket(value: float) -> str:
    if value <= 0:
        return "le_0"
    return "le_2^%d" % math.ceil(math.log2(value))


def observe(name: str, value: float) -> None:
    """Record one sample into histogram ``name`` (power-of-two
    buckets)."""
    reg = _registry
    if not reg.enabled:
        return
    with reg.lock:
        h = reg.hists.get(name)
        if h is None:
            h = reg.hists[name] = {"count": 0, "total": 0.0, "buckets": {}}
        h["count"] += 1
        h["total"] += value
        b = _bucket(value)
        h["buckets"][b] = h["buckets"].get(b, 0) + 1


def bucket_bounds(bucket: str):
    """``(lo, hi)`` of one log2 histogram bucket key (``"le_2^k"`` →
    ``(2^(k-1), 2^k)``; ``"le_0"`` → ``(0, 0)``); None for keys this
    registry never produces."""
    if bucket == "le_0":
        return (0.0, 0.0)
    if not bucket.startswith("le_2^"):
        return None
    try:
        k = int(bucket[5:])
    except ValueError:
        return None
    hi = 2.0 ** k
    return (hi / 2.0, hi)


def quantiles_from_buckets(hist, qs=(0.5, 0.95, 0.99)) -> dict:
    """Quantiles of one histogram (``{"count", "total", "buckets"}``, a
    :func:`snapshot` or :func:`snapshot_delta` entry): the q-quantile's
    bucket is found by cumulative count and the value placed inside it
    by linear interpolation, so the estimate lies within a factor of two
    of the exact order statistic.  Returns ``{q: value}``; ``{}`` for an
    empty histogram."""
    buckets = (hist or {}).get("buckets") or {}
    items = []
    for b, c in buckets.items():
        bounds = bucket_bounds(b)
        if bounds is not None and c > 0:
            items.append((bounds[0], bounds[1], int(c)))
    items.sort(key=lambda x: x[1])
    total = sum(c for _, _, c in items)
    if total <= 0:
        return {}
    out = {}
    for q in qs:
        rank = max(float(q), 0.0) * total
        cum = 0.0
        val = items[-1][1]
        for lo, hi, c in items:
            if cum + c >= rank - 1e-12:
                frac = max(0.0, min(1.0, (rank - cum) / c))
                val = lo + frac * (hi - lo)
                break
            cum += c
        out[q] = val
    return out


def hist_quantiles(name: str, qs=(0.5, 0.95, 0.99)) -> dict:
    """Quantiles of registry histogram ``name`` (see
    :func:`quantiles_from_buckets`); ``{}`` when it never recorded."""
    reg = _registry
    with reg.lock:
        h = reg.hists.get(name)
        if h is None:
            return {}
        h = {"count": h["count"], "total": h["total"],
             "buckets": dict(h["buckets"])}
    return quantiles_from_buckets(h, qs)


def snapshot() -> dict:
    """JSON-safe view of everything recorded so far."""
    reg = _registry
    with reg.lock:
        return {
            "enabled": reg.enabled,
            "counters": dict(reg.counters),
            "gauges": dict(reg.gauges),
            "timers": {k: {"count": t[0], "total_s": t[1],
                           "min_s": t[2], "max_s": t[3]}
                       for k, t in reg.timers.items()},
            "hists": {k: {"count": h["count"], "total": h["total"],
                          "buckets": dict(h["buckets"])}
                      for k, h in reg.hists.items()},
        }


def snapshot_delta(before: dict, after: dict) -> dict:
    """What happened between two :func:`snapshot` calls: counters as
    differences, gauges that changed at their new value, timers and
    histograms that fired as count/total (and bucket) differences
    (``min_s``/``max_s`` are lifetime bounds, carried from ``after``)."""
    b_c = before.get("counters", {}) or {}
    counters = {k: v - b_c.get(k, 0.0)
                for k, v in (after.get("counters", {}) or {}).items()
                if v != b_c.get(k, 0.0)}
    b_g = before.get("gauges", {}) or {}
    gauges = {k: v for k, v in (after.get("gauges", {}) or {}).items()
              if k not in b_g or v != b_g[k]}
    b_t = before.get("timers", {}) or {}
    timers = {}
    for k, t in (after.get("timers", {}) or {}).items():
        prev = b_t.get(k, {})
        dc = t.get("count", 0) - prev.get("count", 0)
        if dc > 0:
            timers[k] = {"count": dc,
                         "total_s": t.get("total_s", 0.0)
                         - prev.get("total_s", 0.0),
                         "min_s": t.get("min_s"), "max_s": t.get("max_s")}
    b_h = before.get("hists", {}) or {}
    hists = {}
    for k, h in (after.get("hists", {}) or {}).items():
        prev = b_h.get(k, {})
        dc = h.get("count", 0) - prev.get("count", 0)
        if dc <= 0:
            continue
        pb = prev.get("buckets", {}) or {}
        hists[k] = {"count": dc,
                    "total": h.get("total", 0.0) - prev.get("total", 0.0),
                    "buckets": {bk: bv - pb.get(bk, 0)
                                for bk, bv in h.get("buckets", {}).items()
                                if bv != pb.get(bk, 0)}}
    return {"enabled": after.get("enabled", False), "delta": True,
            "counters": counters, "gauges": gauges, "timers": timers,
            "hists": hists}


_resilience_hint = [False]


def set_resilience_hint(on: bool) -> None:
    """Flag that a programmatic fault plan is installed (called by
    :func:`slate_tpu_torch.resilience.inject.install` / ``clear_plan``)."""
    _resilience_hint[0] = bool(on)


def resilience_wanted() -> bool:
    """Should the driver facades run the resilience post-conditions (fault
    injection at ``driver.output`` and the health gate)?  True when a plan
    is installed, ``SLATE_TPU_TORCH_FAULT_INJECT`` names one, or
    ``SLATE_TPU_TORCH_HEALTH`` names an active tier."""
    return (_resilience_hint[0]
            or bool(os.environ.get("SLATE_TPU_TORCH_FAULT_INJECT",
                                   "").strip())
            or os.environ.get("SLATE_TPU_TORCH_HEALTH", "").strip().lower()
            in ("warn", "retry", "strict"))


def instrument_driver(name: str):
    """Decorator for a public driver: counts calls (``driver.<name>.calls``)
    and host wall time (timer ``driver.<name>``) while the registry is
    on, and runs :func:`slate_tpu_torch.resilience.health.driver_gate`
    after the call while :func:`resilience_wanted`; a plain call-through
    while neither is."""

    label = "driver.%s" % name

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            resil = resilience_wanted()
            if not (_registry.enabled or resil):
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if _registry.enabled:
                inc(label + ".calls")
                observe_time(label, time.perf_counter() - t0)
            if resil:
                from ..resilience import health as _health

                out = _health.driver_gate(name, fn, args, kwargs, out)
            return out

        wrapper.__metrics_driver__ = name
        return wrapper

    return deco
