"""Deterministic, seeded fault injection at the library's dispatch seams —
the port of ``slate_tpu/resilience/inject.py``.

* **Plans.**  A :class:`FaultPlan` is a set of :class:`FaultSpec`
  entries ``(site, kind, rate[, count])`` plus a seed, from the
  environment::

      SLATE_TPU_TORCH_FAULT_INJECT="site=kind:rate[:count],..."
      SLATE_TPU_TORCH_FAULT_SEED=1234          # default 0

  or programmatically: ``inject.install(FaultPlan(seed=7).add(
  "serve.dispatch", "error", rate=0.1))`` (wins over the environment
  until :func:`clear_plan`).

* **Determinism.**  Every seam calls :func:`poll` once per event; the
  decision for event ``i`` at ``site`` is a pure function of ``(seed,
  site, i)`` (``random.Random`` seeded with the string), and
  :func:`corrupt_bitflip`'s element is one of ``(seed, site, fired
  count)``, drawn with the same generator calls as the JAX package, so a
  plan with one seed fires at the same events and flips the same element
  in both packages.  :attr:`FaultPlan.log` records what fired.

* **Kinds.**  ``error`` raises :class:`InjectedFault` (transient);
  ``nan`` / ``inf`` poison one element of the seam's output; ``slow``
  sleeps :func:`slow_seconds` (``SLATE_TPU_TORCH_FAULT_SLOW_S``, default
  50 ms); ``bitflip`` flips one exponent bit of one seeded element
  (:func:`corrupt_bitflip`), the finite corruption the ABFT ladder
  (:mod:`~slate_tpu_torch.resilience.abft`) finds; ``device_loss`` raises
  :class:`DeviceLoss` (transient), which the checkpoint machinery
  (:mod:`~slate_tpu_torch.resilience.checkpoint`) resumes across.

* **Sites** wired: ``serve.dispatch`` (and a queue's
  ``ServeConfig.inject_site``), ``driver.output`` (the instrumented
  driver facades), ``driver.update`` (the ABFT trailing-update seam),
  ``step.boundary`` (between factorization steps and chunks) and
  ``dist.bcast`` (the fused panel broadcasts).  Unknown sites in a plan
  are legal and never poll.

* **Off.**  With no plan installed and no environment plan,
  :func:`poll` is one environment read returning None.
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..exceptions import SlateError
from ..perf import blackbox, metrics

__all__ = [
    "ENV_PLAN", "ENV_SEED", "ENV_SLOW_S", "KINDS", "DeviceLoss",
    "FaultPlan", "FaultSpec", "InjectedFault", "active", "clear_plan",
    "corrupt_bitflip", "corrupt_outputs", "fault_here", "flip_exponent_bit",
    "get_plan", "install", "iter_leaves", "parse_plan", "poll",
    "slow_seconds",
]

ENV_PLAN = "SLATE_TPU_TORCH_FAULT_INJECT"
ENV_SEED = "SLATE_TPU_TORCH_FAULT_SEED"
ENV_SLOW_S = "SLATE_TPU_TORCH_FAULT_SLOW_S"

KINDS = ("error", "nan", "inf", "slow", "bitflip", "device_loss")


def slow_seconds() -> float:
    """Added latency of the ``slow`` kind (``SLATE_TPU_TORCH_FAULT_SLOW_S``,
    default 0.05 s)."""
    try:
        return float(os.environ.get(ENV_SLOW_S, "").strip() or 0.05)
    except ValueError:
        return 0.05


class InjectedFault(SlateError):
    """A deliberately injected, transient failure (always retryable for
    :func:`slate_tpu_torch.resilience.retry.transient_infra`)."""

    def __init__(self, site: str, index: Optional[int] = None):
        self.site = site
        self.index = index
        at = "" if index is None else f" (event #{index})"
        super().__init__(f"injected fault at {site}{at}")


class DeviceLoss(InjectedFault):
    """An injected device loss mid-run (the ``device_loss`` kind): the
    checkpointed drivers resume from their last snapshot; anything else
    treats it as transient infrastructure trouble."""

    def __init__(self, site: str, index: Optional[int] = None):
        super().__init__(site, index)
        self.args = (f"injected device loss at {site}",)


@dataclass(frozen=True)
class FaultSpec:
    """One site's schedule: fire ``kind`` with probability ``rate`` per
    event, at most ``count`` times (None: unlimited)."""

    site: str
    kind: str
    rate: float = 1.0
    count: Optional[int] = None


class FaultPlan:
    """A seeded set of :class:`FaultSpec` with per-site event counters and
    a replay :attr:`log` of ``(site, event_index, kind)`` fired."""

    def __init__(self, specs: Optional[List[FaultSpec]] = None,
                 seed: int = 0):
        self.seed = int(seed)
        self.specs: Dict[str, FaultSpec] = {}
        for s in (specs or []):
            self.specs[s.site] = s
        self._events: Dict[str, int] = {}
        self._fired: Dict[str, int] = {}
        self.log: List[Tuple[str, int, str]] = []
        self._lock = threading.Lock()

    def add(self, site: str, kind: str, rate: float = 1.0,
            count: Optional[int] = None) -> "FaultPlan":
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; known: {KINDS}")
        self.specs[site] = FaultSpec(site, kind, float(rate), count)
        return self

    def poll(self, site: str) -> Optional[str]:
        """One event at ``site``: the kind to inject, or None."""
        spec = self.specs.get(site)
        if spec is None:
            return None
        with self._lock:
            idx = self._events.get(site, 0)
            self._events[site] = idx + 1
            if spec.count is not None \
                    and self._fired.get(site, 0) >= spec.count:
                return None
            r = random.Random(f"{self.seed}|{site}|{idx}").random()
            if r >= spec.rate:
                return None
            self._fired[site] = self._fired.get(site, 0) + 1
            self.log.append((site, idx, spec.kind))
        metrics.inc("resilience.inject." + site)
        blackbox.record("inject.fired", site=site, index=idx,
                        fault=spec.kind)
        return spec.kind

    def fired(self, site: Optional[str] = None) -> int:
        with self._lock:
            if site is not None:
                return self._fired.get(site, 0)
            return sum(self._fired.values())


def parse_plan(raw: str, seed: int = 0) -> FaultPlan:
    """Parse ``site=kind:rate[:count]`` entries, comma-separated.  A
    malformed entry raises: a plan that half-parses would pass tests it
    never ran."""
    plan = FaultPlan(seed=seed)
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            site, rest = part.split("=", 1)
            toks = rest.split(":")
            kind = toks[0].strip()
            rate = float(toks[1]) if len(toks) > 1 else 1.0
            count = int(toks[2]) if len(toks) > 2 else None
        except (ValueError, IndexError):
            raise ValueError(
                f"bad {ENV_PLAN} entry {part!r}; expected "
                "site=kind:rate[:count]") from None
        plan.add(site.strip(), kind, rate, count)
    return plan


# The active plan: an installed one wins over the environment's, which is
# cached per (plan, seed) string so its event counters persist.
_installed: List[Optional[FaultPlan]] = [None]
_env_cache: List[Optional[Tuple[Tuple[str, str], FaultPlan]]] = [None]


def install(plan: FaultPlan) -> FaultPlan:
    """Activate a programmatic plan (wins over the environment's)."""
    _installed[0] = plan
    metrics.set_resilience_hint(True)
    return plan


def clear_plan() -> None:
    _installed[0] = None
    _env_cache[0] = None
    metrics.set_resilience_hint(False)


def get_plan() -> Optional[FaultPlan]:
    if _installed[0] is not None:
        return _installed[0]
    raw = os.environ.get(ENV_PLAN, "").strip()
    if not raw:
        return None
    seed_raw = os.environ.get(ENV_SEED, "0").strip() or "0"
    cached = _env_cache[0]
    if cached is None or cached[0] != (raw, seed_raw):
        _env_cache[0] = ((raw, seed_raw), parse_plan(raw, int(seed_raw)))
    return _env_cache[0][1]


def active() -> bool:
    return get_plan() is not None


def poll(site: str) -> Optional[str]:
    """One fault-injection event at ``site``; None when no plan names it."""
    plan = get_plan()
    return plan.poll(site) if plan is not None else None


def fault_here(site: str) -> Optional[str]:
    """Poll ``site``: raise :class:`InjectedFault` on ``error``
    (:class:`DeviceLoss` on ``device_loss``), sleep a ``slow`` fault in
    place (returning None), else return the kind (``nan``/``inf``/
    ``bitflip``) for a seam that corrupts its own output."""
    kind = poll(site)
    if kind == "error":
        raise InjectedFault(site)
    if kind == "device_loss":
        raise DeviceLoss(site)
    if kind == "slow":
        time.sleep(slow_seconds())
        return None
    return kind


# ---------------------------------------------------------------------------
# Output corruption
# ---------------------------------------------------------------------------

def iter_leaves(x, out=None) -> list:
    """Array leaves of a driver result: tensors, numpy arrays, matrix
    wrappers (``.array``) and (named) tuples/lists."""
    if out is None:
        out = []
    if x is None or isinstance(x, (bool, int, float, complex, str)):
        return out
    if isinstance(x, (list, tuple)):
        for e in x:
            iter_leaves(e, out)
        return out
    arr = getattr(x, "array", x)
    if hasattr(arr, "shape") and hasattr(arr, "dtype"):
        out.append(arr)
    return out


def _is_float_array(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_floating_point() or x.is_complex()
    dt = getattr(x, "dtype", None)
    if dt is None or not hasattr(x, "shape"):
        return False
    return np.dtype(dt).kind in "fc"


def _poison(arr, kind: str):
    val = float("nan") if kind == "nan" else float("inf")
    if arr.ndim == 0:
        return arr
    idx = (0,) * arr.ndim
    out = arr.clone() if isinstance(arr, torch.Tensor) \
        else np.array(arr, copy=True)
    out[idx] = val
    return out


#: exponent bit flipped by the ``bitflip`` kind, per float width: bit 3 of
#: the biased exponent (fp32 bit 26, fp64 bit 55), which scales the value
#: by 2^±8 — large but finite (the exponent's top bit would overflow small
#: values to inf, which the finite checks already catch)
_FLIP_BIT = {4: 26, 8: 55}


def flip_exponent_bit(x):
    """One exponent-bit flip of a float scalar (numpy fp32/fp64): its
    integer bits XORed with :data:`_FLIP_BIT`."""
    x = np.asarray(x)
    itemsize = x.dtype.itemsize
    bit = _FLIP_BIT.get(itemsize)
    if bit is None:
        return x
    iview = np.array([x]).view(np.dtype("i%d" % itemsize))
    iview ^= np.dtype("i%d" % itemsize).type(1) << bit
    return iview.view(x.dtype)[0]


def _flip_site(shape, site: str) -> Tuple[int, int]:
    """The seeded element of a 2-D ``shape`` the next ``bitflip`` at
    ``site`` lands on: the JAX package's generator calls."""
    plan = get_plan()
    seed = plan.seed if plan is not None else 0
    idx = plan.fired(site) if plan is not None else 0
    rng = random.Random(f"{seed}|{site}|bitflip|{idx}")
    i = rng.randrange(shape[0])
    j = rng.randrange(shape[1])
    return i, j


def corrupt_bitflip(arr, site: str):
    """Flip one exponent bit of ONE seeded element of a 2-D array (numpy or
    tensor; a tensor is corrupted where it lies, one element read and
    written).  Returns ``(corrupted copy, (i, j))``."""
    if isinstance(arr, torch.Tensor):
        out = arr.clone()
        if out.ndim != 2 or out.numel() == 0:
            return out, (0, 0)
        i, j = _flip_site(out.shape, site)
        v = flip_exponent_bit(out[i, j].cpu().numpy())
        out[i, j] = torch.as_tensor(v, device=out.device)
        return out, (i, j)
    out = np.array(arr, copy=True)
    if out.ndim != 2 or out.size == 0:
        return out, (0, 0)
    i, j = _flip_site(out.shape, site)
    out[i, j] = flip_exponent_bit(out[i, j])
    return out, (i, j)


def corrupt_outputs(out, kind: str):
    """A driver result tree with ONE poison value in element [0, ..., 0] of
    its first floating-point raw-array leaf (tensor or numpy); leaves
    inside matrix wrappers are left alone; tuples, lists and namedtuples
    are rebuilt."""
    state = {"done": False}

    def walk(x):
        if state["done"] or x is None \
                or isinstance(x, (bool, int, float, complex, str)):
            return x
        if isinstance(x, (list, tuple)):
            vals = [walk(e) for e in x]
            if hasattr(x, "_fields"):            # namedtuple
                return type(x)(*vals)
            return type(x)(vals)
        if _is_float_array(x) and not hasattr(x, "array"):
            state["done"] = True
            return _poison(x, kind)
        return x

    return walk(out)
