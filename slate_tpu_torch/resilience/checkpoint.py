"""Step-cadence checkpoint/restart for long factorizations — the port of
``slate_tpu/resilience/checkpoint.py``.

* **Cadence.**  ``SLATE_TPU_TORCH_CKPT_EVERY_STEPS`` (:func:`every_steps`)
  snapshots the factorization carry every K block-column steps.  Off (0
  or unset) by default, and then nothing here is consulted.
* **Snapshot = the step carry**: for ``pgetrf`` the local trailing
  window, the pivot vector and the in-flight panel ring; for ``ppotrf``
  the window and the ring.  :func:`snapshot` copies each tensor to the
  host (a copy, never an alias: the drivers update their carries in
  place), and the driver places a restored carry back on its device, so
  a resumed run replays the same arithmetic and reproduces the
  uninterrupted factors bitwise.
* **Recovery.**  :func:`run_checkpointed` polls the ``step.boundary``
  fault site after each chunk (an injected ``device_loss`` fires there)
  and catches classified-transient failures of the chunk; the chunk is
  then lost, the carry rewinds to the last snapshot (``ckpt.restored``,
  ``abft.restarted``) and the chunk reruns.  Non-transient errors and
  more than ``max_restarts`` restarts propagate.

Counters: ``ckpt.saved``, ``ckpt.restored``, ``abft.restarted``; flight
recorder events ``ckpt.restored``, ``abft.restarted`` and ``dist.chunk``,
and a ``device_loss`` trigger.  The JAX package also feeds each restart
to its live telemetry sentinel, which is not ported yet.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from ..perf import blackbox, metrics

__all__ = ["ENV_EVERY", "every_steps", "run_checkpointed", "snapshot"]

ENV_EVERY = "SLATE_TPU_TORCH_CKPT_EVERY_STEPS"


def every_steps() -> int:
    """The checkpoint cadence in block-column steps
    (``SLATE_TPU_TORCH_CKPT_EVERY_STEPS``); 0 = off (default)."""
    raw = os.environ.get(ENV_EVERY, "").strip()
    if not raw:
        return 0
    try:
        return max(0, int(raw))
    except ValueError:
        return 0


def snapshot(state):
    """A host copy of a step carry (nested tuples/lists of tensors, numpy
    arrays or scalars): every array leaf COPIED, so a chunk that updates
    its carry in place cannot touch the rewind image."""
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return tuple(snapshot(s) for s in state)
    if isinstance(state, torch.Tensor):
        return state.detach().to("cpu", copy=True)
    if isinstance(state, np.ndarray):
        return np.array(state, copy=True)
    return state


def run_checkpointed(total_steps: int, every: int, run_chunk: Callable,
                     label: str = "", max_restarts: int = 3,
                     agree: Optional[Callable[[bool], bool]] = None):
    """Drive ``run_chunk(carry, k0, k1)`` over ``[0, total_steps)`` in
    ``every``-step chunks, snapshotting at each boundary and restoring on
    a loss.  ``run_chunk`` gets the previous chunk's carry (None for the
    first; after a loss a fresh host copy of the last snapshot, which it
    places on its device) and returns the new one; it must be
    deterministic in its inputs.  ``agree(lost)`` (the distributed
    drivers) returns whether any rank lost the chunk, so that every rank
    restores together.  Returns the final carry."""
    from . import inject
    from .retry import transient_infra

    every = max(1, int(every))
    k = 0
    carry = None
    ck_k = 0
    ck_state = None
    restarts = 0
    while k < total_steps:
        k1 = min(k + every, total_steps)
        try:
            new_carry = run_chunk(carry, k, k1)
            kind = inject.poll("step.boundary")
            lost = kind in ("device_loss", "error")
            if agree is not None:
                lost = agree(lost)
            if lost:
                if kind == "error":
                    raise inject.InjectedFault("step.boundary")
                raise inject.DeviceLoss("step.boundary")
        except Exception as e:
            if not transient_infra(e) or restarts >= max(0, max_restarts):
                raise
            restarts += 1
            metrics.inc("ckpt.restored")
            metrics.inc("abft.restarted")
            blackbox.record("ckpt.restored", label=label or "ckpt",
                            lost_chunk=[int(k), int(k1)],
                            resume_step=int(ck_k),
                            error="%s: %s" % (type(e).__name__,
                                              str(e)[:200]))
            blackbox.record("abft.restarted", driver=label or "ckpt",
                            detail=str(e)[:200])
            if isinstance(e, inject.DeviceLoss):
                blackbox.trigger(
                    "device_loss", "%s: chunk [%d, %d) lost, resumed "
                    "at step %d" % (label or "ckpt", k, k1, ck_k))
            # the lost chunk reruns from a copy of the snapshot (or from
            # scratch when the first chunk never completed)
            k, carry = ck_k, snapshot(ck_state)
            continue
        blackbox.record("dist.chunk", label=label or "ckpt",
                        k0=int(k), k1=int(k1))
        carry, k = new_carry, k1
        if k < total_steps:
            ck_k, ck_state = k, snapshot(new_carry)
            metrics.inc("ckpt.saved")
    return carry
