"""slate_tpu_torch.resilience — detect, degrade, retry; the port of
``slate_tpu.resilience``:

* :mod:`~slate_tpu_torch.resilience.inject` — seeded fault injection
  (``SLATE_TPU_TORCH_FAULT_INJECT`` plans or :class:`FaultPlan`) at the
  serving dispatch, the driver outputs and trailing updates, the step
  boundaries and the distributed broadcasts;
* :mod:`~slate_tpu_torch.resilience.health` — the driver health gates
  (``SLATE_TPU_TORCH_HEALTH=off|warn|retry|strict``) and the stock
  backend they degrade to;
* :mod:`~slate_tpu_torch.resilience.breaker` — the serving queue's
  per-key circuit breaker;
* :mod:`~slate_tpu_torch.resilience.retry` — classified retry with
  backoff;
* :mod:`~slate_tpu_torch.resilience.abft` — checksum-carried
  factorizations and the detect → correct → recompute → restart ladder
  (``SLATE_TPU_TORCH_ABFT``), loaded by the drivers when asked for;
* :mod:`~slate_tpu_torch.resilience.checkpoint` — step-cadence snapshots
  (``SLATE_TPU_TORCH_CKPT_EVERY_STEPS``) that let a device loss mid-run
  resume bitwise.

Everything counts ``resilience.*``, ``abft.*`` and ``ckpt.*`` through
:mod:`slate_tpu_torch.perf.metrics` and records into the flight recorder
(:mod:`slate_tpu_torch.perf.blackbox`).
"""

from .inject import (  # noqa: F401
    FaultPlan, FaultSpec, InjectedFault, active, clear_plan, fault_here,
    get_plan, install, poll,
)
from .health import mode as health_mode, safe_backend  # noqa: F401
from .breaker import CircuitBreaker  # noqa: F401
from .retry import transient_infra, with_backoff  # noqa: F401
