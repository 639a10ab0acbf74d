"""slate_tpu_torch.resilience — the part of ``slate_tpu.resilience`` the
serving queue needs: classified retry with backoff
(:mod:`~slate_tpu_torch.resilience.retry`), the per-key circuit breaker
(:mod:`~slate_tpu_torch.resilience.breaker`) and the health tier with
the safe stock backend (:mod:`~slate_tpu_torch.resilience.health`).
Fault injection, the driver health gates, ABFT and checkpointing are not
ported yet (ROADMAP.md, queue 1 item 10)."""

from .breaker import CircuitBreaker  # noqa: F401
from .health import mode as health_mode, safe_backend  # noqa: F401
from .retry import transient_infra, with_backoff  # noqa: F401
