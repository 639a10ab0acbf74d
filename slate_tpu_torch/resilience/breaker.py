"""Per-key circuit breaker — the port of
``slate_tpu/resilience/breaker.py``.

``threshold`` consecutive failures OPEN it; after ``cooldown_s`` it goes
HALF-OPEN and admits one trial — success closes it, failure re-opens.
Transitions count ``<prefix>.open`` / ``.half_open`` / ``.close`` and are
flight-recorder events (:mod:`slate_tpu_torch.perf.blackbox`); an open
is a trigger.  The forced open (``trip``) of the JAX package serves its
telemetry sentinel, which is not ported yet."""

from __future__ import annotations

import threading
import time

from ..perf import blackbox, metrics

__all__ = ["CircuitBreaker"]

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    def __init__(self, threshold: int = 3, cooldown_s: float = 1.0,
                 name: str = "", metric_prefix: str = "breaker",
                 clock=time.monotonic):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self.name = name
        self._prefix = metric_prefix
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May the caller try the fast path now?  OPEN past its cool-down
        admits one HALF-OPEN trial; callers during the trial are
        refused."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN \
                    and self._clock() - self._opened_at >= self.cooldown_s:
                self._state = HALF_OPEN
                metrics.inc(self._prefix + ".half_open")
                blackbox.record("breaker.half_open", name=self.name)
                return True
            return False

    def success(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                metrics.inc(self._prefix + ".close")
                blackbox.record("breaker.close", name=self.name)
            self._state = CLOSED
            self._failures = 0

    def failure(self) -> None:
        with self._lock:
            opened = self._state == HALF_OPEN    # the trial failed
            if not opened:
                self._failures += 1
                opened = (self._state == CLOSED
                          and self._failures >= self.threshold)
            if opened:
                self._state = OPEN
                self._opened_at = self._clock()
                metrics.inc(self._prefix + ".open")
        if opened:
            # outside the lock: a dump writes a file
            blackbox.record("breaker.open", name=self.name)
            blackbox.trigger("breaker.open", self.name)
