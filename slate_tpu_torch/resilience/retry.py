"""Classified retry-with-exponential-backoff for transient infrastructure
errors — the port of ``slate_tpu/resilience/retry.py``.  The serving
queue retries a batch dispatch only when :func:`transient_infra` says
the failure is infrastructure trouble, never a numerical or programming
error.  An injected fault (:class:`~.inject.InjectedFault`, and so an
injected :class:`~.inject.DeviceLoss`) is always transient."""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

from ..perf import metrics

__all__ = ["transient_infra", "with_backoff"]

#: lowercase substrings that mark an exception as transient
#: infrastructure trouble rather than a numerical or programming error
#: (deliberately not "init", which would match every ``__init__()``
#: TypeError)
_TRANSIENT_PATTERNS = (
    "unavailable", "deadline", "rpc", "connection", "hostname",
    "worker", "initialize", "initialization", "timed out", "timeout",
    "temporarily", "resource exhausted", "libtpu", "already in use",
    "aborted",
)

#: exception classes that are deterministic programming errors however
#: their message reads — never absorbed by a retry
_NEVER_TRANSIENT = (TypeError, AttributeError, NameError, KeyError,
                    IndexError, AssertionError, SyntaxError)


def transient_infra(e: BaseException) -> bool:
    """True when ``e`` looks like transient infrastructure trouble — the
    only class of failure a retry may absorb."""
    from .inject import InjectedFault

    if isinstance(e, InjectedFault):
        return True
    if getattr(e, "retryable", False):
        return True
    if isinstance(e, _NEVER_TRANSIENT):
        return False
    if isinstance(e, (OSError, TimeoutError, ConnectionError)):
        return True
    msg = ("%s: %s" % (type(e).__name__, e)).lower()
    return any(p in msg for p in _TRANSIENT_PATTERNS)


def with_backoff(fn: Callable, attempts: int = 2, base_s: float = 0.05,
                 classify: Optional[Callable[[BaseException], bool]] = None,
                 metric: str = "resilience.retries",
                 sleep: Callable[[float], None] = time.sleep
                 ) -> Tuple[object, int]:
    """Run ``fn()`` with up to ``attempts`` tries; retry only failures
    ``classify`` accepts (None: any exception), backing off
    ``base_s * 2**retry`` between tries.  Returns ``(result,
    retries_used)``; the last failure (or the first one ``classify``
    rejects) propagates unchanged."""
    retries = 0
    while True:
        try:
            return fn(), retries
        except Exception as e:
            if retries + 1 >= max(1, attempts):
                raise
            if classify is not None and not classify(e):
                raise
            metrics.inc(metric)
            sleep(base_s * (2 ** retries))
            retries += 1
