"""Request-batching queue in front of the batched drivers — the serving
front door, the port of ``slate_tpu/serve/queue.py``.

A serving process receives a stream of small independent problems; this
module batches them:

* :meth:`BatchQueue.submit` takes one problem (``op``, host operands),
  returns a :class:`concurrent.futures.Future` and files the request in
  a **bucket** keyed by ``(op, dtype, pow2 dims)`` (operands padded to
  ``[[A, 0], [0, I]]``, results sliced back), so one executable serves a
  bucket;
* a dispatcher thread drains buckets under a **max-wait / max-batch**
  policy: a bucket dispatches once it holds ``max_batch`` requests or its
  oldest request has waited ``max_wait_s``;
* each dispatch pads the batch to its pow2 occupancy, runs the bucket's
  executable and resolves the futures with per-problem slices.

An **executable** here is the batched driver
(:mod:`slate_tpu_torch.linalg.batched`) bound to a (bucket, padded
batch) key on the queue's device: it takes the padded host batch, makes
one host-to-device copy per operand, calls the driver and returns numpy,
as the JAX package's AOT executable does.  **Building** one
(:meth:`BatchQueue.warm`, :func:`warm_start`, or the first request of a
cold bucket) runs it once on an identity batch, which loads the kernel
libraries and cuSOLVER's handle before the first request is timed.
CUDA graphs in their place are later work.

The dispatcher runs under ``torch.cuda.device(config.device)``; a kernel
launch is a ctypes call, which releases the GIL, so submitters keep
running while the card works.

**The hardened path** (as the JAX package): per-request deadlines
(``TimeoutError``), classified retry with backoff of a transient batch
failure (:mod:`slate_tpu_torch.resilience.retry`), a per-(op, bucket)
circuit breaker whose open state — and any transient batch failure —
serves the batch problem by problem on the stock backend
(:func:`slate_tpu_torch.resilience.health.safe_backend`), explicit
:class:`Backpressure` past ``max_queue_depth``, ``close()`` failing (never
stranding) queued futures and ``flush(timeout)`` raising on expiry.  Under
every ``SLATE_TPU_TORCH_HEALTH`` tier but ``off``, a non-finite batch
result counts as a transient failure.  A failure that is not transient (a kernel launch
error among them) fails the batch's futures with that error.

Counters (:mod:`slate_tpu_torch.perf.metrics`, while it is on):
``serve.requests``, ``serve.dispatches`` (and ``serve.dispatches.<op>``),
``serve.errors``, ``serve.retries``, ``serve.fallback.singles``,
``serve.singles``, ``serve.singles.batches``, ``serve.breaker.*``,
``serve.deadline_expired``, ``serve.backpressure``,
``serve.closed_undispatched``, ``serve.health.batch_nonfinite``,
``serve.device_loss``, ``serve.compile.on_demand`` and
``serve.warm_start.compiled``; the
``serve.queue.depth`` gauge, the ``serve.wait`` and ``serve.dispatch``
timers and the ``serve.batch.occupancy`` histogram.

**Fault injection** (:mod:`slate_tpu_torch.resilience.inject`): each
batch dispatch polls the queue's own site (``ServeConfig.inject_site``,
so a plan can target one replica) and then ``serve.dispatch``: ``error``
and ``device_loss`` raise transient failures (the retry and singles
ladder absorbs them; a device loss also counts ``serve.device_loss``),
``slow`` sleeps, ``nan``/``inf`` poison the batch result.

Not ported yet (ROADMAP.md, queue 1, "Perf tooling" and "Fleet serving,
the APIs and the examples"): request telemetry and SLO histograms, the
fleet knobs (``preempt``, ``drain_queued``, fault listeners) and
warm-start specs from the autotune cache or a bundle.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..exceptions import SlateError
from ..perf import metrics
from ..perf.sweep import pow2_bucket as _pow2_bucket
from ..resilience import health as _health
from ..resilience import inject as _inject
from ..resilience.breaker import CircuitBreaker
from ..resilience.retry import transient_infra, with_backoff

__all__ = ["ServeConfig", "BatchQueue", "Backpressure", "warm_start",
           "get_server", "submit", "shutdown", "SUPPORTED_OPS"]


class Backpressure(SlateError):
    """The queue is at its depth bound: shed load or retry later."""


class _UnhealthyBatch(SlateError):
    """A batch result failed the finite check with the health check on
    — handled like a transient dispatch failure."""


def _finite_arrays(out) -> bool:
    """Every float array of a dispatch result is finite (int arrays —
    permutations — pass)."""
    return all(o.dtype.kind not in "fc" or np.isfinite(o).all() for o in out)


def _bucket(d: int, policy: str = "pow2", floor: int = 8) -> int:
    """Pow2 shape bucket (floor 8 for dims, as the autotune keys; batch
    occupancy buckets pass floor=1), or the exact dim."""
    if policy == "exact":
        return int(d)
    return _pow2_bucket(d, floor)


@dataclass
class ServeConfig:
    """Queue policy knobs.

    * ``max_batch`` — dispatch a bucket once it holds this many requests
      (also the executable's largest padded batch).
    * ``max_wait_s`` — dispatch a bucket once its oldest request has
      waited this long.
    * ``bucket`` — ``"pow2"`` (pad dims to the next power of two) or
      ``"exact"``.
    * ``deadline_s`` — default per-request deadline (None: none).
    * ``max_retries`` / ``retry_backoff_s`` — retries of a transient
      batch failure, with exponential backoff.
    * ``breaker_threshold`` / ``breaker_cooldown_s`` — consecutive batch
      failures before a bucket's breaker opens, and its cool-down.
    * ``max_queue_depth`` — queued requests before :meth:`BatchQueue.
      submit` raises :class:`Backpressure`.
    * ``device`` — where the executables run (``"cuda"``; the tests pass
      ``"cpu"``).
    * ``inject_site`` — a fault-injection site polled before
      ``serve.dispatch`` on each batch dispatch (None: none).
    """

    max_batch: int = 64
    max_wait_s: float = 0.002
    bucket: str = "pow2"
    deadline_s: Optional[float] = None
    max_retries: int = 2
    retry_backoff_s: float = 0.005
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 0.25
    max_queue_depth: int = 4096
    device: object = "cuda"
    inject_site: Optional[str] = None


@dataclass(eq=False)
class _Request:
    operands: tuple
    shape: tuple            # original dims, for unpadding
    future: concurrent.futures.Future = field(
        default_factory=concurrent.futures.Future)
    t_submit: float = field(default_factory=time.perf_counter)
    deadline: Optional[float] = None    # absolute perf_counter time


#: op name → number of operands; each op maps onto one batched driver
SUPPORTED_OPS = {"potrf": 1, "getrf": 1, "posv": 2, "gesv": 2,
                 "geqrf": 1, "gels": 2, "heev": 1}


def _exec_key(op: str, dt: str, pol: str, dims: tuple,
              nrhs: int = 1) -> tuple:
    """The executable bucket key for RAW problem dims, shared by
    :meth:`BatchQueue.bucket_key` and :meth:`BatchQueue.warm`.  Tall ops
    bump the padded rows until ``M − m ≥ N − n`` (``_pad_tall`` anchors
    each padded column in its own padded row); the nrhs bucket has floor
    1."""
    if op in ("potrf", "getrf", "heev"):
        return (op, dt, _bucket(dims[0], pol))
    if op in ("posv", "gesv"):
        return (op, dt, _bucket(dims[0], pol), _bucket(nrhs, pol, floor=1))
    if op in ("geqrf", "gels"):
        m, n = dims
        big_m, big_n = _bucket(m, pol), _bucket(n, pol)
        while big_m - m < big_n - n:
            big_m *= 2
        if op == "geqrf":
            return (op, dt, big_m, big_n)
        return (op, dt, big_m, big_n, _bucket(nrhs, pol, floor=1))
    raise KeyError(f"unsupported serve op {op!r}; "
                   f"known: {sorted(SUPPORTED_OPS)}")


def _pad_square(a, big):
    """Embed (n, n) into (N, N) as ``[[A, 0], [0, I]]`` — stays SPD /
    nonsingular, and the padded block factors to the identity without
    touching the leading problem."""
    n = a.shape[0]
    if big == n:
        return np.asarray(a)
    out = np.zeros((big, big), a.dtype)
    out[:n, :n] = np.asarray(a)
    idx = np.arange(n, big)
    out[idx, idx] = 1.0
    return out


def _pad_heev(a, big):
    """Embed a Hermitian (n, n) into (N, N) as ``[[A, 0], [0, αI]]`` with
    α above A's spectral radius (the ∞-norm bound + 1), so A's eigenpairs
    occupy the first n ascending slots, eigenvectors ``[v; 0]``."""
    n = a.shape[0]
    av = np.asarray(a)
    if big == n:
        return av
    out = np.zeros((big, big), av.dtype)
    out[:n, :n] = av
    alpha = float(np.abs(av).sum(axis=1).max().real) + 1.0
    idx = np.arange(n, big)
    out[idx, idx] = alpha
    return out


def _pad_tall(a, big_m, big_n):
    """Embed a tall (m, n) least-squares operand into (M, N): unit
    columns for the padded unknowns in the padded rows (full column
    rank, ``x' = [x; 0]`` for ``b' = [b; 0]``).  Needs ``M − m ≥ N − n``."""
    m, n = a.shape
    if (big_m, big_n) == (m, n):
        return np.asarray(a)
    out = np.zeros((big_m, big_n), a.dtype)
    out[:m, :n] = np.asarray(a)
    k = big_n - n
    if k:
        out[m + np.arange(k), n + np.arange(k)] = 1.0
    return out


def _pad_rhs(b, big_rows, big_cols):
    bv = np.asarray(b)
    out = np.zeros((big_rows, big_cols), bv.dtype)
    if bv.ndim == 1:
        out[:bv.shape[0], 0] = bv
    else:
        out[:bv.shape[0], :bv.shape[1]] = bv
    return out


def _host(x) -> np.ndarray:
    """A request operand as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class BatchQueue:
    """The serving front door: request buckets + dispatcher thread +
    per-(bucket, padded batch) executables."""

    def __init__(self, config: Optional[ServeConfig] = None):
        from ..config import resolve_device

        self.config = config or ServeConfig()
        self._device = resolve_device(self.config.device)
        self._buckets: Dict[tuple, List[_Request]] = {}
        self._compiled: Dict[tuple, object] = {}
        self._breakers: Dict[tuple, CircuitBreaker] = {}
        self._inflight = 0              # popped but not yet resolved
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._build_lock = threading.Lock()
        self._closed = False
        self._thread: Optional[threading.Thread] = None

    # -- bucketing ---------------------------------------------------------

    def bucket_key(self, op: str, operands) -> tuple:
        """``(op, dtype, padded dims...)`` — the executable identity minus
        the padded batch (:func:`_exec_key`, shared with :meth:`warm`)."""
        a = operands[0]
        nrhs = 1
        if op in ("posv", "gesv", "gels"):
            b = operands[1]
            nrhs = 1 if b.ndim == 1 else b.shape[1]
        dims = tuple(a.shape) if op in ("geqrf", "gels") else (a.shape[0],)
        return _exec_key(op, str(a.dtype), self.config.bucket, dims, nrhs)

    # -- public API --------------------------------------------------------

    def submit(self, op: str, *operands,
               deadline_s: Optional[float] = None
               ) -> concurrent.futures.Future:
        """File one problem; returns the Future of its result, the
        batched driver's per-problem output as numpy: potrf → L, getrf →
        (LU, perm), posv/gesv/gels → x, geqrf → (packed, taus), heev →
        (w, Z).  Operands are numpy arrays or tensors (copied to the host
        here).  A request still queued past ``deadline_s`` (default
        :attr:`ServeConfig.deadline_s`) resolves with ``TimeoutError``;
        raises :class:`Backpressure` at
        :attr:`ServeConfig.max_queue_depth`."""
        if op not in SUPPORTED_OPS:
            raise KeyError(f"unsupported serve op {op!r}; "
                           f"known: {sorted(SUPPORTED_OPS)}")
        if len(operands) != SUPPORTED_OPS[op]:
            raise TypeError(f"{op} takes {SUPPORTED_OPS[op]} operands, "
                            f"got {len(operands)}")
        operands = tuple(_host(x) for x in operands)
        key = self.bucket_key(op, operands)
        if deadline_s is None:
            deadline_s = self.config.deadline_s
        req = _Request(operands=operands,
                       shape=tuple(x.shape for x in operands))
        if deadline_s is not None:
            req.deadline = req.t_submit + float(deadline_s)
        with self._wake:
            if self._closed:
                raise RuntimeError("BatchQueue is closed")
            depth = sum(len(v) for v in self._buckets.values())
            if depth >= self.config.max_queue_depth:
                metrics.inc("serve.backpressure")
                raise Backpressure(
                    f"serve queue at its depth bound ({depth} >= "
                    f"{self.config.max_queue_depth}); shed load or retry "
                    "later")
            self._buckets.setdefault(key, []).append(req)
            depth += 1
            self._ensure_thread()
            self._wake.notify_all()
        metrics.inc("serve.requests")
        metrics.set_gauge("serve.queue.depth", float(depth))
        return req.future

    def flush(self, timeout: Optional[float] = None) -> None:
        """Block until every queued and in-flight request has been
        dispatched; with a ``timeout``, raise ``TimeoutError`` on expiry
        rather than return with work pending."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._wake:
            while any(self._buckets.values()) or self._inflight:
                rem = None if deadline is None \
                    else deadline - time.perf_counter()
                if rem is not None and rem <= 0.0:
                    pending = (sum(len(v) for v in self._buckets.values())
                               + self._inflight)
                    raise TimeoutError(
                        f"BatchQueue.flush: {pending} request(s) still "
                        f"pending after {timeout}s")
                self._wake.wait(timeout=rem if rem is not None
                                else self.config.max_wait_s)

    def queue_depth(self) -> int:
        """Queued, not yet dispatched requests."""
        with self._lock:
            return sum(len(v) for v in self._buckets.values())

    def close(self) -> None:
        """Stop taking work, let the dispatcher drain what it can, then
        FAIL — never strand — every future still queued (a dead
        dispatcher, or one stuck behind a hung dispatch)."""
        with self._wake:
            self._closed = True
            self._wake.notify_all()
            thread = self._thread
        if thread is not None and thread.is_alive():
            thread.join(timeout=30.0)
        with self._wake:
            leftovers = [r for reqs in self._buckets.values() for r in reqs]
            self._buckets.clear()
        for r in leftovers:
            if not r.future.done():
                metrics.inc("serve.closed_undispatched")
                r.future.set_exception(SlateError(
                    "BatchQueue closed before this request was dispatched"))

    # -- warm start --------------------------------------------------------

    def warm(self, op: str, batch: int, *dims, dtype="float32",
             nrhs: int = 1) -> int:
        """Build the executables serving ``(op, dims...)`` at every pow2
        batch occupancy up to the padded ``batch`` (RAW dims: ``(n,)``
        square, ``(m, n)`` tall; the key is :func:`_exec_key`'s, as on
        the request path).  Returns the number newly built."""
        key = _exec_key(op, str(np.dtype(dtype)), self.config.bucket,
                        tuple(dims), int(nrhs))
        done = 0
        bexec = 1
        cap = _bucket(min(batch, self.config.max_batch), "pow2", floor=1)
        while bexec <= cap:
            _, built = self._get_executable(key, bexec, on_demand=False)
            done += int(built)
            bexec *= 2
        return done

    # -- dispatcher --------------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._loop,
                                            name="slate-serve-dispatch",
                                            daemon=True)
            self._thread.start()

    def _loop(self) -> None:
        cfg = self.config
        while True:
            with self._wake:
                while not any(self._buckets.values()) and not self._closed:
                    self._wake.wait()
                if self._closed and not any(self._buckets.values()):
                    return
                now = time.perf_counter()
                # requests past their deadline resolve with TimeoutError
                # and never ride a dispatch
                expired: List[Tuple[tuple, _Request]] = []
                for key in list(self._buckets):
                    live: List[_Request] = []
                    for r in self._buckets[key]:
                        if r.deadline is not None and now >= r.deadline:
                            expired.append((key, r))
                        else:
                            live.append(r)
                    if live:
                        self._buckets[key] = live
                    else:
                        del self._buckets[key]
                ready, soonest = [], None
                for key, reqs in self._buckets.items():
                    age = now - reqs[0].t_submit
                    if (len(reqs) >= cfg.max_batch or self._closed
                            or age >= cfg.max_wait_s):
                        ready.append(key)
                    else:
                        due = reqs[0].t_submit + cfg.max_wait_s
                        soonest = due if soonest is None else min(soonest, due)
                        if reqs[0].deadline is not None:
                            soonest = min(soonest, reqs[0].deadline)
                batches: List[Tuple[tuple, List[_Request]]] = []
                for key in ready:
                    reqs = self._buckets[key]
                    batches.append((key, reqs[:cfg.max_batch]))
                    rest = reqs[cfg.max_batch:]
                    if rest:
                        self._buckets[key] = rest
                    else:
                        del self._buckets[key]
                # expired requests count as in flight until their
                # TimeoutError is set, so flush() never sees an empty
                # queue with a future unresolved
                self._inflight += (sum(len(r) for _, r in batches)
                                   + len(expired))
                if not batches and not expired and soonest is not None:
                    self._wake.wait(timeout=max(soonest - now, 1e-4))
            for key, r in expired:
                metrics.inc("serve.deadline_expired")
                if not r.future.done():
                    r.future.set_exception(TimeoutError(
                        "serve request deadline expired before dispatch"))
            if expired:
                with self._wake:
                    self._inflight -= len(expired)
                    self._wake.notify_all()
            for key, reqs in batches:
                try:
                    self._dispatch(key, reqs)
                finally:
                    with self._wake:
                        self._inflight -= len(reqs)
                        self._wake.notify_all()
            if batches or expired:
                with self._wake:
                    depth = sum(len(v) for v in self._buckets.values())
                metrics.set_gauge("serve.queue.depth", float(depth))

    # -- executables -------------------------------------------------------

    def _device_scope(self):
        """``torch.cuda.device`` of the queue's device (a null context on
        the CPU): builds and dispatches run under it."""
        if self._device.type == "cuda":
            return torch.cuda.device(self._device)
        return contextlib.nullcontext()

    def _driver(self, op: str):
        from ..linalg import batched as B

        return {
            "potrf": B.potrf_batched,
            "getrf": B.getrf_batched,
            "posv": lambda a, b, device: B.posv_batched(a, b, device=device)[1],
            "gesv": lambda a, b, device: B.gesv_batched(a, b, device=device)[2],
            "geqrf": B.geqrf_batched,
            "gels": B.gels_batched,
            "heev": B.heev_batched,
        }[op]

    def _run(self, op: str, host: tuple) -> tuple:
        """Driver ``op`` on a padded host batch: one host-to-device copy
        per operand, the driver on the queue's device, numpy back."""
        dev = self._device
        args = [torch.from_numpy(np.require(h, requirements=("C", "W"))).to(dev)
                for h in host]
        out = self._driver(op)(*args, device=dev)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        return tuple(o.cpu().numpy() for o in outs)

    def _identity_batch(self, key: tuple, bexec: int) -> tuple:
        """The batch a build runs once: identity problems (zero
        right-hand sides), which every driver of the bucket takes."""
        op, dt = key[0], np.dtype(key[1])
        if op in ("geqrf", "gels"):
            m, n = key[2], key[3]
            a = np.broadcast_to(_pad_tall(np.eye(min(m, n), n, dtype=dt),
                                          m, n), (bexec, m, n))
            rows = m
        else:
            rows = n = key[2]
            a = np.broadcast_to(np.eye(n, dtype=dt), (bexec, n, n))
        if op in ("posv", "gesv", "gels"):
            return a, np.zeros((bexec, rows, key[-1]), dt)
        return (a,)

    def _get_executable(self, key: tuple, bexec: int,
                        on_demand: bool = True):
        """The executable of (bucket, padded batch), built on first use:
        returns ``(executable, built)``, ``built`` False on a hit."""
        ck = key + (bexec,)
        with self._build_lock:
            ex = self._compiled.get(ck)
            if ex is not None:
                return ex, False
            metrics.inc("serve.compile.on_demand" if on_demand
                        else "serve.warm_start.compiled")

            def ex(*host, op=key[0]):
                return self._run(op, host)

            with self._device_scope():
                ex(*self._identity_batch(key, bexec))
            self._compiled[ck] = ex
            return ex, True

    # -- the dispatch ladder -----------------------------------------------

    def _breaker(self, key: tuple) -> CircuitBreaker:
        cb = self._breakers.get(key)
        if cb is None:
            cb = self._breakers[key] = CircuitBreaker(
                threshold=self.config.breaker_threshold,
                cooldown_s=self.config.breaker_cooldown_s,
                name="%s/%s" % (key[0], "x".join(str(d) for d in key[2:])),
                metric_prefix="serve.breaker")
        return cb

    def _dispatch(self, key: tuple, reqs: List[_Request]) -> None:
        """One bucket dispatch: breaker check → the batch (with
        classified retries) → on a transient failure, problem by problem
        on the stock backend.  Every future resolves, with a result or an
        exception, whatever fails."""
        t0 = time.perf_counter()
        metrics.inc("serve.dispatches")
        metrics.inc("serve.dispatches.%s" % key[0])
        metrics.observe("serve.batch.occupancy", float(len(reqs)))
        for r in reqs:
            metrics.observe_time("serve.wait", t0 - r.t_submit)
        cb = self._breaker(key)
        if not cb.allow():
            # open breaker: the failing fast path is not touched
            metrics.inc("serve.breaker.short_circuit")
            self._dispatch_singles(key, reqs)
            return
        try:
            out = self._execute_batch(key, reqs)
        except Exception as e:
            cb.failure()
            metrics.inc("serve.errors")
            if transient_infra(e) or isinstance(e, _UnhealthyBatch):
                metrics.inc("serve.fallback.singles")
                self._dispatch_singles(key, reqs)
            else:                   # the caller's error, or the kernel's
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(e)
            return
        cb.success()
        for i, r in enumerate(reqs):
            try:
                r.future.set_result(self._unpad(key, r, out, i))
            except Exception as e:
                if not r.future.done():
                    r.future.set_exception(e)

    def _execute_batch(self, key: tuple, reqs: List[_Request]) -> tuple:
        """The batched fast path: pad, run the executable, and — with the
        health check on — check finiteness.  Transient failures retry
        up to ``max_retries`` times with exponential backoff; the last
        one propagates to :meth:`_dispatch`."""
        def attempt():
            # the queue's own site first, so a plan can target one replica
            # while a serve.dispatch schedule runs on every dispatch
            kind, site = None, "serve.dispatch"
            if self.config.inject_site:
                kind = _inject.poll(self.config.inject_site)
                if kind is not None:
                    site = self.config.inject_site
            if kind is None:
                kind = _inject.poll("serve.dispatch")
            if kind == "error":
                raise _inject.InjectedFault(site)
            if kind == "device_loss":
                metrics.inc("serve.device_loss")
                raise _inject.DeviceLoss(site)
            if kind == "slow":
                time.sleep(_inject.slow_seconds())
            cap = _bucket(self.config.max_batch, "pow2", floor=1)
            bexec = min(_bucket(len(reqs), "pow2", floor=1), cap)
            ex, _ = self._get_executable(key, bexec)
            stacked = self._pad_stack(key, reqs, bexec)
            with metrics.timer("serve.dispatch"), self._device_scope():
                out = ex(*stacked)
            if kind in ("nan", "inf"):
                out = _inject.corrupt_outputs(out, kind)
            if _health.mode() != "off" and not _finite_arrays(out):
                metrics.inc("serve.health.batch_nonfinite")
                raise _UnhealthyBatch(
                    f"non-finite values in the {key[0]} batch result")
            return out

        def retryable(e: BaseException) -> bool:
            return transient_infra(e) or isinstance(e, _UnhealthyBatch)

        out, _ = with_backoff(
            attempt, attempts=1 + max(0, self.config.max_retries),
            base_s=self.config.retry_backoff_s, classify=retryable,
            metric="serve.retries")
        return out

    def _dispatch_singles(self, key: tuple, reqs: List[_Request]) -> None:
        """The degraded path: each request alone through the batched
        driver at batch 1, on the stock backend (never the bucket's
        executable).  One bad problem fails one future."""
        metrics.inc("serve.singles.batches")
        with _health.safe_backend(), self._device_scope():
            for r in reqs:
                if r.future.done():
                    continue
                if r.deadline is not None \
                        and time.perf_counter() >= r.deadline:
                    metrics.inc("serve.deadline_expired")
                    r.future.set_exception(TimeoutError(
                        "serve request deadline expired during degraded "
                        "dispatch"))
                    continue
                try:
                    out = self._run(key[0], self._pad_stack(key, [r], 1))
                    if _health.mode() != "off" and not _finite_arrays(out):
                        raise SlateError(
                            f"{key[0]}: non-finite result even on the "
                            "stock backend")
                    r.future.set_result(self._unpad(key, r, out, 0))
                    metrics.inc("serve.singles")
                except Exception as e:
                    if not r.future.done():
                        r.future.set_exception(e)

    def _pad_stack(self, key: tuple, reqs: List[_Request], bexec: int):
        """The requests padded to the bucket and stacked, the batch
        filled up to ``bexec`` with the bucket's identity problems."""
        op, dt = key[0], np.dtype(key[1])
        fill = self._identity_batch(key, bexec - len(reqs))
        if op in ("geqrf", "gels"):
            m, n = key[2], key[3]
            a = [_pad_tall(r.operands[0], m, n) for r in reqs]
            rows = m
        else:
            rows = n = key[2]
            pad = _pad_heev if op == "heev" else _pad_square
            a = [pad(r.operands[0], n) for r in reqs]
        a = np.concatenate([np.stack(a).astype(dt), fill[0]])
        if op not in ("posv", "gesv", "gels"):
            return (a,)
        b = np.stack([_pad_rhs(r.operands[1], rows, key[-1]) for r in reqs])
        return a, np.concatenate([b.astype(dt), fill[1]])

    def _unpad(self, key: tuple, req: _Request, out: tuple, i: int):
        op = key[0]
        a_shape = req.shape[0]
        if op == "potrf":
            n = a_shape[0]
            return out[0][i, :n, :n]
        if op == "getrf":
            n = a_shape[0]
            return out[0][i, :n, :n], out[1][i, :n]
        if op == "heev":
            n = a_shape[0]
            return out[0][i, :n], out[1][i, :n, :n]
        if op in ("posv", "gesv", "gels"):
            n = a_shape[0] if op != "gels" else a_shape[1]
            b_shape = req.shape[1]
            x = out[0][i, :n]
            return x[:, 0] if len(b_shape) == 1 else x[:, :b_shape[1]]
        if op == "geqrf":
            m, n = a_shape
            return out[0][i, :m, :n], out[1][i, :n]
        raise KeyError(op)


# ---------------------------------------------------------------------------
# Module-level default server + warm start
# ---------------------------------------------------------------------------

_default: List[Optional[BatchQueue]] = [None]
_default_lock = threading.Lock()


def get_server(config: Optional[ServeConfig] = None) -> BatchQueue:
    """The process-default :class:`BatchQueue` (created on first use;
    ``config`` applies only to the creating call)."""
    with _default_lock:
        if _default[0] is None or _default[0]._closed:
            _default[0] = BatchQueue(config)
        return _default[0]


def submit(op: str, *operands,
           deadline_s: Optional[float] = None) -> concurrent.futures.Future:
    """``get_server().submit(...)`` — the one-line client call."""
    return get_server().submit(op, *operands, deadline_s=deadline_s)


def shutdown() -> None:
    """Drain and stop the process-default server."""
    with _default_lock:
        srv, _default[0] = _default[0], None
    if srv is not None:
        srv.close()


def warm_start(server: Optional[BatchQueue] = None,
               specs: Optional[list] = None) -> int:
    """Build the bucket executables a serving process will need before
    its first request.  ``specs`` is a list of ``{"op", "batch", "dims",
    "dtype"[, "nrhs"]}`` dicts (dims ``(n,)`` for square ops, ``(m, n)``
    for geqrf/gels).  Returns the number built; after it, the first
    request of every warmed bucket builds nothing
    (``serve.compile.on_demand`` stays 0).  Specs from the autotune cache
    or a bundle, as the JAX package derives them when ``specs`` is
    omitted, are not ported: ``specs`` is required."""
    if specs is None:
        raise NotImplementedError(
            "warm_start needs explicit specs: specs from the autotune cache "
            "or a bundle are not ported yet (ROADMAP.md, queue 1, \"Perf "
            "tooling\")")
    srv = server or get_server()
    done = 0
    with metrics.timer("serve.warm_start"):
        for sp in specs:
            done += srv.warm(sp["op"], int(sp.get("batch", 1)),
                             *tuple(sp["dims"]),
                             dtype=sp.get("dtype", "float32"),
                             nrhs=int(sp.get("nrhs", 1)))
    return done
