"""The port's serving queue (slate_tpu_torch.serve) and the resilience and
metrics pieces it needs, against the JAX package's (slate_tpu.serve,
slate_tpu.resilience, slate_tpu.perf.metrics) on the same numpy inputs.
The port's queue runs with ``device="cpu"``, where the batched kernels
take their plain versions.

Gates: the same request stream gives the same answers through both
queues (pivots exactly; factors and solutions within 1e-4 relative, on
SPD inputs and inputs of condition number 100, since the two packages
sum in other orders), the bucket keys and paddings agree exactly, and
the hardened path keeps the JAX package's contracts: warm start leaves
nothing to build on demand, deadlines, backpressure, close and flush,
and a transient failure ends in the breaker and the singles path while
every future resolves."""

import threading

import numpy as np
import pytest
import torch

from slate_tpu.perf import autotune as jauto
from slate_tpu.perf import metrics as jmetrics
from slate_tpu.perf import sweep as jsweep
from slate_tpu.resilience import breaker as jbreaker
from slate_tpu.resilience import retry as jretry
from slate_tpu.serve import queue as jq
from slate_tpu_torch import config as tcfg
from slate_tpu_torch import serve
from slate_tpu_torch.exceptions import SlateError
from slate_tpu_torch.linalg import batched as tb
from slate_tpu_torch.perf import autotune as tauto
from slate_tpu_torch.perf import metrics
from slate_tpu_torch.perf.sweep import pow2_bucket
from slate_tpu_torch.resilience import (CircuitBreaker, health,
                                        transient_infra, with_backoff)
from slate_tpu_torch.serve import Backpressure
from slate_tpu_torch.serve import queue as tq

EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    monkeypatch.setenv("SLATE_TPU_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    jauto.reset_table()
    was = metrics.enabled()
    metrics.on()
    metrics.reset()
    yield
    metrics.reset()
    if not was:
        metrics.off()
    jauto.reset_table()


def _queue(**kw):
    kw.setdefault("max_wait_s", 0.005)
    return tq.BatchQueue(tq.ServeConfig(device="cpu", **kw))


def _spd(n, seed=0):
    g = np.random.default_rng(seed).standard_normal((n, n)).astype(np.float32)
    return g @ g.T + n * np.eye(n, dtype=np.float32)


def _cond100(n, seed):
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((n, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return ((u * np.geomspace(1.0, 1e-2, n)) @ v.T).astype(np.float32)


def _resid(a, b, x):
    a, b, x = (np.asarray(v, np.float64) for v in (a, b, x))
    return (np.linalg.norm(a @ x - b)
            / (np.linalg.norm(a) * np.linalg.norm(x) * EPS32 * a.shape[0]))


def _counters():
    return metrics.snapshot()["counters"]


# ---------------------------------------------------------------------------
# The same request stream through both queues
# ---------------------------------------------------------------------------

def test_same_requests_same_answers_as_the_jax_queue():
    rng = np.random.default_rng(1)
    reqs = []
    for i, n in enumerate((24, 40, 24, 40, 40)):
        reqs.append(("posv", (_spd(n, i), rng.standard_normal(n).astype(np.float32))))
        reqs.append(("gesv", (_cond100(n, 10 + i),
                              rng.standard_normal((n, 2)).astype(np.float32))))
    reqs.append(("potrf", (_spd(40, 7),)))
    reqs.append(("getrf", (rng.standard_normal((40, 40)).astype(np.float32),)))
    jsrv = jq.BatchQueue(jq.ServeConfig(max_batch=4, max_wait_s=0.005))
    tsrv = _queue(max_batch=4)
    try:
        jf = [jsrv.submit(op, *ops) for op, ops in reqs]
        tf = [tsrv.submit(op, *ops) for op, ops in reqs]
        for (op, ops), j, t in zip(reqs, jf, tf):
            jr, tr = j.result(timeout=300), t.result(timeout=300)
            if op == "getrf":
                np.testing.assert_array_equal(tr[1], np.asarray(jr[1]))
                assert np.abs(tr[0] - jr[0]).max() <= 1e-4 * np.abs(jr[0]).max()
                continue
            jr = np.asarray(jr)
            assert tr.shape == jr.shape and tr.dtype == np.float32
            assert np.linalg.norm(tr - jr) <= 1e-4 * np.linalg.norm(jr), op
            if op != "potrf":
                assert _resid(ops[0], ops[1], tr) <= 3
    finally:
        jsrv.close()
        tsrv.close()
    c = _counters()
    assert c["serve.requests"] == len(reqs)
    assert c["serve.dispatches"] == sum(
        c.get("serve.dispatches." + op, 0) for op in tq.SUPPORTED_OPS)
    assert tauto.decisions()["batched_potrf|8,64,float32,cpu"] == "plain"


@pytest.mark.parametrize("pol", ["pow2", "exact"])
def test_exec_keys_and_padding_agree_with_jax(pol):
    rng = np.random.default_rng(2)
    for op in ("potrf", "getrf", "heev", "posv", "gesv"):
        for n in (1, 5, 8, 20, 33, 64, 100):
            for nrhs in (1, 3, 8):
                assert tq._exec_key(op, "float32", pol, (n,), nrhs) == \
                    jq._exec_key(op, "float32", pol, (n,), nrhs)
    for op in ("geqrf", "gels"):
        for m, n in ((8, 8), (16, 16), (50, 10), (64, 33), (20, 7)):
            assert tq._exec_key(op, "float64", pol, (m, n), 2) == \
                jq._exec_key(op, "float64", pol, (m, n), 2)
    with pytest.raises(KeyError):
        tq._exec_key("trsm", "float32", pol, (4,))
    for n, big in ((5, 8), (20, 32), (32, 32)):
        a = rng.standard_normal((n, n)).astype(np.float32)
        a = a + a.T
        np.testing.assert_array_equal(tq._pad_square(a, big),
                                      jq._pad_square(a, big))
        np.testing.assert_array_equal(tq._pad_heev(a, big),
                                      jq._pad_heev(a, big))
        for b in (rng.standard_normal(n), rng.standard_normal((n, 2))):
            np.testing.assert_array_equal(tq._pad_rhs(b, big, 4),
                                          jq._pad_rhs(b, big, 4))
    tall = rng.standard_normal((50, 10))
    np.testing.assert_array_equal(tq._pad_tall(tall, 64, 16),
                                  jq._pad_tall(tall, 64, 16))
    for d in (1, 3, 8, 9, 100, 1025):
        for floor in (1, 8):
            assert pow2_bucket(d, floor) == jsweep.pow2_bucket(d, floor)


# ---------------------------------------------------------------------------
# Served ops of the port, metrics and threads
# ---------------------------------------------------------------------------

def test_threaded_mixed_submission_and_queue_metrics():
    srv = _queue(max_batch=8, max_wait_s=0.01)
    rng = np.random.default_rng(3)
    cases = [("posv", (_spd(n, i), rng.standard_normal(n).astype(np.float32)))
             for i, n in enumerate((20, 33, 48, 20, 64, 33))]
    cases += [("gesv", (_cond100(n, 20 + n),
                        rng.standard_normal((n, 2)).astype(np.float32)))
              for n in (24, 40)]
    futs = [None] * len(cases)

    def worker(lo):
        for i in range(lo, len(cases), 4):
            futs[i] = srv.submit(cases[i][0], *cases[i][1])

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for (op, (a, b)), f in zip(cases, futs):
        assert _resid(a, b, f.result(timeout=120)) <= 3, op
    srv.close()
    snap = metrics.snapshot()
    assert snap["counters"]["serve.requests"] == len(cases)
    assert "serve.queue.depth" in snap["gauges"]
    assert {"serve.wait", "serve.dispatch"} <= set(snap["timers"])
    assert snap["hists"]["serve.batch.occupancy"]["total"] == len(cases)


def test_factor_qr_and_eigen_ops_roundtrip():
    srv = _queue(max_batch=2)
    rng = np.random.default_rng(4)
    n = 24
    a = rng.standard_normal((n, n)).astype(np.float32)
    lu, perm = srv.submit("getrf", a).result(timeout=60)
    low = np.tril(lu, -1) + np.eye(n)
    assert (np.linalg.norm(low @ np.triu(lu) - a[perm])
            / (np.linalg.norm(a) * EPS32 * n)) <= 3
    l = srv.submit("potrf", torch.from_numpy(_spd(n, 9))).result(timeout=60)
    assert l.shape == (n, n) and np.all(np.triu(l, 1) == 0)
    tall = rng.standard_normal((50, 10)).astype(np.float32)
    h, taus = srv.submit("geqrf", tall).result(timeout=60)
    assert h.shape == (50, 10) and taus.shape == (10,)
    bb = rng.standard_normal(50).astype(np.float32)
    x = srv.submit("gels", tall, bb).result(timeout=60)
    assert (np.linalg.norm(tall.T @ (tall @ x - bb))
            / (np.linalg.norm(tall) ** 2 * np.linalg.norm(x) * EPS32
               * np.sqrt(50))) < 3
    g = rng.standard_normal((12, 12)).astype(np.float32)
    s = 0.5 * (g + g.T)
    w, z = srv.submit("heev", s).result(timeout=60)
    assert (np.diff(w) >= 0).all()
    assert np.linalg.norm(s @ z - z * w) / (np.linalg.norm(s) * EPS32 * 12) < 3
    with pytest.raises(KeyError):
        srv.submit("sv", a)
    with pytest.raises(TypeError):
        srv.submit("posv", a)
    srv.close()


def test_max_batch_dispatches_without_waiting():
    srv = _queue(max_batch=4, max_wait_s=30.0)
    spd, b = _spd(16), np.ones(16, np.float32)
    futs = [srv.submit("posv", spd, b) for _ in range(4)]
    for f in futs:            # only the occupancy trigger can fire
        f.result(timeout=60)
    srv.close()
    assert _counters()["serve.dispatches"] == 1


def test_queue_runs_on_the_card_by_default():
    assert tq.ServeConfig().device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(SlateError):
            tq.BatchQueue()


# ---------------------------------------------------------------------------
# Warm start
# ---------------------------------------------------------------------------

def test_warm_counts_only_new_builds():
    srv = _queue(max_batch=16)
    assert srv.warm("posv", 16, 40) == 5            # batch 1, 2, 4, 8, 16
    assert srv.warm("posv", 16, 40) == 0
    assert srv.warm("posv", 4, 33) == 0             # the same bucket
    assert srv.warm("gesv", 3, 40, nrhs=2) == 3     # 1, 2, 4
    assert _counters()["serve.warm_start.compiled"] == 8
    srv.close()


def test_warm_start_leaves_nothing_to_build_on_demand():
    srv = _queue(max_batch=4)
    built = serve.warm_start(srv, specs=[
        {"op": "posv", "batch": 4, "dims": (40,)},
        {"op": "gesv", "batch": 4, "dims": (40,), "nrhs": 2},
        {"op": "geqrf", "batch": 2, "dims": (50, 10)}])
    assert built == 3 + 3 + 2
    rng = np.random.default_rng(5)
    futs = [srv.submit("posv", _spd(40, i), rng.standard_normal(40).astype(np.float32))
            for i in range(5)]
    futs += [srv.submit("gesv", _cond100(36, i),
                        rng.standard_normal((36, 2)).astype(np.float32))
             for i in range(3)]
    futs.append(srv.submit("geqrf", rng.standard_normal((50, 10)).astype(np.float32)))
    for f in futs:
        f.result(timeout=60)
    srv.close()
    c = _counters()
    assert c.get("serve.compile.on_demand", 0) == 0
    assert c["serve.dispatches"] >= 3
    with pytest.raises(NotImplementedError):
        serve.warm_start(srv)


# ---------------------------------------------------------------------------
# The hardened path
# ---------------------------------------------------------------------------

def test_deadline_backpressure_close_and_flush():
    srv = _queue(max_wait_s=0.05)
    f = srv.submit("potrf", _spd(16), deadline_s=0.0)
    with pytest.raises(TimeoutError):
        f.result(timeout=30)
    assert _counters()["serve.deadline_expired"] == 1
    srv.flush(timeout=30)
    srv.close()

    srv = _queue(max_wait_s=30.0, max_queue_depth=2)
    srv._ensure_thread = lambda: None               # a dead dispatcher
    f1 = srv.submit("potrf", _spd(16))
    srv.submit("potrf", _spd(16, 1))
    with pytest.raises(Backpressure):
        srv.submit("potrf", _spd(16, 2))
    assert srv.queue_depth() == 2
    with pytest.raises(TimeoutError, match="still pending"):
        srv.flush(timeout=0.05)
    srv.close()
    with pytest.raises(SlateError, match="closed"):
        f1.result(timeout=1)
    c = _counters()
    assert c["serve.backpressure"] == 1 and c["serve.closed_undispatched"] == 2
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit("potrf", _spd(16))



def _patch_posv(monkeypatch, fail):
    """posv_batched raising ``fail()`` (or returning it, when it is not
    an exception) unless the safe backend is on."""
    real = tb.posv_batched

    def patched(a, b, opts=None, *, device=None):
        if tcfg.use_kernels is not False:
            out = fail(a, b)
            if isinstance(out, BaseException):
                raise out
            return out
        return real(a, b, opts, device=device)

    monkeypatch.setattr(tb, "posv_batched", patched)


def test_transient_failures_open_the_breaker_and_singles_resolve(monkeypatch):
    srv = _queue(max_batch=1, max_wait_s=0.001, max_retries=1,
                 retry_backoff_s=0.001, breaker_threshold=2,
                 breaker_cooldown_s=60.0)
    srv.warm("posv", 1, 16)
    knobs = (tcfg.use_kernels, tcfg.scattered_lu)
    _patch_posv(monkeypatch, lambda a, b: ConnectionError("device unavailable"))
    b = np.ones(16, np.float32)
    for i in range(4):
        spd = _spd(16, i)
        assert _resid(spd, b, srv.submit("posv", spd, b).result(timeout=60)) <= 3
    srv.close()
    c = _counters()
    assert c["serve.retries"] == 2                  # one per failed batch
    assert c["serve.errors"] == 2 and c["serve.fallback.singles"] == 2
    assert c["serve.breaker.open"] == 1
    assert c["serve.breaker.short_circuit"] == 2    # batches 3 and 4
    assert c["serve.singles"] == 4
    assert (tcfg.use_kernels, tcfg.scattered_lu) == knobs    # restored


def test_a_failure_that_is_not_transient_fails_the_futures(monkeypatch):
    """A kernel launch error is not absorbed: the batch's futures carry
    it, and nothing is served on the stock backend in its place."""
    srv = _queue(max_batch=2, max_wait_s=0.001)
    srv.warm("posv", 2, 16)
    _patch_posv(monkeypatch, lambda a, b: RuntimeError(
        "potrf_batched kernel launch failed: CUDA error 1"))
    f = srv.submit("posv", _spd(16), np.ones(16, np.float32))
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        f.result(timeout=60)
    srv.close()
    c = _counters()
    assert c["serve.errors"] == 1 and c.get("serve.fallback.singles", 0) == 0
    assert c.get("serve.retries", 0) == 0


def test_nonfinite_batch_under_health_goes_to_singles(monkeypatch):
    monkeypatch.setenv(health.ENV_HEALTH, "warn")
    srv = _queue(max_batch=2, max_wait_s=0.001, max_retries=1,
                 retry_backoff_s=0.001)
    srv.warm("posv", 2, 16)
    _patch_posv(monkeypatch, lambda a, b: (a, torch.full_like(b, float("nan"))))
    spd, b = _spd(16), np.ones(16, np.float32)
    x = srv.submit("posv", spd, b).result(timeout=60)
    srv.close()
    assert np.isfinite(x).all() and _resid(spd, b, x) <= 3
    c = _counters()
    assert c["serve.health.batch_nonfinite"] == 2   # the try and the retry
    assert c["serve.fallback.singles"] == 1


# ---------------------------------------------------------------------------
# Resilience and metrics pieces against the JAX package's
# ---------------------------------------------------------------------------

def test_safe_backend_sends_every_site_to_stock():
    f32, cpu = torch.float32, torch.device("cpu")
    saved = (tcfg.use_kernels, tcfg.scattered_lu)
    with health.safe_backend():
        assert tcfg.use_kernels is False and tcfg.scattered_lu is False
        assert tauto.choose_batched_potrf(8, 64, f32, cpu, True) == "stock"
        assert tauto.choose_batched_lu(8, 64, f32, cpu, True) == "stock"
    assert (tcfg.use_kernels, tcfg.scattered_lu) == saved
    assert health.mode() == "off"


def test_retry_classifier_and_backoff_match_jax():
    class Retryable(Exception):
        retryable = True

    cases = [OSError("x"), TimeoutError(), ConnectionError(),
             RuntimeError("UNAVAILABLE: socket closed"),
             RuntimeError("CUDA error 700"), ValueError("bad shape"),
             KeyError("worker"), TypeError("deadline"), Retryable()]
    for e in cases:
        assert transient_infra(e) == jretry.transient_infra(e), e
    calls, sleeps = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("blip")
        return "ok"

    assert with_backoff(flaky, attempts=3, base_s=0.5,
                        sleep=sleeps.append) == ("ok", 2)
    assert sleeps == [0.5, 1.0] and _counters()["resilience.retries"] == 2
    with pytest.raises(ValueError):
        with_backoff(lambda: (_ for _ in ()).throw(ValueError("no")),
                     attempts=5, classify=transient_infra)


def test_breaker_transitions_match_jax():
    t = [0.0]
    ours = CircuitBreaker(threshold=2, cooldown_s=1.0, clock=lambda: t[0])
    ref = jbreaker.CircuitBreaker(threshold=2, cooldown_s=1.0,
                                  clock=lambda: t[0])
    script = ["allow", "failure", "failure", "allow", "tick", "allow",
              "allow", "failure", "tick", "allow", "success", "allow",
              "failure", "success"]
    for step in script:
        if step == "tick":
            t[0] += 1.5
            continue
        got, want = getattr(ours, step)(), getattr(ref, step)()
        assert got == want and ours.state == ref.state, step
    c = _counters()
    assert c["breaker.open"] == 2 and c["breaker.half_open"] == 2
    assert c["breaker.close"] == 1


def test_histogram_quantiles_and_deltas_match_jax():
    samples = np.random.default_rng(6).lognormal(1.0, 1.5, 500)
    was = jmetrics.enabled()
    jmetrics.on()
    try:
        before, jbefore = metrics.snapshot(), jmetrics.snapshot()
        for v in samples:
            metrics.observe("lat", float(v))
            jmetrics.observe("lat_port_parity", float(v))
        metrics.inc("n", 3.0)
        metrics.set_gauge("g", 2.0)
        with metrics.timer("t"):
            pass
        q = metrics.hist_quantiles("lat", (0.5, 0.9, 0.99))
        jq_ = jmetrics.hist_quantiles("lat_port_parity", (0.5, 0.9, 0.99))
        assert q == jq_ and q[0.5] <= q[0.9] <= q[0.99]
        exact = np.quantile(samples, [0.5, 0.99])
        assert exact[0] / 2 <= q[0.5] <= exact[0] * 2
        d = metrics.snapshot_delta(before, metrics.snapshot())
        jd = jmetrics.snapshot_delta(jbefore, jmetrics.snapshot())
        assert d["hists"]["lat"] == jd["hists"]["lat_port_parity"]
        assert d["counters"]["n"] == 3.0 and d["gauges"] == {"g": 2.0}
        assert d["timers"]["t"]["count"] == 1 and d["delta"] is True
    finally:
        jmetrics.reset()
        if not was:
            jmetrics.off()
