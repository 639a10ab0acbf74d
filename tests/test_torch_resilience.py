"""The port's fault injection, health gates, flight recorder and trace
spans (``slate_tpu_torch.resilience.inject`` / ``.health`` / ``.retry``,
``slate_tpu_torch.perf.blackbox``, ``slate_tpu_torch.trace``) against the
JAX package's, on the same inputs made from seeds.

* inject: the plan grammar (and its refusals), the per-event decisions
  and replay log of one seed equal to the JAX package's, the seeded
  ``bitflip`` element and its exponent flip bitwise the JAX package's (a
  numpy array and a tensor alike);
* retry: injected faults and device losses are transient in both, the
  classification of every case the same;
* health: ``warn`` / ``retry`` / ``strict`` through ``driver_gate`` on the
  getrf facade with a ``driver.output=nan`` plan, the ``resilience.*``
  counters equal to the JAX package's and the rerun's factors within
  1e-5 of the largest entry; the getrf and potrf residual probes within
  1e-3 of the larger of the JAX package's value and the gate (100),
  clean and corrupted, on the same side of the gate; ``reverify``
  and ``quarantine_driver`` (0 on heuristic decisions in both);
* serve: a ``device_loss`` at a queue's own ``inject_site`` and a ``nan``
  at ``serve.dispatch``, each absorbed by the retry with the answer's
  residual ≤ 3 (the serving tests' gate), as the JAX queue absorbs them;
* blackbox: the ring, its bound, a trigger's bundle (its sections the JAX
  package's), the dump cap and ``last_bundle``;
* trace: ``Block`` spans as a context manager and a decorator, the SVG
  and Perfetto exports.
"""

import json
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import slate_tpu as jst
from slate_tpu.perf import blackbox as jblackbox
from slate_tpu.perf import metrics as jmetrics
from slate_tpu.resilience import health as jhealth
from slate_tpu.resilience import inject as jinject
from slate_tpu.resilience import retry as jretry

import slate_tpu_torch as st
from slate_tpu_torch import trace
from slate_tpu_torch.exceptions import SlateError
from slate_tpu_torch.perf import blackbox, metrics
from slate_tpu_torch.resilience import health, inject, retry


@pytest.fixture(autouse=True)
def _clean():
    for m in (metrics, jmetrics):
        m.reset()
        m.on()
    inject.clear_plan()
    jinject.clear_plan()
    yield
    inject.clear_plan()
    jinject.clear_plan()
    for m in (metrics, jmetrics):
        m.reset()
        m.off()


def _counters(m, prefix="resilience."):
    return {k: v for k, v in m.snapshot()["counters"].items()
            if k.startswith(prefix)}


def _lu_mat(n, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n)) + 2.0 * np.sqrt(n) * np.eye(n)) \
        .astype(dtype)


# ---------------------------------------------------------------------------
# inject
# ---------------------------------------------------------------------------

def test_plan_grammar_matches_jax():
    raw = "serve.dispatch=error:0.25,driver.output=nan:0.5:3, dist.bcast=inf"
    p, j = inject.parse_plan(raw, seed=9), jinject.parse_plan(raw, seed=9)
    assert {s: (v.kind, v.rate, v.count) for s, v in p.specs.items()} == \
        {s: (v.kind, v.rate, v.count) for s, v in j.specs.items()}
    assert p.specs["dist.bcast"].rate == 1.0 and p.specs["dist.bcast"].count \
        is None
    for bad in ("serve.dispatch", "x=error:notarate", "x=error:0.5:1.5"):
        with pytest.raises(ValueError):
            inject.parse_plan(bad)
        with pytest.raises(ValueError):
            jinject.parse_plan(bad)
    with pytest.raises(ValueError):
        inject.FaultPlan().add("x", "meltdown")
    assert inject.KINDS == jinject.KINDS


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_seeded_decisions_and_replay_log_match_jax(seed):
    def drive(mod):
        plan = mod.FaultPlan(seed=seed).add("serve.dispatch", "error", 0.3) \
            .add("driver.output", "nan", 0.5, count=4)
        got = [(plan.poll("serve.dispatch"), plan.poll("driver.output"),
                plan.poll("unplanned")) for _ in range(60)]
        return got, list(plan.log), plan.fired(), plan.fired("driver.output")

    port, ref = drive(inject), drive(jinject)
    assert port == ref
    assert port[3] == 4 and 0 < port[2]
    assert drive(inject) == port            # the same seed replays


def test_env_plan_and_programmatic_install(monkeypatch):
    monkeypatch.setenv(inject.ENV_PLAN, "step.boundary=device_loss:1:1")
    monkeypatch.setenv(inject.ENV_SEED, "3")
    assert inject.active() and inject.get_plan().seed == 3
    with pytest.raises(inject.DeviceLoss):
        inject.fault_here("step.boundary")
    assert inject.fault_here("step.boundary") is None      # count 1
    installed = inject.install(inject.FaultPlan(seed=1).add("x", "slow"))
    assert inject.get_plan() is installed
    monkeypatch.setenv(inject.ENV_SLOW_S, "0.001")
    assert inject.fault_here("x") is None                   # slept in place
    inject.clear_plan()
    monkeypatch.delenv(inject.ENV_PLAN)
    assert not inject.active() and inject.poll("x") is None
    assert metrics.resilience_wanted() is False
    inject.install(inject.FaultPlan())
    assert metrics.resilience_wanted() is True


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", [0, 7, 42])
def test_bitflip_site_and_value_match_jax(dtype, seed):
    a = (np.random.default_rng(seed).standard_normal((37, 53)) * 3).astype(dtype)
    a0 = a.copy()
    for mod in (inject, jinject):
        mod.install(mod.FaultPlan(seed=seed).add("driver.update", "bitflip"))
        assert mod.poll("driver.update") == "bitflip"
    got, ij = inject.corrupt_bitflip(a, "driver.update")
    ref, ij_ref = jinject.corrupt_bitflip(a, "driver.update")
    assert ij == ij_ref and np.array_equal(got, ref)
    t, ij_t = inject.corrupt_bitflip(torch.from_numpy(a), "driver.update")
    assert ij_t == ij and np.array_equal(t.numpy(), ref)
    assert np.array_equal(a, a0)                          # input untouched
    i, j = ij
    assert got[i, j] != a[i, j]
    assert inject.flip_exponent_bit(got[i, j]) == a[i, j]
    for v in (dtype(1.3), dtype(-271.25), dtype(3e-4)):
        assert inject.flip_exponent_bit(v) == jinject.flip_exponent_bit(v)


def test_corrupt_outputs_poisons_the_first_float_leaf():
    perm = torch.arange(4)
    lu = torch.ones((4, 4))
    out = inject.corrupt_outputs((perm, lu, np.ones(3)), "inf")
    assert out[0] is perm and torch.isinf(out[1][0, 0])
    assert not torch.isinf(lu).any()                        # a copy
    assert np.isfinite(out[2]).all()
    ref = jinject.corrupt_outputs((np.arange(4), np.ones((4, 4)),
                                   np.ones(3)), "inf")
    assert np.isinf(ref[1][0, 0]) and np.isfinite(ref[2]).all()


# ---------------------------------------------------------------------------
# retry
# ---------------------------------------------------------------------------

def test_injected_faults_are_transient_as_in_jax():
    cases = [(inject.DeviceLoss("s"), jinject.DeviceLoss("s")),
             (inject.InjectedFault("s"), jinject.InjectedFault("s")),
             (TypeError("rpc timeout"), TypeError("rpc timeout")),
             (RuntimeError("UNAVAILABLE"), RuntimeError("UNAVAILABLE")),
             (SlateError("singular"), SlateError("singular")),
             (OSError("x"), OSError("x"))]
    got = [retry.transient_infra(p) for p, _ in cases]
    assert got == [jretry.transient_infra(r) for _, r in cases]
    assert got[:2] == [True, True] and got[2] is False
    assert isinstance(inject.DeviceLoss("s"), inject.InjectedFault)
    assert "device loss" in str(inject.DeviceLoss("step.boundary"))


# ---------------------------------------------------------------------------
# health
# ---------------------------------------------------------------------------

def _both_getrf(a, tier, monkeypatch, plan=True):
    monkeypatch.setenv(health.ENV_HEALTH, tier)
    monkeypatch.setenv(jhealth.ENV_HEALTH, tier)
    if plan:
        for mod in (inject, jinject):
            mod.install(mod.FaultPlan(seed=5).add("driver.output", "nan",
                                                  rate=1.0, count=1))
    outs = {}
    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        outs["port"] = st.getrf(torch.from_numpy(a), device="cpu")
        outs["jax"] = jst.getrf(jnp.asarray(a))
    return outs, [str(w.message) for w in ws]


@pytest.mark.parametrize("tier", ["warn", "retry", "strict"])
def test_health_tiers_match_jax_on_a_poisoned_output(tier, monkeypatch):
    a = _lu_mat(64, seed=3)
    outs, msgs = _both_getrf(a, tier, monkeypatch)
    port, ref = _counters(metrics), _counters(jmetrics)
    assert port == ref, (port, ref)
    assert port["resilience.health.fail"] == 1
    lu, perm = (np.asarray(x) for x in outs["port"])
    lu_ref, perm_ref = (np.asarray(x) for x in outs["jax"])
    if tier == "warn":
        assert np.isnan(lu[0, 0]) and np.isnan(lu_ref[0, 0])
        assert sum("SLATE_TPU_TORCH_HEALTH=warn" in m for m in msgs) == 1
    else:
        # rerun on the stock backend: recovered, nothing to demote
        assert port["resilience.recovered"] == 1
        assert np.isfinite(lu).all() and np.array_equal(perm, perm_ref)
        assert np.abs(lu - lu_ref).max() <= 1e-5 * np.abs(lu_ref).max()


def test_strict_raises_when_the_stock_backend_fails_too(monkeypatch):
    a = _lu_mat(32, seed=4)
    a[3, 5] = np.nan                 # the input is at fault: both fail
    monkeypatch.setenv(health.ENV_HEALTH, "strict")
    with pytest.raises(SlateError, match="strict"):
        st.getrf(torch.from_numpy(a), device="cpu")
    monkeypatch.setenv(jhealth.ENV_HEALTH, "strict")
    with pytest.raises(jst.SlateError if hasattr(jst, "SlateError")
                       else Exception):
        jst.getrf(jnp.asarray(a))
    assert _counters(metrics)["resilience.unrecovered"] == 1
    assert _counters(metrics) == _counters(jmetrics)


def test_off_tier_and_knob_parse(monkeypatch):
    for raw, want in (("", "off"), ("1", "off"), ("WARN", "warn"),
                      ("retry", "retry"), ("strict", "strict")):
        monkeypatch.setenv(health.ENV_HEALTH, raw)
        monkeypatch.setenv(jhealth.ENV_HEALTH, raw)
        assert health.mode() == want == jhealth.mode()
    monkeypatch.setenv(health.ENV_HEALTH, "off")
    a = _lu_mat(16)
    out = st.getrf(torch.from_numpy(a), device="cpu")
    assert _counters(metrics) == {}
    assert np.isfinite(np.asarray(out[0])).all()


@pytest.mark.parametrize("which", ["getrf", "potrf"])
def test_residual_probes_match_jax(which):
    n = 96
    if which == "getrf":
        a = _lu_mat(n, seed=6)
        lu, perm = st.getrf(torch.from_numpy(a), device="cpu")
        lu = lu.numpy()
        args, fn, jfn = (a,), health._resid_getrf, jhealth._resid_getrf

        def out(x):
            return torch.from_numpy(x), perm

        def jout(x):
            return jnp.asarray(x), jnp.asarray(perm.numpy())
    else:
        g = np.random.default_rng(7).standard_normal((n, n))
        a = (g @ g.T / n + np.eye(n)).astype(np.float32)
        lu = np.linalg.cholesky(a.astype(np.float64)).astype(np.float32)
        args, fn, jfn = (a,), health._resid_potrf, jhealth._resid_potrf

        def out(x):
            return torch.from_numpy(x)

        def jout(x):
            return jnp.asarray(x)
    bad = lu.copy()
    bad[n - 5, 7] *= 256.0
    for x, clean in ((lu, True), (bad, False)):
        r = fn((torch.from_numpy(args[0]),), {}, out(x))
        r_ref = jfn((jnp.asarray(args[0]),), {}, jout(x))
        # roundoff-level residuals differ by the sums' order: the
        # tolerance is relative to the gate (100) or the residual
        assert abs(r - r_ref) <= 1e-3 * max(r_ref, 100.0), (r, r_ref)
        assert (r < 100.0) is clean


def test_reverify_and_quarantine_match_jax():
    assert health.reverify(64, "float32", "cpu") is True
    assert health.reverify(32, "float64", "cpu") is True
    assert health.reverify(64, "float32", "no-such-device") is False
    assert _counters(metrics) == {"resilience.reverify.ok": 2,
                                  "resilience.reverify.fail": 1}
    for name in ("getrf", "potrf", "gesv_batched", "unknown"):
        assert health.quarantine_driver(name, "test") == 0 == \
            jhealth.quarantine_driver(name, "test")
    assert health._DRIVER_SITES == jhealth._DRIVER_SITES


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("site,kind", [("replica.3", "device_loss"),
                                       ("serve.dispatch", "nan")])
def test_queue_seams_absorb_injected_faults(site, kind, monkeypatch):
    from slate_tpu.serve import queue as jq
    from slate_tpu_torch.serve import queue as tq

    monkeypatch.setenv(health.ENV_HEALTH, "warn")
    monkeypatch.setenv(jhealth.ENV_HEALTH, "warn")
    n = 16
    g = np.random.default_rng(11).standard_normal((n, n)).astype(np.float32)
    spd = g @ g.T + n * np.eye(n, dtype=np.float32)
    b = np.ones(n, np.float32)
    answers = {}
    for name, q, mod in (("port", tq, inject), ("jax", jq, jinject)):
        mod.install(mod.FaultPlan(seed=4).add(site, kind, rate=1.0, count=1))
        kw = {"device": "cpu"} if name == "port" else {}
        srv = q.BatchQueue(q.ServeConfig(max_wait_s=0.002, max_batch=2,
                                         retry_backoff_s=0.001,
                                         inject_site="replica.3", **kw))
        try:
            answers[name] = np.asarray(srv.submit("posv", spd, b)
                                       .result(timeout=120))
        finally:
            srv.close()
    x = answers["port"].astype(np.float64)
    eps = np.finfo(np.float32).eps
    assert np.linalg.norm(spd @ x - b) / (
        np.linalg.norm(spd) * np.linalg.norm(x) * eps * n) <= 3
    c, jc = metrics.snapshot()["counters"], jmetrics.snapshot()["counters"]
    assert c["serve.retries"] == jc["serve.retries"] == 1
    assert c.get("serve.device_loss", 0) == jc.get("serve.device_loss", 0) \
        == (kind == "device_loss")
    assert c["resilience.inject." + site] == 1


# ---------------------------------------------------------------------------
# blackbox
# ---------------------------------------------------------------------------

@pytest.fixture
def recorder(tmp_path, monkeypatch):
    monkeypatch.setenv(blackbox.ENV_DIR, str(tmp_path))
    blackbox.reset()
    blackbox.on(ring=4)
    yield tmp_path
    blackbox.off()
    blackbox.reset()
    blackbox.on(ring=512)
    blackbox.off()


def test_blackbox_ring_dump_and_trigger(recorder, monkeypatch):
    assert blackbox.ring_size() == 4
    for i in range(6):
        blackbox.record("step", i=i)
    assert [e["i"] for e in blackbox.events()] == [2, 3, 4, 5]   # bounded
    plan = inject.install(inject.FaultPlan(seed=2).add("x", "nan"))
    plan.poll("x")                                 # inject.fired is recorded
    assert blackbox.events()[-1]["kind"] == "inject.fired"
    info = blackbox.trigger("device_loss", "chunk lost")
    assert info["path"].startswith(str(recorder)) and info["reason"] == \
        "device_loss"
    assert blackbox.last_bundle() == info
    bundle = json.load(open(info["path"]))
    assert bundle["schema"] == blackbox.SCHEMA
    assert bundle["trigger"]["detail"] == "chunk lost"
    assert bundle["fault_plan"]["log"] == [{"site": "x", "index": 0,
                                            "kind": "nan"}]
    assert bundle["events"][-1]["kind"] == "trigger"
    # the JAX package's bundle has the same sections
    jblackbox.reset()
    jblackbox.on()
    try:
        ref = jblackbox._assemble("x", "")
    finally:
        jblackbox.off()
    assert set(bundle) == set(ref)
    assert metrics.snapshot()["counters"]["blackbox.trigger.device_loss"] == 1
    monkeypatch.setenv(blackbox.ENV_MAX_DUMPS, "1")
    assert blackbox.trigger("again") is None       # capped, still recorded
    assert blackbox.events()[-1]["reason"] == "again"
    assert blackbox.dump("on demand")["reason"] == "on demand"


def test_blackbox_off_records_nothing(monkeypatch):
    blackbox.off()
    blackbox.reset()
    blackbox.record("x")
    assert blackbox.events() == [] and blackbox.trigger("y") is None
    monkeypatch.setenv(blackbox.ENV_TIMELINE, "1")
    monkeypatch.setenv(blackbox.ENV_TIMELINE_WINDOW, "3")
    assert blackbox.timeline_wanted() and blackbox.timeline_window() == 3


def test_health_verdicts_enter_the_ring(recorder, monkeypatch):
    a = _lu_mat(32, seed=8)
    _both_getrf(a, "retry", monkeypatch)
    kinds = [e["kind"] for e in blackbox.events()]
    assert kinds[-3:] == ["health.fail", "health.retry", "health.recovered"]


# ---------------------------------------------------------------------------
# trace
# ---------------------------------------------------------------------------

def test_trace_blocks_and_exports(tmp_path):
    trace.off()
    with trace.Block("ignored"):
        pass
    trace.on()
    trace.clear()
    try:
        with trace.Block("potrf"):
            with trace.Block("a very long span name that is cut here"):
                pass

        @trace.Block("decorated")
        def f(x):
            return x + 1

        assert f(1) == 2
        evs = trace.events()
        assert [e.name for e in evs] == [
            "a very long span name that is cut here"[:30], "potrf",
            "decorated"]
        assert all(e.stop >= e.start and e.lane == trace.current_lane()
                   for e in evs)
        svg = trace.finish(str(tmp_path / "t.svg"))
        assert open(svg).read().startswith("<svg") and trace.events() == []
        with trace.Block("x"):
            pass
        pj = json.load(open(trace.finish_perfetto(str(tmp_path / "t.json"))))
        spans = [e for e in pj["traceEvents"] if e["ph"] == "X"]
        assert [e["name"] for e in spans] == ["x"]
        assert trace.finish() is None and trace.finish_perfetto() is None
    finally:
        trace.off()
        trace.clear()
