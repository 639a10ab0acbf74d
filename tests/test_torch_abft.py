"""The port's ABFT layer and step checkpoints
(``slate_tpu_torch.resilience.abft`` / ``.checkpoint``) against the JAX
package's (``tests/test_abft.py``'s cases), on the same numpy inputs made
from seeds.

* The checksum core: ``checksums``, ``syndromes``, ``classify``,
  ``correct_single`` and ``augment_lu`` equal to the JAX package's on the
  same arrays (bitwise, but the correction within 200·ε·96 of the true
  value, as the JAX test gates it).
* The composed loops ``getrf_abft`` / ``potrf_abft``: clean factors within
  1e-12 (fp64) and 1e-4 of the largest entry (fp32) of the JAX package's,
  equal permutations, the residual ≤ 3 (the tester's), ``abft.checks`` one
  a step with a trailing block in both; a seeded bitflip at
  ``driver.update`` detected and corrected with the JAX package's
  counters; the verify tier counts and never acts; a non-SPD input flows
  out as its NaN info signal; the tall-panel rung; a ``device_loss`` at a
  step boundary restarts from the checkpoint bitwise.
* The shipped dispatch: gesv and posv with a bitflip under
  ``SLATE_TPU_TORCH_ABFT=correct``, residual ≤ 3; the envelope around the
  scattered driver at every step depth (composed, fused_trsm, fused,
  full) and around potrf's kernel-owned branches: detected, recomputed,
  no false alarm when clean.
* ``run_checkpointed``: its chunks, a restore on device loss, a
  non-transient error propagating, the restart cap.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from slate_tpu.linalg import lu as jlu_mod
from slate_tpu.perf import metrics as jmetrics
from slate_tpu.resilience import abft as jabft
from slate_tpu.resilience import inject as jinject

import slate_tpu_torch as st
from slate_tpu_torch import config as tcfg
from slate_tpu_torch.linalg import lu as lu_mod
from slate_tpu_torch.perf import metrics
from slate_tpu_torch.resilience import abft, checkpoint, inject

TOL = {np.float32: 1e-4, np.float64: 1e-12}


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


def _counters(m=metrics):
    return {k: v for k, v in m.snapshot()["counters"].items()
            if k.startswith(("abft.", "ckpt."))}


def _plan(site, kind, seed, count=1):
    for mod in (inject, jinject):
        mod.install(mod.FaultPlan(seed=seed).add(site, kind, rate=1.0,
                                                 count=count))


def _lu_mat(n, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) + 2.0 * np.sqrt(n) * np.eye(n)
    return a.astype(dtype)


def _spd_mat(n, dtype=np.float32, seed=1):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, n))
    return (g @ g.T / n + np.eye(n)).astype(dtype)


def _lu_resid(a, lu, perm):
    n = a.shape[0]
    lmat = np.tril(lu, -1) + np.eye(n, dtype=a.dtype)
    eps = np.finfo(a.dtype).eps
    return float(np.abs(a[perm] - lmat @ np.triu(lu)).max()
                 / (np.abs(a).max() * n * eps))


def _chol_resid(a, l):
    n = a.shape[0]
    eps = np.finfo(a.dtype).eps
    return float(np.linalg.norm(np.tril(l) @ np.tril(l).T - a)
                 / (np.linalg.norm(a) * eps * n))


def _close(x, ref, dtype):
    ref = np.asarray(ref)
    return np.abs(np.asarray(x) - ref).max() <= TOL[dtype] * np.abs(ref).max()


def _getrf_both(a, nb, **kw):
    lu, perm = abft.getrf_abft(torch.from_numpy(a), nb, **kw)
    jl, jp = jabft.getrf_abft(jnp.asarray(a), nb, **kw)
    return (lu.numpy(), perm.numpy()), (np.asarray(jl), np.asarray(jp))


# ---------------------------------------------------------------------------
# The checksum core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_clean_block_classifies_clean(dtype):
    s = np.random.default_rng(2).standard_normal((96, 96)).astype(dtype)
    cs_row, cs_col = abft.checksums(s)
    assert all(np.array_equal(x, y) for x, y in
               zip((cs_row, cs_col), jabft.checksums(s)))
    assert abft.classify(s, cs_row, cs_col) == \
        jabft.classify(s, cs_row, cs_col) == ("clean", -1, -1, 0.0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("ij", [(0, 0), (17, 83), (95, 1)])
def test_single_corruption_located_and_corrected_as_jax(dtype, ij):
    s0 = np.random.default_rng(3).standard_normal((96, 96)).astype(dtype)
    cs_row, cs_col = abft.checksums(s0)
    s = s0.copy()
    s[ij] += dtype(7.5)
    for x, y in zip(abft.syndromes(s, cs_row, cs_col),
                    jabft.syndromes(s, cs_row, cs_col)):
        assert np.array_equal(x, y)
    got = abft.classify(s, cs_row, cs_col)
    assert got == jabft.classify(s, cs_row, cs_col)
    kind, i, j, delta = got
    assert kind == "single" and (i, j) == ij
    fixed = abft.correct_single(s, i, j, delta)
    assert np.array_equal(fixed, jabft.correct_single(s, i, j, delta))
    assert abs(float(fixed[ij] - s0[ij])) < 200 * np.finfo(dtype).eps * 96


def test_multi_and_nonfinite_classify_as_jax():
    s = np.random.default_rng(4).standard_normal((64, 64)).astype(np.float32)
    cs_row, cs_col = abft.checksums(s)
    s[3, 9] += 5.0
    s[40, 41] -= 11.0
    assert abft.classify(s, cs_row, cs_col)[0] == "multi" == \
        jabft.classify(s, cs_row, cs_col)[0]
    s[2, 2] = np.inf
    assert abft.classify(s, cs_row, cs_col)[0] == "nonfinite" == \
        jabft.classify(s, cs_row, cs_col)[0]


@pytest.mark.parametrize("shape", [(4, 3), (64, 64)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_augment_lu_equals_jax(shape, dtype):
    a = np.random.default_rng(5).standard_normal(shape).astype(dtype)
    w = abft.augment_lu(a)
    assert np.array_equal(w, jabft.augment_lu(a))
    m, n = shape
    assert not w[m + 1:].any() and not w[:, n + 1:].any()
    t = abft.augment_lu(torch.from_numpy(a))     # the tensor route, CPU
    assert t.shape == w.shape
    assert np.abs(t.numpy() - w).max() <= 1e-5 * np.abs(w).max()


# ---------------------------------------------------------------------------
# The composed loops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("nb", [128, 256])
def test_getrf_abft_clean_matches_jax(dtype, nb):
    n = 256
    a = _lu_mat(n, dtype)
    (lu, perm), (jl, jp) = _getrf_both(a, nb)
    assert np.array_equal(perm, jp) and _close(lu, jl, dtype)
    assert _lu_resid(a, lu, perm) < 3.0
    assert _counters() == _counters(jmetrics)
    assert _counters().get("abft.checks", 0) == n // nb - 1


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_potrf_abft_clean_matches_jax(dtype):
    n, nb = 256, 128
    a = _spd_mat(n, dtype)
    l = abft.potrf_abft(torch.from_numpy(a), nb).numpy()
    jl = np.asarray(jabft.potrf_abft(jnp.asarray(a), nb))
    assert _close(l, jl, dtype) and _chol_resid(a, l) < 3.0
    assert _counters() == _counters(jmetrics) == {"abft.checks": 1}


def test_getrf_single_panel_no_verify():
    a = _lu_mat(512)
    lu, perm = abft.getrf_abft(torch.from_numpy(a), 512)
    assert _lu_resid(a, lu.numpy(), perm.numpy()) < 3.0
    assert "abft.checks" not in _counters()


def test_getrf_bitflip_corrected_with_jax_counters(monkeypatch):
    monkeypatch.setenv(abft.ENV_ABFT, "correct")
    monkeypatch.setenv(jabft.ENV_ABFT, "correct")
    n, nb = 256, 64
    a = _lu_mat(n)
    clean = abft.getrf_abft(torch.from_numpy(a), nb)[0].numpy()
    metrics.reset()
    _plan("driver.update", "bitflip", 7)
    (lu, perm), (jl, jp) = _getrf_both(a, nb)
    assert _counters() == _counters(jmetrics)
    c = _counters()
    assert c["abft.detected"] == c["abft.corrected"] == 1
    assert "abft.recomputed" not in c and "abft.restarted" not in c
    assert _lu_resid(a, lu, perm) < 3.0 and np.array_equal(perm, jp)
    np.testing.assert_allclose(lu, clean, rtol=1e-4, atol=1e-4)


def test_potrf_bitflip_corrected_with_jax_counters(monkeypatch):
    monkeypatch.setenv(abft.ENV_ABFT, "correct")
    monkeypatch.setenv(jabft.ENV_ABFT, "correct")
    n, nb = 256, 64
    a = _spd_mat(n)
    _plan("driver.update", "bitflip", 3)
    l = abft.potrf_abft(torch.from_numpy(a), nb).numpy()
    jabft.potrf_abft(jnp.asarray(a), nb)
    assert _chol_resid(a, l) < 3.0
    assert _counters() == _counters(jmetrics)
    assert _counters()["abft.detected"] == _counters()["abft.corrected"] == 1


def test_verify_tier_counts_but_never_acts(monkeypatch):
    monkeypatch.setenv(abft.ENV_ABFT, "verify")
    _plan("driver.update", "bitflip", 7)
    abft.getrf_abft(torch.from_numpy(_lu_mat(256)), 64)
    c = _counters()
    assert c.get("abft.detected", 0) >= 1
    assert "abft.corrected" not in c and "abft.recomputed" not in c


def test_non_spd_info_signal_is_not_corruption(monkeypatch):
    monkeypatch.setenv(abft.ENV_ABFT, "correct")
    a = _spd_mat(128, seed=16)
    a[0, 0] = -1000.0
    l = abft.potrf_abft(torch.from_numpy(a), 32).numpy()
    assert not np.isfinite(l).all()
    c = _counters()
    assert "abft.detected" not in c and "abft.recomputed" not in c
    assert c.get("abft.nonfinite_input", 0) >= 1


def test_tall_panel_rung(monkeypatch):
    from slate_tpu.enums import MethodLU as JMethodLU
    from slate_tpu_torch.enums import MethodLU

    monkeypatch.setattr(lu_mod, "_MAX_LU_PANEL_ROWS", 128)
    monkeypatch.setattr(jlu_mod, "_MAX_LU_PANEL_ROWS", 128)
    a = _lu_mat(256, seed=14)
    (lu, perm), (jl, jp) = _getrf_both(a, 64)
    assert np.array_equal(perm, jp) and _close(lu, jl, np.float32)
    assert _lu_resid(a, lu, perm) < 3.0
    monkeypatch.setenv(abft.ENV_ABFT, "correct")
    monkeypatch.setattr(tcfg, "scattered_lu", False)
    lu2, perm2 = abft.getrf_guarded(torch.from_numpy(a), 64,
                                    MethodLU.PartialPiv)
    assert _lu_resid(a, lu2.numpy(), perm2.numpy()) < 3.0
    monkeypatch.setenv(jabft.ENV_ABFT, "correct")
    jl2, jp2 = jabft.getrf_guarded(jnp.asarray(a), 64, JMethodLU.PartialPiv)
    assert np.array_equal(perm2.numpy(), np.asarray(jp2))


@pytest.mark.parametrize("which", ["getrf", "potrf"])
def test_device_loss_restarts_bitwise(which, monkeypatch):
    monkeypatch.setenv(checkpoint.ENV_EVERY, "2")
    n, nb = 256, 64
    if which == "getrf":
        a = torch.from_numpy(_lu_mat(n))

        def run():
            return abft.getrf_abft(a, nb)
    else:
        a = torch.from_numpy(_spd_mat(n))

        def run():
            return (abft.potrf_abft(a, nb),)
    base = run()
    metrics.reset()
    inject.install(inject.FaultPlan(seed=1).add(
        "step.boundary", "device_loss", rate=1.0, count=1))
    got = run()
    c = _counters()
    assert c["abft.restarted"] == c["ckpt.restored"] == 1
    assert c.get("ckpt.saved", 0) >= 1
    assert all(torch.equal(x, y) for x, y in zip(got, base))


def test_device_loss_late_rewinds_to_the_last_checkpoint(monkeypatch):
    import random

    monkeypatch.setenv(checkpoint.ENV_EVERY, "1")
    a = torch.from_numpy(_lu_mat(256, seed=2))
    base = abft.getrf_abft(a, 64)
    metrics.reset()
    # a seed whose first firing (rate 0.3) is the third step boundary, so
    # the loss rewinds to a checkpoint past the input
    seed = next(s for s in range(1000) if [
        random.Random("%d|step.boundary|%d" % (s, i)).random() < 0.3
        for i in range(3)] == [False, False, True])
    inject.install(inject.FaultPlan(seed=seed).add(
        "step.boundary", "device_loss", rate=0.3, count=1))
    got = abft.getrf_abft(a, 64)
    assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])
    c = _counters()
    assert c["ckpt.restored"] == 1 and c["ckpt.saved"] == 3


# ---------------------------------------------------------------------------
# The shipped dispatch and the envelope rungs
# ---------------------------------------------------------------------------

def _solve_resid(a, x, b):
    x = np.asarray(x, np.float64)
    eps = np.finfo(np.float32).eps
    return (np.linalg.norm(a @ x - b)
            / (np.linalg.norm(a) * np.linalg.norm(x) * a.shape[0] * eps))


def test_gesv_bitflip_residual_gated(monkeypatch):
    monkeypatch.setenv(abft.ENV_ABFT, "correct")
    monkeypatch.setattr(tcfg, "scattered_lu", False)   # the composed loop
    rng = np.random.default_rng(6)
    a = _lu_mat(256, seed=6)
    b = rng.standard_normal((256, 3)).astype(np.float32)
    inject.install(inject.FaultPlan(seed=7).add("driver.update", "bitflip",
                                                rate=1.0, count=1))
    _, _, x = st.gesv(st.Matrix.from_array(a, nb=64, device="cpu"),
                      torch.from_numpy(b), device="cpu")
    assert _solve_resid(a, x, b) < 3
    assert _counters()["abft.detected"] == 1


def test_posv_bitflip_residual_gated(monkeypatch):
    monkeypatch.setenv(abft.ENV_ABFT, "correct")
    monkeypatch.setenv("SLATE_TPU_TORCH_AUTOTUNE_FORCE", "potrf_panel=stock")
    rng = np.random.default_rng(8)
    a = _spd_mat(256, seed=8)
    b = rng.standard_normal((256, 2)).astype(np.float32)
    inject.install(inject.FaultPlan(seed=3).add("driver.update", "bitflip",
                                                rate=1.0, count=1))
    _, x = st.posv(st.HermitianMatrix(torch.from_numpy(a), uplo=st.Uplo.Lower,
                                      nb=64, device="cpu"),
                   torch.from_numpy(b), device="cpu")
    assert _solve_resid(a, x, b) < 3
    c = _counters()
    assert c["abft.detected"] == 1 and c["abft.checks"] == 3   # per step


@pytest.fixture
def scattered(monkeypatch):
    monkeypatch.setattr(tcfg, "scattered_lu", True)
    monkeypatch.setattr(lu_mod, "_SCATTERED_NB", 128)
    monkeypatch.setenv(abft.ENV_ABFT, "correct")


@pytest.mark.parametrize("depth", ["composed", "fused_trsm", "fused", "full"])
def test_envelope_recomputes_every_lu_depth(depth, scattered, monkeypatch):
    monkeypatch.setenv("SLATE_TPU_TORCH_AUTOTUNE_FORCE", "lu_step=" + depth)
    a = _lu_mat(256, seed=11)
    inject.install(inject.FaultPlan(seed=11).add("driver.update", "bitflip",
                                                 rate=1.0, count=1))
    lu, perm = lu_mod._getrf_partial(torch.from_numpy(a), 128)
    assert lu_mod._choose_lu_driver(torch.from_numpy(a)) == "scattered"
    assert _lu_resid(a, lu.numpy(), perm.numpy()) < 3.0
    c = _counters()
    assert c["abft.detected"] == c["abft.recomputed"] == 1
    assert c["abft.checks"] == 2 and "abft.unrecovered" not in c


def test_clean_envelope_matches_jax(scattered, monkeypatch):
    monkeypatch.setenv("SLATE_TPU_TORCH_AUTOTUNE_FORCE", "lu_step=fused")
    a = _lu_mat(256, seed=11)
    lu, perm = lu_mod._getrf_partial(torch.from_numpy(a), 128)
    assert _lu_resid(a, lu.numpy(), perm.numpy()) < 3.0
    assert _counters() == {"abft.checks": 1}
    # the identity sweeps judge the JAX package's factors of the same input
    # clean, and a flipped factor dirty, as the JAX sweeps do
    jl, jp = jax.jit(lambda x: jlu_mod.getrf_rec(x, 64))(jnp.asarray(a))
    cs_row0, cs_col0 = abft.checksums(a)
    for lu_x, perm_x in ((lu.numpy(), perm.numpy()),
                         (np.asarray(jl), np.asarray(jp))):
        bad = lu_x.copy()
        bad[200, 9] = inject.flip_exponent_bit(bad[200, 9])
        for x, ok in ((lu_x, True), (bad, False)):
            assert abft.verify_lu_factors(cs_row0, cs_col0, x, perm_x)[0] \
                is ok is jabft.verify_lu_factors(cs_row0, cs_col0, x,
                                                 perm_x)[0]


@pytest.mark.parametrize("branch", ["fused", "full", "panels"])
def test_potrf_envelope_bitflip(branch, monkeypatch):
    from slate_tpu_torch.linalg import cholesky as chol_mod

    monkeypatch.setenv(abft.ENV_ABFT, "correct")
    monkeypatch.setenv(jabft.ENV_ABFT, "correct")

    a = torch.from_numpy(_spd_mat(256, seed=12))
    _plan("driver.update", "bitflip", 13)
    l = abft.potrf_guarded(a, 128, branch, lambda: chol_mod._potrf_dispatch(
        branch, a, 128, 128)).numpy()
    assert _chol_resid(a.numpy(), l) < 3.0
    c = _counters()
    assert c["abft.detected"] == c["abft.recomputed"] == 1
    # the JAX envelope flips the same element of its factor
    jabft.potrf_guarded(jnp.asarray(a.numpy()), 128, "fused",
                        lambda: jnp.tril(jax.lax.linalg.cholesky(
                            jnp.asarray(a.numpy()))))
    assert _counters(jmetrics) == c


def test_abft_off_is_the_unguarded_path(monkeypatch):
    monkeypatch.delenv(abft.ENV_ABFT, raising=False)
    a = _lu_mat(128, seed=9)
    assert not abft.eligible(torch.from_numpy(a))
    lu, perm = st.getrf(torch.from_numpy(a), device="cpu")
    assert _counters() == {}
    monkeypatch.setenv(abft.ENV_ABFT, "1")
    assert abft.mode() == "correct" and abft.eligible(torch.from_numpy(a))
    assert not abft.eligible(torch.from_numpy(a[:, :64]))
    assert not abft.eligible(torch.arange(16).reshape(4, 4))


# ---------------------------------------------------------------------------
# run_checkpointed
# ---------------------------------------------------------------------------

def _chunk(log):
    def chunk(carry, k0, k1):
        log.append((k0, k1))
        return (carry or 0) + (k1 - k0)
    return chunk


def test_run_checkpointed_plain():
    log = []
    assert checkpoint.run_checkpointed(10, 4, _chunk(log)) == 10
    assert log == [(0, 4), (4, 8), (8, 10)]
    assert _counters() == {"ckpt.saved": 2}


def test_run_checkpointed_restores_a_copy_on_device_loss():
    inject.install(inject.FaultPlan(seed=2).add(
        "step.boundary", "device_loss", rate=1.0, count=1))
    log = []
    assert checkpoint.run_checkpointed(10, 4, _chunk(log)) == 10
    assert log[:2] == [(0, 4), (0, 4)]
    assert _counters()["ckpt.restored"] == _counters()["abft.restarted"] == 1
    # a restored tensor carry is a copy: updating it in place leaves the
    # rewind image intact
    inject.install(inject.FaultPlan(seed=2).add(
        "step.boundary", "device_loss", rate=1.0, count=2))
    seen = []

    def chunk(carry, k0, k1):
        t = torch.zeros(1) if carry is None else carry[0]
        seen.append(float(t[0]))
        t += 1
        return (t,)

    out = checkpoint.run_checkpointed(3, 1, chunk)
    assert float(out[0][0]) == 3 and seen == [0.0, 0.0, 0.0, 1.0, 2.0]
    snap = checkpoint.snapshot((torch.ones(2), np.ones(2), 3))
    assert isinstance(snap, tuple) and snap[2] == 3


def test_nontransient_failure_propagates():
    def chunk(carry, k0, k1):
        raise TypeError("programming error, never retried")

    with pytest.raises(TypeError):
        checkpoint.run_checkpointed(4, 2, chunk)


def test_restart_storm_capped():
    inject.install(inject.FaultPlan(seed=0).add(
        "step.boundary", "device_loss", rate=1.0))
    with pytest.raises(inject.DeviceLoss):
        checkpoint.run_checkpointed(4, 2, _chunk([]), max_restarts=2)
    assert _counters()["ckpt.restored"] == 2


def test_every_steps_knob(monkeypatch):
    for raw, want in (("", 0), ("4", 4), ("-3", 0), ("x", 0)):
        monkeypatch.setenv(checkpoint.ENV_EVERY, raw)
        assert checkpoint.every_steps() == want
