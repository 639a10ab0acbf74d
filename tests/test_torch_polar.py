"""The port's QDWH tier (slate_tpu_torch.linalg.polar: ``polar``,
``heev_qdwh``, ``svd_qdwh``; heev and svd under ``eig_driver`` /
``svd_driver = qdwh``; the ``qdwh_step``, ``eig_driver`` and
``svd_driver`` sites) against the JAX package's, on the same numpy
inputs.  Both packages mix each divide step with the same numpy
generator (``default_rng(0x0D_5EED + depth)``), so their eigenvectors
agree up to sign.

Tolerances, each with its reason:

* polar: U and H within 1e-10·κ (fp64) and 2e-5·κ (fp32) of the JAX
  package's — the Halley iteration's forward error grows with the
  condition number (the pinned Cholesky step at κ = 1e6 departs by
  4e-8 in fp64, and breaks down to NaN in both packages in fp32), and
  the two run their products in other orders;
  UᴴU − I within 20·n·ε and ‖A − U·H‖/‖A‖ within 20·n·ε (fp32 50·n·ε) on
  their own, the backward gates of ``chip_smoke.py`` phase 3n;
* heev_qdwh, svd_qdwh: eigenvalues and singular values within 1e-10
  (fp64), vectors up to sign within 1e-9 (the spectrum's gaps at n = 96
  are ≥ 1e-3, so the vectors are well conditioned), the reconstruction
  within 1e-11·σ_max.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import slate_tpu as jst
from slate_tpu.perf import autotune as jauto
import slate_tpu_torch as tst
from slate_tpu_torch import config as tcfg
from slate_tpu_torch.perf import autotune as tauto
from slate_tpu_torch.perf import metrics

jpolar = importlib.import_module("slate_tpu.linalg.polar")
tpolar = importlib.import_module("slate_tpu_torch.linalg.polar")
FORCE = "SLATE_TPU_TORCH_AUTOTUNE_FORCE"
JFORCE = "SLATE_TPU_AUTOTUNE_FORCE"
#: the divide and conquer's options: nb 32 and a crossover of 16, so that
#: n = 96 recurses three levels before the two-stage leaves
OPTS = {"block_size": 32, "qdwh_crossover": 16}


@pytest.fixture(autouse=True)
def _tables(tmp_path, monkeypatch):
    """A private JAX autotune table, no pins, a clean port census."""
    monkeypatch.setenv("SLATE_TPU_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    monkeypatch.delenv(FORCE, raising=False)
    monkeypatch.delenv(JFORCE, raising=False)
    jauto.reset_table()
    tauto._decisions.clear()
    yield


def _conditioned(n, cond, seed, dtype, m=None):
    """Q₁·diag(s)·Q₂ᵀ, s from 1 to 1/cond (m × n, m ≥ n)."""
    rng = np.random.default_rng(seed)
    m = n if m is None else m
    q1, _ = np.linalg.qr(rng.standard_normal((m, n)))
    q2, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return ((q1 * np.geomspace(1.0, 1.0 / cond, n)) @ q2.T).astype(dtype)


def _herm96(seed=5):
    g = np.random.default_rng(seed).standard_normal((96, 96))
    return (g + g.T) / 2


def _up_to_sign(z, ref):
    z, ref = np.asarray(z), np.asarray(ref)
    sgn = np.sign(np.sum(z * ref, axis=0))
    return np.abs(z * sgn - ref).max()


@pytest.mark.parametrize("step", ["qr", "chol"])
@pytest.mark.parametrize("cond", [1.0, 1e3, 1e6])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_polar_matches_jax(monkeypatch, dtype, cond, step):
    """``qdwh_step`` pinned to one variant in both packages (even at κ = 1
    the iteration steps: spectral_interval's σ_min estimate is low by
    design).  The Cholesky variant is not backward stable at κ = 1e6
    (the reason for the qr → chol switch), so there its backward error is
    held within 2× of the JAX package's instead of the gates."""
    monkeypatch.setenv(FORCE, "qdwh_step=" + step)
    monkeypatch.setenv(JFORCE, "qdwh_step=" + step)
    n = 64
    a = _conditioned(n, cond, 11, dtype, m=80)
    ju, jh = jst.polar(jnp.asarray(a), {"block_size": 32})
    metrics.on()
    metrics.reset()
    try:
        tu, th = tst.polar(torch.from_numpy(a), {"block_size": 32},
                           device="cpu")
        steps = metrics.snapshot()["counters"]
    finally:
        metrics.reset()
        metrics.off()
    tu, th = tu.numpy(), th.numpy()
    assert steps.get("qdwh.step." + step, 0) >= 1
    assert not steps.get("qdwh.step." + ("chol" if step == "qr" else "qr"))
    # the Cholesky variant breaks down at κ = 1e6 in fp32: NaN in both
    np.testing.assert_array_equal(np.isnan(tu), np.isnan(np.asarray(ju)))
    if np.isnan(tu).all():
        assert step == "chol" and dtype == np.float32
        return
    eps = np.finfo(dtype).eps
    tol = (1e-10 if dtype == np.float64 else 2e-5) * cond
    assert np.abs(tu - np.asarray(ju)).max() <= tol
    assert np.abs(th - np.asarray(jh)).max() <= tol
    def backward(u, h):
        u, h, a64 = (np.asarray(x, np.float64) for x in (u, h, a))
        return (np.abs(u.T @ u - np.eye(n)).max(),
                np.linalg.norm(a64 - u @ h) / np.linalg.norm(a64))

    orth, back = backward(tu, th)
    if step == "chol" and cond > 1e3:
        jorth, jback = backward(ju, jh)
        assert orth <= 2 * jorth + 10 * eps and back <= 2 * jback + 10 * eps
        return
    assert orth <= 20 * n * eps
    assert back <= (20 if dtype == np.float64 else 50) * n * eps


def test_heev_qdwh_matches_jax():
    a = _herm96()
    jw, jz = jpolar.heev_qdwh(jnp.asarray(a), True, OPTS)
    metrics.on()
    metrics.reset()
    try:
        tw, tz = tst.heev_qdwh(torch.from_numpy(a), True, OPTS, device="cpu")
        timers = metrics.snapshot()["timers"]
    finally:
        metrics.reset()
        metrics.off()
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-10)
    assert _up_to_sign(tz.numpy(), jz) <= 1e-9
    np.testing.assert_allclose(tw.numpy(), np.linalg.eigvalsh(a), atol=1e-10)
    for stage in ("qr", "gemm", "draw"):
        assert timers["stage.heev." + stage]["count"] > 0
    w, z = tst.heev_qdwh(torch.from_numpy(a), False, OPTS, device="cpu")
    assert z is None and torch.equal(w, tw)


@pytest.mark.parametrize("shape", [(48, 48), (32, 48)])
def test_svd_qdwh_matches_jax(shape):
    """Square, and wide (through the adjoint)."""
    a = np.random.default_rng(12).standard_normal(shape)
    js, ju, jv = jpolar.svd_qdwh(jnp.asarray(a), opts=OPTS)
    ts, tu, tv = tst.svd_qdwh(torch.from_numpy(a), opts=OPTS, device="cpu")
    ts, tu, tv = ts.numpy(), tu.numpy(), tv.numpy()
    np.testing.assert_allclose(ts, np.asarray(js), atol=1e-10)
    np.testing.assert_allclose(ts, np.linalg.svd(a, compute_uv=False),
                               atol=1e-10)
    assert _up_to_sign(tu, ju) <= 1e-9
    assert _up_to_sign(tv.T, np.asarray(jv).T) <= 1e-9
    assert np.abs((tu * ts) @ tv - a).max() <= 1e-11 * ts.max()


def test_heev_and_svd_take_the_qdwh_drivers(monkeypatch):
    """heev and svd under an ``eig_driver`` / ``svd_driver`` option, a pin
    and ``SLATE_TPU_TORCH_QDWH=1`` answer what heev_qdwh and svd_qdwh
    answer."""
    a = _herm96()
    w0, z0 = tst.heev_qdwh(torch.from_numpy(a), True, OPTS, device="cpu")
    w, z = tst.heev(torch.from_numpy(a), True, dict(OPTS, eig_driver="qdwh"),
                    device="cpu")
    assert torch.equal(w, w0) and torch.equal(z, z0)
    monkeypatch.setenv(FORCE, "eig_driver=qdwh")
    w, _ = tst.heev(torch.from_numpy(a), True, OPTS, device="cpu")
    assert torch.equal(w, w0)
    monkeypatch.delenv(FORCE)
    g = np.random.default_rng(13).standard_normal((64, 40))
    s0, u0, v0 = tst.svd_qdwh(torch.from_numpy(g), opts=OPTS, device="cpu")
    monkeypatch.setattr(tcfg, "qdwh", True)
    s, u, v = tst.svd(torch.from_numpy(g), opts=OPTS, device="cpu")
    assert torch.equal(s, s0) and torch.equal(u, u0) and torch.equal(v, v0)
    assert any(k.startswith("svd_driver|") and d == "qdwh"
               for k, d in tauto.decisions().items())


@pytest.mark.parametrize("n", [64, 8192])
@pytest.mark.parametrize("c", [0.5, 3.0, 99.0, 100.0, 101.0, 1e4, 1e17])
def test_qdwh_step_site_matches_jax(n, c):
    import jax.numpy as jnp2

    got = tauto.select("qdwh_step", n=n, c=c, dtype=torch.float32,
                       device="cpu")
    assert got == jauto.select("qdwh_step", n=n, c=c, dtype=jnp2.float32)


def test_driver_sites_follow_the_qdwh_knob(monkeypatch):
    f32 = torch.float32
    assert tauto.choose_eig_driver(64, f32, "cuda", True) == "twostage"
    assert tauto.choose_eig_driver(2, f32, "cuda", True) == "twostage"
    monkeypatch.setattr(tcfg, "qdwh", True)
    assert tauto.choose_eig_driver(64, f32, "cuda", True) == "qdwh"
    assert tauto.choose_svd_driver(64, 64, f32, "cuda", True) == "qdwh"
    assert tauto.choose_eig_driver(64, f32, "cuda", False) == "twostage"
    monkeypatch.setattr(tcfg, "qdwh", False)
    monkeypatch.setenv(FORCE, "eig_driver=qdwh")
    assert tauto.choose_eig_driver(64, f32, "cuda", True) == "twostage"
    monkeypatch.setattr(tcfg, "qdwh", "auto")
    assert tauto.choose_eig_driver(64, f32, "cuda", True) == "qdwh"


def test_dc_degenerate_spectrum_goes_to_the_leaf():
    """A scalar matrix: no shift splits it, so the node is counted
    degenerate and solved by the two-stage leaf."""
    a = 2.0 * torch.eye(40, dtype=torch.float64)
    metrics.on()
    metrics.reset()
    try:
        w, z = tst.heev_qdwh(a, True, OPTS, device="cpu")
        deg = metrics.snapshot()["counters"].get("qdwh.dc.degenerate")
    finally:
        metrics.reset()
        metrics.off()
    assert deg == 1
    np.testing.assert_allclose(w.numpy(), 2.0, atol=1e-14)
    np.testing.assert_allclose(z.numpy().T @ z.numpy(), np.eye(40),
                               atol=1e-13)
