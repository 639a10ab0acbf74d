"""The port's fp32 LU slice (getrf, getrs, gesv, getri, getrf_nopiv,
getrs_nopiv, gesv_nopiv) against the JAX package, on the same numpy
inputs made from a seed.  On the CPU the port's panel kernels run their
plain versions; the JAX package's Pallas panels run in interpret mode
where a test forces them, else its default CPU path (the blocked
recursion over ``lax.linalg.lu``).

Gates: the reference tester's scaled residual ‖A·x − b‖/(‖A‖·‖x‖·ε·n) ≤ 3,
pivots equal to the JAX package's (the inputs have no ties), |L| ≤ 1 up
to roundoff (true partial pivoting), and the factor and solution within
1e-4 relative of the JAX package's.  The solves use inputs of condition
number 100 so that 1e-4 bounds the rounding of either package's
summation order (a Gaussian matrix at n = 1024 has κ ≈ 2e4, and the two
solutions then differ by ~4e-4 while both pass the residual gate)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import slate_tpu as jst
import slate_tpu_torch as tst
from slate_tpu.linalg import lu as jlu
from slate_tpu_torch import config as tcfg
from slate_tpu_torch.linalg import lu as tlu
from slate_tpu_torch.ops import kernels
from slate_tpu_torch.perf import autotune as tauto
from slate_tpu_torch.perf import metrics

EPS32 = float(np.finfo(np.float32).eps)


def _gauss(n, seed):
    return np.random.default_rng(seed).standard_normal((n, n)).astype(
        np.float32)


def _cond100(n, seed):
    """U·diag(s)·Vᵀ with random orthogonal U, V and s from 1 to 1/100:
    dense, pivots off the diagonal, κ₂ = 100."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((n, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return ((u * np.geomspace(1.0, 1e-2, n)) @ v.T).astype(np.float32)


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(x - ref) / np.linalg.norm(ref)


def _residual(a, b, x):
    a, b, x = (np.asarray(v, np.float64) for v in (a, b, x))
    return (np.linalg.norm(a @ x - b)
            / (np.linalg.norm(a) * np.linalg.norm(x) * EPS32 * a.shape[0]))


def _check_factor(a, lu, perm):
    """a[perm] = L·U within the tester's 3 and |L| ≤ 1 + 100ε."""
    lu = np.asarray(lu, np.float64)
    n = a.shape[0]
    assert sorted(np.asarray(perm).tolist()) == list(range(n))
    low = np.tril(lu, -1) + np.eye(n)
    res = np.linalg.norm(low @ np.triu(lu) - a[np.asarray(perm)]) / (
        np.linalg.norm(a) * EPS32 * n)
    assert res <= 3, res
    assert np.abs(np.tril(lu, -1)).max() <= 1 + 100 * EPS32


@pytest.mark.parametrize("n", [512, 1024])
def test_gesv_matches_jax(n):
    """n = 512 is one 512-wide panel of the scattered driver, 1024 two."""
    a = _cond100(n, 40 + n)
    b = np.random.default_rng(41).standard_normal((n, 128)).astype(np.float32)
    jl, jp, jx = jst.gesv(jst.Matrix.from_array(jnp.asarray(a), nb=256),
                          jnp.asarray(b))
    tauto._decisions.clear()
    tl, tp, tx = tst.gesv(tst.Matrix.from_array(a, nb=256, device="cpu"), b)
    assert tauto.decisions()["lu_driver|%d,%d,512,float32,cpu" % (n, n)] \
        == "scattered"
    assert isinstance(tl, tst.Matrix) and tp.dtype == torch.int64
    assert tx.dtype == torch.float32 and tuple(tx.shape) == (n, 128)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert _rel(tx.numpy(), np.asarray(jx)) <= 1e-4
    assert _rel(tl.data.numpy(), np.asarray(jl.data)) <= 1e-4
    assert _residual(a, b, tx.numpy()) <= 3
    _check_factor(a, tl.data.numpy(), tp.numpy())


def test_getrf_scattered_matches_jax():
    """Both packages' scattered drivers, the JAX one over its Pallas
    panel in interpret mode: two 128-wide panels at n = 256."""
    a = _gauss(256, 42)
    jl, jp = jlu.getrf_scattered(jnp.asarray(a), 128)
    tl, tp = tlu.getrf_scattered(torch.from_numpy(a), 128)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert _rel(tl.numpy(), np.asarray(jl)) <= 1e-4
    _check_factor(a, tl.numpy(), tp.numpy())


def test_getrf_rec_kernel_leaf_matches_jax(monkeypatch):
    """The blocked recursion with the panel-kernel leaf on both sides: the
    JAX gate forced open as tests/test_lu_pallas_panel.py forces it; the
    port's own gate is open on the CPU (the leaf's plain version)."""
    monkeypatch.setattr(jlu, "_use_pallas_panel",
                        lambda m, w, dtype: dtype == jnp.float32
                        and w % 32 == 0 and m >= w)
    n, nb = 192, 64
    a = _gauss(n, 43)
    jl, jp = jlu.getrf_rec(jnp.asarray(a), nb)
    tauto._decisions.clear()
    tl, tp = tlu.getrf_rec(torch.from_numpy(a), nb)
    leaves = {k: v for k, v in tauto.decisions().items()
              if k.startswith("lu_panel|")}
    assert leaves and set(leaves.values()) == {"plain"}
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert _rel(tl.numpy(), np.asarray(jl)) <= 1e-4
    _check_factor(a, tl.numpy(), tp.numpy())


def _fused_leaf(a):
    """The ``getrf_panel_fused`` wrapper as a panel leaf: the transposed
    (w, m) panel is its whole carry, factored at k0 = 0; the lanes it
    leaves active follow the pivots in original order."""
    m, w = a.shape
    carry = a.T.contiguous()
    _, piv, act_out, linv = kernels.getrf_panel_fused(
        carry, torch.ones((1, m)), 0, nb=w, bb=min(128, w), ib=32)
    perm = torch.cat([piv, (act_out[0] > 0.5).nonzero()[:, 0]])
    return carry[:, perm].T, perm, linv


@pytest.mark.parametrize("leaf", ["kernel", "fused", "stock"])
def test_panel_leaves_match_jax_stock_panel(leaf):
    """Every panel leaf of the port, and the fused panel wrapper used as
    one, against the JAX package's stock leaf (``lax.linalg.lu``) on a
    tall (200, 64) panel: the same w pivots and the same packed factor to
    1e-5.  Rows past the pivots come in original order from the
    lane-major leaves and in swap order from LAPACK's, so those are
    compared row by row."""
    m, w = 200, 64
    a = np.random.default_rng(56).standard_normal((m, w)).astype(np.float32)
    jl, jp = map(np.asarray, jlu._panel_lu(jnp.asarray(a)))
    fn = {"kernel": tlu._panel_lu_kernel, "fused": _fused_leaf,
          "stock": tlu._panel_lu}[leaf]
    out = fn(torch.from_numpy(a))
    tl, tp = out[0].numpy(), out[1].numpy()
    np.testing.assert_array_equal(tp[:w], jp[:w])
    by_row = np.empty_like(tl)
    by_row[tp] = tl
    ref = np.empty_like(jl)
    ref[jp] = jl
    assert _rel(by_row, ref) <= 1e-5
    if leaf != "stock":
        l11 = np.tril(tl[:w], -1) + np.eye(w)
        assert np.linalg.norm(l11 @ out[2].numpy() - np.eye(w)) < 1e-3
    if leaf == "kernel":
        cpu = torch.device("cpu")
        assert tlu._use_kernel_panel(m, w, torch.float32, cpu)
        assert not tlu._use_kernel_panel(m, 48, torch.float32, cpu)
        assert not tlu._use_kernel_panel(m, w, torch.float64, cpu)


def test_getrf_with_scattered_off_takes_the_recursion(monkeypatch):
    n = 512
    a = _gauss(n, 44)
    jl, jp = jst.getrf(jst.Matrix.from_array(jnp.asarray(a), nb=256))
    monkeypatch.setattr(tcfg, "scattered_lu", False)
    tauto._decisions.clear()
    tl, tp = tst.getrf(tst.Matrix.from_array(a, nb=256, device="cpu"))
    dec = tauto.decisions()
    assert dec["lu_driver|512,512,512,float32,cpu"] == "rec"
    assert "lu_panel|512,256,float32,cpu" in dec
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert _rel(tl.data.numpy(), np.asarray(jl.data)) <= 1e-4
    _check_factor(a, tl.data.numpy(), tp.numpy())


@pytest.mark.parametrize("op", ["trans", "conjtrans"])
def test_getrs_trans_matches_jax(op):
    n = 512
    a = _cond100(n, 45)
    b = np.random.default_rng(46).standard_normal((n, 64)).astype(np.float32)
    jl, jp = jst.getrf(jst.Matrix.from_array(jnp.asarray(a), nb=256))
    jx = jst.getrs(jl, jp, jnp.asarray(b), op=jst.Op(op))
    tl, tp = tst.getrf(tst.Matrix.from_array(a, nb=256, device="cpu"))
    tx = tst.getrs(tl, tp, b, op=tst.Op(op))
    assert _rel(tx.numpy(), np.asarray(jx)) <= 1e-4
    assert _residual(a.T, b, tx.numpy()) <= 3


def test_getri_matches_jax():
    n = 512
    a = _cond100(n, 47)
    jl, jp = jst.getrf(jst.Matrix.from_array(jnp.asarray(a), nb=256))
    jinv = np.asarray(jst.getri(jl, jp).data)
    tl, tp = tst.getrf(tst.Matrix.from_array(a, nb=256, device="cpu"))
    tinv = tst.getri(tl, tp).data.numpy()
    assert _rel(tinv, jinv) <= 1e-4
    ad, invd = a.astype(np.float64), tinv.astype(np.float64)
    kappa1 = np.linalg.norm(ad, 1) * np.linalg.norm(invd, 1)
    assert np.linalg.norm(invd @ ad - np.eye(n)) / (EPS32 * n * kappa1) <= 3


def test_gesv_nopiv_matches_jax():
    n = 256
    a = _gauss(n, 48) + n * np.eye(n, dtype=np.float32)   # dominant
    b = np.random.default_rng(49).standard_normal((n, 16)).astype(np.float32)
    jl, jx = jst.gesv_nopiv(jst.Matrix.from_array(jnp.asarray(a), nb=128),
                            jnp.asarray(b))
    tl, tx = tst.gesv_nopiv(tst.Matrix.from_array(a, nb=128, device="cpu"), b)
    assert _rel(tl.data.numpy(), np.asarray(jl.data)) <= 1e-5
    assert _rel(tx.numpy(), np.asarray(jx)) <= 1e-5
    assert _residual(a, b, tx.numpy()) <= 3
    tl2, tp2 = tst.getrf(tst.Matrix.from_array(a, nb=128, device="cpu"),
                         {"method_lu": tst.MethodLU.NoPiv})
    assert torch.equal(tl2.data, tl.data)
    assert torch.equal(tp2, torch.arange(n))


def test_perm_helpers_match_jax():
    perm = np.random.default_rng(50).permutation(37)
    jipiv = np.asarray(jlu.perm_to_ipiv(perm))
    tipiv = tlu.perm_to_ipiv(torch.from_numpy(perm))
    np.testing.assert_array_equal(tipiv.numpy(), jipiv)
    np.testing.assert_array_equal(tlu.ipiv_to_perm(tipiv, 37).numpy(), perm)
    np.testing.assert_array_equal(
        tlu.inverse_perm(torch.from_numpy(perm)).numpy(),
        np.asarray(jlu.inverse_perm(jnp.asarray(perm))))


def test_lu_interop_round_trip():
    """The JAX package's (Matrix, int32 perm) becomes the port's
    (Matrix, int64 tensor), solves the same system, and goes back."""
    n = 256
    a = _cond100(n, 51)
    b = np.random.default_rng(52).standard_normal((n, 8)).astype(np.float32)
    jl, jp = jst.getrf(jst.Matrix.from_array(jnp.asarray(a), nb=128))
    assert np.asarray(jp).dtype == np.int32
    tl, tp = tst.lu_from_numpy(np.asarray(jl.data), np.asarray(jp), nb=128,
                               device="cpu")
    assert isinstance(tl, tst.Matrix) and tp.dtype == torch.int64
    assert tl.nb == 128
    tx = tst.getrs(tl, tp, b)
    jx = np.asarray(jst.getrs(jl, jp, jnp.asarray(b)))
    assert _rel(tx.numpy(), jx) <= 1e-5
    back = tst.lu_to_numpy(tl, tp)
    assert np.array_equal(back["data"], np.asarray(jl.data))
    np.testing.assert_array_equal(back["perm"], np.asarray(jp))
    assert back["nb"] == 128


def test_fused_steps_and_calu_are_not_ported():
    """The fused step depths are ported now (tests/test_torch_fused.py
    holds them against the JAX package): on one 512-wide panel each picks
    the composed depth's pivots.  An unknown depth is refused.  CALU is
    ported now (tests/test_torch_lu_tall.py holds it against the JAX
    package): ``getrf`` under ``MethodLU.CALU`` is ``getrf_tntpiv``."""
    a = torch.from_numpy(_gauss(512, 53))
    _, perm = tlu.getrf_scattered(a, 512, step="composed")
    for step in ("fused", "fused_trsm", "full"):
        assert torch.equal(tlu.getrf_scattered(a, 512, step=step)[1], perm)
    with pytest.raises(ValueError, match="unknown getrf_scattered step"):
        tlu.getrf_scattered(a, 512, step="panel")
    lu, cperm = tst.getrf(tst.Matrix.from_array(a, nb=256, device="cpu"),
                          {"method_lu": tst.MethodLU.CALU})
    assert torch.equal(cperm, tst.getrf_tntpiv(
        tst.Matrix.from_array(a, nb=256, device="cpu"))[1])
    # the tournament does not bound |L| by 1: the residual gate alone
    f = lu.array.numpy().astype(np.float64)
    res = np.linalg.norm((np.tril(f, -1) + np.eye(512)) @ np.triu(f)
                         - a.numpy()[cperm.numpy()]) / (
        np.linalg.norm(a.numpy()) * EPS32 * 512)
    assert res <= 3, res


def test_cpu_lu_launches_nothing_and_counts_steps():
    n = 1024
    a = tst.Matrix.from_array(_cond100(n, 54), nb=256, device="cpu")
    b = np.ones((n, 128), np.float32)
    kernels.reset_launches()
    metrics.reset()
    metrics.on()
    try:
        tst.gesv(a, b)
        tcfg_off = tcfg.scattered_lu
        tcfg.scattered_lu = False
        try:
            tst.getrf(a)
        finally:
            tcfg.scattered_lu = tcfg_off
        snap = metrics.snapshot()
    finally:
        metrics.off()
        metrics.reset()
    assert all(v == 0 for v in kernels.launches.values())
    c = snap["counters"]
    assert c["driver.gesv.calls"] == 1 and c["driver.getrf.calls"] == 2
    assert c["step.getrf.steps"] == 2                  # two 512 panels
    assert c["step.hbm_roundtrips"] == 3               # one trailing step
    # the recursion splits 1024 into two 512-wide halves, each a 256-wide
    # kernel leaf whose L11⁻¹ solves the u12 beside it
    assert c["lu.u12_linv.sites"] == 2
    assert c.get("lu.u12_linv.fallbacks", 0) == 0
    for stage in ("panel", "trsm", "update"):
        assert snap["timers"]["step.getrf.%s" % stage]["count"] >= 1


def test_gesv_asks_for_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    a = _gauss(64, 55)
    with pytest.raises(tst.SlateError, match="no CUDA device"):
        tst.gesv(a, np.ones((64, 1), np.float32))
    with pytest.raises(tst.SlateError, match="no CUDA device"):
        tst.getrf(tst.Matrix.from_array(a, nb=32, device="cpu"),
                  device="cuda")
