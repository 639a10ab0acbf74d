"""The port's mixed-precision refinement (``linalg/_refine.py``) and the
mixed drivers on it — ``posv_mixed``, ``posv_mixed_gmres``,
``gesv_mixed``, ``gesv_mixed_gmres`` and ``gels_mixed`` — against the
JAX package on the same numpy inputs made from a seed, in fp64 (x64 is
on in this test process; the low leg is fp32 in both packages).

Gates: solutions within 1e-10 relative of the JAX package's (both
converge to the fp64 solution of a system of condition ≤ ~1e3, so they
part by rounding only), iteration counts of the same sign and within 1
of each other (one more or one fewer step where a residual lands on the
stopping threshold; for the FGMRES forms, which sum one sequence per
right-hand side, each column's count alone), and the reference tester's
scaled residual ≤ 3.
The ill-conditioned case (condition 1e10, not positive definite in
fp32) takes the fp64 fallback in both packages; there the two fallback
solves part by up to cond·ε, so only their residuals are gated.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import slate_tpu as jst
from slate_tpu.linalg import _refine as jref
from slate_tpu.ops import blocks as jblocks
import slate_tpu_torch as tst
from slate_tpu_torch import config as tcfg
from slate_tpu_torch.linalg import _refine as tref
from slate_tpu_torch.ops import blocks as tblocks

EPS64 = float(np.finfo(np.float64).eps)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rel(x, ref):
    return np.linalg.norm(np.asarray(x) - np.asarray(ref)) \
        / np.linalg.norm(np.asarray(ref))


def _resid(a, x, b):
    x = np.asarray(x)
    return np.linalg.norm(a @ x - b) / (np.linalg.norm(a) * np.linalg.norm(x)
                                        * EPS64 * a.shape[0])


def _spd(n, seed, cond=None):
    rng = _rng(seed)
    if cond is None:
        g = rng.standard_normal((n, n))
        return (g + g.T) / 2 + n * np.eye(n)       # tester.py's herm(n)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = (q * np.geomspace(1.0, 1.0 / cond, n)) @ q.T
    return (a + a.T) / 2


# ---------------------------------------------------------------------------
# The refinement cores on stub closures
# ---------------------------------------------------------------------------

def _stubs(n, seed, stagnant):
    """A, b, and M ≈ A⁻¹ (the inverse of A + E with |E| ~ 1e-5) or, for
    the stagnant case, M = 0 (no correction ever contracts)."""
    rng = _rng(seed)
    a = rng.standard_normal((n, n)) + n * np.eye(n)
    b = rng.standard_normal((n, 2))
    m = np.zeros((n, n)) if stagnant else np.linalg.inv(
        a + 1e-5 * rng.standard_normal((n, n)))
    full = np.linalg.inv(a)
    return a, b, m, full


@pytest.mark.parametrize("stagnant", [False, True])
@pytest.mark.parametrize("core", ["ir", "fgmres"])
def test_refine_cores_match_jax_on_stubs(core, stagnant):
    n = 64
    a, b, m, full = _stubs(n, 20, stagnant)
    anorm = float(np.abs(a).sum(axis=1).max())
    kw = dict(anorm=anorm, thresh=EPS64 * np.sqrt(n), itermax=10,
              use_fallback=True)
    ja, jm, jfull = map(jnp.asarray, (a, m, full))
    ta, tm, tfull = map(_t, (a, m, full))
    if core == "ir":
        rx, ri = jref.ir_refine(ja, jnp.asarray(b), lambda r: jm @ r,
                                lambda r: jfull @ r, **kw)
        gx, gi = tref.ir_refine(ta, _t(b), lambda r: tm @ r,
                                lambda r: tfull @ r, **kw)
    else:
        rx, ri = jref.fgmres_refine(ja, jnp.asarray(b), lambda r: jm @ r,
                                    lambda r: jfull @ r, restart=5, **kw)
        gx, gi = tref.fgmres_refine(ta, _t(b), lambda r: tm @ r,
                                    lambda r: tfull @ r, restart=5, **kw)
    assert np.sign(gi) == np.sign(ri) and abs(abs(gi) - abs(ri)) <= 1
    assert (gi < 0) == stagnant
    assert _rel(gx.numpy(), rx) <= 1e-10
    assert _resid(a, gx.numpy(), b) <= 3


# ---------------------------------------------------------------------------
# The mixed drivers
# ---------------------------------------------------------------------------

def _drive_both(driver, a, b):
    """One driver in both packages on A and b: ((x, iters) of the JAX
    package, (x, iters) of the port)."""
    nb = 32 if driver == "gels_mixed" else 64
    if driver.startswith("posv"):
        ja = jst.HermitianMatrix(jnp.asarray(a), uplo=jst.Uplo.Lower, nb=nb)
        ta = tst.HermitianMatrix(a, uplo=tst.Uplo.Lower, nb=nb, device="cpu")
    else:
        ja = jst.Matrix.from_array(jnp.asarray(a), nb=nb)
        ta = tst.Matrix.from_array(a, nb=nb, device="cpu")
    ref = getattr(jst, driver)(ja, jnp.asarray(b))
    got = getattr(tst, driver)(ta, _t(b))
    return (np.asarray(ref[0]), int(ref[1])), (got[0].numpy(), int(got[1]))


def _run_both(driver, n, seed, nrhs, cond=None):
    """One driver in both packages on the same inputs: ((x, iters) of the
    JAX package, (x, iters) of the port, A, b)."""
    rng = _rng(seed)
    b = rng.standard_normal((n, nrhs))
    if driver.startswith("posv"):
        a = _spd(n, seed, cond)
    elif driver.startswith("gesv"):
        a = _spd(n, seed, cond) if cond else \
            rng.standard_normal((n, n)) + n * np.eye(n)   # tester.py's input
    else:
        a = rng.standard_normal((n + n // 2, n))        # gels: tall
        b = rng.standard_normal((n + n // 2, nrhs))
    return (*_drive_both(driver, a, b), a, b)


@pytest.mark.parametrize("driver, n, nrhs", [
    ("posv_mixed", 192, 3), ("posv_mixed_gmres", 128, 2),
    ("gesv_mixed", 192, 3), ("gesv_mixed_gmres", 128, 2),
    ("gels_mixed", 128, 2)])
def test_mixed_drivers_match_jax(driver, n, nrhs):
    (rx, ri), (gx, gi), a, b = _run_both(driver, n, 21, nrhs)
    assert gi >= 0 and ri >= 0                  # refined, no fallback
    if driver.endswith("_gmres"):
        # FGMRES runs one sequence per column and returns the sum of their
        # steps, so one step more or fewer in each column can part the sums
        # by nrhs: hold each column's count alone, on the same b
        for j in range(nrhs):
            (_, rj), (_, gj) = _drive_both(driver, a, b[:, j:j + 1])
            assert gj >= 0 and rj >= 0 and abs(gj - rj) <= 1
    else:
        assert abs(gi - ri) <= 1
    assert _rel(gx, rx) <= 1e-10
    if driver == "gels_mixed":
        # bench.py's normal-equations residual ‖Aᵀ(A·x − b)‖/(‖A‖²·‖x‖·ε·m)
        r = a.T @ (a @ gx - b)
        assert np.linalg.norm(r) / (np.linalg.norm(a) ** 2
                                    * np.linalg.norm(gx) * EPS64
                                    * a.shape[0]) <= 3
    else:
        assert _resid(a, gx, b) <= 3


@pytest.mark.parametrize("driver", ["posv_mixed", "gesv_mixed"])
def test_ill_conditioned_takes_the_fallback_in_both(driver):
    """Condition 1e10: not positive definite in fp32 (the low Cholesky
    leaf comes back NaN in both packages, where torch.linalg.cholesky
    would raise), and beyond what an fp32 LU can refine."""
    (rx, ri), (gx, gi), a, b = _run_both(driver, 128, 22, 2, cond=1e10)
    assert gi < 0 and ri < 0 and abs(gi - ri) <= 1
    assert _resid(a, gx, b) <= 3 and _resid(a, rx, b) <= 3


def test_low_cholesky_leg_returns_nan_where_not_positive_definite():
    """The leaf that fails comes back NaN in its lower triangle, as the
    JAX package's ``lax.linalg.cholesky`` leaf does; the default raises."""
    a = np.diag([1.0, 2.0, -1.0, 3.0]).astype(np.float32)
    a[2, 0] = a[0, 2] = 0.5
    ref = np.asarray(jblocks.potrf_rec(jnp.asarray(a), 2))
    got = tblocks.potrf_rec(_t(a), 2, nan_on_fail=True).numpy()
    assert np.isnan(got[2:, 2:]).sum() == 3 and not np.isnan(got[:2]).any()
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(torch.linalg.LinAlgError):
        tblocks.potrf_rec(_t(a), 2)


def test_forcing_the_split_leg_raises(monkeypatch):
    """The split-precision leg needs ops/split_gemm.py, not ported: a
    forced knob raises instead of running a leg the port does not have
    (the JAX package's own forced leg recurses in _getrf_lo)."""
    monkeypatch.setattr(tcfg, "split_gemm", True)
    assert tref.use_split_leg(torch.float64) is False
    a = _spd(64, 23)
    b = np.ones((64, 1))
    for call in (
            lambda: tst.gesv_mixed(_t(a), _t(b), device="cpu"),
            lambda: tst.posv_mixed(_t(a), _t(b), device="cpu"),
            lambda: tst.gels_mixed(_t(a), _t(b), device="cpu")):
        with pytest.raises(NotImplementedError, match="split_gemm"):
            call()
    monkeypatch.setattr(tcfg, "split_gemm", "auto")
    assert tref.use_split_leg(torch.float32) is False
    x, iters = tst.gesv_mixed(_t(a), _t(b), device="cpu")
    assert iters >= 0 and _resid(a, x.numpy(), b) <= 3


def test_gels_mixed_refuses_wide_and_lo_dtype_pairs():
    with pytest.raises(ValueError):
        tst.gels_mixed(torch.zeros((4, 8), dtype=torch.float64),
                       torch.zeros((4, 1), dtype=torch.float64),
                       device="cpu")
    assert tref.lo_dtype(torch.float64) is torch.float32
    assert tref.lo_dtype(torch.complex128) is torch.complex64
    assert tref.lo_dtype(torch.float32) is torch.float32
