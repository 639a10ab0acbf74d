"""The port's tall-panel LU loop and CALU (slate_tpu_torch.linalg.lu:
``getrf_panels``, ``_tall_panel_lu``, ``_tall_panel_lu_pp``,
``_panel_lu_tntpiv``, ``getrf_tntpiv`` and ``getrf``'s routing to them)
against the JAX package's, on the same numpy inputs.

The tall loop needs matrices taller than ``_MAX_LU_PANEL_ROWS`` (8192);
the tests lower it to 64 in both packages, so n = 192 at nb = 32 runs
three tall panels (192, 160 and 128 rows: the tournament's chunks and
knockout rounds, the inner-blocked loop's two slabs) before the leaf
panels.

Gates: pivots equal in fp64, where the Gaussian inputs have no near-ties
(ROADMAP.md, "How parity is checked"); in fp32 the reference tester's
‖A[perm] − L·U‖/(‖A‖·ε·n) ≤ 3 instead.  The factor within 1e-10
(fp64, absolute; entries are O(1)).  True partial pivoting bounds |L| by
1 + 100ε; the tournament does not.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import slate_tpu as jst
from slate_tpu.linalg import lu as jlu
from slate_tpu.testing import generate_matrix
import slate_tpu_torch as tst
from slate_tpu_torch.enums import MethodLU
from slate_tpu_torch.linalg import lu as tlu

N, NB, TALL = 192, 32, 64


@pytest.fixture
def tall(monkeypatch):
    """Both packages' tall-panel threshold at 64 rows."""
    monkeypatch.setattr(jlu, "_MAX_LU_PANEL_ROWS", TALL)
    monkeypatch.setattr(tlu, "_MAX_LU_PANEL_ROWS", TALL)


def _gauss(n, seed, dtype):
    return np.random.default_rng(seed).standard_normal((n, n)).astype(dtype)


def _factor_residual(a, lu, perm):
    """‖A[perm] − L·U‖_F / (‖A‖_F·ε·n) and max |L|."""
    eps = np.finfo(np.asarray(lu).dtype).eps
    a = np.asarray(a, np.float64)
    lu = np.asarray(lu, np.float64)
    n = a.shape[0]
    lo = np.tril(lu, -1) + np.eye(n)
    r = np.linalg.norm(a[np.asarray(perm)] - lo @ np.triu(lu))
    return r / (np.linalg.norm(a) * eps * n), float(np.abs(np.tril(lu, -1)).max())


@pytest.mark.parametrize("mode", ["tournament", "pp"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_getrf_panels_match_jax(tall, dtype, mode):
    a = _gauss(N, 71, dtype)
    jl, jp = jlu.getrf_panels(jnp.asarray(a), NB, tall_panel=mode)
    tl, tp = tlu.getrf_panels(torch.from_numpy(a), NB, tall_panel=mode)
    res, lmax = _factor_residual(a, tl.numpy(), tp.numpy())
    assert res <= 3, res
    if dtype == np.float64:
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-10)
    if mode == "pp":
        assert lmax <= 1 + 100 * np.finfo(dtype).eps


def test_tall_panel_pp_is_partial_pivoting(tall):
    """One (192, 32) panel: ``_tall_panel_lu_pp``'s pivots are LAPACK's
    partial pivots (``torch.linalg.lu_factor``), its factor the same."""
    pan = torch.from_numpy(_gauss(N, 72, np.float64)[:, :NB])
    lu, pl = tlu._tall_panel_lu_pp(pan, ib=8)
    ref, rp = tlu._lu_perm(pan)
    np.testing.assert_array_equal(pl.numpy(), rp.numpy())
    np.testing.assert_allclose(lu.numpy(), ref.numpy(), atol=1e-12)


def test_lu_perm_matches_the_swap_sequence():
    """The device conversion of LAPACK pivots (``_lu_perm``, batched) is
    the host loop ``ipiv_to_perm`` of each problem."""
    a = torch.from_numpy(np.random.default_rng(73).standard_normal((3, 40, 12)))
    _, perms = tlu._lu_perm(a)
    for i in range(3):
        _, ipiv = torch.linalg.lu_factor(a[i])
        np.testing.assert_array_equal(perms[i].numpy(),
                                      tlu.ipiv_to_perm(ipiv, 40).numpy())


@pytest.mark.parametrize("method", [MethodLU.Auto, MethodLU.PartialPiv])
def test_getrf_routes_tall_matrices(tall, method):
    """m > _MAX_LU_PANEL_ROWS: ``getrf`` takes the tall loop, the
    tournament under Auto and true partial pivoting under an explicit
    PartialPiv, as the JAX package's ``_getrf_incore`` does."""
    a = _gauss(N, 74, np.float64)
    jlu_, jperm = jst.getrf(jst.Matrix.from_array(jnp.asarray(a), nb=NB),
                            {"method_lu": getattr(jst.MethodLU, method.name)})
    lu, perm = tst.getrf(tst.Matrix.from_array(a, nb=NB, device="cpu"),
                         {"method_lu": method})
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_allclose(lu.array.numpy(), np.asarray(jlu_.array),
                               atol=1e-10)
    ref = tlu.getrf_panels(torch.from_numpy(a), 512, tall_panel=(
        "pp" if method is MethodLU.PartialPiv else "tournament"))
    assert torch.equal(perm, ref[1])


@pytest.mark.parametrize("n,nb", [(64, 16), (100, 32)])
def test_getrf_tntpiv_matches_jax(n, nb):
    """tests/test_lu.py:104's inputs (``randn``, seed 6): the same
    tournament pivots and factor, and the solve of tests/test_lu.py."""
    a = np.asarray(generate_matrix("randn", n, dtype=jnp.float64, seed=6))
    jf, jp = jst.getrf_tntpiv(jst.Matrix.from_array(jnp.asarray(a), nb=nb))
    tf, tp = tst.getrf_tntpiv(tst.Matrix.from_array(a, nb=nb, device="cpu"))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(tf.array.numpy(), np.asarray(jf.array),
                               atol=1e-10)
    res, _ = _factor_residual(a, tf.array.numpy(), tp.numpy())
    assert res <= 3, res
    b = np.random.default_rng(6).standard_normal((n, 2))
    x = tst.getrs(tf, tp, b, device="cpu").numpy()
    np.testing.assert_allclose(a @ x, b, atol=1e-7)


def test_getrf_calu_routes_to_tntpiv():
    a = np.asarray(generate_matrix("randn", 100, dtype=jnp.float64, seed=6))
    lu, perm = tst.getrf(tst.Matrix.from_array(a, nb=32, device="cpu"),
                         {"method_lu": MethodLU.CALU})
    ref, rperm = tst.getrf_tntpiv(tst.Matrix.from_array(a, nb=32,
                                                        device="cpu"))
    assert torch.equal(perm, rperm)
    assert torch.equal(lu.array, ref.array)
    _, jperm = jst.getrf(jst.Matrix.from_array(jnp.asarray(a), nb=32),
                         {"method_lu": jst.MethodLU.CALU})
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
