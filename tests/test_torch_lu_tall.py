"""The port's tall-panel LU loop and CALU (slate_tpu_torch.linalg.lu:
``getrf_panels``, ``_tall_panel_lu``, ``_tall_panel_lu_pp``,
``_panel_lu_tntpiv``, ``getrf_tntpiv`` and ``getrf``'s routing to them)
against the JAX package's, on the same numpy inputs.

The tall loop needs matrices taller than ``_MAX_LU_PANEL_ROWS`` (8192);
the tests lower it to 64 in both packages, so n = 192 at nb = 32 runs
three tall panels (192, 160 and 128 rows: the tournament's chunks and
knockout rounds, the inner-blocked loop's two slabs) before the leaf
panels.

Gates: pivots equal in fp64, complex128 and complex64, where the
Gaussian inputs have no near-ties (ROADMAP.md, "How parity is checked");
in fp32 the reference tester's ‖A[perm] − L·U‖/(‖A‖·ε·n) ≤ 3 instead.
The factor within 1e-10 (fp64, absolute; entries are O(1)), 1e-12
(complex128) and 1e-4 of its largest entry (complex64, where U's entries
reach ~40 at n = 192; both packages' complex64 factors lie 4e-6 from the
complex128 one).  True partial pivoting bounds |L| by
1 + 100ε; the tournament does not.  The complex cases hold the repair of
``_lu_perm``, which took ``argmax`` of a complex permutation matrix.
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


#: the factor's tolerance to the JAX package's: absolute in fp64 and
#: complex128 (O(1) entries), relative to the largest entry in complex64
FACTOR_TOL = {np.float64: 1e-10, np.complex128: 1e-12, np.complex64: 1e-4}


def _assert_factor(got, ref, dtype):
    ref = np.asarray(ref)
    scale = np.abs(ref).max() if dtype == np.complex64 else 1.0
    np.testing.assert_allclose(np.asarray(got), ref,
                               atol=FACTOR_TOL[dtype] * scale)


def _gauss(n, seed, dtype, m=None):
    """An m×n Gaussian (m = n by default), complex parts drawn after the
    real ones."""
    rng = np.random.default_rng(seed)
    shape = (n if m is None else m, n)
    a = rng.standard_normal(shape)
    if np.issubdtype(dtype, np.complexfloating):
        a = a + 1j * rng.standard_normal(shape)
    return a.astype(dtype)


def _factor_residual(a, lu, perm):
    """‖A[perm] − L·U‖_F / (‖A‖_F·ε·n) and max |L|."""
    eps = np.finfo(np.asarray(lu).dtype).eps
    a = np.asarray(a, np.complex128)
    lu = np.asarray(lu, np.complex128)
    m, n = a.shape
    k = min(m, n)
    lo = np.tril(lu, -1)[:, :k] + np.eye(m, k)
    r = np.linalg.norm(a[np.asarray(perm)] - lo @ np.triu(lu)[:k])
    return (r / (np.linalg.norm(a) * eps * max(m, n)),
            float(np.abs(np.tril(lu, -1)).max()))


@pytest.mark.parametrize("mode", ["tournament", "pp"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.complex128,
                                   np.complex64],
                         ids=["float64", "float32", "complex128",
                              "complex64"])
def test_getrf_panels_match_jax(tall, dtype, mode):
    a = _gauss(N, 71, dtype)
    jl, jp = jlu.getrf_panels(jnp.asarray(a), NB, tall_panel=mode)
    tl, tp = tlu.getrf_panels(torch.from_numpy(a), NB, tall_panel=mode)
    res, lmax = _factor_residual(a, tl.numpy(), tp.numpy())
    assert res <= 3, res
    if dtype in FACTOR_TOL:
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        _assert_factor(tl.numpy(), jl, dtype)
    if mode == "pp":
        # LAPACK picks complex pivots by |Re| + |Im|, which bounds |L| by
        # √2 (|l| ≤ |Re l| + |Im l| ≤ √2·|pivot|/|pivot|), not 1
        bound = np.sqrt(2) if np.iscomplexobj(a) else 1.0
        assert lmax <= bound * (1 + 100 * np.finfo(dtype).eps), lmax


#: ROADMAP.md's F2 inputs: (m, n, nb) from numpy seed 7, tall-loop
#: threshold 96 in both packages
F2_SHAPES = [(300, 64, 32), (257, 40, 16), (200, 200, 32)]


@pytest.mark.parametrize("shape", F2_SHAPES,
                         ids=["%dx%d-nb%d" % s for s in F2_SHAPES])
@pytest.mark.parametrize("dtype", [np.complex128, np.complex64],
                         ids=["complex128", "complex64"])
def test_complex_tall_loop_matches_jax(monkeypatch, dtype, shape):
    """Complex tall and square matrices through the tournament tall loop,
    which raised in the port (``_lu_perm``'s ``argmax`` of a complex
    matrix; the pp loop does not call it)."""
    mode = "tournament"
    monkeypatch.setattr(jlu, "_MAX_LU_PANEL_ROWS", 96)
    monkeypatch.setattr(tlu, "_MAX_LU_PANEL_ROWS", 96)
    m, n, nb = shape
    a = _gauss(n, 7, dtype, m=m)
    jl, jp = jlu.getrf_panels(jnp.asarray(a), nb, tall_panel=mode)
    tl, tp = tlu.getrf_panels(torch.from_numpy(a), nb, tall_panel=mode)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    _assert_factor(tl.numpy(), jl, dtype)
    res, _ = _factor_residual(a, tl.numpy(), tp.numpy())
    assert res <= 3, res


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64],
                         ids=["complex128", "complex64"])
def test_complex_gesv_takes_the_tall_loop(tall, dtype):
    """``gesv`` under ``MethodLU.Auto`` past the tall threshold on complex
    input: the tournament tall loop, the JAX package's pivots, factor
    and solution."""
    a = _gauss(N, 7, dtype)
    b = _gauss(2, 8, dtype, m=N)
    jf, jp, jx = jst.gesv(jst.Matrix.from_array(jnp.asarray(a), nb=NB),
                          jnp.asarray(b))
    tf, tp, tx = tst.gesv(tst.Matrix.from_array(a, nb=NB, device="cpu"), b)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    _assert_factor(tf.array.numpy(), jf.array, dtype)
    ref = tlu.getrf_panels(torch.from_numpy(a), 512, tall_panel="tournament")
    assert torch.equal(tp, ref[1])
    eps = np.finfo(dtype).eps
    x = tx.numpy().astype(np.complex128)
    res = np.linalg.norm(a.astype(np.complex128) @ x - b) / (
        np.linalg.norm(a) * np.linalg.norm(x) * eps * N)
    assert res <= 3, res
    # the solutions differ by the factors' rounding times cond(A) (~1e3)
    jx = np.asarray(jx)
    assert np.linalg.norm(x - jx) / np.linalg.norm(jx) <= (
        1e-3 if dtype == np.complex64 else 1e-10)


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


TNTPIV_CASES = [(64, 16, np.float64), (100, 32, np.float64),
                (96, 32, np.complex128), (130, 32, np.complex128),
                (96, 32, np.complex64), (130, 32, np.complex64)]


@pytest.mark.parametrize("n,nb,dtype", TNTPIV_CASES, ids=[
    "%d-%d" % c[:2] if c[2] == np.float64 else "%d-%d-%s" % (
        c[0], c[1], np.dtype(c[2]).name) for c in TNTPIV_CASES])
def test_getrf_tntpiv_matches_jax(n, nb, dtype):
    """tests/test_lu.py:104's inputs (``randn``, seed 6) in fp64, and
    ROADMAP.md's F2 shapes (numpy seed 7) in complex: the same tournament
    pivots and factor, and the solve of tests/test_lu.py."""
    if dtype == np.float64:
        a = np.asarray(generate_matrix("randn", n, dtype=jnp.float64,
                                       seed=6))
    else:
        a = _gauss(n, 7, dtype)
    jf, jp = jst.getrf_tntpiv(jst.Matrix.from_array(jnp.asarray(a), nb=nb))
    tf, tp = tst.getrf_tntpiv(tst.Matrix.from_array(a, nb=nb, device="cpu"))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    _assert_factor(tf.array.numpy(), jf.array, dtype)
    res, _ = _factor_residual(a, tf.array.numpy(), tp.numpy())
    assert res <= 3, res
    b = np.random.default_rng(6).standard_normal((n, 2)).astype(dtype)
    x = tst.getrs(tf, tp, b, device="cpu").numpy()
    eps = np.finfo(dtype).eps
    np.testing.assert_allclose(a @ x, b, atol=1e-7 if dtype == np.float64
                               else 1e4 * eps)


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
