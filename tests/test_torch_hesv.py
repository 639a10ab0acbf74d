"""The port's Hermitian-indefinite solvers (slate_tpu_torch.linalg.hesv:
``hetrf`` unblocked and blocked, ``hetrs``, ``hesv``, ``_gtsv_scan`` and
the ``sy`` aliases) against the JAX package's, on the same numpy inputs.

n = 5 and 40 run the unblocked loop at nb = 16 (n ≤ 2·nb + 2); n = 150
the blocked one (nine panels, the deferred update and the watermark).

Gates: the pivots equal (the inputs have no near-ties); l, d and e
within 1e-10 (fp64/c128) and 2e-5·n·max(1, max|T|) (fp32/c64) absolute
— the factors' entries are O(1) up to T's growth, and the fp32 rounding
of two summation orders grows along the eliminations (one d entry of
the fp32 n = 150 case parts by 8.9e-3); the solution at the JAX test's gate,
max|A·x − b| ≤ 1e-10·max(1, max|A|)·n (tests/test_hesv_band.py:27-36),
scaled by ε/ε₆₄ in fp32 and c64, and x within the same bound of the JAX
package's x times cond(A).
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import slate_tpu as jst
import slate_tpu_torch as tst

jhesv = importlib.import_module("slate_tpu.linalg.hesv")
thesv = importlib.import_module("slate_tpu_torch.linalg.hesv")
DTYPES = [np.float32, np.float64, np.complex64, np.complex128]


def _herm(n, dtype, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    if np.dtype(dtype).kind == "c":
        a = a + 1j * rng.standard_normal((n, n))
    b = rng.standard_normal((n, 3))
    return ((a + a.conj().T) / 2).astype(dtype), b.astype(dtype)


def _lo(dtype):
    return np.dtype(dtype) in (np.dtype(np.float32), np.dtype(np.complex64))


@pytest.mark.parametrize("n", [5, 40, 150])
@pytest.mark.parametrize("dtype", DTYPES)
def test_hesv_matches_jax(dtype, n):
    a, b = _herm(n, dtype, 20 + n)
    opts = {"block_size": 16}
    jf, jx = jst.hesv(jnp.asarray(a), jnp.asarray(b), opts)
    tf, tx = tst.hesv(torch.from_numpy(a), torch.from_numpy(b), opts,
                      device="cpu")
    np.testing.assert_array_equal(tf.ipiv.numpy(), np.asarray(jf.ipiv))
    growth = max(1.0, float(np.abs(np.asarray(jf.d)).max()),
                 float(np.abs(np.asarray(jf.e)).max()))
    tol = 2e-5 * n * growth if _lo(dtype) else 1e-10
    for name in ("l", "d", "e"):
        np.testing.assert_allclose(getattr(tf, name).numpy(),
                                   np.asarray(getattr(jf, name)), atol=tol,
                                   err_msg=name)
    tx = tx.numpy()
    gate = 1e-10 * max(1, np.abs(a).max()) * n \
        * np.finfo(dtype).eps / np.finfo(np.float64).eps
    assert np.abs(a.astype(np.complex128) @ tx - b).max() <= gate
    cond = np.linalg.cond(a.astype(np.complex128))
    assert np.abs(tx - np.asarray(jx)).max() <= gate * cond


def test_blocked_matches_unblocked():
    """The blocked factor is the unblocked loop's (the JAX test's
    tests/test_hesv_band.py:128 pin, here in the port alone)."""
    a, _ = _herm(70, np.float64, 31)
    big = tst.hetrf(torch.from_numpy(a), {"block_size": 8}, device="cpu")
    small = tst.hetrf(torch.from_numpy(a), {"block_size": 64}, device="cpu")
    assert torch.equal(big.ipiv, small.ipiv)
    for x, y in zip(big[:3], small[:3]):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-11)


def test_tridiagonal_factor_reconstructs():
    """P·A·Pᴴ = L·T·Lᴴ with T = tridiag(e, d, conj(e)) and the swaps
    applied in order."""
    a, _ = _herm(60, np.complex128, 32)
    f = tst.hetrf(torch.from_numpy(a), {"block_size": 16}, device="cpu")
    n = 60
    perm = thesv._swap_perm(f.ipiv, n, on_device=True).numpy()
    np.testing.assert_array_equal(
        perm, thesv._swap_perm(f.ipiv, n, on_device=False).numpy())
    lf = f.l.numpy() + np.eye(n)
    t = np.diag(f.d.numpy()).astype(complex) + np.diag(f.e.numpy(), -1) \
        + np.diag(f.e.numpy().conj(), 1)
    np.testing.assert_allclose(lf @ t @ lf.conj().T, a[perm][:, perm],
                               atol=1e-10)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_gtsv_scan_matches_jax_and_lapack(dtype):
    """The capture branch's tridiagonal solve: JAX's ``_gtsv_scan`` and
    LAPACK's banded solve, on a T whose rows need pivoting (small
    diagonal)."""
    from scipy.linalg import solve_banded

    rng = np.random.default_rng(33)
    n = 50
    d = 1e-3 * rng.standard_normal(n)
    e = rng.standard_normal(n - 1)
    b = rng.standard_normal((n, 2))
    if np.dtype(dtype).kind == "c":
        e = e + 1j * rng.standard_normal(n - 1)
        b = b + 1j * rng.standard_normal((n, 2))
    e, b = e.astype(dtype), b.astype(dtype)
    got = thesv._gtsv_scan(torch.from_numpy(d), torch.from_numpy(e),
                           torch.from_numpy(b)).numpy()
    ref = np.asarray(jhesv._gtsv_scan(jnp.asarray(d), jnp.asarray(e),
                                      jnp.asarray(b)))
    ab = np.zeros((3, n), dtype=dtype)
    ab[1], ab[0, 1:], ab[2, :-1] = d, e.conj(), e
    np.testing.assert_allclose(got, ref, atol=1e-10)
    np.testing.assert_allclose(got, solve_banded((1, 1), ab, b), atol=1e-10)


def test_sy_aliases_and_vector_rhs():
    assert tst.sytrf is tst.hetrf and tst.sytrs is tst.hetrs \
        and tst.sysv is tst.hesv
    a, b = _herm(30, np.float64, 34)
    f, x = tst.sysv(torch.from_numpy(a), torch.from_numpy(b[:, 0]),
                    device="cpu")
    assert x.shape == (30,)
    np.testing.assert_allclose(a @ x.numpy(), b[:, 0], atol=1e-10)
    x2 = tst.sytrs(f, b[:, 1], device="cpu")
    np.testing.assert_allclose(a @ x2.numpy(), b[:, 1], atol=1e-10)
