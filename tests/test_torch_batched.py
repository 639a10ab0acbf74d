"""The port's batched drivers (slate_tpu_torch.linalg.batched) against the
JAX package's (slate_tpu.linalg.batched) on the same numpy inputs made
from a seed.  For fp32 the JAX package is forced onto its grid-batched
Pallas kernels (interpret mode, SLATE_TPU_AUTOTUNE_FORCE, as
tests/test_batched.py does) and the port takes its kernels' plain
versions (the batch lies on the CPU); for fp64 the JAX package takes its
vmapped candidate and the port its stock branch (torch.linalg).

Gates: pivots exactly equal to the JAX package's and to scipy's (plain
Gaussian inputs, no ties), factors within 1e-4 of the JAX package's max
(fp32; the two sum in other orders), solutions within 1e-4 relative on
inputs of condition number 100, the tester's scaled residual ≤ 3, and
1e-10 for fp64 (both sides call LAPACK's algorithms)."""

import numpy as np
import pytest
import scipy.linalg as sla
import torch

import jax.numpy as jnp

from slate_tpu.linalg import batched as jb
from slate_tpu.perf import autotune as jauto
import slate_tpu_torch as tst
from slate_tpu_torch import config as tcfg
from slate_tpu_torch.exceptions import SlateError
from slate_tpu_torch.linalg import batched as tb
from slate_tpu_torch.perf import autotune as tauto

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _jax_table(tmp_path, monkeypatch):
    monkeypatch.setenv("SLATE_TPU_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    jauto.reset_table()
    tauto._decisions.clear()
    yield
    jauto.reset_table()


@pytest.fixture
def jax_grid(monkeypatch):
    monkeypatch.setenv("SLATE_TPU_AUTOTUNE_FORCE",
                       "batched_potrf=grid,batched_lu=grid")


def _eps(dtype):
    return float(np.finfo(dtype).eps)


def _spd(b, n, dtype, seed):
    g = np.random.default_rng(seed).standard_normal((b, n, n)).astype(dtype)
    return g @ g.transpose(0, 2, 1) + n * np.eye(n, dtype=dtype)


def _gauss(b, n, dtype, seed):
    return np.random.default_rng(seed).standard_normal((b, n, n)).astype(dtype)


def _cond100(b, n, dtype, seed):
    """Dense problems U·diag(s)·Vᵀ, s from 1 to 1/100: they pivot off the
    diagonal and have κ₂ = 100, so 1e-4 bounds the solutions' rounding."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(b):
        u, _ = np.linalg.qr(rng.standard_normal((n, n)))
        v, _ = np.linalg.qr(rng.standard_normal((n, n)))
        out.append((u * np.geomspace(1.0, 1e-2, n)) @ v.T)
    return np.stack(out).astype(dtype)


def _rhs(b, n, k, dtype, seed):
    shape = (b, n) if k is None else (b, n, k)
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _scipy_perm(a):
    perm = list(range(a.shape[0]))
    for k, p in enumerate(sla.lu_factor(a.astype(np.float64))[1]):
        perm[k], perm[p] = perm[p], perm[k]
    return np.asarray(perm)


def _solve_residual(a, b, x, dtype):
    a, b, x = (np.asarray(v, np.float64) for v in (a, b, x))
    n = a.shape[-1]
    r = np.linalg.norm((a @ x.reshape(*x.shape[:2], -1)).reshape(b.shape) - b,
                       axis=tuple(range(1, b.ndim)))
    den = (np.linalg.norm(a, axis=(-2, -1))
           * np.linalg.norm(x.reshape(x.shape[0], -1), axis=-1)
           * _eps(dtype) * n)
    return float((r / den).max())


def _max_rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return np.abs(x - ref).max() / np.abs(ref).max()


# ---------------------------------------------------------------------------
# The nine drivers against the JAX package's
# ---------------------------------------------------------------------------

def test_potrf_batched_fp32_matches_jax_grid(jax_grid):
    b, n = 4, 64
    spd = _spd(b, n, np.float32, 1)
    ref = np.asarray(jb.potrf_batched(jnp.asarray(spd)))
    got = tb.potrf_batched(spd, device="cpu").numpy()
    assert tauto.decisions()["batched_potrf|8,64,float32,cpu"] == "plain"
    assert _max_rel(got, ref) <= 1e-4 and np.all(np.triu(got, 1) == 0)
    for i in range(b):
        li = got[i].astype(np.float64)
        assert (np.linalg.norm(li @ li.T - spd[i])
                / (np.linalg.norm(spd[i]) * _eps(np.float32) * n)) <= 3


def test_getrf_batched_fp32_matches_jax_grid_and_scipy_pivots(jax_grid):
    b, n = 4, 64
    a = _gauss(b, n, np.float32, 2)
    jlu, jperm = map(np.asarray, jb.getrf_batched(jnp.asarray(a)))
    lu, perm = (t.numpy() for t in tb.getrf_batched(a, device="cpu"))
    assert tauto.decisions()["batched_lu|8,64,float32,cpu"] == "plain"
    assert perm.dtype == np.int64
    np.testing.assert_array_equal(perm, jperm)
    for i in range(b):
        np.testing.assert_array_equal(perm[i], _scipy_perm(a[i]))
    assert _max_rel(lu, jlu) <= 1e-4
    assert np.abs(np.tril(lu, -1)).max() <= 1 + 100 * _eps(np.float32)


@pytest.mark.parametrize("k", [None, 3])
def test_gesv_and_posv_batched_fp32_match_jax_grid(jax_grid, k):
    """Both solvers, with a (B, n) and a (B, n, k) right-hand side."""
    b, n = 3, 64
    a, spd = _cond100(b, n, np.float32, 3), _spd(b, n, np.float32, 4)
    rhs = _rhs(b, n, k, np.float32, 5)
    jx = np.asarray(jb.gesv_batched(jnp.asarray(a), jnp.asarray(rhs))[2])
    lu, perm, x = tb.gesv_batched(a, rhs, device="cpu")
    assert x.shape == rhs.shape
    assert np.linalg.norm(x.numpy() - jx) <= 1e-4 * np.linalg.norm(jx)
    assert _solve_residual(a, rhs, x.numpy(), np.float32) <= 3
    jx = np.asarray(jb.posv_batched(jnp.asarray(spd), jnp.asarray(rhs))[1])
    l, x = tb.posv_batched(spd, rhs, device="cpu")
    assert np.linalg.norm(x.numpy() - jx) <= 1e-4 * np.linalg.norm(jx)
    assert _solve_residual(spd, rhs, x.numpy(), np.float32) <= 3


def test_factor_drivers_fp64_match_jax_vmapped():
    """fp64 takes the stock branch (the kernels are fp32), the JAX
    package its vmapped one."""
    b, n = 3, 48
    spd, a = _spd(b, n, np.float64, 6), _cond100(b, n, np.float64, 7)
    rhs = _rhs(b, n, 2, np.float64, 8)
    l = tb.potrf_batched(spd, device="cpu").numpy()
    assert _max_rel(l, np.asarray(jb.potrf_batched(jnp.asarray(spd)))) <= 1e-10
    lu, perm, x = (t.numpy() for t in tb.gesv_batched(a, rhs, device="cpu"))
    jlu, jperm, jx = map(np.asarray, jb.gesv_batched(jnp.asarray(a),
                                                     jnp.asarray(rhs)))
    np.testing.assert_array_equal(perm, jperm)
    assert _max_rel(lu, jlu) <= 1e-10 and _max_rel(x, jx) <= 1e-10
    x = tb.posv_batched(spd, rhs, device="cpu")[1].numpy()
    jx = np.asarray(jb.posv_batched(jnp.asarray(spd), jnp.asarray(rhs))[1])
    assert _max_rel(x, jx) <= 1e-10
    assert tauto.decisions()["batched_potrf|8,64,float64,cpu"] == "stock"
    assert tauto.decisions()["batched_lu|8,64,float64,cpu"] == "stock"


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_geqrf_gels_heev_batched_match_jax(dtype):
    tol = 1e-4 if dtype == np.float32 else 1e-10
    b, m, n = 3, 40, 24
    a = _gauss(b, m, dtype, 9)[:, :, :n].copy()
    h, tau = (t.numpy() for t in tb.geqrf_batched(a, device="cpu"))
    jh, jtau = map(np.asarray, jb.geqrf_batched(jnp.asarray(a)))
    assert _max_rel(h, jh) <= tol and _max_rel(tau, jtau) <= tol
    rhs = _rhs(b, m, None, dtype, 10)
    x = tb.gels_batched(a, rhs, device="cpu").numpy()
    jx = np.asarray(jb.gels_batched(jnp.asarray(a), jnp.asarray(rhs)))
    assert x.shape == (b, n) and _max_rel(x, jx) <= 10 * tol
    spd = _spd(b, 32, dtype, 11)
    w, z = (t.numpy() for t in tb.heev_batched(spd, device="cpu"))
    jw, jz = map(np.asarray, jb.heev_batched(jnp.asarray(spd)))
    assert _max_rel(w, jw) <= tol
    # eigenvectors agree up to sign
    assert _max_rel(np.abs(np.einsum("bij,bij->bj", z, jz)),
                    np.ones((b, 32))) <= 100 * tol
    assert tauto.decisions()["batched_qr|8,64,32,%s,cpu"
                             % np.dtype(dtype).name] == "stock"
    assert tauto.decisions()["batched_heev|8,32,%s,cpu"
                             % np.dtype(dtype).name] == "stock"


def test_potrs_getrs_batched_match_jax():
    b, n = 2, 32
    spd, a = _spd(b, n, np.float64, 12), _cond100(b, n, np.float64, 13)
    rhs = _rhs(b, n, 4, np.float64, 14)
    jl = jb.potrf_batched(jnp.asarray(spd))
    x = tb.potrs_batched(np.asarray(jl), rhs, device="cpu").numpy()
    assert _max_rel(x, np.asarray(jb.potrs_batched(jl, jnp.asarray(rhs)))) <= 1e-10
    jlu, jperm = jb.getrf_batched(jnp.asarray(a))
    x = tb.getrs_batched(np.asarray(jlu), np.asarray(jperm), rhs,
                         device="cpu").numpy()
    jx = np.asarray(jb.getrs_batched(jlu, jperm, jnp.asarray(rhs)))
    assert _max_rel(x, jx) <= 1e-10


# ---------------------------------------------------------------------------
# State carried across: batched LU factors between the packages
# ---------------------------------------------------------------------------

def test_getrs_batched_on_factors_carried_both_ways(jax_grid):
    b, n = 3, 64
    a = _cond100(b, n, np.float32, 15)
    rhs = _rhs(b, n, 2, np.float32, 16)
    jlu, jperm = jb.getrf_batched(jnp.asarray(a))
    lu, perm = tst.lu_batched_from_numpy(np.asarray(jlu), np.asarray(jperm),
                                         device="cpu")
    assert perm.dtype == torch.int64 and lu.shape == (b, n, n)
    x = tb.getrs_batched(lu, perm, rhs, device="cpu").numpy()
    jx = np.asarray(jb.getrs_batched(jlu, jperm, jnp.asarray(rhs)))
    assert np.linalg.norm(x - jx) <= 1e-5 * np.linalg.norm(jx)
    assert _solve_residual(a, rhs, x, np.float32) <= 3
    # and back: the port's factors through the JAX package's solve
    d = tst.lu_batched_to_numpy(*tb.getrf_batched(a, device="cpu"))
    assert d["perm"].dtype == np.int64
    jx2 = np.asarray(jb.getrs_batched(jnp.asarray(d["lu"]),
                                      jnp.asarray(d["perm"]),
                                      jnp.asarray(rhs)))
    assert _solve_residual(a, rhs, jx2, np.float32) <= 3
    with pytest.raises(ValueError):
        tst.lu_batched_from_numpy(np.zeros((2, 4, 4)), np.zeros((2, 3)),
                                  device="cpu")


# ---------------------------------------------------------------------------
# Site decisions, bucketing, gates, probes
# ---------------------------------------------------------------------------

def test_batched_sites_kernel_plain_stock(monkeypatch):
    f32, cuda = torch.float32, torch.device("cuda")
    assert tauto.choose_batched_potrf(64, 256, f32, cuda, True) == "kernel"
    assert tauto.choose_batched_lu(64, 256, f32, CPU, True) == "plain"
    assert tauto.choose_batched_lu(64, 256, f32, cuda, False) == "stock"
    assert tauto.select("batched_qr", b=4, m=64, n=32, dtype=f32,
                        device=cuda) == "stock"
    assert tauto.select("batched_heev", b=4, n=64, dtype=f32,
                        device=cuda) == "stock"
    monkeypatch.setattr(tcfg, "use_kernels", False)
    assert tauto.choose_batched_potrf(64, 256, f32, cuda, True) == "stock"
    assert "batched_potrf|64,256,float32,cuda" in tauto.decisions()


def test_batched_keys_are_pow2_buckets():
    """One decision serves a (B, n) bucket: B 60/64 at n 224/256 share a
    key (floor 8, as the JAX package's _bucket_dim)."""
    for b, n in ((60, 224), (64, 256)):
        assert tauto.select(
            "batched_potrf", b=b, n=n, dtype=torch.float32, device=CPU,
            eligible=tb._grid_eligible("potrf_batched", b, n, n,
                                       torch.float32)) == "plain"
    keys = [k for k in tauto.decisions() if k.startswith("batched_potrf|")]
    assert keys == ["batched_potrf|64,256,float32,cpu"]
    tb.potrf_batched(_spd(3, 40, np.float32, 17), device="cpu")
    assert tauto.decisions()["batched_potrf|8,64,float32,cpu"] == "stock"


def test_grid_gate_follows_the_kernels(monkeypatch):
    f32 = torch.float32
    assert tb._grid_eligible("getrf_batched", 4, 864, 864, f32)
    assert not tb._grid_eligible("getrf_batched", 4, 896, 896, f32)
    assert tb._grid_eligible("potrf_batched", 4, 896, 896, f32)
    assert not tb._grid_eligible("potrf_batched", 4, 48, 48, f32)
    assert not tb._grid_eligible("potrf_batched", 4, 64, 64, torch.float64)
    assert not tb._grid_eligible("potrf_batched", 4, 64, 32, f32)
    # the gate is the shape alone; with the kernels off the site says stock
    monkeypatch.setattr(tcfg, "use_kernels", False)
    assert tb._grid_eligible("potrf_batched", 4, 64, 64, f32)
    assert tauto.choose_batched_potrf(4, 64, f32, CPU, True) == "stock"
    assert tauto.choose_batched_lu(4, 64, f32, CPU, True) == "stock"


def test_ineligible_n_takes_stock_with_the_same_answer():
    """n = 40 is off the kernels' 32 grid: stock, pivots still scipy's."""
    a = _gauss(2, 40, np.float32, 18)
    lu, perm = tb.getrf_batched(a, device="cpu")
    assert tauto.decisions()["batched_lu|8,64,float32,cpu"] == "stock"
    for i in range(2):
        np.testing.assert_array_equal(perm[i].numpy(), _scipy_perm(a[i]))


def test_residual_probes():
    b, n = 3, 32
    spd, a = _spd(b, n, np.float32, 19), _gauss(b, n, np.float32, 20)
    tspd, ta = torch.from_numpy(spd), torch.from_numpy(a)
    l = tb.potrf_batched(tspd, device="cpu")
    assert tb.batched_factor_resid_potrf(tspd, l) < 3
    out = tb.getrf_batched(ta, device="cpu")
    assert tb.batched_factor_resid_lu(ta, out) < 3
    bad = l.clone()
    bad[1, 5, 3] += 1.0
    assert tb.batched_factor_resid_potrf(tspd, bad) > 100
    bad[0, 0, 0] = float("nan")
    assert tb.batched_factor_resid_potrf(tspd, bad) == float("inf")
    assert tb.batched_factor_resid_lu(ta, (out[0] * float("nan"), out[1])) \
        == float("inf")


def test_batched_drivers_reject_bad_operands():
    with pytest.raises(SlateError):
        tb.potrf_batched(np.eye(4, dtype=np.float32), device="cpu")
    with pytest.raises(SlateError):
        tb.getrf_batched(np.zeros((2, 4, 3), np.float32), device="cpu")
    with pytest.raises(SlateError):
        tb.gels_batched(np.zeros((2, 3, 4), np.float32),
                        np.zeros((2, 3), np.float32), device="cpu")
    with pytest.raises(SlateError):
        tb.potrs_batched(np.eye(4)[None], np.zeros(4), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(SlateError):
            tb.potrf_batched(np.eye(32, dtype=np.float32)[None])
