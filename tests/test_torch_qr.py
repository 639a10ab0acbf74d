"""The port's QR family (slate_tpu_torch.linalg.qr) and its lu_inv_panel
kernel against the JAX package's (slate_tpu.linalg.qr,
slate_tpu.ops.pallas_kernels.lu_inv_panel) on the same numpy inputs made
from a seed.  On the CPU the port's kernels take their plain versions;
the JAX package runs its Pallas kernels in interpret mode, its geqrf_panel
site pinned to cholqr2 by forcing its Pallas switch on
(``slate_tpu.config.use_pallas``) with a private autotune table.

Tolerances, each with its reason:

* 1e-6 relative (Frobenius) for lu_inv_panel's outputs and the CholQR²
  panel's: both run the same blocked fp32 algorithm, and only the
  summation order of their products differs;
* 1e-5 relative for fp32 geqrf factors (packed and τ): the panel loop
  carries that rounding through the trailing updates of later panels;
* for the conditioning guard's rerun on a κ₂ = 1e6 input, 1e-5 relative
  for R and for the reflectors of the leading quarter of the columns
  (σⱼ ≥ 1e-1.5): the reflector of a column at σⱼ carries ε/σⱼ of
  rounding, so the trailing ones differ by up to 2e-2 between the two
  Householder reruns and are held by orthogonality and reconstruction;
* 1e-10 for fp64 (LAPACK's geqrf leaf against the JAX column loop, and
  the drivers built on it), absolute on O(1) data as tests/test_qr.py;
* the reference tester's orthogonality < 50 (tests/test_qr.py's gate).
"""


import numpy as np
import pytest
import torch

import jax.numpy as jnp

import slate_tpu as jst
from slate_tpu import config as jcfg
from slate_tpu.linalg import qr as jqr
from slate_tpu.ops import pallas_kernels as pk
from slate_tpu.perf import autotune as jauto
import slate_tpu_torch as tst
from slate_tpu_torch import config as tcfg
from slate_tpu_torch.enums import MethodGels, Op, Side
from slate_tpu_torch.linalg import qr as tqr
from slate_tpu_torch.method import select_gels
from slate_tpu_torch.ops import kernels
from slate_tpu_torch.perf import autotune as tauto
from slate_tpu_torch.perf import metrics

CPU = torch.device("cpu")
FORCE = "SLATE_TPU_TORCH_AUTOTUNE_FORCE"


@pytest.fixture(autouse=True)
def _tables(tmp_path, monkeypatch):
    """A private JAX autotune table with the Pallas kernels forced on (the
    geqrf_panel site answers cholqr2), and a clean port census."""
    monkeypatch.setenv("SLATE_TPU_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    monkeypatch.setattr(jcfg, "use_pallas", True)
    monkeypatch.delenv(FORCE, raising=False)
    jauto.reset_table()
    tauto._decisions.clear()
    yield
    jauto.reset_table()


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(x - ref) / np.linalg.norm(ref)


def _t(a):
    return torch.from_numpy(np.array(a))


def _gauss(m, n, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((m, n)).astype(dtype)


def _cond(m, n, cond, seed):
    """U·diag(σ)·Vᵀ with σ from 1 to 1/cond (fp64, from numpy)."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((m, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (u * np.geomspace(1.0, 1.0 / cond, n)) @ v.T


def _orth(q):
    q = np.asarray(q, np.float64)
    m = q.shape[0]
    return np.linalg.norm(q.T @ q - np.eye(q.shape[1])) / (
        m * np.finfo(np.float32).eps)


# ---------------------------------------------------------------------------
# The kernel: lu_inv_panel's plain version against the interpreted Pallas one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nb", [32, 64, 128])
@pytest.mark.parametrize("kind", ["dominant", "cholqr2_b"])
def test_lu_inv_panel_plain_matches_pallas(nb, kind):
    if kind == "dominant":
        a = _gauss(nb, nb, 40 + nb) + nb * np.eye(nb, dtype=np.float32)
    else:
        # the block the CholQR² reconstruction hands lu_inv_panel
        q = tqr._cholqr2(_t(_gauss(4 * nb, nb, 50 + nb)))[0]
        a = tqr._householder_b(q)[1][:nb].numpy()
    ref = [np.asarray(x) for x in pk.lu_inv_panel(jnp.asarray(a))]
    kernels.reset_launches()
    got = [x.numpy() for x in kernels.lu_inv_panel(_t(a))]
    assert kernels.launches["lu_inv_panel"] == 0        # plain on the CPU
    for g, r in zip(got, ref):
        assert _rel(g, r) <= 1e-6
    lu, linv, uinv = got
    low = np.tril(lu, -1) + np.eye(nb, dtype=np.float32)
    up = np.triu(lu)
    eps = np.finfo(np.float32).eps
    assert np.linalg.norm(low @ up - a) / (np.linalg.norm(a) * eps * nb) <= 3
    assert np.linalg.norm(low @ linv - np.eye(nb)) < 1e-3
    assert np.linalg.norm(up @ uinv - np.eye(nb)) < 1e-3
    assert np.all(np.triu(linv, 1) == 0) and np.all(np.tril(uinv, -1) == 0)


@pytest.mark.parametrize("bad", [
    torch.zeros(48, 48), torch.zeros(64, 32), torch.zeros(16, 16),
    torch.zeros(64, 64, dtype=torch.float64)])
def test_lu_inv_panel_rejects_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        kernels.lu_inv_panel(bad)


# ---------------------------------------------------------------------------
# The CholQR² panel loop against the JAX package's
# ---------------------------------------------------------------------------

def test_cholqr2_panel_matches_jax():
    pan = _gauss(256, 64, 60)
    ref = [np.asarray(x) for x in jqr._cholqr2_panel(jnp.asarray(pan))]
    got = [x.numpy() for x in tqr._cholqr2_panel(_t(pan))]
    for name, g, r in zip(("y", "rprime", "tau", "tmat"), got, ref):
        assert _rel(g, r) <= 1e-6, name
    # the departure (the shift's O(100·w·ε) on a Gaussian panel) absolutely,
    # well below the guard's 0.25
    assert abs(float(got[4]) - float(ref[4])) <= 1e-6 and float(got[4]) < 0.01


@pytest.mark.parametrize("m,n,nb", [(256, 64, 32), (512, 128, 64)])
def test_geqrf_panels_matches_jax(m, n, nb):
    a = _gauss(m, n, 61 + nb)
    fj, tj = (np.asarray(x) for x in jqr.geqrf_panels(jnp.asarray(a), nb))
    kernels.reset_launches()
    ft, tt = tqr.geqrf_panels(_t(a), nb)
    assert _rel(ft.numpy(), fj) <= 1e-5 and _rel(tt.numpy(), tj) <= 1e-5
    assert all(v == 0 for v in kernels.launches.values())


def test_guard_reruns_as_the_jax_package_does():
    """The counterpart of tests/test_qr.py:150-167 on numpy input: both
    packages see the departure pass 0.25 on a κ₂ = 1e6 panel, rerun with
    Householder panels, and agree; Q stays orthogonal."""
    m, n = 128, 32
    a64 = _cond(m, n, 1e6, 62)
    a = a64.astype(np.float32)
    jdev = float(jqr._geqrf_panels_core(jnp.asarray(a), n, True)[2])
    fj, tj = (np.asarray(x) for x in jqr.geqrf_panels(jnp.asarray(a), n))
    hj = np.asarray(jqr._geqrf_panels_core(jnp.asarray(a), n, False)[0])
    assert np.array_equal(fj, hj)           # the JAX package took its rerun
    metrics.on()
    metrics.reset()
    try:
        ft, tt = tqr.geqrf_panels(_t(a), n)
        snap = metrics.snapshot()
    finally:
        metrics.reset()
        metrics.off()
    assert jdev >= 0.25 and snap["gauges"]["qr.cholqr2.devmax"] >= 0.25
    assert snap["counters"]["qr.cholqr2.reruns"] == 1
    hh = tqr._geqrf_panels_core(_t(a), n, False)
    assert torch.equal(ft, hh[0]) and torch.equal(tt, hh[1])
    lead = n // 4
    assert _rel(np.triu(ft.numpy()), np.triu(fj)) <= 1e-5
    assert _rel(ft.numpy()[:, :lead], fj[:, :lead]) <= 1e-5
    assert _rel(tt.numpy()[:lead], tj[:lead]) <= 1e-5
    q = tqr.ungqr(ft, tt, m, device=CPU).numpy()
    assert _orth(q) < 50
    r = np.triu(ft.numpy().astype(np.float64))[:n]
    eps = np.finfo(np.float32).eps
    assert np.linalg.norm(a64 - q[:, :n] @ r) / (np.linalg.norm(a64) * m * eps) < 50


@pytest.mark.parametrize("site", ["cholqr2", "stock"])
def test_geqrf_public_entry_at_each_site(site, monkeypatch):
    """st.geqrf on both packages, each site set by its package's kernel
    switch (the port's answers stock with its kernels off).  (1024, 512)
    is the least shape whose 512-wide panel takes CholQR² (rows ≥ 2·512)."""
    a = _gauss(1024, 512, 63)
    monkeypatch.setattr(tcfg, "use_kernels", site == "cholqr2")
    monkeypatch.setattr(jcfg, "use_pallas", site == "cholqr2")
    fj, tj = jst.geqrf(jst.Matrix.from_array(jnp.asarray(a), nb=256))
    ft, tt = tst.geqrf(tst.Matrix.from_array(a, nb=256, device="cpu"))
    assert isinstance(ft, tst.Matrix) and ft.device == CPU
    assert tauto.decisions()["geqrf_panel|1024,512,512,float32,cpu"] == site
    assert _rel(ft.data.numpy(), np.asarray(fj.data)) <= 1e-5
    assert _rel(tt.numpy(), np.asarray(tj)) <= 1e-5
    q = tst.ungqr(ft, tt).numpy()
    assert _orth(q) < 50


# ---------------------------------------------------------------------------
# The Householder recursion and the drivers, fp64, against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n", [(64, 64), (120, 40), (40, 96)])
def test_householder_panel_recursion_and_larft_match_jax(m, n):
    a = _gauss(m, n, 1, np.float64)
    fj, tj = (np.asarray(x) for x in jqr._panel_geqrf(jnp.asarray(a)))
    ft, tt = tqr._panel_geqrf(_t(a))
    np.testing.assert_allclose(ft.numpy(), fj, atol=1e-10)
    np.testing.assert_allclose(tt.numpy(), tj, atol=1e-10)
    fj, tj = (np.asarray(x) for x in jqr.geqrf_rec(jnp.asarray(a), 16))
    ft, tt = tqr.geqrf_rec(_t(a), 16)
    np.testing.assert_allclose(ft.numpy(), fj, atol=1e-10)
    np.testing.assert_allclose(tt.numpy(), tj, atol=1e-10)
    k = min(m, n)
    v = np.tril(fj[:, :k], -1) + np.eye(m, k)
    t_ref = np.asarray(jqr.larft_rec(jnp.asarray(v), jnp.asarray(tj)))
    np.testing.assert_allclose(tqr.larft_rec(_t(v), _t(tj)).numpy(), t_ref,
                               atol=1e-10)


def test_complex_geqrf_rec_and_unmqr_match_jax():
    """complex128: the panels complex he2hb rides (geqrf_rec, larft_rec)
    and unmqr with Qᴴ, against the JAX package on the same input."""
    m, n = 48, 32
    rng = np.random.default_rng(21)
    a = rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))
    fj, tj = (np.asarray(x) for x in jqr.geqrf_rec(jnp.asarray(a), 8))
    ft, tt = tqr.geqrf_rec(_t(a), 8)
    np.testing.assert_allclose(ft.numpy(), fj, atol=1e-10)
    np.testing.assert_allclose(tt.numpy(), tj, atol=1e-10)
    c = rng.standard_normal((m, 5)) + 1j * rng.standard_normal((m, 5))
    ref = np.asarray(jqr.unmqr(jst.Side.Left, jst.Op.ConjTrans,
                               jst.Matrix.from_array(jnp.asarray(fj), nb=8),
                               jnp.asarray(tj), jnp.asarray(c)))
    got = tst.unmqr(Side.Left, Op.ConjTrans,
                    tst.Matrix.from_array(ft, nb=8, device="cpu"), tt, c,
                    device="cpu").numpy()
    np.testing.assert_allclose(got, ref, atol=1e-10)
    # Qᴴ·A is [R; 0]
    np.testing.assert_allclose(
        tst.unmqr(Side.Left, Op.ConjTrans,
                  tst.Matrix.from_array(ft, nb=8, device="cpu"), tt, a,
                  device="cpu").numpy()[:n], np.triu(ft.numpy()[:n]),
        atol=1e-10)


def test_householder_panel_reflects_a_zero_tail_as_the_jax_loop():
    """An upper-triangular column: LAPACK takes H = I (τ = 0), the JAX loop
    reflects it (τ = 2, row negated); a zero column keeps τ = 0 in both."""
    a = np.triu(_gauss(6, 4, 2, np.float64))
    a[:, 2] = 0.0
    fj, tj = (np.asarray(x) for x in jqr._panel_geqrf(jnp.asarray(a)))
    ft, tt = tqr._panel_geqrf(_t(a))
    np.testing.assert_allclose(tt.numpy(), tj, atol=1e-12)
    np.testing.assert_allclose(ft.numpy(), fj, atol=1e-12)
    assert tj[2] == 0 and tj[0] == 2


def test_larft_interior_zero_tau_matches_jax():
    rng = np.random.default_rng(55)
    m, k = 8, 3
    v = np.tril(rng.standard_normal((m, k)), -1)
    v[np.arange(k), np.arange(k)] = 1.0
    tau = np.array([0.7, 0.0, 0.4])
    ref = np.asarray(jqr.larft_rec(jnp.asarray(v), jnp.asarray(tau)))
    t = tqr.larft_rec(_t(v), _t(tau)).numpy()
    np.testing.assert_allclose(t, ref, atol=1e-12)
    assert np.all(t[1] == 0) and np.all(t[:, 1] == 0)
    q = np.eye(m)
    for j in range(k):
        q = q @ (np.eye(m) - tau[j] * np.outer(v[:, j], v[:, j]))
    np.testing.assert_allclose(np.eye(m) - v @ t @ v.T, q, atol=1e-12)


def _factor_pair(m, k, seed, nb=8):
    """A fp64 (packed, taus) from the JAX package's geqrf_rec, and the same
    as the port's Matrix (through interop) and τ tensor."""
    a = _gauss(m, k, seed, np.float64)
    fj, tj = jqr.geqrf_rec(jnp.asarray(a), nb)
    ft = tst.matrix_from_numpy("Matrix", np.asarray(fj), nb=nb, device="cpu")
    return fj, tj, ft, _t(tj)


@pytest.mark.parametrize("side", [Side.Left, Side.Right])
@pytest.mark.parametrize("op", [Op.NoTrans, Op.Trans])
def test_unmqr_sides_ops_match_jax(side, op):
    """A factor made by the JAX package, applied by both packages' unmqr."""
    m, k = 40, 24
    fj, tj, ft, tt = _factor_pair(m, k, 4)
    c = np.random.default_rng(5).standard_normal((m, m))
    jside, jop = jst.Side(side.value), jst.Op(op.value)
    ref = np.asarray(jqr.unmqr(jside, jop, jst.Matrix.from_array(fj, nb=8),
                               tj, jnp.asarray(c)))
    got = tst.unmqr(side, op, ft, tt, c, device="cpu").numpy()
    np.testing.assert_allclose(got, ref, atol=1e-10)
    q = tst.ungqr(ft, tt, m).numpy()
    qop = q if op is Op.NoTrans else q.T
    np.testing.assert_allclose(got, qop @ c if side is Side.Left else c @ qop,
                               atol=1e-10)


def test_qr_factor_round_trips_between_the_packages():
    """The port's factor, carried to the JAX package, is applied there."""
    a = _gauss(36, 20, 6, np.float64)
    ft, tt = tst.geqrf(tst.Matrix.from_array(a, nb=8, device="cpu"),
                       {"method_factor": "recursive"})
    d = tst.matrix_to_numpy(ft)
    q_j = np.asarray(jqr.ungqr(jst.Matrix.from_array(jnp.asarray(d["data"]),
                                                     nb=d["nb"]),
                               jnp.asarray(tt.numpy()), 36))
    np.testing.assert_allclose(q_j, tst.ungqr(ft, tt, 36).numpy(), atol=1e-12)


def test_gelqf_unmlq_match_jax():
    m, n = 30, 70
    a = _gauss(m, n, 7, np.float64)
    fj, tj = jqr.gelqf(jst.Matrix.from_array(jnp.asarray(a), nb=16))
    ft, tt = tst.gelqf(tst.Matrix.from_array(a, nb=16, device="cpu"))
    np.testing.assert_allclose(ft.data.numpy(), np.asarray(fj.data), atol=1e-10)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-10)
    lext = np.zeros((m, n))
    lext[:, :m] = np.tril(ft.data.numpy())[:, :m]
    got = tst.unmlq(Side.Right, Op.NoTrans, ft, tt, lext).numpy()
    np.testing.assert_allclose(got, a, atol=1e-11)
    ref = np.asarray(jqr.unmlq(jst.Side.Right, jst.Op.NoTrans, fj, tj,
                               jnp.asarray(lext)))
    np.testing.assert_allclose(got, ref, atol=1e-10)


@pytest.mark.parametrize("m,n", [(90, 30), (30, 80)])
def test_gels_qr_matches_jax_and_lstsq(m, n):
    a = _gauss(m, n, 8, np.float64)
    b = np.random.default_rng(9).standard_normal(m)
    ref = np.asarray(jqr.gels_qr(jst.Matrix.from_array(jnp.asarray(a), nb=16),
                                 jnp.asarray(b)))
    x = tst.gels_qr(tst.Matrix.from_array(a, nb=16, device="cpu"), b).numpy()
    np.testing.assert_allclose(x, ref, atol=1e-10)
    np.testing.assert_allclose(x, np.linalg.lstsq(a, b, rcond=None)[0],
                               atol=1e-9)


def test_cholqr_matches_jax():
    a = _cond(200, 24, 1e3, 10)
    qj, rj = (np.asarray(x) for x in jqr.cholqr(
        jst.Matrix.from_array(jnp.asarray(a), nb=16)))
    q, r = (x.numpy() for x in tst.cholqr(
        tst.Matrix.from_array(a, nb=16, device="cpu")))
    np.testing.assert_allclose(q, qj, atol=1e-10)
    np.testing.assert_allclose(r, rj, atol=1e-10)
    np.testing.assert_allclose(q @ r, a, atol=1e-11)
    assert np.all(np.tril(r, -1) == 0)


def test_gels_cholqr_and_auto_selection_match_jax():
    m, n = 300, 40
    a = _gauss(m, n, 11, np.float64)
    b = np.random.default_rng(12).standard_normal((m, 3))
    want = np.linalg.lstsq(a, b, rcond=None)[0]
    A = tst.Matrix.from_array(a, nb=16, device="cpu")
    JA = jst.Matrix.from_array(jnp.asarray(a), nb=16)
    x1 = tst.gels_cholqr(A, b).numpy()
    np.testing.assert_allclose(
        x1, np.asarray(jqr.gels_cholqr(JA, jnp.asarray(b))), atol=1e-10)
    np.testing.assert_allclose(x1, want, atol=1e-8)
    x2 = tst.gels(A, b).numpy()                     # Auto: m ≥ 3n → CholQR
    np.testing.assert_array_equal(x2, x1)
    x3 = tst.gels(A, b, {"method_gels": MethodGels.QR}).numpy()
    np.testing.assert_array_equal(x3, tst.gels_qr(A, b).numpy())
    np.testing.assert_allclose(x3, want, atol=1e-8)
    assert select_gels(MethodGels.Auto, 300, 100) is MethodGels.CholQR
    assert select_gels(MethodGels.Auto, 299, 100) is MethodGels.QR
    assert select_gels(MethodGels.QR, 900, 10) is MethodGels.QR


def test_drivers_default_to_cuda():
    """With no device named and no Matrix operand, a driver places its
    input on the card, which this host lacks."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is a valid default here")
    a = _gauss(16, 8, 13)
    for call in (lambda: tst.geqrf(a), lambda: tst.gels(a, a[:, 0]),
                 lambda: tst.cholqr(a), lambda: tst.gelqf(a.T)):
        with pytest.raises(tst.SlateError):
            call()


# ---------------------------------------------------------------------------
# The geqrf_panel site
# ---------------------------------------------------------------------------

def test_geqrf_panel_site_answers(monkeypatch):
    f32, f64 = torch.float32, torch.float64
    assert tauto.choose_geqrf_panel(4096, 1024, 512, f32, CPU) == "cholqr2"
    assert tauto.choose_geqrf_panel(4096, 1024, 512, f32, "cuda") == "cholqr2"
    assert tauto.choose_geqrf_panel(4096, 1024, 512, f64, CPU) == "stock"
    assert tauto.select("geqrf_panel", m=64, n=64, nb=512, dtype=f32,
                        device=CPU) == "cholqr2"
    monkeypatch.setattr(tcfg, "use_kernels", False)
    assert tauto.choose_geqrf_panel(4096, 1024, 512, f32, CPU) == "stock"
    reasons = tauto.decisions(with_reasons=True)
    assert reasons["geqrf_panel|4096,1024,512,float32,cpu"] == (
        "stock", "kernels off")
