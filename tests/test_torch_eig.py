"""The port's two-stage Hermitian eigensolver (slate_tpu_torch.linalg.eig,
_chase, _stedc, native) and its hb2st_wavefront kernel against the JAX
package's on the same numpy inputs made from a seed.  On the CPU the
port's kernel wrapper runs its plain version; the JAX package runs its
Pallas chase in interpret mode where the test pins it
(``SLATE_TPU_AUTOTUNE_FORCE=chase=pallas_wavefront``), as its own tests do.

Tolerances, each with its reason:

* the chase (band, τ, v, a back-transformed probe): the JAX test's own,
  5e-3 (band: times max|band|) in fp32 and 1e-8 in fp64
  (tests/test_chase_wavefront.py:199): the two run the same task bodies
  with sums in another order, and the chase's forward error grows along
  the sweeps;
* the host chase against the JAX package's compiled one: 1e-13 relative
  (Frobenius) for the Givens chase and its applier, 1e-12 for the
  Householder chase (1.1e-13 measured over 120 sweeps): the same C++
  task bodies, built here with ``-mfma`` and there with
  ``-march=native``, contract other products into FMAs;
* stage 1 and its back-transform: 1e-10 in fp64/c128 (LAPACK's geqrf
  leaf against the JAX column loop), 1e-4 relative in fp32;
* heev: the JAX test's gates, 50·n·ε·max|w| (tests/test_eig_svd.py:61-78);
  the port back-transforms the tridiagonal eigenvectors in the band's
  dtype, the JAX package's CPU tests in fp64 (x64 on);
* hegv: the JAX test's 1e-9.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import slate_tpu as jst
from slate_tpu import native as jnative
from slate_tpu.linalg import eig as jeig
from slate_tpu.linalg._stedc import stedc as jstedc
from slate_tpu.ops import pallas_kernels as pk
from slate_tpu.perf import autotune as jauto
import slate_tpu_torch as tst
from slate_tpu_torch import native as tnative
from slate_tpu_torch.enums import MethodEig, Op, Side
from slate_tpu_torch.linalg import eig as teig
from slate_tpu_torch.ops import kernels
from slate_tpu_torch.perf import autotune as tauto
from slate_tpu_torch.perf import metrics

ROOT = Path(__file__).resolve().parent.parent
FORCE = "SLATE_TPU_TORCH_AUTOTUNE_FORCE"
JFORCE = "SLATE_TPU_AUTOTUNE_FORCE"


@pytest.fixture(autouse=True)
def _tables(tmp_path, monkeypatch):
    """A private JAX autotune table, no pins, a clean port census."""
    monkeypatch.setenv("SLATE_TPU_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    monkeypatch.delenv(FORCE, raising=False)
    monkeypatch.delenv(JFORCE, raising=False)
    jauto.reset_table()
    tauto._decisions.clear()
    yield


def _herm(rng, n, dtype):
    a = rng.standard_normal((n, n))
    if np.dtype(dtype).kind == "c":
        a = a + 1j * rng.standard_normal((n, n))
    return ((a + a.conj().T) / 2).astype(dtype)


def _band_wide(n, kd, seed, dtype=np.float64):
    """bench.py-style random wide band (tests/test_chase_wavefront.py:32)."""
    rng = np.random.default_rng(seed)
    abw = np.zeros((n, 2 * kd + 2), dtype=dtype)
    for d in range(kd + 1):
        v = rng.standard_normal(n - d)
        if np.issubdtype(dtype, np.complexfloating) and d > 0:
            v = v + 1j * rng.standard_normal(n - d)
        abw[:n - d, d] = v
    return abw


def _eps(dtype):
    return np.finfo(np.dtype(dtype).char.lower() if np.dtype(dtype).kind == "c"
                    else dtype).eps


# ---------------------------------------------------------------------------
# The kernel: hb2st_wavefront's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,kd", [(96, 8), (128, 48), (37, 5), (8192, 256),
                                  (1024, 64), (10, 4)])
def test_wave_meta_matches_jax(n, kd):
    for j0, j1 in [(0, None), (0, n // 3), (n // 3, n - 2)]:
        assert kernels.hb_wave_meta(n, kd, j0, j1) == \
            pk._hb_wave_meta(n, kd, j0, j1)


@pytest.mark.parametrize("n,kd", [(96, 8), (128, 48)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_hb2st_wavefront_plain_matches_pallas(n, kd, dtype):
    ab = _band_wide(n, kd, 7).astype(dtype)
    ab_j, vt_j = map(np.asarray, pk.hb2st_wavefront(jnp.asarray(ab), kd))
    ab_t, vt_t = kernels.hb2st_wavefront(torch.from_numpy(ab.copy()), kd)
    ab_t, vt_t = ab_t.numpy(), vt_t.numpy()
    assert vt_t.shape == vt_j.shape
    tol = 5e-3 if dtype == np.float32 else 1e-8
    np.testing.assert_allclose(ab_t, ab_j, atol=tol * np.abs(ab).max(), rtol=0)
    np.testing.assert_allclose(vt_t[:, :, 1:], vt_j[:, :, 1:], atol=tol, rtol=0)
    np.testing.assert_allclose(vt_t[:, :, 0], vt_j[:, :, 0], atol=tol, rtol=0)
    # the consumed layout: a probe back-transformed through each log by
    # its own package
    z = np.random.default_rng(8).standard_normal((n, 4)).astype(dtype)
    s0 = np.arange(1, vt_j.shape[0] + 1, dtype=np.int32)
    z_j = np.asarray(jeig.unmtr_hb2st_hh(vt_j[:, :, 1:], vt_j[:, :, 0], s0,
                                         jnp.asarray(z), kd))
    z_t = teig.unmtr_hb2st_hh(torch.from_numpy(vt_t[:, :, 1:].copy()),
                              torch.from_numpy(vt_t[:, :, 0].copy()), s0,
                              torch.from_numpy(z), kd).numpy()
    np.testing.assert_allclose(z_t, z_j, atol=tol * 10, rtol=0)


def test_hb2st_wavefront_plain_range_chunks_match_pallas():
    """The sweep-range chunks (tests/test_chase_wavefront.py:215): the band
    is the whole state between chunks."""
    n, kd = 96, 8
    ab_j = jnp.asarray(_band_wide(n, kd, 9))
    ab_t = torch.from_numpy(_band_wide(n, kd, 9))
    for j0, j1 in [(0, 30), (30, 70), (70, n - 2)]:
        ab_j, vt_j = pk.hb2st_wavefront(ab_j, kd, j0, j1)
        ab_t, vt_t = kernels.hb2st_wavefront(ab_t, kd, j0, j1)
        np.testing.assert_allclose(ab_t.numpy(), np.asarray(ab_j), atol=1e-8,
                                   rtol=0)
        np.testing.assert_allclose(vt_t.numpy(), np.asarray(vt_j), atol=1e-8,
                                   rtol=0)


@pytest.mark.parametrize("bad", ["kd3", "width", "complex"])
def test_hb2st_wavefront_rejects_what_the_kernel_does_not_take(bad):
    kd = 3 if bad == "kd3" else 8
    ab = torch.zeros((40, 2 * kd + (3 if bad == "width" else 2)),
                     dtype=torch.complex128 if bad == "complex"
                     else torch.float64)
    with pytest.raises(ValueError):
        kernels.hb2st_wavefront(ab, kd)


# ---------------------------------------------------------------------------
# The host chase (slate_tpu_torch.native) against the JAX package's
# ---------------------------------------------------------------------------

def _need_native():
    if not jnative.available():
        pytest.skip("the JAX package's native runtime is unavailable")
    assert tnative.available(), tnative.build_error()


def _rel(x, y):
    return np.linalg.norm(x - y) / np.linalg.norm(y)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
def test_native_chase_matches_jax_runtime(dtype):
    _need_native()
    n, kd = 200, 16
    wide = _band_wide(n, kd, 3, dtype)
    ab = np.ascontiguousarray(wide[:, :kd + 2])
    ab_j, ab_t = ab.copy(), ab.copy()
    rots_j = jnative.hb2st_banded(ab_j, n, kd)
    rots_t = tnative.hb2st_banded(ab_t, n, kd)
    assert _rel(ab_t, ab_j) < 1e-13
    np.testing.assert_array_equal(rots_t[0], rots_j[0])
    for x, y in zip(rots_t[1:], rots_j[1:]):
        assert _rel(x, y) < 1e-13
    z = np.random.default_rng(4).standard_normal((n, 6)).astype(dtype)
    zj = jnative.apply_rot_seq(z.copy(), *rots_j, 0, kd=kd)
    assert _rel(tnative.apply_rot_seq(z.copy(), *rots_j, 0, kd=kd), zj) < 1e-13
    aw_j, aw_t = wide.copy(), wide.copy()
    log_j = jnative.hb2st_hh_banded_range(aw_j, n, kd, 0, 120)
    log_t = tnative.hb2st_hh_banded_range(aw_t, n, kd, 0, 120)
    # the Householder chase carries its rounding through 120 sweeps:
    # 1.1e-13 measured against the JAX package's AVX-512 build
    assert _rel(aw_t, aw_j) < 1e-12
    for x, y in zip(log_t, log_j):
        assert _rel(x, y) < 1e-12


@pytest.mark.parametrize("nthreads", [1, 4])
def test_native_wavefront_chase_is_the_serial_chase(nthreads, monkeypatch):
    """The OpenMP wavefront of the Householder chase against its serial
    sweep order (``SLATE_TPU_TORCH_CHASE_SERIAL=1``): bitwise equal, band
    and log, at every thread count."""
    assert tnative.available(), tnative.build_error()
    n, kd = 300, 16
    ab_s = _band_wide(n, kd, 0)
    ab_w = ab_s.copy()
    monkeypatch.setenv("SLATE_TPU_TORCH_CHASE_SERIAL", "1")
    ser = tnative.hb2st_hh_banded_range(ab_s, n, kd, 0, n - 2)
    monkeypatch.delenv("SLATE_TPU_TORCH_CHASE_SERIAL")
    prev = tnative.num_threads()
    tnative.set_num_threads(nthreads)
    try:
        wav = tnative.hb2st_hh_banded(ab_w, n, kd)
    finally:
        tnative.set_num_threads(prev)
    np.testing.assert_array_equal(ab_w, ab_s)
    for x, y in zip(wav, ser):
        np.testing.assert_array_equal(x, y)


def test_importing_native_builds_nothing():
    code = ("import slate_tpu_torch.native as nv\n"
            "assert nv._lib is None and nv._build_error is None\n"
            "print('OK')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr[-2000:]


# ---------------------------------------------------------------------------
# Stages 1 and 3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,nb,dtype", [(32, 8, np.float64),
                                        (45, 16, np.float64),
                                        (32, 8, np.complex128),
                                        (45, 16, np.complex128),
                                        (64, 16, np.float32)])
def test_he2hb_and_unmtr_he2hb_match_jax(n, nb, dtype):
    a = _herm(np.random.default_rng(42), n, dtype)
    fj = jeig.he2hb(jnp.asarray(a), {"block_size": nb})
    ft = teig.he2hb(a, {"block_size": nb}, device="cpu")
    eye = np.eye(n, dtype=dtype)
    qj = np.asarray(jeig.unmtr_he2hb(jst.Side.Left, jst.Op.NoTrans, fj,
                                     jnp.asarray(eye)))
    qt = teig.unmtr_he2hb(Side.Left, Op.NoTrans, ft,
                          torch.from_numpy(eye)).numpy()
    band = ft.band.numpy()
    if dtype == np.float32:
        rel = lambda x, y: np.linalg.norm(x - y) / np.linalg.norm(y)
        assert rel(band, np.asarray(fj.band)) < 1e-4
        assert rel(qt, qj) < 1e-4
        assert rel(qt @ band @ qt.T, a) < 1e-5
        return
    np.testing.assert_allclose(band, np.asarray(fj.band), atol=1e-10)
    np.testing.assert_allclose(qt, qj, atol=1e-10)
    i, j = np.indices(band.shape)
    assert np.abs(band[np.abs(i - j) > nb]).max() < 1e-12
    assert np.abs(qt @ band @ qt.conj().T - a).max() < 1e-12 * n
    # the right side and Qᴴ: C·Q₁ and Q₁ᴴ·C
    c = np.random.default_rng(1).standard_normal((n, n)).astype(dtype)
    np.testing.assert_allclose(
        teig.unmtr_he2hb(Side.Right, Op.NoTrans, ft,
                         torch.from_numpy(c)).numpy(), c @ qt, atol=1e-10)
    np.testing.assert_allclose(
        teig.unmtr_he2hb(Side.Left, Op.ConjTrans, ft,
                         torch.from_numpy(c)).numpy(), qt.conj().T @ c,
        atol=1e-10)


def test_unmtr_hb2st_hh_matches_jax():
    """One host log (the native Householder chase), back-transformed by
    both packages."""
    _need_native()
    n, kd = 60, 8
    abw = _band_wide(n, kd, 5)
    v, tau, row0, length = jnative.hb2st_hh_banded(abw, n, kd)
    v3, t2, s0 = jeig._pack_hh_log(v, tau, row0, length, n, kd)
    v3t, t2t, s0t = teig._pack_hh_log(v, tau, row0, length, n, kd)
    for x, y in zip((v3t, t2t, s0t), (v3, t2, s0)):
        np.testing.assert_array_equal(x, y)
    z = np.random.default_rng(6).standard_normal((n, 5))
    zj = np.asarray(jeig.unmtr_hb2st_hh(v3, t2, s0, jnp.asarray(z), kd))
    zt = teig.unmtr_hb2st_hh(v3, t2, s0, torch.from_numpy(z), kd).numpy()
    np.testing.assert_allclose(zt, zj, atol=1e-13)


def test_stedc_matches_jax():
    rng = np.random.default_rng(12)
    d, e = rng.standard_normal(80), rng.standard_normal(79)
    wj, zj = jstedc(d, e, True)
    wt, zt = teig.stedc(d, e)
    np.testing.assert_array_equal(wt, wj)
    np.testing.assert_array_equal(zt, zj)


# ---------------------------------------------------------------------------
# The drivers
# ---------------------------------------------------------------------------

def _heev_gates(a, w, z, tol):
    n = a.shape[0]
    ref = np.linalg.eigvalsh(a.astype(np.complex128 if a.dtype.kind == "c"
                                      else np.float64))
    assert np.abs(np.sort(w) - ref).max() < tol
    assert np.abs(a @ z - z * w[None, :]).max() < tol
    assert np.abs(z.conj().T @ z - np.eye(n)).max() < tol


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex128])
@pytest.mark.parametrize("method", [MethodEig.DC, MethodEig.QR,
                                    MethodEig.MRRR])
def test_heev_matches_jax(dtype, method):
    n, nb = 36, 8
    a = _herm(np.random.default_rng(7), n, dtype)
    w, z = tst.heev(a, True, {"block_size": nb, "method_eig": method},
                    device="cpu")
    assert w.dtype == torch.from_numpy(np.zeros(1, dtype)).real.dtype
    assert z.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
    w, z = w.numpy().astype(np.float64), z.numpy()
    tol = 50 * n * _eps(dtype) * max(1, np.abs(w).max())
    _heev_gates(a, w, z, tol)
    wj, _ = jst.heev(jnp.asarray(a), True,
                     {"block_size": nb,
                      "method_eig": jst.MethodEig(method.value)})
    np.testing.assert_allclose(w, np.asarray(wj), atol=tol)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_heev_kernel_route_matches_jax_pallas_route(dtype, monkeypatch):
    """The chase pinned to the kernel route (its plain version here),
    against the JAX package pinned to its Pallas chase; the kernel route
    moves no band or log bytes between host and device."""
    monkeypatch.setenv(FORCE, "chase=kernel")
    monkeypatch.setenv(JFORCE, "chase=pallas_wavefront")
    n, nb = 64, 8
    a = _herm(np.random.default_rng(5), n, dtype)
    was_on = metrics.enabled()
    metrics.reset()
    metrics.on()
    try:
        w, z = tst.heev(tst.HermitianMatrix(a, uplo=tst.Uplo.Lower,
                                            device="cpu"),
                        True, {"block_size": nb})
        snap = metrics.snapshot()["counters"]
    finally:
        metrics.reset()
        if not was_on:
            metrics.off()
    assert snap.get("chase.dispatch.kernel", 0) >= 1
    assert snap.get("chase.host_bytes") == 0.0
    assert any(k.startswith("chase|") and v == ("kernel", "forced")
               for k, v in tauto.decisions(with_reasons=True).items())
    w, z = w.numpy().astype(np.float64), z.numpy().astype(np.float64)
    tol = 50 * n * _eps(dtype) * max(1, np.abs(w).max())
    _heev_gates(a, w, z, tol)
    wj, zj = jst.heev(jst.HermitianMatrix(jnp.asarray(a), uplo=jst.Uplo.Lower),
                      True, {"block_size": nb})
    np.testing.assert_allclose(w, np.asarray(wj), atol=tol)
    # the same eigenvectors up to sign (the spectrum has no close pair)
    np.testing.assert_allclose(np.abs(np.diag(z.T @ np.asarray(zj))), 1.0,
                               atol=tol)


def test_heev_vals_matches_jax():
    a = _herm(np.random.default_rng(11), 30, np.float64)
    w = tst.heev_vals(a, {"block_size": 8}, device="cpu").numpy()
    np.testing.assert_allclose(w, np.linalg.eigvalsh(a), atol=1e-11)
    np.testing.assert_allclose(
        w, np.asarray(jst.heev_vals(jnp.asarray(a), {"block_size": 8})),
        atol=1e-11)
    w2, z2 = tst.syev(a, False, {"block_size": 8}, device="cpu")
    assert z2 is None
    np.testing.assert_allclose(w2.numpy(), w, atol=1e-12)


@pytest.mark.parametrize("itype", [1, 2, 3])
def test_hegv_matches_jax(itype):
    import scipy.linalg as sla

    n, nb = 28, 8
    rng = np.random.default_rng(5)
    a = _herm(rng, n, np.float64)
    b = rng.standard_normal((n, n))
    b = b @ b.T + n * np.eye(n)
    w, z = tst.hegv(a, b, itype, True, {"block_size": nb}, device="cpu")
    w, z = w.numpy(), z.numpy()
    np.testing.assert_allclose(np.sort(w), sla.eigh(a, b, type=itype,
                                                    eigvals_only=True),
                               atol=1e-9)
    wj, zj = jst.hegv(jnp.asarray(a), jnp.asarray(b), itype, True,
                      {"block_size": nb})
    np.testing.assert_allclose(w, np.asarray(wj), atol=1e-9)
    if itype == 1:
        assert np.abs(a @ z - b @ z * w[None, :]).max() < 1e-9
    l = np.linalg.cholesky(b)
    np.testing.assert_allclose(
        tst.sygst(itype, a, l, {"block_size": nb}, device="cpu").numpy(),
        np.asarray(jeig.sygst(itype, jnp.asarray(a), jnp.asarray(l),
                              {"block_size": nb})), atol=1e-10)


@pytest.mark.parametrize("route", ["kernel", "host_native"])
def test_band_storage_entry_routes(route, monkeypatch):
    """``_band_eig_ab`` (the band-storage entry, ``(n, kd+2)`` host
    storage): the kernel route (one O(n·kd) upload counted as ingestion)
    and the host Givens route give the band's eigenpairs."""
    monkeypatch.setenv(FORCE, "chase=" + route)
    n, kd = 50, 6
    abw = _band_wide(n, kd, 13)
    ab = np.ascontiguousarray(abw[:, :kd + 2])
    ab[:, kd + 1] = 0
    dense = np.zeros((n, n))
    for d in range(kd + 1):
        dense += np.diag(ab[:n - d, d], -d)
    dense = dense + np.tril(dense, -1).T
    was_on = metrics.enabled()
    metrics.reset()
    metrics.on()
    try:
        w, z = teig._band_eig_ab(ab.copy(), kd, True, MethodEig.DC, True,
                                 torch.device("cpu"))
        snap = metrics.snapshot()["counters"]
    finally:
        metrics.reset()
        if not was_on:
            metrics.off()
    z = np.asarray(torch.as_tensor(z))
    np.testing.assert_allclose(w, np.linalg.eigvalsh(dense), atol=1e-11)
    assert np.abs(dense @ z - z * w[None, :]).max() < 1e-11
    assert (snap.get("chase.ingest_bytes", 0) > 0) == (route == "kernel")


def test_qdwh_driver_is_not_ported(monkeypatch):
    """The QDWH driver is ported now (tests/test_torch_polar.py holds it
    against the JAX package): an ``eig_driver="qdwh"`` option or pin
    answers heev_qdwh's eigenpairs."""
    a = _herm(np.random.default_rng(1), 16, np.float64)
    w0, z0 = tst.heev_qdwh(torch.from_numpy(a), True, {"qdwh_crossover": 4},
                           device="cpu")
    np.testing.assert_allclose(w0.numpy(), np.linalg.eigvalsh(a), atol=1e-12)
    w, z = tst.heev(a, True, {"eig_driver": "qdwh", "qdwh_crossover": 4},
                    device="cpu")
    assert torch.equal(w, w0) and torch.equal(z, z0)
    monkeypatch.setenv(FORCE, "eig_driver=qdwh")
    w, _ = tst.heev(a, True, {"qdwh_crossover": 4}, device="cpu")
    assert torch.equal(w, w0)


def test_chase_site_answers(monkeypatch):
    from slate_tpu_torch import config as tcfg

    f32 = torch.float32
    assert tauto.choose_chase("hb2st", 64, 8, f32, "cpu", True) == "host_native"
    assert tauto.choose_chase("hb2st", 64, 8, f32, "cuda", True) == "kernel"
    assert tauto.choose_chase("hb2st", 64, 8, f32, "cuda", False) == \
        "host_native"
    assert tauto.choose_chase("hb2st", 64, 8, torch.complex128, "cuda",
                              True) == "host_native"
    monkeypatch.setenv(FORCE, "chase=kernel")
    assert tauto.choose_chase("hb2st", 64, 8, f32, "cpu", True) == "kernel"
    monkeypatch.setattr(tcfg, "use_kernels", False)
    assert tauto.choose_chase("hb2st", 64, 8, f32, "cuda", True) == \
        "host_native"


def test_eig_driver_site_answers(monkeypatch):
    """As the JAX site off the TPU: twostage by default and when the call
    site is ineligible, a pin of either name answered as it is, any
    other pin warned about and ignored."""
    f32 = torch.float32
    assert tauto.choose_eig_driver(64, f32, "cpu", True) == "twostage"
    monkeypatch.setenv(FORCE, "eig_driver=qdwh")
    assert tauto.choose_eig_driver(64, f32, "cpu", True) == "qdwh"
    assert tauto.choose_eig_driver(64, f32, "cpu", False) == "twostage"
    monkeypatch.setenv(FORCE, "eig_driver=jacobi")
    with pytest.warns(UserWarning, match="jacobi"):
        assert tauto.choose_eig_driver(64, f32, "cpu", True) == "twostage"


def test_eig_drivers_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    a = _herm(np.random.default_rng(2), 16, np.float64)
    with pytest.raises(tst.SlateError, match="no CUDA device"):
        tst.heev(a)
