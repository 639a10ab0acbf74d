"""The port's two-stage SVD (slate_tpu_torch.linalg.svd, the tb2bd half of
_chase, native) and its tb2bd_wavefront kernel against the JAX package's
on the same numpy inputs made from a seed.  On the CPU the port's kernel
wrapper runs its plain version; the JAX package runs its Pallas chase in
interpret mode, called directly or pinned through
``SLATE_TPU_AUTOTUNE_FORCE=chase=pallas_wavefront``, as its own tests do.

Tolerances, each with its reason:

* the chase in fp64 (band, τ, v, a probe back-transformed through both
  logs): the JAX test's 1e-8 (tests/test_chase_wavefront.py:236-252;
  the band times max|band|): the two run the same task bodies with sums
  in another order;
* the chase in fp32: the band over the whole chase and both logs over
  the first 64 sweeps within 5e-3 (the band times max|band|), and the
  whole chase to the backward gates below.  The fp32 chase's forward
  error is not stable along the sweeps: at (96, 8) the JAX package's
  interpreted kernel in fp32 departs from itself in fp64 by 0.1 in a V
  reflector and takes τ = 0 for a reflector whose tail it rounds to
  1e-22, where both packages take τ = 2 in fp64 and the port in fp32
  (the tail is 4e-13 there);
* the backward gates of a whole chase: ‖B·V₂ − U₂·bidiag(d, e)‖ and the
  orthogonality of U₂ and V₂ within 50·n·ε (relative to ‖B‖);
* the host chases against the JAX package's compiled ones: bitwise for
  the Givens chase, 1e-11 relative (Frobenius) for the whole Householder
  chase (2.7e-12 measured at n = 200, kd = 16): the same C++ task
  bodies, built here with ``-mfma`` and there with ``-march=native``,
  contract other products into FMAs;
* ``bdsdc``: bitwise (both call scipy's OpenBLAS ``dbdsdc``);
* stage 1 and its back-transform: 1e-10 in fp64/c128, 1e-4 relative in
  fp32 (the eigensolver test's);
* svd: the JAX test's gates (tests/test_eig_svd.py:106-139), 1e-11 in
  fp64/c128 and 1e-3 in fp32, and the JAX package's σ within the same;
  U and Vᴴ, each column's sign (phase) aligned by its inner product,
  within 1e-9 in fp64/c128 (a singular vector moves by ε·σ_max/gap) and
  50·n·ε in fp32 on the kernel route.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import slate_tpu as jst
from slate_tpu import native as jnative
from slate_tpu.linalg import eig as jeig
from slate_tpu.ops import pallas_kernels as pk
from slate_tpu.perf import autotune as jauto
import slate_tpu_torch as tst
from slate_tpu_torch import native as tnative
from slate_tpu_torch.enums import MethodSVD, Op, Side
from slate_tpu_torch.linalg import _chase
from slate_tpu_torch.linalg import eig as teig
from slate_tpu_torch.ops import kernels
from slate_tpu_torch.perf import autotune as tauto
from slate_tpu_torch.perf import metrics

# the modules (each package's linalg exports a function named svd)
jsvd = importlib.import_module("slate_tpu.linalg.svd")
tsvd = importlib.import_module("slate_tpu_torch.linalg.svd")

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


def _tb_band(n, kd, seed):
    """The JAX test's random general band (tests/test_chase_wavefront.py:
    50): ``st[r, c−r+kd]`` = A[r, c] for r ≤ c ≤ r + kd."""
    rng = np.random.default_rng(seed)
    st = np.zeros((n, 3 * kd + 2), dtype=np.float64)
    for r in range(n):
        for c in range(r, min(r + kd + 1, n)):
            st[r, c - r + kd] = rng.standard_normal()
    return st


def _dense(st, kd):
    n = st.shape[0]
    a = np.zeros((n, n))
    for d in range(kd + 1):
        a += np.diag(st[:n - d, kd + d], d)
    return a


def _gaussian(rng, m, n, dtype):
    a = rng.standard_normal((m, n))
    if np.dtype(dtype).kind == "c":
        a = a + 1j * rng.standard_normal((m, n))
    return a.astype(dtype)


def _eps(dtype):
    return np.finfo(np.dtype(dtype).char.lower() if np.dtype(dtype).kind == "c"
                    else dtype).eps


def _need_native():
    if not jnative.available():
        pytest.skip("the JAX package's native runtime is unavailable")
    assert tnative.available(), tnative.build_error()


def _rel(x, y):
    return np.linalg.norm(x - y) / np.linalg.norm(y)


def _backward(b, st, ut, vt, kd):
    """‖B·V₂ − U₂·bidiag(d, e)‖/‖B‖, ‖U₂ᵀU₂ − I‖ and ‖V₂ᵀV₂ − I‖ of one
    chase (U₂, V₂ the back-transforms of I through each log)."""
    n = st.shape[0]
    eye = torch.eye(n, dtype=torch.float64)
    s0 = np.arange(1, ut.shape[0] + 1, dtype=np.int32)
    q = [teig.unmtr_hb2st_hh(torch.from_numpy(lg[:, :, 1:].astype(np.float64)),
                             torch.from_numpy(lg[:, :, 0].astype(np.float64)),
                             s0, eye, kd).numpy() for lg in (ut, vt)]
    bd = np.diag(st[:, kd]) + np.diag(st[:n - 1, kd + 1], 1)
    res = np.linalg.norm(b @ q[1] - q[0] @ bd) / np.linalg.norm(b)
    return (res, np.linalg.norm(q[0].T @ q[0] - np.eye(n)),
            np.linalg.norm(q[1].T @ q[1] - np.eye(n)))


def _align(x, ref):
    """Each column of ``x`` times the phase that aligns it with ``ref``'s."""
    p = np.sum(x.conj() * ref, axis=0)
    return x * (p / np.abs(p))[None, :], p / np.abs(p)


# ---------------------------------------------------------------------------
# The kernel: tb2bd_wavefront's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,kd", [(96, 8), (128, 48), (37, 5), (8192, 256),
                                  (1024, 64), (10, 4)])
def test_tb_wave_meta_matches_jax(n, kd):
    for s0, s1 in [(0, None), (0, n // 3), (n // 3, n - 1), (n // 2, n - 2)]:
        assert kernels.tb_wave_meta(n, kd, s0, s1) == \
            pk._tb_wave_meta(n, kd, s0, s1)


@pytest.mark.parametrize("n,kd", [(96, 8), (128, 48)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_tb2bd_wavefront_plain_matches_pallas(n, kd, dtype):
    st = _tb_band(n, kd, 11).astype(dtype)
    st_j, ut_j, vt_j = map(np.asarray, pk.tb2bd_wavefront(jnp.asarray(st), kd))
    st_t, ut_t, vt_t = (x.numpy() for x in kernels.tb2bd_wavefront(
        torch.from_numpy(st.copy()), kd))
    assert ut_t.shape == ut_j.shape and vt_t.shape == vt_j.shape
    scale = np.abs(st).max()
    if dtype == np.float64:
        tol, sw = 1e-8, ut_j.shape[0]
    else:
        tol, sw = 5e-3, 64
    np.testing.assert_allclose(st_t, st_j, atol=tol * scale, rtol=0)
    for x, y in ((ut_t, ut_j), (vt_t, vt_j)):
        np.testing.assert_allclose(x[:sw], y[:sw], atol=tol, rtol=0)
    res, ou, ov = _backward(_dense(st.astype(np.float64), kd),
                            st_t.astype(np.float64), ut_t, vt_t, kd)
    assert max(res, ou, ov) < 50 * n * _eps(dtype), (res, ou, ov)
    if dtype == np.float64:
        # the consumed layout: a probe back-transformed through both logs
        # of each package
        z = np.random.default_rng(8).standard_normal((n, 4))
        s0 = np.arange(1, ut_j.shape[0] + 1, dtype=np.int32)
        for lt, lj in ((ut_t, ut_j), (vt_t, vt_j)):
            zj = np.asarray(jeig.unmtr_hb2st_hh(lj[:, :, 1:], lj[:, :, 0], s0,
                                                jnp.asarray(z), kd))
            zt = teig.unmtr_hb2st_hh(torch.from_numpy(lt[:, :, 1:].copy()),
                                     torch.from_numpy(lt[:, :, 0].copy()), s0,
                                     torch.from_numpy(z), kd).numpy()
            np.testing.assert_allclose(zt, zj, atol=tol * 10, rtol=0)


def test_tb2bd_wavefront_plain_range_chunks_are_the_whole_chase():
    """Sweep-range chunks: the band is the whole state between chunks —
    bitwise the plain whole chase, and the Pallas chunks within 1e-8."""
    n, kd = 96, 8
    st = _tb_band(n, kd, 9)
    whole, uw, vw = kernels.tb2bd_wavefront(torch.from_numpy(st.copy()), kd)
    st_t, st_j = torch.from_numpy(st.copy()), jnp.asarray(st)
    logs = []
    for s0, s1 in [(0, 30), (30, 70), (70, n - 1)]:
        st_t, ut, vt = kernels.tb2bd_wavefront(st_t, kd, s0, s1)
        st_j, ut_j, vt_j = pk.tb2bd_wavefront(st_j, kd, s0, s1)
        np.testing.assert_allclose(st_t.numpy(), np.asarray(st_j), atol=1e-8,
                                   rtol=0)
        np.testing.assert_allclose(ut.numpy(), np.asarray(ut_j), atol=1e-8,
                                   rtol=0)
        np.testing.assert_allclose(vt.numpy(), np.asarray(vt_j), atol=1e-8,
                                   rtol=0)
        assert ut.shape[0] == min(s1, n - 2) - s0
        logs.append((ut, vt))
    np.testing.assert_array_equal(st_t.numpy(), whole.numpy())
    for k, full in ((0, uw), (1, vw)):
        parts = [lg[k] for lg in logs]
        w = max(p.shape[1] for p in parts)
        cat = torch.cat([torch.nn.functional.pad(p, (0, 0, 0, w - p.shape[1]))
                         for p in parts])
        np.testing.assert_array_equal(cat.numpy(), full.numpy())


@pytest.mark.parametrize("bad", ["kd3", "width", "complex", "strided"])
def test_tb2bd_wavefront_rejects_what_the_kernel_does_not_take(bad):
    kd = 3 if bad == "kd3" else 8
    st = torch.zeros((40, 3 * kd + (3 if bad == "width" else 2)),
                     dtype=torch.complex128 if bad == "complex"
                     else torch.float64)
    if bad == "strided":
        st = torch.zeros((80, 3 * kd + 2), dtype=torch.float64)[::2]
    with pytest.raises(ValueError):
        kernels.tb2bd_wavefront(st, kd)


# ---------------------------------------------------------------------------
# The host chases and bdsdc (slate_tpu_torch.native) against the JAX
# package's
# ---------------------------------------------------------------------------

def test_native_householder_chase_matches_jax_runtime():
    _need_native()
    n, kd = 200, 16
    st = _tb_band(n, kd, 3)
    for rng in (None, (10, 80)):
        a_j, a_t = st.copy(), st.copy()
        if rng is None:
            lj = jnative.tb2bd_hh_banded(a_j, n, kd)
            lt = tnative.tb2bd_hh_banded(a_t, n, kd)
        else:
            lj = jnative.tb2bd_hh_banded_range(a_j, n, kd, *rng)
            lt = tnative.tb2bd_hh_banded_range(a_t, n, kd, *rng)
        assert _rel(a_t, a_j) < 1e-11
        for log_t, log_j in zip(lt, lj):
            for x, y in zip(log_t[:2], log_j[:2]):
                assert _rel(x, y) < 1e-11
            for x, y in zip(log_t[2:], log_j[2:]):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
def test_native_givens_chase_matches_jax_runtime(dtype):
    _need_native()
    n, kd = 150, 12
    rng = np.random.default_rng(1)
    ab = np.zeros((n, kd + 3), dtype=dtype)
    for dd in range(kd + 1):
        ab[dd:, dd + 1] = _gaussian(rng, 1, n - dd, dtype)[0]
    a_j, a_t = ab.copy(), ab.copy()
    rj = jnative.tb2bd_banded(a_j, n, kd)
    rt = tnative.tb2bd_banded(a_t, n, kd)
    np.testing.assert_array_equal(a_t, a_j)
    for x3, y3 in zip(rt, rj):
        for x, y in zip(x3, y3):
            np.testing.assert_array_equal(x, y)
    z = _gaussian(np.random.default_rng(4), n, 5, dtype)
    for mode, rots in ((0, rj[0]), (1, rj[1])):
        np.testing.assert_array_equal(
            tnative.apply_rot_seq(z.copy(), *rots, mode, kd=kd),
            jnative.apply_rot_seq(z.copy(), *rots, mode, kd=kd))
    a_t = ab.copy()
    empty = tnative.tb2bd_banded(a_t, n, kd, want_rots=False)
    assert all(len(x) == 0 for x3 in empty for x in x3)
    np.testing.assert_array_equal(a_t, a_j)


@pytest.mark.parametrize("nthreads", [1, 4])
def test_native_bidiagonal_wavefront_is_the_serial_chase(nthreads,
                                                         monkeypatch):
    """The OpenMP wavefront of the bidiagonal Householder chase against
    its serial sweep order (``SLATE_TPU_TORCH_CHASE_SERIAL=1``): bitwise
    equal, band and both logs, at every thread count."""
    assert tnative.available(), tnative.build_error()
    n, kd = 300, 16
    st_s = _tb_band(n, kd, 0)
    st_w = st_s.copy()
    monkeypatch.setenv("SLATE_TPU_TORCH_CHASE_SERIAL", "1")
    ser = tnative.tb2bd_hh_banded_range(st_s, n, kd, 0, n - 1)
    monkeypatch.delenv("SLATE_TPU_TORCH_CHASE_SERIAL")
    prev = tnative.num_threads()
    tnative.set_num_threads(nthreads)
    try:
        wav = tnative.tb2bd_hh_banded(st_w, n, kd)
    finally:
        tnative.set_num_threads(prev)
    np.testing.assert_array_equal(st_w, st_s)
    for log_w, log_s in zip(wav, ser):
        for x, y in zip(log_w, log_s):
            np.testing.assert_array_equal(x, y)


def test_bdsdc_matches_jax():
    _need_native()
    rng = np.random.default_rng(12)
    d, e = rng.standard_normal(120), rng.standard_normal(119)
    for x, y in zip(tnative.bdsdc(d, e), jnative.bdsdc(d, e)):
        np.testing.assert_array_equal(x, y)
    u, s, vt = tnative.bdsdc(d, e)
    b = np.diag(d) + np.diag(e, 1)
    assert np.abs((u * s) @ vt - b).max() < 1e-13 * 120
    assert np.all(np.diff(s) <= 0)
    with pytest.raises(np.linalg.LinAlgError):
        tnative.bdsdc(np.array([1.0, np.nan, 2.0]), np.array([1.0, 1.0]))


# ---------------------------------------------------------------------------
# Stages 1, 2 and 3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,nb,dtype", [(40, 40, 8, np.float64),
                                          (56, 32, 8, np.float64),
                                          (40, 40, 8, np.complex128),
                                          (56, 32, 8, np.complex128),
                                          (64, 64, 16, np.float32)])
def test_ge2tb_and_unmbr_ge2tb_match_jax(m, n, nb, dtype):
    a = _gaussian(np.random.default_rng(42), m, n, dtype)
    fj = jsvd.ge2tb(jnp.asarray(a), {"block_size": nb})
    ft = tsvd.ge2tb(a, {"block_size": nb}, device="cpu")
    band = ft.band.numpy()
    assert [o for o, _, _ in ft.qpanels] == [o for o, _, _ in fj.qpanels]
    assert [o for o, _, _ in ft.ppanels] == [o for o, _, _ in fj.ppanels]
    mats = {}
    for side, k in ((Side.Left, m), (Side.Right, n)):
        eye = np.eye(k, dtype=dtype)
        mats[side] = (tsvd.unmbr_ge2tb(side, Op.NoTrans, ft,
                                       torch.from_numpy(eye)).numpy(),
                      np.asarray(jsvd.unmbr_ge2tb(
                          jst.Side(side.value), jst.Op.NoTrans, fj,
                          jnp.asarray(eye))))
    q, p = mats[Side.Left][0], mats[Side.Right][0]
    if dtype == np.float32:
        assert _rel(band, np.asarray(fj.band)) < 1e-4
        for side in mats:
            assert _rel(*mats[side]) < 1e-4
        assert _rel(q @ band @ p.T, a) < 1e-5
        return
    np.testing.assert_allclose(band, np.asarray(fj.band), atol=1e-10)
    for side in mats:
        np.testing.assert_allclose(*mats[side], atol=1e-10)
    i, j = np.indices(band.shape)
    assert np.abs(band[(j < i) | (j - i > nb)]).max() == 0
    assert np.abs(q @ band @ p.conj().T - a).max() < 1e-12 * m
    c = _gaussian(np.random.default_rng(1), m, 3, dtype)
    np.testing.assert_allclose(
        tsvd.unmbr_ge2tb(Side.Left, Op.ConjTrans, ft,
                         torch.from_numpy(c)).numpy(), q.conj().T @ c,
        atol=1e-10)


@pytest.mark.parametrize("route", ["native", "python"])
def test_tb2bd_and_unmbr_tb2bd_match_jax(route, monkeypatch):
    """The host Givens chase (compiled, and the Python schedule the port
    keeps for hosts without a compiler) against the JAX package's
    compiled one: the same (d, e), and B = U₂·bidiag(d, e)·V₂ᵀ through
    both back-transforms."""
    _need_native()
    n, kd = 30, 5
    b = _dense(_tb_band(n, kd, 21), kd)
    dj, ej, rj = jsvd.tb2bd(b, kd)
    if route == "python":
        monkeypatch.setattr(tnative, "available", lambda: False)
    d, e, rots = tsvd.tb2bd(torch.from_numpy(b), kd)
    np.testing.assert_allclose(np.abs(d), np.abs(dj), atol=1e-12)
    np.testing.assert_allclose(np.abs(e), np.abs(ej), atol=1e-12)
    eye = np.eye(n)
    u2 = tsvd.unmbr_tb2bd(Side.Left, rots, eye)
    v2 = tsvd.unmbr_tb2bd(Side.Right, rots, eye)
    bd = np.diag(d) + np.diag(e, 1)
    assert np.abs(u2 @ bd @ v2.T - b).max() < 1e-12 * n
    assert np.abs(u2.T @ u2 - eye).max() < 1e-13 * n
    if route == "native":
        for side, rots_j in ((Side.Left, rj), (Side.Right, rj)):
            np.testing.assert_allclose(
                tsvd.unmbr_tb2bd(side, rots, eye),
                jsvd.unmbr_tb2bd(jst.Side(side.value), rots_j, eye),
                atol=1e-12)


def test_bdsqr_matches_jax():
    rng = np.random.default_rng(3)
    d, e = rng.standard_normal(40), rng.standard_normal(39)
    ref = np.linalg.svd(np.diag(d) + np.diag(e, 1), compute_uv=False)
    s = tsvd.bdsqr(d, e)
    np.testing.assert_allclose(s, ref, atol=1e-12)
    np.testing.assert_allclose(s, jsvd.bdsqr(d, e), atol=1e-13)
    for method in (MethodSVD.Auto, MethodSVD.QR):
        u, s, vh = tsvd.bdsqr(d, e, want_uv=True, method=method)
        uj, sj, vhj = jsvd.bdsqr(d, e, want_uv=True,
                                 method=jst.MethodSVD(method.value))
        np.testing.assert_allclose(s, sj, atol=1e-13)
        np.testing.assert_allclose(u, uj, atol=1e-12)
        np.testing.assert_allclose(vh, vhj, atol=1e-12)


# ---------------------------------------------------------------------------
# The drivers
# ---------------------------------------------------------------------------

def _svd_gates(a, s, u, vh, tol):
    k = min(a.shape)
    sref = np.linalg.svd(a.astype(np.complex128), compute_uv=False)
    assert np.abs(s - sref).max() < tol * max(1, sref.max())
    assert np.abs((u * s[None, :]) @ vh - a).max() < tol * sref.max()
    assert np.abs(u.conj().T @ u - np.eye(k)).max() < tol
    assert np.abs(vh @ vh.conj().T - np.eye(k)).max() < tol


def _match_jax(s, u, vh, sj, uj, vhj, tol, vtol):
    np.testing.assert_allclose(s, sj, atol=tol * max(1, sj.max()))
    ua, ph = _align(u, uj)
    np.testing.assert_allclose(ua, uj, atol=vtol)
    np.testing.assert_allclose(vh * ph.conj()[:, None], vhj, atol=vtol)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
@pytest.mark.parametrize("m,n", [(40, 40), (56, 32), (32, 56)])
def test_svd_matches_jax(dtype, m, n):
    a = _gaussian(np.random.default_rng(9), m, n, dtype)
    s, u, vh = tst.svd(a, opts={"block_size": 8}, device="cpu")
    assert s.dtype == torch.float64 and u.dtype == vh.dtype
    assert u.shape == (m, min(m, n)) and vh.shape == (min(m, n), n)
    s, u, vh = s.numpy(), u.numpy(), vh.numpy()
    _svd_gates(a, s, u, vh, 1e-11)
    sj, uj, vhj = map(np.asarray, jst.svd(jnp.asarray(a),
                                          opts={"block_size": 8}))
    _match_jax(s, u, vh, sj, uj, vhj, 1e-11, 1e-9)
    g = tst.gesvd(a, False, True, {"block_size": 8}, device="cpu")
    assert g[1] is None and g[2].shape == (min(m, n), n)


def test_svd_vals_matches_jax():
    a = np.random.default_rng(13).standard_normal((48, 24))
    s = tst.svd_vals(a, {"block_size": 8}, device="cpu").numpy()
    np.testing.assert_allclose(s, np.linalg.svd(a, compute_uv=False),
                               atol=1e-11)
    np.testing.assert_allclose(
        s, np.asarray(jst.svd_vals(jnp.asarray(a), {"block_size": 8})),
        atol=1e-11)


def test_svd_float32_matches_jax():
    a = np.random.default_rng(17).standard_normal((36, 36)).astype(np.float32)
    s, u, vh = tst.svd(a, opts={"block_size": 8}, device="cpu")
    assert s.dtype == torch.float32 and u.dtype == torch.float32
    s, u, vh = s.numpy(), u.numpy(), vh.numpy()
    sref = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    assert np.abs(s - sref).max() < 1e-3
    assert np.abs((u * s[None, :]) @ vh - a).max() < 1e-3
    sj = np.asarray(jst.svd(jnp.asarray(a), opts={"block_size": 8})[0])
    np.testing.assert_allclose(s, sj, atol=1e-3)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_svd_kernel_route_matches_jax_pallas_route(dtype, monkeypatch):
    """The chase pinned to the kernel route (its plain version here)
    against the JAX package pinned to its Pallas chase; the kernel route
    moves no band or log bytes between host and device."""
    monkeypatch.setenv(FORCE, "chase=kernel")
    monkeypatch.setenv(JFORCE, "chase=pallas_wavefront")
    m, n, nb = 72, 64, 8
    a = _gaussian(np.random.default_rng(5), m, n, dtype)
    was_on = metrics.enabled()
    metrics.reset()
    metrics.on()
    try:
        s, u, vh = tst.svd(tst.Matrix.from_array(a, nb=nb, device="cpu"))
        snap = metrics.snapshot()
    finally:
        metrics.reset()
        if not was_on:
            metrics.off()
    counters = snap["counters"]
    assert counters.get("chase.dispatch.kernel", 0) == 1
    assert counters.get("chase.host_bytes") == 0.0
    assert "chase.tb2bd" in snap["timers"]
    assert all(k in snap["timers"] for k in ("stage.svd.stage1",
                                            "stage.svd.stage2",
                                            "stage.svd.stage3"))
    assert any(k.startswith("chase|tb2bd") and v == ("kernel", "forced")
               for k, v in tauto.decisions(with_reasons=True).items())
    s, u, vh = (x.numpy().astype(np.float64) for x in (s, u, vh))
    tol = 50 * n * _eps(dtype)
    _svd_gates(a.astype(np.float64), s, u, vh, tol)
    sj, uj, vhj = map(np.asarray, jst.svd(jnp.asarray(a),
                                          opts={"block_size": nb}))
    _match_jax(s, u, vh, sj, uj, vhj, tol, tol if dtype == np.float32
               else 1e-9)


@pytest.mark.parametrize("route", ["kernel", "host_native"])
def test_band_storage_entry_routes(route, monkeypatch):
    """``_band_svd_ab`` (the band-storage entry, ``(n, kd+3)`` host
    storage): the kernel route (one O(n·kd) upload counted as ingestion)
    and the host Givens route give the band's singular triplets; the host
    Householder route (``_band_svd_hh_ab``, taken on the card) as
    well."""
    monkeypatch.setenv(FORCE, "chase=" + route)
    n, kd = 50, 6
    st = _tb_band(n, kd, 13)
    b = _dense(st, kd)
    ab = np.zeros((n, kd + 3))
    for dd in range(kd + 1):
        ab[dd:, dd + 1] = st[:n - dd, kd + dd]
    sref = np.linalg.svd(b, compute_uv=False)
    was_on = metrics.enabled()
    metrics.reset()
    metrics.on()
    try:
        outs = [tsvd._band_svd_ab(ab.copy(), kd, True, True, MethodSVD.Auto,
                                  True, torch.device("cpu"))]
        snap = metrics.snapshot()["counters"]
        outs.append(tsvd._band_svd_hh_ab(st.copy(), kd, True, True,
                                         MethodSVD.Auto, True,
                                         torch.device("cpu")))
    finally:
        metrics.reset()
        if not was_on:
            metrics.off()
    for s, u, vh in outs:
        u, vh = np.asarray(torch.as_tensor(u)), np.asarray(torch.as_tensor(vh))
        np.testing.assert_allclose(s, sref, atol=1e-11 * sref.max())
        assert np.abs((u * s[None, :]) @ vh - b).max() < 1e-11 * sref.max()
    assert (snap.get("chase.ingest_bytes", 0) > 0) == (route == "kernel")


def test_qdwh_driver_is_not_ported(monkeypatch):
    """The QDWH driver is ported now (tests/test_torch_polar.py holds it
    against the JAX package): an ``svd_driver="qdwh"`` option or pin
    answers svd_qdwh's factors."""
    a = np.random.default_rng(1).standard_normal((16, 16))
    s0, u0, v0 = tst.svd_qdwh(a, opts={"qdwh_crossover": 4}, device="cpu")
    np.testing.assert_allclose(s0.numpy(), np.linalg.svd(a, compute_uv=False),
                               atol=1e-12)
    s, u, v = tst.svd(a, opts={"svd_driver": "qdwh", "qdwh_crossover": 4},
                      device="cpu")
    assert torch.equal(s, s0) and torch.equal(u, u0) and torch.equal(v, v0)
    monkeypatch.setenv(FORCE, "svd_driver=qdwh")
    s = tst.svd(a, opts={"qdwh_crossover": 4}, device="cpu")[0]
    assert torch.equal(s, s0)
    # an ineligible call site never reaches qdwh
    s = tst.svd(a, opts={"method_svd": MethodSVD.QR}, device="cpu")[0]
    np.testing.assert_allclose(s.numpy(), np.linalg.svd(a, compute_uv=False),
                               atol=1e-12)


def test_svd_driver_and_chase_sites_answer(monkeypatch):
    from slate_tpu_torch import config as tcfg

    f32 = torch.float32
    assert tauto.choose_svd_driver(64, 64, f32, "cpu", True) == "twostage"
    assert tauto.choose_svd_driver(64, 2, f32, "cpu", True) == "twostage"
    assert tauto.choose_chase("tb2bd", 64, 8, f32, "cuda", True) == "kernel"
    assert tauto.choose_chase("tb2bd", 64, 8, f32, "cpu", True) == \
        "host_native"
    assert tauto.choose_chase("tb2bd", 64, 8, torch.complex128, "cuda",
                              True) == "host_native"
    assert not _chase.eligible(64, 3, True)
    monkeypatch.setenv(FORCE, "svd_driver=qdwh,chase=kernel")
    assert tauto.choose_svd_driver(64, 64, f32, "cpu", True) == "qdwh"
    assert tauto.choose_svd_driver(64, 64, f32, "cpu", False) == "twostage"
    assert tauto.choose_chase("tb2bd", 64, 8, f32, "cpu", True) == "kernel"
    monkeypatch.setattr(tcfg, "use_kernels", False)
    assert tauto.choose_chase("tb2bd", 64, 8, f32, "cuda", True) == \
        "host_native"
    monkeypatch.setenv(FORCE, "svd_driver=jacobi")
    with pytest.warns(UserWarning, match="jacobi"):
        assert tauto.choose_svd_driver(64, 64, f32, "cpu", True) == "twostage"
    assert tauto.select("svd_driver", m=64, n=64, dtype=f32, device="cpu",
                        eligible=True) == "twostage"


def test_svd_drivers_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    a = np.random.default_rng(2).standard_normal((16, 12))
    for fn in (tst.svd, tst.svd_vals, tst.gesvd):
        with pytest.raises(tst.SlateError, match="no CUDA device"):
            fn(a)
