"""The port's split-precision products and what rides on them, against
the JAX package on the same numpy inputs made from seeds:

* ``ops/split_gemm.py``: the bf16 slices bit for bit, and bf16x3 / bf16x6
  (the ``split_matmul`` kernel's plain version here) within the JAX tests'
  componentwise envelope to the fp64 product (``tests/test_split_gemm.py``:
  4·(2⁷ + 3k)·ε₃₂·|A||B| for split3, 4·3k·ε₃₂·|A||B| for split6), as the
  JAX package's products are, within 4·√k·ε₃₂·|A||B| of the JAX
  package's products, and bf16x6 within 8·ε₃₂·|A||B| of the exact
  product, which bf16x3 does not reach;
* ``ops/ozaki.py``: the int8 slices and the power-of-two exponents equal
  (integers, not results), and ``matmul_f64`` (the ``ozaki_matmul``
  kernel's plain version) on ``tests/test_ozaki.py``'s cases within
  1e-12 of |A||B| componentwise of the exact product and of the JAX
  package's answer;
* the fp64 Cholesky's Newton panels (``blocks.potrf_panels_f64``) against
  the JAX package's (its Pallas ``chol_inv_panel`` in interpret mode):
  the reference's ``_potrf_guard`` ≤ 30 and the factors within 1e-12;
  the stock rerun where the fp32 seed breaks down, and ``posv`` fp64
  under ``f64_mxu``;
* the ``matmul`` site's split answers on the fp32 drivers, the mixed
  drivers' split leg (``posv_mixed``, ``gels_mixed`` against the JAX
  package's own forced leg within 1e-12; ``gesv_mixed`` against numpy,
  since the JAX package's forced LU leg calls itself without end), the
  safe backend, and ``pposv``'s split trailing product on a spawned 1×2
  gloo world against the JAX package on a 1×2 mesh.

Inputs are cast to fp32 explicitly where the JAX side wants fp32: the
reference's ``tests/conftest.py`` turns x64 on.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import slate_tpu as jst
from slate_tpu import config as jcfg
from slate_tpu.ops import blocks as jblocks
from slate_tpu.ops import ozaki as jozaki
from slate_tpu.ops import split_gemm as jsplit
from slate_tpu.parallel import dist_factor as jfactor
from slate_tpu.perf import autotune as jauto

import slate_tpu_torch as tst
from slate_tpu_torch import config as tcfg
from slate_tpu_torch.linalg import _refine as trefine
from slate_tpu_torch.linalg import lu as tlu
from slate_tpu_torch.ops import blocks as tblocks
from slate_tpu_torch.ops import kernels
from slate_tpu_torch.ops import ozaki as tozaki
from slate_tpu_torch.ops import split_gemm as tsplit
from slate_tpu_torch.perf import autotune as tauto
from slate_tpu_torch.perf import metrics as tmetrics
from slate_tpu_torch.resilience import health

EPS32 = float(np.finfo(np.float32).eps)
EPS64 = float(np.finfo(np.float64).eps)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rel(x, ref):
    return np.linalg.norm(np.asarray(x, np.float64) - ref) \
        / np.linalg.norm(ref)


def _resid(a, x, b, eps):
    x = np.asarray(x, np.float64)
    return np.linalg.norm(a @ x - b) / (np.linalg.norm(a) * np.linalg.norm(x)
                                        * eps * a.shape[0])


def _spd(n, seed):
    g = np.random.default_rng(seed).standard_normal((n, n))
    return (g + g.T) / 2 + n * np.eye(n)         # tester.py's herm(n)


# ---------------------------------------------------------------------------
# ops/split_gemm.py
# ---------------------------------------------------------------------------

def test_split_slices_equal_jax_bit_for_bit():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((96, 80))
         * np.exp2(rng.integers(-20, 20, (96, 80)))).astype(np.float32)
    got = tsplit.split_slices(_t(x))
    ref = jsplit.split_slices(jnp.asarray(x))
    assert len(got) == len(ref) == tsplit.NSLICES
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(r.astype(jnp.float32)))


def _envelope(grade, k):
    return 4 * ((2 ** 7 + 3 * k) if grade == "split3" else 3 * k) * EPS32


def _accumulation(k):
    """Two fp32 sums of the same exact slice products in different
    orders: componentwise within 4·√k·ε₃₂ of |A||B|."""
    return 4 * np.sqrt(k) * EPS32


@pytest.mark.parametrize("grade", ["split3", "split6"])
@pytest.mark.parametrize("m, k, n", [(64, 64, 64), (96, 256, 64),
                                     (100, 130, 70)])
def test_split_products_match_jax_in_the_envelope(grade, m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    mag = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    fn = "matmul_" + grade
    got = getattr(tsplit, fn)(_t(a), _t(b))
    ref = np.asarray(getattr(jsplit, fn)(jnp.asarray(a), jnp.asarray(b)),
                     np.float64)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    env = _envelope(grade, k)
    err = (np.abs(got.double().numpy() - exact) / mag).max()
    assert err <= env
    assert (np.abs(ref - exact) / mag).max() <= env
    # both sum the same exact slice products in fp32, so they agree to the
    # fp32 accumulation, far inside the envelope
    assert (np.abs(got.double().numpy() - ref) / mag).max() \
        <= _accumulation(k)
    # six passes keep every bit of the fp32 operands: within 8 ε₃₂ of
    # |A||B|, which three passes do not reach
    assert err <= 8 * EPS32 if grade == "split6" else err > 8 * EPS32
    # a transposed view of B's planes gives the same product
    sa, sb = tsplit.split_slices(_t(a)), tsplit.split_slices(_t(b.T.copy()))
    tv = kernels.split_matmul(sa, tuple(s.mT for s in sb), grade)
    np.testing.assert_array_equal(tv.numpy(), got.numpy())
    with pytest.raises(TypeError):
        getattr(tsplit, fn)(_t(a).double(), _t(b).double())
    with pytest.raises(ValueError):
        getattr(tsplit, fn)(_t(a)[None], _t(b))


# ---------------------------------------------------------------------------
# ops/ozaki.py
# ---------------------------------------------------------------------------

def test_ozaki_slices_and_exponents_equal_jax():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((40, 70)) * np.exp2(
        rng.integers(-300, 300, (40, 1)).astype(np.float64))
    a[5] = 0.0
    a[7] = 2.0 ** np.arange(70) / 2 ** 40          # exact powers of two
    ax = np.abs(a).max(axis=1)
    e_t = tozaki._pow2_scale(_t(ax))
    e_j = np.asarray(jozaki._pow2_scale(jnp.asarray(ax)))
    np.testing.assert_array_equal(e_t.numpy(), e_j)
    # the scaling is exact: a·2^−e to the bit (XLA's CPU exp2 is not
    # exact at these exponents, so the JAX package's scaled rows are not
    # compared; the slices of one scaled operand are)
    r = tozaki._mul_pow2(_t(a), -e_t[:, None])
    np.testing.assert_array_equal(
        r.numpy(), np.ldexp(a, -e_j.astype(np.int64)[:, None]))
    assert np.all(np.abs(r.numpy()).max(axis=1)[ax > 0] < 1.0)
    assert np.all(np.abs(r.numpy()).max(axis=1)[ax > 0] >= 0.25)
    got = tozaki._split_int8(r)
    ref = jozaki._split_int8(jnp.asarray(r.numpy()))
    assert len(got) == len(ref) == tozaki._NSL
    for g, s in zip(got, ref):
        assert g.dtype == torch.int8
        np.testing.assert_array_equal(g.numpy(), np.asarray(s))
    assert (tozaki._W, tozaki._NSL, tozaki._SMAX, tozaki._KMAX) == (
        jozaki._W, jozaki._NSL, jozaki._SMAX, jozaki._KMAX)


def _ozaki_case(name):
    rng = np.random.default_rng(1234)
    if name == "gaussian":
        return rng.standard_normal((70, 90)), rng.standard_normal((90, 50))
    if name == "wide_range_zero_rows":
        m, k, n = 24, 40, 16
        a = rng.standard_normal((m, k)) * np.exp2(
            rng.integers(-180, 180, size=(m, 1)).astype(np.float64))
        b = rng.standard_normal((k, n)) * np.exp2(
            rng.integers(-180, 180, size=(1, n)).astype(np.float64))
        a[3, :] = 0.0
        b[:, 5] = 0.0
        return a, b
    if name == "powers_of_two":
        return np.full((32, 32), 0.5), np.eye(32)
    if name == "extreme_scales":
        return np.full((4, 4), 2.0 ** 1023), np.full((4, 4), 2.0 ** -1000)
    k = (1 << 16) * 3 + 17                       # past _KMAX: chunked
    a = np.full((2, k), 1 - 2 ** -24)
    a[1, ::3] = -0.75
    return a, a.T.copy()


@pytest.mark.parametrize("case", ["gaussian", "wide_range_zero_rows",
                                  "powers_of_two", "extreme_scales",
                                  "past_kmax"])
def test_matmul_f64_matches_jax(case):
    a, b = _ozaki_case(case)
    got = tozaki.matmul_f64(_t(a), _t(b)).numpy()
    ref = np.asarray(jozaki.matmul_f64(jnp.asarray(a), jnp.asarray(b)))
    exact = a @ b
    mag = np.maximum(np.abs(a) @ np.abs(b), 1e-300)
    assert got.dtype == np.float64 and np.isfinite(got).all()
    assert (np.abs(got - exact) / mag).max() < 1e-12
    assert (np.abs(got - ref) / mag).max() < 1e-12
    if case == "wide_range_zero_rows":
        assert np.all(got[3, :] == 0.0) and np.all(got[:, 5] == 0.0)
    if case == "powers_of_two":
        np.testing.assert_array_equal(got, a)
    with pytest.raises(TypeError):
        tozaki.matmul_f64(_t(a).float(), _t(b).float())


_NINE_SLICES = """
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import json
import numpy as np, torch, jax.numpy as jnp
from slate_tpu.ops import ozaki as jozaki
from slate_tpu_torch.ops import ozaki as tozaki
consts = (tozaki._NSL, tozaki._SMAX, tozaki._KMAX)
assert consts == (jozaki._NSL, jozaki._SMAX, jozaki._KMAX) == (9, 8, 32768)
rng = np.random.default_rng(1234)
a, b = rng.standard_normal((70, 90)), rng.standard_normal((90, 50))
r = tozaki._mul_pow2(torch.from_numpy(a), -tozaki._pow2_scale(
    torch.from_numpy(np.abs(a).max(axis=1)))[:, None])
got, ref = tozaki._split_int8(r), jozaki._split_int8(jnp.asarray(r.numpy()))
assert len(got) == len(ref) == 9
for g, s in zip(got, ref):
    np.testing.assert_array_equal(g.numpy(), np.asarray(s))
k = 3 * tozaki._KMAX + 17                      # past the 9-slice _KMAX
c = np.full((2, k), 1 - 2 ** -24)
c[1, ::3] = -0.75
errs = []
for x, y in ((a, b), (c, c.T.copy())):
    out = tozaki.matmul_f64(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    jout = np.asarray(jozaki.matmul_f64(jnp.asarray(x), jnp.asarray(y)))
    mag = np.abs(x) @ np.abs(y)
    errs.append([float((np.abs(out - x @ y) / mag).max()),
                 float((np.abs(out - jout) / mag).max())])
print(json.dumps(errs))
"""


def test_nine_slices_match_jax():
    """``SLATE_TPU_TORCH_F64_SLICES=9`` beside the JAX package's
    ``SLATE_TPU_F64_SLICES=9``, in a fresh process (both read the knob at
    import): the constants, the nine int8 planes bit for bit, and
    ``matmul_f64`` (45 pairs in the ``ozaki_matmul`` kernel's plain
    version, the 9-slice ``_KMAX`` chunking) against the
    exact product and the JAX package's.  Nine slices keep the full 53
    bits: the Gaussian case's error is under 1e-14 of |A||B|, which the
    default eight slices (~1e-13) do not reach."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, SLATE_TPU_F64_SLICES="9",
               SLATE_TPU_TORCH_F64_SLICES="9", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = subprocess.run([sys.executable, "-c", _NINE_SLICES], cwd=root,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    import json

    (g_exact, g_jax), (k_exact, k_jax) = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert g_exact < 1e-14 and g_jax < 1e-14
    assert k_exact < 1e-12 and k_jax < 1e-12


# ---------------------------------------------------------------------------
# The fp64 Cholesky's Newton panels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n, nb", [(256, 64), (300, 64)])
def test_potrf_panels_f64_matches_jax(n, nb):
    a = _spd(n, 31)
    got = tblocks.potrf_panels_f64(_t(a), nb).numpy()
    ref = np.asarray(jblocks.potrf_panels_f64(jnp.asarray(a), nb))
    assert jauto._potrf_guard(jnp.asarray(a), jnp.asarray(got), 30.0)
    assert jauto._potrf_guard(jnp.asarray(a), jnp.asarray(ref), 30.0)
    assert _rel(got, ref) <= 1e-12
    assert _rel(got, np.linalg.cholesky(a)) <= 1e-12
    assert np.array_equal(np.triu(got, 1), np.zeros((n, n)))


@pytest.fixture
def counters(monkeypatch):
    saved = tmetrics.enabled()
    tmetrics.on()
    tmetrics.reset()
    yield lambda: tmetrics.snapshot()["counters"]
    tmetrics.reset()
    if not saved:
        tmetrics.off()


def test_potrf_f64_reruns_stock_where_the_fp32_seed_breaks(monkeypatch,
                                                           counters):
    """SPD in fp64, eigenvalues spread over 1e-10 … 1, so its fp32 image
    is not positive definite: the Newton panels' seed gives NaN and the
    driver reruns ``torch.linalg.cholesky``, counted once."""
    n = 512                         # nb 256: one 512-wide Newton panel
    q, _ = np.linalg.qr(np.random.default_rng(32).standard_normal((n, n)))
    a = (q * np.geomspace(1.0, 1e-10, n)) @ q.T
    a = (a + a.T) / 2
    assert np.linalg.eigvalsh(a.astype(np.float32).astype(np.float64)).min() \
        < 0
    monkeypatch.setenv(tauto.FORCE_ENV, "potrf_panel_f64=ozaki_newton")
    fac = tst.potrf(tst.HermitianMatrix(a, uplo=tst.Uplo.Lower, nb=256,
                                        device="cpu"))
    assert counters().get("potrf.f64_rerun") == 1
    np.testing.assert_array_equal(fac.array.numpy(),
                                  torch.linalg.cholesky(_t(a)).numpy())
    assert any(k.startswith("potrf_panel_f64|") and v == "ozaki_newton"
               for k, v in tauto.decisions().items())


def test_posv_f64_under_f64_mxu(monkeypatch, counters):
    monkeypatch.setattr(tcfg, "f64_mxu", True)
    n = 1024                      # nb 256: two 512-wide Newton panels
    a = _spd(n, 33)
    b = np.random.default_rng(34).standard_normal((n, 3))
    fac, x = tst.posv(tst.HermitianMatrix(a, uplo=tst.Uplo.Lower, nb=256,
                                          device="cpu"), _t(b))
    assert _resid(a, x.numpy(), b, EPS64) <= 3
    assert _rel(fac.array.numpy(), np.linalg.cholesky(a)) <= 1e-11
    dec = tauto.decisions()
    assert dec["potrf_panel_f64|%d,512,float64,cpu" % n] == "ozaki_newton"
    assert "ozaki" in {v for k, v in dec.items() if k.startswith("matmul|")
                       and "float64" in k}
    assert not counters().get("potrf.f64_rerun")


# ---------------------------------------------------------------------------
# The matmul site's split answers on the fp32 drivers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pin", ["knob", "split6"])
def test_forced_split_on_the_fp32_drivers(monkeypatch, pin):
    if pin == "knob":
        monkeypatch.setattr(tcfg, "split_gemm", True)
        want = "split3"
    else:
        monkeypatch.setenv(tauto.FORCE_ENV, "matmul=split6")
        want = "split6"
    n, nb = 200, 64                      # ragged: the split takes any shape
    rng = np.random.default_rng(35)
    g = (rng.standard_normal((n, n)) + n * np.eye(n)).astype(np.float32)
    h = _spd(n, 36).astype(np.float32)
    b = rng.standard_normal((n, 2)).astype(np.float32)
    _, _, x = tst.gesv(tst.Matrix.from_array(_t(g), nb=nb, device="cpu"),
                       _t(b))
    assert _resid(g.astype(np.float64), x.numpy(), b, EPS32) <= 3
    _, x = tst.posv(tst.HermitianMatrix(_t(h), uplo=tst.Uplo.Lower, nb=nb,
                                        device="cpu"), _t(b))
    assert _resid(h.astype(np.float64), x.numpy(), b, EPS32) <= 3
    hits = {v for k, v in tauto.decisions().items()
            if k.startswith("matmul|") and "float32" in k}
    assert want in hits
    # fp64 and complex products stay stock under either
    assert tauto.choose_matmul((128, 128), (128, 128), torch.float64,
                               "cpu") == "stock"
    assert tauto.choose_matmul((128, 128), (128, 128), torch.complex64,
                               "cpu") == "stock"


# ---------------------------------------------------------------------------
# The mixed drivers' split leg
# ---------------------------------------------------------------------------

@pytest.fixture
def split_both(monkeypatch):
    """The split leg forced in both packages."""
    monkeypatch.setattr(tcfg, "split_gemm", True)
    monkeypatch.setattr(jcfg, "split_gemm", True)
    jauto.reset_table()
    yield
    jauto.reset_table()


@pytest.mark.parametrize("driver", ["posv_mixed", "gels_mixed"])
def test_split_leg_matches_jax(split_both, counters, driver):
    rng = np.random.default_rng(37)
    if driver == "posv_mixed":
        n = 192
        a = _spd(n, 38)
        b = rng.standard_normal((n, 3))
        ja = jst.HermitianMatrix(jnp.asarray(a), uplo=jst.Uplo.Lower, nb=64)
        ta = tst.HermitianMatrix(a, uplo=tst.Uplo.Lower, nb=64, device="cpu")
    else:
        # tall enough that κ₁(R)²·n·ε₃₂ stays under the demotion gate
        a = rng.standard_normal((512, 64))
        b = rng.standard_normal((512, 2))
        ja = jst.Matrix.from_array(jnp.asarray(a), nb=32)
        ta = tst.Matrix.from_array(a, nb=32, device="cpu")
    rx, ri = getattr(jst, driver)(ja, jnp.asarray(b))
    gx, gi = getattr(tst, driver)(ta, _t(b))
    assert int(ri) >= 0 and gi >= 0
    assert _rel(gx.numpy(), np.asarray(rx)) <= 1e-12
    c = counters()
    assert c.get("mixed.%s.split_leg" % driver) == 1
    assert not c.get("mixed.%s.split_demoted" % driver)


@pytest.mark.parametrize("cond", [None, 1e7])
def test_gesv_mixed_split_leg_factors_once(monkeypatch, counters, cond):
    """The forced split leg factors ``getrf_rec`` once (twice where the
    κ·ε probe demotes it, condition 1e7), against numpy fp64."""
    monkeypatch.setattr(tcfg, "split_gemm", True)
    n = 160
    rng = np.random.default_rng(39)
    if cond is None:
        a = rng.standard_normal((n, n)) + n * np.eye(n)
    else:
        u, _ = np.linalg.qr(rng.standard_normal((n, n)))
        v, _ = np.linalg.qr(rng.standard_normal((n, n)))
        a = (u * np.geomspace(1.0, 1.0 / cond, n)) @ v.T
    b = rng.standard_normal((n, 2))
    calls = []
    real = tlu.getrf_rec

    def counted(x, nb, *args, **kw):
        if x.shape == (n, n):
            calls.append(x.dtype)
        return real(x, nb, *args, **kw)

    monkeypatch.setattr(tlu, "getrf_rec", counted)
    x, iters = tst.gesv_mixed(tst.Matrix.from_array(a, nb=64, device="cpu"),
                              _t(b))
    demoted = counters().get("mixed.gesv_mixed.split_demoted", 0)
    assert calls[:1 + int(demoted)] == [torch.float32] * (1 + int(demoted))
    assert len([d for d in calls if d == torch.float32]) == 1 + int(demoted)
    assert demoted == (0 if cond is None else 1)
    assert _resid(a, x.numpy(), b, EPS64) <= 3
    if cond is None:
        assert iters >= 0
        assert _rel(x.numpy(), np.linalg.solve(a, b)) <= 1e-12


def test_split_leg_tri_state(monkeypatch):
    f32 = torch.float32
    monkeypatch.setattr(tcfg, "split_gemm", "auto")
    assert trefine.use_split_leg(f32, "cuda") is True
    assert trefine.use_split_leg(f32, "cpu") is False
    assert trefine.use_split_leg(torch.float64, "cuda") is False
    monkeypatch.setattr(tcfg, "split_gemm", False)
    assert trefine.use_split_leg(f32, "cuda") is False
    monkeypatch.setattr(tcfg, "split_gemm", True)
    assert trefine.use_split_leg(f32, "cpu") is True
    monkeypatch.setattr(tcfg, "split_gemm", "auto")
    before = dict(tauto.decisions())
    with trefine.split_factor_leg():
        assert tcfg.split_gemm == "auto"         # thread-local, no global
        assert tauto.choose_matmul((100, 30), (30, 7), f32, "cpu") == "split3"
    # the forced leg's resolutions stay out of the census
    assert tcfg.split_gemm == "auto" and tauto.decisions() == before
    monkeypatch.setattr(tcfg, "use_kernels", False)
    assert trefine.use_split_leg(f32, "cuda") is False


def test_split_leg_is_thread_local_beside_safe_backend(monkeypatch):
    """A split leg in one thread and the safe backend in another: the leg
    keeps split3 in its own thread only, the serve thread's safe backend
    restores what it found, and neither scope leaves a knob changed or
    hides another thread's census entries."""
    import threading

    f32 = torch.float32
    monkeypatch.setattr(tcfg, "split_gemm", "auto")
    monkeypatch.setattr(tcfg, "f64_mxu", "auto")
    in_leg, safe_done, leg_may_exit = (threading.Event() for _ in range(3))
    seen = {}

    def leg():
        with trefine.split_factor_leg():
            seen["leg_in"] = tauto.choose_matmul((100, 30), (30, 7), f32,
                                                 "cpu")
            in_leg.set()
            leg_may_exit.wait(30)
            # the safe backend came and went in the other thread
            seen["leg_after"] = tauto.choose_matmul((100, 30), (30, 7), f32,
                                                    "cpu")

    def safe():
        in_leg.wait(30)
        with health.safe_backend():
            seen["safe"] = tauto.choose_matmul((128, 128), (128, 128), f32,
                                               "cpu")
        safe_done.set()

    threads = [threading.Thread(target=leg), threading.Thread(target=safe)]
    for t in threads:
        t.start()
    assert in_leg.wait(30)
    # this thread is outside the leg: the default answer, recorded
    assert tauto.choose_matmul((256, 128), (128, 384), f32, "cpu") == "plain"
    assert tauto.decisions()["matmul|256,128,384,float32,cpu"] == "plain"
    assert safe_done.wait(30)
    leg_may_exit.set()
    for t in threads:
        t.join(30)
    assert seen == {"leg_in": "split3", "safe": "stock",
                    "leg_after": "split3"}
    assert tcfg.split_gemm == "auto" and tcfg.f64_mxu == "auto"
    assert tauto.choose_matmul((128, 128), (128, 128), f32, "cpu") == "plain"


def test_safe_backend_pins_both_knobs_off(monkeypatch):
    monkeypatch.setattr(tcfg, "split_gemm", True)
    monkeypatch.setattr(tcfg, "f64_mxu", True)
    before = dict(tauto.decisions())
    with health.safe_backend():
        assert tcfg.split_gemm is False and tcfg.f64_mxu is False
        assert tauto.choose_matmul((128, 128), (128, 128), torch.float32,
                                   "cpu") == "stock"
        assert tauto.choose_matmul((128, 128), (128, 128), torch.float64,
                                   "cpu") == "stock"
        assert tauto.choose_potrf_panel_f64(1024, 512, "cpu") == "stock"
    assert tcfg.split_gemm is True and tcfg.f64_mxu is True
    assert tauto.decisions() == before


# ---------------------------------------------------------------------------
# pposv's split trailing product on a 1×2 gloo world
# ---------------------------------------------------------------------------

def test_pposv_forced_split_matches_jax(monkeypatch):
    from slate_tpu.parallel import pposv as jpposv, undistribute as jundist
    from slate_tpu.parallel.mesh import make_grid_mesh as jmesh
    from slate_tpu_torch.parallel.launch import run_spmd

    n, nb = 192, 32
    a = _spd(n, 40).astype(np.float32)
    b = np.random.default_rng(41).standard_normal((n, 2)).astype(np.float32)
    out = run_spmd("slate_tpu_torch.parallel.launch:rank_drivers", 1, 2,
                   (a, a, b, nb), backend="gloo", device="cpu",
                   env={tauto.FORCE_ENV: "matmul=split3"}, timeout=300)
    saved = jfactor.shard_map
    jfactor.shard_map = functools.partial(jax.shard_map, check_vma=False)
    monkeypatch.setattr(jcfg, "split_gemm", True)
    jauto.reset_table()
    try:
        jfactor._build_ppotrf.cache_clear()
        lj, _ = jpposv(a, b, jmesh(1, 2, devices=np.asarray(
            jax.devices()[:2])), nb=nb)
        lj = np.tril(np.asarray(jundist(lj), np.float64))
    finally:
        jfactor.shard_map = saved
        jfactor._build_ppotrf.cache_clear()
        jauto.reset_table()
    exact = np.linalg.cholesky(a.astype(np.float64))
    for rank in out:
        assert "split3" in rank["matmul"]
        assert _rel(rank["l"], lj) <= 1e-4
        assert _rel(rank["l"], exact) <= 1e-4
        assert _resid(a.astype(np.float64), rank["x_po"], b, EPS32) <= 3
        np.testing.assert_array_equal(rank["l"], out[0]["l"])
