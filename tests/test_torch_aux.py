"""The port's tile kernels (``ops.kernels.tile_norms``, ``tzset``,
``tzscale``, ``geadd``, ``gescale_row_col``), ``ops/tile_ops.py``,
``linalg/norms.py``, ``util.py``, ``condest.py`` and ``band.py`` against
the JAX package on the same numpy inputs made from a seed.

On the CPU each kernel wrapper runs its plain version; the JAX package's
Pallas kernels run in interpret mode, as ``tests/test_pallas.py`` runs
them.  Tolerances: tzset, tzscale, gescale_row_col and the max-norm
partials are exact on both sides (each product rounded once, in the same
order), so they are held bitwise; geadd to 2ε·(|α·a| + |β·b|) (XLA on the
CPU contracts it into an FMA, the port rounds each product); a sum of squares is held to 1e-12
relative in fp64 and 1e-6 in fp32 (only the summation order differs);
the tile_ops, norms and util functions in fp64 to 1e-13 relative; the
condition estimates to 1e-12 relative in fp64 (the same host iteration
over solves that round differently); band solves to 1e-10 relative and
the reference tester's scaled residual ≤ 3.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import slate_tpu as jst
from slate_tpu.linalg import band as jband
from slate_tpu.linalg import util as jutil
from slate_tpu.ops import pallas_kernels as pk
from slate_tpu.ops import tile_ops as jto
import slate_tpu_torch as tst
from slate_tpu_torch import interop
from slate_tpu_torch.linalg import band as tband
from slate_tpu_torch.linalg import util as tutil
from slate_tpu_torch.ops import kernels
from slate_tpu_torch.ops import tile_ops as tto

DT = {"f32": np.float32, "f64": np.float64}


def _rng(seed):
    return np.random.default_rng(seed)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rel(x, ref):
    x, ref = np.asarray(x, np.complex128), np.asarray(ref, np.complex128)
    return np.linalg.norm(x - ref) / np.linalg.norm(ref)


# ---------------------------------------------------------------------------
# The four kernels' plain versions against the interpreted Pallas kernels
# ---------------------------------------------------------------------------

KERNEL_CASES = [
    (op, dt, lower, shape)
    for op in ("tzset", "tzscale")
    for dt in ("f32", "f64")
    for lower in (True, False)
    for shape in ((256, 256), (384, 640))
] + [
    (op, dt, None, shape)
    for op in ("geadd", "gescale_row_col")
    for dt in ("f32", "f64")
    for shape in ((256, 256), (384, 640))
] + [
    ("tile_norms_" + norm, dt, None, (4, 64, 128))
    for norm in ("max", "fro") for dt in ("f32", "f64")
]


@pytest.mark.parametrize("op, dt, lower, shape", KERNEL_CASES)
def test_tile_kernel_plain_matches_pallas(op, dt, lower, shape):
    rng = _rng(sum(shape))
    x = rng.standard_normal(shape).astype(DT[dt])
    y = rng.standard_normal(shape).astype(DT[dt])
    if op in ("tzset", "tzscale"):
        ref = getattr(pk, op)(jnp.asarray(x), lower, -0.75, 2.5, bm=128,
                              bn=128)
        got = getattr(kernels, op)(_t(x), lower, -0.75, 2.5, bm=128, bn=128)
    elif op == "geadd":
        ref = pk.geadd(1.5, jnp.asarray(x), -0.3, jnp.asarray(y), bm=128,
                       bn=128)
        got = kernels.geadd(1.5, _t(x), -0.3, _t(y), bm=128, bn=128)
        # XLA on the CPU contracts α·a + β·b into fma(α, a, β·b); the plain
        # version (and the CUDA kernel) rounds α·a first: one rounding of
        # the two terms apart
        eps = np.finfo(DT[dt]).eps
        bound = 2 * eps * (np.abs(1.5 * x) + np.abs(0.3 * y))
        assert got.numpy().dtype == np.asarray(ref).dtype
        assert np.all(np.abs(got.numpy() - np.asarray(ref)) <= bound)
        return
    elif op == "gescale_row_col":
        r = rng.standard_normal(shape[0]).astype(DT[dt])
        c = rng.standard_normal(shape[1]).astype(DT[dt])
        ref = pk.gescale_row_col(jnp.asarray(r), jnp.asarray(c),
                                 jnp.asarray(x), bm=128, bn=128)
        got = kernels.gescale_row_col(_t(r), _t(c), _t(x), bm=128, bn=128)
    else:
        norm = op.split("_")[-1]
        ref = pk.tile_norms(jnp.asarray(x), norm)
        got = kernels.tile_norms(_t(x), norm)
        if norm == "fro":
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=1e-12 if dt == "f64" else 1e-6)
            return
    assert got.numpy().dtype == np.asarray(ref).dtype == DT[dt]
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_tz_keeps_the_other_triangle_on_wide_and_tall_shapes():
    """The diagonal ends at min(m, n); the triangle the op does not store
    is copied.  The tile ops' tzset zeroes it instead (by design)."""
    for shape in ((384, 640), (640, 384)):
        x = _rng(5).standard_normal(shape)
        i, j = np.indices(shape)
        for lower in (True, False):
            s = kernels.tzset(_t(x), lower, 0.5, 2.0, bm=128, bn=128).numpy()
            tri = (i > j) if lower else (i < j)
            assert np.all(s[i == j] == 2.0) and np.all(s[tri] == 0.5)
            assert np.array_equal(s[~tri & (i != j)], x[~tri & (i != j)])
            z = tto.tzset(shape, tst.Uplo.Lower if lower else tst.Uplo.Upper,
                          0.5, 2.0, torch.float64).numpy()
            assert np.all(z[~tri & (i != j)] == 0)


def test_tile_kernel_nan_cases_match_pallas():
    x = _rng(6).standard_normal((4, 64, 128))
    x[2, 5, 7] = np.nan
    for norm in ("max", "fro"):
        ref = np.asarray(pk.tile_norms(jnp.asarray(x), norm))
        got = kernels.tile_norms(_t(x), norm).numpy()
        assert np.array_equal(np.isnan(got), np.isnan(ref))
        assert np.isnan(got[2]) and not np.isnan(got).sum() - 1
    a = _rng(7).standard_normal((256, 256))
    b = _rng(8).standard_normal((256, 256))
    b[3, 4] = np.nan
    b[9, 1] = np.inf
    ref = np.asarray(pk.geadd(2.0, jnp.asarray(a), 0.0, jnp.asarray(b),
                              bm=128, bn=128))
    got = kernels.geadd(2.0, _t(a), 0.0, _t(b), bm=128, bn=128).numpy()
    # β = 0 still reads B: 0·NaN and 0·Inf are NaN on both sides; 2·a is
    # exact, so the rest agrees bitwise
    assert np.isnan(got[3, 4]) and np.isnan(got[9, 1])
    np.testing.assert_array_equal(got, ref)


def test_tile_norms_complex128_matches_pallas():
    rng = _rng(9)
    x = rng.standard_normal((3, 32, 64)) + 1j * rng.standard_normal(
        (3, 32, 64))
    for norm in ("max", "fro"):
        ref = np.asarray(pk.tile_norms(jnp.asarray(x), norm))
        got = kernels.tile_norms(_t(x), norm)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12)


@pytest.mark.parametrize("call", [
    lambda a: kernels.tzset(a, True, 0.0, 1.0, bm=256, bn=128),
    lambda a: kernels.tzscale(a, False, 2.0, 1.0, bm=128, bn=256),
    lambda a: kernels.geadd(1.0, a, 1.0, a, bm=256),
    lambda a: kernels.gescale_row_col(a[:, 0], a[0], a, bn=256),
])
def test_tile_kernels_refuse_what_the_pallas_grid_refuses(call):
    """(384, 640) splits into neither 256-row nor 256-column tiles."""
    with pytest.raises(ValueError):
        call(torch.zeros((384, 640)))


def test_tile_kernel_launch_checks():
    """What a CUDA launch refuses, checked before it: complex (the TPU
    kernels are real) is a TypeError naming the kernel, a strided tensor
    or mixed dtypes a ValueError; there is no hidden copy."""
    z = torch.zeros((4, 4), dtype=torch.complex128)
    with pytest.raises(TypeError, match="geadd"):
        kernels._tile_dt("geadd", z, z)
    with pytest.raises(ValueError, match="contiguous"):
        kernels._tile_dt("tzset", torch.zeros((4, 8)).T)
    with pytest.raises(ValueError):
        kernels._tile_dt("geadd", torch.zeros(4), torch.zeros(4).double())
    assert kernels._tile_dt("tile_norms", torch.zeros((2, 4, 4))) == "f32"


# ---------------------------------------------------------------------------
# ops/tile_ops.py
# ---------------------------------------------------------------------------

class _Side:
    """One package's tile_ops with numpy arguments converted for it, and
    its enums and dtypes under shared names."""

    def __init__(self, mod, conv, enums, dtypes):
        self.mod, self.conv = mod, conv
        self.Uplo, self.Norm = enums.Uplo, enums.Norm
        self.f32, self.f64, self.c64 = dtypes

    def __getattr__(self, name):
        fn = getattr(self.mod, name)

        def call(*args, **kw):
            return fn(*[self.conv(x) if isinstance(x, np.ndarray) else x
                        for x in args], **kw)
        return call

    def norms(self):
        return [self.Norm.Max, self.Norm.One, self.Norm.Inf, self.Norm.Fro]


JAX_SIDE = _Side(jto, jnp.asarray, jst, (np.float32, np.float64,
                                         np.complex64))
TORCH_SIDE = _Side(tto, _t, tst, (torch.float32, torch.float64,
                                  torch.complex64))

TILE_OPS = {
    "geset": lambda m, a, b: m.geset((2, 24, 16), 0.5, 3.0, m.f64),
    "tzset": lambda m, a, b: m.tzset((24, 16), m.Uplo.Upper, 0.5, 3.0,
                                     m.f64),
    "geadd": lambda m, a, b: m.geadd(2.0, a.real.copy(), -1.0, b),
    "tzadd": lambda m, a, b: m.tzadd(m.Uplo.Lower, 2.0, a.real.copy(), -1.0,
                                     b),
    "gecopy": lambda m, a, b: m.gecopy(a, m.c64),
    "tzcopy": lambda m, a, b: m.tzcopy(m.Uplo.Upper, a.real.copy(), b,
                                       m.f32),
    "gescale": lambda m, a, b: m.gescale(3.0, 7.0, a),
    "gescale_row_col": lambda m, a, b: m.gescale_row_col(
        b[:, :, 0].copy(), b[:, 0, :].copy(), a),
    "transpose": lambda m, a, b: m.transpose(a, conj=True),
    "genorm": lambda m, a, b: [m.genorm(w, a) for w in m.norms()],
    "trnorm": lambda m, a, b: [m.trnorm(w, m.Uplo.Lower, a, True)
                               for w in m.norms()],
    "synorm": lambda m, a, b: [m.synorm(w, m.Uplo.Upper, a[:, :16].copy())
                               for w in m.norms()],
    "henorm": lambda m, a, b: [m.henorm(w, m.Uplo.Lower, a[:, :16].copy())
                               for w in m.norms()],
}


@pytest.mark.parametrize("name", list(TILE_OPS))
def test_tile_ops_match_jax(name):
    rng = _rng(10)
    a = rng.standard_normal((2, 24, 16)) + 1j * rng.standard_normal(
        (2, 24, 16))
    b = rng.standard_normal((2, 24, 16))
    ref = TILE_OPS[name](JAX_SIDE, a, b)
    got = TILE_OPS[name](TORCH_SIDE, a, b)
    for r, g in zip(ref if isinstance(ref, list) else [ref],
                    got if isinstance(got, list) else [got]):
        r, g = np.asarray(r), g.resolve_conj().numpy()
        assert g.shape == r.shape and g.dtype == r.dtype
        np.testing.assert_allclose(g, r, rtol=1e-13, atol=1e-13)


# ---------------------------------------------------------------------------
# linalg/norms.py
# ---------------------------------------------------------------------------

def _pair(kind, data, **kw):
    """The same matrix in both packages: (JAX object, port object)."""
    jkw = {k: getattr(jst.Uplo if k == "uplo" else jst.Diag, v.name)
           if k in ("uplo", "diag") else v for k, v in kw.items()}
    jm = getattr(jst, kind)(jnp.asarray(data), **jkw)
    tm = interop.matrix_from_numpy(kind, data, device="cpu",
                                   **{k: v for k, v in kw.items()})
    return jm, tm


NORM_KINDS = [
    ("Matrix", {}),
    ("SymmetricMatrix", {"uplo": tst.Uplo.Lower}),
    ("HermitianMatrix", {"uplo": tst.Uplo.Upper}),
    ("TriangularMatrix", {"uplo": tst.Uplo.Lower, "diag": tst.Diag.Unit}),
    ("BandMatrix", {"kl": 3, "ku": 5}),
    ("TriangularBandMatrix", {"kd": 4, "uplo": tst.Uplo.Upper,
                              "diag": tst.Diag.Unit}),
    ("HermitianBandMatrix", {"kd": 6, "uplo": tst.Uplo.Lower}),
]


@pytest.mark.parametrize("kind, kw", NORM_KINDS,
                         ids=[k for k, _ in NORM_KINDS])
def test_norms_match_jax(kind, kw):
    rng = _rng(11)
    n = 40
    a = rng.standard_normal((n, n))
    if kind.startswith("Hermitian"):
        a = a + 1j * rng.standard_normal((n, n))
    jm, tm = _pair(kind, a, **kw)
    back = interop.matrix_to_numpy(tm)
    assert back["kind"] == kind and np.array_equal(back["data"], a)
    assert all(back[k] == getattr(jm, k) for k in ("kl", "ku", "kd")
               if hasattr(jm, k))
    for jn, tn in zip((jst.Norm.Max, jst.Norm.One, jst.Norm.Inf,
                       jst.Norm.Fro),
                      (tst.Norm.Max, tst.Norm.One, tst.Norm.Inf,
                       tst.Norm.Fro)):
        ref = float(jst.norm(jn, jm))
        got = tst.norm(tn, tm)
        assert got.dtype == torch.float64 and got.ndim == 0
        np.testing.assert_allclose(float(got), ref, rtol=1e-13)
    np.testing.assert_allclose(
        tst.col_norms(tst.Norm.Max, tm).numpy(),
        np.asarray(jst.col_norms(jst.Norm.Max, jm)), rtol=1e-13)
    for alias in ("genorm", "synorm", "henorm", "trnorm", "gbnorm",
                  "hbnorm"):
        assert float(getattr(tst, alias)(tst.Norm.One, tm)) \
            == float(tst.norm(tst.Norm.One, tm))


def test_fro_norm_no_overflow_and_col_norms_refuse_other_norms():
    a = np.full((4, 4), 1e30)
    got = float(tst.norm(tst.Norm.Fro, tst.Matrix.from_array(a,
                                                             device="cpu")))
    ref = float(jst.norm(jst.Norm.Fro, jst.Matrix.from_array(jnp.asarray(a))))
    assert got == ref and np.isclose(got, 4e30, rtol=1e-15)
    with pytest.raises(ValueError):
        tst.col_norms(tst.Norm.One, _t(a), device="cpu")


# ---------------------------------------------------------------------------
# linalg/util.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["Matrix", "TriangularMatrix"])
def test_util_matches_jax(kind):
    rng = _rng(12)
    a = rng.standard_normal((30, 30))
    b = rng.standard_normal((30, 30))
    kw = {} if kind == "Matrix" else {"uplo": tst.Uplo.Lower}
    ja, ta = _pair(kind, a, **kw)
    jb, tb = _pair(kind, b, **kw)
    r = rng.standard_normal(30)
    c = rng.standard_normal(30)
    pairs = [
        (jutil.add(2.0, ja, 0.5, jb), tutil.add(2.0, ta, 0.5, tb)),
        (jutil.copy(ja, jnp.float32), tutil.copy(ta, torch.float32)),
        (jutil.scale(3.0, 2.0, ja), tutil.scale(3.0, 2.0, ta)),
        (jutil.scale_row_col(r, c, ja), tutil.scale_row_col(r, c, ta)),
        (jutil.set(0.25, 4.0, ja), tutil.set(0.25, 4.0, ta)),
    ]
    for ref, got in pairs:
        assert type(got).__name__ == type(ref).__name__ == kind
        np.testing.assert_allclose(got.data.numpy(), np.asarray(ref.data),
                                   rtol=1e-13, atol=1e-15)


# ---------------------------------------------------------------------------
# linalg/condest.py
# ---------------------------------------------------------------------------

def test_condest_matches_jax():
    rng = _rng(13)
    n = 96
    a = rng.standard_normal((n, n)) + 4 * np.eye(n)
    jlu_, jperm = jst.getrf(jnp.asarray(a))
    tlu_, tperm = tst.getrf(_t(a), device="cpu")
    anorm = float(np.abs(a).sum(axis=0).max())
    ref = jst.gecondest(jst.Norm.One, jlu_, jperm, anorm)
    got = tst.gecondest(tst.Norm.One, tlu_, tperm, anorm, device="cpu")
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    true_rc = 1.0 / (anorm * np.linalg.norm(np.linalg.inv(a), 1))
    assert 0 < got <= 30 * true_rc             # tester.py's gate

    g = rng.standard_normal((n, n))
    spd = g @ g.T + n * np.eye(n)
    jf = jst.potrf(jst.HermitianMatrix(jnp.asarray(spd), uplo=jst.Uplo.Lower,
                                       nb=32))
    tf = tst.potrf(tst.HermitianMatrix(spd, uplo=tst.Uplo.Lower, nb=32,
                                       device="cpu"))
    sn = float(np.abs(spd).sum(axis=0).max())
    np.testing.assert_allclose(tst.pocondest(tst.Norm.One, tf, sn),
                               jst.pocondest(jst.Norm.One, jf, sn),
                               rtol=1e-12)

    t = np.tril(rng.standard_normal((n, n))) + 2 * n * np.eye(n)
    np.testing.assert_allclose(
        tst.trcondest(tst.Norm.One, _t(t), tst.Uplo.Lower, device="cpu"),
        jst.trcondest(jst.Norm.One, jnp.asarray(t), jst.Uplo.Lower),
        rtol=1e-12)

    ref = jst.refine_kappa_eps(lambda v: jst.getrs(jlu_, jperm, v),
                               lambda v: jst.getrs(jlu_, jperm, v,
                                                   op=jst.Op.ConjTrans),
                               n, anorm, np.float64)
    got = tst.refine_kappa_eps(
        lambda v: tst.getrs(tlu_, tperm, v, device="cpu"),
        lambda v: tst.getrs(tlu_, tperm, v, op=tst.Op.ConjTrans,
                            device="cpu"),
        n, anorm, torch.float64)
    np.testing.assert_allclose(got, ref, rtol=1e-12)

    w = rng.standard_normal((64, 40))
    np.testing.assert_allclose(
        tst.spectral_interval(_t(w), {"block_size": 16}, device="cpu"),
        jst.spectral_interval(jnp.asarray(w), {"block_size": 16}),
        rtol=1e-12)


# ---------------------------------------------------------------------------
# linalg/band.py
# ---------------------------------------------------------------------------

def _banded(n, kl, ku, seed, dominant=True):
    a = _rng(seed).standard_normal((n, n))
    i, j = np.indices((n, n))
    a = np.where((j - i <= ku) & (i - j <= kl), a, 0.0)
    return a + (kl + ku + 2) * np.eye(n) if dominant else a


def _resid(a, x, b):
    eps = np.finfo(np.float64).eps
    return np.linalg.norm(a @ x - b) / (np.linalg.norm(a) * np.linalg.norm(x)
                                        * eps * a.shape[0])


def test_band_solvers_match_jax():
    n, kd = 160, 12
    rng = _rng(14)
    b = rng.standard_normal((n, 3))
    s = _banded(n, kd, kd, 15)
    spd = s @ s.T                           # bandwidth 2·kd
    jm, tm = _pair("HermitianBandMatrix", spd, kd=2 * kd,
                   uplo=tst.Uplo.Lower, nb=32)
    jf, jx = jband.pbsv(jm, jnp.asarray(b))
    tf, tx = tband.pbsv(tm, _t(b))
    assert type(tf).__name__ == "TriangularBandMatrix" and tf.kd == 2 * kd
    assert _rel(tf.data.numpy(), np.asarray(jf.data)) <= 1e-10
    assert _rel(tx.numpy(), np.asarray(jx)) <= 1e-10
    assert _resid(spd, tx.numpy(), b) <= 3

    g = _banded(n, 5, 9, 16)
    jm, tm = _pair("BandMatrix", g, kl=5, ku=9, nb=32)
    jf, jp, jx = jband.gbsv(jm, jnp.asarray(b))
    tf, tp, tx = tband.gbsv(tm, _t(b))
    assert (tf.kl, tf.ku) == (5, 14)
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    assert _rel(tx.numpy(), np.asarray(jx)) <= 1e-10
    assert _resid(g, tx.numpy(), b) <= 3

    c = rng.standard_normal((n, 3))
    np.testing.assert_allclose(
        tband.gbmm(2.0, tm, _t(b), -1.0, _t(c)).numpy(),
        np.asarray(jband.gbmm(2.0, jm, jnp.asarray(b), -1.0,
                              jnp.asarray(c))), rtol=1e-12, atol=1e-12)
    jh, th = _pair("HermitianBandMatrix", _banded(n, 7, 0, 17, False), kd=7,
                   uplo=tst.Uplo.Lower)
    for jside, tside, bb, cc in ((jst.Side.Left, tst.Side.Left, b, c),
                                 (jst.Side.Right, tst.Side.Right, b.T, c.T)):
        np.testing.assert_allclose(
            tband.hbmm(tside, 0.5, th, _t(bb), 2.0, _t(cc)).numpy(),
            np.asarray(jband.hbmm(jside, 0.5, jh, jnp.asarray(bb), 2.0,
                                  jnp.asarray(cc))), rtol=1e-12, atol=1e-12)

    tri = _banded(n, 0, 6, 18)
    jt, tt = _pair("TriangularBandMatrix", tri, kd=6, uplo=tst.Uplo.Upper,
                   nb=32)
    perm = rng.permutation(n)
    for piv in (None, perm):
        ref = jband.tbsm(jst.Side.Left, 2.0, jt, jnp.asarray(b),
                         None if piv is None else jnp.asarray(piv))
        got = tband.tbsm(tst.Side.Left, 2.0, tt, _t(b),
                         None if piv is None else _t(piv))
        assert _rel(got.numpy(), np.asarray(ref)) <= 1e-12
    got = tband.tbsm(tst.Side.Left, 1.0, tt.transpose(), _t(b))
    ref = jband.tbsm(jst.Side.Left, 1.0, jt.transpose(), jnp.asarray(b))
    assert _rel(got.numpy(), np.asarray(ref)) <= 1e-12
