"""The rest of the port's core surface against the JAX package, on the
same numpy inputs made from seeds:

* ``symm``/``hemm`` (both sides, both uplos), ``syr2k``/``her2k`` (both
  uplos; the unstored triangle of C left as it was) and the
  data-placement variants ``gemmA``/``gemmC``, ``hemmA``/``hemmC``,
  ``trsmA``/``trsmB``, in fp32, fp64, complex64 and complex128 at n = 40
  with 32-tiles (off the block size): within 1e-12 relative in 64-bit
  and 1e-5 in 32-bit;
* the ``method.select_*`` heuristics over a grid of their arguments and
  the enums' members and values;
* ``sprint_matrix``'s text for the same fp64 matrix at verbose 0–4;
* ``debug.check_finite``'s list of tiles and the other debug checks;
* ``TrapezoidMatrix`` and its transposed view;
* ``testing.generate_matrix``: the deterministic kinds exactly, the
  random kinds by shape, dtype, Hermitian-ness and spectrum
  (``jax.random``'s bits are not reproducible in torch).

``redistribute`` and ``check_dist_layout`` on a 2×2 grid ride the gloo
spawn of ``tests/test_torch_dist_aux.py``.
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import slate_tpu as jst
from slate_tpu import debug as jdebug
from slate_tpu import enums as jenums
from slate_tpu import method as jmethod
from slate_tpu.printing import sprint_matrix as jsprint
from slate_tpu.testing.matgen import generate_matrix as jgenerate

import slate_tpu_torch as st
from slate_tpu_torch import debug, enums, method
from slate_tpu_torch.exceptions import SlateError
from slate_tpu_torch.testing import generate_matrix

N, K, NB = 40, 24, 32
DTYPES = [np.float32, np.float64, np.complex64, np.complex128]
TOL = {np.float32: 1e-5, np.complex64: 1e-5, np.float64: 1e-12,
       np.complex128: 1e-12}


def _draw(rng, dtype, *shape):
    x = rng.standard_normal(shape)
    if np.issubdtype(dtype, np.complexfloating):
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def _rel(x, ref):
    x, ref = np.asarray(x), np.asarray(ref)
    return float(np.linalg.norm(x.astype(ref.dtype) - ref)
                 / np.linalg.norm(ref))


def _data(x):
    return (x.data if hasattr(x, "data") else x)


def _port(x):
    return _data(x).detach().resolve_conj().numpy()


def _scalars(dtype):
    if np.issubdtype(dtype, np.complexfloating):
        return complex(0.75, -0.5), complex(-0.25, 0.5)
    return 0.75, -0.25


def _both(kind, cls_name, x, uplo=None):
    """``x`` wrapped as ``cls_name`` of each package (the port's on the
    CPU), uplo by name."""
    jcls, pcls = getattr(jst, cls_name), getattr(st, cls_name)
    if uplo is None:
        return (jcls.from_array(jnp.asarray(x), nb=NB),
                pcls.from_array(x, nb=NB, device="cpu"))
    return (jcls(jnp.asarray(x), uplo=getattr(jst.Uplo, uplo), nb=NB),
            pcls(x, uplo=getattr(st.Uplo, uplo), nb=NB, device="cpu"))


def _jax_all(calls):
    """The JAX package's results of ``calls`` (thunks) from one jitted
    program: eager JAX compiles each small op apart, which costs seconds."""
    return [np.asarray(_data(r)) for r in jax.jit(
        lambda: tuple(_data(c()) for c in calls))()]


SIDES_UPLOS = list(itertools.product(("Left", "Right"), ("Lower", "Upper")))


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_symm_hemm_match_jax(dtype):
    """symm and hemm at both sides and uplos; hemmA and hemmC at one."""
    rng = np.random.default_rng(11)
    a = _draw(rng, dtype, N, N)
    alpha, beta = _scalars(dtype)
    cases = [(name, side, uplo) for name in ("symm", "hemm")
             for side, uplo in SIDES_UPLOS] + [
        ("hemmA", "Left", "Upper"), ("hemmC", "Right", "Lower")]
    calls, ports = [], []
    for name, side, uplo in cases:
        shape = (N, 5) if side == "Left" else (5, N)
        b, c = _draw(rng, dtype, *shape), _draw(rng, dtype, *shape)
        cls = "SymmetricMatrix" if name == "symm" else "HermitianMatrix"
        ja, pa = _both("a", cls, a, uplo)
        calls.append(lambda name=name, side=side, ja=ja, b=b, c=c: getattr(
            jst, name)(getattr(jst.Side, side), alpha, ja, jnp.asarray(b),
                       beta, jnp.asarray(c)))
        ports.append(getattr(st, name)(getattr(st.Side, side), alpha, pa, b,
                                       beta, c))
    for case, got, want in zip(cases, ports, _jax_all(calls)):
        assert _rel(_port(got), want) <= TOL[dtype], case


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("name", ["syr2k", "her2k"])
def test_rank_2k_match_jax(name, dtype):
    rng = np.random.default_rng(12)
    a, b = _draw(rng, dtype, N, K), _draw(rng, dtype, N, K)
    c = _draw(rng, dtype, N, N)
    alpha, beta = _scalars(dtype)
    cls = "SymmetricMatrix" if name == "syr2k" else "HermitianMatrix"
    uplos = ("Lower", "Upper")
    mats = [_both("c", cls, c, uplo) for uplo in uplos]
    wants = _jax_all([lambda jc=jc: getattr(jst, name)(
        alpha, jnp.asarray(a), jnp.asarray(b), beta, jc) for jc, _ in mats])
    for uplo, (_, pc), want in zip(uplos, mats, wants):
        got = _port(getattr(st, name)(alpha, a, b, beta, pc))
        keep = np.tril(np.ones((N, N), bool)) if uplo == "Lower" \
            else np.triu(np.ones((N, N), bool))
        assert _rel(got[keep], want[keep]) <= TOL[dtype], uplo
        # the unstored triangle is C's, untouched
        assert np.array_equal(got[~keep], c[~keep]), uplo
        # the stored triangle is the update itself (numpy, fp64)
        a64, b64, c64 = (v.astype(np.complex128) for v in (a, b, c))
        conj = name == "her2k"
        bt = b64.conj().T if conj else b64.T
        at = a64.conj().T if conj else a64.T
        al2 = np.conj(alpha) if conj else alpha
        be = beta.real if conj and isinstance(beta, complex) else beta
        ref = alpha * a64 @ bt + al2 * b64 @ at + be * c64
        assert _rel(got[keep], ref[keep]) <= 10 * TOL[dtype], uplo


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_gemm_and_trsm_variants_match_jax(dtype):
    rng = np.random.default_rng(13)
    alpha, beta = _scalars(dtype)
    a, b, c = (_draw(rng, dtype, N, K), _draw(rng, dtype, K, 9),
               _draw(rng, dtype, N, 9))
    t = (_draw(rng, dtype, N, N) / N + 2 * np.eye(N)).astype(dtype)
    rhs = _draw(rng, dtype, N, 6)
    cases, calls, ports = [], [], []
    for name in ("gemm", "gemmA", "gemmC"):
        cases.append(name)
        calls.append(lambda name=name: getattr(jst, name)(
            alpha, jnp.asarray(a), jnp.asarray(b), beta, jnp.asarray(c)))
        ports.append(getattr(st, name)(alpha, a, b, beta, c, device="cpu"))
    for name, (side, uplo) in itertools.product(
            ("trsm", "trsmA", "trsmB"),
            (("Left", "Lower"), ("Right", "Upper"))):
        bb = rhs if side == "Left" else rhs.T.copy()
        jt, pt = _both("t", "TriangularMatrix", t, uplo)
        cases.append((name, side, uplo))
        calls.append(lambda name=name, side=side, jt=jt, bb=bb: getattr(
            jst, name)(getattr(jst.Side, side), alpha, jt, jnp.asarray(bb)))
        ports.append(getattr(st, name)(getattr(st.Side, side), alpha, pt, bb))
    for case, got, want in zip(cases, ports, _jax_all(calls)):
        assert _rel(_port(got), want) <= TOL[dtype], case


def test_variants_are_their_drivers():
    """gemmA/gemmC, hemmA/hemmC and trsmA/trsmB compute what gemm, hemm
    and trsm compute, bitwise (one card: one computation)."""
    rng = np.random.default_rng(14)
    a, b, c = (_draw(rng, np.float32, N, N) for _ in range(3))
    h = st.HermitianMatrix(a, uplo=st.Uplo.Lower, nb=NB, device="cpu")
    tri = st.TriangularMatrix(a + N * np.eye(N, dtype=np.float32),
                              uplo=st.Uplo.Lower, nb=NB, device="cpu")
    g = st.gemm(1.5, a, b, 0.5, c, device="cpu")
    for v in (st.gemmA, st.gemmC):
        assert torch.equal(v(1.5, a, b, 0.5, c, device="cpu"), g)
    hm = st.hemm(st.Side.Left, 1.5, h, b, 0.5, c)
    for v in (st.hemmA, st.hemmC):
        assert torch.equal(v(st.Side.Left, 1.5, h, b, 0.5, c), hm)
    ts = st.trsm(st.Side.Left, 1.5, tri, b)
    for v in (st.trsmA, st.trsmB):
        assert torch.equal(v(st.Side.Left, 1.5, tri, b), ts)


def test_rank_2k_refuses_an_op_view():
    rng = np.random.default_rng(15)
    a = _draw(rng, np.float64, N, K)
    c = st.HermitianMatrix(_draw(rng, np.float64, N, N), uplo=st.Uplo.Lower,
                           nb=NB, device="cpu").transpose()
    with pytest.raises(SlateError, match="NoTrans"):
        st.her2k(1.0, a, a, 1.0, c)


def test_trapezoid_matrix_matches_jax():
    """A rectangular TrapezoidMatrix and its transposed view: the logical
    uplo, shape and stored triangle as the JAX package's."""
    a = np.random.default_rng(18).standard_normal((7, 5))
    for uplo in ("Lower", "Upper"):
        jm = jst.TrapezoidMatrix(jnp.asarray(a), uplo=getattr(jst.Uplo, uplo),
                                 nb=4)
        pm = st.TrapezoidMatrix(a, uplo=getattr(st.Uplo, uplo), nb=4,
                                device="cpu")
        for j, p in ((jm, pm), (jm.transpose(), pm.transpose())):
            assert p.logical_uplo.name == j.logical_uplo.name
            assert (p.m, p.n) == (j.m, j.n)
            assert np.array_equal(p.tril_or_triu().numpy(),
                                  np.asarray(j.tril_or_triu()))


# ---------------------------------------------------------------------------
# Method selectors and enums
# ---------------------------------------------------------------------------

ENUMS = ["Layout", "TileKind", "MOSI", "MethodGemm", "MethodHemm",
         "MethodTrsm", "MethodCholQR", "MethodEig", "MethodSVD",
         "MethodGels", "MethodLU", "GridOrder", "Target"]


@pytest.mark.parametrize("name", ENUMS)
def test_enum_members_match_jax(name):
    ours, theirs = getattr(enums, name), getattr(jenums, name)
    assert {m.name: m.value for m in ours} == \
        {m.name: m.value for m in theirs}


def _same(got, want):
    return (got.name, got.value) == (want.name, want.value)


@pytest.mark.parametrize("sel,enum,args", [
    ("select_gemm", "MethodGemm", [(b_nt,) for b_nt in (0, 1, 2, 7)]),
    ("select_trsm", "MethodTrsm", [(b_nt,) for b_nt in (0, 1, 2, 7)]),
    ("select_hemm", "MethodHemm", [(b_nt,) for b_nt in (0, 1, 2, 7)]),
    ("select_cholqr", "MethodCholQR",
     [(m, n) for m in (1, 63, 64, 65, 300) for n in (1, 32, 64)]),
    ("select_eig", "MethodEig",
     [(n, v) for n in (1, 100) for v in (False, True)]),
    ("select_svd", "MethodSVD",
     [(m, n, v) for m in (5, 90) for n in (5, 40) for v in (False, True)]),
])
def test_selectors_match_jax(sel, enum, args):
    ours, theirs = getattr(method, sel), getattr(jmethod, sel)
    for member in getattr(enums, enum):
        jmember = getattr(getattr(jenums, enum), member.name)
        for a in args:
            assert _same(ours(member, *a), theirs(jmember, *a)), (member, a)


# ---------------------------------------------------------------------------
# Printing and debug
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("verbose", [0, 1, 2, 3, 4])
def test_sprint_matrix_text_equals_jax(verbose):
    rng = np.random.default_rng(16)
    a = rng.standard_normal((9, 8))
    pairs = [(jst.Matrix.from_array(jnp.asarray(a), mb=3, nb=2),
              st.Matrix.from_array(a, mb=3, nb=2, device="cpu")),
             (jnp.asarray(a), torch.from_numpy(a)),
             (a, a),
             (jst.HermitianMatrix(jnp.asarray(a[:8] + 1j * a[1:]),
                                  uplo=jst.Uplo.Lower, mb=4, nb=4),
              st.HermitianMatrix(a[:8] + 1j * a[1:], uplo=st.Uplo.Lower,
                                 mb=4, nb=4, device="cpu"))]
    for ja, pa in pairs:
        want = jsprint("A", ja, verbose=verbose, edgeitems=2)
        assert st.sprint_matrix("A", pa, verbose=verbose,
                                edgeitems=2) == want
    import io
    buf = io.StringIO()
    st.print_matrix("B", a, verbose=verbose, file=buf)
    assert buf.getvalue() == jsprint("B", a, verbose=verbose)


def test_check_finite_lists_the_same_tiles():
    a = np.random.default_rng(17).standard_normal((100, 70))
    debug.check_finite(a, nb=32)
    a[5, 40] = np.nan
    a[99, 0] = np.inf
    a[70, 69] = -np.inf
    msgs = []
    for fn, x in ((jdebug.check_finite, jnp.asarray(a)),
                  (debug.check_finite, st.Matrix.from_array(
                      a, nb=32, device="cpu"))):
        with pytest.raises(Exception) as e:
            fn(x, nb=32, name="A")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert "[(0, 1), (2, 2), (3, 0)]" in msgs[1]


def test_pool_leaks_and_memory_stats():
    class Pool:
        num_allocated, num_free = 5, 5

    debug.check_pool_leaks(Pool())
    Pool.num_free = 3
    with pytest.raises(SlateError, match="2 block"):
        debug.check_pool_leaks(Pool())
    assert debug.device_memory_stats() == []       # no card here
    stats = debug.memory_stats()
    assert stats["devices"] == [] and "available" in stats


def test_check_dist_layout_serial_stub():
    mesh = st.parallel.make_grid_mesh(1, 1, device="cpu")
    dm = st.parallel.distribute(np.ones((50, 30)), mesh, 16)
    debug.check_dist_layout(dm)
    bad = st.parallel.DistMatrix(dm.data[:40], 50, 30, 16, mesh)
    with pytest.raises(SlateError, match="multiple of the tile"):
        debug.check_dist_layout(bad)
    short = st.parallel.DistMatrix(dm.data[:48], 50, 30, 16, mesh)
    with pytest.raises(SlateError, match="exceed padded storage"):
        debug.check_dist_layout(short)
    moved = st.redistribute(dm, nb=32)
    debug.check_dist_layout(moved)
    assert moved.nb == 32 and torch.equal(
        st.parallel.undistribute(moved), torch.ones((50, 30),
                                                    dtype=torch.float64))


# ---------------------------------------------------------------------------
# generate_matrix
# ---------------------------------------------------------------------------

GEN_DTYPES = [(torch.float64, jnp.float64), (torch.complex128, jnp.complex128),
              (torch.float32, jnp.float32)]


@pytest.mark.parametrize("dt", GEN_DTYPES, ids=lambda d: str(d[0])[6:])
@pytest.mark.parametrize("kind", ["zeros", "ones", "identity", "jordan"])
def test_generate_deterministic_kinds_exact(kind, dt):
    for m, n in ((7, 7), (7, 4), (4, 7)):
        got = generate_matrix(kind, m, n, dtype=dt[0], device="cpu")
        want = np.asarray(jgenerate(kind, m, n, dtype=dt[1]))
        assert got.dtype == dt[0] and got.shape == (m, n)
        assert np.array_equal(got.numpy(), want), (m, n)


@pytest.mark.parametrize("dt", GEN_DTYPES[:2], ids=lambda d: str(d[0])[6:])
def test_generate_random_kinds(dt):
    tdt = dt[0]
    cplx = tdt.is_complex
    for kind in ("rand", "rands", "randn", "rand_dominant"):
        a = generate_matrix(kind, 30, 20, dtype=tdt, seed=3, device="cpu")
        assert a.shape == (30, 20) and a.dtype == tdt
        assert torch.equal(a, generate_matrix(kind, 30, 20, dtype=tdt,
                                              seed=3, device="cpu"))
        re = a.real
        if kind == "rand":
            assert float(re.min()) >= 0 and float(re.max()) < 1
        if kind == "rands":
            assert float(re.min()) >= -1 and float(re.max()) < 1
        if kind == "rand_dominant":
            assert float((re.diagonal() - 60).abs().max()) <= 1
        if cplx:
            assert float(a.imag.abs().max()) > 0
    for kind in ("svd", "svd:arith", "cond:cluster1", "heev", "poev",
                 "poev:rgeo"):
        base, _, spec = kind.partition(":")
        m, n = (30, 20) if base in ("svd", "cond") else (24, 24)
        a = generate_matrix(kind, m, n, dtype=tdt, seed=4, cond=1e3,
                            device="cpu")
        assert a.shape == (m, n) and a.dtype == tdt
        from slate_tpu_torch.testing.matgen import _spectrum
        want = np.sort(_spectrum(spec, min(m, n), 1e3))
        if base in ("heev", "poev"):
            assert torch.equal(a, a.mH)
            w = np.sort(torch.linalg.eigvalsh(a).numpy())
            if base == "heev":
                signs = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
                want = np.sort(_spectrum(spec, n, 1e3) * signs)
            assert np.abs(w - want).max() <= 1e-10
        else:
            s = np.sort(torch.linalg.svdvals(a).numpy())
            assert np.abs(s - want).max() <= 1e-10
    s = generate_matrix("svd", 12, 9, dtype=tdt, sigma=np.arange(1, 10.0),
                        device="cpu")
    assert np.abs(np.sort(torch.linalg.svdvals(s).numpy())
                  - np.arange(1, 10.0)).max() <= 1e-10
    with pytest.raises(ValueError, match="unknown matrix kind"):
        generate_matrix("nope", 3, device="cpu")
    with pytest.raises(ValueError, match="unknown spectrum"):
        generate_matrix("svd:nope", 3, device="cpu")
