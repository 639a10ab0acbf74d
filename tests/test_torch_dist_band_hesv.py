"""The port's distributed band solvers and multiplies
(``slate_tpu_torch.parallel`` ``ppbtrf``/``ppbsv``, ``pgbtrf``/``pgbsv``,
``pgbmm``, ``phbmm``, ``ptbsm``) and its Hermitian-indefinite drivers
(``phetrf``, ``phetrs``, ``phesv``) against the JAX package's, on the same
numpy inputs made from seeds.

* One 2×2 gloo spawn of CPU processes runs
  :func:`~slate_tpu_torch.parallel.launch.rank_band_hesv` for every case,
  and a 1×2 spawn runs the complex128 cases at once (p ≠ q: the mixed
  row and column maps of phetrf's re-hermitization), while the JAX
  drivers run on a 2×2 mesh of the virtual CPU devices in this process.
* Sizes: the odd n = 90 at nb = 16 (padded tiles), bandwidths kd = ku = 5,
  kl = 3; phetrf's six panels of a symmetric Gaussian take pivots from
  inside the panel's window and from the trailing matrix.  Dtypes fp64,
  complex128 and fp32.
* Gates: the pivots (pgbtrf's window row orders, phetrf's ipiv) equal the
  JAX package's; factors, stacks and solutions within 1e-10 relative
  (fp64, complex128) and 1e-4 (fp32) of the JAX package's; the solves'
  residuals within the JAX tests' 1e-12 (fp64, complex128); every rank's
  replicated results bitwise equal; phetrf's swaps one collective a
  column on both grids.
* The serial stub (1×1, no process group) in process: phetrf against the
  single-device blocked Aasen (:func:`slate_tpu_torch.linalg.hesv.
  _hetrf_blocked`), and the refusals.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from slate_tpu.parallel.mesh import make_grid_mesh as jmake_grid_mesh

from slate_tpu_torch import parallel as tpar
from slate_tpu_torch.parallel import dist_band as tband
from slate_tpu_torch.parallel.launch import run_spmd

N, NB, KD, KL = 90, 16, 5, 3
LAUNCH = "slate_tpu_torch.parallel.launch"
TOL = {np.float32: 1e-4, np.float64: 1e-10, np.complex128: 1e-10}
DTYPES = list(TOL)
#: the spawns and the dtypes each runs
GRIDS = {(2, 2): DTYPES, (1, 2): [np.complex128]}
CASES = [(grid, dt) for grid, dts in GRIDS.items() for dt in dts]


def _draw(rng, shape, dtype):
    x = rng.standard_normal(shape)
    if np.issubdtype(dtype, np.complexfloating):
        x = x + 1j * rng.standard_normal(shape)
    return x


def _band_inputs(dtype):
    """spd (Hermitian, bandwidth KD, diagonally dominant), gen (lower KL,
    upper KD, pivoting), tri (lower triangular, bandwidth KD), b and c (N×3), α, β
    and a row order of B, from seed 41."""
    rng = np.random.default_rng(41)
    d = np.subtract.outer(np.arange(N), np.arange(N))       # i − j
    g = np.where(np.abs(d) <= KD, _draw(rng, (N, N), dtype), 0)
    spd = (g + g.conj().T) / 2 + N * np.eye(N)
    gen = np.where((d <= KL) & (d >= -KD), _draw(rng, (N, N), dtype), 0) \
        + np.eye(N)
    tri = np.where((d >= 0) & (d <= KD), _draw(rng, (N, N), dtype), 0) \
        + 2 * N * np.eye(N)
    cplx = np.issubdtype(dtype, np.complexfloating)
    return {"spd": spd.astype(dtype), "gen": gen.astype(dtype),
            "tri": tri.astype(dtype), "b": _draw(rng, (N, 3), dtype)
            .astype(dtype), "c": _draw(rng, (N, 3), dtype).astype(dtype),
            "alpha": complex(0.75, -0.5) if cplx else 2.0,
            "beta": complex(-0.25, 0.5) if cplx else -0.5,
            "pivots": rng.permutation(N), "kd": KD, "kl": KL, "ku": KD}


def _hesv_inputs(dtype):
    """A symmetric (Hermitian) Gaussian, indefinite, and b (N×2), from
    seed 43."""
    rng = np.random.default_rng(43)
    g = _draw(rng, (N, N), dtype)
    return {"a": ((g + g.conj().T) / 2).astype(dtype),
            "b": _draw(rng, (N, 2), dtype).astype(dtype)}


def _jobs(dtypes):
    jobs = []
    for dt in dtypes:
        jobs.append((LAUNCH + ":rank_band_hesv",
                     (dict(_band_inputs(dt), op="band", nb=NB),)))
        jobs.append((LAUNCH + ":rank_band_hesv",
                     (dict(_hesv_inputs(dt), op="hesv", nb=NB),)))
    return jobs


def _jax_band(mesh, inp):
    from slate_tpu.enums import Diag as JD, Op as JO, Side as JS, Uplo as JU
    from slate_tpu.parallel import (distribute, pgbmm, pgbsv, phbmm, ppbsv,
                                    ptbsm, undistribute)
    from slate_tpu.parallel.dist_band import pgbtrf, ppbtrf

    def dist(x, **kw):
        return distribute(jnp.asarray(x), mesh, NB, **kw)

    def und(x):
        return np.asarray(undistribute(x))

    sq = dict(row_mult=2, col_mult=2)
    spd, gen = dist(inp["spd"], **sq), dist(inp["gen"], **sq)
    b, c = dist(inp["b"], row_mult=2), dist(inp["c"], row_mult=2)
    out = {}
    # the upper band's factor is the lower band's: A is stored whole and
    # Hermitian, so the port's upper stacks are held to these too
    out["pbtrf_lower"] = out["pbtrf_upper"] = tuple(
        np.asarray(t) for t in ppbtrf(spd, KD))
    out["pbsv"] = und(ppbsv(spd, KD, b))
    out["gbtrf"] = tuple(np.asarray(t) for t in pgbtrf(gen, KL, KD))
    out["gbsv"] = und(pgbsv(gen, KL, KD, b))
    out["gbmm"] = und(pgbmm(inp["alpha"], gen, KL, KD, b, inp["beta"], c))
    out["hbmm"] = und(phbmm(inp["alpha"], dist(np.tril(inp["spd"]), **sq),
                            KD, b))
    tri = dist(inp["tri"], diag_pad=1.0, **sq)
    args = (JS.Left, JU.Lower, JO.NoTrans, JD.NonUnit, tri, KD)
    out["tbsm"] = und(ptbsm(*args, b))
    out["tbsm_pivots"] = und(ptbsm(*args, b, pivots=inp["pivots"]))
    return out


def _jax_hesv(mesh, inp):
    from slate_tpu.parallel import undistribute
    from slate_tpu.parallel.dist_hesv import phetrf, phetrs

    l, d, e, ipiv = phetrf(jnp.asarray(inp["a"]), mesh, NB)
    x = phetrs(l, d, e, ipiv, inp["b"])
    # the JAX package's phesv is this phetrf and phetrs
    # (slate_tpu/parallel/dist_hesv.py:355-362; its phetrf would compile
    # again): the port's phesv is held to the same x
    return {"l": np.asarray(undistribute(l)), "d": np.asarray(d),
            "e": np.asarray(e), "ipiv": np.asarray(ipiv),
            "x_trs": np.asarray(x), "x": np.asarray(x)}


@pytest.fixture(scope="module")
def runs():
    """The 2×2 and 1×2 spawns (in threads) while the JAX drivers run on
    the 2×2 mesh here."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        spawns = {grid: pool.submit(run_spmd, LAUNCH + ":rank_jobs", *grid,
                                    (_jobs(dts),), backend="gloo",
                                    device="cpu", timeout=600)
                  for grid, dts in GRIDS.items()}
        jm = jmake_grid_mesh(2, 2, devices=np.asarray(jax.devices()[:4]))
        ref = {}
        for dt in DTYPES:
            ref[dt, "band"] = _jax_band(jm, _band_inputs(dt))
            ref[dt, "hesv"] = _jax_hesv(jm, _hesv_inputs(dt))
        out = {grid: f.result() for grid, f in spawns.items()}
    got = {}
    for grid, ranks in out.items():
        for i, dt in enumerate(GRIDS[grid]):
            got[grid, dt, "band"] = [rank[2 * i] for rank in ranks]
            got[grid, dt, "hesv"] = [rank[2 * i + 1] for rank in ranks]
    return {"ref": ref, "got": got}


def _rel(x, ref):
    ref = np.asarray(ref)
    d = np.linalg.norm(np.asarray(x).astype(ref.dtype) - ref)
    return float(d / np.linalg.norm(ref)) if np.linalg.norm(ref) else float(d)


def _held(runs, grid, dt, op, key):
    """Every rank's ``key`` (a tensor or a tuple of them) within TOL of the
    JAX package's, and bitwise equal across the ranks; returns rank 0's."""
    ref = runs["ref"][dt, op][key]
    ranks = runs["got"][grid, dt, op]
    refs = ref if isinstance(ref, tuple) else (ref,)
    for got in ranks:
        gots = got[key] if isinstance(got[key], tuple) else (got[key],)
        assert len(gots) == len(refs)
        for g, r, g0 in zip(gots, refs, ranks[0][key] if isinstance(
                ranks[0][key], tuple) else (ranks[0][key],)):
            assert np.shape(g) == np.shape(r), key
            assert _rel(g, r) <= TOL[dt], (key, _rel(g, r))
            assert np.array_equal(g, g0), key
    return ranks[0][key]


def _ids(x):
    return np.dtype(x).name if isinstance(x, type) else "%dx%d" % x


def _resid(a, x, b):
    return float(np.linalg.norm(a @ x - b)
                 / (np.linalg.norm(a) * np.linalg.norm(x)))


@pytest.mark.parametrize("grid,dtype", CASES, ids=_ids)
@pytest.mark.parametrize("uplo", ["lower", "upper"])
def test_ppbtrf_matches_jax(runs, grid, dtype, uplo):
    """ppbtrf's (diagonal, sub) stacks from the lower band and from the
    upper band's adjoints, and L·Lᴴ reconstructs A."""
    ld, ls = _held(runs, grid, dtype, "band", "pbtrf_" + uplo)
    l = np.zeros((ld.shape[0] * NB,) * 2, dtype=ld.dtype)
    for k in range(ld.shape[0]):
        l[k * NB:(k + 1) * NB, k * NB:(k + 1) * NB] = ld[k]
        if k + 1 < ld.shape[0]:
            l[(k + 1) * NB:(k + 2) * NB, k * NB:(k + 1) * NB] = ls[k]
    a = _band_inputs(dtype)["spd"]
    rec = (l @ l.conj().T)[:N, :N]
    assert _rel(rec, a) <= 10 * np.finfo(dtype).eps


@pytest.mark.parametrize("grid,dtype", CASES, ids=_ids)
@pytest.mark.parametrize("op", ["pbsv", "gbsv"])
def test_band_solves_match_jax(runs, grid, dtype, op):
    """ppbsv and pgbsv: X against the JAX package's and its residual."""
    inp = _band_inputs(dtype)
    x = _held(runs, grid, dtype, "band", op)
    a = inp["spd"] if op == "pbsv" else inp["gen"]
    limit = 1e-12 if dtype != np.float32 else 1e-5
    assert _resid(a, x, inp["b"]) <= limit


@pytest.mark.parametrize("grid,dtype", CASES, ids=_ids)
def test_pgbtrf_matches_jax(runs, grid, dtype):
    """pgbtrf's packed panels and U fill within TOL, its window row orders
    equal the JAX package's (no ties at this input), some not the
    identity."""
    ref = runs["ref"][dtype, "band"]["gbtrf"]
    lu, u12, piv = runs["got"][grid, dtype, "band"][0]["gbtrf"]
    assert np.array_equal(piv, ref[2])
    assert (piv != np.arange(2 * NB)).any()
    for got in runs["got"][grid, dtype, "band"]:
        assert np.array_equal(got["gbtrf"][2], piv)
    for g, r in ((lu, ref[0]), (u12, ref[1])):
        assert _rel(g, r) <= TOL[dtype]
    _held(runs, grid, dtype, "band", "gbtrf")


@pytest.mark.parametrize("grid,dtype", CASES, ids=_ids)
@pytest.mark.parametrize("op", ["gbmm", "hbmm"])
def test_band_multiplies_match_jax(runs, grid, dtype, op):
    """pgbmm (with β·C) and phbmm (the lower triangle mirrored) against
    the JAX package's and against the dense product."""
    inp = _band_inputs(dtype)
    y = _held(runs, grid, dtype, "band", op)
    if op == "gbmm":
        want = inp["alpha"] * inp["gen"] @ inp["b"] + inp["beta"] * inp["c"]
    else:
        want = inp["alpha"] * inp["spd"] @ inp["b"]
    assert _rel(y, want) <= TOL[dtype]


@pytest.mark.parametrize("grid,dtype", CASES, ids=_ids)
@pytest.mark.parametrize("pivots", [False, True], ids=["plain", "pivots"])
def test_ptbsm_matches_jax(runs, grid, dtype, pivots):
    """ptbsm of the lower band, B row-permuted first with the pivots."""
    inp = _band_inputs(dtype)
    x = _held(runs, grid, dtype, "band",
              "tbsm_pivots" if pivots else "tbsm")
    b = inp["b"][inp["pivots"]] if pivots else inp["b"]
    limit = 1e-12 if dtype != np.float32 else 1e-5
    assert _resid(inp["tri"], x, b) <= limit


@pytest.mark.parametrize("grid,dtype", CASES, ids=_ids)
def test_phetrf_matches_jax(runs, grid, dtype):
    """phetrf's L, d, e within TOL and its pivots equal the JAX package's,
    with pivots from inside a panel's window and from the trailing
    matrix; P·A·Pᴴ = L·T·Lᴴ."""
    ref = runs["ref"][dtype, "hesv"]
    ranks = runs["got"][grid, dtype, "hesv"]
    ipiv = ranks[0]["ipiv"]
    assert np.array_equal(ipiv, ref["ipiv"])
    for got in ranks:
        assert np.array_equal(got["ipiv"], ipiv)
    j = np.arange(ipiv.size)
    j0 = j // NB * NB
    inwin = ipiv < j0 + np.minimum(np.minimum(NB, N - 2 - j0) + 1, N - j0)
    assert inwin[ipiv > j + 1].any() and (~inwin).any()
    l = _held(runs, grid, dtype, "hesv", "l")
    d = _held(runs, grid, dtype, "hesv", "d")
    e = _held(runs, grid, dtype, "hesv", "e")
    a = _hesv_inputs(dtype)["a"].astype(np.complex128)
    perm = np.arange(N)
    for k, pv in enumerate(ipiv):
        perm[[k + 1, pv]] = perm[[pv, k + 1]]
    t = np.diag(d).astype(np.complex128) + np.diag(e, -1) \
        + np.diag(np.conj(e), 1)
    lu = l + np.eye(N)
    assert _rel(lu @ t @ lu.conj().T, a[perm][:, perm]) \
        <= 1e3 * np.finfo(dtype).eps


@pytest.mark.parametrize("grid,dtype", CASES, ids=_ids)
@pytest.mark.parametrize("op", ["x_trs", "x"], ids=["phetrs", "phesv"])
def test_phesv_matches_jax(runs, grid, dtype, op):
    """phetrs of phetrf's factors and phesv: X against the JAX package's
    and its residual."""
    inp = _hesv_inputs(dtype)
    x = _held(runs, grid, dtype, "hesv", op)
    limit = 1e-12 if dtype != np.float32 else 1e-5
    assert _resid(inp["a"], x, inp["b"]) <= limit


@pytest.mark.parametrize("grid", list(GRIDS), ids=_ids)
def test_phetrf_one_collective_a_column(runs, grid):
    """Each column's swap is one collective on every grid: n − 2 in the
    job's one phetrf, one window and one re-hermitization a panel, two
    gathers; no kernel launched on the CPU."""
    panels = -(-(N - 2) // NB)
    for dt in GRIDS[grid]:
        for got in runs["got"][grid, dt, "hesv"]:
            c = got["collectives"]
            assert c["collective.hetrf_swap.count"] == N - 2
            assert c["collective.hetrf_window.count"] == panels
            assert c["collective.hetrf_hermitize.count"] == panels
            assert c["collective.hetrf_gather.count"] == 2
            assert not got["launches"]


@pytest.mark.parametrize("dtype", DTYPES, ids=_ids)
def test_phetrf_serial_stub_matches_blocked_hetrf(dtype):
    """On the 1×1 serial stub phetrf is the single-device blocked Aasen:
    the same pivots, L, d and e within TOL."""
    from slate_tpu_torch.linalg.hesv import _hetrf_blocked

    inp = _hesv_inputs(dtype)
    mesh = tpar.make_grid_mesh(1, 1, device="cpu")
    a = torch.from_numpy(inp["a"])
    l, d, e, ipiv = tpar.phetrf(a, mesh, NB)
    lb, db, eb, pb = _hetrf_blocked(a, NB)
    assert torch.equal(ipiv, pb[:N - 2].long())
    for g, r in ((tpar.undistribute(l), lb), (d, db), (e, eb)):
        assert _rel(g.numpy(), r.numpy()) <= TOL[dtype]


def test_refusals():
    """Band widths past nb and non-square padded storage raise."""
    mesh = tpar.make_grid_mesh(1, 1, device="cpu")
    a = tpar.distribute(torch.eye(40, dtype=torch.float64), mesh, 8)
    with pytest.raises(ValueError, match="exceeds tile size"):
        tband.ppbtrf(a, 9)
    with pytest.raises(ValueError, match="exceeds tile size"):
        tband.pgbtrf(a, 2, 9)
    rect = tpar.distribute(torch.zeros((40, 24), dtype=torch.float64), mesh, 8)
    with pytest.raises(ValueError, match="square padded storage"):
        tpar.phetrf(rect)
