"""The port's distributed norms, rank-k updates, triangular multiplies and
solves (``slate_tpu_torch.parallel`` ``dist_aux``) and its layout moves
(``peye``, ``ptranspose``, ``predistribute``, ``phermitize``) against the
JAX package's, on the same numpy inputs made from seeds.

* dist_aux: one 2×2 gloo spawn of CPU processes runs
  :func:`~slate_tpu_torch.parallel.launch.rank_aux` in fp32, fp64 and
  complex128 (``pnorm`` at the four norms and ``pcolnorms`` of a ragged
  matrix distributed with ``diag_pad=1``, so the padding must be masked;
  ``pherk``/``psyrk``/``pher2k``/``psyr2k`` without and with C and β;
  ``ptri_mask`` and ``ptrmm`` at each uplo and diag; ``phemm``/``psymm``;
  ``ptrsm`` at all 16 side/uplo/op/diag combinations), against the JAX
  drivers on a 2×2 mesh of the virtual CPU devices: within 1e-4 relative
  in fp32 and 1e-10 in fp64 and complex128; the triangular solves'
  residuals at rounding level.
* layout: every rank's shard of ``ptranspose`` (plain and conj),
  ``predistribute`` (a new nb, and a new grid over the same ranks: 2×2 →
  1×4, 1×3 → 3×1), ``peye`` and ``phermitize`` bitwise the JAX
  ``DistMatrix``'s block, on 2×2 and 1×3 gloo grids.
* The core surface on the 2×2 spawn: ``printing.redistribute`` (a new
  nb, and the 1×4 grid) bitwise the JAX package's shards,
  ``debug.check_dist_layout`` on each shard, and ``sprint_matrix`` of the
  DistMatrix equal to the JAX package's text.
* The serial stub (1×1, no process group) in process, and the refusals.
"""

import concurrent.futures

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from slate_tpu.parallel.mesh import make_grid_mesh as jmake_grid_mesh

from slate_tpu_torch import parallel as tpar
from slate_tpu_torch.enums import Diag, Norm, Op, Side, Uplo
from slate_tpu_torch.parallel.launch import rank_aux, run_spmd
from slate_tpu_torch.parallel.mesh import Mesh

NB = 32
LAUNCH = "slate_tpu_torch.parallel.launch"
TOL = {np.float32: 1e-4, np.float64: 1e-10, np.complex128: 1e-10}
#: the layout moves' input (a ragged complex matrix), tile sizes and the
#: re-grid of each grid
LAYOUT = {"shape": (100, 70), "nb": 16, "nb_new": 32,
          (2, 2): (1, 4), (1, 3): (3, 1)}
MOVES = ("transpose", "conj_transpose", "nb_new", "regrid", "eye",
         "hermitize_lower", "hermitize_upper")


def _rel(x, ref):
    ref = np.asarray(ref)
    d = np.linalg.norm(np.asarray(x).astype(ref.dtype) - ref)
    return float(d / np.linalg.norm(ref)) if np.linalg.norm(ref) else float(d)


def _aux_inputs(dtype):
    """rect 70×50, tall/tall2 160×40, sq 96×96 (a triangle of it well
    conditioned: N(0, 1)/n off the diagonal, 2 on it), c 160×160, rhs
    96×5 and rhs_right 5×96, α and β, from seed 93."""
    rng = np.random.default_rng(93)
    cplx = np.issubdtype(dtype, np.complexfloating)

    def draw(*s):
        x = rng.standard_normal(s)
        if cplx:
            x = x + 1j * rng.standard_normal(s)
        return x.astype(dtype)

    n = 96
    return {"rect": draw(70, 50), "tall": draw(160, 40),
            "tall2": draw(160, 40),
            "sq": (draw(n, n) / n + 2 * np.eye(n)).astype(dtype),
            "c": draw(160, 160), "rhs": draw(n, 5), "rhs_right": draw(5, n),
            "alpha": complex(0.75, -0.5) if cplx else 0.75,
            "beta": complex(-0.25, 0.5) if cplx else -0.25}


def _jax_aux(mesh, inp):
    from slate_tpu.enums import Diag as JD, Norm as JN, Op as JO, \
        Side as JS, Uplo as JU
    from slate_tpu.parallel import (distribute, pcolnorms, phemm, pher2k,
                                    pherk, pnorm, psymm, psyr2k, psyrk,
                                    ptri_mask, ptrmm, ptrsm, undistribute)

    def und(x):
        return np.asarray(undistribute(x))

    def dist(x, **kw):
        return distribute(jnp.asarray(x), mesh, NB, **kw)

    alpha, beta = inp["alpha"], inp["beta"]
    sq = dict(row_mult=2, col_mult=2)
    out = {}
    rect = dist(inp["rect"], diag_pad=1.0, **sq)
    for norm in (JN.Max, JN.One, JN.Inf, JN.Fro):
        out["norm/" + norm.value] = float(pnorm(rect, norm))
    out["colnorms"] = np.asarray(pcolnorms(rect))
    a, b = dist(inp["tall"], row_mult=2), dist(inp["tall2"], row_mult=2)
    for name, fn, args in (("herk", pherk, (a,)), ("syrk", psyrk, (a,)),
                           ("her2k", pher2k, (a, b)),
                           ("syr2k", psyr2k, (a, b))):
        out[name] = und(fn(alpha, *args))
        out[name + "/c"] = und(fn(alpha, *args, beta, dist(inp["c"], **sq)))
    s = dist(inp["sq"], **sq)
    rhs = dist(inp["rhs"], row_mult=2)
    for uplo in (JU.Lower, JU.Upper):
        for diag in (JD.NonUnit, JD.Unit):
            key = "%s/%s" % (uplo.name, diag.name)
            out["tri_mask/" + key] = und(ptri_mask(s, uplo, diag))
            out["trmm/" + key] = und(ptrmm(uplo, diag, s, rhs, alpha))
    for name, fn in (("hemm", phemm), ("symm", psymm)):
        out[name] = und(fn(alpha, s, rhs))
        out[name + "/c"] = und(fn(alpha, s, rhs, beta,
                                  dist(inp["rhs"], row_mult=2)))
    rhs_right = dist(inp["rhs_right"], col_mult=2)
    for side in (JS.Left, JS.Right):
        for uplo in (JU.Lower, JU.Upper):
            for op in (JO.NoTrans, JO.Trans, JO.ConjTrans):
                for diag in (JD.NonUnit, JD.Unit):
                    key = "trsm/%s/%s/%s/%s" % (side.name, uplo.name,
                                                op.name, diag.name)
                    out[key] = und(ptrsm(side, uplo, op, diag, s,
                                         rhs if side is JS.Left
                                         else rhs_right))
    return out


def _jax_layout(p, q, a, sq):
    from slate_tpu.enums import Uplo as JU
    from slate_tpu.parallel import dist_util as jutil
    from slate_tpu.parallel.dist import distribute

    nb = LAYOUT["nb"]
    jm = jmake_grid_mesh(p, q, devices=np.asarray(jax.devices()[:p * q]))
    p2, q2 = LAYOUT[p, q]
    jm2 = jmake_grid_mesh(p2, q2, devices=np.asarray(jax.devices()[:p * q]))
    ad = distribute(jnp.asarray(a), jm, nb, row_mult=q, col_mult=p)
    sd = distribute(jnp.asarray(sq), jm, nb, diag_pad=1.0, row_mult=q,
                    col_mult=p)
    moves = {"transpose": (jutil.ptranspose(ad), (p, q)),
             "conj_transpose": (jutil.ptranspose(ad, conj=True), (p, q)),
             "nb_new": (jutil.predistribute(ad, LAYOUT["nb_new"]), (p, q)),
             "regrid": (jutil.predistribute(ad, mesh_new=jm2), (p2, q2)),
             "eye": (jutil.peye(sq.shape[0], nb, jm, dtype=sq.dtype), (p, q)),
             "hermitize_lower": (jutil.phermitize(sd, JU.Lower), (p, q)),
             "hermitize_upper": (jutil.phermitize(sd, JU.Upper), (p, q))}
    return {k: (np.asarray(v.data), grid, (v.m, v.n, v.nb, v.mtp, v.ntp))
            for k, (v, grid) in moves.items()}


def _jax_surface(a):
    """The JAX package's ``redistribute`` of ``a`` (2×2, nb 16) to nb 32
    and to the 1×4 grid, and ``sprint_matrix`` of it at verbose 4."""
    from slate_tpu.parallel.dist import distribute
    from slate_tpu.printing import redistribute, sprint_matrix

    devs = np.asarray(jax.devices()[:4])
    jm = jmake_grid_mesh(2, 2, devices=devs)
    jm2 = jmake_grid_mesh(*LAYOUT[2, 2], devices=devs)
    ad = distribute(jnp.asarray(a), jm, LAYOUT["nb"])
    moves = {"nb_new": (redistribute(ad, nb=LAYOUT["nb_new"]), (2, 2)),
             "regrid": (redistribute(ad, mesh=jm2), LAYOUT[2, 2])}
    out = {k: (np.asarray(v.data), grid, (v.m, v.n, v.nb, v.mtp, v.ntp))
           for k, (v, grid) in moves.items()}
    out["text"] = sprint_matrix("D", ad, verbose=4)
    return out


def _layout_inputs():
    rng = np.random.default_rng(95)
    m, n = LAYOUT["shape"]
    a = rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))
    sq = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    return a, sq


@pytest.fixture(scope="module")
def runs():
    """The 2×2 spawn (rank_aux in three dtypes, then the layout moves)
    and the 1×3 spawn (the layout moves), in threads, while the JAX
    drivers run here."""
    a, sq = _layout_inputs()
    lay = (a, sq, LAYOUT["nb"], LAYOUT["nb_new"])
    jobs = [(LAUNCH + ":rank_aux", (_aux_inputs(dt), NB)) for dt in TOL]
    jobs.append((LAUNCH + ":rank_surface", (a.real.copy(), LAYOUT["nb"],
                                            LAYOUT["nb_new"],
                                            LAYOUT[2, 2])))
    jobs.append((LAUNCH + ":rank_layout_moves", lay + (LAYOUT[2, 2],)))
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        grid22 = pool.submit(run_spmd, LAUNCH + ":rank_jobs", 2, 2, (jobs,),
                             backend="gloo", device="cpu", timeout=300)
        grid13 = pool.submit(run_spmd, LAUNCH + ":rank_layout_moves", 1, 3,
                             lay + (LAYOUT[1, 3],), backend="gloo",
                             device="cpu", timeout=300)
        jm = jmake_grid_mesh(2, 2, devices=np.asarray(jax.devices()[:4]))
        ref = {dt: _jax_aux(jm, _aux_inputs(dt)) for dt in TOL}
        layout_ref = {(2, 2): _jax_layout(2, 2, a, sq),
                      (1, 3): _jax_layout(1, 3, a, sq)}
        surface_ref = _jax_surface(a.real.copy())
        out22, out13 = grid22.result(), grid13.result()
    return {"ref": ref, "aux": {dt: [rank[i] for rank in out22]
                                for i, dt in enumerate(TOL)},
            "surface_ref": surface_ref,
            "surface": [rank[len(TOL)] for rank in out22],
            "layout_ref": layout_ref,
            "layout": {(2, 2): [rank[-1] for rank in out22], (1, 3): out13}}


@pytest.mark.parametrize("dtype", list(TOL), ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("family", ["norm", "colnorms", "herk", "syrk",
                                    "her2k", "syr2k", "tri_mask", "trmm",
                                    "hemm", "symm", "trsm"])
def test_aux_matches_jax(runs, family, dtype):
    ref = runs["ref"][dtype]
    keys = [k for k in sorted(ref) if k.split("/")[0] == family]
    # on the CPU the wrappers run their plain versions: no launch counted
    assert not any(runs["aux"][dtype][0]["launches"].values())
    assert keys
    for got in runs["aux"][dtype]:
        for key in keys:
            g, r = np.asarray(got[key]), np.asarray(ref[key])
            assert g.shape == r.shape, key
            assert _rel(g, r) <= TOL[dtype], (key, _rel(g, r))
            # every rank holds the same replicated results
            assert np.array_equal(g, runs["aux"][dtype][0][key]), key


@pytest.mark.parametrize("dtype", list(TOL), ids=lambda d: np.dtype(d).name)
def test_aux_answers_are_right(runs, dtype):
    """The port's answers themselves, against numpy on the inputs."""
    inp = {k: (np.asarray(v, np.complex128) if isinstance(v, np.ndarray)
               else v) for k, v in _aux_inputs(dtype).items()}
    got = runs["aux"][dtype][0]
    eps = np.finfo(dtype).eps
    rect = inp["rect"]
    for key, want in (("max", np.abs(rect).max()),
                      ("one", np.abs(rect).sum(0).max()),
                      ("inf", np.abs(rect).sum(1).max()),
                      ("fro", np.linalg.norm(rect))):
        assert abs(got["norm/" + key] - want) <= 100 * eps * want, key
    assert np.allclose(got["colnorms"], np.abs(rect).max(0),
                       rtol=10 * eps, atol=0)
    al, be, a, b = inp["alpha"], inp["beta"], inp["tall"], inp["tall2"]
    her2k = al * a @ b.conj().T + np.conj(al) * b @ a.conj().T + be * inp["c"]
    assert _rel(got["her2k/c"], her2k) <= 100 * eps
    s, rhs, rr = inp["sq"], inp["rhs"], inp["rhs_right"]
    n = s.shape[0]
    for key in (k for k in got if k.startswith("trsm/")):
        _, side, uplo, op, diag = key.split("/")
        t = np.tril(s) if uplo == "Lower" else np.triu(s)
        if diag == "Unit":
            t = t - np.diag(np.diag(t)) + np.eye(n)
        t = {"NoTrans": t, "Trans": t.T, "ConjTrans": t.conj().T}[op]
        x = got[key]
        res = t @ x - rhs if side == "Left" else x @ t - rr
        assert np.linalg.norm(res) <= 10 * eps * n * np.linalg.norm(t) \
            * np.linalg.norm(x), key


@pytest.mark.parametrize("grid", [(2, 2), (1, 3)], ids=["2x2", "1x3"])
@pytest.mark.parametrize("move", MOVES)
def test_layout_moves_bitwise_jax(runs, grid, move):
    data, (p, q), dims = runs["layout_ref"][grid][move]
    h, w = data.shape[0] // p, data.shape[1] // q
    for rank, got in enumerate(runs["layout"][grid]):
        r, c = got["regrid_rank"] if move == "regrid" else divmod(
            rank, grid[1])
        assert tuple(got["dims"][move]) == dims, (move, got["dims"][move])
        assert np.array_equal(got[move],
                              data[r * h:(r + 1) * h, c * w:(c + 1) * w]), \
            (move, rank)


@pytest.mark.parametrize("move", ["nb_new", "regrid"])
def test_redistribute_bitwise_jax(runs, move):
    """``printing.redistribute`` on the 2×2 grid: every rank's shard
    bitwise the JAX package's block, each shard's layout checked."""
    data, (p, q), dims = runs["surface_ref"][move]
    h, w = data.shape[0] // p, data.shape[1] // q
    for rank, got in enumerate(runs["surface"]):
        r, c = got["regrid_rank"] if move == "regrid" else divmod(rank, 2)
        assert tuple(got["dims"][move]) == dims
        assert np.array_equal(got[move],
                              data[r * h:(r + 1) * h, c * w:(c + 1) * w])
        assert got["layout"][move] is None


def test_dist_layout_check_and_print_on_the_grid(runs):
    want = runs["surface_ref"]["text"]
    assert want.startswith("% D: DistMatrix 100x70, nb=16, grid=2x2")
    for got in runs["surface"]:
        assert got["layout"]["a"] is None
        assert "not a multiple of the tile" in got["layout"]["short"]
        assert got["text"] == want


def test_serial_stub_matches_jax(runs):
    """dist_aux on the 1×1 grid with no process group, in this process,
    against the JAX drivers' 2×2 results (fp64)."""
    ref = runs["ref"][np.float64]
    got = rank_aux(tpar.make_grid_mesh(1, 1, device="cpu"),
                   _aux_inputs(np.float64), NB)
    for key in sorted(ref):
        assert _rel(got[key], ref[key]) <= 1e-10, key


def test_serial_stub_layout_moves():
    mesh = tpar.make_grid_mesh(1, 1, device="cpu")
    a, sq = _layout_inputs()
    ad = tpar.distribute(a, mesh, 16)
    assert np.array_equal(tpar.undistribute(tpar.ptranspose(ad, conj=True))
                          .numpy(), a.conj().T)
    back = tpar.predistribute(tpar.predistribute(ad, 32), 16)
    assert np.array_equal(tpar.undistribute(back).numpy(), a)
    assert np.array_equal(tpar.undistribute(tpar.peye(70, 16, mesh))
                          .numpy(), np.eye(70))
    h = tpar.undistribute(tpar.phermitize(tpar.distribute(sq, mesh, 16),
                                          Uplo.Upper)).numpy()
    up = np.triu(sq)
    assert np.array_equal(h, up + up.conj().T - np.diag(np.diag(sq)).conj())


def test_aux_refusals():
    mesh = tpar.make_grid_mesh(1, 1, device="cpu")
    rng = np.random.default_rng(7)
    a = tpar.distribute(rng.standard_normal((64, 32)), mesh, NB)
    b = tpar.distribute(rng.standard_normal((64, 64)), mesh, NB)
    with pytest.raises(ValueError, match="must match in shape"):
        tpar.pher2k(1.0, a, b)
    with pytest.raises(ValueError, match="C padding"):
        tpar.pherk(1.0, a, 0.0, tpar.distribute(np.zeros((96, 96)), mesh, NB))
    s = tpar.distribute(rng.standard_normal((64, 64)), mesh, NB)
    with pytest.raises(ValueError, match="B tiling"):
        tpar.ptrsm(Side.Left, Uplo.Lower, Op.NoTrans, Diag.NonUnit, s,
                   tpar.distribute(rng.standard_normal((96, 2)), mesh, NB))
    with pytest.raises(ValueError, match="square"):
        tpar.phemm(1.0, a, b)
    # a grid over other ranks than the matrix's
    with pytest.raises(ValueError, match="same ranks"):
        tpar.predistribute(s, mesh_new=Mesh(1, 2, 0, 0, "cpu"))
    assert float(tpar.pnorm(s, Norm.Max)) == np.abs(
        tpar.undistribute(s).numpy()).max()
