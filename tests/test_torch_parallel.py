"""The port's distributed drivers (``slate_tpu_torch.parallel``) and their
two kernels (``chol_l21_panel``, ``lu_u12_panel``) against the JAX
package, on the same numpy inputs made from seeds.

* kernels: the plain versions against the JAX package's Pallas kernels in
  interpret mode at nb = 128 (the kernels' own shape rule), fp32 within
  1e-4 relative (dev within 1e-4 relative) and fp64 within
  100·ε·nb·max|input|, as ``tests/test_multichip_scaleout.py:265-297``;
* layout: every rank's shard from the port's ``distribute`` bitwise the
  JAX ``DistMatrix``'s block for device (r, c), on 2×2 and 1×3 grids, with
  diagonal padding, padding multiples, rectangular tiles and a row map;
  on a 2×2 gloo grid ``dist_from_numpy`` ∘ ``dist_to_numpy``, the
  undistributed matrix and ``canonicalize`` against the JAX package;
* drivers: ``pgemm``, ``pposv`` and ``pgesv`` (n = 192, nb = 32) on a 2×2
  gloo grid of spawned CPU processes (one spawn per configuration)
  against the JAX drivers on a 2×2 mesh of the virtual CPU devices, both
  packages pinned alike; factors within 1e-4 (fp32) and 1e-10 (fp64)
  relative, ``gperm`` exactly equal (the inputs have no ties), scaled
  residuals < 3·ε·n; the serial stub (1×1, no process group) in process;
* sites: each ``dist_*`` site on ``cpu`` and ``cuda`` keys, and each pin.

The JAX package's fused rung returns a ``pallas_call`` output inside
``shard_map``, which this JAX's varying-axes check refuses (its own
``test_dist_panel_fused_parity_end_to_end`` fails the same way under
``--runslow``); the fixture below builds its drivers' ``shard_map`` with
``check_vma=False`` for this module and drops those builds afterwards.
"""

import concurrent.futures
import functools
import operator

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from slate_tpu.ops import pallas_kernels as pk
from slate_tpu.parallel import dist as jdist
from slate_tpu.parallel import dist_factor as jfactor
from slate_tpu.parallel import dist_lu as jlu
from slate_tpu.parallel.dist_blas3 import pgemm_auto as jpgemm_auto
from slate_tpu.parallel.mesh import make_grid_mesh as jmake_grid_mesh
from slate_tpu.perf import autotune as jauto

from slate_tpu_torch import parallel as tpar
from slate_tpu_torch.ops import kernels
from slate_tpu_torch.parallel import dist_util
from slate_tpu_torch.parallel.launch import rank_drivers, run_spmd
from slate_tpu_torch.parallel.mesh import Mesh
from slate_tpu_torch.perf import autotune as tauto

N, NB, NRHS = 192, 32, 4
JAX_FORCE = "SLATE_TPU_AUTOTUNE_FORCE"
#: the pins both packages run under ("" = the CPU defaults: xla, maxloc,
#: whole, depth 1)
CONFIGS = {
    "fused_maxloc": "dist_panel=pallas_fused,dist_lookahead=1,"
                    "dist_pivot=maxloc",
    "fused_depth2_tournament": "dist_panel=pallas_fused,dist_lookahead=2,"
                               "dist_pivot=tournament",
    "default": "",
}
TOL = {np.float32: 1e-4, np.float64: 1e-10}
LAUNCH = "slate_tpu_torch.parallel.launch"


def _rel(x, ref):
    return float(np.linalg.norm(np.asarray(x, np.float64) - ref)
                 / np.linalg.norm(ref))


def _scaled_res(a, x, b):
    return np.linalg.norm(a @ x - b) / (
        np.linalg.norm(a) * np.linalg.norm(x) + np.linalg.norm(b))


def _inputs():
    rng = np.random.default_rng(81)
    g = rng.standard_normal((N, N))
    return {"a_spd": g @ g.T + N * np.eye(N),
            "a_gen": rng.standard_normal((N, N)),
            "b": rng.standard_normal((N, NRHS))}


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_chol_l21_panel_plain_matches_pallas(dtype):
    nb, m = 128, 256
    rng = np.random.default_rng(11)
    g = rng.standard_normal((nb, nb))
    d = (g @ g.T + nb * np.eye(nb)).astype(dtype)
    panel = rng.standard_normal((m, nb)).astype(dtype)
    lj, xj = (np.asarray(v, np.float64) for v in pk.chol_l21_panel(
        jnp.asarray(d), jnp.asarray(panel)))
    lt, xt = kernels.chol_l21_panel(torch.from_numpy(d),
                                    torch.from_numpy(panel))
    assert lt.dtype == xt.dtype == torch.from_numpy(d).dtype
    if dtype == np.float32:
        assert _rel(lt, lj) <= 1e-4 and _rel(xt, xj) <= 1e-4
    else:
        eps = np.finfo(np.float64).eps
        assert np.abs(lt.numpy() - lj).max() <= 100 * eps * nb * np.abs(d).max()
        assert np.abs(xt.numpy() - xj).max() <= \
            100 * eps * nb * np.abs(panel).max()
    # the factor and the solve themselves
    assert np.allclose(xt.double().numpy() @ lt.double().numpy().T, panel,
                       atol=1e-3 if dtype == np.float32 else 1e-10)
    assert np.array_equal(np.triu(lt.numpy(), 1), np.zeros((nb, nb)))


@pytest.mark.parametrize("dtype,nb,w", [
    pytest.param(np.float32, 128, 256, id="float32"),
    pytest.param(np.float64, 128, 256, id="float64"),
    # the distributed LU's depth-2 ring call
    pytest.param(np.float32, 256, 256, id="float32-ring256")])
def test_lu_u12_panel_plain_matches_pallas(dtype, nb, w):
    rng = np.random.default_rng(12)
    # a tame unit-lower triangle, as the reference test makes it
    l11 = (np.tril(rng.standard_normal((nb, nb)), -1) / np.sqrt(nb)
           + np.eye(nb)).astype(dtype)
    b = rng.standard_normal((nb, w)).astype(dtype)
    uj, devj = (np.asarray(v, np.float64) for v in pk.lu_u12_panel(
        jnp.asarray(l11), jnp.asarray(b)))
    ut, devt = kernels.lu_u12_panel(torch.from_numpy(l11), torch.from_numpy(b))
    assert tuple(devt.shape) == (1, 1)
    eps = np.finfo(dtype).eps
    if dtype == np.float32:
        assert _rel(ut, uj) <= 1e-4
    else:
        assert np.abs(ut.numpy() - uj).max() <= 100 * eps * nb * np.abs(b).max()
    _same_departure(float(devt), float(devj[0, 0]))
    assert float(devt) < 10 * nb * eps
    assert np.allclose(l11.astype(np.float64) @ ut.double().numpy(), b,
                       atol=1e-4 if dtype == np.float32 else 1e-11)


def _same_departure(dev, ref):
    """The departure of a unit-lower L11 is the solve's rounding amplified
    by cond(L11), so two summation orders give values apart by up to a
    factor of 2 (0.6040e-6 against 0.6595e-6 at nb = 128 in fp32 here):
    hold it within a factor of 4, with the guard's verdict, and zero only
    where the reference is zero."""
    if ref == 0.0:
        assert dev == 0.0, (dev, ref)
    else:
        assert 0.25 <= dev / ref <= 4.0, (dev, ref)
        assert (dev < 1e-2) == (ref < 1e-2), (dev, ref)


@pytest.mark.parametrize("nb", [128, 256])
def test_lu_u12_panel_departure_of_a_strict_upper_part(nb):
    """L11 is multiplied as given in the correction: with a strict upper
    part S the departure max|S·L⁻¹B| / max|B| is set by the data, so it
    is held at 1e-4 relative to the JAX kernel's and to fp64."""
    rng = np.random.default_rng(14)
    l11 = (np.tril(rng.standard_normal((nb, nb)), -1) / np.sqrt(nb)
           + np.eye(nb) + np.triu(rng.standard_normal((nb, nb)), 1)
           / np.sqrt(nb)).astype(np.float32)
    b = rng.standard_normal((nb, 256)).astype(np.float32)
    uj, devj = (np.asarray(v, np.float64) for v in pk.lu_u12_panel(
        jnp.asarray(l11), jnp.asarray(b)))
    ut, devt = kernels.lu_u12_panel(torch.from_numpy(l11), torch.from_numpy(b))
    l64, b64 = l11.astype(np.float64), b.astype(np.float64)
    u1 = np.linalg.solve(np.tril(l64), b64)
    dev64 = np.abs(b64 - l64 @ u1).max() / np.abs(b64).max()
    assert dev64 > 0.5
    assert abs(float(devt) - devj[0, 0]) <= 1e-4 * devj[0, 0]
    assert abs(float(devt) - dev64) <= 1e-4 * dev64
    assert _rel(ut, uj) <= 1e-4


@pytest.mark.parametrize("seed", [12, 13])
def test_lu_u12_panel_departure_flags_a_wrong_inverse(seed):
    """A unit-lower triangle with N(0, 1) entries (condition ~2ⁿ): the
    departure the guard reads passes 1e-2 in fp32, in both packages."""
    nb, w = 128, 256
    rng = np.random.default_rng(seed)
    l11 = (np.tril(rng.standard_normal((nb, nb)), -1)
           + np.eye(nb)).astype(np.float32)
    b = rng.standard_normal((nb, w)).astype(np.float32)
    _, devj = pk.lu_u12_panel(jnp.asarray(l11), jnp.asarray(b))
    _, devt = kernels.lu_u12_panel(torch.from_numpy(l11), torch.from_numpy(b))
    _same_departure(float(devt), float(np.asarray(devj)[0, 0]))
    assert float(devt) > 1e-2


def test_fused_panel_shape_rules():
    # on the card: nb a power of two in [128, 1024] and 128 | dims
    assert kernels.fused_panel_fits(256, (16384,), "cuda")
    assert not kernels.fused_panel_fits(64, (16384,), "cuda")
    assert not kernels.fused_panel_fits(256, (16320,), "cuda")
    assert not kernels.fused_panel_fits(2048, (16384,), "cuda")
    # on the CPU the plain versions take nb ≥ 32
    assert kernels.fused_panel_fits(32, (192,), "cpu")
    assert not kernels.fused_panel_fits(48, (192,), "cpu")
    f32 = dict(dtype=torch.float32)
    with pytest.raises(ValueError):
        kernels.chol_l21_panel(torch.eye(48, **f32), torch.ones((96, 48), **f32))
    with pytest.raises(ValueError):
        kernels.lu_u12_panel(torch.eye(32, **f32),
                             torch.ones((32, 64), dtype=torch.float64))
    with pytest.raises(ValueError):
        kernels.lu_u12_panel(torch.eye(32, **f32), torch.ones((16, 64), **f32))


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

def _row_map(mtp, p):
    """A balanced non-cyclic tile map: pairs of blocks per owner."""
    return functools.partial(operator.getitem,
                             tuple((i // 2) % p for i in range(mtp)))


def _layout_cases(p, q):
    rng = np.random.default_rng(21)
    a = rng.standard_normal((100, 70))
    mt = -(-100 // 16)
    mtp = -(-mt // (2 * p)) * 2 * p
    return [("plain", a, dict(nb=16)),
            ("padded", a, dict(nb=16, diag_pad=1.0, row_mult=q, col_mult=p)),
            ("rect_tiles", a, dict(nb=16, mb=8)),
            ("row_map", a, dict(nb=16, row_mult=2 * p,
                                row_map=_row_map(mtp, p)))]


def _jax_mesh(p, q):
    return jmake_grid_mesh(p, q, devices=np.asarray(jax.devices()[:p * q]))


@pytest.mark.parametrize("grid", [(2, 2), (1, 3)])
def test_distribute_shards_bitwise_equal_jax(grid):
    p, q = grid
    jm = _jax_mesh(p, q)
    for label, a, kw in _layout_cases(p, q):
        jd = jdist.distribute(jnp.asarray(a), jm, **kw)
        data = np.asarray(jd.data)
        h, w = data.shape[0] // p, data.shape[1] // q
        for r in range(p):
            for c in range(q):
                td = tpar.distribute(a, Mesh(p, q, r, c, "cpu"), **kw)
                assert (td.mtp, td.ntp) == (jd.mtp, jd.ntp), label
                assert np.array_equal(
                    td.data.numpy(),
                    data[r * h:(r + 1) * h, c * w:(c + 1) * w]), (label, r, c)


def test_serial_stub_collectives_are_identities():
    mesh = tpar.make_grid_mesh(1, 1, device="cpu")
    assert mesh.groups is None and (mesh.p, mesh.q, mesh.r, mesh.c) == (
        1, 1, 0, 0)
    x = torch.arange(4.0)
    assert mesh.psum(x) is x and torch.equal(mesh.pmax(x, "p"), x)
    with pytest.raises(ValueError):
        tpar.make_grid_mesh(2, 2, device="cpu")


# ---------------------------------------------------------------------------
# drivers on a 2×2 grid
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_check_vma_off():
    saved = jfactor.shard_map, jlu.shard_map
    sm = functools.partial(jax.shard_map, check_vma=False)
    jfactor.shard_map = jlu.shard_map = sm
    try:
        yield
    finally:
        jfactor.shard_map, jlu.shard_map = saved
        for fn in (jfactor._build_ppotrf, jfactor._build_ptrsm,
                   jlu._build_pgetrf, jlu._build_plu_trsm,
                   jlu._build_permute_rows):
            fn.cache_clear()


def _jax_drivers(mesh, inp, dtype):
    from slate_tpu.parallel import pgesv, pposv, undistribute

    a_spd, a_gen, b = (inp[k].astype(dtype) for k in ("a_spd", "a_gen", "b"))
    c = jpgemm_auto(1.0, a_gen, a_spd, mesh, nb=NB)
    l, x = pposv(a_spd, b, mesh, nb=NB)
    lu, gperm, x2 = pgesv(a_gen, b, mesh, nb=NB)
    return {"c": np.asarray(undistribute(c), np.float64),
            "l": np.tril(np.asarray(undistribute(l), np.float64)),
            "x_po": np.asarray(undistribute(x), np.float64),
            "lu": np.asarray(undistribute(lu), np.float64),
            "gperm": np.asarray(gperm)[:N],
            "x_ge": np.asarray(undistribute(x2), np.float64)}


def _config_run(name):
    """One configuration: ONE spawn of the port's 2×2 gloo grid running
    the drivers in fp32 and fp64 (and, in the default configuration, the
    layout round trips), in a thread, while the JAX drivers run on the
    2×2 mesh in this process."""
    force = CONFIGS[name]
    inp = _inputs()
    jm = _jax_mesh(2, 2)
    jobs = [(LAUNCH + ":rank_drivers",
             tuple(inp[k].astype(dt) for k in ("a_spd", "a_gen", "b"))
             + (NB,)) for dt in TOL]
    layout = None
    if name == "default":
        layout = []
        for label, a, kw in _layout_cases(2, 2):
            jd = jdist.distribute(jnp.asarray(a), jm, **kw)
            layout.append({"label": label, "data": np.asarray(jd.data),
                           "m": jd.m, "n": jd.n, "nb": jd.nb, "mb": jd.mb,
                           "row_map": jd.row_map, "natural": a,
                           "canonical": np.asarray(
                               jdist.canonicalize(jd).data)})
        jobs.append((LAUNCH + ":rank_layout", (layout,)))
    mp = pytest.MonkeyPatch()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawn = pool.submit(run_spmd, LAUNCH + ":rank_jobs", 2, 2, (jobs,),
                            backend="gloo", device="cpu",
                            env={tauto.FORCE_ENV: force}, timeout=300)
        try:
            mp.setenv(JAX_FORCE, force)
            jauto.reset_table()
            ref = {dt: _jax_drivers(jm, inp, dt) for dt in TOL}
        finally:
            jauto.reset_table()
            mp.undo()
        out = spawn.result()
    return {"name": name, "ref": ref, "ranks": out, "layout": layout,
            "inputs": inp}


@pytest.fixture(scope="module")
def runs(jax_check_vma_off):
    done = {}

    def get(name):
        if name not in done:
            done[name] = _config_run(name)
        return done[name]

    return get


@pytest.mark.parametrize("name", list(CONFIGS))
def test_drivers_match_jax(runs, name):
    run = runs(name)
    inp = run["inputs"]
    for i, dt in enumerate(TOL):
        ref = run["ref"][dt]
        eps = np.finfo(dt).eps
        for got in (rank[i] for rank in run["ranks"]):
            for key in ("c", "l", "lu"):
                assert _rel(got[key], ref[key]) <= TOL[dt], (
                    name, dt, key, _rel(got[key], ref[key]))
            assert np.array_equal(got["gperm"], ref["gperm"]), dt
            assert _scaled_res(inp["a_spd"], got["x_po"], inp["b"]) \
                < 3 * eps * N
            assert _scaled_res(inp["a_gen"], got["x_ge"], inp["b"]) \
                < 3 * eps * N
            # every rank holds the same replicated results
            assert np.array_equal(got["lu"], run["ranks"][0][i]["lu"])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_driver_sites_take_the_pins(runs, name):
    force = CONFIGS[name]
    want = dict(kv.split("=") for kv in force.split(",")) if force else {
        "dist_panel": "xla", "dist_pivot": "maxloc", "dist_lookahead": "1"}
    run = runs(name)
    for dt_index in range(len(TOL)):
        dec = run["ranks"][0][dt_index]["decisions"]
        for site, rung in want.items():
            hits = [v for k, v in dec.items() if k.startswith(site + "|")]
            assert hits and set(hits) == {rung}, (site, dec)
    # on the CPU the wrappers run their plain versions: no launch counted
    assert not any(run["ranks"][0][0]["launches"].values())


def test_layout_round_trips_match_jax(runs):
    run = runs("default")
    for rank, got in enumerate(run["ranks"]):
        r, c = divmod(rank, 2)
        for case, res in zip(run["layout"], got[-1]):
            data = case["data"]
            h, w = data.shape[0] // 2, data.shape[1] // 2
            assert np.array_equal(
                res["shard"], data[r * h:(r + 1) * h, c * w:(c + 1) * w])
            assert np.array_equal(res["storage"], data), case["label"]
            assert np.array_equal(res["natural"], case["natural"])
            assert np.array_equal(res["canonical"], case["canonical"]), \
                case["label"]


def test_serial_stub_matches_jax(runs):
    """The 1×1 grid with no process group, in this process, against the
    JAX drivers' 2×2 results (fp64: the factors are unique)."""
    run = runs("default")
    inp = run["inputs"]
    got = rank_drivers(tpar.make_grid_mesh(1, 1, device="cpu"),
                       inp["a_spd"], inp["a_gen"], inp["b"], NB)
    ref = run["ref"][np.float64]
    for key in ("c", "l", "lu"):
        assert _rel(got[key], ref[key]) <= 1e-10, key
    assert np.array_equal(got["gperm"], ref["gperm"])


# ---------------------------------------------------------------------------
# sites
# ---------------------------------------------------------------------------

def test_dist_sites_defaults_and_pins(monkeypatch):
    monkeypatch.delenv(tauto.FORCE_ENV, raising=False)
    f32, f64 = torch.float32, torch.float64
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    panel = dist_util.dist_panel_backend
    # the card: the JAX package's on-chip defaults, fused where it fits
    assert panel("potrf", 256, f32, cuda, m=16384) == "pallas_fused"
    assert panel("getrf", 256, f32, cuda, w=8192) == "pallas_fused"
    assert panel("potrf", 64, f32, cuda, m=16384) == "pallas_panel"
    assert panel("potrf", 256, f64, cuda, m=16384) == "xla"
    assert dist_util.dist_pivot_backend(256, 2, f32, cuda) == "tournament"
    assert dist_util.dist_pivot_backend(256, 1, f32, cuda) == "maxloc"
    assert dist_util.dist_lookahead_depth("getrf", 64, 256, f32, cuda) == 2
    assert dist_util.dist_lookahead_depth("getrf", 4, 256, f32, cuda) == 1
    card = Mesh(2, 2, 0, 0, cuda)
    assert dist_util.dist_chunk_slices("potrf", 256, f32, card) == 1
    assert dist_util.dist_chunk_slices("potrf", 1024, f32, card) == 2
    # the CPU: the JAX package's off-chip answers
    assert panel("potrf", 32, f32, cpu, m=256) == "xla"
    assert panel("getrf", 32, f64, cpu, w=128) == "xla"
    assert dist_util.dist_pivot_backend(32, 2, f32, cpu) == "maxloc"
    assert dist_util.dist_lookahead_depth("potrf", 64, 32, f32, cpu) == 1
    assert dist_util.dist_chunk_slices("potrf", 1024, f32,
                                       Mesh(2, 2, 0, 0, cpu)) == 1
    assert panel("potrf", 48, f32, cpu, m=192) == "xla"    # ineligible nb
    # every pin reaches its site; a rung the key lacks is ignored
    monkeypatch.setenv(tauto.FORCE_ENV, "dist_panel=pallas_fused,"
                       "dist_pivot=tournament,dist_lookahead=3,dist_chunk=4")
    assert panel("getrf", 32, f64, cpu, w=128) == "pallas_fused"
    assert dist_util.dist_pivot_backend(32, 1, f32, cpu) == "tournament"
    assert dist_util.dist_lookahead_depth("potrf", 64, 32, f32, cpu) == 3
    assert dist_util.dist_lookahead_depth("potrf", 2, 32, f32, cpu) == 2
    assert dist_util.dist_chunk_slices("potrf", 32, f32,
                                       Mesh(1, 1, 0, 0, cpu)) == 4
    monkeypatch.setenv(tauto.FORCE_ENV, "dist_panel=pallas_panel")
    assert panel("potrf", 32, f32, cpu, m=256) == "pallas_panel"
    with pytest.warns(UserWarning):
        assert panel("potrf", 32, f64, cpu, m=256) == "xla"
    assert panel("potrf", 256, f32, cuda, m=16320) == "pallas_panel"
    dec = tauto.decisions(with_reasons=True)
    assert dec["dist_panel|potrf,256,float32,cuda,m16384"][0] in (
        "pallas_fused", "pallas_panel")
