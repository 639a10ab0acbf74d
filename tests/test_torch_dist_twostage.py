"""The port's distributed two-stage eigensolver and SVD
(``slate_tpu_torch.parallel`` ``phe2hb``, ``pge2tb``, their
back-transforms and band gathers, ``pheev``, ``psvd``, and the
distributed middle ``dist_stedc.pstedc`` / ``dist_svd.dist_band_svd``)
against the JAX package's, on the same numpy inputs made from seeds.

* One 2×2 gloo spawn of CPU processes (``parallel.launch.run_spmd``) runs
  :func:`~slate_tpu_torch.parallel.launch.rank_twostage` once per case
  (its pins and snapshot budget set per job), while the JAX drivers run
  on a 2×2 mesh of the virtual CPU devices in this process under the
  same pins: the kernel route of the chase is ``chase=kernel`` in the
  port (the wrappers' plain versions on the CPU) and
  ``chase=pallas_wavefront`` in the JAX package (interpret mode); the
  spill branch runs under a 10-kB snapshot budget in both (a snapshot
  is 24 kB at n = 90, kd = 16).
* Sizes: n = 96 at nb 16, psvd also at (128, 96); the odd n = 90 in
  the spill cases (the distributed middle) and the band gathers.
  ``pheev`` in fp64, complex128 and fp32 on the replicated stage 2 (the
  default below n = 2048) and with ``stedc_dist``, values only too;
  ``psvd`` in fp64 with ``svd_dist`` and replicated, complex128
  replicated, values only, and a rank-2-deficient input for the
  near-null repair; ``pstedc`` alone at n = 700 (host cut-off 128) and
  the clustered n = 512 of ``tests/test_dist_twostage.py``.
* Gates: factors, T blocks, band tiles and back-transforms within 1e-10
  relative (fp64, complex128) and 1e-4 (fp32); values within 1e-10 of
  the largest (fp32 input: 1e-5, its stage 1 runs in fp32); residual and
  orthogonality ≤ 10 in n·ε units; vectors equal to the JAX package's
  up to a per-column sign or phase where the value's gap to its
  neighbours exceeds 1e-6 of the largest; every rank's values bitwise
  equal.  The band gathers are bitwise on the same tiles.
"""

import concurrent.futures

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from slate_tpu.linalg import _chase as jchase
from slate_tpu.parallel import dist_twostage as jtwo
from slate_tpu.parallel.mesh import make_grid_mesh as jmake_grid_mesh
from slate_tpu.perf import autotune as jauto

from slate_tpu_torch import parallel as tpar
from slate_tpu_torch.parallel import dist_twostage as ttwo
from slate_tpu_torch.parallel.launch import rank_twostage, run_spmd

NB = 16
JAX_FORCE = "SLATE_TPU_AUTOTUNE_FORCE"
LAUNCH = "slate_tpu_torch.parallel.launch"
#: the chase's kernel route pinned in each package
KERNEL = ("chase=kernel", "chase=pallas_wavefront")
TOL = {np.float32: 1e-4, np.float64: 1e-10, np.complex128: 1e-10}
VAL_TOL = {np.float32: 1e-5, np.float64: 1e-10, np.complex128: 1e-10}
DIST_EIG = {"stedc_dist": True}
DIST_SVD = {"svd_dist": True}

#: name -> (op, dtype, shape, seed, extra); extra: opts, jobz/jobu/jobvt,
#: route ("kernel" pins both packages' kernel route), budget_mb, rank
CASES = {
    "phe2hb-f64-96": ("phe2hb", np.float64, (96, 96), 1, {}),
    "phe2hb-c128-96": ("phe2hb", np.complex128, (96, 96), 3, {}),
    "phe2hb-f32-96": ("phe2hb", np.float32, (96, 96), 4, {}),
    "pge2tb-f64-128x96": ("pge2tb", np.float64, (128, 96), 5, {}),
    "pge2tb-c128-128x96": ("pge2tb", np.complex128, (128, 96), 7, {}),
    "pge2tb-f32-128x96": ("pge2tb", np.float32, (128, 96), 8, {}),
    "pheev-f64-96": ("pheev", np.float64, (96, 96), 11, {}),
    "pheev-c128-96": ("pheev", np.complex128, (96, 96), 13, {}),
    "pheev-f32-96": ("pheev", np.float32, (96, 96), 14, {}),
    "pheev-f64-96-values": ("pheev", np.float64, (96, 96), 15,
                            {"jobz": False}),
    "pheev-f64-96-dist-host": ("pheev", np.float64, (96, 96), 16,
                               {"opts": DIST_EIG}),
    "pheev-f64-96-dist-kernel": ("pheev", np.float64, (96, 96), 17,
                                 {"opts": DIST_EIG, "route": "kernel"}),
    "pheev-f64-90-dist-kernel-spill": ("pheev", np.float64, (90, 90), 18,
                                       {"opts": DIST_EIG, "route": "kernel",
                                        "budget_mb": 0.01}),
    "pheev-c128-96-dist": ("pheev", np.complex128, (96, 96), 19,
                           {"opts": DIST_EIG}),
    "pheev-f32-96-dist-kernel": ("pheev", np.float32, (96, 96), 20,
                                 {"opts": DIST_EIG, "route": "kernel"}),
    "psvd-f64-128x96-dist-host": ("psvd", np.float64, (128, 96), 21,
                                  {"opts": DIST_SVD}),
    "psvd-f64-128x96-dist-kernel": ("psvd", np.float64, (128, 96), 22,
                                    {"opts": DIST_SVD, "route": "kernel"}),
    "psvd-f64-90-dist-kernel-spill": ("psvd", np.float64, (90, 90), 23,
                                      {"opts": DIST_SVD, "route": "kernel",
                                       "budget_mb": 0.01}),
    "psvd-f64-128x96": ("psvd", np.float64, (128, 96), 24, {}),
    "psvd-c128-128x96": ("psvd", np.complex128, (128, 96), 26, {}),
    "psvd-f64-128x96-values": ("psvd", np.float64, (128, 96), 27,
                               {"jobu": False, "jobvt": False}),
    "psvd-f64-128x96-rank94-dist": ("psvd", np.float64, (128, 96), 28,
                                    {"opts": DIST_SVD, "rank": 94}),
    "pstedc-700": ("pstedc", np.float64, (700,), 3, {"host_cutoff": 128}),
    "pstedc-512-clustered": ("pstedc", np.float64, (512,), 4,
                             {"host_cutoff": 128, "clustered": True}),
}


def _draw(rng, shape, dtype):
    x = rng.standard_normal(shape)
    if np.issubdtype(dtype, np.complexfloating):
        x = x + 1j * rng.standard_normal(shape)
    return x


def _inputs(name):
    """The numpy inputs of a case (both packages get these)."""
    op, dt, shape, seed, extra = CASES[name]
    rng = np.random.default_rng(seed)
    if op == "pstedc":
        n = shape[0]
        if extra.get("clustered"):
            d = np.repeat(rng.standard_normal(8), 64)
            return {"d": d, "e": 1e-8 * rng.standard_normal(n - 1)}
        return {"d": rng.standard_normal(n), "e": rng.standard_normal(n - 1)}
    if op in ("phe2hb", "pheev"):
        a = _draw(rng, shape, dt)
        a = ((a + a.conj().T) / 2).astype(dt)
    else:
        a = _draw(rng, shape, dt)
        if "rank" in extra:                 # singular values 0 past rank
            u, s, vh = np.linalg.svd(a, full_matrices=False)
            s[extra["rank"]:] = 0
            a = (u * s) @ vh
        a = a.astype(dt)
    inp = {"a": a}
    if op == "phe2hb":
        inp["z"] = _draw(rng, (shape[0], 5), dt).astype(dt)
    if op == "pge2tb":
        inp["zq"] = _draw(rng, (shape[0], 5), dt).astype(dt)
        inp["zp"] = _draw(rng, (shape[1], 4), dt).astype(dt)
    return inp


def _port_job(name):
    op, _, _, _, extra = CASES[name]
    job = dict(_inputs(name), op=op, nb=NB)
    for key in ("opts", "jobz", "jobu", "jobvt", "budget_mb",
                "host_cutoff"):
        if key in extra:
            job[key] = extra[key]
    if extra.get("route") == "kernel":
        job["force"] = KERNEL[0]
    return job


def _jax_case(mesh, name):
    from slate_tpu.parallel import (band_tiles_to_banded, band_tiles_to_dense,
                                    distribute, pge2tb, phe2hb, pheev, psvd,
                                    punmbr_ge2tb_p, punmbr_ge2tb_q,
                                    punmtr_he2hb, undistribute)
    from slate_tpu.parallel.dist_stedc import pstedc

    op, _, _, _, extra = CASES[name]
    inp = _inputs(name)

    def und(x):
        return None if x is None else np.asarray(undistribute(x))

    def dist(x):
        return distribute(jnp.asarray(x), mesh, NB, row_mult=2, col_mult=2)

    if op == "phe2hb":
        n = inp["a"].shape[0]
        fac, tmats, tiles = phe2hb(dist(inp["a"]))
        zd = dist(inp["z"])
        return {"fac": und(fac), "tmats": np.asarray(tmats),
                "tiles": np.asarray(tiles),
                "dense": band_tiles_to_dense(tiles, n, NB),
                "banded": band_tiles_to_banded(tiles, n, NB),
                "qz": und(punmtr_he2hb(fac, tmats, zd)),
                "qhz": und(punmtr_he2hb(fac, tmats, zd, forward=False))}
    if op == "pge2tb":
        n = inp["a"].shape[1]
        fac, qt, pt, tiles = pge2tb(dist(inp["a"]))
        zq, zp = dist(inp["zq"]), dist(inp["zp"])
        return {"fac": und(fac), "qtmats": np.asarray(qt),
                "ptmats": np.asarray(pt), "tiles": np.asarray(tiles),
                "dense": band_tiles_to_dense(tiles, n, NB, lower=False),
                "banded": band_tiles_to_banded(tiles, n, NB, lower=False),
                "qz": und(punmbr_ge2tb_q(fac, qt, zq)),
                "qhz": und(punmbr_ge2tb_q(fac, qt, zq, forward=False)),
                "pz": und(punmbr_ge2tb_p(fac, pt, zp)),
                "phz": und(punmbr_ge2tb_p(fac, pt, zp, forward=False))}
    if op == "pheev":
        w, z = pheev(jnp.asarray(inp["a"]), mesh, NB,
                     jobz=extra.get("jobz", True), opts=extra.get("opts"))
        return {"w": np.asarray(w), "z": und(z)}
    if op == "psvd":
        s, u, v = psvd(jnp.asarray(inp["a"]), mesh, NB,
                       jobu=extra.get("jobu", True),
                       jobvt=extra.get("jobvt", True), opts=extra.get("opts"))
        return {"s": np.asarray(s), "u": und(u), "v": und(v)}
    w, q = pstedc(inp["d"], inp["e"], mesh, host_cutoff=extra["host_cutoff"])
    return {"w": np.asarray(w), "q": np.asarray(q)}


@pytest.fixture(scope="module")
def runs():
    """Every case: ONE 2×2 gloo spawn running the port's jobs (in a
    thread) while the JAX drivers run on the 2×2 mesh here."""
    jm = jmake_grid_mesh(2, 2, devices=np.asarray(jax.devices()[:4]))
    jobs = [(LAUNCH + ":rank_twostage", (_port_job(name),)) for name in CASES]
    ref = {}
    mp = pytest.MonkeyPatch()
    budget = jchase._SNAP_BUDGET_BYTES
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawn = pool.submit(run_spmd, LAUNCH + ":rank_jobs", 2, 2, (jobs,),
                            backend="gloo", device="cpu", timeout=1200)
        try:
            for name, (_, _, _, _, extra) in CASES.items():
                if extra.get("route") == "kernel":
                    mp.setenv(JAX_FORCE, KERNEL[1])
                else:
                    mp.delenv(JAX_FORCE, raising=False)
                jchase._SNAP_BUDGET_BYTES = (extra["budget_mb"] * 1e6
                                             if "budget_mb" in extra
                                             else budget)
                jauto.reset_table()
                ref[name] = _jax_case(jm, name)
        finally:
            jchase._SNAP_BUDGET_BYTES = budget
            jauto.reset_table()
            mp.undo()
        out = spawn.result()
    return {name: (ref[name], [rank[i] for rank in out])
            for i, name in enumerate(CASES)}


def _rel(x, ref):
    ref = np.asarray(ref)
    d = np.linalg.norm(np.asarray(x).astype(ref.dtype) - ref)
    return float(d / np.linalg.norm(ref)) if np.linalg.norm(ref) else float(d)


def _eps(dt):
    return float(np.finfo(dt).eps)


def _same_vectors(z, zref, w, tol):
    """Columns of z equal to zref's up to a sign or phase where w's gap to
    its neighbours exceeds 1e-6 of max|w|; returns how many were held."""
    w = np.asarray(w, np.float64)
    scale = max(np.abs(w).max(), 1.0)
    gaps = np.full(w.size, np.inf)
    gaps[1:] = np.minimum(gaps[1:], np.abs(np.diff(w)))
    gaps[:-1] = np.minimum(gaps[:-1], np.abs(np.diff(w)))
    held = 0
    for j in np.flatnonzero(gaps > 1e-6 * scale):
        c = np.vdot(zref[:, j], z[:, j])
        ph = c / abs(c) if abs(c) else 1.0
        err = np.linalg.norm(z[:, j] - ph * zref[:, j])
        assert err <= tol, (j, err, gaps[j] / scale)
        held += 1
    return held


def _ranks_agree(ranks, keys):
    for got in ranks[1:]:
        for key in keys:
            if ranks[0][key] is None:
                assert got[key] is None, key
            else:
                assert np.array_equal(got[key], ranks[0][key]), key


REDUCE = [n for n in CASES if CASES[n][0] in ("phe2hb", "pge2tb")]
EIG = [n for n in CASES if CASES[n][0] == "pheev"]
SVD = [n for n in CASES if CASES[n][0] == "psvd"]
STEDC = [n for n in CASES if CASES[n][0] == "pstedc"]


@pytest.mark.parametrize("name", REDUCE)
def test_reductions_match_jax(runs, name):
    """phe2hb / pge2tb: the factor, T blocks, band tiles, both band
    assemblies and the back-transforms both ways, on every rank."""
    op, dt = CASES[name][:2]
    ref, ranks = runs[name]
    keys = [k for k in ref if k in ranks[0]]
    assert len(keys) == len(ref)
    for got in ranks:
        for key in keys:
            assert got[key].shape == ref[key].shape, key
            assert _rel(got[key], ref[key]) <= TOL[dt], (key, _rel(
                got[key], ref[key]))
    _ranks_agree(ranks, keys)
    # the band has A's spectrum (a unitary congruence / equivalence)
    a = _inputs(name)["a"].astype(np.complex128)
    band = ranks[0]["dense"].astype(np.complex128)
    if op == "phe2hb":
        got, want = np.linalg.eigvalsh(band), np.linalg.eigvalsh(a)
    else:
        got = np.linalg.svd(band, compute_uv=False)
        want = np.linalg.svd(a, compute_uv=False)
    assert np.abs(got - want).max() <= 100 * a.shape[0] * _eps(dt) * \
        np.abs(want).max()


#: the band gathers at an odd n on tiles drawn from a seed (lower, seed):
#: the odd n's factors run inside the spill cases at n = 90
GATHER_ODD = {"phe2hb-f64-90": (True, 2), "pge2tb-f64-90": (False, 6)}


@pytest.mark.parametrize("name", ["phe2hb-f64-90", "phe2hb-c128-96",
                                  "pge2tb-f64-128x96", "pge2tb-f64-90"])
def test_band_gathers_bitwise(runs, name):
    """``band_tiles_to_dense`` / ``_banded`` on the same tiles (the JAX
    package's own at n = 96; drawn from a seed at the odd n = 90):
    bitwise the JAX package's assemblies."""
    if name in GATHER_ODD:
        lower, seed = GATHER_ODD[name]
        n = 90
        tiles = np.random.default_rng(seed).standard_normal(
            (-(-n // NB), 2, NB, NB))
        ref = {"tiles": tiles,
               "dense": jtwo.band_tiles_to_dense(tiles, n, NB, lower),
               "banded": jtwo.band_tiles_to_banded(tiles, n, NB, lower)}
    else:
        ref = runs[name][0]
        lower = CASES[name][0] == "phe2hb"
        n = CASES[name][2][1]
    assert np.array_equal(ttwo.band_tiles_to_dense(ref["tiles"], n, NB,
                                                   lower), ref["dense"])
    banded = ttwo.band_tiles_to_banded(ref["tiles"], n, NB, lower)
    assert banded.dtype == ref["banded"].dtype
    assert np.array_equal(banded, ref["banded"])


@pytest.mark.parametrize("name", EIG)
def test_pheev_matches_jax(runs, name):
    _, dt, shape, _, extra = CASES[name]
    n = shape[0]
    ref, ranks = runs[name]
    a = _inputs(name)["a"].astype(np.complex128)
    scale = np.abs(ref["w"]).max()
    eps = _eps(dt)
    for got in ranks:
        assert np.abs(got["w"] - ref["w"]).max() <= VAL_TOL[dt] * scale
    _ranks_agree(ranks, ("w", "z"))
    if not extra.get("jobz", True):
        assert ranks[0]["z"] is None and ref["z"] is None
        return
    z, w = ranks[0]["z"].astype(np.complex128), ranks[0]["w"]
    assert z.shape == (n, n)
    res = np.linalg.norm(a @ z - z * w[None, :]) / (
        np.linalg.norm(a) * n * eps)
    orth = np.linalg.norm(z.conj().T @ z - np.eye(n)) / (n * eps)
    assert res <= 10 and orth <= 10, (res, orth)
    held = _same_vectors(z, ref["z"].astype(np.complex128), w,
                         1e4 * n * eps)
    assert held >= n // 2


@pytest.mark.parametrize("name", SVD)
def test_psvd_matches_jax(runs, name):
    _, dt, (m, n), _, extra = CASES[name]
    ref, ranks = runs[name]
    a = _inputs(name)["a"].astype(np.complex128)
    eps = _eps(dt)
    for got in ranks:
        assert np.abs(got["s"] - ref["s"]).max() <= VAL_TOL[dt] * ref["s"][0]
    _ranks_agree(ranks, ("s", "u", "v"))
    got = ranks[0]
    if not extra.get("jobu", True):
        assert got["u"] is None and got["v"] is None
        return
    s = got["s"]
    u = got["u"].astype(np.complex128)[:, :n]
    v = got["v"].astype(np.complex128)
    assert got["u"].shape == (m, n) and v.shape == (n, n)
    rec = np.linalg.norm(a - (u * s) @ v.conj().T) / (
        np.linalg.norm(a) * n * eps)
    ou = np.linalg.norm(u.conj().T @ u - np.eye(n)) / (n * eps)
    ov = np.linalg.norm(v.conj().T @ v - np.eye(n)) / (n * eps)
    assert rec <= 10 and ou <= 10 and ov <= 10, (rec, ou, ov)
    # the null space of a rank-deficient input has no unique basis
    live = s > 1e-8 * s[0]
    held = _same_vectors(u[:, live], ref["u"][:, :n][:, live], s[live],
                         1e4 * n * eps)
    held += _same_vectors(v[:, live], ref["v"][:, live], s[live],
                          1e4 * n * eps)
    assert held >= n


@pytest.mark.parametrize("name", STEDC)
def test_pstedc_matches_jax(runs, name):
    ref, ranks = runs[name]
    inp = _inputs(name)
    d, e = inp["d"], inp["e"]
    n = d.size
    eps = _eps(np.float64)
    for got in ranks:
        assert np.abs(got["w"] - ref["w"]).max() <= 1e-10 * max(
            np.abs(ref["w"]).max(), 1.0)
    _ranks_agree(ranks, ("w", "q"))
    q, w = ranks[0]["q"], ranks[0]["w"]
    t = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    res = np.linalg.norm(t @ q - q * w[None, :]) / (
        max(np.linalg.norm(t), 1.0) * n * eps)
    orth = np.linalg.norm(q.T @ q - np.eye(n)) / (n * eps)
    assert res <= 10 and orth <= 10, (res, orth)
    _same_vectors(q, ref["q"], w, 1e4 * n * eps)


@pytest.mark.parametrize("name", [n for n in CASES
                                  if CASES[n][4].get("route") == "kernel"])
def test_chase_routes_take_the_pins(runs, name):
    """The ``chase`` site answers the pinned kernel route (its plain
    version on the CPU: no launch counted); the 10-kB budget spills the
    snapshots to the host, counted into ``chase.host_bytes``, and the
    kernel route moves nothing otherwise."""
    kind = "hb2st" if CASES[name][0] == "pheev" else "tb2bd"
    # the decision table is the process's: this job's key has its n
    key = "chase|%s,%d,%d,float64," % (kind, CASES[name][2][1], NB)
    for got in runs[name][1]:
        hits = {v for k, v in got["decisions"].items() if k.startswith(key)}
        assert hits == {"kernel"}, got["decisions"]
        assert not got["launches"], got["launches"]
        spill = "budget_mb" in CASES[name][4]
        assert (got["host_bytes"] > 0) == spill, got["host_bytes"]


def test_default_routes_on_the_cpu(runs):
    """Unpinned, the CPU takes the host chase on the distributed middle,
    as the JAX package off its chip."""
    for name, kind in (("pheev-f64-96-dist-host", "hb2st"),
                       ("psvd-f64-128x96-dist-host", "tb2bd")):
        got = runs[name][1][0]
        key = "chase|%s,96,%d,float64,cpu" % (kind, NB)
        assert got["decisions"][key] == "host_native", name
        assert got["host_bytes"] > 0


@pytest.mark.parametrize("name", ["pheev-f64-96-dist-kernel",
                                  "psvd-f64-128x96-dist-kernel",
                                  "pheev-c128-96"])
def test_serial_stub_matches_jax(runs, name):
    """The 1×1 grid with no process group, in this process, against the
    JAX drivers' 2×2 results."""
    dt = CASES[name][1]
    ref = runs[name][0]
    got = rank_twostage(tpar.make_grid_mesh(1, 1, device="cpu"),
                        _port_job(name))
    key = "w" if "w" in ref else "s"
    assert np.abs(got[key] - ref[key]).max() <= VAL_TOL[dt] * np.abs(
        ref[key]).max()


def test_refusals():
    mesh = tpar.make_grid_mesh(1, 1, device="cpu")
    rng = np.random.default_rng(5)
    wide = rng.standard_normal((64, 96))
    with pytest.raises(ValueError, match="m >= n"):
        tpar.psvd(wide, mesh, NB)
    with pytest.raises(ValueError, match="m >= n"):
        tpar.pge2tb(tpar.distribute(wide, mesh, NB))
    with pytest.raises(ValueError, match="square"):
        tpar.phe2hb(tpar.distribute(wide, mesh, NB))


def test_exports_and_driver_wrapping():
    """The nine names, the seven drivers wrapped for user tile maps as
    the JAX package wraps them (``slate_tpu/parallel/__init__.py:62-63``)."""
    names = ("phe2hb", "pge2tb", "pheev", "psvd", "punmtr_he2hb",
             "punmbr_ge2tb_q", "punmbr_ge2tb_p", "band_tiles_to_dense",
             "band_tiles_to_banded")
    for nm in names:
        assert hasattr(tpar, nm), nm
        wrapped = hasattr(getattr(tpar, nm), "__wrapped_driver__")
        assert wrapped == hasattr(getattr(jtwo, nm), "__wrapped_driver__"), nm


def test_chase_chunk_bounds_match_jax():
    from slate_tpu.linalg.eig import _hb_sweep_counts as jcounts
    from slate_tpu_torch.linalg.eig import _hb_sweep_counts as tcounts

    for n, kd in ((96, 16), (2048, 256), (16384, 256)):
        want = jtwo.chase_chunk_bounds(jcounts(n, kd), n - 2, n, kd)
        assert ttwo.chase_chunk_bounds(tcounts(n, kd), n - 2, n, kd) == want
    # 16384 at kd 256: 8 chunks, so 16 chase launches a pheev
    assert len(ttwo.chase_chunk_bounds(tcounts(16384, 256), 16382, 16384,
                                       256)) - 1 == 8


@pytest.mark.parametrize("budget_mb", [None, 1])
def test_snapshot_budget_matches_jax(budget_mb, monkeypatch):
    """``snapshots_fit_device`` answers as the JAX package's, at the
    default 2048-MB budget and under ``launch.snapshot_budget``."""
    from slate_tpu_torch.linalg import _chase as tchase
    from slate_tpu_torch.parallel.launch import snapshot_budget

    if budget_mb is not None:
        monkeypatch.setattr(jchase, "_SNAP_BUDGET_BYTES", budget_mb * 1e6)
    cases = [(n * kd * 8, c) for n in (2048, 16384, 65536)
             for kd in (16, 256) for c in (0, 1, 8, 11)]
    with snapshot_budget(budget_mb):
        got = [tchase.snapshots_fit_device(b, c) for b, c in cases]
    assert got == [jchase.snapshots_fit_device(b, c) for b, c in cases]
    assert tchase._SNAP_BUDGET_BYTES == 2048e6


def test_snapshot_spill_round_trip_counts_host_bytes():
    """A spilled snapshot comes back bitwise, and the store and the
    restore each count its bytes into ``chase.host_bytes``, as in the JAX
    package."""
    import torch

    from slate_tpu.perf import metrics as jmetrics
    from slate_tpu_torch.linalg import _chase as tchase
    from slate_tpu_torch.perf import metrics as tmetrics

    band = np.random.default_rng(9).standard_normal((90, 34))
    counted = []
    for mod, store, restore in (
            (tmetrics, tchase.snapshot_store, lambda a: tchase.snapshot_restore(
                a, "cpu")),
            (jmetrics, jchase.snapshot_store, jchase.snapshot_restore)):
        was = mod.enabled()
        mod.on()
        try:
            before = mod.snapshot()["counters"].get("chase.host_bytes", 0.0)
            arg = torch.from_numpy(band.copy()) if mod is tmetrics \
                else jnp.asarray(band)
            back = np.asarray(restore(store(arg)))
            counted.append(mod.snapshot()["counters"]["chase.host_bytes"]
                           - before)
        finally:
            if not was:
                mod.off()
        assert np.array_equal(back, band)
    assert counted == [2.0 * band.nbytes] * 2


def test_move_places_rows_and_gathers():
    """``dist_util._move`` on the serial stub: rows held out of order move
    to column slabs and to an every-rank (gather) destination with each
    entry at its place, and the rows no rank holds stay zero."""
    import torch

    from slate_tpu_torch.parallel import dist_util
    from slate_tpu_torch.parallel.launch import _gather_rows

    mesh = tpar.make_grid_mesh(1, 1, device="cpu")
    a = np.random.default_rng(4).standard_normal((12, 7))
    rows = np.array([9, 2, 5, 0, 11])
    x = torch.from_numpy(a[rows])
    want = np.zeros_like(a)
    want[rows] = a[rows]
    assert np.array_equal(_gather_rows(mesh, x, rows, 12).numpy(), want)
    assert np.array_equal(dist_util._rows_to_cols(mesh, x, rows, 12, 7)
                          .numpy(), want)
    sub = dist_util._move(mesh, x, rows, np.arange(7),
                          lambda d: (np.array([0, 5, 9]), np.array([1, 6])))
    assert np.array_equal(sub.numpy(), a[[0, 5, 9]][:, [1, 6]])
