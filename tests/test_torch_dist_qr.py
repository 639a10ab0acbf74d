"""The port's distributed QR family (``slate_tpu_torch.parallel`` ``pgeqrf``,
``punmqr_conj``, ``pgels``, ``pgelqf``, ``punmlq``) against the JAX
package's, on the same numpy inputs made from seeds.

* One 2×2 gloo spawn of CPU processes (``parallel.launch.run_spmd``) runs
  :func:`~slate_tpu_torch.parallel.launch.rank_qr` once per
  configuration (its pins set per job), while the JAX drivers run on a
  2×2 mesh of the virtual CPU devices in this process under the same
  pins: ``dist_panel=xla`` in fp64, complex128 and fp32, at lookahead
  depth 1 and 2; ``dist_panel=pallas_panel`` (the CholQR² panel) in fp32
  at depth 1 and 2; ``dist_chunk`` 1 and 2 at depth 2, which must agree
  bitwise.  The shapes are (256, 96) (nb 32) and a ragged (250, 90),
  whose zero pad columns trip the CholQR² guard in both packages.
  Factors, T blocks, τ, Qᴴ·B, x, the LQ factor and Q̃·C both ways within
  1e-4 relative (fp32) and 1e-10 (fp64, complex128); x's
  normal-equations residual at rounding level.
* The refusals (m < n, a B padded unlike the factor), the serial stub
  (1×1, no process group) in process, and the ``dist_panel`` site for
  ``"geqrf"``.

The JAX package's ``pallas_panel`` rung calls Pallas kernels inside
``shard_map``, which this JAX's varying-axes check refuses; the fixture
builds its ``dist_qr`` ``shard_map`` with ``check_vma=False`` for this
module and drops those builds afterwards.
"""

import concurrent.futures
import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from slate_tpu.parallel import dist_qr as jqr
from slate_tpu.parallel.mesh import make_grid_mesh as jmake_grid_mesh
from slate_tpu.perf import autotune as jauto

from slate_tpu_torch import parallel as tpar
from slate_tpu_torch.parallel import dist_util
from slate_tpu_torch.parallel.launch import rank_qr, run_spmd
from slate_tpu_torch.perf import autotune as tauto

NB = 32
JAX_FORCE = "SLATE_TPU_AUTOTUNE_FORCE"
LAUNCH = "slate_tpu_torch.parallel.launch"
TOL = {np.float32: 1e-4, np.float64: 1e-10, np.complex128: 1e-10}
SHAPES = {"tiles": (256, 96), "ragged": (250, 90)}
#: (pins, [(dtype, shape)]) of each configuration, both packages alike
CONFIGS = {
    "xla": ("dist_panel=xla,dist_lookahead=1,dist_chunk=whole",
            [(np.float64, "tiles"), (np.float64, "ragged"),
             (np.complex128, "tiles"), (np.complex128, "ragged"),
             (np.float32, "tiles")]),
    "xla_depth2": ("dist_panel=xla,dist_lookahead=2,dist_chunk=whole",
                   [(np.float64, "tiles")]),
    "pallas_panel": ("dist_panel=pallas_panel,dist_lookahead=1,"
                     "dist_chunk=whole",
                     [(np.float32, "tiles"), (np.float32, "ragged")]),
    "pallas_panel_depth2": ("dist_panel=pallas_panel,dist_lookahead=2,"
                            "dist_chunk=whole", [(np.float32, "tiles")]),
    "pallas_panel_depth2_chunk2": ("dist_panel=pallas_panel,"
                                   "dist_lookahead=2,dist_chunk=2",
                                   [(np.float32, "tiles")]),
}
CASES = [(name, dt, shape) for name, (_, cases) in CONFIGS.items()
         for dt, shape in cases]
KEYS = ("qr", "tmats", "taus", "qtb", "x", "lq", "lq_tmats", "lq_taus",
        "qc", "qhc")


def _rel(x, ref):
    ref = np.asarray(ref)
    d = np.linalg.norm(np.asarray(x).astype(ref.dtype) - ref)
    return float(d / np.linalg.norm(ref)) if np.linalg.norm(ref) else float(d)


def _inputs(dtype, shape):
    """(a, b, wide, c): a tall m×n, b m×3, the wide n×m (pgelqf's A) and
    c m×4 (rows in the wide matrix's column space), from seed 91."""
    m, n = SHAPES[shape]
    rng = np.random.default_rng(91)

    def draw(*s):
        x = rng.standard_normal(s)
        if np.issubdtype(dtype, np.complexfloating):
            x = x + 1j * rng.standard_normal(s)
        return x.astype(dtype)

    return draw(m, n), draw(m, 3), draw(n, m), draw(m, 4)


@pytest.fixture(scope="module")
def jax_check_vma_off():
    saved = jqr.shard_map
    jqr.shard_map = functools.partial(jax.shard_map, check_vma=False)
    try:
        yield
    finally:
        jqr.shard_map = saved
        for fn in (jqr._build_pgeqrf, jqr._build_punmqr,
                   jqr._build_patch_diag_tail):
            fn.cache_clear()


def _jax_qr(mesh, a, b, wide, c):
    from slate_tpu.parallel import (distribute, pgelqf, pgels, pgeqrf,
                                    punmlq, punmqr_conj, undistribute)

    def und(x):
        return np.asarray(undistribute(x))

    qr, tmats, taus = pgeqrf(distribute(jnp.asarray(a), mesh, NB,
                                        row_mult=2, col_mult=2))
    qtb = punmqr_conj(qr, tmats, distribute(jnp.asarray(b), mesh, NB,
                                             row_mult=2))
    _, _, x = pgels(jnp.asarray(a), jnp.asarray(b), mesh, nb=NB)
    lq, ltm, ltau = pgelqf(distribute(jnp.asarray(wide), mesh, NB,
                                      row_mult=2, col_mult=2))
    cd = distribute(jnp.asarray(c), mesh, NB, row_mult=2)
    return {"qr": und(qr), "tmats": np.asarray(tmats),
            "taus": np.asarray(taus), "qtb": und(qtb), "x": und(x),
            "lq": und(lq), "lq_tmats": np.asarray(ltm),
            "lq_taus": np.asarray(ltau), "qc": und(punmlq(lq, ltm, cd)),
            "qhc": und(punmlq(lq, ltm, cd, adjoint=True))}


@pytest.fixture(scope="module")
def runs(jax_check_vma_off):
    """Every configuration: ONE 2×2 gloo spawn running the port's jobs (in
    a thread) while the JAX drivers run on the 2×2 mesh here."""
    jm = jmake_grid_mesh(2, 2, devices=np.asarray(jax.devices()[:4]))
    jobs = [(LAUNCH + ":rank_qr", _inputs(dt, shape) + (NB, CONFIGS[name][0]))
            for name, dt, shape in CASES]
    ref = {}
    mp = pytest.MonkeyPatch()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawn = pool.submit(run_spmd, LAUNCH + ":rank_jobs", 2, 2, (jobs,),
                            backend="gloo", device="cpu", timeout=300)
        try:
            for name, dt, shape in CASES:
                mp.setenv(JAX_FORCE, CONFIGS[name][0])
                jauto.reset_table()
                ref[name, dt, shape] = _jax_qr(jm, *_inputs(dt, shape))
        finally:
            jauto.reset_table()
            mp.undo()
        out = spawn.result()
    return {case: (ref[case], [rank[i] for rank in out])
            for i, case in enumerate(CASES)}


@pytest.mark.parametrize("case", CASES, ids=lambda c: "%s-%s-%s" % (
    c[0], np.dtype(c[1]).name, c[2]))
def test_qr_family_matches_jax(runs, case):
    name, dt, shape = case
    ref, ranks = runs[case]
    for got in ranks:
        for key in KEYS:
            assert got[key].shape == ref[key].shape, key
            assert _rel(got[key], ref[key]) <= TOL[dt], (
                key, _rel(got[key], ref[key]))
        # every rank holds the same replicated results
        for key in KEYS:
            assert np.array_equal(got[key], ranks[0][key]), key
    a, b, _, _ = _inputs(dt, shape)
    x = ranks[0]["x"].astype(np.complex128)
    ad = a.astype(np.complex128)
    res = np.linalg.norm(ad.conj().T @ (ad @ x - b)) / (
        np.linalg.norm(ad) ** 2 * np.linalg.norm(x))
    assert res < 10 * np.finfo(dt).eps * np.sqrt(a.shape[0]), res


@pytest.mark.parametrize("case", CASES, ids=lambda c: "%s-%s-%s" % (
    c[0], np.dtype(c[1]).name, c[2]))
def test_qr_sites_take_the_pins(runs, case):
    name, dt, shape = case
    want = dict(kv.split("=") for kv in CONFIGS[name][0].split(","))
    if dt != np.float32:
        want["dist_panel"] = "xla"          # the CholQR² rung is fp32 only
    got = runs[case][1][0]
    # the decision table is the process's: this job's keys are those of
    # its dtype, which it wrote last
    dtn = np.dtype(dt).name
    for site, rung in want.items():
        hits = {v for k, v in got["decisions"].items()
                if k.startswith(site + "|geqrf") and "," + dtn + "," in k}
        assert hits == {rung}, (site, got["decisions"])
    # on the CPU the wrappers run their plain versions: no launch counted
    assert not any(got["launches"].values())
    # the ragged pad columns make a singular CholQR² Gram: the guard reruns
    # the Householder panel (once a factorization, at its last panel)
    pallas = want["dist_panel"] == "pallas_panel"
    assert (got["reruns"] > 0) == (pallas and shape == "ragged"), \
        got["reruns"]


@pytest.mark.parametrize("panel", ["pallas_panel"])
def test_dist_chunk_is_bitwise(runs, panel):
    """Each element rides exactly one psum whatever the slices."""
    whole = runs["%s_depth2" % panel, np.float32, "tiles"][1]
    sliced = runs["%s_depth2_chunk2" % panel, np.float32, "tiles"][1]
    for w, s in zip(whole, sliced):
        for key in KEYS:
            assert np.array_equal(w[key], s[key]), key


def test_serial_stub_matches_jax(runs):
    """The 1×1 grid with no process group, in this process, against the
    JAX drivers' 2×2 results (fp64: the factors are unique)."""
    for shape in SHAPES:
        ref = runs["xla", np.float64, shape][0]
        got = rank_qr(tpar.make_grid_mesh(1, 1, device="cpu"),
                      *_inputs(np.float64, shape), NB)
        for key in KEYS:
            assert _rel(got[key], ref[key]) <= 1e-10, (shape, key)


def test_qr_refusals():
    mesh = tpar.make_grid_mesh(1, 1, device="cpu")
    rng = np.random.default_rng(5)
    wide = tpar.distribute(rng.standard_normal((64, 96)), mesh, NB)
    with pytest.raises(ValueError, match="m >= n"):
        tpar.pgeqrf(wide)
    tall = tpar.distribute(rng.standard_normal((96, 64)), mesh, NB)
    qr, tmats, _ = tpar.pgeqrf(tall)
    short = tpar.distribute(rng.standard_normal((64, 2)), mesh, NB)
    with pytest.raises(ValueError, match="must match the factor"):
        tpar.punmqr_conj(qr, tmats, short)
    lq, ltm, _ = tpar.pgelqf(wide)
    with pytest.raises(ValueError, match="must match the factor"):
        tpar.punmlq(lq, ltm, short, adjoint=True)


def test_geqrf_dist_panel_site(monkeypatch):
    """The JAX package keeps the Householder panel for geqrf on its chip
    (``op != "geqrf"``); the port answers alike on the card: ``xla`` by
    default, ``pallas_panel`` under the pin or with kernels on, ``xla``
    for fp64 (ineligible), and never ``pallas_fused``."""
    from slate_tpu_torch import config

    monkeypatch.delenv(tauto.FORCE_ENV, raising=False)
    f32, f64 = torch.float32, torch.float64
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    panel = dist_util.dist_panel_backend
    assert panel("geqrf", 256, f32, cuda) == "xla"
    assert panel("geqrf", 32, f32, cpu) == "xla"
    monkeypatch.setenv(tauto.FORCE_ENV, "dist_panel=pallas_panel")
    assert panel("geqrf", 256, f32, cuda) == "pallas_panel"
    assert panel("geqrf", 32, f32, cpu) == "pallas_panel"
    assert panel("geqrf", 32, f64, cpu) == "xla"
    assert tauto.decisions(with_reasons=True)[
        "dist_panel|geqrf,32,float64,cpu"] == ("xla", "ineligible")
    monkeypatch.setenv(tauto.FORCE_ENV, "dist_panel=pallas_fused")
    with pytest.warns(UserWarning):
        assert panel("geqrf", 256, f32, cuda) == "xla"
    monkeypatch.delenv(tauto.FORCE_ENV)
    monkeypatch.setattr(config, "use_kernels", True)
    assert panel("geqrf", 256, f32, cuda) == "pallas_panel"
    assert panel("potrf", 256, f32, cuda, m=16384) == "pallas_fused"
    monkeypatch.setattr(config, "use_kernels", False)
    assert panel("geqrf", 256, f32, cuda) == "xla"


def test_pgels_gates_on_the_serial_stub():
    """``chip_smoke.py``'s ``rank_pgels`` (the card's config-4 run and its
    gates) on a small input in this process, under both rungs."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    mesh = tpar.make_grid_mesh(1, 1, device="cpu")
    for force in ("dist_panel=xla", "dist_panel=pallas_panel"):
        res = smoke.rank_pgels(mesh, 512, 128, NB, 3, reps=1, force=force)
        for key in ("gram", "orthogonality", "reconstruction",
                    "normal_equations"):
            assert 0 <= res["gates"][key] <= 3, (force, res["gates"])
        assert res["reruns"] == 0
        assert min(res["pgeqrf_ms"], res["pgels_ms"], res["pgeqrf_first_ms"],
                   res["pgels_first_ms"]) > 0
