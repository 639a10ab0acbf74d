"""The port's distributed QDWH tier (``slate_tpu_torch.parallel``
``ppolar``, ``pheev_qdwh``, ``psvd_qdwh``) against the JAX package's, on
the same numpy inputs made from seeds — the first CPU check of
``slate_tpu/parallel/dist_qdwh.py`` against anything.

* One 2×2 gloo spawn of CPU processes runs
  :func:`~slate_tpu_torch.parallel.launch.rank_qdwh` for every case and a
  1×2 spawn runs the fp64 drivers at their default steps at once
  (p ≠ q), while the JAX drivers run on a 2×2 mesh of the virtual CPU
  devices in this process under the same pins.
* n = 64 at nb = 16: ``ppolar`` in fp64 and fp32 at the default step
  variants (QR, then Cholesky) and with each ``qdwh_step`` variant pinned
  in both packages; ``pheev_qdwh`` in fp64 and fp32 at a
  ``qdwh_crossover`` of 40 (one split, then the leaves); ``psvd_qdwh``
  square, and rectangular (80 × 64: the single-device fallback and its
  ``RuntimeWarning``).
* Gates: U and H within 1e-10 relative (fp32: 1e-4) of the JAX
  package's (the polar factor of a nonsingular A is unique); values and
  σ within 1e-10 of the largest (fp32: 1e-5); vectors equal to the JAX
  package's up to a per-column sign where the value's gap to its
  neighbours exceeds 1e-6 of the largest; residual and orthogonality ≤
  10 in n·ε units; the pinned variant the only one taken; every rank's
  results bitwise equal.
* The serial stub in process: ``ppolar`` against the single-device
  ``polar``, and the refusals.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from slate_tpu.parallel.mesh import make_grid_mesh as jmake_grid_mesh
from slate_tpu.perf import autotune as jauto

from slate_tpu_torch import parallel as tpar
from slate_tpu_torch.parallel.launch import run_spmd

N, NB, CROSSOVER = 64, 16, 40
JAX_FORCE = "SLATE_TPU_AUTOTUNE_FORCE"
LAUNCH = "slate_tpu_torch.parallel.launch"
TOL = {np.float32: 1e-4, np.float64: 1e-10}
VAL_TOL = {np.float32: 1e-5, np.float64: 1e-10}
SPLIT = {"qdwh_crossover": CROSSOVER}

#: name -> (op, dtype, shape, seed, pin, opts)
CASES = {
    "ppolar-f64": ("ppolar", np.float64, (N, N), 61, None, None),
    "ppolar-f32": ("ppolar", np.float32, (N, N), 62, None, None),
    "ppolar-f64-qr": ("ppolar", np.float64, (N, N), 61, "qdwh_step=qr",
                      None),
    "ppolar-f64-chol": ("ppolar", np.float64, (N, N), 61, "qdwh_step=chol",
                        None),
    "pheev_qdwh-f64": ("pheev_qdwh", np.float64, (N, N), 63, None, SPLIT),
    "pheev_qdwh-f32": ("pheev_qdwh", np.float32, (N, N), 64, None, SPLIT),
    "psvd_qdwh-f64": ("psvd_qdwh", np.float64, (N, N), 65, None, SPLIT),
    "psvd_qdwh-f64-80x64": ("psvd_qdwh", np.float64, (80, N), 66, None,
                            None),
}
#: the spawns and the cases each runs
GRIDS = {(2, 2): list(CASES),
         (1, 2): ["ppolar-f64", "pheev_qdwh-f64", "psvd_qdwh-f64"]}


def _input(name):
    op, dt, shape, seed, _, _ = CASES[name]
    a = np.random.default_rng(seed).standard_normal(shape)
    if op == "pheev_qdwh":
        a = (a + a.T) / 2
    return a.astype(dt)


def _jobs(names):
    jobs = []
    for name in names:
        op, _, _, _, pin, opts = CASES[name]
        jobs.append((LAUNCH + ":rank_qdwh", (dict(
            op=op, a=_input(name), nb=NB, opts=opts, force=pin),)))
    return jobs


def _jax_case(mesh, name):
    import warnings

    from slate_tpu.parallel import (pheev_qdwh, ppolar, psvd_qdwh,
                                    undistribute)

    op, _, _, _, _, opts = CASES[name]
    a = jnp.asarray(_input(name))
    if op == "ppolar":
        u, h = ppolar(a, mesh, NB, opts)
        return {"u": np.asarray(u), "h": np.asarray(h)}
    if op == "pheev_qdwh":
        w, z = pheev_qdwh(a, mesh, NB, opts=opts)
        return {"w": np.asarray(w), "z": np.asarray(undistribute(z))}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        s, u, vh = psvd_qdwh(a, mesh, NB, opts=opts)
    return {"s": np.asarray(s), "u": np.asarray(undistribute(u)),
            "vh": np.asarray(undistribute(vh))}


@pytest.fixture(scope="module")
def runs():
    """The 2×2 and 1×2 spawns (in threads) while the JAX drivers run on
    the 2×2 mesh here under the same pins."""
    mp = pytest.MonkeyPatch()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        spawns = {grid: pool.submit(run_spmd, LAUNCH + ":rank_jobs", *grid,
                                    (_jobs(names),), backend="gloo",
                                    device="cpu", timeout=600)
                  for grid, names in GRIDS.items()}
        jm = jmake_grid_mesh(2, 2, devices=np.asarray(jax.devices()[:4]))
        ref = {}
        try:
            for name, (_, _, _, _, pin, _) in CASES.items():
                if pin:
                    mp.setenv(JAX_FORCE, pin)
                else:
                    mp.delenv(JAX_FORCE, raising=False)
                jauto.reset_table()
                ref[name] = _jax_case(jm, name)
        finally:
            jauto.reset_table()
            mp.undo()
        out = {grid: f.result() for grid, f in spawns.items()}
    return {name: (ref[name], {
        grid: [rank[GRIDS[grid].index(name)] for rank in ranks]
        for grid, ranks in out.items() if name in GRIDS[grid]})
        for name in CASES}


def _rel(x, ref):
    ref = np.asarray(ref)
    d = np.linalg.norm(np.asarray(x).astype(ref.dtype) - ref)
    return float(d / np.linalg.norm(ref)) if np.linalg.norm(ref) else float(d)


def _ranks_agree(ranks, keys):
    for got in ranks[1:]:
        for key in keys:
            assert np.array_equal(got[key], ranks[0][key]), key


def _same_vectors(z, zref, w, tol):
    """Columns of z equal to zref's up to a sign where w's gap to its
    neighbours exceeds 1e-6 of max|w|; returns how many were held."""
    w = np.asarray(w, np.float64)
    scale = max(np.abs(w).max(), 1.0)
    gaps = np.full(w.size, np.inf)
    gaps[1:] = np.minimum(gaps[1:], np.abs(np.diff(w)))
    gaps[:-1] = np.minimum(gaps[:-1], np.abs(np.diff(w)))
    held = 0
    for j in np.flatnonzero(gaps > 1e-6 * scale):
        c = np.vdot(zref[:, j], z[:, j])
        ph = c / abs(c) if abs(c) else 1.0
        assert np.linalg.norm(z[:, j] - ph * zref[:, j]) <= tol, j
        held += 1
    return held


def _eps(dt):
    return float(np.finfo(dt).eps)


NAMES = list(CASES)


@pytest.mark.parametrize("name,grid", [
    (n, g) for n in NAMES if CASES[n][0] == "ppolar" for g in GRIDS
    if n in GRIDS[g]], ids=lambda x: "%dx%d" % x if isinstance(x, tuple)
    else x)
def test_ppolar_matches_jax(runs, name, grid):
    """U and H against the JAX package's; UᵀU = I and U·H = A; a pinned
    step variant is the only one taken, the default takes both."""
    _, dt, _, _, pin, _ = CASES[name]
    ref, ranks = runs[name][0], runs[name][1][grid]
    a = _input(name).astype(np.float64)
    for got in ranks:
        for key in ("u", "h"):
            assert got[key].dtype == dt
            assert _rel(got[key], ref[key]) <= TOL[dt], (key, _rel(
                got[key], ref[key]))
    _ranks_agree(ranks, ("u", "h"))
    u, h = ranks[0]["u"].astype(np.float64), ranks[0]["h"].astype(np.float64)
    assert np.linalg.norm(u.T @ u - np.eye(N)) <= 10 * N * _eps(dt)
    assert np.linalg.norm(u @ h - a) <= 10 * N * _eps(dt) * np.linalg.norm(a)
    steps = {k.rpartition(".")[2]: v for k, v in ranks[0]["counters"].items()
             if k.startswith("qdwh.step.")}
    if pin:
        assert set(steps) == {pin.split("=")[1]}, steps
    else:
        assert set(steps) == {"qr", "chol"}, steps


@pytest.mark.parametrize("name,grid", [
    (n, g) for n in NAMES if CASES[n][0] == "pheev_qdwh" for g in GRIDS
    if n in GRIDS[g]], ids=lambda x: "%dx%d" % x if isinstance(x, tuple)
    else x)
def test_pheev_qdwh_matches_jax(runs, name, grid):
    """w ascending against the JAX package's and eigvalsh, Z up to a sign
    a column; the crossover of 40 splits the 64 once (the trace counts
    agreed over the grid); residual and orthogonality."""
    dt = CASES[name][1]
    ref, ranks = runs[name][0], runs[name][1][grid]
    a = _input(name).astype(np.float64)
    lam = np.linalg.eigvalsh(a)
    scale = np.abs(lam).max()
    for got in ranks:
        assert got["w"].dtype == dt and got["z"].dtype == dt
        assert np.all(np.diff(got["w"]) >= 0)
        assert np.abs(got["w"] - ref["w"]).max() <= VAL_TOL[dt] * scale
        assert np.abs(got["w"] - lam).max() <= VAL_TOL[dt] * scale
        # the interval and a shift's trace at the root, one of each a
        # leaf's parent: three agreements at least
        assert got["counters"]["collective.qdwh_agree.count"] >= 3
    _ranks_agree(ranks, ("w", "z"))
    w, z = ranks[0]["w"].astype(np.float64), ranks[0]["z"].astype(np.float64)
    assert _same_vectors(z, ref["z"].astype(np.float64), w,
                         1e4 * N * _eps(dt)) >= N // 2
    assert np.linalg.norm(a @ z - z * w) <= 10 * N * _eps(dt) * scale
    assert np.linalg.norm(z.T @ z - np.eye(N)) <= 10 * N * _eps(dt)


@pytest.mark.parametrize("name,grid", [
    (n, g) for n in NAMES if CASES[n][0] == "psvd_qdwh" for g in GRIDS
    if n in GRIDS[g]], ids=lambda x: "%dx%d" % x if isinstance(x, tuple)
    else x)
def test_psvd_qdwh_matches_jax(runs, name, grid):
    """σ descending against the JAX package's and svdvals, U and Vᴴ up to
    a sign a singular pair, A = U·Σ·Vᴴ; the rectangular operand takes
    the single-device fallback with its warning."""
    ref, ranks = runs[name][0], runs[name][1][grid]
    a = _input(name)
    m, n = a.shape
    sref = np.linalg.svd(a, compute_uv=False)
    for got in ranks:
        assert np.all(np.diff(got["s"]) <= 0)
        assert np.abs(got["s"] - ref["s"]).max() <= 1e-10 * sref[0]
        assert np.abs(got["s"] - sref).max() <= 1e-10 * sref[0]
        assert bool(got["warnings"]) == (m != n)
        if m != n:
            assert "rectangular operand" in got["warnings"][0]
    _ranks_agree(ranks, ("s", "u", "vh"))
    s, u, vh = ranks[0]["s"], ranks[0]["u"], ranks[0]["vh"]
    assert u.shape == ref["u"].shape and vh.shape == ref["vh"].shape
    assert _same_vectors(u, ref["u"], s, 1e6 * n * _eps(np.float64)) \
        >= n // 2
    assert _same_vectors(vh.T, ref["vh"].T, s,
                         1e6 * n * _eps(np.float64)) >= n // 2
    assert np.linalg.norm(a - (u * s) @ vh) \
        <= 10 * n * _eps(np.float64) * sref[0]


@pytest.mark.parametrize("dtype", list(TOL), ids=lambda d: np.dtype(d).name)
def test_ppolar_serial_stub_matches_polar(dtype):
    """On the 1×1 serial stub ppolar is the single-device polar: U and H
    within TOL."""
    from slate_tpu_torch.linalg.polar import polar

    a = torch.from_numpy(_input("ppolar-f64").astype(dtype))
    mesh = tpar.make_grid_mesh(1, 1, device="cpu")
    u, h = tpar.ppolar(a, mesh, NB)
    u1, h1 = polar(a, {"block_size": NB}, device="cpu")
    assert _rel(u.numpy(), u1.numpy()) <= TOL[dtype]
    assert _rel(h.numpy(), h1.numpy()) <= TOL[dtype]


def test_refusals():
    """A dense operand needs a mesh; the distributed drivers are
    square-only (but psvd_qdwh's fallback)."""
    mesh = tpar.make_grid_mesh(1, 1, device="cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        tpar.ppolar(torch.eye(8, dtype=torch.float64))
    with pytest.raises(ValueError, match="requires a square matrix"):
        tpar.pheev_qdwh(torch.zeros((8, 6), dtype=torch.float64), mesh, 4)
