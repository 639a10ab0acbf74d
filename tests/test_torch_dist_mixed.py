"""The port's distributed mixed-precision drivers, ``pgetri`` and
``pgecondest``, and the resilience paths of ``pgetrf``/``ppotrf`` (the
measured timeline, step checkpoints, the ABFT envelope), on a 2×2 gloo grid
of spawned CPU processes (ONE spawn: :func:`~slate_tpu_torch.parallel.
launch.rank_dist_mixed`), against the JAX drivers on a 2×2 mesh of the
virtual CPU devices, on the same numpy inputs made from seeds.

* ``pposv_mixed``, ``pposv_mixed_gmres`` and ``pgesv_mixed`` (fp64, n =
  192, nb = 32, one right-hand side): the solutions within 1e-10 relative
  of the JAX package's, the tester's residual ≤ 3, the iteration counts
  positive (no fallback) and within 1 of the JAX package's (FGMRES's
  steps move with the Krylov vectors' roundoff, as the single-device
  tests allow);
* ``pgetri``: within 1e-10 relative of the JAX package's inverse and
  ‖A·X − I‖_F < 1e-9·n (``tests/test_dist_gaps.py``'s gate);
  ``pgecondest``: the estimate within 1e-8 relative of the JAX package's
  and 0.1·κ₁ ≤ 1/rcond ≤ 3·κ₁ (its bounds);
* pgetrf and ppotrf (fp64, n = 256, nb = 32, tournament pivots, a ring
  of depth 2): the monolithic factors within 1e-12 of the JAX package's
  and gperm equal; run by timeline windows of 3 steps, bitwise the
  monolithic factors and gperm on every rank, one row a window; with
  checkpoints every 2 steps and one injected device loss, bitwise
  resumed and ``ckpt.restored`` = 1 on every rank; under
  ``SLATE_TPU_TORCH_ABFT=correct`` clean (one check each, nothing
  detected); each envelope handed a factor with one flipped exponent bit
  on rank (0, 0) detects it on EVERY rank and recomputes.
* Every rank's replicated results are bitwise equal.
"""

import functools
import random

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from slate_tpu.parallel.mesh import make_grid_mesh as jmake_grid_mesh

from slate_tpu_torch.parallel.launch import run_spmd

LAUNCH = "slate_tpu_torch.parallel.launch"
N, NB = 192, 32
RES_N = 256
WINDOW, EVERY = 3, 2
FORCE = "dist_lookahead=2,dist_pivot=tournament"
EPS = np.finfo(np.float64).eps


def _inputs():
    rng = np.random.default_rng(61)
    g = rng.standard_normal((N, N))
    spd = g @ g.T / N + np.eye(N)
    gen = rng.standard_normal((N, N)) + 2.0 * np.sqrt(N) * np.eye(N)
    b = rng.standard_normal((N, 1))
    rng = np.random.default_rng(62)
    g = rng.standard_normal((RES_N, RES_N))
    rspd = g @ g.T / RES_N + np.eye(RES_N)
    rgen = rng.standard_normal((RES_N, RES_N))
    return spd, gen, b, rspd, rgen


def _loss_seed():
    """A seed whose first ``step.boundary`` firing (rate 0.5) is the second
    boundary, so the loss rewinds to a snapshot, not to the input."""
    return next(s for s in range(1000) if [
        random.Random("%d|step.boundary|%d" % (s, i)).random() < 0.5
        for i in range(2)] == [False, True])


def _jax(spd, gen, b, rspd, rgen):
    from slate_tpu.enums import Norm
    from slate_tpu.parallel import (distribute, pgecondest, pgesv_mixed,
                                    pgetrf, pgetri, pnorm, ppotrf,
                                    pposv_mixed, pposv_mixed_gmres,
                                    undistribute)

    mesh = jmake_grid_mesh(2, 2, devices=np.asarray(jax.devices()[:4]))
    sq = dict(diag_pad=1.0, row_mult=2, col_mult=2)
    ref = {}
    x, it = pposv_mixed(jnp.asarray(spd), jnp.asarray(b), mesh, NB)
    ref["posv"] = (np.asarray(undistribute(x)), it)
    x, it = pposv_mixed_gmres(jnp.asarray(spd), jnp.asarray(b), mesh, NB)
    ref["posv_gmres"] = (np.asarray(x), it)
    x, it = pgesv_mixed(jnp.asarray(gen), jnp.asarray(b), mesh, NB)
    ref["gesv"] = (np.asarray(undistribute(x)), it)
    gd = distribute(jnp.asarray(gen), mesh, NB, **sq)
    ref["getri"] = np.asarray(undistribute(pgetri(gd)))
    lu, gperm = pgetrf(gd)
    ref["condest"] = pgecondest(lu, gperm, float(pnorm(gd, Norm.One)))
    rg = distribute(jnp.asarray(rgen), mesh, NB, **sq)
    lu, gperm = pgetrf(rg)
    ref["lu"] = np.asarray(undistribute(lu))
    ref["gperm"] = np.asarray(gperm)
    rs = distribute(jnp.asarray(rspd), mesh, NB, **sq)
    ref["l"] = np.tril(np.asarray(undistribute(ppotrf(rs))))
    return ref


@pytest.fixture(scope="module")
def jax_check_vma_off():
    """The JAX drivers' ``shard_map`` builds with ``check_vma=False`` under
    this JAX (their lookahead carries mix replicated and varying values),
    for this module only; the builds are dropped afterwards."""
    import importlib

    mods = [importlib.import_module("slate_tpu.parallel." + m) for m in
            ("dist_factor", "dist_lu", "dist_aux", "dist_blas3", "dist_util")]
    mods = [m for m in mods if hasattr(m, "shard_map")]
    saved = [m.shard_map for m in mods]
    sm = functools.partial(jax.shard_map, check_vma=False)

    def clear():
        for m in mods:
            for name in dir(m):
                fn = getattr(m, name)
                if name.startswith("_build") and hasattr(fn, "cache_clear"):
                    fn.cache_clear()

    for m in mods:
        m.shard_map = sm
    clear()
    try:
        yield
    finally:
        for m, f in zip(mods, saved):
            m.shard_map = f
        clear()


@pytest.fixture(scope="module")
def runs(monkeypatch_module, jax_check_vma_off):
    spd, gen, b, rspd, rgen = _inputs()
    jobs = [(LAUNCH + ":rank_dist_mixed",
             ({"op": "mixed", "spd": spd, "gen": gen, "b": b, "nb": NB},)),
            (LAUNCH + ":rank_dist_mixed",
             ({"op": "resilience", "spd": rspd, "gen": rgen, "nb": NB,
               "force": FORCE, "window": WINDOW, "every": EVERY,
               "seed": _loss_seed()},))]
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(run_spmd, LAUNCH + ":rank_jobs", 2, 2, (jobs,),
                          backend="gloo", device="cpu", timeout=600)
        monkeypatch_module.setenv("SLATE_TPU_AUTOTUNE_FORCE", FORCE)
        ref = _jax(spd, gen, b, rspd, rgen)
        ranks = fut.result()
    return {"ref": ref, "mixed": [r[0] for r in ranks],
            "res": [r[1] for r in ranks],
            "inputs": (spd, gen, b, rspd, rgen)}


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _rel(x, ref):
    return float(np.linalg.norm(np.asarray(x) - ref) / np.linalg.norm(ref))


def _resid(a, x, b):
    return float(np.linalg.norm(a @ x - b)
                 / (np.linalg.norm(a) * np.linalg.norm(x) * a.shape[0] * EPS))


@pytest.mark.parametrize("name", ["posv", "posv_gmres", "gesv"])
def test_mixed_drivers_match_jax(runs, name):
    spd, gen, b = runs["inputs"][:3]
    a = gen if name == "gesv" else spd
    x_ref, it_ref = runs["ref"][name]
    for r in runs["mixed"]:
        x, it = r[name]
        assert x.shape == (N, 1) and _rel(x, x_ref) <= 1e-10
        assert _resid(a, x, b) <= 3
        assert it > 0 and abs(it - it_ref) <= 1, (it, it_ref)
        assert np.array_equal(x, runs["mixed"][0][name][0])


def test_pgetri_matches_jax(runs):
    gen = runs["inputs"][1]
    for r in runs["mixed"]:
        inv = r["getri"]
        assert _rel(inv, runs["ref"]["getri"]) <= 1e-10
        assert np.linalg.norm(gen @ inv - np.eye(N)) < 1e-9 * N
        assert np.array_equal(inv, runs["mixed"][0]["getri"])


def test_pgecondest_matches_jax(runs):
    gen = runs["inputs"][1]
    kappa = np.linalg.norm(gen, 1) * np.linalg.norm(np.linalg.inv(gen), 1)
    rc_ref, est_ref = runs["ref"]["condest"]
    for r in runs["mixed"]:
        rcond, est = r["condest"]
        assert abs(est - est_ref) <= 1e-8 * est_ref
        assert 0.1 * kappa <= 1.0 / rcond <= 3.0 * kappa
        assert r["condest"] == runs["mixed"][0]["condest"]


def _gather(shards, n, nb, p=2, q=2):
    """The natural-order n×n matrix of the four ranks' block-cyclic
    shards (row-major rank order)."""
    ml, nl = shards[0].shape[0] // nb, shards[0].shape[1] // nb
    full = np.zeros((p * ml * nb, q * nl * nb))
    for rank, s in enumerate(shards):
        r, c = divmod(rank, q)
        for il in range(ml):
            for jl in range(nl):
                i, j = il * p + r, jl * q + c
                full[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb] = \
                    s[il * nb:(il + 1) * nb, jl * nb:(jl + 1) * nb]
    return full[:n, :n]


def test_monolithic_factors_match_jax(runs):
    res = runs["res"]
    lu = _gather([r["mono"][0] for r in res], RES_N, NB)
    l = np.tril(_gather([r["mono"][2] for r in res], RES_N, NB))
    assert np.abs(lu - runs["ref"]["lu"]).max() <= \
        1e-12 * np.abs(runs["ref"]["lu"]).max()
    assert np.abs(l - runs["ref"]["l"]).max() <= \
        1e-12 * np.abs(runs["ref"]["l"]).max()
    for r in res:
        assert np.array_equal(r["mono"][1][:RES_N], runs["ref"]["gperm"])


@pytest.mark.parametrize("path", ["timeline", "ckpt", "abft"])
def test_chunked_and_guarded_runs_are_bitwise(runs, path):
    nt = RES_N // NB
    for r in runs["res"]:
        got, mono = r[path], r["mono"]
        assert all(np.array_equal(x, y) for x, y in zip(got, mono)), path
        if path == "timeline":
            assert r["timeline_rows"] == -(-nt // WINDOW)
        if path == "ckpt":
            c = r["ckpt_counters"]
            assert c["ckpt.restored"] == c["abft.restarted"] == 1
            assert c["ckpt.saved"] >= 1
        if path == "abft":
            assert r["abft_counters"] == {"abft.checks": 2}


def test_abft_envelopes_detect_on_every_rank(runs):
    for r in runs["res"]:
        for name, ref in (("abft_lu_detect", r["mono"][0]),
                          ("abft_chol_detect", r["mono"][2])):
            c = r[name + "_counters"]
            assert c == {"abft.checks": 2, "abft.detected": 1,
                         "abft.recomputed": 1}, (name, c)
            assert np.array_equal(r[name], ref)
