"""The port's out-of-core tile pool and drivers
(``slate_tpu_torch.ops.tilepool``, ``slate_tpu_torch.linalg.ooc``)
against the JAX package's, on the same numpy inputs made from seeds, at
n = 128 with 32-tiles (a 4×4 grid), fp32 and fp64.

* The residency protocol: LRU order, exact dirty write-back, prefetch
  hits, the two-way byte odometer, no ``ooc.*`` key with metrics off, and
  the resident tiles' storage bounded by the window (a tile put as a row
  slice of a strip is copied to its own storage).
* Traffic: every ``ooc.*`` counter of getrf_ooc and potrf_ooc equal to
  the JAX package's at (capacity, depth) = (2, 0), (3, 2) and all
  resident; the forced windows' factors bitwise the all-resident ones.
* Values: getrf's permutation equal to the JAX package's on a Gaussian
  and on a Gaussian + 2√n·I, factors within 1e-12 (fp64) or 1e-4 of the
  largest entry (fp32); potrf's factor likewise.
* Dispatch: gesv and posv through the forced ``ooc`` site (the census
  shows ``pool``, the tester's residual ≤ 3), ``SLATE_TPU_TORCH_OOC=0``
  never pools, complex64 and a one-tile matrix stay in core; the site's
  analytic answer on a card under a budget knob.
* Checkpoints: an injected ``device_loss`` resumes bitwise the
  uninterrupted run.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slate_tpu.linalg import ooc as jooc
from slate_tpu.ops import tilepool as jtilepool
from slate_tpu.perf import metrics as jmetrics
from slate_tpu.resilience import inject as jinject

import slate_tpu_torch as st
from slate_tpu_torch import config
from slate_tpu_torch.linalg import cholesky as chol_mod
from slate_tpu_torch.linalg import lu as lu_mod
from slate_tpu_torch.linalg import ooc
from slate_tpu_torch.ops import kernels, tilepool
from slate_tpu_torch.perf import autotune, metrics
from slate_tpu_torch.resilience import inject

N, NB = 128, 32
#: (capacity, depth): the forced windows and all resident (16 tiles)
WINDOWS = [(2, 0), (3, 2), (64, 4)]
DTYPES = [np.float32, np.float64]


@pytest.fixture(autouse=True)
def _clean():
    for m in (metrics, jmetrics):
        m.reset()
        m.off()
    inject.clear_plan()
    jinject.clear_plan()
    yield
    for m in (metrics, jmetrics):
        m.reset()
        m.off()
    inject.clear_plan()
    jinject.clear_plan()


def _gauss(n, dtype, seed, shift=True):
    a = np.random.default_rng(seed).standard_normal((n, n))
    if shift:
        a = a + 2.0 * np.sqrt(n) * np.eye(n)
    return a.astype(dtype)


def _spd(n, dtype, seed):
    g = np.random.default_rng(seed).standard_normal((n, n))
    return (g @ g.T / n + np.eye(n)).astype(dtype)


def _ooc_counters(m):
    return {k: v for k, v in m.snapshot()["counters"].items()
            if k.startswith(("ooc.", "ckpt."))}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# The residency protocol
# ---------------------------------------------------------------------------

def test_lru_eviction_order_matches_jax():
    a = _gauss(96, np.float32, 0)
    events = []
    for m, pool in ((metrics, tilepool.TilePool(_t(a), 32, 2, 0)),
                    (jmetrics, jtilepool.TilePool(a, 32, 2, 0))):
        m.on()
        trace = []
        for key in ((0, 0), (0, 1), (0, 2), (0, 1), (1, 0)):
            pool.get(*key)
            trace.append(tuple(pool._resident))
        events.append((trace, _ooc_counters(m)))
    assert events[0] == events[1]
    trace, counts = events[0]
    assert trace[2] == ((0, 1), (0, 2)) and trace[4] == ((0, 1), (1, 0))
    assert counts["ooc.evictions"] == 2.0


def test_dirty_write_back_exact():
    a = _gauss(96, np.float32, 0)
    pool = tilepool.TilePool(_t(a), 32, capacity=2, depth=0)
    fresh = _t(np.random.default_rng(3).standard_normal((32, 32))
               .astype(np.float32))
    pool.put(1, 1, fresh)
    # host memory is stale until the flush, then exactly the tile
    assert not torch.equal(pool.host[1, 1], fresh)
    pool.flush()
    assert torch.equal(pool.host[1, 1], fresh)
    other = fresh + 1.0
    pool.put(2, 2, other)
    pool.get(0, 0)
    pool.get(0, 1)               # evicts the dirty (2, 2)
    assert (2, 2) not in pool._resident
    assert torch.equal(pool.host[2, 2], other)
    want = a.copy()
    want[32:64, 32:64] = fresh.numpy()
    want[64:96, 64:96] = other.numpy()
    assert np.array_equal(pool.array().numpy(), want)


def test_prefetch_hit_accounting():
    metrics.on()
    pool = tilepool.TilePool(_t(_gauss(96, np.float32, 0)), 32, 4, 2)
    assert pool.prefetch([(0, 0), (0, 1), (0, 2)]) == 2   # depth-capped
    pool.get(0, 0)
    pool.get(0, 1)
    c = _ooc_counters(metrics)
    assert c.get("ooc.prefetch.hits") == 2.0
    assert "ooc.prefetch.misses" not in c
    pool.get(0, 2)
    assert _ooc_counters(metrics).get("ooc.prefetch.misses") == 1.0


def test_bytes_odometer_counts_both_directions():
    metrics.on()
    pool = tilepool.TilePool(_t(_gauss(64, np.float64, 0)), 32, 4, 0)
    tb = pool.tile_bytes
    assert tb == 32 * 32 * 8
    pool.get(0, 0)
    pool.put(0, 0, pool.get(0, 0) * 2.0)
    pool.flush()
    assert pool.bytes_moved == 2 * tb
    assert pool.host_gb_transferred() == pytest.approx(2 * tb / 1e9)
    assert _ooc_counters(metrics) == {"ooc.host_bytes": 2.0 * tb,
                                      "ooc.prefetch.misses": 1.0,
                                      "ooc.write_backs": 1.0}


def test_metrics_off_records_nothing():
    pool = tilepool.TilePool(_t(_gauss(96, np.float32, 0)), 32, 2, 1)
    pool.prefetch([(0, 0)])
    pool.get(0, 0)
    pool.put(0, 1, pool.get(0, 1))
    pool.flush()
    ooc.getrf_ooc(_t(_gauss(N, np.float32, 1)), nb=NB, capacity=2,
                  device="cpu")
    snap = metrics.snapshot()
    assert not any(k.startswith("ooc.") for k in snap["counters"])
    assert not any(k.startswith("ooc.") for k in snap["timers"])


def test_ragged_grid_pads_and_trims():
    a = np.random.default_rng(5).standard_normal((70, 45))
    pool = tilepool.TilePool(_t(a), 32, 2, 0)
    assert (pool.gi, pool.gj) == (3, 2)
    assert torch.equal(pool.host[2, 1][6:], torch.zeros(26, 32,
                                                        dtype=torch.float64))
    assert np.array_equal(pool.array().numpy(), a)


def test_resident_storage_bounded_by_the_window():
    """A row slice of a strip put as a tile is copied to its own storage,
    so the window bounds the resident bytes."""
    pool = tilepool.TilePool(_t(_gauss(N, np.float32, 0)), NB, 3, 0)
    strip = torch.cat([pool.get(i, 0) for i in range(4)], dim=0)
    for t in range(4):
        pool.put(t, 0, strip[t * NB:(t + 1) * NB])
    total = sum(v.untyped_storage().nbytes() for v in pool._resident.values())
    assert len(pool._resident) == 3
    assert total <= pool.capacity * pool.tile_bytes
    # and through a whole factorization, at every put
    seen = []
    real = tilepool.TilePool.put

    def put(self, i, j, dev):
        real(self, i, j, dev)
        seen.append(sum(v.untyped_storage().nbytes()
                        for v in self._resident.values()))

    tilepool.TilePool.put = put
    try:
        ooc.getrf_ooc(_t(_gauss(N, np.float32, 1)), nb=NB, capacity=3,
                      device="cpu")
    finally:
        tilepool.TilePool.put = real
    assert seen and max(seen) <= 3 * NB * NB * 4


# ---------------------------------------------------------------------------
# Traffic and values against the JAX package
# ---------------------------------------------------------------------------

def _run_both(driver, a, cap, dep):
    """The port's and the JAX package's driver on ``a`` at (cap, dep):
    (port result, port counters, JAX result, JAX counters)."""
    out = []
    for m, fn, x in ((metrics, getattr(ooc, driver), _t(a)),
                     (jmetrics, getattr(jooc, driver), jnp.asarray(a))):
        m.reset()
        m.on()
        kw = {"device": "cpu"} if m is metrics else {}
        res = fn(x, nb=NB, capacity=cap, depth=dep, **kw)
        m.off()
        out += [res, _ooc_counters(m)]
    return out


@pytest.fixture(scope="module")
def lu_runs():
    """getrf_ooc of the shifted Gaussian (seed 0) at every window and
    dtype, both packages."""
    return {(dt, w): _run_both("getrf_ooc", _gauss(N, dt, 0), *w)
            for dt in DTYPES for w in WINDOWS}


@pytest.fixture(scope="module")
def chol_runs():
    return {(dt, w): _run_both("potrf_ooc", _spd(N, dt, 1), *w)
            for dt in DTYPES for w in WINDOWS}


@pytest.mark.parametrize("window", WINDOWS, ids=lambda w: "cap%d_d%d" % w)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("driver", ["getrf", "potrf"])
def test_counters_equal_jax(lu_runs, chol_runs, driver, dtype, window):
    runs = lu_runs if driver == "getrf" else chol_runs
    _, got, _, want = runs[dtype, window]
    assert got == want
    assert got["ooc.write_backs"] > 0


@pytest.mark.parametrize("window", WINDOWS[:2], ids=lambda w: "cap%d_d%d" % w)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_forced_window_bitwise_all_resident(lu_runs, chol_runs, dtype,
                                            window):
    (lu, perm), _, _, _ = lu_runs[dtype, window]
    (lu0, perm0), _, _, _ = lu_runs[dtype, WINDOWS[-1]]
    assert torch.equal(lu, lu0) and torch.equal(perm, perm0)
    l, _, _, _ = chol_runs[dtype, window]
    l0, _, _, _ = chol_runs[dtype, WINDOWS[-1]]
    assert torch.equal(l, l0)


def _factor_tol(dtype, ref):
    return (1e-12 if dtype == np.float64 else 1e-4) * float(np.abs(ref).max())


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_getrf_matches_jax(lu_runs, dtype):
    (lu, perm), _, (jlu, jperm), _ = lu_runs[dtype, WINDOWS[1]]
    assert lu.dtype == torch.float32 if dtype == np.float32 \
        else lu.dtype == torch.float64
    assert np.array_equal(perm.numpy(), np.asarray(jperm))
    jlu = np.asarray(jlu)
    assert float(np.abs(lu.numpy() - jlu).max()) <= _factor_tol(dtype, jlu)
    a = _gauss(N, dtype, 0).astype(np.float64)
    f = lu.numpy().astype(np.float64)
    lmat = np.tril(f, -1) + np.eye(N)
    eps = np.finfo(dtype).eps
    assert np.abs(a[perm.numpy()] - lmat @ np.triu(f)).max() \
        / (np.abs(a).max() * N * eps) < 3.0


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_getrf_pivots_gaussian_match_jax(dtype):
    """An unshifted Gaussian: the pivots travel off the diagonal."""
    a = _gauss(N, dtype, 4, shift=False)
    lu, perm = ooc.getrf_ooc(_t(a), nb=NB, capacity=3, depth=2,
                             device="cpu")
    jlu, jperm = jooc.getrf_ooc(jnp.asarray(a), nb=NB, capacity=3, depth=2)
    assert not np.array_equal(perm.numpy(), np.arange(N))
    assert np.array_equal(perm.numpy(), np.asarray(jperm))
    jlu = np.asarray(jlu)
    assert float(np.abs(lu.numpy() - jlu).max()) <= _factor_tol(dtype, jlu)


def test_tall_panels_keep_partial_pivoting_on_kernel_leaves(monkeypatch):
    """A panel taller than the tall loop's threshold that the scattered
    driver cannot take factors through the recursion on
    ``getrf_panel_linv`` leaves (true partial pivoting), not the Auto
    tall loop's tournament: with the threshold lowered to 128 rows, the
    first panel of a 256-row Gaussian in 128-tiles reaches the leaf at
    its full height, and the permutation is the JAX package's and
    LAPACK's."""
    monkeypatch.setattr(lu_mod, "_MAX_LU_PANEL_ROWS", 128)
    heights = []
    real = kernels.getrf_panel_linv

    def leaf(slab, *args, **kw):
        heights.append(int(slab.shape[1]))
        return real(slab, *args, **kw)

    monkeypatch.setattr(kernels, "getrf_panel_linv", leaf)
    a = _gauss(256, np.float32, 6, shift=False)
    lu, perm = ooc.getrf_ooc(_t(a), nb=128, capacity=2, depth=0,
                             device="cpu")
    jlu, jperm = jooc.getrf_ooc(jnp.asarray(a), nb=128, capacity=2, depth=0)
    assert heights == [256, 128]
    assert np.array_equal(perm.numpy(), np.asarray(jperm))
    assert torch.equal(perm, lu_mod._lu_perm(_t(a))[1])
    jlu = np.asarray(jlu)
    assert float(np.abs(lu.numpy() - jlu).max()) <= _factor_tol(np.float32,
                                                                jlu)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_potrf_matches_jax(chol_runs, dtype):
    l, _, jl, _ = chol_runs[dtype, WINDOWS[1]]
    jl = np.asarray(jl)
    assert float(np.abs(l.numpy() - jl).max()) <= _factor_tol(dtype, jl)
    assert torch.equal(l, torch.tril(l))
    a = _spd(N, dtype, 1).astype(np.float64)
    f = l.numpy().astype(np.float64)
    assert np.linalg.norm(f @ f.T - a) / (
        np.linalg.norm(a) * np.finfo(dtype).eps * N) < 3.0


def test_to_device_false_returns_host_tensors():
    lu, perm = ooc.getrf_ooc(_gauss(N, np.float32, 0), nb=NB, capacity=3,
                             to_device=False, device="cpu")
    assert lu.device.type == "cpu" and perm.dtype == torch.int64
    with pytest.raises(ValueError, match="uniform 32-tile grid"):
        ooc.getrf_ooc(_t(_gauss(100, np.float32, 0)), nb=NB, device="cpu")


# ---------------------------------------------------------------------------
# Dispatch through the ooc site
# ---------------------------------------------------------------------------

@pytest.fixture
def forced(monkeypatch):
    monkeypatch.setattr(config, "ooc", True)
    monkeypatch.setenv("SLATE_TPU_TORCH_OOC_NB", str(NB))
    monkeypatch.setenv("SLATE_TPU_TORCH_OOC_WINDOW_TILES", "3")
    metrics.on()


def _resid(a, x, b):
    a, x, b = (np.asarray(v, np.float64) for v in (a, x, b))
    return np.linalg.norm(a @ x - b) / (
        np.linalg.norm(a) * np.linalg.norm(x) * N * np.finfo(np.float32).eps)


def _pooled(n=N, dt="float32"):
    return autotune.decisions().get("ooc|%d,%d,%s,cpu" % (n, NB, dt))


def test_gesv_through_forced_site(forced):
    a = _gauss(N, np.float32, 2)
    b = np.random.default_rng(4).standard_normal((N, 8)).astype(np.float32)
    lu, perm, x = st.gesv(st.Matrix.from_array(a, nb=NB, device="cpu"), b)
    assert _resid(a, x.numpy(), b) < 3.0
    assert _pooled() == "pool"
    assert autotune.decisions(with_reasons=True)[
        "ooc|%d,%d,float32,cpu" % (N, NB)] == ("pool", "forced-config")
    assert _ooc_counters(metrics).get("ooc.host_bytes", 0.0) > 0
    # the same factor as the driver called directly
    lu2, perm2 = ooc.getrf_ooc(_t(a), nb=NB, capacity=3, device="cpu")
    assert torch.equal(lu.data, lu2) and torch.equal(perm, perm2)


def test_posv_through_forced_site(forced):
    a = _spd(N, np.float32, 3)
    b = np.random.default_rng(5).standard_normal((N, 4)).astype(np.float32)
    fac, x = st.posv(st.HermitianMatrix(a, uplo=st.Uplo.Lower, nb=NB,
                                        device="cpu"), b)
    assert _resid(a, x.numpy(), b) < 3.0
    assert _pooled() == "pool"
    assert _ooc_counters(metrics).get("ooc.host_bytes", 0.0) > 0
    assert chol_mod._potrf_branch(_t(a), NB, 512, "auto") == "ooc"


def test_config_off_never_pools(monkeypatch):
    metrics.on()
    monkeypatch.setattr(config, "ooc", False)
    monkeypatch.setenv("SLATE_TPU_TORCH_OOC_NB", str(NB))
    monkeypatch.setenv("SLATE_TPU_TORCH_AUTOTUNE_FORCE", "ooc=pool")
    a = _gauss(N, np.float32, 0)
    lu, perm = lu_mod._getrf_partial(_t(a), NB)
    f = lu.numpy().astype(np.float64)
    assert np.abs(a[perm.numpy()] - (np.tril(f, -1) + np.eye(N))
                  @ np.triu(f)).max() < 1e-3
    assert _pooled() == "incore"
    assert not _ooc_counters(metrics)


def test_complex_and_one_tile_stay_incore(forced):
    a = _gauss(N, np.float32, 0)
    c = _t((a + 1j * a).astype(np.complex64))
    assert not ooc.pool_eligible(c)
    lu_mod._getrf_partial(c, NB)
    one = _t(a[:NB, :NB])
    assert not ooc.pool_eligible(one)
    lu_mod._getrf_partial(one, NB)
    assert not ooc.pool_eligible(_t(a[:, :96]))
    assert not _ooc_counters(metrics)
    assert autotune.decisions(with_reasons=True)[
        "ooc|%d,%d,complex64,cpu" % (N, NB)] == ("incore", "ineligible")
    assert ooc.pool_eligible(_t(a))


def test_auto_pin_and_off_the_card(monkeypatch):
    """Under auto: incore off the card, a pin answered as it is."""
    monkeypatch.setattr(config, "ooc", "auto")
    assert autotune.choose_ooc(N, NB, torch.float32, "cpu", True) == "incore"
    monkeypatch.setenv("SLATE_TPU_TORCH_AUTOTUNE_FORCE", "ooc=pool")
    assert autotune.choose_ooc(N, NB, torch.float32, "cpu", True) == "pool"
    assert autotune.choose_ooc(N, NB, torch.float32, "cpu", False) == "incore"


def test_choose_ooc_analytic_budget_on_the_card(monkeypatch):
    """On a CUDA operand under auto the site weighs 3·n²·itemsize against
    the budget: 1 MiB pools n = 1024 fp32 (12 MiB), 64 MiB does not
    pool n = 1024 fp32 but pools fp64 at 2048 (96 MiB)."""
    monkeypatch.setattr(config, "ooc", "auto")
    monkeypatch.delenv("SLATE_TPU_TORCH_AUTOTUNE_FORCE", raising=False)
    monkeypatch.setenv("SLATE_TPU_TORCH_OOC_HBM_MB", "1")
    assert tilepool.hbm_budget_bytes("cuda") == 1 << 20
    assert autotune.choose_ooc(1024, 512, torch.float32, "cuda",
                               True) == "pool"
    monkeypatch.setenv("SLATE_TPU_TORCH_OOC_HBM_MB", "64")
    assert autotune.choose_ooc(1024, 512, torch.float32, "cuda",
                               True) == "incore"
    assert autotune.choose_ooc(2048, 512, torch.float64, "cuda",
                               True) == "pool"
    reasons = autotune.decisions(with_reasons=True)
    assert reasons["ooc|2048,512,float64,cuda"][1].startswith("analytic")
    monkeypatch.setattr(config, "ooc", False)
    assert autotune.choose_ooc(2048, 512, torch.float64, "cuda",
                               True) == "incore"
    monkeypatch.delenv("SLATE_TPU_TORCH_OOC_HBM_MB")
    with pytest.raises(ValueError, match="not a card"):
        tilepool.hbm_budget_bytes("cpu")


def test_knobs(monkeypatch):
    for k in ("NB", "WINDOW_TILES", "PREFETCH_DEPTH"):
        monkeypatch.delenv("SLATE_TPU_TORCH_OOC_" + k, raising=False)
    assert (tilepool.ooc_nb(), tilepool.window_tiles(),
            tilepool.prefetch_depth()) == (512, 64, 4)
    monkeypatch.setenv("SLATE_TPU_TORCH_OOC_WINDOW_TILES", "1")
    monkeypatch.setenv("SLATE_TPU_TORCH_OOC_PREFETCH_DEPTH", "-3")
    monkeypatch.setenv("SLATE_TPU_TORCH_OOC_NB", "4")
    assert (tilepool.ooc_nb(), tilepool.window_tiles(),
            tilepool.prefetch_depth()) == (8, 2, 0)
    assert ooc.ooc_nb is tilepool.ooc_nb


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("driver", ["getrf_ooc", "potrf_ooc"])
def test_device_loss_resume_bitwise(monkeypatch, driver):
    metrics.on()
    a = _t(_gauss(N, np.float32, 9) if driver == "getrf_ooc"
           else _spd(N, np.float32, 11))
    fn = getattr(ooc, driver)
    clean = fn(a, nb=NB, capacity=3, device="cpu")
    monkeypatch.setenv("SLATE_TPU_TORCH_CKPT_EVERY_STEPS", "2")
    chunked = fn(a, nb=NB, capacity=3, device="cpu")
    inject.install(inject.FaultPlan(seed=7).add(
        "step.boundary", "device_loss", rate=1.0, count=1))
    chaos = fn(a, nb=NB, capacity=3, device="cpu")
    for got in (chunked, chaos):
        got = got if isinstance(got, tuple) else (got,)
        ref = clean if isinstance(clean, tuple) else (clean,)
        assert all(torch.equal(x, y) for x, y in zip(got, ref))
    c = _ooc_counters(metrics)
    assert c.get("ckpt.restored") == 1.0 and c.get("ckpt.saved", 0) >= 1.0
