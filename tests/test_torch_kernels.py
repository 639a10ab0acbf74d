"""The port's kernel module (slate_tpu_torch.ops.kernels) against the JAX
package's Pallas kernels, run in interpret mode as tests/test_pallas.py
runs them.  On the CPU each wrapper takes its kernel's plain version;
the CUDA kernels themselves are held against the plain versions on the
card by chip_smoke.py.  Inputs are numpy from a seed, cast to fp32."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slate_tpu.ops import pallas_kernels as pk
from slate_tpu_torch import config as tcfg
from slate_tpu_torch.ops import _build, blocks as tblocks, kernels
from slate_tpu_torch.perf import autotune as tauto


def _spd(nb, seed):
    g = np.random.default_rng(seed).standard_normal((nb, nb)).astype(np.float32)
    return g @ g.T + nb * np.eye(nb, dtype=np.float32)


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(x - ref) / np.linalg.norm(ref)


def test_matmul_plain_matches_pallas():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((256, 384)).astype(np.float32)
    b = rng.standard_normal((384, 256)).astype(np.float32)
    ref = np.asarray(pk.matmul(jnp.asarray(a), jnp.asarray(b),
                               bm=128, bn=128, bk=128))
    got = kernels.matmul(torch.from_numpy(a), torch.from_numpy(b))
    # both accumulate full fp32 products: only the summation order differs
    assert _rel(got.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("trans_a", [False, True])
@pytest.mark.parametrize("trans_b", [False, True])
def test_matmul_takes_transposed_views(trans_a, trans_b):
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((256, 640)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((640, 128)).astype(np.float32))
    av = a.T.contiguous().T if trans_a else a
    bv = b.T.contiguous().T if trans_b else b
    assert av.stride(0) == (1 if trans_a else 640)
    got = kernels.matmul(av, bv)
    ref = a.double() @ b.double()
    assert _rel(got.numpy(), ref.numpy()) <= 1e-6


@pytest.mark.parametrize("nb", [64, 128])
def test_chol_inv_panel_matches_pallas(nb):
    spd = _spd(nb, 3)
    l_ref, inv_ref = map(np.asarray, pk.chol_inv_panel(jnp.asarray(spd)))
    l, inv = (t.numpy() for t in kernels.chol_inv_panel(torch.from_numpy(spd)))
    assert _rel(l, l_ref) <= 1e-4 and _rel(inv, inv_ref) <= 1e-4
    assert np.all(np.triu(l, 1) == 0) and np.all(np.triu(inv, 1) == 0)
    # the gates of tests/test_pallas.py::test_chol_inv_panel
    assert np.linalg.norm(l @ l.T - spd) / np.linalg.norm(spd) < 1e-5
    assert np.linalg.norm(l @ inv - np.eye(nb)) < 1e-4


@pytest.mark.parametrize("nb", [64, 128])
def test_chol_inv_panel_reads_only_lower(nb):
    spd = _spd(nb, 4)
    junk = spd.copy()
    iu = np.triu_indices(nb, 1)
    junk[iu] = np.random.default_rng(5).standard_normal(len(iu[0])) * 1e3
    l0, inv0 = kernels.chol_inv_panel(torch.from_numpy(spd))
    l1, inv1 = kernels.chol_inv_panel(torch.from_numpy(junk))
    assert torch.equal(l0, l1) and torch.equal(inv0, inv1)


def test_trtri_panel_matches_pallas():
    nb = 128
    rng = np.random.default_rng(5)
    l = np.tril(rng.standard_normal((nb, nb))).astype(np.float32)
    l += nb * np.eye(nb, dtype=np.float32)
    ref = np.asarray(pk.trtri_panel(jnp.asarray(l)))
    got = kernels.trtri_panel(torch.from_numpy(l)).numpy()
    assert _rel(got, ref) <= 1e-5
    assert np.linalg.norm(l @ got - np.eye(nb)) < 1e-4
    # the strict upper triangle is never read
    junk = l + np.triu(np.ones_like(l), 1)
    assert np.array_equal(kernels.trtri_panel(torch.from_numpy(junk)).numpy(),
                          got)


@pytest.mark.parametrize("bad", ["f64", "not_pow2", "not_square", "small"])
def test_panel_wrappers_reject_what_the_kernel_does_not_take(bad):
    x = {"f64": torch.eye(64, dtype=torch.float64),
         "not_pow2": torch.eye(96),
         "not_square": torch.zeros(64, 128),
         "small": torch.eye(16)}[bad]
    for fn in (kernels.chol_inv_panel, kernels.trtri_panel):
        with pytest.raises(ValueError):
            fn(x)


def test_matmul_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        kernels.matmul(torch.zeros(128, 128), torch.zeros(64, 128))
    with pytest.raises(ValueError):
        kernels.matmul(torch.zeros(128, 128, dtype=torch.float64),
                       torch.zeros(128, 128, dtype=torch.float64))


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    kernels.reset_launches()
    a = torch.from_numpy(_spd(64, 6))
    kernels.chol_inv_panel(a)
    kernels.trtri_panel(torch.tril(a))
    kernels.lu_inv_panel(a)
    kernels.matmul(torch.zeros(128, 128), torch.zeros(128, 128))
    kernels.getrf_panel_linv(a, torch.ones(1, 64))
    kernels.getrf_panel_fused(a.clone(), torch.ones(1, 64), 0, nb=32, bb=32)
    kernels.potrf_batched(a[None].clone())
    kernels.getrf_batched(a[None].clone())
    spd = torch.from_numpy(_spd(256, 7))
    kernels.potrf_step_fused(spd.clone(), 0, nb=128)
    kernels.potrf_full_fused(spd.clone(), nb=128)
    kernels.getrf_step_fused(spd.clone(), torch.ones(1, 256), 0, nb=128)
    kernels.getrf_full_fused(spd.clone(), torch.ones(1, 256), nb=128)
    kernels.hb2st_wavefront(torch.zeros((40, 18), dtype=torch.float64), 8)
    kernels.tb2bd_wavefront(torch.zeros((40, 26), dtype=torch.float64), 8)
    kernels.chol_l21_panel(a, torch.zeros(128, 64))
    kernels.lu_u12_panel(torch.eye(64), torch.ones(64, 128))
    kernels.tile_norms(a[None], "fro")
    kernels.tzset(a, True, 0.0, 1.0)
    kernels.tzscale(a, False, 2.0, 1.0)
    kernels.geadd(1.0, a, 2.0, a)
    kernels.gescale_row_col(a[0], a[1], a)
    planes = tuple(torch.zeros(64, 64, dtype=torch.bfloat16) for _ in range(3))
    kernels.split_matmul(planes, planes, "split3")
    kernels.split_matmul(planes, planes, "split6")
    kernels.ozaki_matmul(torch.zeros((8, 64, 64), dtype=torch.int8),
                         torch.zeros((8, 32, 64), dtype=torch.int8),
                         torch.zeros(64, dtype=torch.float64),
                         torch.zeros(32, dtype=torch.float64))
    assert set(kernels.launches) == {"matmul", "chol_inv_panel",
                                     "trtri_panel", "lu_inv_panel",
                                     "getrf_panel_linv",
                                     "getrf_panel_fused", "potrf_batched",
                                     "getrf_batched", "potrf_step_fused",
                                     "potrf_full_fused", "getrf_step_fused",
                                     "getrf_full_fused", "hb2st_wavefront",
                                     "tb2bd_wavefront", "chol_l21_panel",
                                     "lu_u12_panel", "tile_norms", "tzset",
                                     "tzscale", "geadd", "gescale_row_col",
                                     "split_matmul", "ozaki_matmul"}
    assert all(v == 0 for v in kernels.launches.values())


def test_library_loading_and_launch_counts_are_thread_safe(monkeypatch):
    """Sixteen threads, with the interpreter switching threads every
    microsecond: each kernel's library is loaded once and no launch
    count is lost (the serving queue launches from its own thread)."""
    import sys
    import threading
    import time

    loads = []

    class Lib:
        def __getattr__(self, sym):
            return lambda *args: 0

    def library(name):
        loads.append(name)
        time.sleep(0.01)
        return Lib()

    monkeypatch.setattr(_build, "library", library)
    monkeypatch.setattr(kernels, "_fns", {})
    kernels.reset_launches()
    fns = []

    def worker():
        for _ in range(200):
            fns.append(kernels._fn("matmul"))
            kernels._count("getrf_batched")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        counted = kernels.launches["getrf_batched"]
    finally:
        sys.setswitchinterval(old)
        kernels.reset_launches()
        kernels._fns.clear()
    assert counted == 16 * 200
    assert loads == ["matmul"]
    assert len({id(f) for f in fns}) == 1 and len(fns) == 16 * 200


@pytest.fixture
def jax_pallas_on(tmp_path, monkeypatch):
    """The JAX package with its Pallas kernels forced on (interpret mode
    on the CPU) and a private autotune table, restored after."""
    from slate_tpu import config as jcfg
    from slate_tpu.perf import autotune as jauto

    monkeypatch.setenv("SLATE_TPU_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    monkeypatch.setattr(jcfg, "use_pallas", True)
    jauto.reset_table()
    yield
    jauto.reset_table()


def test_potrf_panels_matches_jax_strip_driver(jax_pallas_on):
    from slate_tpu.ops import blocks as jblocks

    n, nb = 384, 128
    a = _spd(n, 7)
    ref = np.asarray(jblocks.potrf_panels(jnp.asarray(a), nb))
    got = tblocks.potrf_panels(torch.from_numpy(a), nb).numpy()
    assert _rel(got, ref) <= 1e-4
    assert np.all(np.triu(got, 1) == 0)


def test_sites_pick_plain_on_cpu_and_stock_off_path(monkeypatch):
    cpu = torch.device("cpu")
    f32 = torch.float32
    assert tauto.choose_matmul((256, 128), (128, 384), f32, cpu) == "plain"
    assert tauto.choose_matmul((250, 128), (128, 384), f32, cpu) == "stock"
    assert tauto.choose_matmul((256, 128), (128, 384), torch.float64,
                               cpu) == "stock"
    assert tauto.choose_potrf_panel(1024, 512, f32, cpu) == "plain"
    assert tauto.choose_potrf_panel(1024, 512, torch.float64, cpu) == "stock"
    assert tauto.choose_potrf_step(1024, 512, f32, cpu) == "composed"
    assert tauto.choose_trtri_panel(256, f32, cpu) == "plain"
    assert tauto.choose_matmul((256, 128), (128, 384), f32,
                               torch.device("cuda")) == "kernel"
    monkeypatch.setattr(tcfg, "use_kernels", False)
    assert tauto.choose_matmul((256, 128), (128, 384), f32, cpu) == "stock"
    assert tauto.choose_potrf_panel(1024, 512, f32, cpu) == "stock"
    assert tauto.choose_trtri_panel(256, f32, cpu) == "stock"
    assert "matmul|256,128,384,float32,cpu" in tauto.decisions()


def test_build_goes_to_the_checkout_build_dir(monkeypatch):
    root = _build.CSRC.parents[1]
    assert _build.BUILD_DIR == root / "build" / "slate_tpu_torch"
    for name, (src, headers) in _build.SOURCES.items():
        assert (_build.CSRC / src).is_file()
        assert all((_build.CSRC / h).is_file() for h in headers)
        p = _build.lib_path(name)
        assert p.parent == _build.BUILD_DIR and p.name.startswith("lib" + name)
    assert "arch=compute_90a,code=sm_90a" in _build.FLAGS
    monkeypatch.setenv("SLATE_TPU_TORCH_NVCC", "/usr/x/nvcc")
    assert _build.nvcc_path() == "/usr/x/nvcc"


# ---------------------------------------------------------------------------
# Partial-pivot LU panels: the plain versions against the Pallas kernels in
# interpret mode.  Pivots must agree exactly (the inputs have no ties);
# factors and inverses to 1e-4 relative (the two block the elimination
# differently, so they round differently).
# ---------------------------------------------------------------------------

def _max_rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return np.abs(x - ref).max() / np.abs(ref).max()


def _panel_residual(out, piv, act_out, a_rows):
    """‖L·U − A[perm]‖/(‖A‖·ε·m) of a factored (w, m) lane-major panel
    whose untransposed input is ``a_rows`` (m, w) — the gate of
    tests/test_lu_pallas_panel.py — and ‖L11·linv − I‖'s L11."""
    w, m = out.shape
    rest = np.argsort(act_out[0] < 0.5, kind="stable")[: m - w]
    perm = np.concatenate([piv, rest])
    lu = out[:, perm].T
    low = np.tril(lu, -1) + np.eye(m, w, dtype=np.float32)
    res = np.linalg.norm(low @ np.triu(lu[:w]) - a_rows[perm]) / (
        np.linalg.norm(a_rows) * np.finfo(np.float32).eps * m)
    return res, np.tril(lu[:w], -1) + np.eye(w, dtype=np.float32)


def test_getrf_panel_linv_plain_matches_pallas():
    rng = np.random.default_rng(30)
    bb, m = 64, 256
    slab = rng.standard_normal((bb, m)).astype(np.float32)
    act = np.ones((1, m), np.float32)
    ref = [np.asarray(t) for t in pk.getrf_panel_linv(
        jnp.asarray(slab), jnp.asarray(act), ib=32)]
    got = [t.numpy() for t in kernels.getrf_panel_linv(
        torch.from_numpy(slab), torch.from_numpy(act), ib=32)]
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[2], ref[2])
    assert _max_rel(got[0], ref[0]) <= 1e-4
    assert _max_rel(got[3], ref[3]) <= 1e-4
    res, l11 = _panel_residual(got[0], got[1], got[2], slab.T)
    assert res < 60, res
    assert np.linalg.norm(l11 @ got[3] - np.eye(bb)) < 1e-3
    assert got[1].dtype == np.int64 and got[2].shape == (1, m)


def test_getrf_panel_fused_plain_matches_pallas_in_place():
    rng = np.random.default_rng(31)
    m, nb, bb, ib = 256, 64, 32, 16
    a = rng.standard_normal((m, m)).astype(np.float32)
    at = a.T.copy()
    act = np.ones((1, m), np.float32)
    carry = torch.from_numpy(at.copy())
    jc, ja = jnp.asarray(at), jnp.asarray(act)
    tc_act = torch.from_numpy(act)
    for k0 in (0, nb):
        before = carry.clone()
        jc, jpiv, ja, jlinv = pk.getrf_panel_fused(jc, ja, k0, nb=nb, bb=bb,
                                                   ib=ib)
        out, piv, tc_act, linv = kernels.getrf_panel_fused(
            carry, tc_act, k0, nb=nb, bb=bb, ib=ib)
        assert out is carry                         # in place
        np.testing.assert_array_equal(piv.numpy(), np.asarray(jpiv))
        np.testing.assert_array_equal(tc_act.numpy(), np.asarray(ja))
        assert _max_rel(carry.numpy(), np.asarray(jc)) <= 1e-4
        assert _max_rel(linv.numpy(), np.asarray(jlinv)) <= 1e-4
        # rows outside the panel are untouched
        assert torch.equal(carry[:k0], before[:k0])
        assert torch.equal(carry[k0 + nb:], before[k0 + nb:])
    assert len(set(np.asarray(jpiv).tolist())) == nb


@pytest.mark.parametrize("which", ["linv", "fused"])
def test_lu_panel_tie_takes_the_lowest_lane(which):
    """Two lanes of equal magnitude lead column 0: both packages take the
    lower lane index (pallas_kernels.py:725-728)."""
    rng = np.random.default_rng(32)
    w, m = 64, 256
    slab = rng.standard_normal((w, m)).astype(np.float32)
    slab[0, 200] = 9.0
    slab[0, 37] = -9.0
    act = np.ones((1, m), np.float32)
    if which == "linv":
        ref = np.asarray(pk.getrf_panel_linv(jnp.asarray(slab),
                                             jnp.asarray(act), ib=32)[1])
        got = kernels.getrf_panel_linv(torch.from_numpy(slab),
                                       torch.from_numpy(act), ib=32)[1]
    else:
        ref = np.asarray(pk.getrf_panel_fused(
            jnp.asarray(slab), jnp.asarray(act), 0, nb=w, bb=32, ib=16)[1])
        got = kernels.getrf_panel_fused(torch.from_numpy(slab.copy()),
                                        torch.from_numpy(act), 0, nb=w,
                                        bb=32, ib=16)[1]
    assert ref[0] == 37 and got[0].item() == 37
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("bad", ["ib", "act_dtype", "act_len", "k0", "rows"])
def test_lu_panel_wrappers_reject_what_the_kernel_does_not_take(bad):
    slab, act = torch.zeros(64, 128), torch.ones(1, 128)
    with pytest.raises(ValueError):
        if bad == "ib":
            kernels.getrf_panel_linv(slab, act, ib=24)
        elif bad == "act_dtype":
            kernels.getrf_panel_linv(slab, act.double())
        elif bad == "act_len":
            kernels.getrf_panel_linv(slab, torch.ones(1, 64))
        elif bad == "k0":
            kernels.getrf_panel_fused(slab, act, 16, nb=32, bb=32)
        else:
            kernels.getrf_panel_fused(slab, act, 64, nb=32, bb=32)


def test_lu_sites_pick_plain_on_cpu_and_stock_off_path(monkeypatch):
    cpu, cuda, f32 = torch.device("cpu"), torch.device("cuda"), torch.float32
    assert tauto.choose_lu_panel(1024, 256, f32, cpu, True) == "plain"
    assert tauto.choose_lu_panel(1024, 256, f32, cuda, True) == "kernel"
    assert tauto.choose_lu_panel(1024, 256, f32, cpu, False) == "stock"
    assert tauto.choose_lu_driver(8192, 8192, 512, f32, cuda,
                                  True) == "scattered"
    assert tauto.choose_lu_driver(8192, 8192, 512, f32, cuda, False) == "rec"
    assert tauto.choose_lu_step(8192, 8192, 512, f32, cuda) == "composed"
    monkeypatch.setattr(tcfg, "scattered_lu", False)
    assert tauto.choose_lu_driver(8192, 8192, 512, f32, cuda, True) == "rec"
    monkeypatch.setattr(tcfg, "use_kernels", False)
    assert tauto.choose_lu_panel(1024, 256, f32, cuda, True) == "stock"
    assert tauto.select("lu_step", m=512, n=512, nb=512, dtype=f32,
                        device=cpu) == "composed"
    assert "lu_driver|8192,8192,512,float32,cuda" in tauto.decisions()


def test_smem_plans_the_main_path_panels():
    """The shared-memory gate of lu_panel.cuh's panel kernels at the
    main-path shapes, on the H100's constants: the kernels' share at their
    leaf cluster of 16 blocks (for the 512-wide fused panel at m = 8192
    the updaters' 14,752 words pass the leaf's 512 lanes × 16 rows), the
    512-wide fused panel at m = 8192 and the 256-wide leaf fit, and the
    fused panel stops at m = 12144 (92 lanes × 512 rows a block of the
    grid the gate has kept from before the leaf clusters)."""
    from slate_tpu_torch.ops import smem

    assert smem.lu_panel_cluster_bytes(8192, 512, 16) == 4 * 14752
    assert smem.lu_panel_leaf_floats(8192, 16, 16) < smem.lu_panel_update_floats(512, 16)
    assert smem.lu_panel_fits(8192, 512, 16)
    assert smem.lu_panel_fits(8192, 256, 32)
    assert smem.lu_panel_fits(256, 256, 32)
    assert not smem.lu_panel_fits(16384, 512, 16)
    assert smem.lu_panel_fits(12144, 512, 16)
    assert not smem.lu_panel_fits(12145, 512, 16)
    assert smem.lu_panel_cluster_bytes(12145, 512, 16) <= smem.BLOCK_SMEM_MAX
    assert not smem.lu_panel_fits(256, 64, 40)       # ib past the kernel's
    assert not smem.lu_panel_fits(256, 48, 32)       # ib must divide w


@pytest.mark.parametrize("w, ib, m_max", [(512, 16, 12144), (256, 32, 16384)])
def test_panel_gate_admits_what_it_admitted(w, ib, m_max):
    """The gate admits exactly the panels it admitted before the leaf
    clusters (a block of one grid of min(SMs, m/32) blocks holding all w
    rows of its lanes, ``smem.lu_panel_bytes``), so no driver changes
    route: the scattered driver's (512, m) panels with ib = 16 up to
    m = 12144 and the recursion's (256, m) leaves with ib = 32 for
    m ≤ 16384 among them, at every m the drivers pass (m ≥ w,
    m % 8 == 0); the kernels' own share fits wherever it admits."""
    from slate_tpu_torch.ops import smem

    for m in range(w, 4 * m_max, 8):
        before = smem.fits(smem.lu_panel_bytes(m, w, ib, smem._first_grid(m)))
        assert smem.lu_panel_fits(m, w, ib) == before, m
        assert before or m > m_max, m
        if before:
            assert smem.lu_panel_cluster_bytes(m, w, ib) <= smem.BLOCK_SMEM_MAX, m


# ---------------------------------------------------------------------------
# Batched kernels: the plain versions against the Pallas kernels in
# interpret mode (pallas_kernels.potrf_batched / getrf_batched).
# ---------------------------------------------------------------------------

def _gauss_batch(b, n, seed):
    """Plain Gaussian problems (no + n·I), so the argmax chooses pivots
    off the diagonal; problem 1 gets an exact zero column."""
    a = np.random.default_rng(seed).standard_normal((b, n, n)).astype(
        np.float32)
    a[1, :, 5] = 0.0
    return a


def _scipy_perm(a):
    import scipy.linalg as sla

    perm = list(range(a.shape[0]))
    for k, p in enumerate(sla.lu_factor(a.astype(np.float64))[1]):
        perm[k], perm[p] = perm[p], perm[k]
    return np.asarray(perm)


def test_getrf_batched_plain_matches_pallas_and_scipy_pivots():
    """Pivots exactly equal to the JAX kernel's for every problem and to
    scipy's for the nonsingular ones; the factored problems within 1e-4
    of the JAX kernel's max (the two sum U12 and the rank-32 update in
    different orders).  The zero column of problem 1 picks the lowest
    active lane and divides by 1 in both: finite, equal pivots."""
    b, n = 3, 64
    a = _gauss_batch(b, n, 50)
    at = np.ascontiguousarray(a.transpose(0, 2, 1))
    jout, jpiv = map(np.asarray, pk.getrf_batched(jnp.asarray(at)))
    out, piv = (t.numpy() for t in kernels.getrf_batched(torch.from_numpy(at)))
    np.testing.assert_array_equal(piv, jpiv)
    assert piv.dtype == np.int64 and np.isfinite(out).all()
    assert _max_rel(out, jout) <= 1e-4
    for i in (0, 2):
        np.testing.assert_array_equal(piv[i], _scipy_perm(a[i]))
    for i in range(b):
        lu = out[i][:, piv[i]].T.astype(np.float64)
        low = np.tril(lu, -1) + np.eye(n)
        res = np.linalg.norm(low @ np.triu(lu) - a[i][piv[i]]) / (
            np.linalg.norm(a[i]) * np.finfo(np.float32).eps * n)
        assert res <= 3, (i, res)
        assert np.abs(np.tril(lu, -1)).max() <= 1 + 100 * np.finfo(np.float32).eps


def test_getrf_batched_tie_takes_the_lowest_lane():
    rng = np.random.default_rng(51)
    a = rng.standard_normal((2, 64, 64)).astype(np.float32)
    a[0, 40, 0], a[0, 7, 0] = 9.0, -9.0
    at = np.ascontiguousarray(a.transpose(0, 2, 1))
    jpiv = np.asarray(pk.getrf_batched(jnp.asarray(at))[1])
    piv = kernels.getrf_batched(torch.from_numpy(at))[1].numpy()
    assert jpiv[0, 0] == 7 and piv[0, 0] == 7
    np.testing.assert_array_equal(piv, jpiv)


def test_potrf_batched_plain_matches_pallas():
    """|ΔL| ≤ 1e-4·max|L| (both do the same blocked arithmetic in other
    summation orders) and both factors pass the tester's ≤ 3."""
    b, n = 3, 64
    g = np.random.default_rng(52).standard_normal((b, n, n)).astype(np.float32)
    spd = g @ g.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)
    ref = np.asarray(pk.potrf_batched(jnp.asarray(spd)))
    got = kernels.potrf_batched(torch.from_numpy(spd)).numpy()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
    assert np.all(np.triu(got, 1) == 0)
    for l in (got, ref):
        for i in range(b):
            li = l[i].astype(np.float64)
            res = np.linalg.norm(li @ li.T - spd[i]) / (
                np.linalg.norm(spd[i]) * np.finfo(np.float32).eps * n)
            assert res <= 3, res
    # only the lower triangle is read
    junk = spd + np.triu(np.full_like(spd, 1e3), 1)
    assert torch.equal(kernels.potrf_batched(torch.from_numpy(junk)),
                       torch.from_numpy(got))


@pytest.mark.parametrize("bad", ["f64", "2d", "not_square", "n48", "n16",
                                 "n896"])
def test_batched_wrappers_reject_what_the_kernels_do_not_take(bad):
    x = {"f64": torch.zeros(2, 64, 64, dtype=torch.float64),
         "2d": torch.zeros(64, 64),
         "not_square": torch.zeros(2, 64, 32),
         "n48": torch.zeros(2, 48, 48),
         "n16": torch.zeros(2, 16, 16),
         "n896": torch.zeros(1, 896, 896)}[bad]
    fns = (kernels.getrf_batched,) if bad == "n896" else (
        kernels.potrf_batched, kernels.getrf_batched)
    for fn in fns:
        with pytest.raises(ValueError):
            fn(x)


def test_smem_gates_the_batched_kernels():
    """potrf_batched takes any n on the 32 grid (its problem lives in
    device memory); getrf_batched also needs its 32-row block and U12
    rows in one block's shared memory: n ≤ 864 on the H100."""
    from slate_tpu_torch.ops import smem

    assert smem.getrf_batched_bytes(256) == 4 * (66 * 256 + 52)
    for n in (32, 64, 256, 864):
        assert smem.batched_fits("getrf_batched", n)
    assert not smem.batched_fits("getrf_batched", 896)
    assert smem.batched_fits("potrf_batched", 4096)
    for kernel in ("potrf_batched", "getrf_batched"):
        assert not smem.batched_fits(kernel, 48)
        assert not smem.batched_fits(kernel, 16)
    with pytest.raises(KeyError):
        smem.batched_fits("geqrf_batched", 64)


@pytest.mark.parametrize("n", [288, 320])
def test_potrf_batched_plain_matches_pallas_at_the_route_edge(n):
    """At the largest n of potrf_batched's shared-memory route (288) and
    the smallest of its L2 route (320): the plain version within
    1e-4·max|L| of the JAX kernel, both factors ≤ 3 by the tester's
    residual, zeros above the diagonal."""
    b = 2
    g = np.random.default_rng(53 + n).standard_normal((b, n, n)).astype(np.float32)
    spd = g @ g.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)
    ref = np.asarray(pk.potrf_batched(jnp.asarray(spd)))
    got = kernels.potrf_batched(torch.from_numpy(spd)).numpy()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
    assert np.all(np.triu(got, 1) == 0)
    for l in (got, ref):
        for i in range(b):
            li = l[i].astype(np.float64)
            res = np.linalg.norm(li @ li.T - spd[i]) / (
                np.linalg.norm(spd[i]) * np.finfo(np.float32).eps * n)
            assert res <= 3, res


def _first_split(out, piv, other, tol=1e-4):
    """The first column where the pivot lanes ``piv`` of the factored
    lane-major problem ``out`` differ from ``other`` (None: they agree),
    after checking that the two candidates there are a near-tie: within
    ``tol`` relative in ``out``'s factor (the pivot's |U[j, j]| against the
    other lane's |L[i, j]|·|U[j, j]|).  The default is the value tolerance
    of the comparison: factors that agree to 1e-4 may order two candidates
    closer than that either way."""
    diff = np.nonzero(piv != other)[0]
    if not diff.size:
        return None
    j = int(diff[0])
    mk = abs(float(out[j, piv[j]]))
    mo = abs(float(out[j, other[j]])) * mk
    assert abs(mk - mo) <= tol * mk, (j, mk, mo)
    return j


@pytest.mark.parametrize("n", [800, 832])
def test_getrf_batched_plain_matches_pallas_at_the_route_edge(n):
    """At the largest n of getrf_batched's cluster route (800) and the
    smallest of its L2 route (832): pivots equal to the JAX kernel's and to
    scipy's up to a near-tie (a first differing column whose candidates
    are within 1e-4 relative: the three round in different orders over
    800 dependent columns, and at 832 the plain version's factor drifts
    3.9e-5 from the JAX kernel's before a column whose candidates lie
    3.0e-5 apart), the factored columns before it within 1e-4 of the JAX
    kernel's max, residuals ≤ 3 and |L| ≤ 1 + 100ε."""
    b = 2
    a = np.random.default_rng(54 + n).standard_normal((b, n, n)).astype(np.float32)
    at = np.ascontiguousarray(a.transpose(0, 2, 1))
    jout, jpiv = map(np.asarray, pk.getrf_batched(jnp.asarray(at)))
    out, piv = (t.numpy() for t in kernels.getrf_batched(torch.from_numpy(at)))
    for i in range(b):
        j = _first_split(out[i], piv[i], jpiv[i])
        assert _max_rel(out[i][:j], jout[i][:j]) <= 1e-4
        _first_split(out[i], piv[i], _scipy_perm(a[i]))
        lu = out[i][:, piv[i]].T.astype(np.float64)
        low = np.tril(lu, -1) + np.eye(n)
        res = np.linalg.norm(low @ np.triu(lu) - a[i][piv[i]]) / (
            np.linalg.norm(a[i]) * np.finfo(np.float32).eps * n)
        assert res <= 3, (i, res)
        assert np.abs(np.tril(lu, -1)).max() <= 1 + 100 * np.finfo(np.float32).eps


def test_batched_plans_cover_every_admitted_n():
    """Every n on the 32 grid to 1024 gets a route: potrf_batched's lower
    triangle (its tiles and the inverse's) in one block to n = 288, then
    the L2 route; getrf_batched's problem on the smallest cluster (≤ 16
    blocks) whose shares fit, every block owning a row block, to n = 800,
    then the L2 route to 864.  No block takes more than 227 KB."""
    from slate_tpu_torch.ops import smem

    for n in range(32, 1025, 32):
        route, nbytes = smem.potrf_batched_plan(n)
        assert (route == "smem") == (n <= 288), n
        assert nbytes <= smem.BLOCK_SMEM_MAX, n
        assert nbytes == (smem.potrf_batched_bytes(n) if route == "smem"
                          else smem.POTRF_L2_SMEM)
        if not smem.batched_fits("getrf_batched", n):
            continue
        route, c, nbytes = smem.getrf_batched_plan(n)
        assert (route == "smem") == (n <= 800), n
        assert 1 <= c <= smem.GETRF_CLUSTER and nbytes <= smem.BLOCK_SMEM_MAX, n
        if route == "l2":
            assert c == 1 and nbytes == smem.getrf_batched_bytes(n)
            continue
        nt = n // 32
        rows = -(-nt // c)
        assert nbytes == smem.getrf_batched_cluster_bytes(n, rows)
        assert (c - 1) * rows < nt <= c * rows, n          # every block owns one
        assert c == 1 or smem.getrf_batched_cluster_bytes(
            n, -(-nt // (c - 1))) > smem.BLOCK_SMEM_MAX, n  # the smallest cluster
    assert smem.potrf_batched_plan(256) == ("smem", 156288)
    assert smem.getrf_batched_plan(224)[:2] == ("smem", 1)
    assert smem.getrf_batched_plan(256) == ("smem", 2, 148480)
    assert smem.getrf_batched_plan(800)[:2] == ("smem", 13)


def test_batched_fits_is_unchanged_by_the_routes():
    """The shape gate admits what it admitted before the on-chip routes:
    potrf_batched every n on the 32 grid, getrf_batched n ≤ 864."""
    from slate_tpu_torch.ops import smem

    grid = range(32, 1025, 32)
    assert all(smem.batched_fits("potrf_batched", n) for n in grid)
    assert [n for n in grid if smem.batched_fits("getrf_batched", n)] == list(
        range(32, 865, 32))


class _FakePlanLib:
    """A kernel library whose ``slate_<name>_plan`` entries answer from
    ``plans[name](n)`` (a tuple of ints: the route's index, then the
    cluster for getrf_batched, then the bytes)."""

    def __init__(self, plans):
        self.plans = plans

    def __getattr__(self, sym):
        plan = self.plans[sym[len("slate_"):-len("_plan")]]

        class Entry:
            argtypes = restype = None

            def __call__(self, n, *outs):
                for out, v in zip(outs, plan(n)):
                    out._obj.value = v
                return 0

        return Entry()


def _c_side(name, change_at=None):
    """The C plan as ops/smem.py states it, but one byte more at n =
    ``change_at``."""
    from slate_tpu_torch.ops import smem

    def plan(n):
        got = list(getattr(smem, name + "_plan")(n))
        got[0] = smem.BATCHED_ROUTES.index(got[0])
        if n == change_at:
            got[-1] += 1
        return tuple(got)
    return plan


@pytest.mark.parametrize("name", ["potrf_batched", "getrf_batched"])
def test_batched_plan_check_at_load(name):
    """The load-time check (ops/kernels.py ``_check_batched_plan``) passes
    a library whose plan is ops/smem.py's and raises on one that differs
    at a single n, naming it."""
    kernels._check_batched_plan(_FakePlanLib({name: _c_side(name)}), name)
    with pytest.raises(RuntimeError, match="n = 288"):
        kernels._check_batched_plan(
            _FakePlanLib({name: _c_side(name, change_at=288)}), name)


# ---------------------------------------------------------------------------
# matmul's parts of K (split-K) and its 3xTF32 arithmetic
# ---------------------------------------------------------------------------

H100_SMS = 132


def test_matmul_splits_one_part_where_the_tiles_fill_the_card():
    # phase 2's strip update (960 tiles), 8192³ and a 132-tile output
    assert kernels.matmul_splits(7680, 2048, 512, H100_SMS) == 1
    assert kernels.matmul_splits(8192, 8192, 8192, H100_SMS) == 1
    assert kernels.matmul_splits(128 * 12, 128 * 11, 32768, H100_SMS) == 1
    # a short K is not cut, however few the tiles
    assert kernels.matmul_splits(512, 512, 256, H100_SMS) == 1


@pytest.mark.parametrize("n", [512, 3584])
def test_matmul_splits_cut_geqrf_products_under_one_wave(n):
    # YᵀY (16 tiles) and Yᵀ·C (112 tiles) of geqrf's first panel at K = 32768
    s = kernels.matmul_splits(512, n, 32768, H100_SMS)
    tiles = 4 * (n // 128)
    assert s > 1
    assert tiles * s >= H100_SMS * 0.9 or tiles * s > H100_SMS


@pytest.mark.parametrize("m,n,k", [(512, 512, 32768), (512, 3584, 32768),
                                   (512, 512, 4096), (512, 1024, 16400),
                                   (512, 3072, 28672), (128, 128, 1040),
                                   (7680, 2048, 512), (256, 128, 48)])
def test_matmul_parts_are_whole_slabs_covering_k(m, n, k):
    # part z runs slabs [z·per, min((z+1)·per, slabs)) of 32 (csrc/matmul.cu
    # refuses a per that leaves a part empty or K uncovered)
    bk = kernels.MATMUL_SLAB
    s = kernels.matmul_splits(m, n, k, H100_SMS)
    slabs = -(-k // bk)
    per = kernels.matmul_part_slabs(k, s)
    parts = [(z * per * bk, min(k, (z + 1) * per * bk)) for z in range(s)]
    assert parts[0][0] == 0 and parts[-1][1] == k
    for (a0, a1), (b0, _) in zip(parts, parts[1:]):
        assert a1 == b0 and a1 % bk == 0
    assert all(k1 > k0 for k0, k1 in parts)
    assert (s - 1) * per < slabs


def _tf32_rna(x):
    """Round fp32 to TF32 (10 mantissa bits) with ties away from zero, as
    cvt.rna.tf32.f32 does for a finite x: on the bits, add half of the 13
    dropped bits' weight to the magnitude and clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_truncate(x):
    """fp32 read as TF32 by the tensor core: its 13 low bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _matmul_3xtf32(a, b):
    """The kernel's arithmetic in torch: each operand into big = tf32(x)
    and small = x − big (truncated to TF32 as the mma reads it), then
    small·big + big·small first and big·big last, three fp32 products."""
    ab, bb = _tf32_rna(a), _tf32_rna(b)
    as_, bs = _tf32_truncate(a - ab), _tf32_truncate(b - bb)
    return (as_ @ bb + ab @ bs) + ab @ bb


def test_tf32_rounding_keeps_ten_bits_ties_away():
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12,
                      1.0 + 3 * 2.0 ** -11], dtype=torch.float32)
    got = _tf32_rna(x)
    assert got.tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
                            1.0 + 2.0 ** -9]


def _f32(bits):
    return torch.tensor([bits], dtype=torch.int64).to(torch.int32).view(
        torch.float32)


@pytest.mark.parametrize("bits", [0x7FFFFFFF, 0xFFFFFFFF, 0x7FC00000,
                                  0x7FFFF000, 0x7F800001])
def test_3xtf32_split_keeps_a_nan(bits):
    # the rounding may turn a NaN into ±0 or ±inf (the card's NaN
    # 0x7fffffff becomes −0), but small = x − big stays a NaN as the mma
    # reads it, and so does the product's row and column
    x = _f32(bits)
    assert bool(torch.isnan(_tf32_truncate(x - _tf32_rna(x))).all())
    a = torch.ones(2, 3)
    a[1, 2] = x
    got = _matmul_3xtf32(a, torch.ones(3, 2))
    assert bool(got[1].isnan().all()) and bool(got[0].isfinite().all())
    got = _matmul_3xtf32(torch.ones(2, 3), a.T)
    assert bool(got[:, 1].isnan().all()) and bool(got[:, 0].isfinite().all())


@pytest.mark.parametrize("bits", [0x7F800000, 0xFF800000])
def test_3xtf32_split_of_inf(bits):
    # big keeps ±inf; small is inf − inf, a NaN, so the product is not finite
    x = _f32(bits)
    assert _tf32_rna(x).view(torch.int32).item() & 0xFFFFFFFF == bits
    assert not bool(torch.isfinite(_matmul_3xtf32(x.view(1, 1), torch.ones(1, 1))).any())


@pytest.mark.parametrize("m,k,n", [(256, 512, 256), (128, 32768, 128)])
def test_3xtf32_within_4x_of_fp32_error(m, k, n):
    """The 3xTF32 split is fp32-class: its error to the fp64 product is
    within 4x of a full fp32 product's, at the strip update's K and at a
    K = 32768 Gram shape (chip_smoke.py's gate for the kernel)."""
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    b = a.T.contiguous()[:, :n] if m == n and k > 4096 else torch.from_numpy(
        rng.standard_normal((k, n)).astype(np.float32))
    ref = a.double() @ b.double()
    e3 = _rel(_matmul_3xtf32(a, b).numpy(), ref.numpy())
    e32 = _rel((a @ b).numpy(), ref.numpy())
    e1 = _rel((_tf32_rna(a) @ _tf32_rna(b)).numpy(), ref.numpy())
    assert e3 <= 4.0 * e32
    assert e1 > 100 * e3      # one TF32 pass is not fp32-class


@pytest.mark.parametrize("nb", [32, 64, 128, 256, 512, 1024])
def test_chol_l21_panel_scratch_covers_chol_inv_grid(nb):
    # chol_inv_grid (csrc/tri_grid.cuh) keeps an nb² Schur complement and
    # then the doubling's products in the scratch
    for dev in ("cpu", "cuda"):
        if kernels.fused_panel_fits(nb, (1024,), dev):
            assert kernels.chol_l21_panel_scratch(nb) >= nb * nb


# ---------------------------------------------------------------------------
# The chase kernels' plan (ops/smem.py chase_*; csrc/chase.cuh computes the
# same, and chip_smoke.py holds the two to each other on the card): one
# task a cluster, its window in the cluster's shared memory or left in the
# band.
# ---------------------------------------------------------------------------

#: clusters of each size an H100 holds at once, one block an SM (the
#: occupancy query's answer is the card's; these stand in for it here)
_H100_CLUSTERS = {16: 7, 8: 16, 4: 33, 2: 66, 1: 132}


@pytest.mark.parametrize("kind", ["hb2st", "tb2bd"])
@pytest.mark.parametrize("n, kd, dtype, cluster", [(8192, 256, torch.float32, 8),
                                                   (4096, 256, torch.float64, 16)])
def test_chase_main_shapes_take_the_shared_memory_route(kind, n, kd, dtype, cluster):
    """heev's and svd's chases at their main shapes keep each task's window
    in its cluster's shared memory, within a block's 227 KB, and run every
    live task of a stagger at once: 12 tasks on clusters of 8 at n = 8192
    (96 SMs), 7 on clusters of 16 at n = 4096 (112 SMs)."""
    from slate_tpu_torch.ops import smem

    meta = kernels.hb_wave_meta if kind == "hb2st" else kernels.tb_wave_meta
    nl = meta(n, kd)[3]
    g, c, route = smem.chase_plan(kind, kd, dtype, nl, _H100_CLUSTERS)
    assert (g, c, route) == (nl, cluster, "smem")
    assert smem.chase_route(kind, kd, dtype) == "smem"
    assert smem.chase_block_bytes(kind, kd, dtype, c, route) <= smem.BLOCK_SMEM_MAX
    assert nl == (12 if n == 8192 else 7)


@pytest.mark.parametrize("kind", ["hb2st", "tb2bd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kd", [4, 64, 256, 512, 768, 1024])
def test_every_admitted_band_width_gets_a_route(kind, dtype, kd):
    """Every kd the chase site admits (``linalg._chase.eligible``: kd ≥ 4,
    n > kd + 2) gets a plan whose block share fits: the window in shared
    memory while a block's share at 16 blocks fits, else left in the band
    with only the vectors in shared memory."""
    from slate_tpu_torch.linalg import _chase
    from slate_tpu_torch.ops import smem

    for n in (kd + 3, 4 * kd + 5):
        assert _chase.eligible(n, kd, True)
        meta = kernels.hb_wave_meta if kind == "hb2st" else kernels.tb_wave_meta
        nl = meta(n, kd)[3]
        g, c, route = smem.chase_plan(kind, kd, dtype, nl, _H100_CLUSTERS)
        assert route == smem.chase_route(kind, kd, dtype)
        assert smem.chase_block_bytes(kind, kd, dtype, c, route) <= smem.BLOCK_SMEM_MAX
        assert 1 <= g <= max(nl, 1) and c in _H100_CLUSTERS
    smem_fits = (smem.chase_block_bytes(kind, kd, dtype, 16, "smem")
                 <= smem.BLOCK_SMEM_MAX)
    assert smem.chase_route(kind, kd, dtype) == ("smem" if smem_fits else "l2")
    # fp64 takes the band route from kd = 453 (tb2bd) and 528 (hb2st), fp32
    # from 657 and 757
    first = {("hb2st", torch.float32): 757, ("hb2st", torch.float64): 528,
             ("tb2bd", torch.float32): 657, ("tb2bd", torch.float64): 453}
    assert (smem.chase_route(kind, kd, dtype) == "l2") == (kd >= first[kind, dtype])


@pytest.mark.parametrize("nl, clusters, want", [
    (12, {16: 7, 8: 16, 4: 33, 2: 66, 1: 132}, (12, 8)),     # one round at 8
    (7, {16: 7, 8: 16, 4: 33, 2: 66, 1: 132}, (7, 16)),      # a tie: the larger
    (44, {16: 7, 8: 16, 4: 33, 2: 66, 1: 132}, (44, 2)),
    (12, {16: 0, 8: 0, 4: 33, 2: 66, 1: 132}, (12, 4)),      # no cluster of 8 fits
    (20, {16: 7, 8: 8, 4: 0, 2: 0, 1: 0}, (7, 16)),          # three rounds either way
])
def test_chase_plan_takes_the_fewest_rounds_then_the_largest_cluster(nl, clusters, want):
    from slate_tpu_torch.ops import smem

    assert smem.chase_plan("hb2st", 64, torch.float32, nl, clusters)[:2] == want


@pytest.mark.parametrize("kind", ["hb2st", "tb2bd"])
@pytest.mark.parametrize("kd", [5, 256, 511])
def test_chase_window_shares_cover_the_window(kind, kd):
    """The blocks of a cluster of any size hold the whole window between
    them: hb2st's (kd, kd) bulge block by columns and the kd(kd+1)/2 stored
    entries of the symmetric block by pairs of columns (c, kd−1−c),
    kd + 1 entries a pair; tb2bd's two (kd, kd) blocks by columns and by
    rows."""
    from slate_tpu_torch.ops import smem

    for c in (1, 2, 4, 8, 16):
        s = smem.chase_share(kd, c)
        assert c * s >= kd > c * (s - 1)          # the least share that covers
        have = smem.chase_window_values(kind, kd, c)
        if kind == "hb2st":
            pairs = -(-(-(-kd // 2)) // c)
            assert have == s * kd + pairs * (kd + 1)
            assert c * pairs * (kd + 1) >= kd * (kd + 1) // 2
        else:
            assert have == s * kd + kd * (s + 1)
        assert c * have >= (kd * kd + kd * (kd + 1) // 2 if kind == "hb2st"
                            else 2 * kd * kd)


@pytest.mark.parametrize("which", ["hb2st", "tb2bd"])
def test_chase_wrappers_take_the_plain_route_on_the_cpu(which, monkeypatch):
    """On CPU tensors the chase wrappers run their plain versions (the
    same bits) and neither plan, launch nor count a kernel."""
    def refuse(*a, **k):
        raise AssertionError("no plan or launch on the CPU")

    monkeypatch.setattr(kernels, "_plan", refuse)
    monkeypatch.setattr(kernels, "_launch", refuse)
    kernels.reset_launches()
    n, kd = 48, 8
    rng = np.random.default_rng(3)
    if which == "hb2st":
        band = np.zeros((n, 2 * kd + 2))
        for d in range(kd + 1):
            band[:n - d, d] = rng.standard_normal(n - d)
        got = kernels.hb2st_wavefront(torch.from_numpy(band.copy()), kd)
        want = kernels.hb2st_wavefront_plain(torch.from_numpy(band.copy()), kd)
    else:
        band = np.zeros((n, 3 * kd + 2))
        for d in range(kd + 1):
            band[:n - d, kd + d] = rng.standard_normal(n - d)
        got = kernels.tb2bd_wavefront(torch.from_numpy(band.copy()), kd)
        want = kernels.tb2bd_wavefront_plain(torch.from_numpy(band.copy()), kd)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert kernels.launches[which + "_wavefront"] == 0
