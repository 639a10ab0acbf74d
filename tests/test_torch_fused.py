"""The port's fused and full step depths of potrf and getrf
(``potrf_step_fused``, ``potrf_full_fused``, ``getrf_step_fused``,
``getrf_full_fused`` and the drivers over them) against the JAX package,
on the same numpy inputs made from a seed.  On the CPU the port's
wrappers run their plain versions; the JAX package's Pallas kernels run
in interpret mode, called directly (the kernels, ``blocks.potrf_steps``,
``blocks.potrf_full`` and ``getrf_scattered(step=...)``), so that no JAX
knob or cached site decision is involved.

Tolerances: pivots and active masks exactly (the inputs have no ties);
carries and inverses within 1e-4 of the JAX package's largest entry
(the two packages sum in different orders, and the U rows grow past
max|A|); the tester's scaled residual ≤ 3, |L| ≤ 1 + 100ε and
scipy's pivots exactly for the LU drivers (tests/test_step_fused.py's
gates); factors and solutions within 1e-4 relative.  Within the port the
``full`` depths equal the ``fused`` ones bitwise, as the JAX package pins
(tests/test_full_fused.py)."""

import functools
import warnings

import numpy as np
import pytest
import scipy.linalg as sla
import torch

import jax
import jax.numpy as jnp

import slate_tpu_torch as tst
from slate_tpu.linalg.lu import getrf_scattered as jax_getrf_scattered
from slate_tpu.ops import blocks as jblocks
from slate_tpu.ops import pallas_kernels as pk
from slate_tpu_torch import config as tcfg
from slate_tpu_torch.linalg import lu as tlu
from slate_tpu_torch.ops import blocks as tblocks, kernels, smem
from slate_tpu_torch.perf import autotune as tauto
from slate_tpu_torch.perf import metrics

EPS32 = float(np.finfo(np.float32).eps)
F32 = torch.float32
FORCE = tauto.FORCE_ENV


@functools.lru_cache(maxsize=None)
def _jit(fn, **static):
    """One jitted JAX callable per (function, static arguments), so that
    the tests sharing a shape share one trace of the interpreted kernel
    (k0 stays a traced scalar, as the TPU kernels take it)."""
    return jax.jit(functools.partial(fn, **static))


def _spd(n, seed):
    g = np.random.default_rng(seed).standard_normal((n, n))
    return (g @ g.T + n * np.eye(n)).astype(np.float32)


def _gauss(m, n, seed):
    return np.random.default_rng(seed).standard_normal((m, n)).astype(
        np.float32)


def _max_rel(x, ref):
    """max |x − ref| over max |ref| (the JAX carry's largest entry: the
    U rows grow past max |A|, and their rounding with them)."""
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return np.abs(x - ref).max() / np.abs(ref).max()


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(x - ref) / np.linalg.norm(ref)


def _scipy_perm(a):
    """scipy's swap sequence replayed into a permutation vector."""
    _, piv = sla.lu_factor(np.asarray(a, np.float64), check_finite=False)
    want = np.arange(a.shape[0])
    for k, p in enumerate(piv):
        want[k], want[p] = want[p], want[k]
    return want


def _check_lu(a, lu, perm):
    """tests/test_step_fused.py:36-56: the tester's scaled residual ≤ 3,
    |L| ≤ 1 + 100ε, scipy's pivots exactly."""
    lu, perm = np.asarray(lu, np.float64), np.asarray(perm)
    m, n = a.shape
    k = min(m, n)
    assert sorted(perm.tolist()) == list(range(m))
    low = np.tril(lu[:, :k], -1) + np.eye(m, k)
    res = (np.abs(a[perm] - low @ np.triu(lu[:k])).max()
           / (np.abs(a).max() * max(m, n) * EPS32))
    assert res <= 3, res
    assert np.abs(np.tril(lu[:, :k], -1)).max() <= 1 + 100 * EPS32
    np.testing.assert_array_equal(perm[:k], _scipy_perm(a)[:k])


# ---------------------------------------------------------------------------
# (a) the plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k0", [(256, 0), (256, 128), (384, 0), (384, 128)])
def test_potrf_step_fused_plain_matches_pallas(n, k0):
    """One step at k0 from the same carry (at k0 = 128 the carry is the
    JAX package's own output of step 0), in place."""
    nb = tc = 128
    a = _spd(n, 50 + n)
    step = _jit(pk.potrf_step_fused, nb=nb, tc=tc)
    if k0:
        a = np.asarray(step(jnp.asarray(a), 0))
    ref = np.asarray(step(jnp.asarray(a), k0))
    carry = torch.from_numpy(a.copy())
    out = kernels.potrf_step_fused(carry, k0, nb=nb, tc=tc)
    assert out is carry
    assert _max_rel(carry.numpy(), ref) <= 1e-4
    # rows and columns before k0 and the upper block row pass through
    assert np.array_equal(carry.numpy()[:k0], a[:k0])
    assert np.array_equal(carry.numpy()[k0:k0 + nb, k0 + nb:],
                          a[k0:k0 + nb, k0 + nb:])
    assert np.all(np.triu(carry.numpy()[k0:k0 + nb, k0:k0 + nb], 1) == 0)


@pytest.mark.parametrize("n", [256, 384])
def test_potrf_full_fused_plain_matches_pallas(n):
    a = _spd(n, 60 + n)
    ref = np.asarray(_jit(pk.potrf_full_fused, nb=128, tc=128)(jnp.asarray(a)))
    got = kernels.potrf_full_fused(torch.from_numpy(a.copy()), nb=128, tc=128)
    assert _max_rel(got.numpy(), ref) <= 1e-4
    low = np.tril(got.numpy()).astype(np.float64)
    res = np.linalg.norm(low @ low.T - a) / (np.linalg.norm(a) * EPS32 * n)
    assert res <= 3, res


@pytest.mark.parametrize("update", [True, False])
@pytest.mark.parametrize("m,n", [(256, 256), (384, 256)])
def test_getrf_step_fused_plain_matches_pallas(m, n, update):
    """Steps k0 = 0 and 128 on the transposed carry of an (m, n) Gaussian
    A, each package chaining its own carry and mask."""
    nb, bb, ib = 128, 128, 16
    a = _gauss(m, n, 70 + m + update)
    at = a.T.copy()
    jc, ja = jnp.asarray(at), jnp.ones((1, m), jnp.float32)
    carry, act = torch.from_numpy(at.copy()), torch.ones((1, m))
    step = _jit(pk.getrf_step_fused, nb=nb, bb=bb, ib=ib, tc=128,
                update=update)
    for k0 in (0, nb):
        jc, jpiv, ja, jlinv = step(jc, ja, k0)
        out, piv, act, linv = kernels.getrf_step_fused(
            carry, act, k0, nb=nb, bb=bb, ib=ib, tc=128, update=update)
        assert out is carry and piv.dtype == torch.int64
        np.testing.assert_array_equal(piv.numpy(), np.asarray(jpiv))
        np.testing.assert_array_equal(act.numpy(), np.asarray(ja))
        assert _max_rel(carry.numpy(), np.asarray(jc)) <= 1e-4
        assert _max_rel(linv.numpy(), np.asarray(jlinv)) <= 1e-4
        if k0 == 0 and not update:
            # fused_trsm: past the panel only this step's pivot lanes change
            keep = np.ones(m, bool)
            keep[piv.numpy()] = False
            np.testing.assert_array_equal(carry.numpy()[nb:, keep],
                                          at[nb:, keep])


@pytest.mark.parametrize("m,n", [(256, 256), (384, 256)])
def test_getrf_full_fused_plain_matches_pallas(m, n):
    a = _gauss(m, n, 80 + m)
    at = a.T.copy()
    jc, jpiv, ja = _jit(pk.getrf_full_fused, nb=128, bb=128, ib=16, tc=128)(
        jnp.asarray(at), jnp.ones((1, m)))
    carry, piv, act = kernels.getrf_full_fused(
        torch.from_numpy(at.copy()), torch.ones((1, m)), nb=128, bb=128,
        ib=16, tc=128)
    assert piv.numel() == min(m, n)
    np.testing.assert_array_equal(piv.numpy(), np.asarray(jpiv))
    np.testing.assert_array_equal(act.numpy(), np.asarray(ja))
    assert _max_rel(carry.numpy(), np.asarray(jc)) <= 1e-4


# ---------------------------------------------------------------------------
# (b) the drivers at each depth against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", ["fused", "full"])
def test_posv_depth_matches_jax(depth, monkeypatch):
    """posv through the public entry point, the potrf_step site pinned:
    n = 1024 at nb = 256 is two 512-wide steps (posv's panel width)."""
    n = 1024
    a = _spd(n, 90)
    b = _gauss(n, 32, 91)
    fn = {"fused": jblocks.potrf_steps, "full": jblocks.potrf_full}[depth]
    jl = np.asarray(_jit(fn, nb=512)(jnp.asarray(a)), np.float64)
    jx = sla.cho_solve((jl, True), b.astype(np.float64))
    monkeypatch.setenv(FORCE, "potrf_step=%s" % depth)
    tauto._decisions.clear()
    fac, x = tst.posv(tst.HermitianMatrix(a, uplo=tst.Uplo.Lower, nb=256,
                                          device="cpu"), b)
    assert tauto.decisions()["potrf_step|1024,512,float32,cpu"] == depth
    assert _rel(fac.data.numpy(), jl) <= 1e-4
    assert _rel(x.numpy(), jx) <= 1e-4
    xd = x.double().numpy()
    assert (np.linalg.norm(a @ xd - b)
            / (np.linalg.norm(a) * np.linalg.norm(xd) * EPS32 * n)) <= 3


@pytest.mark.parametrize("depth", ["fused", "fused_trsm", "full"])
def test_getrf_scattered_depth_matches_jax(depth):
    """Both packages' scattered drivers at one depth, nb = 128: two steps
    at n = 256."""
    a = _gauss(256, 256, 92)
    jl, jp = _jit(jax_getrf_scattered, nb=128, step=depth)(jnp.asarray(a))
    tl, tp = tlu.getrf_scattered(torch.from_numpy(a), 128, step=depth)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert _max_rel(tl.numpy(), np.asarray(jl)) <= 1e-4
    _check_lu(a, tl.numpy(), tp.numpy())


@pytest.mark.parametrize("depth", ["fused", "fused_trsm", "full"])
def test_gesv_depth_matches_jax(depth, monkeypatch):
    """gesv through the public entry point with the lu_step site pinned,
    the scattered driver's panel width cut to 128 so that n = 256 takes
    two steps (the JAX package's kernels compiled at that shape are
    shared with the tests above)."""
    n = 256
    a = _gauss(n, n, 93)
    b = _gauss(n, 8, 94)
    jl, jp = _jit(jax_getrf_scattered, nb=128, step=depth)(jnp.asarray(a))
    jl, jp = np.asarray(jl, np.float64), np.asarray(jp)
    jx = sla.lu_solve((jl, np.arange(n)), b.astype(np.float64)[jp])
    monkeypatch.setattr(tlu, "_SCATTERED_NB", 128)
    monkeypatch.setenv(FORCE, "lu_step=%s" % depth)
    tauto._decisions.clear()
    lu, perm, x = tst.gesv(tst.Matrix.from_array(a, nb=128, device="cpu"), b)
    assert tauto.decisions()["lu_step|256,256,128,float32,cpu"] == depth
    np.testing.assert_array_equal(perm.numpy(), jp)
    assert _rel(lu.data.numpy(), jl) <= 1e-4
    assert _rel(x.numpy(), jx) <= 1e-4
    _check_lu(a, lu.data.numpy(), perm.numpy())


# ---------------------------------------------------------------------------
# (c) within the port
# ---------------------------------------------------------------------------

def test_posv_full_equals_fused_bitwise(monkeypatch):
    a = _spd(1024, 95)
    b = _gauss(1024, 4, 96)
    out = {}
    for depth in ("fused", "full"):
        monkeypatch.setenv(FORCE, "potrf_step=%s" % depth)
        out[depth] = tst.posv(tst.HermitianMatrix(
            a, uplo=tst.Uplo.Lower, nb=256, device="cpu"), b)
    assert torch.equal(out["fused"][0].data, out["full"][0].data)
    assert torch.equal(out["fused"][1], out["full"][1])


def test_getrf_full_equals_fused_bitwise():
    a = torch.from_numpy(_gauss(384, 384, 97))
    lf, pf = tlu.getrf_scattered(a, 128, step="fused")
    lF, pF = tlu.getrf_scattered(a, 128, step="full")
    assert torch.equal(pf, pF) and torch.equal(lf, lF)


def _spy(monkeypatch, name):
    """Count the calls of wrapper ``kernels.<name>`` (on the CPU the
    launch counts stay 0: the plain version runs)."""
    calls = []
    real = getattr(kernels, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(kernels, name, spy)
    return calls


def _counted(fn) -> dict:
    """The metrics snapshot of ``fn`` alone, with no launch counted; the
    registry is restored after."""
    was = metrics.enabled()
    metrics.on()
    metrics.reset()
    kernels.reset_launches()
    try:
        fn()
        snap = metrics.snapshot()
    finally:
        metrics.reset()
        if not was:
            metrics.off()
    assert all(v == 0 for v in kernels.launches.values())
    return snap


@pytest.mark.parametrize("depth,roundtrips,wrapper,calls", [
    ("fused", 0, "getrf_step_fused", 3),
    ("fused_trsm", 2, "getrf_step_fused", 3),
    ("full", 0, "getrf_full_fused", 1),
    ("composed", 6, "getrf_panel_fused", 3)])
def test_lu_depth_roundtrips_and_launches(depth, roundtrips, wrapper, calls,
                                          monkeypatch):
    """n = 384, nb = 128: three steps, two with a trailing block.  The
    fused depths round-trip nothing, fused_trsm once a step (its rank-nb
    update), the composed depth three times; one kernel call a step, or
    one in all for full."""
    seen = _spy(monkeypatch, wrapper)
    snap = _counted(lambda: tlu.getrf_scattered(
        torch.from_numpy(_gauss(384, 384, 98)), 128, step=depth))
    assert snap["counters"].get(metrics.STEP_HBM_ROUNDTRIPS, 0.0) == roundtrips
    assert snap["counters"]["step.getrf.steps"] == 3
    assert len(seen) == calls


@pytest.mark.parametrize("depth,wrapper,calls", [
    ("fused", "potrf_step_fused", 2), ("full", "potrf_full_fused", 1)])
def test_potrf_depth_roundtrips_and_launches(depth, wrapper, calls,
                                             monkeypatch):
    seen = _spy(monkeypatch, wrapper)
    monkeypatch.setenv(FORCE, "potrf_step=%s" % depth)
    snap = _counted(lambda: tst.potrf(tst.HermitianMatrix(
        _spd(1024, 99), uplo=tst.Uplo.Lower, nb=256, device="cpu")))
    assert snap["counters"].get(metrics.STEP_HBM_ROUNDTRIPS, 0.0) == 0
    assert snap["counters"]["step.potrf.steps"] == 2
    assert "step.potrf.%s" % depth in snap["timers"]
    assert len(seen) == calls


def _c_lu_bytes(m, nb, ib, grid):
    """The LU step and full kernels' shared memory as their C entries
    compute it: ``lu_panel.cuh`` ``dyn_floats`` over ``smem_floats`` and
    ``lu_full.cuh`` ``trail_floats`` (tri_grid.cuh's eight 32 × 36 blocks,
    the step's nb pivot lanes, a tile's 128 lanes)."""
    chunk, nown = -(-m // grid), -(-nb // grid)
    panel = (nb * chunk + ib * nb + nown * nb + ib * ib + ib * nown + 2 * chunk
             + 64)
    return 4 * max(panel, 8 * 32 * 36 + nb + 128)


def _old_lu_fits(m, n, nb):
    """The LU gate as it stood while the step kernel had a trailing phase
    of its own: the larger of that kernel's share (two 16 × 132 slabs and
    a 128-lane mask) and the full kernel's, at the first grid."""
    if m < nb or nb % 128 or n % nb:
        return False
    grid = smem._first_grid(m)
    step = max(smem.lu_panel_bytes(m, nb, 16, grid), 4 * (2 * 16 * 132 + 128))
    return smem.fits(max(step, smem.lu_full_bytes(m, nb, 16, grid)))


def test_gates_follow_smem():
    """The shape rules of the JAX gates on the H100's constants: the main
    path's shapes pass, and the LU kernels stop where one block's share
    of the panel passes the opt-in limit.  The LU step and full kernels
    take one formula (:func:`smem.lu_full_bytes`, what their C entries
    compute at every (m, nb, grid)), and the gate admits and refuses
    exactly the shapes it did while the step kernel had a smaller
    trailing share of its own."""
    assert smem.potrf_fused_fits(8192, 512, F32)
    for n, nb, dt in ((8192, 64, F32), (8192, 384, F32), (1000, 128, F32),
                      (512, 512, F32), (8192, 512, torch.float64)):
        assert not smem.potrf_fused_fits(n, nb, dt)
    assert smem.lu_fused_fits(8192, 8192, 512, F32)
    for m in (128, 256, 2048, 8192, 12144):
        for nb in (128, 512):
            for grid in (1, 8, 64, 132):
                assert smem.lu_full_bytes(m, nb, 16, grid) == _c_lu_bytes(
                    m, nb, 16, grid)
    assert smem.lu_full_bytes(8192, 512, 16, 132) == smem.lu_panel_bytes(
        8192, 512, 16, 132)
    # one lane a block: the product tiles outgrow the panel's share
    assert smem.lu_full_bytes(132, 128, 16, 132) == \
        4 * (smem.LU_FULL_TRAIL_FLOATS + 128) > smem.lu_panel_bytes(132, 128, 16, 132)
    assert smem.lu_fused_fits(12144, 8192, 512, F32)
    assert not smem.lu_fused_fits(12160, 8192, 512, F32)
    for m in list(range(32, 16385, 464)) + [12144, 12160]:
        for nb in (128, 256, 512):
            assert smem.lu_fused_fits(m, 8192, nb, F32) == _old_lu_fits(m, 8192, nb)
    for m, n, nb, dt in ((8192, 8192, 192, F32), (8192, 8192, 512,
                                                  torch.float64),
                         (8192, 8000, 512, F32), (64, 256, 128, F32)):
        assert not smem.lu_fused_fits(m, n, nb, dt)


@pytest.mark.parametrize("n", [2048, 8192])
def test_full_depth_follows_the_full_kernels_smem(n, monkeypatch):
    """The LU step and full kernels' shared memory (``csrc/lu_full.cuh``:
    the panel's share, in which they keep their lanes' indices and pivot
    columns where the panel kernel keeps its mask and marks, or the
    trailing tiles with the step's pivot lanes) is what
    ``smem.lu_full_bytes`` counts; at the drivers' shapes it equals the
    panel kernel's, the gate holds both depths, and a pinned ``full`` or
    ``fused`` depth is taken there."""
    grid = smem._first_grid(n)
    assert grid == min(smem.SMS, n // smem.MIN_LANES)
    full = smem.lu_full_bytes(n, 512, 16, grid)
    assert full == smem.lu_panel_bytes(n, 512, 16, grid) == _c_lu_bytes(n, 512, 16, grid)
    assert smem.fits(full) and smem.lu_fused_fits(n, n, 512, F32)
    for m in (128, 1024, n, 12144, 12160):
        g = smem._first_grid(m)
        assert smem.lu_fused_fits(m, n, 512, F32) == (
            m >= 512 and smem.fits(smem.lu_full_bytes(m, 512, 16, g)))
    monkeypatch.setattr(tauto, "_warned_forces", set())
    for depth in ("full", "fused"):
        monkeypatch.setenv(FORCE, "lu_step=" + depth)
        assert tauto.choose_lu_step(n, n, 512, F32, "cpu",
                                    smem.lu_fused_fits(n, n, 512, F32)) == depth


class _Lib:
    """A stand-in for a kernel library whose shared-memory entry answers
    ``fn``."""

    def __init__(self, name, fn):
        setattr(self, "slate_%s_smem_bytes" % name, fn)


@pytest.mark.parametrize("name", ["potrf_step_fused", "potrf_full_fused",
                                  "getrf_step_fused", "getrf_full_fused"])
def test_loader_holds_the_fused_kernels_to_one_formula(name):
    """When ``ops/kernels.py`` loads a fused kernel it checks the
    library's own shared-memory count: both Cholesky kernels against
    ``tri_grid.cuh``'s static blocks, both LU kernels against
    :func:`smem.lu_full_bytes`.  A library that reports what the step
    kernels took before they ran the full kernels' code (``tri_panel.cuh``'s
    staging for the Cholesky step, the LU step's smaller trailing share)
    is refused."""
    check = kernels._SMEM_CHECKS[name]
    if name.startswith("potrf"):
        check(_Lib(name, lambda: smem.TRI_GRID_SMEM), name)
        old = 4 * (2 * 32 * 132 + 2 * 32 * 33)
        with pytest.raises(RuntimeError):
            check(_Lib(name, lambda: old), name)
        return
    check(_Lib(name, _c_lu_bytes), name)

    def old_step(m, nb, ib, grid):
        return max(smem.lu_panel_bytes(m, nb, ib, grid), 4 * (2 * 16 * 132 + 128))

    with pytest.raises(RuntimeError):
        check(_Lib(name, old_step), name)


def test_gates_off_with_kernels_off(monkeypatch):
    """Kernels switched off close both step sites, even where the gate
    holds and a depth is pinned."""
    monkeypatch.setattr(tcfg, "use_kernels", False)
    monkeypatch.setattr(tauto, "_warned_forces", set())
    monkeypatch.setenv(FORCE, "potrf_step=full,lu_step=full")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert tauto.choose_potrf_step(8192, 512, F32, "cpu", True) == \
            "composed"
        assert tauto.choose_lu_step(8192, 8192, 512, F32, "cpu", True) == \
            "composed"
    assert tauto.decisions(with_reasons=True)[
        "lu_step|8192,8192,512,float32,cpu"] == ("composed", "kernels off")


@pytest.mark.parametrize("bad", ["nb64", "tc", "k0", "square"])
def test_potrf_wrappers_reject_what_the_gate_refuses(bad):
    a = torch.from_numpy(_spd(256, 100))
    with pytest.raises(ValueError):
        if bad == "nb64":
            kernels.potrf_step_fused(a, 0, nb=64, tc=64)
        elif bad == "tc":
            kernels.potrf_full_fused(a, nb=128, tc=96)
        elif bad == "k0":
            kernels.potrf_step_fused(a, 64, nb=128)
        else:
            kernels.potrf_full_fused(a[:, :128].contiguous(), nb=128)


@pytest.mark.parametrize("bad", ["nb", "rows", "lanes", "full"])
def test_lu_wrappers_reject_what_the_gate_refuses(bad):
    at = torch.from_numpy(_gauss(256, 256, 101))
    act = torch.ones((1, 256))
    with pytest.raises(ValueError):
        if bad == "nb":
            kernels.getrf_step_fused(at, act, 0, nb=64, bb=64)
        elif bad == "rows":
            kernels.getrf_step_fused(at[:200].contiguous(), act, 0, nb=128)
        elif bad == "lanes":
            kernels.getrf_step_fused(at[:, :128].contiguous(),
                                     act[:, :128].contiguous(), 0, nb=256)
        else:
            kernels.getrf_full_fused(at[:, :192].contiguous(),
                                     act[:, :192].contiguous(), nb=128)


def test_ineligible_pin_resolves_to_composed_and_warns_once(monkeypatch):
    """A pinned depth the gates refuse (n = 512 is one 512-wide block:
    nothing to fuse) resolves to composed, with one warning per (site,
    depth) however often the site is asked."""
    monkeypatch.setattr(tauto, "_warned_forces", set())
    monkeypatch.setenv(FORCE, "potrf_step=full")
    a = tst.HermitianMatrix(_spd(512, 102), uplo=tst.Uplo.Lower, nb=256,
                            device="cpu")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        tst.potrf(a)
        tst.potrf(a)
    ours = [w for w in seen if FORCE in str(w.message)]
    assert len(ours) == 1 and "potrf_step='full'" in str(ours[0].message)
    assert tauto.decisions(with_reasons=True)[
        "potrf_step|512,512,float32,cpu"] == ("composed", "ineligible")


def test_bad_pin_warns_once_and_no_pin_answers_composed(monkeypatch):
    monkeypatch.setattr(tauto, "_warned_forces", set())
    cuda = torch.device("cuda")
    assert tauto.choose_lu_step(8192, 8192, 512, F32, cuda, True) == \
        "composed"
    key = "lu_step|8192,8192,512,float32,cuda"
    backend, reason = tauto.decisions(with_reasons=True)[key]
    assert backend == "composed" and "no timed decision" in reason
    monkeypatch.setenv(FORCE, "lu_step=fused_trsm")
    assert tauto.choose_lu_step(8192, 8192, 512, F32, cuda, True) == \
        "fused_trsm"
    monkeypatch.setenv(FORCE, "lu_step=bogus")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        for _ in range(3):
            assert tauto.choose_lu_step(8192, 8192, 512, F32, cuda,
                                        True) == "composed"
    assert len([w for w in seen if "bogus" in str(w.message)]) == 1
    assert tauto.select("lu_step", m=512, n=512, nb=512, dtype=F32,
                        device="cpu", eligible=True) == "composed"
