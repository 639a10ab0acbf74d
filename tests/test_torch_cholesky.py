"""The port's fp32 Cholesky slice (gemm, potrf, potrs, posv, trtri, trtrm,
potri, and the BLAS-3 drivers beside them) against the JAX package's
default CPU path, on the same numpy inputs made from a seed.  Gates are
the reference tester's scaled residuals (‖b − A·x‖ / (‖A‖·‖x‖·ε·n) ≤ 3)
plus agreement with the JAX result."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import slate_tpu as jst
import slate_tpu_torch as tst
from slate_tpu_torch import config as tcfg
from slate_tpu_torch.interop import matrix_from_numpy, matrix_to_numpy

ROOT = Path(__file__).resolve().parents[1]
EPS32 = float(np.finfo(np.float32).eps)
UPLOS = ["lower", "upper"]


def _spd(n, seed):
    """Well-conditioned SPD matrix g·gᵀ + n·I in fp32."""
    g = np.random.default_rng(seed).standard_normal((n, n))
    return (g @ g.T + n * np.eye(n)).astype(np.float32)


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(x - ref) / np.linalg.norm(ref)


def _posv_residual(a, b, x):
    a, b, x = (np.asarray(v, np.float64) for v in (a, b, x))
    n = a.shape[0]
    return (np.linalg.norm(a @ x - b)
            / (np.linalg.norm(a) * np.linalg.norm(x) * EPS32 * n))


@pytest.mark.parametrize("uplo", UPLOS)
def test_posv_matches_jax(uplo):
    n, nb, nrhs = 1024, 256, 128        # nbsel = 512: two panels
    a = _spd(n, 10)
    b = np.random.default_rng(11).standard_normal((n, nrhs)).astype(np.float32)
    ja = jst.HermitianMatrix(jnp.asarray(a), uplo=jst.Uplo(uplo), mb=nb, nb=nb)
    _, jx = jst.posv(ja, jnp.asarray(b))
    ta = tst.HermitianMatrix(a, uplo=tst.Uplo(uplo), mb=nb, nb=nb,
                             device="cpu")
    fac, tx = tst.posv(ta, b)
    assert isinstance(fac, tst.TriangularMatrix) and fac.uplo is tst.Uplo(uplo)
    assert tx.device.type == "cpu" and tx.dtype == torch.float32
    assert _posv_residual(a, b, tx.numpy()) <= 3
    assert _posv_residual(a, b, np.asarray(jx)) <= 3
    assert _rel(tx.numpy(), np.asarray(jx)) <= 1e-4
    # the factor itself: L·Lᴴ reproduces A in the tester's potrf units
    f = fac.data.numpy().astype(np.float64)
    rec = f @ f.T if uplo == "lower" else f.T @ f
    assert np.linalg.norm(rec - a) / (np.linalg.norm(a) * EPS32 * n) <= 3


@pytest.mark.parametrize("uplo", UPLOS)
def test_potri_matches_jax(uplo):
    n, nb = 1024, 256
    a = _spd(n, 12)
    jf = jst.potrf(jst.HermitianMatrix(jnp.asarray(a), uplo=jst.Uplo(uplo),
                                       mb=nb, nb=nb))
    jinv = np.asarray(jst.potri(jf).data)
    tf = tst.potrf(tst.HermitianMatrix(a, uplo=tst.Uplo(uplo), mb=nb, nb=nb,
                                       device="cpu"))
    tinv = tst.potri(tf)
    assert isinstance(tinv, tst.HermitianMatrix)
    d = tinv.data.numpy().astype(np.float64)
    if uplo == "lower":
        full, jfull = np.tril(d) + np.tril(d, -1).T, np.tril(jinv)
    else:
        full, jfull = np.triu(d) + np.triu(d, 1).T, np.triu(jinv)
    # the tester's potri check: ‖A⁻¹·A − I‖ / (ε·n·κ₁(A)) ≤ 3
    err = (np.linalg.norm(full @ a - np.eye(n))
           / (EPS32 * n * np.linalg.cond(a.astype(np.float64), 1)))
    assert err <= 3
    tri = np.tril(d) if uplo == "lower" else np.triu(d)
    assert _rel(tri, jfull) <= 1e-4


def test_trtri_trtrm_match_jax():
    n, nb = 256, 64
    rng = np.random.default_rng(13)
    l = (np.tril(rng.standard_normal((n, n))) + n * np.eye(n)).astype(np.float32)
    jl = jst.TriangularMatrix(jnp.asarray(l), uplo=jst.Uplo.Lower, nb=nb)
    tl = tst.TriangularMatrix(l, uplo=tst.Uplo.Lower, nb=nb, device="cpu")
    jinv = np.asarray(jst.trtri(jl).data)
    tinv = tst.trtri(tl).data.numpy()
    assert _rel(tinv, jinv) <= 1e-5
    jprod = np.asarray(jst.trtrm(jl).data)
    tprod = tst.trtrm(tl).data.numpy()
    assert _rel(np.tril(tprod), np.tril(jprod)) <= 1e-5


@pytest.mark.parametrize("shape", [(1024, 1024, 1024), (100, 70, 50)])
def test_gemm_matches_jax(shape):
    m, k, n = shape
    rng = np.random.default_rng(14)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    c = rng.standard_normal((m, n)).astype(np.float32)
    ref = np.asarray(jst.gemm(1.5, jnp.asarray(a), jnp.asarray(b), -0.5,
                              jnp.asarray(c)))
    got = tst.gemm(1.5, a, b, -0.5, c, device="cpu")
    assert got.device.type == "cpu"
    assert _rel(got.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("uplo", UPLOS)
def test_trsm_trmm_match_jax(side, uplo):
    n, nrhs, nb = 96, 40, 32
    rng = np.random.default_rng(15)
    t = (rng.standard_normal((n, n)) + n * np.eye(n)).astype(np.float32)
    b = rng.standard_normal((n, nrhs) if side == "left"
                            else (nrhs, n)).astype(np.float32)
    jt = jst.TriangularMatrix(jnp.asarray(t), uplo=jst.Uplo(uplo), nb=nb)
    tt = tst.TriangularMatrix(t, uplo=tst.Uplo(uplo), nb=nb, device="cpu")
    js, ts = jst.Side(side), tst.Side(side)
    assert _rel(tst.trsm(ts, 2.0, tt, b).numpy(),
                np.asarray(jst.trsm(js, 2.0, jt, jnp.asarray(b)))) <= 1e-5
    assert _rel(tst.trmm(ts, 2.0, tt, b).numpy(),
                np.asarray(jst.trmm(js, 2.0, jt, jnp.asarray(b)))) <= 1e-5


@pytest.mark.parametrize("uplo", UPLOS)
def test_herk_matches_jax(uplo):
    n, k = 96, 40
    rng = np.random.default_rng(16)
    a = rng.standard_normal((n, k)).astype(np.float32)
    c = rng.standard_normal((n, n)).astype(np.float32)
    jc = jst.HermitianMatrix(jnp.asarray(c), uplo=jst.Uplo(uplo), nb=32)
    tc = tst.HermitianMatrix(c, uplo=tst.Uplo(uplo), nb=32, device="cpu")
    ref = np.asarray(jst.herk(0.5, jnp.asarray(a), 2.0, jc).data)
    got = tst.herk(0.5, a, 2.0, tc).data.numpy()
    assert _rel(got, ref) <= 1e-5


def test_potrf_stock_branches_agree(monkeypatch):
    """fp64 and SLATE_TPU_TORCH_USE_KERNELS=0 take torch.linalg.cholesky,
    as the JAX package takes XLA's off-TPU; an explicit method_factor
    takes the nb recursion."""
    n = 512
    a = _spd(n, 17)
    ref = np.linalg.cholesky(a.astype(np.float64))
    base = tst.potrf(tst.HermitianMatrix(a, uplo=tst.Uplo.Lower, nb=256,
                                         device="cpu")).data.numpy()
    f64 = tst.potrf(tst.HermitianMatrix(a.astype(np.float64),
                                        uplo=tst.Uplo.Lower, nb=256,
                                        device="cpu")).data
    assert f64.dtype == torch.float64
    rec = tst.potrf(tst.HermitianMatrix(a, uplo=tst.Uplo.Lower, nb=128,
                                        device="cpu"),
                    {"method_factor": "recursive"}).data.numpy()
    monkeypatch.setattr(tcfg, "use_kernels", False)
    off = tst.potrf(tst.HermitianMatrix(a, uplo=tst.Uplo.Lower, nb=256,
                                        device="cpu")).data.numpy()
    for got in (base, rec, off):
        assert _rel(got, ref) <= 1e-5
    assert _rel(f64.numpy(), ref) <= 1e-12


@pytest.mark.parametrize("kind", ["Matrix", "TriangularMatrix",
                                  "HermitianMatrix", "SymmetricMatrix"])
def test_interop_round_trip(kind):
    rng = np.random.default_rng(18)
    a = rng.standard_normal((64, 64)).astype(np.float32)
    cls = getattr(jst, kind)
    if kind == "Matrix":
        jm = cls(jnp.asarray(a), mb=32, nb=16)
        tm = matrix_from_numpy(kind, np.asarray(jm.data), mb=jm.mb,
                               nb=jm.nb, device="cpu")
    else:
        jm = cls(jnp.asarray(a), uplo=jst.Uplo.Upper, diag=jst.Diag.Unit,
                 mb=32, nb=16)
        tm = matrix_from_numpy(kind, np.asarray(jm.data), uplo=jm.uplo,
                               diag=jm.diag.value, mb=jm.mb, nb=jm.nb,
                               device="cpu")
        assert tm.uplo is tst.Uplo.Upper and tm.diag is tst.Diag.Unit
    assert type(tm).__name__ == kind and (tm.mb, tm.nb) == (32, 16)
    back = matrix_to_numpy(tm)
    assert back["kind"] == kind and np.array_equal(back["data"], a)
    assert (back["mb"], back["nb"]) == (32, 16)
    if kind != "Matrix":
        assert (back["uplo"], back["diag"]) == ("upper", "unit")
        assert jst.Uplo(back["uplo"]) is jm.uplo


def test_matrix_views():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    m = tst.Matrix(a, mb=2, nb=3, device="cpu")
    assert (m.m, m.n, m.mt, m.nt) == (3, 4, 2, 2)
    t = m.transpose()
    assert (t.m, t.n, t.mb, t.nb) == (4, 3, 3, 2)
    assert torch.equal(t.tile(1, 0), m.tile(0, 1).T)
    assert torch.equal(tst.as_array(t), torch.from_numpy(a.T))
    h = tst.HermitianMatrix(np.eye(4, dtype=np.float32), uplo=tst.Uplo.Lower,
                            device="cpu")
    assert h.conj_transpose().logical_uplo is tst.Uplo.Upper
    with pytest.raises(tst.SlateError):
        t.conj_transpose()


def test_metrics_count_only_when_on():
    from slate_tpu_torch.perf import metrics

    n = 1024
    a = tst.HermitianMatrix(_spd(n, 20), uplo=tst.Uplo.Lower, nb=256,
                            device="cpu")
    b = np.ones((n, 128), np.float32)
    metrics.off()
    metrics.reset()
    tst.posv(a, b)
    assert metrics.snapshot()["counters"] == {}
    metrics.on()
    try:
        tst.posv(a, b)
        snap = metrics.snapshot()
    finally:
        metrics.off()
        metrics.reset()
    assert snap["counters"]["driver.posv.calls"] == 1
    # two 512-wide panels: one L21 write-back + one strip after the first
    assert snap["counters"]["step.hbm_roundtrips"] == 2
    assert snap["timers"]["step.potrf.panel"]["count"] == 2
    assert snap["timers"]["driver.potrf"]["count"] == 1


def test_asking_for_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    a = _spd(64, 19)
    with pytest.raises(tst.SlateError, match="no CUDA device"):
        tst.HermitianMatrix(a, uplo=tst.Uplo.Lower)
    with pytest.raises(tst.SlateError, match="no CUDA device"):
        tst.HermitianMatrix(a, uplo=tst.Uplo.Lower, device="cuda")
    with pytest.raises(tst.SlateError, match="no CUDA device"):
        tst.gemm(1.0, a, a, 0.0, a)


_POISON = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["slate_tpu"] = None
sys.path.insert(0, {root!r})
{body}
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and (m in ("jax", "slate_tpu")
                  or m.startswith(("jax.", "jaxlib", "slate_tpu."))))
assert not bad, bad
print("OK")
"""

_WALK = """
import slate_tpu_torch
for info in pkgutil.walk_packages(slate_tpu_torch.__path__, "slate_tpu_torch."):
    importlib.import_module(info.name)
"""


@pytest.mark.parametrize("target", ["package", "chip_smoke"])
def test_port_imports_no_jax(target):
    body = _WALK if target == "package" else "import chip_smoke"
    out = subprocess.run(
        [sys.executable, "-c", _POISON.format(root=str(ROOT), body=body)],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr[-2000:]


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(ROOT), env=dict(os.environ))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
