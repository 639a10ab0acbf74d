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
    kernels.matmul(torch.zeros(128, 128), torch.zeros(128, 128))
    assert kernels.launches == {"matmul": 0, "chol_inv_panel": 0,
                                "trtri_panel": 0}


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
