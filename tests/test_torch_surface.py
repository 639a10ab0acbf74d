"""The port's public surface and its kernel build's inputs.

* Every public name of ``slate_tpu.linalg`` (its ``dir()`` without leading
  underscores: it has no ``__all__``) that a module of
  ``slate_tpu_torch.linalg`` defines is an attribute of
  ``slate_tpu_torch.linalg`` and of ``slate_tpu_torch``, the same object
  in both, and one of the port's own definitions of that name.
* Every kernel of ``slate_tpu_torch.ops._build.SOURCES`` lists each local
  header its ``.cu`` reaches through ``#include "..."``, followed
  transitively: a library's digest covers only the files listed there, so
  an unlisted header would leave a stale library on the card after an
  edit.
"""

import importlib
import importlib.util
import inspect
import pkgutil
import re

import pytest

import slate_tpu.linalg as jax_linalg
import slate_tpu_torch
import slate_tpu_torch.linalg as port_linalg
from slate_tpu_torch.ops import _build

PUBLIC = sorted(n for n in dir(jax_linalg) if not n.startswith("_"))
MODULES = sorted(m.name for m in pkgutil.iter_modules(port_linalg.__path__))


def _defined(module, name):
    """``module``'s own function or class ``name`` (not an import), or None."""
    obj = getattr(module, name, None)
    if (inspect.isfunction(obj) or inspect.isclass(obj)) and \
            obj.__module__ == module.__name__:
        return obj
    return None


@pytest.mark.parametrize("sub", MODULES)
def test_linalg_definitions_are_exported(sub):
    module = importlib.import_module("slate_tpu_torch.linalg." + sub)
    missing, astray = [], []
    for name in PUBLIC:
        if _defined(module, name) is None:
            continue
        if not hasattr(port_linalg, name) or not hasattr(slate_tpu_torch, name):
            missing.append(name)
            continue
        got = getattr(port_linalg, name)
        owners = [_defined(importlib.import_module("slate_tpu_torch.linalg." + m), name)
                  for m in MODULES]
        if getattr(slate_tpu_torch, name) is not got or got not in owners:
            astray.append(name)
    assert not missing, "%s defines %s, which slate_tpu.linalg exports and " \
        "the port does not" % (sub, missing)
    assert not astray, "%s: %s are other objects at the top level or not the " \
        "port's own definitions" % (sub, astray)


def test_linalg_surface_covers_the_stedc_family():
    for name in ("hb2st", "unmtr_hb2st", "sterf", "steqr", "stedc", "stemr",
                 "stedc_deflate", "stedc_merge", "stedc_secular", "stedc_solve",
                 "stedc_sort", "stedc_z_vector"):
        assert getattr(slate_tpu_torch, name) is getattr(port_linalg, name)
    from slate_tpu_torch.linalg import eig
    assert port_linalg.stedc is eig.stedc     # as slate_tpu.linalg.stedc is eig's


def test_linalg_surface_covers_the_dense_solver_slice():
    """The tall LU, CALU, QDWH and hesv names: exported at both levels,
    as the JAX package exports them, each the port's own module's."""
    import slate_tpu

    hesv, lu, polar = (importlib.import_module("slate_tpu_torch.linalg." + m)
                       for m in ("hesv", "lu", "polar"))
    for name, mod in (("getrf_tntpiv", lu), ("polar", polar),
                      ("heev_qdwh", polar), ("svd_qdwh", polar),
                      ("hetrf", hesv), ("hetrs", hesv), ("hesv", hesv),
                      ("sytrf", hesv), ("sytrs", hesv), ("sysv", hesv)):
        assert hasattr(slate_tpu, name) and hasattr(jax_linalg, name), name
        got = getattr(port_linalg, name)
        assert getattr(slate_tpu_torch, name) is got is getattr(mod, name)
    assert port_linalg.sysv is hesv.hesv and port_linalg.sytrf is hesv.hetrf


#: the rest of the core surface (ROADMAP queue 1 item 4), by module: each
#: name is exported where the JAX package exports it
CORE_SURFACE = {
    "": ("symm", "hemm", "syr2k", "her2k", "gemmA", "gemmC", "hemmA",
         "hemmC", "trsmA", "trsmB", "Layout", "TileKind", "MethodGemm",
         "MethodHemm", "MethodTrsm", "MethodCholQR", "TrapezoidMatrix",
         "print_matrix", "sprint_matrix", "redistribute", "MOSI"),
    ".linalg": ("symm", "hemm", "syr2k", "her2k", "gemmA", "gemmC",
                "hemmA", "hemmC", "trsmA", "trsmB"),
    ".enums": ("Layout", "TileKind", "MOSI", "MethodGemm", "MethodHemm",
               "MethodTrsm", "MethodCholQR"),
    ".method": ("select_gemm", "select_trsm", "select_hemm",
                "select_cholqr", "select_eig", "select_svd"),
    ".matrix": ("TrapezoidMatrix",),
    ".printing": ("print_matrix", "sprint_matrix", "redistribute"),
    ".debug": ("check_finite", "check_dist_layout", "check_pool_leaks",
               "device_memory_stats", "memory_stats"),
    ".testing": ("generate_matrix", "random_spd"),
    ".testing.matgen": ("generate_matrix", "random_spd"),
    ".ops.tilepool": ("TilePool", "window_tiles", "prefetch_depth",
                      "hbm_budget_bytes", "ooc_nb"),
    ".linalg.ooc": ("getrf_ooc", "potrf_ooc", "ooc_nb", "pool_eligible",
                    "choose"),
}


@pytest.mark.parametrize("sub", sorted(CORE_SURFACE))
def test_core_surface_exported_where_jax_exports_it(sub):
    """Each name of :data:`CORE_SURFACE` that ``slate_tpu<sub>`` has,
    ``slate_tpu_torch<sub>`` has too (and no JAX-side name is missing from
    the list's module, so the list stays true); a name at the top level is
    the same object as in its defining module."""
    jmod = importlib.import_module("slate_tpu" + sub)
    pmod = importlib.import_module("slate_tpu_torch" + sub)
    for name in CORE_SURFACE[sub]:
        if not hasattr(jmod, name):
            assert name == "MOSI" and sub == "", (sub, name)
            continue
        assert hasattr(pmod, name), (sub, name)
        obj = getattr(pmod, name)
        if inspect.isfunction(obj) or inspect.isclass(obj):
            owner = importlib.import_module(obj.__module__)
            assert getattr(owner, name) is obj, (sub, name)
            assert owner.__name__.startswith("slate_tpu_torch."), (sub, name)


#: public names of ``slate_tpu.parallel`` defined in a module the port has
#: but queued for a later slice; empty since the mixed drivers, pgetri and
#: pgecondest landed.  The test fails when a queued name lands unexported
#: or this set goes stale
PARALLEL_QUEUED = set()


def test_parallel_surface_matches_the_ported_modules():
    """Every public function of ``slate_tpu.parallel`` whose defining
    module the port has is exported by ``slate_tpu_torch.parallel`` (but
    :data:`PARALLEL_QUEUED`), and wrapped by the tile-map ingestion
    (``__wrapped_driver__``) exactly where the JAX package wraps it."""
    import slate_tpu.parallel as jax_parallel
    import slate_tpu_torch.parallel as port_parallel

    missing, queued, wrapping = [], [], []
    for name in sorted(n for n in dir(jax_parallel) if not n.startswith("_")):
        obj = getattr(jax_parallel, name)
        if not inspect.isfunction(obj):
            continue
        sub = obj.__module__.rpartition(".")[2]
        if importlib.util.find_spec("slate_tpu_torch.parallel." + sub) is None:
            continue
        if name in PARALLEL_QUEUED:
            if hasattr(port_parallel, name):
                queued.append(name)
            continue
        got = getattr(port_parallel, name, None)
        if got is None:
            missing.append(name)
        elif hasattr(obj, "__wrapped_driver__") != hasattr(
                got, "__wrapped_driver__"):
            wrapping.append(name)
    assert not missing, "not exported: %s" % missing
    assert not queued, "exported now, drop from PARALLEL_QUEUED: %s" % queued
    assert not wrapping, "wrapped unlike the JAX package: %s" % wrapping
    for name in ("pgeqrf", "pgels", "punmqr_conj", "pgelqf", "punmlq",
                 "pnorm", "pcolnorms", "pherk", "psyrk", "pher2k", "psyr2k",
                 "ptri_mask", "ptrmm", "phemm", "psymm", "ptrsm", "peye",
                 "ptranspose", "predistribute", "phermitize", "phe2hb",
                 "pge2tb", "pheev", "psvd", "punmtr_he2hb", "punmbr_ge2tb_q",
                 "punmbr_ge2tb_p", "band_tiles_to_dense",
                 "band_tiles_to_banded", "ppbsv", "pgbsv", "pgbmm", "phbmm",
                 "ptbsm", "phetrf", "phetrs", "phesv", "ppolar",
                 "pheev_qdwh", "psvd_qdwh", "pposv_mixed",
                 "pposv_mixed_gmres", "pgesv_mixed", "pgetri",
                 "pgecondest"):
        assert callable(getattr(port_parallel, name)), name


def test_resilience_surface_matches_the_jax_package():
    """Every public name of ``slate_tpu.resilience`` is exported by
    ``slate_tpu_torch.resilience`` (the submodules included), and each
    function or class is the port's own, from the module of the same
    name."""
    import slate_tpu.resilience as jax_res
    import slate_tpu_torch.resilience as port_res

    missing, astray = [], []
    for name in sorted(n for n in dir(jax_res) if not n.startswith("_")):
        obj = getattr(jax_res, name)
        if inspect.ismodule(obj):
            # a submodule is an attribute once something imported it
            importlib.import_module("slate_tpu_torch.resilience." + name)
        got = getattr(port_res, name, None)
        if got is None:
            missing.append(name)
            continue
        if inspect.isfunction(obj) or inspect.isclass(obj):
            want = obj.__module__.replace("slate_tpu.", "slate_tpu_torch.", 1)
            if getattr(got, "__module__", None) != want:
                astray.append(name)
    assert not missing, "not exported: %s" % missing
    assert not astray, "not the port's namesake module's: %s" % astray


def test_row_mapped_operand_reaches_pgeqrf_canonicalized(monkeypatch):
    """A DistMatrix with a user row map passed to ``pgeqrf`` is re-gridded
    to the block-cyclic layout before the driver runs (the step loop sees
    no map), and the factor equals the canonical operand's."""
    import functools
    import operator

    import numpy as np

    import slate_tpu_torch.parallel as port_parallel
    from slate_tpu_torch.parallel import dist_qr

    seen = []
    loop = dist_qr._pgeqrf

    def spy(mesh, a_loc, *args):
        seen.append(a_loc.clone())
        return loop(mesh, a_loc, *args)

    monkeypatch.setattr(dist_qr, "_pgeqrf", spy)
    mesh = port_parallel.make_grid_mesh(1, 1, device="cpu")
    a = np.random.default_rng(4).standard_normal((128, 64))
    mapped = port_parallel.distribute(
        a, mesh, 32, row_map=functools.partial(operator.mul, 0))
    plain = port_parallel.distribute(a, mesh, 32)
    got, _, _ = port_parallel.pgeqrf(mapped)
    want, _, _ = port_parallel.pgeqrf(plain)
    assert mapped.row_map is not None and got.row_map is None
    assert all(np.array_equal(x.numpy(), plain.data.numpy()) for x in seen)
    assert np.array_equal(got.data.numpy(), want.data.numpy())


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _local_includes(source: str) -> set:
    """The headers in ``csrc`` that ``source`` reaches, transitively."""
    seen, todo = set(), [source]
    while todo:
        for inc in _INCLUDE.findall((_build.CSRC / todo.pop()).read_text()):
            if (_build.CSRC / inc).is_file() and inc not in seen:
                seen.add(inc)
                todo.append(inc)
    return seen


@pytest.mark.parametrize("kernel", sorted(_build.SOURCES))
def test_build_sources_list_every_header(kernel):
    src, headers = _build.SOURCES[kernel]
    assert (_build.CSRC / src).is_file()
    for h in headers:
        assert (_build.CSRC / h).is_file(), "%s lists a missing %s" % (kernel, h)
    reached = _local_includes(src)
    assert reached <= set(headers), "%s includes %s, which SOURCES does not " \
        "list: its library would not be rebuilt after an edit there" % (
            kernel, sorted(reached - set(headers)))


@pytest.mark.parametrize("kernel", ["lu_inv_panel", "lu_u12_panel",
                                    "chol_inv_panel", "potrf_full_fused",
                                    "trtri_panel", "getrf_full_fused",
                                    "potrf_step_fused", "getrf_step_fused",
                                    "chol_l21_panel"])
def test_kernel_phases_marks_are_in_the_sources(kernel):
    """``perf/kernel_phases.py`` stamps text anchors of the kernel sources:
    each of its marks must still be there, the stamped copy must inline
    every header of ``csrc`` it reaches, and it must keep the kernel's
    start, barrier and end stamps."""
    from slate_tpu_torch.perf import kernel_phases

    src = kernel_phases.stamped_source(kernel)
    assert not [inc for inc in _INCLUDE.findall(src) if (_build.CSRC / inc).is_file()]
    assert set(kernel_phases.SECTIONS) >= {kernel}
    assert "cg::this_grid(); STAMP();" in src
    assert "grid.sync(); STAMP();" in src
    assert "atomicMax(&g_end, g_time());" in src
    assert src.index("#define STAMP()") < src.index("STAMP();")
    for _, new in kernel_phases.MARKS[kernel]:
        assert new in src


@pytest.mark.parametrize("kernel", ["getrf_panel_fused", "getrf_panel_linv"])
def test_kernel_phases_marks_the_lu_panel_leaf(kernel):
    """The LU panel kernels' stamps (``perf/kernel_phases.py``): the start,
    the leaf's start, each of its columns (the cluster barrier) and its
    end beside each grid barrier, in both of the leaf's paths, and the
    kernel's end; every header of ``csrc`` inlined."""
    from slate_tpu_torch.perf import kernel_phases

    src = kernel_phases.stamped_source(kernel)
    assert not [inc for inc in _INCLUDE.findall(src) if (_build.CSRC / inc).is_file()]
    assert set(kernel_phases.SECTIONS) >= {kernel}
    assert "ColumnBarrier grid{p.bar, (unsigned)p.G, 0u}; STAMP();" in src
    assert src.count("__syncthreads(); STAMP();  // the leaf of inner block") == 2
    assert src.count("cluster_wait(); STAMP();") == 2
    assert src.count("STAMP(); grid.sync(); STAMP();") == 2
    assert "atomicMax(&g_end, g_time());" in src
    for _, new in kernel_phases.MARKS[kernel]:
        assert new in src


@pytest.mark.parametrize("kernel", ["hb2st_wavefront", "tb2bd_wavefront"])
def test_kernel_phases_marks_the_chase_phases(kernel):
    """The chase kernels' stamped copies (``perf/kernel_phases.py``
    chase_source): every header of ``csrc`` inlined, the phase macro
    defined before chase.cuh's no-op default, the start mark after the
    exchange's set-up and the end mark after its last wait, once each."""
    from slate_tpu_torch.perf import kernel_phases

    src = kernel_phases.chase_source(kernel)
    assert not [inc for inc in _INCLUDE.findall(src) if (_build.CSRC / inc).is_file()]
    assert set(kernel_phases.SECTIONS) >= {kernel}
    assert src.index("#define CHASE_PHASE(k) do") < src.index("#ifndef CHASE_PHASE")
    assert src.count("  PHASES_START();") == 1
    assert src.count("  ex.finish();\n  PHASES_END();") == 1
    assert "CHASE_PHASE(PH_STAGGER);" in src


@pytest.mark.parametrize("kernel", ["potrf_batched", "getrf_batched"])
def test_kernel_phases_marks_the_batched_kernels(kernel):
    """The batched kernels' stamped copies (``perf/kernel_phases.py``
    batched_source): every header of ``csrc`` inlined, the mark macro
    defined before the source's no-op default, and the marks the reports
    read in place: the start and the end once, getrf_batched's cluster
    barrier once a row block and a mark a column, potrf_batched's step,
    L21 and diagonal marks."""
    from slate_tpu_torch.perf import kernel_phases

    src = kernel_phases.batched_source(kernel)
    assert not [inc for inc in _INCLUDE.findall(src) if (_build.CSRC / inc).is_file()]
    assert set(kernel_phases.SECTIONS) >= {kernel}
    assert src.index("#define BATCHED_MARK(k) do") < src.index("#ifndef BATCHED_MARK")
    assert src.count("BATCHED_MARK(M_START);") == 1
    assert src.count("BATCHED_MARK(M_END);") == 1
    if kernel == "getrf_batched":
        assert src.count("cluster_wait();  // the row block's one cluster barrier\n"
                         "    BATCHED_MARK(M_WAITED);") == 1
        for mark in ("M_COLUMN", "M_STORED", "M_U12", "M_UPDATED", "M_LOADED"):
            assert src.count("BATCHED_MARK(%s);" % mark) == 1, mark
    else:
        for mark, times in (("M_STEP", 2), ("M_L21", 1), ("M_DIAG", 2),
                            ("M_SYRK_DIAG", 1), ("M_LOADED", 1)):
            assert src.count("BATCHED_MARK(%s);" % mark) == times, mark
