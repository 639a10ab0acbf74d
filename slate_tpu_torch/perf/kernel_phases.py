"""Where the time goes inside one launch of the grid kernels
(``csrc/lu_inv_panel.cu``, ``csrc/lu_u12_panel.cu``,
``csrc/chol_inv_panel.cu``, ``csrc/potrf_full_fused.cu``,
``csrc/trtri_panel.cu``, ``csrc/getrf_full_fused.cu``,
``csrc/potrf_step_fused.cu``, ``csrc/getrf_step_fused.cu``,
``csrc/chol_l21_panel.cu``, ``csrc/getrf_panel_fused.cu``,
``csrc/getrf_panel_linv.cu``): device time stamps between their phases;
and the ``matmul`` kernel's time by shape.  Needs a CUDA card and
``nvcc``::

    python3 -m slate_tpu_torch.perf.kernel_phases [kernel ...]

(default: every kernel of :data:`SECTIONS`).  For each grid kernel it
builds a stamped copy of the source (every header of ``csrc`` it includes
inlined) into ``build/slate_tpu_torch/phases/``, one ``nvcc`` each, all at
once: block 0's thread 0 reads the global timer and its SM's cycle counter
at the kernel's start, after every grid barrier and at the marks below,
and every block stamps its end.  It launches the copy at the main paths'
shapes (``lu_inv_panel`` and ``chol_inv_panel`` at nb = 512 and 256,
``lu_u12_panel`` at the ring call (256, 256), the checked runs' (256, 4096)
and the block row (256, 16384), ``potrf_full_fused`` at (8192, 8192),
nb = 512, ``trtri_panel`` at potri's (256, 256) tile and geqrf's (512, 512)
T block, by both of its launch routes, ``getrf_full_fused`` at (8192,
8192), nb = 512, ib = 16, the two step kernels at k0 = 0 on the same
(8192, 8192) carries, ``chol_l21_panel`` at pposv's (16384, 256) panel on
the plan's grid and on 28 blocks) and prints the best of five launches
(three for the full kernels and the LU step): each interval in
microseconds, block 0's SM clock over the launch, for ``lu_inv_panel`` and
``chol_inv_panel`` the median of each part of a step and the doubling, for
``potrf_full_fused`` the diagonal phase A against the L21 and trailing
phases B + C summed over the steps, for ``trtri_panel`` the diagonal
inverses and each doubling product beside CUDA-event times of both routes
and of ``solve_triangular``, for ``getrf_full_fused`` per step the panel,
its median µs a column (and a column that ends an inner block) and the
trailing phases 1–4, for ``potrf_step_fused`` phase A against B and C, for
``getrf_step_fused`` (with its update and without, the ``fused_trsm``
launch) the list of active lanes, the panel with its µs a column and the
trailing phases 1–4, and for ``chol_l21_panel`` phase A (the diagonal
block's L and L⁻¹) against B (X = P·L⁻ᵀ), and for the LU panel kernels
(``getrf_panel_fused`` at k0 = 0 of the (8192, 8192) carry, nb = 512,
ib = 16; ``getrf_panel_linv`` on a (256, 8192) slab, ib = 32; each on
its plan's grid) the grid and cluster, µs a column and an inner block,
the number of grid barriers, and the leaf (its columns, one cluster
barrier each) against the inner block's end (the leaf's write-back, the
wait at the grid barrier, the next leaf's rows), on the leaf's block 0.
The stamps cost a few instructions on block 0; the kernels the port launches
carry none.
``matmul`` (:func:`_matmul`) is timed by CUDA events instead.

The chase kernels (``hb2st_wavefront``, ``tb2bd_wavefront``: ~24,600
staggers, too many for one stamp each) are stamped through their
``CHASE_PHASE`` hooks instead (:func:`chase_source`): the first block of
each cluster adds its SM cycles since the last hook to the phase each
names (the task's load, its row dots, column dots, updates, larfg and
other passes, each exchange's cluster-barrier wait, the partial sums,
the store, the stagger's grid barrier, the deferred half of an
exchange's second barrier), and :func:`_chase` prints each cluster's
time outside the stagger barrier and the busiest one's µs a task in
each phase at (8192, 256) fp32 and (4096, 256) fp64 beside the plan and
registers.

The batched kernels (``potrf_batched``, ``getrf_batched``) are stamped at
their ``BATCHED_MARK`` hooks (:func:`batched_source`): thread 0 of each of
the first 16 blocks records the time at each mark, and :func:`_batched`
prints, at the drivers' (64, 256) and the served (16, 256), the plan, the
stamped copy's registers and the launch's CUDA-event time beside
``potrf_batched``'s load, diagonal chain, L21, trailing update and store
(block 0) and ``getrf_batched``'s load, µs a column, stores, cluster
barriers and their waits, U12 and the update, the look-ahead apart from
the rest (the busiest block of the first cluster).  Nothing here runs at
import.
"""

from __future__ import annotations

import ctypes
import functools
import re
import statistics
import subprocess
import sys

_HEAD = r'''
#define CAP 16384
__device__ unsigned long long g_st[CAP];
__device__ unsigned long long g_ck[CAP];
__device__ int g_n;
__device__ unsigned long long g_end;
__device__ __forceinline__ unsigned long long g_time() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP() do { if (blockIdx.x == 0 && threadIdx.x == 0 && g_n < CAP) { \
  int n_ = g_n++; g_st[n_] = g_time(); g_ck[n_] = clock64(); } } while (0)
'''
_TAIL = r'''
extern "C" int phases_reset() {
  int z = 0; unsigned long long e = 0;
  cudaMemcpyToSymbol(g_n, &z, sizeof z);
  return (int)cudaMemcpyToSymbol(g_end, &e, sizeof e);
}
extern "C" int phases_read(unsigned long long* st, unsigned long long* ck, int* n,
                           unsigned long long* end) {
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(n, g_n, sizeof(int));
  cudaMemcpyFromSymbol(end, g_end, 8);
  cudaMemcpyFromSymbol(st, g_st, 8 * CAP);
  return (int)cudaMemcpyFromSymbol(ck, g_ck, 8 * CAP);
}
'''
#: marks inside a step, beside the grid barriers: (text, text with stamps)
MARKS = {
    "lu_inv_panel": [
        ("  put_block(s.a12, LDT, a12);\n  __syncthreads();",
         "  put_block(s.a12, LDT, a12);\n  __syncthreads(); STAMP();"),
        ("  if (threadIdx.x < 32) lu32_warp(s.blk);\n  __syncthreads();",
         "  STAMP(); if (threadIdx.x < 32) lu32_warp(s.blk);\n"
         "  __syncthreads(); STAMP();"),
        ("  store_block(s.blk, LDB, LU + o, nb);",
         "  STAMP(); store_block(s.blk, LDB, LU + o, nb);")],
    "lu_u12_panel": [
        ("    if (tid < 32) lower_inv_warp(blk, inv, false);\n    __syncthreads();",
         "    STAMP(); if (tid < 32) lower_inv_warp(blk, inv, false);\n"
         "    __syncthreads(); STAMP();")],
    "chol_inv_panel": [
        ("  if (!diag) put_block(s.aJT, LDT, aJ, true);\n  __syncthreads();",
         "  if (!diag) put_block(s.aJT, LDT, aJ, true);\n  __syncthreads(); STAMP();"),
        ("  if (threadIdx.x < 32) chol32_warp(s.blk);\n"
         "  else if (threadIdx.x < 64) lower_inv_warp<true>(s.blk, s.inv, false);\n"
         "  __syncthreads();",
         "  STAMP(); if (threadIdx.x < 32) chol32_warp(s.blk);\n"
         "  else if (threadIdx.x < 64) lower_inv_warp<true>(s.blk, s.inv, false);\n"
         "  __syncthreads(); STAMP();")],
    "potrf_full_fused": [],
    "trtri_panel": [
        ("  cg::cluster_group grid = cg::this_cluster();\n"
         "  trtri_grid(grid, sm, L, ldl, Linv, W, nb);\n}",
         "  cg::cluster_group grid = cg::this_cluster(); STAMP();\n"
         "  trtri_grid(grid, sm, L, ldl, Linv, W, nb);\n  __syncthreads();\n"
         "  if (threadIdx.x == 0) atomicMax(&g_end, g_time());\n}")],
    "getrf_full_fused": [],
    "potrf_step_fused": [],
    "getrf_step_fused": [],
    "chol_l21_panel": [],
    "getrf_panel_fused": [
        ("  ColumnBarrier grid{p.bar, (unsigned)p.G, 0u};",
         "  ColumnBarrier grid{p.bar, (unsigned)p.G, 0u}; STAMP();"),
        ("    __syncthreads();  // the leaf of inner block b0 / ib starts",
         "    __syncthreads(); STAMP();  // the leaf of inner block b0 / ib starts"),
        ("      cluster_wait();  // the column's one cluster barrier",
         "      cluster_wait(); STAMP();  // the column's one cluster barrier"),
        ("    grid.sync(); STAMP();  // the leaf is in out",
         "    STAMP(); grid.sync(); STAMP();  // the leaf is in out")]}
MARKS["getrf_panel_linv"] = MARKS["getrf_panel_fused"]


_LOCAL_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"[^\n]*$', re.M)


def _inline(text: str, seen: set) -> str:
    """``text`` with every header of ``csrc`` it includes inlined in its
    place, each once (``seen``: those inlined already)."""
    from ..ops import _build

    def repl(m):
        inc = m.group(1)
        if not (_build.CSRC / inc).is_file():
            return m.group(0)
        if inc in seen:
            return ""
        seen.add(inc)
        return _inline((_build.CSRC / inc).read_text().replace("#pragma once", ""),
                       seen)

    return _LOCAL_INCLUDE.sub(repl, text)


def _kernel_end(src: str) -> int:
    """Where the last ``__global__`` function of ``src`` closes (the
    offset of its closing brace's line break)."""
    start = src.index("{", src.rindex("__global__"))
    depth = 0
    for i in range(start, len(src)):
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            return src.rindex("\n", 0, i)
    raise RuntimeError("unbalanced braces after the last __global__")


def stamped_source(name: str) -> str:
    """The source of kernel ``name`` with its local headers inlined and
    stamps at its start, after each grid barrier, at :data:`MARKS` and at
    every block's end."""
    from ..ops import _build

    src = (_build.CSRC / (name + ".cu")).read_text()
    first = _LOCAL_INCLUDE.search(src).start()
    src = src[:first] + _HEAD + _inline(src[first:], set())
    end = _kernel_end(src)
    src = (src[:end] + "\n  __syncthreads();\n"
           "  if (threadIdx.x == 0) atomicMax(&g_end, g_time());" + src[end:])
    src = src.replace("grid.sync();", "grid.sync(); STAMP();")
    src = src.replace("cg::grid_group grid = cg::this_grid();",
                      "cg::grid_group grid = cg::this_grid(); STAMP();")
    for old, new in MARKS[name]:
        if old not in src:
            raise RuntimeError("%s: the mark %r is not in the source" % (name, old))
        src = src.replace(old, new)
    return src + _TAIL


def build(names) -> dict:
    """Stamped copies of kernels ``names`` (:func:`chase_source` for the
    chases, :func:`batched_source` for the batched kernels, else
    :func:`stamped_source`), one ``nvcc`` each, all started
    together: ``{name: ctypes.CDLL}``; each compiler log (``-Xptxas -v``)
    is kept beside its library as ``<lib>.log``."""
    from ..ops import _build

    out = _build.BUILD_DIR / "phases"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = out / (name + "_phases.cu")
        cu.write_text(chase_source(name) if name in CHASES else
                      batched_source(name) if name in BATCHED else stamped_source(name))
        so = out / ("lib%s_phases.so" % name)
        procs[name] = (so, cu, subprocess.Popen(
            [_build.nvcc_path(), *_build.FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, cu, proc) in procs.items():
        log, _ = proc.communicate()
        so.with_name(so.name + ".log").write_text(log)
        if proc.returncode:
            raise RuntimeError("nvcc failed on %s:\n%s" % (cu, log))
        libs[name] = ctypes.CDLL(str(so))
    return libs


_CAP = 16384      # stamps a launch keeps (CAP in _HEAD)


def run(lib, entry: str, argtypes, args, reps: int = 5, setup=None):
    """Best of ``reps`` launches: (intervals in µs, SM clock in GHz).
    ``setup`` (untimed) runs before each launch."""
    import torch

    fn = getattr(lib, entry)
    fn.argtypes = list(argtypes) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    st, ck = (ctypes.c_ulonglong * _CAP)(), (ctypes.c_ulonglong * _CAP)()
    n, end = ctypes.c_int(), ctypes.c_ulonglong()
    best = None
    for _ in range(reps):
        if setup is not None:
            setup()
        lib.phases_reset()
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError("%s: CUDA error %d" % (entry, rc))
        lib.phases_read(st, ck, ctypes.byref(n), ctypes.byref(end))
        if n.value >= _CAP:
            raise RuntimeError("%s: more than %d stamps" % (entry, _CAP))
        t = [st[i] - st[0] for i in range(n.value)] + [end.value - st[0]]
        if best is None or t[-1] < best[0][-1]:
            ghz = (ck[n.value - 1] - ck[0]) / max(1, t[n.value - 1])
            best = (t, ghz)
    t, ghz = best
    return [(t[i + 1] - t[i]) / 1e3 for i in range(len(t) - 1)], ghz


def _plan(lib, name: str, *args, outs: int = 1):
    """The C entry ``slate_<name>_plan(*args, &out…)``: an int, or a tuple
    of ``outs`` ints."""
    got = [ctypes.c_int() for _ in range(outs)]
    rc = getattr(lib, "slate_%s_plan" % name)(*args, *map(ctypes.byref, got))
    if rc:
        raise RuntimeError("%s: no grid: CUDA error %d" % (name, rc))
    return got[0].value if outs == 1 else tuple(g.value for g in got)


P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def _lu_inv_panel(torch, lib, gen, dev) -> None:
    for nb in (512, 256):
        a = torch.randn((nb, nb), generator=gen, device=dev) + nb * torch.eye(nb, device=dev)
        lu, li, ui, w = (torch.empty((nb, nb), device=dev) for _ in range(4))
        g = _plan(lib, "lu_inv_panel", nb)
        d, ghz = run(lib, "slate_lu_inv_panel_f32", [P, I64, P, P, P, P, I, I],
                     [a.data_ptr(), nb, lu.data_ptr(), li.data_ptr(), ui.data_ptr(),
                      w.data_ptr(), nb, g])
        # start, prologue: zero + load, LU, inverses, stores + barrier; then
        # per step: loads, products, LU, inverses, stores + barrier
        steps = nb // 32 - 1
        body = d[4:4 + 5 * steps]
        parts = ("loads", "products", "LU", "inverses", "stores+barrier")
        med = {p: statistics.median(body[i::5]) for i, p in enumerate(parts)}
        print("lu_inv_panel nb=%d grid %d: %.1f us at %.2f GHz; prologue %s; "
              "a step (median us) %s; the doublings %s" % (
                  nb, g, sum(d), ghz, [round(x, 1) for x in d[:4]],
                  {k: round(v, 2) for k, v in med.items()},
                  [round(x, 1) for x in d[4 + 5 * steps:]]), flush=True)


def _lu_u12_panel(torch, lib, gen, dev) -> None:
    l11 = torch.eye(256, device=dev) + torch.tril(
        torch.randn((256, 256), generator=gen, device=dev), -1) / 16
    for w in (256, 4096, 16384):
        nb = 256
        b = torch.randn((nb, w), generator=gen, device=dev)
        u, r = torch.empty((nb, w), device=dev), torch.empty((nb, w), device=dev)
        li = torch.empty((nb, nb), device=dev)
        wk = torch.empty((nb // 2) ** 2, device=dev)
        mx = torch.empty(2, dtype=torch.int32, device=dev)
        dv = torch.empty(1, device=dev)
        g = _plan(lib, "lu_u12_panel", nb, w)
        d, ghz = run(lib, "slate_lu_u12_panel_f32", [P, I64, P, I64] + [P] * 6 + [I] * 3,
                     [l11.data_ptr(), nb, b.data_ptr(), w, u.data_ptr(), li.data_ptr(),
                      wk.data_ptr(), r.data_ptr(), mx.data_ptr(), dv.data_ptr(), nb, w,
                      g])
        # zero + load, diagonal inverses, stores + barrier, the doubling's
        # phases, then u1, r1, U
        print("lu_u12_panel (%d,%d) grid %d: %.1f us at %.2f GHz; diagonal "
              "inverses %.1f, stores + barrier %.1f; the doubling %.1f %s; "
              "u1 %.1f, r1 %.1f, U %.1f" % (
                  nb, w, g, sum(d), ghz, d[1], d[2], sum(d[3:-3]),
                  [round(x, 1) for x in d[3:-3]], d[-3], d[-2], d[-1]), flush=True)


def _chol_inv_panel(torch, lib, gen, dev) -> None:
    for nb in (512, 256):
        g0 = torch.randn((nb, nb), generator=gen, device=dev)
        a = g0 @ g0.T + nb * torch.eye(nb, device=dev)
        l, li = torch.empty((nb, nb), device=dev), torch.empty((nb, nb), device=dev)
        w = torch.empty(nb * nb, device=dev)
        g = _plan(lib, "chol_inv_panel", nb)
        d, ghz = run(lib, "slate_chol_inv_panel_f32", [P, I64, P, P, P, I, I],
                     [a.data_ptr(), nb, l.data_ptr(), li.data_ptr(), w.data_ptr(),
                      nb, g])
        # prologue: zero + load, the 32² Cholesky and inverse, stores +
        # barrier; then per step: loads, products, Cholesky and inverse,
        # stores + barrier; then the doubling's phases
        steps = nb // 32 - 1
        body = d[3:3 + 4 * steps]
        parts = ("loads", "products", "Cholesky+inverse", "stores+barrier")
        med = {p: statistics.median(body[i::4]) for i, p in enumerate(parts)}
        print("chol_inv_panel nb=%d grid %d: %.1f us at %.2f GHz; prologue %s; "
              "a step (median us) %s; steps %.1f; the doubling %.1f %s" % (
                  nb, g, sum(d), ghz, [round(x, 1) for x in d[:3]],
                  {k: round(v, 2) for k, v in med.items()}, sum(body),
                  sum(d[3 + 4 * steps:]),
                  [round(x, 1) for x in d[3 + 4 * steps:]]), flush=True)


def _potrf_full_fused(torch, lib, gen, dev) -> None:
    n, nb, tc = 8192, 512, 512
    r = torch.randn((n, n), generator=gen, device=dev)
    spd = (r + r.T) / 2 + n * torch.eye(n, device=dev)      # the tester's herm(n)
    del r
    a = torch.empty_like(spd)
    lkk, li, s = (torch.empty((nb, nb), device=dev) for _ in range(3))
    l21 = torch.empty((n - nb, nb), device=dev)
    g = _plan(lib, "potrf_full_fused", n, nb, tc)
    d, ghz = run(lib, "slate_potrf_full_fused_f32", [P, I64] + [P] * 4 + [I] * 4,
                 [a.data_ptr(), n, lkk.data_ptr(), li.data_ptr(), s.data_ptr(),
                  l21.data_ptr(), n, nb, tc, g], setup=lambda: a.copy_(spd))
    # a step: phase A's stamps (chol_inv_grid's barriers and doubling
    # phases, then the step's own barrier), then B's and C's barriers; the
    # last step ends after A with the copy of L11
    levels = (nb // 32).bit_length() - 1
    na = 1 + (nb // 32 - 1) + 2 * levels + 1
    steps = n // nb
    if len(d) != steps * (na + 2) - 1:
        raise RuntimeError("potrf_full_fused: %d intervals, expected %d"
                           % (len(d), steps * (na + 2) - 1))
    pa = [sum(d[k * (na + 2):k * (na + 2) + na]) for k in range(steps)]
    pb = [d[k * (na + 2) + na] for k in range(steps - 1)] + [d[-1]]
    pc = [d[k * (na + 2) + na + 1] for k in range(steps - 1)]
    print("potrf_full_fused (%d,%d) nb=%d grid %d: %.1f us at %.2f GHz; phase A "
          "(the diagonal block) %.1f us, a step's median %.1f; phases B + C "
          "%.1f us (B %.1f, C %.1f); per step A %s, B %s, C %s" % (
              n, n, nb, g, sum(d), ghz, sum(pa), statistics.median(pa),
              sum(pb) + sum(pc), sum(pb), sum(pc), [round(x, 1) for x in pa],
              [round(x, 1) for x in pb], [round(x, 1) for x in pc]), flush=True)


def _lower(torch, gen, dev, nb: int, ld: int):
    """An (nb, nb) view of row stride ``ld`` whose lower triangle is
    well conditioned (unit-order diagonal, N(0, 1/nb) below it) and whose
    upper part holds stale values."""
    full = torch.randn((nb, ld), generator=gen, device=dev)
    v = full[:, :nb]
    v.copy_(torch.tril(v, -1) / nb ** 0.5 + torch.triu(v, 1) * 1e3
            + torch.diag(1.0 + torch.rand(nb, generator=gen, device=dev)))
    return v


def _event_us(torch, fn, reps: int = 20) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls after
    one warm-up, from CUDA events, in µs."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / reps


def _trtri_panel(torch, lib, gen, dev) -> None:
    # potri's 256² diagonal tile (a view of row stride 512) and geqrf's
    # 512² T block; each launch route: one cluster, a cooperative grid
    entry = getattr(lib, "slate_trtri_panel_f32")
    entry.argtypes = [P, I64, P, P, I, I, I, P]
    for nb, ld in ((256, 512), (512, 512)):
        l = _lower(torch, gen, dev, nb, ld)
        li = torch.empty((nb, nb), device=dev)
        w = torch.empty((nb // 2) ** 2, device=dev)
        eye = torch.eye(nb, device=dev)
        lib_us = _event_us(torch, lambda: torch.linalg.solve_triangular(
            l, eye, upper=False))
        for cluster in (1, 0):
            g = _plan(lib, "trtri_panel", nb, cluster)
            args = [l.data_ptr(), ld, li.data_ptr(), w.data_ptr(), nb, g, cluster]
            d, ghz = run(lib, "slate_trtri_panel_f32", [P, I64, P, P, I, I, I], args)
            us = _event_us(torch, lambda: entry(
                *args, torch.cuda.current_stream().cuda_stream))
            # the diagonal inverses, then each doubling product; the grid
            # launch's stamps also time its start
            print("trtri_panel (%d,%d) row stride %d %s of %d blocks: %.1f us by "
                  "events (solve_triangular %.1f us); stamps %.1f us at %.2f GHz: "
                  "zero + diagonal inverses %.1f, the doubling's products %s"
                  % (nb, nb, ld, "one cluster" if cluster else "cooperative grid",
                     g, us, lib_us, sum(d), ghz, d[0], [round(x, 1) for x in d[1:]]),
                  flush=True)


def _getrf_full_fused(torch, lib, gen, dev) -> None:
    n, nb, ib = 8192, 512, 16
    at0 = torch.randn((n, n), generator=gen, device=dev)   # A's transpose
    at = torch.empty_like(at0)
    act = torch.empty(n, device=dev)
    f32 = dict(device=dev)
    g = _plan(lib, "getrf_full_fused", n, nb, ib)
    piv = torch.empty(n, dtype=torch.int64, device=dev)
    linv, l11, t, x2 = (torch.empty((nb, nb), **f32) for _ in range(4))
    cand, cval = torch.empty((2, g, nb), **f32), torch.empty((2, g), **f32)
    clane = torch.empty((2, g), dtype=torch.int32, device=dev)
    u, cpiv = torch.empty((n - nb, nb), **f32), torch.empty((n - nb, nb), **f32)
    lanes = torch.empty(2 * n, dtype=torch.int32, device=dev)
    na = torch.empty(2, dtype=torch.int32, device=dev)
    bar = torch.empty(1, dtype=torch.int32, device=dev)

    def setup():
        at.copy_(at0)
        act.fill_(1.0)
        bar.zero_()

    d, ghz = run(lib, "slate_getrf_full_fused_f32", [P, I64, I] + [P] * 14 + [I] * 4,
                 [at.data_ptr(), n, n, act.data_ptr(), piv.data_ptr(),
                  linv.data_ptr(), cand.data_ptr(), cval.data_ptr(),
                  clane.data_ptr(), l11.data_ptr(), t.data_ptr(), x2.data_ptr(),
                  u.data_ptr(), cpiv.data_ptr(), lanes.data_ptr(), na.data_ptr(),
                  bar.data_ptr(), n, nb, ib, g], reps=3, setup=setup)
    # the list of active lanes, then a step: one barrier a column, the
    # barrier after the panel's write-back, one after each of the three
    # products and one after the update (the last step ends after its
    # panel)
    steps = n // nb
    per = nb + 1 + 4
    if len(d) != 2 + steps * per - 4:
        raise RuntimeError("getrf_full_fused: %d intervals, expected %d"
                           % (len(d), 2 + steps * per - 4))
    pan, col, end, tr = [], [], [], [[], [], [], []]
    for k in range(steps):
        s0 = 1 + k * per
        cols = d[s0:s0 + nb]
        pan.append(sum(d[s0:s0 + nb + 1]))
        # a column that ends an inner block also runs the block's end
        col.append(statistics.median(c for j, c in enumerate(cols) if j % ib))
        end.append(statistics.median(cols[ib::ib]))
        if k + 1 < steps:
            for i in range(4):
                tr[i].append(d[s0 + nb + 1 + i])
    print("getrf_full_fused (%d,%d) nb=%d ib=%d grid %d: %.1f us at %.2f GHz; "
          "lane list %.1f us, panels %.1f us, trailing %.1f us (phases 1-4: %s)" % (
              n, n, nb, ib, g, sum(d), ghz, d[0], sum(pan), sum(map(sum, tr)),
              [round(sum(x), 1) for x in tr]), flush=True)
    print("getrf_full_fused per step: panel us %s; median us a column %s; median "
          "us a column with an inner block's end %s; phase 1 %s; phase 2 %s; "
          "phase 3 %s; phase 4 %s" % (
              [round(x, 1) for x in pan], [round(x, 2) for x in col],
              [round(x, 2) for x in end],
              *[[round(x, 1) for x in p] for p in tr]), flush=True)


def _potrf_step_fused(torch, lib, gen, dev) -> None:
    n, nb, tc = 8192, 512, 512
    r = torch.randn((n, n), generator=gen, device=dev)
    spd = (r + r.T) / 2 + n * torch.eye(n, device=dev)      # the tester's herm(n)
    del r
    a = torch.empty_like(spd)
    lkk, li, s = (torch.empty((nb, nb), device=dev) for _ in range(3))
    l21 = torch.empty((n - nb, nb), device=dev)
    g = _plan(lib, "potrf_step_fused", n, nb, tc)
    d, ghz = run(lib, "slate_potrf_step_fused_f32", [P, I64] + [P] * 4 + [I] * 5,
                 [a.data_ptr(), n, lkk.data_ptr(), li.data_ptr(), s.data_ptr(),
                  l21.data_ptr(), n, nb, tc, 0, g], setup=lambda: a.copy_(spd))
    # phase A (the diagonal block: its stamps up to the step's own
    # barrier), then B's barrier and C to the end
    print("potrf_step_fused (%d,%d) k0=0 nb=%d grid %d: %.1f us at %.2f GHz; "
          "phase A (the diagonal block) %.1f us; phases B + C %.1f us (B %.1f, "
          "C %.1f)" % (n, n, nb, g, sum(d), ghz, sum(d[:-2]), d[-2] + d[-1],
                       d[-2], d[-1]), flush=True)


def _getrf_step_fused(torch, lib, gen, dev) -> None:
    n, nb, ib = 8192, 512, 16
    at0 = torch.randn((n, n), generator=gen, device=dev)   # A's transpose
    at = torch.empty_like(at0)
    act = torch.ones(n, device=dev)
    f32 = dict(device=dev)
    g = _plan(lib, "getrf_step_fused", n, nb, ib)
    piv = torch.empty(nb, dtype=torch.int64, device=dev)
    act_out = torch.empty(n, **f32)
    linv, l11, t, x2 = (torch.empty((nb, nb), **f32) for _ in range(4))
    cand, cval = torch.empty((2, g, nb), **f32), torch.empty((2, g), **f32)
    clane = torch.empty((2, g), dtype=torch.int32, device=dev)
    u, cpiv = torch.empty((n - nb, nb), **f32), torch.empty((n - nb, nb), **f32)
    lanes = torch.empty(2 * n, dtype=torch.int32, device=dev)
    na = torch.empty(2, dtype=torch.int32, device=dev)
    bar = torch.empty(1, dtype=torch.int32, device=dev)

    def setup():
        at.copy_(at0)
        bar.zero_()

    for update in (1, 0):
        d, ghz = run(lib, "slate_getrf_step_fused_f32",
                     [P, I64, I64, I] + [P] * 15 + [I] * 5,
                     [at.data_ptr(), n, 0, n, act.data_ptr(), act_out.data_ptr(),
                      piv.data_ptr(), linv.data_ptr(), cand.data_ptr(),
                      cval.data_ptr(), clane.data_ptr(), l11.data_ptr(), t.data_ptr(),
                      x2.data_ptr(), u.data_ptr(), cpiv.data_ptr(), lanes.data_ptr(),
                      na.data_ptr(), bar.data_ptr(), n, nb, ib, update, g], reps=3,
                     setup=setup)
        _step_report("getrf_step_fused (%d,%d) k0=0 nb=%d ib=%d update=%d grid %d"
                     % (n, n, nb, ib, update, g), d, ghz, nb, ib)


def _step_report(label: str, d, ghz: float, nb: int, ib: int) -> None:
    """One LU step's stamps: the prologue (the list of active lanes), one
    barrier a column, the panel's write-back, then trailing phases 1-4 (T,
    X2, U, the update and the scatter of U)."""
    if len(d) != nb + 6:
        raise RuntimeError("%s: %d intervals, expected %d" % (label, len(d), nb + 6))
    cols = d[1:1 + nb]
    print("%s: %.1f us at %.2f GHz; prologue %.1f us, panel %.1f us (median us a "
          "column %.2f, with an inner block's end %.2f), trailing phases 1-4 %s"
          % (label, sum(d), ghz, d[0], sum(d[1:2 + nb]),
             statistics.median(c for j, c in enumerate(cols) if j % ib),
             statistics.median(cols[ib::ib]), [round(x, 1) for x in d[-4:]]),
          flush=True)


def _chol_l21_panel(torch, lib, gen, dev) -> None:
    # pposv's panel on the 1×1 grid: (16384, 256), its SPD diagonal block
    # at rows [2048, 2304) read in place, as phase 2i of chip_smoke.py
    m, nb = 16384, 256
    panel = torch.randn((m, nb), generator=gen, device=dev)
    g0 = torch.randn((nb, nb), generator=gen, device=dev)
    k0 = 8 * nb
    panel[k0:k0 + nb] = g0 @ g0.T / nb + torch.eye(nb, device=dev)
    d = panel[k0:k0 + nb]
    l, li = torch.empty((nb, nb), device=dev), torch.empty((nb, nb), device=dev)
    w, x = torch.empty(nb * nb, device=dev), torch.empty((m, nb), device=dev)
    g = _plan(lib, "chol_l21_panel", m, nb)
    lib_us = _event_us(torch, lambda: torch.linalg.solve_triangular(
        torch.linalg.cholesky(d).mT, panel, upper=True, left=False))
    # the grid of the plan, and the diagonal phase's own widest grid
    for grid in (g, 28) if g != 28 else (g,):
        dd, ghz = run(lib, "slate_chol_l21_panel_f32", [P, I64, P, I64] + [P] * 4 + [I] * 3,
                      [d.data_ptr(), nb, panel.data_ptr(), nb, l.data_ptr(),
                       li.data_ptr(), w.data_ptr(), x.data_ptr(), m, nb, grid])
        # everything to the last grid barrier is the diagonal block (L and
        # L⁻¹); after it the product X = P·L⁻ᵀ
        print("chol_l21_panel (%d,%d) nb=%d grid %d: %.1f us at %.2f GHz; phase A "
              "(L, L^-1 of the diagonal block) %.1f us, phase B (X = P L^-T) %.1f us; "
              "cholesky + solve_triangular %.1f us by events"
              % (m, nb, nb, grid, sum(dd), ghz, sum(dd[:-1]), dd[-1], lib_us),
              flush=True)


def _lu_panel(name: str, torch, lib, gen, dev) -> None:
    """``getrf_panel_fused`` at k0 = 0 of the (8192, 8192) carry, nb = 512,
    ib = 16 (the scattered driver's first panel), or ``getrf_panel_linv``
    on a (256, 8192) slab, ib = 32 (the recursion's first leaf), on the
    plan's grid and cluster with the wrapper's scratch."""
    n = 8192
    act = torch.ones(n, device=dev)
    w, ib = (512, 16) if name == "getrf_panel_fused" else (256, 32)
    g, c = _plan(lib, name, n, w, ib, outs=2)
    act_out = torch.empty(n, device=dev)
    piv = torch.empty(w, dtype=torch.int64, device=dev)
    linv = torch.empty((w, w), device=dev)
    iwork = torch.empty(2 * n + 1, dtype=torch.int32, device=dev)
    lblk = torch.empty(3 * ib * ib, device=dev)
    bar = torch.empty(2, dtype=torch.int32, device=dev)
    tail = [act.data_ptr(), act_out.data_ptr(), piv.data_ptr(), linv.data_ptr(),
            iwork.data_ptr(), lblk.data_ptr(), bar.data_ptr(), n, w, ib, g, c]
    if name == "getrf_panel_fused":
        c0 = torch.randn((n, n), generator=gen, device=dev)     # A's transpose
        carry = torch.empty_like(c0)
        label = "getrf_panel_fused (%d,%d) carry k0=0 nb=%d ib=%d" % (n, n, w, ib)
        head, args = [P, I64, I64], [carry.data_ptr(), n, 0]

        def setup():
            carry.copy_(c0)
            bar.zero_()
    else:
        slab = torch.randn((w, n), generator=gen, device=dev)
        out = torch.empty_like(slab)
        label = "getrf_panel_linv (%d,%d) slab ib=%d" % (w, n, ib)
        head, args = [P, I64, P], [slab.data_ptr(), n, out.data_ptr()]
        setup = bar.zero_
    d, ghz = run(lib, "slate_%s_f32" % name, head + [P] * 7 + [I] * 5, args + tail,
                 reps=3, setup=setup)
    _lu_panel_report("%s, grid %d in clusters of %d" % (label, g, c), d, ghz, w, ib)


def _lu_panel_report(label: str, d, ghz: float, w: int, ib: int) -> None:
    """One panel launch's stamps: the leaf cluster's timeline on its block
    0 (one grid barrier an inner block)."""
    nblk = w // ib
    head = "%s: %.1f us at %.2f GHz; %.2f us a column, %.1f us an inner block" % (
        label, sum(d), ghz, sum(d) / w, sum(d) * ib / w)
    per = ib + 3
    if len(d) != 1 + nblk * per:
        raise RuntimeError("%s: %d intervals, expected %d"
                           % (label, len(d), 1 + nblk * per))
    # the prologue (the list of lanes and the first leaf's rows), then per
    # inner block: its ib columns (one cluster barrier each), the leaf's
    # write-back, the wait at the grid barrier (the updaters' share of the
    # previous block's end still running), and the next leaf's rows (the
    # last block: the kernel's end)
    blocks = [d[1 + b * per:1 + (b + 1) * per] for b in range(nblk)]
    leaf = [sum(x[:ib]) for x in blocks]
    end = [sum(x[ib:]) for x in blocks]
    print("%s; %d grid barriers (one an inner block): prologue %.1f us; leaf %.1f us "
          "(median column %.2f us, median leaf %.1f us), block end %.1f us (median "
          "write-back %.2f us, grid barrier wait %.2f us, next leaf's rows %.2f us)" % (
              head, nblk, d[0], sum(leaf),
              statistics.median(c for x in blocks for c in x[:ib]),
              statistics.median(leaf), sum(end),
              statistics.median(x[ib] for x in blocks),
              statistics.median(x[ib + 1] for x in blocks),
              statistics.median(x[ib + 2] for x in blocks[:-1])), flush=True)


#: the chase kernels' stamps: CHASE_PHASE(k) (csrc/chase.cuh's hooks) adds
#: the SM cycles since the last mark to phase k on the first block of each
#: cluster, in shared memory (a few cycles a mark), written out at the
#: kernel's end; the start and end marks of block 0 read the global timer
#: too
_CHASE_HEAD = r'''
#define PH_N 12
#define PH_G 132
__device__ unsigned long long g_ph[PH_G][PH_N];
__device__ unsigned long long g_phn[PH_G][PH_N];
__device__ unsigned long long g_mark[4];
__shared__ unsigned long long ph_acc[PH_N], ph_cnt[PH_N], ph_last;
__device__ __forceinline__ unsigned long long g_time() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned ph_reg(int which) {
  unsigned r;
  if (which) asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  else asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
#define PH_ONE (threadIdx.x == 0 && ph_reg(0) == 0 && ph_reg(1) < PH_G)
#define CHASE_PHASE(k) do { if (PH_ONE) { const unsigned long long c_ = clock64(); \
  const int k_ = (k); ph_acc[k_] += c_ - ph_last; ++ph_cnt[k_]; ph_last = c_; } } while (0)
#define PHASES_START() do { if (PH_ONE) { for (int k_ = 0; k_ < PH_N; ++k_) \
  ph_acc[k_] = ph_cnt[k_] = 0; ph_last = clock64(); \
  if (blockIdx.x == 0) { g_mark[0] = clock64(); g_mark[1] = g_time(); } } } while (0)
#define PHASES_END() do { if (PH_ONE) { const unsigned g_ = ph_reg(1); \
  for (int k_ = 0; k_ < PH_N; ++k_) { g_ph[g_][k_] = ph_acc[k_]; g_phn[g_][k_] = ph_cnt[k_]; } \
  if (blockIdx.x == 0) { g_mark[2] = clock64(); g_mark[3] = g_time(); } } } while (0)
'''
_CHASE_TAIL = r'''
extern "C" int chase_phases_reset() {
  static unsigned long long z[PH_G * PH_N];
  cudaMemcpyToSymbol(g_ph, z, sizeof z);
  return (int)cudaMemcpyToSymbol(g_phn, z, sizeof z);
}
extern "C" int chase_phases_read(unsigned long long* ph, unsigned long long* n,
                                 unsigned long long* mark) {
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(ph, g_ph, sizeof g_ph);
  cudaMemcpyFromSymbol(n, g_phn, sizeof g_phn);
  return (int)cudaMemcpyFromSymbol(mark, g_mark, sizeof g_mark);
}
'''
#: the chase kernels' phases (chase.cuh Phase), as printed
CHASE_PHASES = ("load", "other passes", "exchange 1 wait", "exchange 2 wait",
                "partial sums", "store", "stagger barrier", "trailing wait",
                "row dots", "column dots", "updates", "larfg")
#: the marks of a chase kernel's stamped copy: its start and its end
CHASE_MARKS = [("  Exchange<T> ex{s.x, p.C, 0, false};",
                "  Exchange<T> ex{s.x, p.C, 0, false};\n  PHASES_START();"),
               ("  ex.finish();\n}", "  ex.finish();\n  PHASES_END();\n}")]


def chase_source(name: str) -> str:
    """Chase kernel ``name``'s source with its local headers inlined and
    the phase stamps of :data:`_CHASE_HEAD` at :data:`CHASE_MARKS`."""
    from ..ops import _build

    src = (_build.CSRC / (name + ".cu")).read_text()
    first = _LOCAL_INCLUDE.search(src).start()
    src = src[:first] + _CHASE_HEAD + _inline(src[first:], set())
    for old, new in CHASE_MARKS:
        if src.count(old) != 1:
            raise RuntimeError("%s: the mark %r is not in the source once" % (name, old))
        src = src.replace(old, new)
    return src + _CHASE_TAIL


_BATCHED_HEAD = r"""
#define BCAP 4096
#define BBLK 16
__device__ unsigned long long g_bt[BBLK][BCAP];
__device__ unsigned long long g_bc[BBLK][BCAP];
__device__ int g_bk[BBLK][BCAP];
__device__ int g_bn[BBLK];
__device__ __forceinline__ unsigned long long g_time() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__shared__ int b_i;
#define BATCHED_MARK(k) do { if (blockIdx.x < BBLK && threadIdx.x == 0) { \
  if ((k) == 0) b_i = 0; \
  if (b_i < BCAP) { const int n_ = b_i++; g_bt[blockIdx.x][n_] = g_time(); \
  g_bc[blockIdx.x][n_] = clock64(); g_bk[blockIdx.x][n_] = (k); \
  g_bn[blockIdx.x] = b_i; } } } while (0)
"""
_BATCHED_TAIL = r"""
extern "C" int batched_marks_reset() {
  static int z[BBLK];
  return (int)cudaMemcpyToSymbol(g_bn, z, sizeof z);
}
extern "C" int batched_marks_read(unsigned long long* t, unsigned long long* c, int* k,
                                  int* n) {
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(t, g_bt, sizeof g_bt);
  cudaMemcpyFromSymbol(c, g_bc, sizeof g_bc);
  cudaMemcpyFromSymbol(k, g_bk, sizeof g_bk);
  return (int)cudaMemcpyFromSymbol(n, g_bn, sizeof g_bn);
}
"""
#: the batched kernels, stamped at their BATCHED_MARK hooks
BATCHED = ("potrf_batched", "getrf_batched")
_BBLK, _BCAP = 16, 4096


def batched_source(name: str) -> str:
    """Batched kernel ``name``'s source with its local headers inlined and
    :data:`_BATCHED_HEAD`'s ``BATCHED_MARK`` defined before the source's
    no-op default: thread 0 of each of the first 16 blocks stamps the
    global timer and its SM clock at each mark (its count in shared memory,
    so that a stamp waits on no load; the first mark, 0, resets it)."""
    from ..ops import _build

    src = (_build.CSRC / (name + ".cu")).read_text()
    first = _LOCAL_INCLUDE.search(src).start()
    return src[:first] + _BATCHED_HEAD + _inline(src[first:], set()) + _BATCHED_TAIL


def _batched_run(lib, fn, args, reps: int = 5):
    """Best of ``reps`` launches of the stamped batched kernel ``fn``: per
    block of the first 16, its marks as (mark, µs since its first mark on
    its SM clock), and the SM clock in GHz (block 0's cycles over its
    nanoseconds)."""
    import torch

    t = (ctypes.c_ulonglong * (_BBLK * _BCAP))()
    c = (ctypes.c_ulonglong * (_BBLK * _BCAP))()
    k = (ctypes.c_int * (_BBLK * _BCAP))()
    n = (ctypes.c_int * _BBLK)()
    best = None
    for _ in range(reps):
        lib.batched_marks_reset()
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError("CUDA error %d" % rc)
        lib.batched_marks_read(t, c, k, n)
        span = max(t[b * _BCAP + n[b] - 1] - t[b * _BCAP] for b in range(_BBLK) if n[b])
        if best is None or span < best[0]:
            ghz = (c[n[0] - 1] - c[0]) / max(1, t[n[0] - 1] - t[0])
            marks = [[(k[b * _BCAP + i], (c[b * _BCAP + i] - c[b * _BCAP]) / ghz / 1e3)
                      for i in range(n[b])] for b in range(_BBLK)]
            best = (span, marks, ghz)
    return best[1], best[2]


def _batched_args(torch, name: str, bsz: int, n: int, gen, dev):
    """Inputs and the C entry's arguments of one batched launch at (bsz, n)."""
    g = torch.randn((bsz, n, n), generator=gen, device=dev)
    if name == "potrf_batched":
        a = g @ g.mT + n * torch.eye(n, device=dev)
        out = torch.empty_like(a)
        keep = (a, out)
        return keep, [a.data_ptr(), out.data_ptr(), None, bsz, n]
    at = g.mT.contiguous()
    out = torch.empty_like(at)
    piv = torch.empty((bsz, n), dtype=torch.int64, device=dev)
    return (at, out, piv), [at.data_ptr(), out.data_ptr(), piv.data_ptr(), bsz, n]


def _intervals(marks):
    """(mark, µs since the previous mark) for each mark but the first."""
    return [(marks[i][0], marks[i][1] - marks[i - 1][1]) for i in range(1, len(marks))]


def _potrf_batched_report(label: str, marks, ghz: float) -> None:
    """potrf_batched's smem route on block 0 (every block has the same
    work): the load, the diagonal chain (the 32² Cholesky and inverse on
    warps 0 and 1), L21, the trailing SYRK (the step's barrier to barrier
    after L21: warps 0 and 1's SYRK of the next diagonal tile and its
    Cholesky inside it) and the store (``potrf_batched.cu`` Mark)."""
    M_START, M_LOADED, M_DIAG, M_STEP, M_L21, M_SYRK_DIAG, M_END = range(7)
    iv = _intervals(marks)
    tot = marks[-1][1] - marks[0][1]
    load = sum(d for m, d in iv if m == M_LOADED)
    chol = [d for m, d in iv if m == M_DIAG]
    l21 = [d for m, d in iv if m == M_L21]
    sdiag = [d for m, d in iv if m == M_SYRK_DIAG]
    steps = [i for i, (m, _) in enumerate(iv) if m == M_STEP]
    lpos = [i for i, (m, _) in enumerate(iv) if m == M_L21]
    trail = [sum(d for _, d in iv[a + 1:b + 1]) for a, b in zip(lpos, steps[1:])]
    store = sum(d for m, d in iv if m == M_END)
    print("potrf_batched %s: %.1f us at %.2f GHz on block 0; load %.1f; diagonal "
          "chain (Cholesky + inverse, warp 0) %.1f (%d blocks, %s); L21 %.1f %s; "
          "trailing SYRK with the next diagonal block %.1f %s, of it warps 0-1's "
          "SYRK of the diagonal tile %.1f %s; store %.1f; %d block barriers" % (
              label, tot, ghz, load, sum(chol), len(chol), [round(x, 2) for x in chol],
              sum(l21), [round(x, 2) for x in l21], sum(trail),
              [round(x, 2) for x in trail], sum(sdiag), [round(x, 2) for x in sdiag],
              store, 2 * len(l21) + 2), flush=True)


def _getrf_batched_report(label: str, marks_by_block, ghz: float, cluster: int,
                          nt: int) -> None:
    """getrf_batched's smem route on the busiest block of the first
    problem's cluster (the most time outside the cluster barrier): the
    load, the column loops (µs a column), the row blocks' stores, the
    cluster-barrier waits (one a row block), each row block's end (U12:
    its pivots, L11 and the substitution; the update, the chunk that holds
    the next row block's rows, the look-ahead, apart from the rest) and
    the end (``getrf_batched.cu`` Mark)."""
    M_START, M_LOADED, M_COLUMN, M_STORED, M_WAITED, M_U12, M_UPDATED, M_END = range(8)
    rows = -(-nt // cluster)
    blocks = []
    for r in range(cluster):
        marks = marks_by_block[r]
        iv = _intervals(marks)
        wait = [d for m, d in iv if m == M_WAITED]
        blocks.append((marks[-1][1] - marks[0][1] - sum(wait), r, iv, wait))
    busy, r, iv, wait = max(blocks)
    col = [d for m, d in iv if m == M_COLUMN]
    b, look, rest, first = -1, [], [], False
    for m, d in iv:
        if m == M_WAITED:
            b += 1
            first = (b + 1) // rows == r and b + 1 < nt
        elif m == M_UPDATED:
            (look if first else rest).append(d)
            first = False
    u12 = [d for m, d in iv if m == M_U12]
    store = [d for m, d in iv if m == M_STORED]
    load = sum(d for m, d in iv if m == M_LOADED)
    print("getrf_batched %s (cluster of %d, %d row blocks a block): the busiest "
          "block %d, %.1f us outside the barrier at %.2f GHz; load %.1f; %d columns, "
          "%.3f us a column (median; %.1f in all); stores %.1f; %d cluster barriers "
          "a block, waits %.1f %s; U12 %.1f (%d chunks); update: look-ahead %.1f (%d), "
          "the rest %.1f (%d); end %.1f; by block, us outside the barrier %s" % (
              label, cluster, rows, r, busy, ghz, load, len(col),
              statistics.median(col) if col else 0.0, sum(col), sum(store), len(wait),
              sum(wait), [round(x, 1) for x in wait], sum(u12), len(u12), sum(look),
              len(look), sum(rest), len(rest), sum(d for m, d in iv if m == M_END),
              [round(x[0], 1) for x in sorted(blocks, key=lambda x: x[1])]), flush=True)


def _batched(name: str, torch, lib, gen, dev) -> None:
    """A batched kernel's stamped copy (:func:`batched_source`) at the
    drivers' (64, 256) and the served (16, 256): its plan and the ptxas
    line of the stamped copy, the launch's CUDA-event time, and the phases
    of :func:`_potrf_batched_report` / :func:`_getrf_batched_report`."""
    from ..ops import _build, kernels, smem

    fn = getattr(lib, "slate_%s_f32" % name)
    fn.argtypes = list(kernels._SIGNATURES[name][1][:-1]) + [P]
    fn.restype = I
    log = _build.BUILD_DIR / "phases" / ("lib%s_phases.so.log" % name)
    for bsz, n in ((64, 256), (16, 256)):
        keep, args = _batched_args(torch, name, bsz, n, gen, dev)
        us = _event_us(torch, lambda: fn(*args, torch.cuda.current_stream().cuda_stream))
        marks, ghz = _batched_run(lib, fn, args)
        label = "(%d, %d)" % (bsz, n)
        if name == "potrf_batched":
            route, nbytes = smem.potrf_batched_plan(n)
            print("potrf_batched %s: route %s, one block of 512 threads a problem, %d B "
                  "shared; ptxas of the stamped copy %s; %.1f us a launch (CUDA events)"
                  % (label, route, nbytes, "; ".join(ptxas_lines(log, "smem_kernel")), us),
                  flush=True)
            _potrf_batched_report(label, marks[0], ghz)
        else:
            route, cluster, nbytes = smem.getrf_batched_plan(n)
            print("getrf_batched %s: route %s, a cluster of %d blocks of 256 threads a "
                  "problem, %d B shared a block; ptxas of the stamped copy %s; %.1f us a "
                  "launch (CUDA events)" % (label, route, cluster, nbytes, "; ".join(
                      ptxas_lines(log, "cluster_kernelILi%dE" % -(-n // 256))), us),
                  flush=True)
            _getrf_batched_report(label, marks, ghz, cluster, n // 32)
        del keep


def ptxas_lines(log_path, key: str) -> list:
    """The registers and spill lines ``-Xptxas -v`` printed for the entries
    whose mangled names hold ``key``."""
    entry, out = None, []
    for ln in log_path.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            entry = m.group(1)
        elif entry and key in entry and ("registers" in ln or "spill" in ln):
            out.append(ln.split("info    :")[-1].strip())
    return out


def _chase(name: str, torch, lib, gen, dev) -> None:
    """A chase kernel at heev's and svd's shapes, (8192, 256) fp32 and
    (4096, 256) fp64, on a random band of width kd, in its stamped copy
    (:func:`chase_source`): the plan, registers, the launch's time by the
    global timer and the staggers; for the first block of each cluster its
    µs a stagger outside the stagger barrier and its tasks; and for the
    busiest one its µs a task in each phase, on its SM clock as block 0's
    cycles over the launch's nanoseconds give it."""
    from ..ops import _build, kernels, smem

    kind = name.split("_")[0]
    hb = kind == "hb2st"
    entry_args = kernels._SIGNATURES[name][1][:-1]
    for n, kd, dt in ((8192, 256, torch.float32), (4096, 256, torch.float64)):
        band = torch.zeros((n, (2 if hb else 3) * kd + 2), dtype=dt, device=dev)
        for d in range(kd + 1):
            band[:n - d, d if hb else kd + d] = torch.randn(
                n - d, generator=gen, device=dev, dtype=dt)
        nsw, nmax, tmax, nl = (kernels.hb_wave_meta if hb else kernels.tb_wave_meta)(n, kd)
        logs = torch.zeros((2, nsw, nmax, kd + 1), dtype=dt, device=dev)
        work = torch.empty_like(band)
        args = ([work.data_ptr(), work.stride(0), n, kd, 0, n - 2]
                + ([logs[0].data_ptr()] if hb else [logs[0].data_ptr(), logs[1].data_ptr()])
                + [nmax, 1])
        dts = "f32" if dt == torch.float32 else "f64"
        fn = getattr(lib, "slate_%s_%s" % (name, dts))
        fn.argtypes = list(entry_args) + [P]
        fn.restype = I
        ph, cnt = (ctypes.c_ulonglong * (12 * 132))(), (ctypes.c_ulonglong * (12 * 132))()
        mark = (ctypes.c_ulonglong * 4)()
        best = None
        for _ in range(2):
            work.copy_(band)
            logs.zero_()
            lib.chase_phases_reset()
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError("%s: CUDA error %d" % (name, rc))
            lib.chase_phases_read(ph, cnt, mark)
            ns = mark[3] - mark[1]
            if best is None or ns < best[0]:
                best = (ns, mark[2] - mark[0], list(ph), list(cnt))
        ns, cycles, ph_c, ph_n = best
        ghz = cycles / max(ns, 1)
        stag = tmax + 1
        g, c, route = _plan(lib, name, n, kd, 0, n, dt.itemsize, outs=3)
        rname = smem.CHASE_ROUTES[route]
        key = "I%sLb%dELb1E" % ("f" if dts == "f32" else "d", 1 - route)
        log = _build.BUILD_DIR / "phases" / ("lib%s_phases.so.log" % name)
        # per cluster (its first block): tasks run (stores), µs in each phase
        groups = [g for g in range(132) if any(ph_n[12 * g:12 * g + 12])]
        us = {g: [ph_c[12 * g + k] / ghz / 1e3 for k in range(12)] for g in groups}
        tasks = {g: ph_n[12 * g + 5] for g in groups}
        busy = max(groups, key=lambda g: sum(us[g]) - us[g][6])
        split = {CHASE_PHASES[k]: round(us[busy][k] / max(tasks[busy], 1), 3)
                 for k in range(12) if ph_n[12 * busy + k] and k != 6}
        print("%s (%d, %d) %s: %d clusters x %d blocks of %d threads (%d live tasks a "
              "stagger), route %s, %d B dynamic shared memory a block by the formula; "
              "ptxas of the stamped copy %s; %d staggers, %.3f ms by the global timer "
              "at %.2f GHz (block 0's clock), %.3f us a stagger; outside the stagger "
              "barrier, us a stagger by cluster %s; tasks by cluster %s; the busiest "
              "cluster (%d), us a task by phase %s" % (
                  name, n, kd, dts, g, c, smem.CHASE_THREADS, nl, rname,
                  smem.chase_block_bytes(kind, kd, dt, c, rname),
                  "; ".join(ptxas_lines(log, key)), stag, ns / 1e6, ghz, ns / 1e3 / stag,
                  [round((sum(us[g]) - us[g][6]) / stag, 2) for g in groups],
                  [tasks[g] for g in groups], busy, split), flush=True)


def _matmul(torch, lib, gen, dev) -> None:
    """The matmul kernel by CUDA events (it has no grid barrier to stamp):
    phase 2's timed shape, 8192³ and geqrf's two products under one wave
    (YᵀY and Yᵀ·C at K = 32768), each beside ``torch.matmul`` and, where
    the wrapper splits K, beside the same kernel with one part; then the
    device time of every matmul call inside one ``geqrf`` of bench.py's
    (32768, 4096) Gaussian, summed by the shape of the product."""
    import numpy as np

    import slate_tpu_torch as st
    from ..ops import kernels

    big = torch.randn((8192, 8192), generator=gen, device=dev)
    l21 = big[512:, :512]
    y = torch.randn((32768, 512), generator=gen, device=dev)
    c = torch.randn((32768, 3584), generator=gen, device=dev)
    cases = (("strip update (7680,512)x(512,2048), B a transposed view",
              l21, l21[:2048].mT),
             ("8192^3", big, big),
             ("Y^T Y (512,32768)x(32768,512)", y.mT, y),
             ("Y^T C (512,32768)x(32768,3584)", y.mT, c))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, a, b in cases:
        m, k = a.shape
        n = b.shape[1]
        us = _event_us(torch, lambda: kernels.matmul(a, b), 5)
        lib_us = _event_us(torch, lambda: torch.matmul(a, b), 5)
        line = "matmul %s: kernel %.1f us (%.1f TFLOP/s), torch.matmul %.1f us" % (
            label, us, 2.0 * m * n * k / us / 1e6, lib_us)
        s, staging = kernels.matmul_plan(a, b, sms)
        if s > 1:
            one = _event_us(torch, lambda: kernels._matmul_launch(a, b, 1), 5)
            line += "; %d parts of K (%s staging), one part %.1f us" % (s, staging, one)
        print(line, flush=True)
    del big, l21, y, c

    a = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (32768, 4096)).astype(np.float32)).to(dev)      # bench.py's geqrf input
    A = st.Matrix.from_array(a, nb=256, device=dev)
    st.geqrf(A)
    torch.cuda.synchronize()
    calls = []
    plain = kernels.matmul

    def timed(x, z):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = plain(x, z)
        e1.record()
        calls.append((x.shape[0], x.shape[1], z.shape[1], e0, e1))
        return out

    kernels.matmul = timed
    try:
        st.geqrf(A)
        torch.cuda.synchronize()
    finally:
        kernels.matmul = plain
    by = {}
    for m, k, n, e0, e1 in calls:
        kind = ("Y^T Y (512, mk)x(mk, 512)" if m == n == 512 and k > 512 else
                "Y^T C (512, mk)x(mk, nt)" if m == 512 and k > 512 else
                "K = 512 (mk, 512)x(512, n)" if k == 512 and m > 512 else "other")
        t = by.setdefault(kind, [0, 0.0])
        t[0] += 1
        t[1] += e0.elapsed_time(e1)
    print("matmul inside one geqrf (32768,4096): %d calls, %.3f ms; %s" % (
        len(calls), sum(v[1] for v in by.values()), "; ".join(
            "%s %d calls %.3f ms" % (kind, v[0], v[1]) for kind, v in sorted(by.items()))),
        flush=True)


CHASES = ("hb2st_wavefront", "tb2bd_wavefront")
SECTIONS = {"lu_inv_panel": _lu_inv_panel, "lu_u12_panel": _lu_u12_panel,
            "chol_inv_panel": _chol_inv_panel, "potrf_full_fused": _potrf_full_fused,
            "trtri_panel": _trtri_panel, "getrf_full_fused": _getrf_full_fused,
            "potrf_step_fused": _potrf_step_fused, "getrf_step_fused": _getrf_step_fused,
            "chol_l21_panel": _chol_l21_panel, "matmul": _matmul,
            "getrf_panel_fused": functools.partial(_lu_panel, "getrf_panel_fused"),
            "getrf_panel_linv": functools.partial(_lu_panel, "getrf_panel_linv"),
            "hb2st_wavefront": functools.partial(_chase, "hb2st_wavefront"),
            "tb2bd_wavefront": functools.partial(_chase, "tb2bd_wavefront"),
            "potrf_batched": functools.partial(_batched, "potrf_batched"),
            "getrf_batched": functools.partial(_batched, "getrf_batched")}


def main(argv=None) -> int:
    import torch

    names = list(sys.argv[1:] if argv is None else argv) or list(SECTIONS)
    bad = [x for x in names if x not in SECTIONS]
    if bad:
        print("kernel_phases: no kernel %s (choose from %s)" % (bad, list(SECTIONS)),
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(60)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = build([x for x in names if x in MARKS or x in CHASES or x in BATCHED])
    for name in names:
        SECTIONS[name](torch, libs.get(name), gen, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
