"""Where the time goes inside one launch of the grid triangular kernels
(``csrc/lu_inv_panel.cu``, ``csrc/lu_u12_panel.cu``,
``csrc/chol_inv_panel.cu``, ``csrc/potrf_full_fused.cu``): device time
stamps between their phases.  Needs a CUDA card and ``nvcc``::

    python3 -m slate_tpu_torch.perf.kernel_phases

For each kernel it builds a stamped copy of the source (``tri_grid.cuh``
inlined) into ``build/slate_tpu_torch/phases/``: block 0's thread 0 reads
the global timer and its SM's cycle counter at the kernel's start, after
every grid barrier and at the marks below, and every block stamps its end.
It launches the copy at the main paths' shapes (``lu_inv_panel`` and
``chol_inv_panel`` at nb = 512 and 256, ``lu_u12_panel`` at the ring call
(256, 256), the checked runs' (256, 4096) and the block row (256, 16384),
``potrf_full_fused`` at (8192, 8192), nb = 512) and prints the best of
five launches: each interval in microseconds, block 0's SM clock over the
launch, for ``lu_inv_panel`` and ``chol_inv_panel`` the median of each part
of a step and the doubling, and for ``potrf_full_fused`` the diagonal
phase A against the L21 and trailing phases B + C, summed over the steps.
The stamps cost a few instructions on block 0; the kernels the port
launches carry none.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys

_HEAD = r'''
__device__ unsigned long long g_st[1024];
__device__ unsigned long long g_ck[1024];
__device__ int g_n;
__device__ unsigned long long g_end;
__device__ __forceinline__ unsigned long long g_time() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP() do { if (blockIdx.x == 0 && threadIdx.x == 0) { \
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
  cudaMemcpyFromSymbol(st, g_st, 8 * 1024);
  return (int)cudaMemcpyFromSymbol(ck, g_ck, 8 * 1024);
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
    "potrf_full_fused": []}


def stamped_source(name: str) -> str:
    """The source of kernel ``name`` with the header inlined and stamps
    at its start, after each grid barrier, at :data:`MARKS` and at every
    block's end."""
    from ..ops import _build

    src = (_build.CSRC / (name + ".cu")).read_text()
    hdr = (_build.CSRC / "tri_grid.cuh").read_text().replace("#pragma once", "")
    end = src.index("\n}\n\n}  // namespace")   # the kernel's closing brace
    src = (src[:end] + "\n  __syncthreads();\n"
           "  if (threadIdx.x == 0) atomicMax(&g_end, g_time());" + src[end:])
    src = src.replace('#include "tri_grid.cuh"', _HEAD + hdr)
    src = src.replace("grid.sync();", "grid.sync(); STAMP();")
    src = src.replace("cg::grid_group grid = cg::this_grid();",
                      "cg::grid_group grid = cg::this_grid(); STAMP();")
    for old, new in MARKS[name]:
        if old not in src:
            raise RuntimeError("%s: the mark %r is not in the source" % (name, old))
        src = src.replace(old, new)
    return src + _TAIL


def build(name: str) -> ctypes.CDLL:
    from ..ops import _build

    out = _build.BUILD_DIR / "phases"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / (name + "_phases.cu")
    cu.write_text(stamped_source(name))
    so = out / ("lib%s_phases.so" % name)
    r = subprocess.run([_build.nvcc_path(), *_build.FLAGS, "-I", str(_build.CSRC),
                        "-o", str(so), str(cu)], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError("nvcc failed on %s:\n%s%s" % (cu, r.stdout, r.stderr))
    return ctypes.CDLL(str(so))


def run(lib, entry: str, argtypes, args, reps: int = 5, setup=None):
    """Best of ``reps`` launches: (intervals in µs, SM clock in GHz).
    ``setup`` (untimed) runs before each launch."""
    import torch

    fn = getattr(lib, entry)
    fn.argtypes = list(argtypes) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    st, ck = (ctypes.c_ulonglong * 1024)(), (ctypes.c_ulonglong * 1024)()
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
        t = [st[i] - st[0] for i in range(n.value)] + [end.value - st[0]]
        if best is None or t[-1] < best[0][-1]:
            ghz = (ck[n.value - 1] - ck[0]) / max(1, t[n.value - 1])
            best = (t, ghz)
    t, ghz = best
    return [(t[i + 1] - t[i]) / 1e3 for i in range(len(t) - 1)], ghz


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device", file=sys.stderr)
        return 2
    P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(60)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    inv = build("lu_inv_panel")
    for nb in (512, 256):
        a = torch.randn((nb, nb), generator=gen, device=dev) + nb * torch.eye(nb, device=dev)
        lu, li, ui, w = (torch.empty((nb, nb), device=dev) for _ in range(4))
        g = ctypes.c_int()
        inv.slate_lu_inv_panel_plan(nb, ctypes.byref(g))
        d, ghz = run(inv, "slate_lu_inv_panel_f32", [P, I64, P, P, P, P, I, I],
                     [a.data_ptr(), nb, lu.data_ptr(), li.data_ptr(), ui.data_ptr(),
                      w.data_ptr(), nb, g.value])
        # start, prologue: zero + load, LU, inverses, stores + barrier; then
        # per step: loads, products, LU, inverses, stores + barrier
        steps = nb // 32 - 1
        body = d[4:4 + 5 * steps]
        parts = ("loads", "products", "LU", "inverses", "stores+barrier")
        med = {p: statistics.median(body[i::5]) for i, p in enumerate(parts)}
        print("lu_inv_panel nb=%d grid %d: %.1f us at %.2f GHz; prologue %s; "
              "a step (median us) %s; the doublings %s" % (
                  nb, g.value, sum(d), ghz, [round(x, 1) for x in d[:4]],
                  {k: round(v, 2) for k, v in med.items()},
                  [round(x, 1) for x in d[4 + 5 * steps:]]), flush=True)
    u12 = build("lu_u12_panel")
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
        g = ctypes.c_int()
        u12.slate_lu_u12_panel_plan(nb, w, ctypes.byref(g))
        d, ghz = run(u12, "slate_lu_u12_panel_f32", [P, I64, P, I64] + [P] * 6 + [I] * 3,
                     [l11.data_ptr(), nb, b.data_ptr(), w, u.data_ptr(), li.data_ptr(),
                      wk.data_ptr(), r.data_ptr(), mx.data_ptr(), dv.data_ptr(), nb, w,
                      g.value])
        # zero + load, diagonal inverses, stores + barrier, the doubling's
        # phases, then u1, r1, U
        print("lu_u12_panel (%d,%d) grid %d: %.1f us at %.2f GHz; diagonal "
              "inverses %.1f, stores + barrier %.1f; the doubling %.1f %s; "
              "u1 %.1f, r1 %.1f, U %.1f" % (
                  nb, w, g.value, sum(d), ghz, d[1], d[2], sum(d[3:-3]),
                  [round(x, 1) for x in d[3:-3]], d[-3], d[-2], d[-1]), flush=True)
    chol = build("chol_inv_panel")
    for nb in (512, 256):
        g0 = torch.randn((nb, nb), generator=gen, device=dev)
        a = g0 @ g0.T + nb * torch.eye(nb, device=dev)
        l, li = torch.empty((nb, nb), device=dev), torch.empty((nb, nb), device=dev)
        w = torch.empty(nb * nb, device=dev)
        g = ctypes.c_int()
        chol.slate_chol_inv_panel_plan(nb, ctypes.byref(g))
        d, ghz = run(chol, "slate_chol_inv_panel_f32", [P, I64, P, P, P, I, I],
                     [a.data_ptr(), nb, l.data_ptr(), li.data_ptr(), w.data_ptr(),
                      nb, g.value])
        # prologue: zero + load, the 32² Cholesky and inverse, stores +
        # barrier; then per step: loads, products, Cholesky and inverse,
        # stores + barrier; then the doubling's phases
        steps = nb // 32 - 1
        body = d[3:3 + 4 * steps]
        parts = ("loads", "products", "Cholesky+inverse", "stores+barrier")
        med = {p: statistics.median(body[i::4]) for i, p in enumerate(parts)}
        print("chol_inv_panel nb=%d grid %d: %.1f us at %.2f GHz; prologue %s; "
              "a step (median us) %s; steps %.1f; the doubling %.1f %s" % (
                  nb, g.value, sum(d), ghz, [round(x, 1) for x in d[:3]],
                  {k: round(v, 2) for k, v in med.items()}, sum(body),
                  sum(d[3 + 4 * steps:]),
                  [round(x, 1) for x in d[3 + 4 * steps:]]), flush=True)
    full = build("potrf_full_fused")
    n, nb, tc = 8192, 512, 512
    r = torch.randn((n, n), generator=gen, device=dev)
    spd = (r + r.T) / 2 + n * torch.eye(n, device=dev)      # the tester's herm(n)
    del r
    a = torch.empty_like(spd)
    lkk, li, s = (torch.empty((nb, nb), device=dev) for _ in range(3))
    l21 = torch.empty((n - nb, nb), device=dev)
    g = ctypes.c_int()
    full.slate_potrf_full_fused_plan(n, nb, tc, ctypes.byref(g))
    d, ghz = run(full, "slate_potrf_full_fused_f32", [P, I64] + [P] * 4 + [I] * 4,
                 [a.data_ptr(), n, lkk.data_ptr(), li.data_ptr(), s.data_ptr(),
                  l21.data_ptr(), n, nb, tc, g.value], setup=lambda: a.copy_(spd))
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
              n, n, nb, g.value, sum(d), ghz, sum(pa), statistics.median(pa),
              sum(pb) + sum(pc), sum(pb), sum(pc), [round(x, 1) for x in pa],
              [round(x, 1) for x in pb], [round(x, 1) for x in pc]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
