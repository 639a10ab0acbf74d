#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``slate_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (``nvidia-smi``) and builds
   every kernel from ``slate_tpu_torch/csrc`` (``nvcc``, one process per
   source, into ``build/slate_tpu_torch/``).
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it, and times kernel, plain version and a
   library yardstick with CUDA events (the yardstick is timed here only;
   the port never calls it in place of a kernel).
   The LU panel kernels are held to the same pivots as their plain
   versions (a near-tie, within 1e-5 relative, is printed and excepted),
   to a panel residual < 60 and to ‖L11·linv − I‖ < 1e-3.
3. Drives the main paths through the public entry points, with the
   reference tester's scaled-residual gates (≤ 3):
   * Cholesky: ``posv`` of an n = 8192 fp32 HermitianMatrix (nb = 256,
     so 512-wide panels) with 128 right-hand sides, ``potri`` of its
     factor and ``gemm`` at 8192;
   * LU: ``gesv`` of an n = 8192 Gaussian Matrix (nb = 256) with 128
     right-hand sides through the scattered driver (the default sites),
     ``gesv`` again through the blocked recursion
     (``config.scattered_lu`` off) and ``getri`` of the first factor,
     plus |L| ≤ 1 + 100ε; the first column where the two drivers' pivots
     differ is printed with both candidates' magnitudes, and one more
     profiled ``gesv`` per driver prints its device time by kernel.
   Every kernel's launch count is set to 0 just before each path (each
   LU driver and ``getri`` a path of its own) and read just after it; a
   kernel of the path that was not launched fails the run.
4. Prints one JSON line of per-kernel numbers, then, as the last line,
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, on any failure, when no CUDA device
is present, or when run without the rest of the repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

N, NB, NRHS = 8192, 256, 128
PANEL_NB = 512                  # potrf's panel width for nb = 256
STRIP = 2048                    # the strip driver's trailing strip width
TRTRI_NB = 256                  # potri's diagonal tiles at nb = 256
PEAK_FP32_FLOPS = 67e12         # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12            # H100 SXM HBM3
REPO = {"matmul": ("slate_tpu_torch/csrc/matmul.cu",
                   "slate_tpu/ops/pallas_kernels.py:95"),
        "chol_inv_panel": ("slate_tpu_torch/csrc/chol_inv_panel.cu",
                           "slate_tpu/ops/pallas_kernels.py:395"),
        "trtri_panel": ("slate_tpu_torch/csrc/trtri_panel.cu",
                        "slate_tpu/ops/pallas_kernels.py:571"),
        "getrf_panel_linv": ("slate_tpu_torch/csrc/getrf_panel_linv.cu",
                             "slate_tpu/ops/pallas_kernels.py:873"),
        "getrf_panel_fused": ("slate_tpu_torch/csrc/getrf_panel_fused.cu",
                              "slate_tpu/ops/pallas_kernels.py:1080")}
LU_NB, LU_BB, LU_IB = 512, 128, 16   # the scattered driver's panel call
LEAF_W, LEAF_IB = 256, 32            # getrf_rec's kernel leaf at nb = 256
#: kernels of each main path; the path must launch every one of them
PATHS = {"cholesky": ("matmul", "chol_inv_panel", "trtri_panel"),
         "lu_scattered": ("matmul", "getrf_panel_fused"),
         "lu_rec": ("matmul", "getrf_panel_linv"),
         "getri": ("matmul",)}


def fail(msg: str):
    raise RuntimeError("chip_smoke: " + msg)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up,
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float):
    """Least time the card could take: the larger of operations over the
    fp32 peak and bytes over the memory rate, in ms, and which bounds."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def rel_err(x, ref) -> float:
    return float((x.double() - ref.double()).norm() / ref.double().norm())


def check_kernels(torch, kernels, dev) -> dict:
    """Phase 2: each kernel against its plain version at main-path shapes."""
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}

    # matmul: the first strip update of potrf, L21[o:]·L21[o:o+2048]ᵀ with
    # L21 a (7680, 512) column panel of the (8192, 8192) carry
    carry = torch.randn((N, N), generator=gen, device=dev)
    l21 = carry[PANEL_NB:, :PANEL_NB]
    a, b = l21, l21[:STRIP].mT
    m, k = a.shape
    n = b.shape[1]
    got, ref = kernels.matmul(a, b), kernels.matmul_plain(a, b)
    torch.cuda.synchronize()
    err = rel_err(got, ref)
    if not err <= 1e-5:
        fail("matmul disagrees with its plain version: rel %.3e" % err)
    b_ms, b_by = bound(2.0 * m * n * k, 4.0 * (m * k + k * n + m * n))
    out["matmul"] = dict(
        shape="(%d,%d)x(%d,%d) B transposed view" % (m, k, k, n),
        max_abs_err=float((got - ref).abs().max()), rel_err=err,
        tol="rel Frobenius <= 1e-5",
        ms=cuda_ms(torch, lambda: kernels.matmul(a, b), 20),
        plain_ms=cuda_ms(torch, lambda: kernels.matmul_plain(a, b), 20),
        library_ms=cuda_ms(torch, lambda: torch.matmul(a, b), 20),
        bound_ms=b_ms, bound_by=b_by)
    # the same kernel at the gemm shape of phase 3 (reported, not gated
    # separately: phase 3 gates gemm's result)
    g1 = carry[:, :N]
    print("matmul at %d^3: kernel %.3f ms, torch.matmul %.3f ms, bound %.3f ms"
          % (N, cuda_ms(torch, lambda: kernels.matmul(g1, g1), 3),
             cuda_ms(torch, lambda: torch.matmul(g1, g1), 3),
             bound(2.0 * N ** 3, 12.0 * N * N)[0]), flush=True)
    del got, ref

    # chol_inv_panel: a 512² diagonal block read in place from the carry
    # (row stride 8192), stale values above its diagonal
    g = torch.randn((PANEL_NB, PANEL_NB), generator=gen, device=dev)
    spd = g @ g.T + PANEL_NB * torch.eye(PANEL_NB, device=dev)
    carry[:PANEL_NB, :PANEL_NB] = torch.tril(spd) + torch.triu(
        torch.full_like(spd, 1e3), 1)
    akk = carry[:PANEL_NB, :PANEL_NB]
    (l, li), (lp, lip) = kernels.chol_inv_panel(akk), \
        kernels.chol_inv_panel_plain(akk)
    torch.cuda.synchronize()
    err = max(rel_err(l, lp), rel_err(li, lip))
    eye = torch.eye(PANEL_NB, device=dev)
    fac = float((l.double() @ l.double().T - spd.double()).norm()
                / spd.double().norm())
    if not (err <= 1e-4 and fac < 1e-5 and float((l @ li - eye).norm()) < 1e-4):
        fail("chol_inv_panel disagrees: rel %.3e, factor %.3e" % (err, fac))
    nb = PANEL_NB
    b_ms, b_by = bound(2.0 * nb ** 3 / 3, 4.0 * (nb * (nb + 1) / 2 + 2 * nb * nb))

    def library_chol():
        lk = torch.linalg.cholesky(akk)
        return torch.linalg.solve_triangular(lk, eye, upper=False)

    out["chol_inv_panel"] = dict(
        shape="(%d,%d) view, row stride %d" % (nb, nb, N),
        max_abs_err=float(max((l - lp).abs().max(), (li - lip).abs().max())),
        rel_err=err, tol="rel Frobenius of L and L^-1 <= 1e-4",
        ms=cuda_ms(torch, lambda: kernels.chol_inv_panel(akk), 20),
        plain_ms=cuda_ms(torch, lambda: kernels.chol_inv_panel_plain(akk), 3),
        library_ms=cuda_ms(torch, library_chol, 20),
        bound_ms=b_ms, bound_by=b_by)

    # trtri_panel: a 256² diagonal tile of a factor, in place (stride 512)
    tl = l[:TRTRI_NB, :TRTRI_NB]
    got, ref = kernels.trtri_panel(tl), kernels.trtri_panel_plain(tl)
    torch.cuda.synchronize()
    err = rel_err(got, ref)
    eye2 = torch.eye(TRTRI_NB, device=dev)
    if not (err <= 1e-4 and float((tl @ got - eye2).norm()) < 1e-4):
        fail("trtri_panel disagrees with its plain version: rel %.3e" % err)
    nb = TRTRI_NB
    b_ms, b_by = bound(nb ** 3 / 3.0, 4.0 * (nb * (nb + 1) / 2 + nb * nb))
    out["trtri_panel"] = dict(
        shape="(%d,%d) view, row stride %d" % (nb, nb, PANEL_NB),
        max_abs_err=float((got - ref).abs().max()), rel_err=err,
        tol="rel Frobenius <= 1e-4",
        ms=cuda_ms(torch, lambda: kernels.trtri_panel(tl), 20),
        plain_ms=cuda_ms(torch, lambda: kernels.trtri_panel_plain(tl), 5),
        library_ms=cuda_ms(torch, lambda: torch.linalg.solve_triangular(
            tl, eye2, upper=False), 20),
        bound_ms=b_ms, bound_by=b_by)
    for name, r in out.items():
        print("kernel %s %s: max_abs_err %.3e rel %.3e (%s); kernel %.4f ms, "
              "plain %.4f ms, library %.4f ms, bound %.5f ms (%s)"
              % (name, r["shape"], r["max_abs_err"], r["rel_err"], r["tol"],
                 r["ms"], r["plain_ms"], r["library_ms"], r["bound_ms"],
                 r["bound_by"]), flush=True)
    return out


def main_path(torch, st, kernels, dev) -> dict:
    """Phase 3: posv, potri and gemm through the public entry points,
    with the reference tester's checks."""
    gen = torch.Generator(device=dev).manual_seed(2)
    eps = float(torch.finfo(torch.float32).eps)
    r = torch.randn((N, N), generator=gen, device=dev)
    a = (r + r.T) / 2 + N * torch.eye(N, device=dev)     # the tester's herm(n)
    b = torch.randn((N, NRHS), generator=gen, device=dev)
    c = torch.randn((N, N), generator=gen, device=dev)
    A = st.HermitianMatrix(a, uplo=st.Uplo.Lower, mb=NB, nb=NB)
    torch.cuda.synchronize()

    kernels.reset_launches()
    t0 = time.perf_counter()
    fac, x = st.posv(A, b)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    inv = st.potri(fac)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    prod = st.gemm(1.0, r, a, 1.0, c)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = dict(kernels.launches)

    for name, t in (("factor", fac.data), ("x", x), ("inverse", inv.data),
                    ("gemm", prod)):
        if not bool(torch.isfinite(t).all()):
            fail("%s has non-finite values" % name)
    if tuple(x.shape) != (N, NRHS) or tuple(prod.shape) != (N, N):
        fail("wrong output shapes %s, %s" % (tuple(x.shape), tuple(prod.shape)))
    ad = a.double()
    xd = x.double()
    posv_res = float((ad @ xd - b.double()).norm()
                     / (ad.norm() * xd.norm() * eps * N))
    ld = fac.data.double()
    potrf_res = float((ld @ ld.T - ad).norm() / (ad.norm() * eps * N))
    invd = inv.data.double()
    invd = torch.tril(invd) + torch.tril(invd, -1).T
    ainv_err = float((invd @ ad - torch.eye(N, device=dev,
                                            dtype=torch.float64)).norm())
    cond1 = float(torch.linalg.matrix_norm(ad, 1)
                  * torch.linalg.matrix_norm(invd, 1))
    potri_res = ainv_err / (eps * N * cond1)
    ref = r.double() @ ad + c.double()
    gemm_res = float((prod.double() - ref).norm()
                     / ((r.double().norm() * ad.norm() + c.double().norm())
                        * eps * N))
    res = dict(posv_residual=posv_res, potrf_residual=potrf_res,
               potri_residual=potri_res,
               potri_AinvA_minus_I_in_n_eps=ainv_err / (eps * N),
               gemm_residual=gemm_res, posv_ms=(t1 - t0) * 1e3,
               potri_ms=(t2 - t1) * 1e3, gemm_ms=(t3 - t2) * 1e3,
               launches=launches)
    print("main path n=%d nb=%d nrhs=%d: posv %.1f ms (residual %.3g, factor "
          "%.3g), potri %.1f ms (residual %.3g; ||A^-1 A - I|| = %.3g n*eps), "
          "gemm %.1f ms (residual %.3g); launches %s"
          % (N, NB, NRHS, res["posv_ms"], posv_res, potrf_res,
             res["potri_ms"], potri_res, res["potri_AinvA_minus_I_in_n_eps"],
             res["gemm_ms"], gemm_res, launches), flush=True)
    for name in ("posv", "potrf", "potri", "gemm"):
        if not res[name + "_residual"] <= 3:
            fail("%s residual %.3f > 3" % (name, res[name + "_residual"]))
    missing = [k for k in PATHS["cholesky"] if launches[k] <= 0]
    if missing:
        fail("the Cholesky path launched no %s kernel" % ", ".join(missing))
    return res


def _lu_of_panel(torch, out, piv, act_out):
    """(L, U, perm) of a factored (w, m) lane-major panel, in float64:
    perm is the pivot lanes, then the lanes still active, in order (the
    lanes retired before the panel took no part in it)."""
    w = out.shape[0]
    perm = torch.cat([piv, (act_out[0] > 0.5).nonzero()[:, 0]])
    lu = out[:, perm].T.double()
    low = torch.tril(lu, -1) + torch.eye(perm.numel(), w,
                                         dtype=torch.float64, device=lu.device)
    return low, torch.triu(lu[:w]), perm


def _panel_gates(torch, name, a_rows, out, piv, act_out, linv, ref):
    """The gates of one panel-kernel call: pivots equal to the plain
    version's (a near-tie excepted and printed), slab and linv within
    1e-4, ‖L·U − A[perm]‖/(‖A‖·ε·m) < 60 and ‖L11·linv − I‖ < 1e-3.
    Returns the max abs difference from the plain version (over the
    panel rows before a near-tie, which both compute the same way)."""
    eps = float(torch.finfo(torch.float32).eps)
    w, m = out.shape
    rout, rpiv, ract, rlinv = ref
    diff = (piv != rpiv).nonzero()
    tie = None
    if diff.numel():
        j = int(diff[0, 0])
        pk, pp = int(piv[j]), int(rpiv[j])
        mk = abs(float(out[j, pk]))
        mp = abs(float(out[j, pp])) * mk    # |multiplier| · |pivot|
        if not abs(mk - mp) <= 1e-5 * mk:
            fail("%s: pivot %d is lane %d, the plain version's lane %d "
                 "(|x| %.9g vs %.9g): not a near-tie" % (name, j, pk, pp, mk, mp))
        tie = (j, pk, pp, mk, mp)
        print("%s: near-tie at column %d: lanes %d (kernel, |x| %.9g) and %d "
              "(plain, |x| %.9g); later columns not compared"
              % (name, j, pk, mk, pp, mp), flush=True)
    else:
        err = max(rel_err(out, rout), rel_err(linv, rlinv))
        if not err <= 1e-4 or not torch.equal(act_out, ract):
            fail("%s disagrees with its plain version: rel %.3e" % (name, err))
    low, up, perm = _lu_of_panel(torch, out, piv, act_out)
    ad = a_rows.double()[perm]
    res = float((low @ up - ad).norm() / (ad.norm() * eps * perm.numel()))
    l11 = low[:w]
    inv_err = float((l11 @ linv.double()
                     - torch.eye(w, dtype=torch.float64, device=out.device)).norm())
    if not (res < 60 and inv_err < 1e-3):
        fail("%s: panel residual %.3g (< 60), ||L11 linv - I|| %.3g (< 1e-3)"
             % (name, res, inv_err))
    if tie is not None:
        return float((out[:tie[0]] - rout[:tie[0]]).abs().max())
    return float(max((out - rout).abs().max(), (linv - rlinv).abs().max()))


def check_lu_kernels(torch, kernels, dev) -> dict:
    """Phase 2b: the two LU panel kernels against their plain versions at
    the main-path shapes."""
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    eye_nb = torch.eye(LU_NB, device=dev)

    # getrf_panel_fused: the (8192, 8192) transposed carry, panels at
    # k0 = 0 and then k0 = 512 on the kernel's own output
    carry0 = torch.randn((N, N), generator=gen, device=dev)
    ck, cp = carry0.clone(), carry0.clone()
    ak = ap = torch.ones((1, N), device=dev)
    errs = []
    for k0 in (0, LU_NB):
        before = ck.clone()
        a_rows = ck[k0:k0 + LU_NB].T.clone()          # the panel as A holds it
        _, piv, ak2, linv = kernels.getrf_panel_fused(ck, ak, k0, nb=LU_NB,
                                                      bb=LU_BB, ib=LU_IB)
        cp.copy_(before)
        _, rpiv, ap2, rlinv = kernels.getrf_panel_fused_plain(
            cp, ak, k0, nb=LU_NB, bb=LU_BB, ib=LU_IB)
        torch.cuda.synchronize()
        if not (torch.equal(ck[:k0], before[:k0])
                and torch.equal(ck[k0 + LU_NB:], before[k0 + LU_NB:])):
            fail("getrf_panel_fused wrote rows outside [%d, %d)"
                 % (k0, k0 + LU_NB))
        errs.append(_panel_gates(
            torch, "getrf_panel_fused k0=%d" % k0, a_rows,
            ck[k0:k0 + LU_NB], piv, ak2, linv,
            (cp[k0:k0 + LU_NB], rpiv, ap2, rlinv)))
        ak = ak2
    del cp, before

    # timing: each call factors a fresh panel of the same carry, as the
    # driver's 16 calls do
    work = carry0.clone()
    act1 = torch.ones((1, N), device=dev)
    k0s = iter(range(0, 10 ** 9, LU_NB))

    def fused_call(fn):
        def call():
            k0 = next(k0s) % N
            if k0 == 0:
                work.copy_(carry0)
            fn(work, act1, k0, nb=LU_NB, bb=LU_BB, ib=LU_IB)
        return call

    pan = carry0[:LU_NB].T.contiguous()            # (8192, 512) panel

    def library_lu(p=pan, w=LU_NB):
        # cuSOLVER's getrf (PyTorch's MAGMA route warns at this shape)
        saved = torch.backends.cuda.preferred_linalg_library()
        torch.backends.cuda.preferred_linalg_library("cusolver")
        try:
            lu, _ = torch.linalg.lu_factor(p)
            return torch.linalg.solve_triangular(
                lu[:w], torch.eye(w, device=dev), upper=False,
                unitriangular=True)
        finally:
            torch.backends.cuda.preferred_linalg_library(saved)

    flops = N * LU_NB ** 2 - LU_NB ** 3 / 3 + LU_NB ** 3 / 3
    b_ms, b_by = bound(flops, 2.0 * N * LU_NB * 4)
    out["getrf_panel_fused"] = dict(
        shape="(%d,%d) carry, k0=0 and 512, nb=%d bb=%d ib=%d"
              % (N, N, LU_NB, LU_BB, LU_IB),
        max_abs_err=max(errs), rel_err=None, tol="pivots exact (near-ties reported), rel 1e-4",
        ms=cuda_ms(torch, fused_call(kernels.getrf_panel_fused), 8),
        plain_ms=cuda_ms(torch, fused_call(kernels.getrf_panel_fused_plain), 1),
        library_ms=cuda_ms(torch, library_lu, 8),
        bound_ms=b_ms, bound_by=b_by)
    del work

    # getrf_panel_linv: a (256, 8192) slab, as getrf_rec's first leaf
    slab = carry0[2 * LU_NB:2 * LU_NB + LEAF_W].contiguous()
    act = torch.ones((1, N), device=dev)
    got = kernels.getrf_panel_linv(slab, act, ib=LEAF_IB)
    ref = kernels.getrf_panel_linv_plain(slab, act, ib=LEAF_IB)
    torch.cuda.synchronize()
    err = _panel_gates(torch, "getrf_panel_linv", slab.T, *got, ref)
    pan = slab.T.contiguous()
    flops = N * LEAF_W ** 2 - LEAF_W ** 3 / 3 + LEAF_W ** 3 / 3
    b_ms, b_by = bound(flops, 2.0 * N * LEAF_W * 4)
    out["getrf_panel_linv"] = dict(
        shape="(%d,%d) slab, ib=%d" % (LEAF_W, N, LEAF_IB),
        max_abs_err=err, rel_err=None,
        tol="pivots exact (near-ties reported), rel 1e-4",
        ms=cuda_ms(torch, lambda: kernels.getrf_panel_linv(slab, act,
                                                           ib=LEAF_IB), 10),
        plain_ms=cuda_ms(torch, lambda: kernels.getrf_panel_linv_plain(
            slab, act, ib=LEAF_IB), 1),
        library_ms=cuda_ms(torch, lambda: library_lu(pan, LEAF_W), 10),
        bound_ms=b_ms, bound_by=b_by)
    for name, r in out.items():
        print("kernel %s %s: max_abs_err %.3e (%s); kernel %.4f ms, plain "
              "%.4f ms, library %.4f ms, bound %.5f ms (%s)"
              % (name, r["shape"], r["max_abs_err"], r["tol"], r["ms"],
                 r["plain_ms"], r["library_ms"], r["bound_ms"],
                 r["bound_by"]), flush=True)
    return out


def lu_split(torch, st, A, b, label: str) -> None:
    """Where one more gesv's device time goes, from a torch.profiler
    trace: the LU panel kernels, the matmul kernel, and everything else
    (cuBLAS products and solves, copies, elementwise ops).  The caller
    picks the driver.  Printed only; a trace with no device time prints
    'not measured'.  A failure of the gesv fails the run."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        st.gesv(A, b)
        torch.cuda.synchronize()
    split = {"lu panel kernel": 0.0, "matmul kernel": 0.0, "other": 0.0}
    for ev in prof.key_averages():
        # kernel events only: a CPU op's self device time repeats the
        # kernels it launched
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if not us:
            continue
        key = ("lu panel kernel" if "lu_panel_kernel" in ev.key else
               "matmul kernel" if "matmul_f32_kernel" in ev.key else "other")
        split[key] += us / 1e3
    total = sum(split.values())
    if not total:
        print("LU split (%s): not measured (no device time in the trace)"
              % label, flush=True)
        return
    print("LU split (%s gesv, device ms from torch.profiler): %s; total %.1f"
          % (label, ", ".join("%s %.1f" % kv for kv in split.items()), total),
          flush=True)


def run_path(torch, kernels, path: str, fn):
    """Run ``fn`` with every launch count set to 0 just before it and
    read just after it; fail unless each kernel of ``path`` launched.
    Returns ``(fn's result, host wall ms, launches)``."""
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(kernels.launches)
    missing = [k for k in PATHS[path] if launches[k] <= 0]
    if missing:
        fail("the %s path launched no %s kernel" % (path, ", ".join(missing)))
    return out, ms, launches


def first_pivot_difference(torch, lu_s, perm_s, lu_r, perm_r):
    """The first column where the two drivers chose different pivot rows,
    with both candidates' updated magnitudes in each driver's factor: a
    pivot's is |U[j, j]|, the other row's |L[i, j]|·|U[j, j]|.  None when
    the pivots agree."""
    diff = (perm_s != perm_r).nonzero()
    if not diff.numel():
        return None
    j = int(diff[0, 0])
    out = {"column": j, "rows": (int(perm_s[j]), int(perm_r[j]))}
    for tag, lu, perm, other in (("scattered", lu_s, perm_s, perm_r[j]),
                                 ("rec", lu_r, perm_r, perm_s[j])):
        pos = int((perm == other).nonzero()[0, 0])
        u = abs(float(lu[j, j]))
        out[tag] = (u, abs(float(lu[pos, j])) * u)
    return out


def main_path_lu(torch, st, kernels, dev) -> dict:
    """Phase 3b: gesv through the scattered driver (the default sites),
    gesv through the blocked recursion (``config.scattered_lu`` off) and
    getri of the first factor, each a path of its own for the launch
    gates, with the reference tester's checks."""
    from slate_tpu_torch import config

    gen = torch.Generator(device=dev).manual_seed(4)
    eps = float(torch.finfo(torch.float32).eps)
    a = torch.randn((N, N), generator=gen, device=dev)   # the tester's gesv A
    b = torch.randn((N, NRHS), generator=gen, device=dev)
    A = st.Matrix.from_array(a, nb=NB)
    torch.cuda.synchronize()

    (lu_s, perm_s, x_s), ms_s, l_s = run_path(
        torch, kernels, "lu_scattered", lambda: st.gesv(A, b))
    saved = config.scattered_lu
    config.scattered_lu = False
    try:
        (lu_r, perm_r, x_r), ms_r, l_r = run_path(
            torch, kernels, "lu_rec", lambda: st.gesv(A, b))
    finally:
        config.scattered_lu = saved
    inv, ms_i, l_i = run_path(torch, kernels, "getri",
                              lambda: st.getri(lu_s, perm_s))

    for name, t in (("scattered factor", lu_s.data), ("x", x_s),
                    ("rec factor", lu_r.data), ("rec x", x_r),
                    ("inverse", inv.data)):
        if not bool(torch.isfinite(t).all()):
            fail("%s has non-finite values" % name)
    ad = a.double()
    res = {}
    for tag, x in (("gesv_scattered", x_s), ("gesv_rec", x_r)):
        xd = x.double()
        res[tag + "_residual"] = float((ad @ xd - b.double()).norm()
                                       / (ad.norm() * xd.norm() * eps * N))
    invd = inv.data.double()
    cond1 = float(torch.linalg.matrix_norm(ad, 1)
                  * torch.linalg.matrix_norm(invd, 1))
    res["getri_residual"] = float(
        (invd @ ad - torch.eye(N, device=dev, dtype=torch.float64)).norm()
        / (eps * N * cond1))
    lmax = max(float(torch.tril(lu_s.data, -1).abs().max()),
               float(torch.tril(lu_r.data, -1).abs().max()))
    res.update(L_max=lmax, pivots_differing=int((perm_s != perm_r).sum()),
               gesv_scattered_ms=ms_s, gesv_rec_ms=ms_r, getri_ms=ms_i,
               launches={"lu_scattered": l_s, "lu_rec": l_r, "getri": l_i})
    print("LU path n=%d nb=%d nrhs=%d: gesv scattered %.1f ms (residual "
          "%.3g; launches %s), gesv rec %.1f ms (residual %.3g; launches "
          "%s), getri %.1f ms (residual %.3g; launches %s); max |L| %.7f; "
          "%d of %d pivots differ between the drivers"
          % (N, NB, NRHS, ms_s, res["gesv_scattered_residual"], l_s, ms_r,
             res["gesv_rec_residual"], l_r, ms_i, res["getri_residual"], l_i,
             lmax, res["pivots_differing"], N), flush=True)
    d = first_pivot_difference(torch, lu_s.data, perm_s, lu_r.data, perm_r)
    if d is not None:
        print("first pivot difference: column %d, rows %d (scattered) and %d "
              "(rec); in the scattered factor |pivot| %.9g vs the rec row "
              "%.9g; in the rec factor |pivot| %.9g vs the scattered row %.9g"
              % (d["column"], d["rows"][0], d["rows"][1], *d["scattered"],
                 *d["rec"]), flush=True)
    for label, on in (("scattered", True), ("rec", False)):
        config.scattered_lu = on
        try:
            lu_split(torch, st, A, b, label)
        finally:
            config.scattered_lu = saved
    print("context: torch.linalg.solve on the same A and B %.1f ms"
          % cuda_ms(torch, lambda: torch.linalg.solve(a, b), 3), flush=True)
    for name in ("gesv_scattered", "gesv_rec", "getri"):
        if not res[name + "_residual"] <= 3:
            fail("%s residual %.3f > 3" % (name, res[name + "_residual"]))
    if not lmax <= 1 + 100 * eps:
        fail("|L| = %.7f > 1 + 100 eps: not partial pivoting" % lmax)
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    try:
        import slate_tpu_torch as st
        from slate_tpu_torch.ops import _build, kernels
    except ImportError as e:
        print("chip_smoke: the slate_tpu_torch package is missing (%s)" % e,
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print("torch %s, CUDA %s, python %s" % (torch.__version__,
                                            torch.version.cuda,
                                            sys.version.split()[0]), flush=True)
    t0 = time.perf_counter()
    built = _build.build_all()
    print("build: %.1f s (%s)" % (time.perf_counter() - t0, ", ".join(
        "%s %.1f s" % kv for kv in built.items()) or "all cached"), flush=True)
    for name in _build.SOURCES:
        log = _build.lib_path(name).with_name(
            _build.lib_path(name).name + ".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print("ptxas %s: %s" % (name, line.strip()), flush=True)

    measured = check_kernels(torch, kernels, dev)
    measured.update(check_lu_kernels(torch, kernels, dev))
    paths = {"cholesky": main_path(torch, st, kernels, dev)["launches"]}
    paths.update(main_path_lu(torch, st, kernels, dev)["launches"])

    rows = []
    for name, r in measured.items():
        src, replaces = REPO[name]
        # launches on the main paths that run this kernel (matmul: all)
        n_launch = sum(paths[p][name] for p, ks in PATHS.items() if name in ks)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": n_launch,
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
