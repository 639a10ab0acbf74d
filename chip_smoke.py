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
3. Drives the main path through the public entry points: ``posv`` of an
   n = 8192 fp32 HermitianMatrix (nb = 256, so 512-wide panels) with 128
   right-hand sides, ``potri`` of its factor and ``gemm`` at 8192, with
   the reference tester's scaled-residual gates (≤ 3).  Every kernel's
   launch count is set to 0 just before and read just after; a kernel of
   the path that was not launched fails the run.
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
                        "slate_tpu/ops/pallas_kernels.py:571")}


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
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        fail("the main path launched no %s kernel" % ", ".join(missing))
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
    res = main_path(torch, st, kernels, dev)

    rows = []
    for name, r in measured.items():
        src, replaces = REPO[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": res["launches"][name],
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
