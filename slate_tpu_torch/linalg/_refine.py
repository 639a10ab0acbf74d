"""Shared mixed-precision refinement cores — the counterpart of
``slate_tpu/linalg/_refine.py`` (reference ``src/gesv_mixed.cc``,
``posv_mixed.cc``, ``gesv_mixed_gmres.cc``, ``posv_mixed_gmres.cc``).

The two refinement loops are written once over callables:

* ``solve_lo(r)`` — apply the low-precision factor to a residual block
  (working precision in, working precision out);
* ``solve_full(b)`` — factor in working precision and solve (the
  fallback, ``Option.UseFallbackSolver``);
* the residual product, :func:`slate_tpu_torch.ops.blocks.matmul_hi`
  (``torch.matmul``, full precision with TF32 off).

Stopping criterion (both loops, reference ``gesv_mixed.cc``):
‖r‖∞ ≤ ‖x‖∞ · ‖A‖∞ · ε · √n.  Where the JAX package wraps a closure in
``jax.jit`` the port calls it plainly.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch

from ..ops.blocks import matmul_hi


def _absmax(v) -> float:
    return float(v.abs().max())


def ir_refine_core(b, solve_lo, solve_full, residual, *, anorm, thresh,
                   itermax, use_fallback, add=lambda x, d: x + d,
                   absmax=_absmax):
    """Classic iterative refinement over opaque solution objects.
    Returns ``(x, iters)``; negative ``iters`` flags the full-precision
    fallback (reference convention)."""
    x = solve_lo(b)
    iters = 0
    converged = False
    for it in range(itermax):
        r = residual(x)
        rnorm = absmax(r)
        xnorm = absmax(x)
        if rnorm <= xnorm * float(anorm) * thresh:
            converged = True
            iters = it
            break
        x = add(x, solve_lo(r))
        iters = it + 1
    if not converged:
        rnorm = absmax(residual(x))
        xnorm = absmax(x)
        converged = rnorm <= xnorm * float(anorm) * thresh
    if not converged and use_fallback:
        x = solve_full(b)
        iters = -(iters + 1)
    return x, iters


def ir_refine(av, bv, solve_lo, solve_full, *, anorm, thresh, itermax,
              use_fallback):
    """Dense front end of :func:`ir_refine_core` (1-D right-hand sides,
    the full-precision residual product)."""
    squeeze = bv.ndim == 1
    if squeeze:
        bv = bv[:, None]
    x, iters = ir_refine_core(bv, solve_lo, solve_full,
                              lambda x: bv - matmul_hi(av, x),
                              anorm=anorm, thresh=thresh, itermax=itermax,
                              use_fallback=use_fallback)
    if squeeze:
        x = x[:, 0]
    return x, iters


def _scalar(v, is_complex: bool):
    """A host scalar of ``v`` (a numpy or 0-dim torch value): complex for
    complex systems, else the real part as a float."""
    v = complex(v)
    return v if is_complex else v.real


def fgmres_refine(av, bv, precond, solve_full, *, anorm, thresh, itermax,
                  restart, use_fallback, matvec=None):
    """FGMRES-IR: flexible GMRES in working precision, left-preconditioned
    by the low-precision solve, one GMRES sequence per right-hand-side
    column (the reference iterates nrhs = 1).  Returns ``(x, iters)``.
    The (restart+1)×restart Hessenberg least squares is solved on the
    host, as in the JAX package."""
    squeeze = bv.ndim == 1
    if squeeze:
        bv = bv[:, None]
    if matvec is None:
        def matvec(v):
            return matmul_hi(av, v[:, None])[:, 0]

    cplx = bv.is_complex()
    hdt = torch.empty(0, dtype=bv.dtype).numpy().dtype
    cols = []
    total_iters = 0
    any_fallback = False
    full_solution = None          # fallback solve, shared by all columns
    for j in range(bv.shape[1]):
        bj = bv[:, j]
        x = precond(bj[:, None])[:, 0]
        col_iters = 0
        converged = False
        # FGMRES(restart) cycles, bounded by the itermax option
        while col_iters < itermax:
            r = bj - matvec(x)
            rnorm = float(torch.linalg.vector_norm(r))
            xnorm = _absmax(x)
            if rnorm <= max(xnorm, 1.0) * float(anorm) * thresh:
                converged = True
                break
            V = [r / rnorm]
            Z = []
            H = np.zeros((restart + 1, restart), dtype=hdt)
            k_used = 0
            for k in range(restart):
                z = precond(V[k][:, None])[:, 0]
                Z.append(z)
                w = matvec(z)
                for i in range(k + 1):
                    H[i, k] = _scalar(torch.vdot(V[i], w), cplx)
                    w = w - _scalar(H[i, k], cplx) * V[i]
                hk1 = float(torch.linalg.vector_norm(w))
                H[k + 1, k] = hk1
                total_iters += 1
                col_iters += 1
                k_used = k + 1
                if hk1 == 0.0:       # happy breakdown
                    break
                V.append(w / hk1)
                # running LSQ residual of min‖β·e₁ − H·y‖ for early exit
                g = np.zeros(k + 2, H.dtype)
                g[0] = rnorm
                _, res, *_ = np.linalg.lstsq(H[:k + 2, :k + 1], g,
                                             rcond=None)
                lsq_res = np.sqrt(float(res[0])) if res.size else 0.0
                if lsq_res <= max(xnorm, 1.0) * float(anorm) * thresh:
                    break
            if k_used:
                g = np.zeros(k_used + 1, H.dtype)
                g[0] = rnorm
                yk, *_ = np.linalg.lstsq(H[:k_used + 1, :k_used], g,
                                         rcond=None)
                for i in range(k_used):
                    x = x + _scalar(yk[i], cplx) * Z[i]
        if not converged:
            r = bj - matvec(x)
            rnorm = float(torch.linalg.vector_norm(r))
            xnorm = _absmax(x)
            converged = rnorm <= max(xnorm, 1.0) * float(anorm) * thresh
        if not converged and use_fallback:
            # full-precision fallback, factored once and reused across
            # right-hand-side columns
            if full_solution is None:
                full_solution = solve_full(bv)
            x = full_solution[:, j]
            any_fallback = True
        cols.append(x)
    x = torch.stack(cols, dim=1)
    if squeeze:
        x = x[:, 0]
    iters = -(total_iters + 1) if any_fallback else total_iters
    return x, iters


def lo_dtype(dtype):
    """The low-precision leg's dtype: fp64 → fp32, complex128 → complex64,
    any other dtype itself (the reference pairs fp64 with fp32; a raw
    fp32 → bf16 demotion is not accurate enough for IR's contraction)."""
    if dtype == torch.float64:
        return torch.float32
    if dtype == torch.complex128:
        return torch.complex64
    return dtype


def use_split_leg(dtype, device=None) -> bool:
    """Should a mixed driver factor its low leg of ``dtype`` on
    ``device`` under :func:`split_factor_leg`
    (``slate_tpu/linalg/_refine.py:191-232``)?  Real fp32 only:
    ``SLATE_TPU_TORCH_SPLIT_GEMM=1`` answers True, ``0`` False, and
    ``auto`` True on a CUDA device and False on the CPU, as the JAX
    package's ``auto`` answers True on its TPU only.  False wherever the
    kernels are switched off (``SLATE_TPU_TORCH_USE_KERNELS=0``): the leg
    is the ``split_matmul`` kernel's."""
    from .. import config

    if dtype != torch.float32 or config.use_kernels_mode() == "off":
        return False
    mode = config.split_gemm_mode()
    if mode != "auto":
        return mode == "on"
    return device is not None and torch.device(device).type == "cuda"


@contextmanager
def split_factor_leg():
    """Force the bf16x3 split backend at the ``matmul`` site for the scope
    of a mixed driver's low-precision factor, in this thread only: every
    fp32 product inside resolves to ``split3`` (any shape), and the
    forced resolutions stay out of the census
    (:func:`~slate_tpu_torch.perf.autotune.split_leg`).  No module global
    changes, so another thread's products and a concurrent
    :func:`~slate_tpu_torch.resilience.health.safe_backend` are left as
    they are."""
    from ..perf import autotune

    with autotune.split_leg():
        yield


#: past this κ·n·ε₃₂ (κ² for the semi-normal equations) a split factor
#: cannot seed a contracting refinement: the leg is demoted to the stock
#: fp32 factor (the JAX package's gate)
SPLIT_DEMOTE = 0.25


def note_split_leg(driver: str, kappa_eps: float) -> bool:
    """Record a split leg's κ·ε probe and say whether it demotes the leg
    (``kappa_eps > 0.25``).  With metrics on: the gauge
    ``mixed.<driver>.kappa_eps`` and the counters
    ``mixed.<driver>.split_leg`` and ``mixed.<driver>.split_demoted``."""
    from ..perf import metrics

    demoted = not kappa_eps <= SPLIT_DEMOTE
    metrics.set_gauge("mixed.%s.kappa_eps" % driver, kappa_eps)
    metrics.inc("mixed.%s.split_leg" % driver)
    if demoted:
        metrics.inc("mixed.%s.split_demoted" % driver)
    return demoted
