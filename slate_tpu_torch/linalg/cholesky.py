"""Cholesky family: potrf / potrs / posv / potri (+ trtri, trtrm) — the
counterpart of ``slate_tpu/linalg/cholesky.py:31-247`` (reference
``src/potrf.cc``, ``potrs.cc``, ``posv.cc``, ``potri.cc``, ``trtri.cc``,
``trtrm.cc``).

The fp32 factorization runs at one of three depths, as the
``potrf_step`` site decides: the strip driver over the ``chol_inv_panel``
kernel (``panels``, the default), one ``potrf_step_fused`` launch per
step (``fused``) or one ``potrf_full_fused`` launch (``full``).
Real fp64 takes the ``ozaki`` branch where the ``potrf_panel_f64`` site
answers ``ozaki_newton`` (``SLATE_TPU_TORCH_F64_MXU=1`` or its pin): the
strip driver over fp64 Newton panels seeded by the ``chol_inv_panel``
kernel (:func:`slate_tpu_torch.ops.blocks.potrf_panels_f64`), rerun with
``torch.linalg.cholesky`` where that factor is not finite.
``posv_mixed``/``posv_mixed_gmres`` factor in fp32 through
``blocks.potrf_rec`` — under the split-precision products where
:func:`~slate_tpu_torch.linalg._refine.use_split_leg` says so, with the
JAX package's κ·ε demotion — and refine in the working precision
(:mod:`slate_tpu_torch.linalg._refine`).
With ``SLATE_TPU_TORCH_ABFT`` on, potrf runs under the ABFT layer
(:mod:`slate_tpu_torch.resilience.abft`): the ``stock`` branch as the
checksum-carried step loop, every other branch inside the checksum
envelope; off, that is one environment read.  Under ``auto`` the ``ooc``
site is asked first: where it answers ``"pool"`` the factor is computed
out of core (``ooc``, :func:`slate_tpu_torch.linalg.ooc.potrf_ooc`: the
matrix in a host tile grid, a bounded window of tiles on the card),
outside the ABFT layer, as in the JAX package (its resilience is the
pool's window-boundary checkpoints).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..enums import Diag, Norm, Side, Uplo
from ..exceptions import SlateError
from ..matrix import BaseMatrix, BaseTrapezoidMatrix, HermitianMatrix, \
    TriangularMatrix
from ..method import select_backend
from ..ops import blocks, smem
from ..ops.tile_ops import hermitize
from ..options import Options, get_option
from ..perf.metrics import instrument_driver
from .blas3 import _arr, _device_of, _diag_of, _nb, _uplo_of, _wrap_like


def _hermitian_full(a, device):
    """The full Hermitian tensor of ``a``'s stored triangle (a raw array
    is taken as already full)."""
    if isinstance(a, BaseTrapezoidMatrix):
        return hermitize(a.logical_uplo, a.array)
    return _arr(a, device)


@instrument_driver("potrf")
def potrf(a, opts: Optional[Options] = None, *, device=None):
    """Cholesky factorization A = L·Lᴴ (or UᴴU).  Returns a
    TriangularMatrix holding the factor in ``a``'s uplo, other triangle
    zero."""
    dev = _device_of(a, device=device)
    uplo = _uplo_of(a)
    nb = _nb(a, opts)
    full = _hermitian_full(a, dev)
    if full.shape[-1] != full.shape[-2]:
        raise SlateError(f"potrf requires a square matrix, got {tuple(full.shape)}")
    method = get_option(opts, "method_factor", "auto")
    nbsel = 512 if nb <= 256 else nb
    branch = _potrf_branch(full, nb, nbsel, method)
    from ..resilience import abft as _abft

    if branch == "ooc":
        # the pool's own resilience is its window-boundary checkpoints:
        # the ABFT checksum loop does not wrap it
        l = _potrf_dispatch(branch, full, nb, nbsel)
    elif _abft.eligible(full):
        # the stock branch runs the checksum-carried loop at the caller's
        # nb (finer steps, finer verify and recompute); the kernel-owned
        # branches run at nbsel inside the checksum envelope
        l = _abft.potrf_guarded(
            full, nb, branch,
            lambda: _potrf_dispatch(branch, full, nb, nbsel))
    else:
        l = _potrf_dispatch(branch, full, nb, nbsel)
    fac = l if uplo is Uplo.Lower else l.mH.resolve_conj().contiguous()
    return TriangularMatrix(fac, uplo=uplo, diag=Diag.NonUnit,
                            mb=getattr(a, "mb", nb), nb=nb,
                            grid=getattr(a, "grid", None), device=fac.device)


def _potrf_branch(full, nb: int, nbsel: int, method) -> str:
    """Which potrf branch runs: ``"ooc"`` (the out-of-core driver, where
    the ``ooc`` site answers ``"pool"``; asked first), ``"full"`` /
    ``"fused"`` (the whole
    factorization, or each whole step, one kernel launch), ``"panels"``
    (the strip driver over the ``chol_inv_panel`` kernel, fp32),
    ``"ozaki"`` (real fp64 where the ``potrf_panel_f64`` site answers
    ``ozaki_newton``: the Newton panels), ``"recursive"`` (an explicit
    ``method_factor``: the nb recursion) or ``"stock"``
    (``torch.linalg.cholesky``: fp64 by default, complex, or kernels
    switched off).  The ``potrf_step`` site is consulted first, with the
    shape gates of the fused kernels, as in the JAX package."""
    if method != "auto":
        return "recursive"
    from . import ooc as _ooc

    if _ooc.choose(full) == "pool":
        return "ooc"
    n = int(full.shape[-1])
    if full.ndim == 2 and full.dtype.is_floating_point:
        depth = select_backend(
            "potrf_step", n=n, nb=nbsel, dtype=full.dtype,
            device=full.device,
            eligible=smem.potrf_fused_fits(n, nbsel, full.dtype))
        if depth in ("full", "fused"):
            return depth
    if full.ndim == 2 and select_backend(
            "potrf_panel", n=n, nb=nbsel, dtype=full.dtype,
            device=full.device) in ("kernel", "plain"):
        return "panels"
    if full.ndim == 2 and full.dtype == torch.float64 and select_backend(
            "potrf_panel_f64", n=n, nb=nbsel,
            device=full.device) == "ozaki_newton":
        return "ozaki"
    return "stock"


def _potrf_dispatch(branch: str, full, nb: int, nbsel: int):
    """Run one resolved potrf branch (see :func:`_potrf_branch`)."""
    if branch == "full":
        return blocks.potrf_full(full, nbsel)
    if branch == "fused":
        return blocks.potrf_steps(full, nbsel)
    if branch == "panels":
        return blocks.potrf_panels(full, nbsel)
    if branch == "ozaki":
        # a panel whose fp32 seed breaks down (SPD but cond ≳ 1/ε₃₂) makes
        # the factor NaN: rerun those inputs stock, as the JAX package's
        # lax.cond does (a host read of one flag here); each rerun counted
        from ..perf import metrics

        fast = blocks.potrf_panels_f64(full, nbsel)
        if bool(torch.isfinite(fast).all()):
            return fast
        metrics.inc("potrf.f64_rerun")
        return torch.linalg.cholesky(full)
    if branch == "ooc":
        from . import ooc as _ooc

        return _ooc.potrf_ooc(full)
    if branch == "recursive":
        return blocks.potrf_rec(full, nb)
    return torch.linalg.cholesky(full)


@instrument_driver("potrs")
def potrs(a_factor, b, opts: Optional[Options] = None, *, device=None):
    """Solve A·X = B from the Cholesky factor: two triangular solves."""
    dev = _device_of(a_factor, b, device=device)
    uplo = _uplo_of(a_factor)
    av = _arr(a_factor, dev)
    bv = _arr(b, dev)
    nb = _nb(a_factor, opts)
    if uplo is Uplo.Lower:
        # L y = b ; L^H x = y
        y = blocks.trsm_rec(Side.Left, Uplo.Lower, Diag.NonUnit, av, bv, nb)
        x = blocks.trsm_rec(Side.Left, Uplo.Upper, Diag.NonUnit, av.mH, y, nb)
    else:
        y = blocks.trsm_rec(Side.Left, Uplo.Lower, Diag.NonUnit, av.mH, bv, nb)
        x = blocks.trsm_rec(Side.Left, Uplo.Upper, Diag.NonUnit, av, y, nb)
    return _wrap_like(b, x)


@instrument_driver("posv")
def posv(a, b, opts: Optional[Options] = None, *, device=None):
    """Factor + solve (reference ``slate::posv``).  Returns ``(factor, x)``."""
    fac = potrf(a, opts, device=device)
    x = potrs(fac, b, opts)
    return fac, x


@instrument_driver("trtri")
def trtri(a, opts: Optional[Options] = None, hi: bool = False, *,
          device=None):
    """Triangular inverse.  ``hi`` routes the assembly products through
    ``blocks.matmul_hi`` (potri)."""
    dev = _device_of(a, device=device)
    uplo = _uplo_of(a)
    inv = blocks.trtri_rec(uplo, _diag_of(a), _arr(a, dev), _nb(a, opts), hi=hi)
    inv = torch.tril(inv) if uplo is Uplo.Lower else torch.triu(inv)
    return _wrap_like(a, inv)


@instrument_driver("trtrm")
def trtrm(a, opts: Optional[Options] = None, hi: bool = False, *,
          device=None):
    """Triangular × triangular product Lᴴ·L / U·Uᴴ (LAPACK ``lauum``)."""
    dev = _device_of(a, device=device)
    av = _arr(a, dev)
    out = blocks.lauum_rec(_uplo_of(a), av, _nb(a, opts),
                           conj=av.is_complex(), hi=hi)
    return _wrap_like(a, out)


@instrument_driver("potri")
def potri(a_factor, opts: Optional[Options] = None, *, device=None):
    """Inverse of a Hermitian positive-definite matrix from its Cholesky
    factor: ``trtri`` then ``trtrm`` (A⁻¹ = L⁻ᴴ·L⁻¹), both with
    full-precision products as in the JAX package.  Returns a
    HermitianMatrix (stored triangle valid)."""
    uplo = _uplo_of(a_factor)
    inv_t = trtri(a_factor, opts, hi=True, device=device)
    prod = trtrm(inv_t, opts, hi=True, device=device)
    data = prod.data if isinstance(prod, BaseMatrix) else prod
    return HermitianMatrix(data, uplo=uplo,
                           mb=getattr(a_factor, "mb", 256),
                           nb=getattr(a_factor, "nb", 256),
                           grid=getattr(a_factor, "grid", None),
                           device=data.device)


# ---------------------------------------------------------------------------
# Mixed precision + iterative refinement (posv_mixed / posv_mixed_gmres)
# ---------------------------------------------------------------------------

def _chol_solve(lv, bv, nb):
    """Two triangular sweeps from the lower factor (src/potrs.cc shape)."""
    y = blocks.trsm_rec(Side.Left, Uplo.Lower, Diag.NonUnit, lv, bv, nb)
    return blocks.trsm_rec(Side.Left, Uplo.Upper, Diag.NonUnit, lv.mH, y, nb)


def _posv_mixed_setup(a, b, opts, tol, device=None):
    """The low-precision Cholesky leg and the refinement closures.  The
    leg is ``blocks.potrf_rec`` in fp32 (its products through the
    ``matmul`` site); a leaf that is not positive definite in fp32 comes
    back NaN, as the JAX package's does, so the loop never converges and
    the fallback factors in full precision.  Where
    :func:`~._refine.use_split_leg` says so the leg factors once under
    :func:`~._refine.split_factor_leg` (every product a bf16x3 split),
    and a κ·n·ε₃₂ probe past 0.25 demotes it to the stock fp32 factor
    (``slate_tpu/linalg/cholesky.py:268-295``)."""
    import math

    from .norms import norm as _norm
    from ._refine import lo_dtype, note_split_leg, split_factor_leg, \
        use_split_leg

    dev = _device_of(a, b, device=device)
    full = _hermitian_full(a, dev)
    bv = _arr(b, dev)
    n = full.shape[-1]
    nb = _nb(a, opts)
    itermax = int(get_option(opts, "max_iterations", 30))
    use_fallback = bool(get_option(opts, "use_fallback_solver", True))
    eps = torch.finfo(full.dtype).eps
    anorm = _norm(Norm.Inf, full, device=dev)
    thresh = float(tol) if tol is not None else float(eps) * math.sqrt(n)

    lo = lo_dtype(full.dtype)
    a_lo = full.to(lo)
    if use_split_leg(lo, dev):
        from .condest import refine_kappa_eps

        with split_factor_leg():
            l_lo = blocks.potrf_rec(a_lo, nb, nan_on_fail=True)

        def _solve(v):
            return _chol_solve(l_lo, v.to(l_lo.device), nb)

        ke = refine_kappa_eps(_solve, _solve, n, anorm, lo)
        if note_split_leg("posv_mixed", ke):
            l_lo = blocks.potrf_rec(a_lo, nb, nan_on_fail=True)
    else:
        l_lo = blocks.potrf_rec(a_lo, nb, nan_on_fail=True)

    def solve_lo(r):
        return _chol_solve(l_lo, r.to(lo), nb).to(full.dtype)

    def solve_full(bv2):
        # full-precision fallback (reference posv_mixed.cc); the refine
        # cores always pass a 2-D block
        return _chol_solve(blocks.potrf_rec(full, nb), bv2, nb)

    return full, bv, nb, dict(anorm=anorm, thresh=thresh, itermax=itermax,
                              use_fallback=use_fallback), solve_lo, solve_full


def posv_mixed(a, b, opts: Optional[Options] = None, *, tol=None,
               device=None):
    """Mixed-precision Cholesky solve with iterative refinement —
    reference ``slate::posv_mixed``: factor the HPD matrix in low
    precision, refine the residual in working precision, full-precision
    fallback on stagnation.  Returns ``(x, iters)``; ``iters < 0`` flags
    the fallback."""
    from ._refine import ir_refine

    full, bv, nb, kw, solve_lo, solve_full = _posv_mixed_setup(
        a, b, opts, tol, device)
    x, iters = ir_refine(full, bv, solve_lo, solve_full, **kw)
    return _wrap_like(b, x), iters


def posv_mixed_gmres(a, b, opts: Optional[Options] = None, *, tol=None,
                     restart: int = 30, device=None):
    """FGMRES-IR over a low-precision Cholesky preconditioner — reference
    ``slate::posv_mixed_gmres``.  Returns ``(x, iters)``."""
    from ._refine import fgmres_refine

    full, bv, nb, kw, solve_lo, solve_full = _posv_mixed_setup(
        a, b, opts, tol, device)
    x, iters = fgmres_refine(full, bv, solve_lo, solve_full, restart=restart,
                             **kw)
    return _wrap_like(b, x), iters


#: Deprecated camel-case alias kept by the reference (slate.hh).
posvMixed = posv_mixed
