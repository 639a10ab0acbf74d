"""BLAS-3 drivers — the counterpart of ``slate_tpu/linalg/blas3.py``
(reference ``src/gemm.cc``, ``symm.cc``/``hemm.cc``, ``herk.cc``/
``syrk.cc``, ``her2k.cc``/``syr2k.cc``, ``trmm.cc``, ``trsm.cc``).
``C = α·op(A)·op(B) + β·C`` and friends, with matrices carrying their
op/uplo/diag; functions return the result rather than writing in place.
Every product goes through :func:`slate_tpu_torch.ops.blocks.matmul`
(the ``matmul`` site).

The reference's data-placement variants (gemmA/gemmC, hemmA/hemmC,
trsmA/trsmB, ``method.hh:25-126``) differ only in which operand stays
where; on one card they share one computation, and the names are kept
so reference call sites port unchanged.

Placement: operands go to the ``device=`` the caller names, else to the
device of the first Matrix-family operand, else to ``cuda``
(:func:`slate_tpu_torch.config.resolve_device`).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import config
from ..enums import Diag, Op, Side, Uplo
from ..matrix import BaseMatrix, BaseTrapezoidMatrix, as_array
from ..ops import blocks
from ..ops.blocks import matmul
from ..options import Options, get_option
from ..perf.metrics import instrument_driver


def _device_of(*xs, device=None) -> torch.device:
    """Where a driver runs: ``device`` if given, else the device of the
    first Matrix-family operand, else ``cuda`` (raising without a card)."""
    if device is not None:
        return config.resolve_device(device)
    for x in xs:
        if isinstance(x, BaseMatrix):
            return x.device
    return config.resolve_device(None)


def _arr(x, device=None):
    """The logical tensor of ``x`` on ``device``."""
    t = as_array(x, device)
    return t if device is None or t.device == device else t.to(device)


def _uplo_of(a, default=Uplo.Lower):
    if isinstance(a, BaseTrapezoidMatrix):
        return a.logical_uplo
    return default


def _diag_of(a, default=Diag.NonUnit):
    return getattr(a, "diag", default)


def _wrap_like(template, data):
    if isinstance(template, BaseMatrix):
        out = template._like(data)
        out.op = Op.NoTrans
        return out
    return data


def _nb(a, opts):
    """Blocking size: per-call option → matrix nb → SLATE_TPU_TORCH_NB."""
    nb = get_option(opts, "block_size", None)
    if nb is None:
        nb = getattr(a, "nb", None) or config.default_block_size
    return int(nb)


@instrument_driver("gemm")
def gemm(alpha, a, b, beta, c, opts: Optional[Options] = None, *, device=None):
    """C ← α·op(A)·op(B) + β·C (reference ``slate::gemm``)."""
    dev = _device_of(a, b, c, device=device)
    av, bv, cv = _arr(a, dev), _arr(b, dev), _arr(c, dev)
    return _wrap_like(c, alpha * matmul(av, bv) + beta * cv)


def symm(side: Side, alpha, a, b, beta, c, opts: Optional[Options] = None,
         *, device=None):
    """C ← α·A·B + β·C (Left) or α·B·A + β·C (Right), A symmetric with
    its stored triangle (reference ``src/symm.cc``)."""
    return _symm_hemm(side, alpha, a, b, beta, c, False, device)


def hemm(side: Side, alpha, a, b, beta, c, opts: Optional[Options] = None,
         *, device=None):
    """The Hermitian form of :func:`symm` (reference ``src/hemm.cc``)."""
    return _symm_hemm(side, alpha, a, b, beta, c, True, device)


def _symm_hemm(side, alpha, a, b, beta, c, conj, device):
    from ..ops.tile_ops import hermitize, symmetrize

    dev = _device_of(a, b, c, device=device)
    # logical_uplo pairs with the op-applied array: after a transpose
    # view the stored triangle of .array sits in the flipped position
    uplo = _uplo_of(a)
    raw = a.array if isinstance(a, BaseMatrix) else _arr(a, dev)
    raw = raw if raw.device == dev else raw.to(dev)
    full = hermitize(uplo, raw) if conj else symmetrize(uplo, raw)
    bv, cv = _arr(b, dev), _arr(c, dev)
    if side is Side.Left:
        out = alpha * matmul(full, bv) + beta * cv
    else:
        out = alpha * matmul(bv, full) + beta * cv
    return _wrap_like(c, out)


def _rank_k(alpha, a, beta, c, conj, device):
    if isinstance(c, BaseMatrix) and c.op is not Op.NoTrans:
        from ..exceptions import SlateError
        raise SlateError("C of a rank-k update must be a NoTrans view")
    dev = _device_of(c, a, device=device)
    uplo = _uplo_of(c)
    av = _arr(a, dev)
    cv = c.data if isinstance(c, BaseMatrix) else _arr(c, dev)
    nb = getattr(c, "nb", None) or config.default_block_size
    new = blocks.herk_rec(uplo, alpha, av, beta, cv, int(nb), conj=conj)
    # only the stored triangle is defined; keep the other triangle as is
    keep = torch.ones_like(cv, dtype=torch.bool)
    keep = keep.tril() if uplo is Uplo.Lower else keep.triu()
    return _wrap_like(c, torch.where(keep, new, cv))


def syrk(alpha, a, beta, c, opts: Optional[Options] = None, *, device=None):
    """C ← α·op(A)·op(A)ᵀ + β·C on C's triangle (reference ``src/syrk.cc``)."""
    return _rank_k(alpha, a, beta, c, False, device)


def herk(alpha, a, beta, c, opts: Optional[Options] = None, *, device=None):
    """C ← α·op(A)·op(A)ᴴ + β·C, α and β real (reference ``src/herk.cc``)."""
    return _rank_k(alpha, a, beta, c, True, device)


def _rank_2k(alpha, a, b, beta, c, conj, device):
    if isinstance(c, BaseMatrix) and c.op is not Op.NoTrans:
        from ..exceptions import SlateError
        raise SlateError("C of a rank-2k update must be a NoTrans view")
    dev = _device_of(c, a, b, device=device)
    uplo = _uplo_of(c)
    av, bv = _arr(a, dev), _arr(b, dev)
    cv = c.data if isinstance(c, BaseMatrix) else _arr(c, dev)
    nb = getattr(c, "nb", None) or config.default_block_size
    if conj:
        beta = beta.real if isinstance(beta, torch.Tensor) \
            else complex(beta).real
    new = blocks.her2k_rec(uplo, alpha, av, bv, beta, cv, int(nb), conj=conj)
    # only the stored triangle is defined; keep the other triangle as is
    keep = torch.ones_like(cv, dtype=torch.bool)
    keep = keep.tril() if uplo is Uplo.Lower else keep.triu()
    return _wrap_like(c, torch.where(keep, new, cv))


def syr2k(alpha, a, b, beta, c, opts: Optional[Options] = None, *,
          device=None):
    """C ← α·A·Bᵀ + α·B·Aᵀ + β·C on C's triangle (reference
    ``src/syr2k.cc``)."""
    return _rank_2k(alpha, a, b, beta, c, False, device)


def her2k(alpha, a, b, beta, c, opts: Optional[Options] = None, *,
          device=None):
    """C ← α·A·Bᴴ + ᾱ·B·Aᴴ + β·C on C's triangle, β real (reference
    ``src/her2k.cc``)."""
    return _rank_2k(alpha, a, b, beta, c, True, device)


def trmm(side: Side, alpha, a, b, opts: Optional[Options] = None, *,
         device=None):
    """B ← α·op(A)·B or α·B·op(A), A triangular (reference ``src/trmm.cc``)."""
    dev = _device_of(a, b, device=device)
    uplo, diag = _uplo_of(a), _diag_of(a)
    av, bv = _arr(a, dev), _arr(b, dev)
    out = alpha * blocks.trmm_rec(side, uplo, diag, av, bv, _nb(a, opts))
    return _wrap_like(b, out)


@instrument_driver("trsm")
def trsm(side: Side, alpha, a, b, opts: Optional[Options] = None, *,
         device=None):
    """Solve op(A)·X = α·B or X·op(A) = α·B (reference ``src/trsm.cc``)."""
    dev = _device_of(a, b, device=device)
    uplo, diag = _uplo_of(a), _diag_of(a)
    av, bv = _arr(a, dev), _arr(b, dev)
    out = blocks.trsm_rec(side, uplo, diag, av, alpha * bv, _nb(a, opts))
    return _wrap_like(b, out)


def gemmA(alpha, a, b, beta, c, opts: Optional[Options] = None, *,
          device=None):
    """gemm, the A-stationary variant (reference ``src/gemmA.cc``)."""
    return gemm(alpha, a, b, beta, c, opts, device=device)


def gemmC(alpha, a, b, beta, c, opts: Optional[Options] = None, *,
          device=None):
    """gemm, the C-stationary variant (reference ``src/gemmC.cc``)."""
    return gemm(alpha, a, b, beta, c, opts, device=device)


def hemmA(side: Side, alpha, a, b, beta, c, opts: Optional[Options] = None,
          *, device=None):
    """hemm, the A-stationary variant (reference ``src/hemmA.cc``)."""
    return hemm(side, alpha, a, b, beta, c, opts, device=device)


def hemmC(side: Side, alpha, a, b, beta, c, opts: Optional[Options] = None,
          *, device=None):
    """hemm, the C-stationary variant (reference ``slate::hemmC``)."""
    return hemm(side, alpha, a, b, beta, c, opts, device=device)


def trsmA(side: Side, alpha, a, b, opts: Optional[Options] = None, *,
          device=None):
    """trsm, the A-stationary variant (reference ``src/trsmA.cc``)."""
    return trsm(side, alpha, a, b, opts, device=device)


def trsmB(side: Side, alpha, a, b, opts: Optional[Options] = None, *,
          device=None):
    """trsm, the B-stationary variant, the default (reference
    ``src/trsm.cc``)."""
    return trsm(side, alpha, a, b, opts, device=device)
