"""BLAS-3 drivers — the counterpart of ``slate_tpu/linalg/blas3.py:35-208``
(reference ``src/gemm.cc``, ``herk.cc``/``syrk.cc``, ``trmm.cc``,
``trsm.cc``).  ``C = α·op(A)·op(B) + β·C`` and friends, with matrices
carrying their op/uplo/diag; functions return the result rather than
writing in place.

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
