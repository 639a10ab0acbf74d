"""Band-matrix routines: gbmm, hbmm, tbsm, gbtrf/gbtrs/gbsv and
pbtrf/pbtrs/pbsv — the counterpart of ``slate_tpu/linalg/band.py``
(reference ``src/gbmm.cc``, ``hbmm.cc``, ``tbsm.cc``, ``gbtrf.cc`` …
``pbsv.cc``).

Bands are stored dense with implicit zeros (``BaseBandMatrix``), as in
the JAX package: a band product is one masked product; the band Cholesky
is band-aware, each block column touching only the kd-row window below
it (O(n·kd²) work), on one private copy updated in place; the pivoted
band LU is the dense ``getrf`` of the masked band (the factor's upper
bandwidth grows to kl + ku, as in LAPACK ``gbtrf``), so on the card it
runs the ``getrf`` driver's kernels.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..enums import Diag, Op, Side, Uplo
from ..exceptions import SlateError
from ..matrix import (BandMatrix, BaseBandMatrix, HermitianBandMatrix,
                      TriangularBandMatrix)
from ..ops import blocks
from ..ops.blocks import _ct, matmul
from ..ops.tile_ops import hermitize
from ..options import Options
from .blas3 import _arr, _device_of, _nb, _wrap_like


def _band_arr(a, device=None):
    """Logical tensor of a band operand with outside-band zeros applied."""
    if isinstance(a, BaseBandMatrix):
        return a.banded()
    return _arr(a, _device_of(a, device=device))


def _herm_band_full(a, device=None):
    if isinstance(a, HermitianBandMatrix):
        return hermitize(a.uplo, a.banded())
    return _band_arr(a, device)


def gbmm(alpha, a, b, beta, c, opts: Optional[Options] = None, *,
         device=None):
    """C ← α·op(A_band)·B + β·C — reference ``slate::gbmm``: the masked
    band times a dense matrix, one product through the ``matmul`` site."""
    dev = _device_of(a, b, c, device=device)
    av, bv, cv = _band_arr(a, dev), _arr(b, dev), _arr(c, dev)
    return _wrap_like(c, alpha * matmul(av, bv) + beta * cv)


def hbmm(side: Side, alpha, a, b, beta, c, opts: Optional[Options] = None,
         *, device=None):
    """C ← α·A_hermband·B + β·C (or B·A) — reference ``slate::hbmm``."""
    dev = _device_of(a, b, c, device=device)
    av = _herm_band_full(a, dev)
    bv, cv = _arr(b, dev), _arr(c, dev)
    prod = matmul(av, bv) if side is Side.Left else matmul(bv, av)
    return _wrap_like(c, alpha * prod + beta * cv)


def pbtrf(a, opts: Optional[Options] = None):
    """Band Cholesky — reference ``slate::pbtrf``.  Per block column of
    width min(nb, kd): the diagonal block's Cholesky, the window trsm and
    the window's rank-w update (``matmul`` site), the factor keeping
    bandwidth kd.  Returns a TriangularBandMatrix in ``a``'s uplo."""
    if not isinstance(a, HermitianBandMatrix):
        raise SlateError("pbtrf expects a HermitianBandMatrix")
    kd = a.kd
    uplo = a.uplo
    full = hermitize(uplo, a.banded())          # a new tensor: ours to update
    n = full.shape[-1]
    nb = min(_nb(a, opts), max(kd, 1))
    for j0 in range(0, n, nb):
        r1 = min(j0 + nb, n)
        r2 = min(n, r1 + kd)
        l11 = blocks.potrf_rec(full[j0:r1, j0:r1], nb)
        full[j0:r1, j0:r1] = l11
        if r1 < r2:
            l21 = blocks.trsm_rec(Side.Right, Uplo.Upper, Diag.NonUnit,
                                  _ct(l11), full[r1:r2, j0:r1], nb)
            full[r1:r2, j0:r1] = l21
            full[r1:r2, r1:r2] -= matmul(l21, _ct(l21))
    lfac = torch.tril(full)
    data = lfac if uplo is Uplo.Lower else _ct(lfac).resolve_conj().contiguous()
    return TriangularBandMatrix(data, kd=kd, uplo=uplo, diag=Diag.NonUnit,
                                mb=a.mb, nb=a.nb, grid=a.grid,
                                device=data.device)


def pbtrs(factor, b, opts: Optional[Options] = None, *, device=None):
    """Solve with the band Cholesky factor — reference ``slate::pbtrs``:
    two triangular band solves."""
    dev = _device_of(factor, b, device=device)
    uplo = getattr(factor, "uplo", Uplo.Lower)
    lv = _band_arr(factor, dev)
    if uplo is not Uplo.Lower:
        lv = _ct(lv)
    bv = _arr(b, dev)
    nb = _nb(factor, opts)
    y = blocks.trsm_rec(Side.Left, Uplo.Lower, Diag.NonUnit, lv, bv, nb)
    x = blocks.trsm_rec(Side.Left, Uplo.Upper, Diag.NonUnit, _ct(lv), y, nb)
    return _wrap_like(b, x)


def pbsv(a, b, opts: Optional[Options] = None):
    """Factor + solve — reference ``slate::pbsv``.  Returns (factor, x)."""
    f = pbtrf(a, opts)
    return f, pbtrs(f, b, opts)


def gbtrf(a, opts: Optional[Options] = None):
    """Pivoted band LU — reference ``slate::gbtrf``: the dense ``getrf``
    of the masked band (L keeps bandwidth kl, U grows to kl + ku, which
    the returned BandMatrix records).  Returns ``(factor_band, pivots)``."""
    from .lu import getrf

    if not isinstance(a, BandMatrix):
        raise SlateError("gbtrf expects a BandMatrix")
    fac, piv = getrf(a.banded(), opts, device=a.device)
    return BandMatrix(fac, kl=a.kl, ku=a.kl + a.ku, mb=a.mb, nb=a.nb,
                      grid=a.grid, device=fac.device), piv


def gbtrs(factor, pivots, b, opts: Optional[Options] = None, *,
          device=None):
    """Solve with the band LU — reference ``slate::gbtrs``."""
    from .lu import getrs

    dev = _device_of(factor, b, device=device)
    fv = factor.data if isinstance(factor, BaseBandMatrix) else _arr(factor,
                                                                     dev)
    x = getrs(fv, pivots, _arr(b, dev), opts=opts, device=dev)
    return _wrap_like(b, x)


def gbsv(a, b, opts: Optional[Options] = None):
    """Factor + solve — reference ``slate::gbsv``.  Returns ``(factor,
    pivots, x)``."""
    f, piv = gbtrf(a, opts)
    return f, piv, gbtrs(f, piv, b, opts)


def tbsm(side: Side, alpha, a, b, pivots=None,
         opts: Optional[Options] = None, *, device=None):
    """Triangular band solve op(A_band)·X = α·B — reference
    ``slate::tbsm`` (the pivoted variant applies the band-LU row swaps
    first)."""
    if not isinstance(a, TriangularBandMatrix):
        raise SlateError("tbsm expects a TriangularBandMatrix")
    dev = _device_of(a, b, device=device)
    av = a.banded()
    uplo = a.uplo
    if a.op is not Op.NoTrans:
        uplo = Uplo.Lower if uplo is Uplo.Upper else Uplo.Upper
    bv = _arr(b, dev)
    nb = _nb(a, opts)
    if pivots is not None and side is Side.Left:
        bv = bv[torch.as_tensor(pivots, device=dev).long()]
    out = blocks.trsm_rec(side, uplo, a.diag, av, alpha * bv, nb)
    return _wrap_like(b, out)
