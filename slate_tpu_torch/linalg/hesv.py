"""Hermitian-indefinite solvers: hetrf / hetrs / hesv and the ``sy``
aliases — the counterpart of ``slate_tpu/linalg/hesv.py`` (reference
``src/hetrf.cc``, ``src/hetrs.cc``, ``src/hesv.cc``).

As in the JAX package, the factorization is a pivoted Parlett–Reid
congruence A = P·L·T·Lᴴ·Pᴴ with T tridiagonal (the reference's Aasen
family with a band of one): step j pivots the largest |A(i, j)|, i > j,
into row j + 1 by a two-sided swap and applies the elementary
congruence.  The blocked form (:func:`_hetrf_blocked`) updates only the
panel's window column by column and defers the two rank-1 terms of each
step into one her2k-shaped product over the trailing columns a panel.
Each column's pivot stays on the device: the swaps take tensor indices,
so no column reads the host.

:func:`hetrs` applies the pivots, L, T and Lᴴ: T by LAPACK's banded
solve on the host (``scipy.linalg.solve_banded``, as the JAX package's
eager path), or, where no host round trip can happen — inside a CUDA
graph capture — by :func:`_gtsv_scan`, the counterpart of the JAX
package's traced branch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..enums import Diag, Side, Uplo
from ..ops import blocks
from ..ops.blocks import _ct, matmul
from ..options import Options, get_option
from .blas3 import _arr, _device_of, _wrap_like
from .cholesky import _hermitian_full

__all__ = ["HetrfFactors", "hetrf", "hetrs", "hesv", "sytrf", "sytrs",
           "sysv"]


class HetrfFactors(NamedTuple):
    """A = P·L·T·Lᴴ·Pᴴ, the pivots interleaved with the eliminations as
    in LAPACK ``sytrf_aa``: ``l`` the multiplier columns (unit diagonal
    implicit, column 0 zero), ``d``/``e`` the real diagonal and the
    subdiagonal of T, ``ipiv`` (int32) the row each step swapped with."""

    l: torch.Tensor
    d: torch.Tensor
    e: torch.Tensor
    ipiv: torch.Tensor


def _pair(i: int, p):
    """``(i, p)`` and ``(p, i)`` as index tensors on ``p``'s device."""
    ip = torch.stack([torch.full_like(p, i), p])
    return ip, ip.flip(0)


def _d_e(a):
    d = torch.diagonal(a)
    return (d.real if a.is_complex() else d).clone(), \
        torch.diagonal(a, -1).clone()


def hetrf(a, opts: Optional[Options] = None, *, device=None) -> HetrfFactors:
    """Factor a Hermitian (possibly indefinite) A = L·T·Lᴴ, L unit lower
    and T tridiagonal, with symmetric partial pivoting — reference
    ``slate::hetrf``.  Step j pivots the largest |A(i, j)|, i > j, into
    row j + 1 (a two-sided swap) and applies E·A·Eᴴ,
    E = I − l·e_{j+1}ᵀ.  Past n = 2·nb + 2 the blocked form
    (:func:`_hetrf_blocked`) runs; the unblocked loop below serves small
    n and is what the blocked form is tested against.  nb is the
    ``block_size`` option, else the matrix's nb, else 64."""
    dev = _device_of(a, device=device)
    av = _hermitian_full(a, dev)
    n = av.shape[-1]
    nb = int(get_option(opts, "block_size", None)
             or getattr(a, "nb", None) or 64)
    if n > 2 * nb + 2 and n > 8:
        return HetrfFactors(*_hetrf_blocked(av, nb))
    a = av.clone()
    l = torch.zeros_like(a)
    ipiv = torch.zeros(n, dtype=torch.int32, device=a.device)
    for j in range(max(n - 2, 0)):
        p = torch.argmax(a[j + 1:, j].abs()) + (j + 1)
        ij, pj = _pair(j + 1, p)
        a[ij] = a[pj]
        a[:, ij] = a[:, pj]
        l[ij] = l[pj]
        alpha = a[j + 1, j]
        lcol = torch.zeros_like(a[:, j])
        lcol[j + 2:] = a[j + 2:, j] / torch.where(
            alpha == 0, torch.ones_like(alpha), alpha)
        a -= torch.outer(lcol, a[j + 1].clone())
        a -= torch.outer(a[:, j + 1].clone(), lcol.conj())
        l[:, j + 1] += lcol
        ipiv[j] = p
    d, e = _d_e(a)
    return HetrfFactors(l=l, d=d, e=e, ipiv=ipiv)


def _hetrf_blocked(av, nb: int):
    """Panel-blocked Parlett–Reid L·T·Lᴴ (``slate_tpu/linalg/hesv.py:
    115-237``): within a panel the two-sided eliminations update only the
    (n × nb + 1) window; their rank-1 terms are kept (V the multipliers,
    U the pivot columns before the step's left term, C after it) and
    applied to the trailing columns as one V·Uᴴ + C·Vᴴ product a panel.
    Swaps move whole rows and columns at once; a per-column watermark
    records how many of the panel's steps a column swapped out of the
    window has absorbed, so the deferred product subtracts only the
    missing terms.  The pivot of each column stays on the device.
    Returns ``(l, d, e, ipiv)``."""
    n = av.shape[-1]
    dt = av.dtype
    dev = av.device
    a = av.clone()
    l = torch.zeros_like(a)
    ipiv = torch.zeros(n, dtype=torch.int32, device=dev)
    for j0 in range(0, max(n - 2, 0), nb):
        w = min(nb, n - 2 - j0)
        m = n - j0                  # the panel runs on the trailing
        wide = min(w + 1, m)        # square a[j0:, j0:]
        asq = a[j0:, j0:].clone()
        lp = l[j0:]
        vuc = torch.zeros((m, 3 * w), dtype=dt, device=dev)   # [V | U | C]
        V, U, C = vuc[:, :w], vuc[:, w:2 * w], vuc[:, 2 * w:]
        wm = torch.zeros(m, dtype=torch.int64, device=dev)
        steps = torch.arange(w, device=dev)
        rows = torch.arange(m, device=dev)
        piv = torch.empty(w, dtype=torch.int64, device=dev)
        for t in range(w):
            p = torch.argmax(asq[t + 1:, t].abs()) + (t + 1)
            it = torch.cat([rows[t + 1:t + 2], p.view(1)])
            pt = it.flip(0)
            for x in (asq, vuc, wm, lp):
                x.index_copy_(0, it, x.index_select(0, pt))
            asq.index_copy_(1, it, asq.index_select(1, pt))
            # refresh the swapped-in column t+1 with the panel terms it
            # missed (steps wm[t+1] .. t-1); U keeps it before the left term
            col = asq[:, t + 1]
            if t:
                mask = (steps[:t] >= wm[t + 1]).to(dt)
                col.addmv_(V[:, :t], mask * U[t + 1, :t].conj(), alpha=-1)
                col.addmv_(C[:, :t], mask * V[t + 1, :t].conj(), alpha=-1)
            U[:, t] = col
            # the multipliers, written straight into V's zero column t
            aj1 = asq[t + 1, t]
            V[t + 2:, t] = asq[t + 2:, t] / (aj1 + (aj1 == 0))
            lcol = V[:, t]
            # the two congruence terms on the window (rows and columns
            # below t+2: the multipliers are zero above)
            win = asq[:, :wide]
            win[t + 2:].addr_(lcol[t + 2:], win[t + 1], alpha=-1)
            C[:, t] = win[:, t + 1]
            win[:, t + 2:].addr_(win[:, t + 1], lcol[t + 2:wide].conj(),
                                 alpha=-1)
            piv[t] = p
            wm[:wide] = t + 1       # window columns are current through t
        ipiv[j0:j0 + w] = piv + j0
        if wide < m:
            # the deferred her2k-shaped update of the trailing columns,
            # masked per column by its watermark
            maskc = (steps[None, :] >= wm[wide:, None]).to(dt)
            asq[:, wide:] = asq[:, wide:] \
                - matmul(V, (U[wide:].conj() * maskc).T) \
                - matmul(C, (V[wide:].conj() * maskc).T)
            # re-hermitize: the deferred product's rounding asymmetry is
            # otherwise amplified by every later elimination's growth
            blk = asq[wide:, wide:]
            asq[wide:, wide:] = 0.5 * (blk + _ct(blk))
        a[j0:, j0:] = asq
        l[j0:, j0 + 1:j0 + w + 1] = V
    d, e = _d_e(a)
    return l, d, e, ipiv


def _gtsv_scan(d, e, b):
    """Partial-pivot tridiagonal solve, LAPACK ``gtsv``'s algorithm as one
    forward sweep and one back substitution over the rows (the JAX
    package's ``lax.scan`` pair), in device operations only: the branch
    :func:`hetrs` takes inside a CUDA graph capture, where no host round
    trip can happen.  T is Hermitian tridiagonal: diagonal ``d``,
    subdiagonal ``e``, superdiagonal ``conj(e)``.  Forward: the current
    row (d, du, du2, rhs) meets the next row's subdiagonal and either
    eliminates it or swaps first (dgtsv's adjacent-row pivoting with its
    one extra ``du2`` band)."""
    dt = torch.promote_types(torch.promote_types(d.dtype, e.dtype), b.dtype)
    n = d.shape[0]
    d, e, b = d.to(dt), e.to(dt), b.to(dt)
    if n == 1:
        return b / d[0]
    du = e.conj()
    zero = torch.zeros((), dtype=dt, device=d.device)
    cd, cdu, cdu2, cb = d[0], du[0], zero, b[0]
    rows = []
    for i in range(n - 1):
        dl, dn, dun, bn = e[i], d[i + 1], (du[i + 1] if i + 1 < n - 1
                                           else zero), b[i + 1]
        swap = cd.abs() < dl.abs()
        fact = torch.where(swap, cd, dl) / torch.where(swap, dl, cd)
        rows.append((torch.where(swap, dl, cd), torch.where(swap, dn, cdu),
                     torch.where(swap, dun, cdu2),
                     torch.where(swap, bn, cb)))
        cd, cdu, cdu2, cb = (torch.where(swap, cdu - fact * dn,
                                         dn - fact * cdu),
                             torch.where(swap, cdu2 - fact * dun,
                                         dun - fact * cdu2),
                             zero,
                             torch.where(swap, cb - fact * bn, bn - fact * cb))
    rows.append((cd, zero, zero, cb))
    x1 = x2 = torch.zeros_like(b[0])
    xs = [None] * n
    for i in range(n - 1, -1, -1):
        di, dui, du2i, bi = rows[i]
        xs[i] = (bi - dui * x1 - du2i * x2) / di
        x1, x2 = xs[i], x1
    return torch.stack(xs)


def _swap_perm(ipiv, n: int, on_device: bool):
    """The row order ``z[perm]`` that the pivots' swap sequence
    (rows j+1 and ipiv[j], j = 0 … n−3, in turn) makes of z: on the host
    from one read of ``ipiv``, or by index operations on the device."""
    if on_device:
        perm = torch.arange(n, device=ipiv.device)
        for j in range(n - 2):
            ij, pj = _pair(j + 1, ipiv[j].long())
            perm[ij] = perm[pj]
        return perm
    perm = np.arange(n)
    for j, p in enumerate(ipiv[:max(n - 2, 0)].cpu().numpy().tolist()):
        perm[j + 1], perm[p] = perm[p], perm[j + 1]
    return torch.from_numpy(perm).to(ipiv.device)


def hetrs(factors: HetrfFactors, b, opts: Optional[Options] = None, *,
          device=None):
    """Solve with the :func:`hetrf` factors — reference ``slate::hetrs``:
    pivots → L → T → Lᴴ → pivots back.  T's solve is LAPACK's banded
    solve on the host, or :func:`_gtsv_scan` inside a CUDA graph
    capture.  Runs where the factors are unless ``device`` says
    otherwise."""
    l, d, e, ipiv = factors
    dev = l.device if device is None else _device_of(device=device)
    bv = _arr(b, dev)
    squeeze = bv.ndim == 1
    if squeeze:
        bv = bv[:, None]
    n = l.shape[0]
    dt = l.dtype
    bv = bv.to(dt)
    # the row-swapped multipliers make P·A·Pᴴ = L·T·Lᴴ
    capturing = dev.type == "cuda" and torch.cuda.is_current_stream_capturing()
    perm = _swap_perm(ipiv, n, capturing)
    lfull = l + torch.eye(n, dtype=dt, device=l.device)
    nb = max(32, n // 8)
    y = blocks.trsm_rec(Side.Left, Uplo.Lower, Diag.Unit, lfull, bv[perm], nb)
    if capturing:
        w = _gtsv_scan(d, e, y)
    else:
        from scipy.linalg import solve_banded

        ab = np.zeros((3, n), dtype=torch.empty(0, dtype=dt).numpy().dtype)
        ab[1] = d.cpu().numpy()
        if n > 1:
            enp = e.cpu().numpy()
            ab[0, 1:] = np.conj(enp)
            ab[2, :-1] = enp
        w = torch.from_numpy(np.ascontiguousarray(solve_banded(
            (1, 1), ab, y.cpu().numpy()))).to(device=y.device, dtype=dt)
    v = blocks.trsm_rec(Side.Left, Uplo.Upper, Diag.Unit, _ct(lfull), w, nb)
    x = torch.empty_like(v)
    x[perm] = v
    if squeeze:
        x = x[:, 0]
    return _wrap_like(b, x)


def hesv(a, b, opts: Optional[Options] = None, *, device=None):
    """Factor and solve — reference ``slate::hesv``.  Returns
    ``(factors, x)``."""
    dev = _device_of(a, b, device=device)
    f = hetrf(a, opts, device=dev)
    return f, hetrs(f, b, opts, device=dev)


#: real-symmetric aliases (reference ``slate::sytrf/sytrs/sysv``)
sytrf = hetrf
sytrs = hetrs
sysv = hesv
