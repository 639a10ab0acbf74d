"""LU family: getrf (partial pivot / no pivot), getrs, gesv, getri — the
counterpart of ``slate_tpu/linalg/lu.py`` (reference ``src/getrf.cc``,
``getrf_nopiv.cc``, ``getrs.cc``, ``gesv.cc``, ``getri.cc``).

Pivots are permutation vectors (int64 tensors), ``A[perm] = L·U`` with
the factor packed LAPACK-style in one tensor, as in the JAX package.
Partial pivoting runs one of two drivers, chosen by the ``lu_driver``
site:

* ``"scattered"`` — :func:`getrf_scattered`: the matrix lives
  transposed, rows never move, and each 512-wide panel is one launch of
  the ``getrf_panel_fused`` kernel (``csrc/getrf_panel_fused.cu``) — or,
  at the deeper depths of the ``lu_step`` site, each whole step one
  launch of ``getrf_step_fused`` or the whole factorization one launch of
  ``getrf_full_fused``;
* ``"rec"`` — :func:`getrf_rec`: the blocked recursion, whose panel leaf
  is the ``getrf_panel_linv`` kernel (``csrc/getrf_panel_linv.cu``)
  where the ``lu_panel`` site admits it, else ``torch.linalg.lu_factor``.

``gesv_mixed``/``gesv_mixed_gmres`` factor in fp32 through
``getrf_rec`` — under the split-precision products where
:func:`~slate_tpu_torch.linalg._refine.use_split_leg` says so, with a
κ·ε demotion — and refine in the working precision
(:mod:`slate_tpu_torch.linalg._refine`).

Matrices taller than :data:`_MAX_LU_PANEL_ROWS` factor through the
tall-panel loop :func:`getrf_panels` (as in the JAX package): panels of
up to that many rows take the ``lu_panel`` site's leaf, taller ones a
tournament (:func:`_tall_panel_lu`, under ``MethodLU.Auto``) or the
inner-blocked true partial pivoting of :func:`_tall_panel_lu_pp` (under
an explicit ``MethodLU.PartialPiv``).  ``MethodLU.CALU`` is
:func:`getrf_tntpiv`, the blocked recursion over the tournament panel
:func:`_panel_lu_tntpiv`.

With ``SLATE_TPU_TORCH_ABFT`` on, the partial-pivot driver runs under
the ABFT layer (:func:`_getrf_partial`).  Where the ``ooc`` site answers
``"pool"`` (:func:`slate_tpu_torch.linalg.ooc.choose`), partial pivoting
runs out of core instead (:func:`slate_tpu_torch.linalg.ooc.getrf_ooc`:
the matrix in a host tile grid, the panels through
:func:`slate_tpu_torch.linalg.ooc._panel_lu`, which calls
:func:`_getrf_incore` or, for a panel too tall for the scattered
driver, :func:`getrf_rec` on ``getrf_panel_linv`` leaves).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..enums import Diag, MethodLU, Norm, Op, Side, Uplo
from ..method import select_backend, select_lu
from ..ops import blocks, kernels, smem
from ..ops.blocks import matmul, matmul_hi
from ..options import Options, get_option
from ..perf import metrics
from ..perf.metrics import instrument_driver
from .blas3 import _arr, _device_of, _nb, _wrap_like


# ---------------------------------------------------------------------------
# Pivot representation
# ---------------------------------------------------------------------------

def ipiv_to_perm(ipiv, m: int):
    """LAPACK ipiv (1-based swap sequence) → permutation vector."""
    perm = list(range(m))
    for k, p in enumerate(torch.as_tensor(ipiv).tolist()):
        p = int(p) - 1
        perm[k], perm[p] = perm[p], perm[k]
    return torch.tensor(perm, dtype=torch.int64)


def perm_to_ipiv(perm):
    """Permutation vector → LAPACK 1-based swap sequence (int32)."""
    perm = [int(x) for x in torch.as_tensor(perm).tolist()]
    m = len(perm)
    ipiv = [0] * m
    cur = list(range(m))
    loc = {r: i for i, r in enumerate(cur)}
    for k in range(m):
        j = loc[perm[k]]
        ipiv[k] = j + 1
        rk, rj = cur[k], cur[j]
        cur[k], cur[j] = rj, rk
        loc[rj], loc[rk] = k, j
    return torch.tensor(ipiv, dtype=torch.int32)


def inverse_perm(perm):
    return torch.argsort(perm)


def _lu_perm(a):
    """``torch.linalg.lu_factor_ex`` of ``a`` (any leading batch) with its
    pivots as permutations: ``(lu, perm)``, ``a[..., perm, :] = L·U``.
    The swap sequences become permutations on the operand's device,
    through ``torch.lu_unpack``'s permutation matrices, with no Python
    loop over rows and no host read (a singular block, such as CALU's
    zero padding, is factored without the error check's sync)."""
    lu, ipiv, _ = torch.linalg.lu_factor_ex(a)
    p = torch.lu_unpack(lu, ipiv, unpack_data=False)[0]
    # a = P·L·U, so row i of L·U is row argmax_j P[j, i] of a; P has the
    # operand's dtype, and argmax takes no complex input: its 0/1 entries
    # are all in the real part
    return lu, (p.real if p.is_complex() else p).argmax(dim=-2)


# ---------------------------------------------------------------------------
# Panels
# ---------------------------------------------------------------------------

#: inner block of the panel-leaf kernels (the JAX package passes ib=32)
_PANEL_IB = 32


def _panel_lu(a):
    """Stock partial-pivot panel: ``torch.linalg.lu_factor`` plus the swap
    sequence turned into a permutation — the role ``lax.linalg.lu`` plays
    in the JAX package.  Returns ``(lu, perm)`` with ``a[perm] = L·U``."""
    lu, ipiv = torch.linalg.lu_factor(a)
    return lu, ipiv_to_perm(ipiv, a.shape[0]).to(a.device)


def _panel_lu_kernel(a):
    """Partial-pivot panel in ONE launch of the ``getrf_panel_linv``
    kernel on the transposed panel; returns ``(lu, perm, linv)`` with
    ``linv`` the inverse of the unit-lower pivot block.  The JAX package
    pads the lane count to a power of two here to bound Mosaic
    recompiles; a CUDA kernel takes m at run time, and the padding lanes
    were inactive, so nothing is padded."""
    m, w = a.shape
    at = a.T.contiguous()                      # (w, m) lane-major slab
    act = torch.ones((1, m), dtype=a.dtype, device=a.device)
    out, piv, act_out, linv = kernels.getrf_panel_linv(at, act, ib=_PANEL_IB)
    perm = piv
    if m > w:
        # active (non-pivot) rows follow in original order
        rest = torch.argsort((act_out[0] < 0.5).to(torch.int8),
                             stable=True)[: m - w]
        perm = torch.cat([piv, rest])
    return out[:, perm].T, perm, linv


#: the JAX package's name for the same leaf
_panel_lu_pallas = _panel_lu_kernel


def _use_kernel_panel(m: int, w: int, dtype, device) -> bool:
    """Eligibility of the ``getrf_panel_linv`` leaf (``lu_panel`` site).
    The JAX package also required m ≥ 3072 — a v5e timing ("short panels
    keep XLA's fused kernel"), not a fact about this card — so that term
    is dropped; the TPU test becomes the device test (the kernel on CUDA,
    its plain version on the CPU) and VMEM becomes shared memory."""
    from .. import config

    if config.use_kernels_mode() == "off":
        return False
    return (dtype == torch.float32 and w % 32 == 0 and m % 8 == 0
            and w >= 64 and m >= w
            and torch.device(device).type in ("cpu", "cuda")
            and smem.lu_panel_fits(m, w, _PANEL_IB, device))


#: the JAX package's name for the same gate
_use_pallas_panel = _use_kernel_panel


def _panel_lu_auto(a):
    """Panel dispatch through the ``lu_panel`` site: the kernel leaf
    (``(lu, perm, linv)``) or the stock one (``(lu, perm)``)."""
    m, w = a.shape
    choice = select_backend("lu_panel", m=m, w=w, dtype=a.dtype,
                            device=a.device,
                            eligible=_use_kernel_panel(m, w, a.dtype,
                                                       a.device))
    if choice in ("kernel", "plain"):
        return _panel_lu_kernel(a)
    return _panel_lu(a)


def _panel_lu_nopiv(a, ib: int = 128):
    """No-pivot panel: recursion down to ``ib``-wide unblocked rank-1
    loops (reference ``Option::InnerBlocking``)."""
    m, n = a.shape
    if n <= ib:
        acc = a.clone()
        for k in range(min(m, n)):
            acc[k + 1:, k] /= acc[k, k]
            acc[k + 1:, k + 1:] -= torch.outer(acc[k + 1:, k], acc[k, k + 1:])
        return acc
    n1 = n // 2
    f1 = _panel_lu_nopiv(a[:, :n1], ib)
    u12 = torch.linalg.solve_triangular(f1[:n1], a[:n1, n1:], upper=False,
                                        unitriangular=True)
    f2 = _panel_lu_nopiv(a[n1:, n1:] - matmul(f1[n1:], u12), ib)
    top = torch.cat([f1[:n1], u12], dim=1)
    bot = torch.cat([f1[n1:], f2], dim=1)
    return torch.cat([top, bot], dim=0)


def _panel_lu_tntpiv(a, nb: int):
    """CALU tournament-pivot panel (reference ``getrf_tntpiv``,
    ``internal_getrf_tntpiv.cc``; ``slate_tpu/linalg/lu.py:273-328``):
    round 0 factors every mb-row tile independently in ONE batched
    ``torch.linalg.lu_factor`` over the (nt, mb, w) tile stack; each
    tournament round stacks pairs of winner sets and factors them as one
    batch, halving the candidates; the winning w rows lead, and the panel
    factors against their block with one triangular solve.  Returns
    ``(lu, perm)`` with ``a[perm] = L·U``, the contract of
    :func:`_panel_lu` with a communication-avoiding pivot choice."""
    m, n = a.shape
    mb = max(nb, n)
    nt = -(-m // mb)
    pad_m = nt * mb
    # padded rows are exact zeros and never win the tournament
    apad = a.new_zeros((pad_m, n))
    apad[:m] = a
    _, perms = _lu_perm(apad.reshape(nt, mb, n))
    offs = torch.arange(nt, device=a.device)[:, None] * mb
    cand = (perms[:, :n] + offs).reshape(-1)
    while cand.shape[0] > n:
        bye = None
        if (cand.shape[0] // n) % 2 == 1:      # odd contenders: a bye
            bye, cand = cand[-n:], cand[:-n]
        pairs = cand.reshape(-1, 2 * n)
        _, sp = _lu_perm(apad[pairs.reshape(-1)].reshape(-1, 2 * n, n))
        win = torch.gather(pairs, 1, sp[:, :n]).reshape(-1)
        cand = torch.cat([win, bye]) if bye is not None else win
    # the winners lead, the rest follow in their order; pivoting inside
    # the winners' n×n block is local, then one solve gives L21
    mask = torch.zeros(pad_m, dtype=torch.bool, device=a.device)
    mask[cand] = True
    order = torch.argsort((~mask).to(torch.int8), stable=True)
    ap = apad[order]
    lu_top, p2 = _lu_perm(ap[:n])
    l21 = torch.linalg.solve_triangular(torch.triu(lu_top), ap[n:],
                                        upper=True, left=False)
    lu = torch.cat([lu_top, l21], dim=0)
    order = torch.cat([order[:n][p2], order[n:]])
    sel = torch.argsort((order >= m).to(torch.int8), stable=True)[:m]
    return lu[sel], order[sel]


# ---------------------------------------------------------------------------
# Blocked factorization
# ---------------------------------------------------------------------------

def _u12_with_linv(lu_top, linv, c):
    """U₁₂ from the panel's unit-lower inverse: one Newton step on the
    inverse (``X₂ = X(2I − L₁₁X)``, full-precision products), one product
    and one residual correction.  Guarded by ‖r₁‖∞/‖c‖∞ < 1e-2, past
    which the exact triangular solve takes over.  The JAX package
    branches on the device with ``lax.cond``; here the branch is on the
    host, which costs one scalar read per panel, and each fallback is
    counted (``lu.u12_linv.fallbacks``)."""
    n1 = lu_top.shape[0]
    l11 = torch.tril(lu_top, -1) + torch.eye(n1, dtype=lu_top.dtype,
                                             device=lu_top.device)
    li = linv.to(lu_top.dtype)
    li = 2.0 * li - matmul_hi(li, matmul_hi(l11, li))
    u12 = matmul(li, c)
    r1 = c - matmul(l11, u12)
    dev = r1.abs().max() / torch.clamp(c.abs().max(),
                                       min=torch.finfo(lu_top.dtype).tiny)
    metrics.inc("lu.u12_linv.sites")
    if float(dev) < 1e-2:
        return u12 + matmul(li, r1)
    metrics.inc("lu.u12_linv.fallbacks")
    return torch.linalg.solve_triangular(l11, c, upper=False,
                                         unitriangular=True)


def getrf_rec(a, nb: int, panel=_panel_lu_auto):
    """Blocked right-looking LU with row pivoting: ``a[perm] = L·U``
    packed LAPACK-style (reference ``src/getrf.cc:94-215``: panel →
    row permutation → trsm → trailing gemm)."""
    m, n = a.shape
    if m < n:
        # wide: factor the square left part, then one trsm for the rest
        lu_l, perm = getrf_rec(a[:, :m], nb, panel)
        u_r = torch.linalg.solve_triangular(lu_l, a[perm][:, m:], upper=False,
                                            unitriangular=True)
        return torch.cat([lu_l, u_r], dim=1), perm
    if n <= nb:
        out = panel(a)
        return out[0], out[1]
    n1 = blocks._split(n, nb)
    linv = None
    if n1 <= nb:
        out = panel(a[:, :n1])
        lu1, perm1 = out[0], out[1]
        linv = out[2] if len(out) > 2 else None
    else:
        lu1, perm1 = getrf_rec(a[:, :n1], nb, panel)
    right = a[perm1][:, n1:]
    if linv is not None:
        u12 = _u12_with_linv(lu1[:n1], linv, right[:n1])
    else:
        u12 = torch.linalg.solve_triangular(lu1[:n1], right[:n1], upper=False,
                                            unitriangular=True)
    lu2, perm2 = getrf_rec(right[n1:] - matmul(lu1[n1:], u12), nb, panel)
    top = torch.cat([lu1[:n1], u12], dim=1)
    bot = torch.cat([lu1[n1:][perm2], lu2], dim=1)
    perm = torch.cat([perm1[:n1], perm1[n1:][perm2]])
    return torch.cat([top, bot], dim=0), perm


#: tallest panel the loop factors with the ``lu_panel`` site's leaf; a
#: taller one takes the tournament or the inner-blocked loop.  The JAX
#: package's value (XLA's fused LU overflows v5e scoped VMEM past it),
#: kept so both packages pivot alike; it is not this card's limit, whose
#: leaf kernel admits 512-wide panels to 9768 rows at ib 32
#: (``smem.lu_panel_fits``)
_MAX_LU_PANEL_ROWS = 8192


def _tall_panel_lu(pan, max_rows: int = _MAX_LU_PANEL_ROWS):
    """Tournament (CALU) factorization of a panel taller than
    :data:`_MAX_LU_PANEL_ROWS` — reference ``getrf_tntpiv``: round 0
    factors each row chunk with ``torch.linalg.lu_factor``, knockout
    rounds stack pairs of winner sets, the winner block leads and the
    panel factors against it with one triangular solve.  Returns
    ``(lu, pl)`` with ``pan[pl] = L·U``."""
    m, w = pan.shape
    dev = pan.device
    cand = []
    for c0 in range(0, m, max_rows):
        chunk = pan[c0:c0 + max_rows]
        if chunk.shape[0] <= w:
            cand.append(c0 + torch.arange(chunk.shape[0], device=dev))
            continue
        cand.append(c0 + _lu_perm(chunk)[1][:w])
    rows = torch.cat(cand)
    while rows.shape[0] > w:
        take = min(2 * w, rows.shape[0])
        winners = rows[:take][_lu_perm(pan[rows[:take]])[1][:w]]
        rows = torch.cat([winners, rows[take:]]) \
            if rows.shape[0] > take else winners
    # winners first in tournament order, the rest in their order
    score = m + torch.arange(m, device=dev)
    score[rows] = torch.arange(w, device=dev)
    pl = torch.argsort(score)
    permuted = pan[pl]
    top, permw = _lu_perm(permuted[:w])
    pl = torch.cat([pl[:w][permw], pl[w:]])
    l21 = torch.linalg.solve_triangular(torch.triu(top), permuted[w:],
                                        upper=True, left=False)
    return torch.cat([top, l21], dim=0), pl


def _tall_panel_lu_pp(pan, ib: int = 64):
    """TRUE partial-pivot factorization of a panel taller than
    :data:`_MAX_LU_PANEL_ROWS` (reference ``Tile_getrf.hh:154-320``:
    per-column argmax, swap, rank-1 update), inner-blocked so each rank-1
    update touches an ib-wide slab; every pivot is the argmax of the
    fully updated column, so |L| ≤ 1.  Each column's pivot stays on the
    device: the swap takes index tensors, with no ``.item()``.  Returns
    ``(lu, pl)`` with ``pan[pl] = L·U``."""
    m, w = pan.shape
    a = pan.clone()
    gperm = torch.arange(m, device=pan.device)
    for b0 in range(0, w, ib):
        bw = min(ib, w - b0)
        slab = a[b0:, b0:b0 + bw].clone()
        bperm = torch.arange(m - b0, device=pan.device)
        for jj in range(bw):
            p = torch.argmax(slab[jj:, jj].abs()) + jj
            ij = torch.cat([bperm.new_full((1,), jj), p.view(1)])
            pj = ij.flip(0)
            for x in (slab, bperm):
                x.index_copy_(0, ij, x.index_select(0, pj))
            piv = slab[jj, jj]
            slab[jj + 1:, jj] /= piv + (piv == 0)
            slab[jj + 1:, jj + 1:].addr_(slab[jj + 1:, jj],
                                         slab[jj, jj + 1:], alpha=-1)
        body = a[b0:][bperm]
        body[:, b0:b0 + bw] = slab
        gperm[b0:] = gperm[b0:][bperm]
        if b0 + bw < w:
            u12 = torch.linalg.solve_triangular(
                slab[:bw], body[:bw, b0 + bw:], upper=False,
                unitriangular=True)
            body[:bw, b0 + bw:] = u12
            body[bw:, b0 + bw:] -= matmul(slab[bw:], u12)
        a[b0:] = body
    return a, gperm


def getrf_panels(a, nb: int = 512, tall_panel: str = "tournament"):
    """Right-looking blocked partial-pivot LU, loop form
    (``slate_tpu/linalg/lu.py:514-583``): each panel through the
    ``lu_panel`` site's leaf (:func:`_panel_lu_auto`: the
    ``getrf_panel_linv`` kernel, whose L₁₁⁻¹ turns U₁₂'s solve into
    products, :func:`_u12_with_linv`) or, taller than
    :data:`_MAX_LU_PANEL_ROWS`, the tournament (``"tournament"``, the
    Auto default) or the true partial-pivot loop (``"pp"``, what an
    explicit ``MethodLU.PartialPiv`` gets); then ONE permutation gather
    of the sub-matrix rows and one trailing product.  Returns
    ``(lu, perm)`` with ``a[perm] = L·U``."""
    if tall_panel not in ("tournament", "pp"):
        raise ValueError("unknown tall_panel %r" % (tall_panel,))
    m, n = a.shape
    k = min(m, n)
    a = a.clone()
    gperm = torch.arange(m, device=a.device)
    for k0 in range(0, k, nb):
        w = min(nb, k - k0)
        pan = a[k0:, k0:k0 + w]
        linv = None
        if pan.shape[0] > _MAX_LU_PANEL_ROWS:
            lu_p, pl = (_tall_panel_lu_pp if tall_panel == "pp"
                        else _tall_panel_lu)(pan)
        else:
            out = _panel_lu_auto(pan)
            lu_p, pl = out[0], out[1]
            linv = out[2] if len(out) > 2 else None
        body = a[k0:][pl]
        body[:, k0:k0 + w] = lu_p
        gperm[k0:] = gperm[k0:][pl]
        if k0 + w < n:
            if linv is not None:
                u12 = _u12_with_linv(lu_p[:w], linv, body[:w, k0 + w:])
            else:
                u12 = torch.linalg.solve_triangular(
                    lu_p[:w], body[:w, k0 + w:], upper=False,
                    unitriangular=True)
            body[:w, k0 + w:] = u12
            if w < body.shape[0]:
                body[w:, k0 + w:] -= matmul(lu_p[w:], u12)
        a[k0:] = body
    return a, gperm


def _scattered_tail(at, piv_all, act, m: int, k: int):
    """The packed layout from the scattered carry: the factorization-order
    pivots, then (m > k) the never-pivoted rows in order, with ONE column
    gather at the end."""
    perm = piv_all
    if m > k:
        rest = torch.argsort((act[0] < 0.5).to(torch.int8),
                             stable=True)[: m - k]
        perm = torch.cat([piv_all, rest])
    return at[:, perm].T.contiguous(), perm


def getrf_scattered(a, nb: int = 512, bb: int = 128, step=None):
    """Right-looking partial-pivot LU in SCATTERED-ROW form: pivoting is
    logical (each pivot is the masked argmax over the still-active rows
    and retires that row; no row moves), and the whole matrix lives
    transposed in ``a.T.contiguous()``, one private copy that the kernels
    update IN PLACE, standing in for the JAX package's aliased HBM carry.
    The ``lu_step`` site (or ``step``) picks the depth:

    * ``"composed"`` — each panel one ``getrf_panel_fused`` launch, then
      in PyTorch glue: the pivot-lane gather of the trailing rows, U₁₂
      from the panel's L₁₁⁻¹ with one residual correction (full-precision
      products), the rank-nb update over all lanes with retired lanes'
      multipliers zeroed (through the ``matmul`` site), and U₁₂ written
      into the pivot lanes (3 round trips a step);
    * ``"fused"`` — the whole step one ``getrf_step_fused`` launch (panel,
      Newton-refined inverse, U₁₂, update, scatter; no round trip);
    * ``"fused_trsm"`` — the same kernel with ``update=False``, then the
      rank-nb update through the ``matmul`` site (1 round trip a step);
    * ``"full"`` — the whole factorization one ``getrf_full_fused``
      launch, its pivots in factorization order.

    Returns ``(lu, perm)`` with ``a[perm] = L·U``.  Requires
    min(m, n) % nb == 0.
    """
    m, n = a.shape
    k = min(m, n)
    bb = min(bb, nb)
    if nb % bb or k % nb:
        raise ValueError("getrf_scattered needs bb | nb | min(m, n), got "
                         "(%d, %d), nb = %d, bb = %d" % (m, n, nb, bb))
    if step is None:
        step = select_backend(
            "lu_step", m=m, n=n, nb=nb, dtype=a.dtype, device=a.device,
            eligible=smem.lu_fused_fits(m, n, nb, a.dtype, a.device))
    if step not in ("composed", "fused", "fused_trsm", "full"):
        raise ValueError("unknown getrf_scattered step %r" % (step,))
    at = a.T.contiguous()
    act = torch.ones((1, m), dtype=a.dtype, device=a.device)
    if step == "full":
        metrics.inc("step.getrf.steps", float(k // nb))
        with metrics.step_timer("getrf", "full"):
            at, piv_all, act = kernels.getrf_full_fused(at, act, nb=nb, bb=bb)
        return _scattered_tail(at, piv_all, act, m, k)
    eye = torch.eye(nb, dtype=a.dtype, device=a.device)
    pivs = []
    for k0 in range(0, k, nb):
        metrics.inc("step.getrf.steps")
        if step in ("fused", "fused_trsm"):
            with metrics.step_timer("getrf", "fused"):
                at, piv, act, _ = kernels.getrf_step_fused(
                    at, act, k0, nb=nb, bb=bb, update=step == "fused")
            pivs.append(piv)
            if step == "fused_trsm" and k0 + nb < n:
                # the kernel scattered U12 into the pivot lanes; the rank-nb
                # update gathers them back for its operand
                metrics.count_hbm_roundtrips(1.0)
                with metrics.step_timer("getrf", "update"):
                    lmt = at[k0:k0 + nb, :] * act
                    at[k0 + nb:, :] -= matmul(at[k0 + nb:, :][:, piv], lmt)
            continue
        with metrics.step_timer("getrf", "panel"):
            at, piv, act, linv = kernels.getrf_panel_fused(at, act, k0,
                                                           nb=nb, bb=bb)
        pivs.append(piv)
        if k0 + nb < n:
            # the pivot-row gather, the u12 write-back and the trailing
            # read-modify-write each materialize an intermediate
            metrics.count_hbm_roundtrips(3.0)
            with metrics.step_timer("getrf", "trsm"):
                slab_t = at[k0:k0 + nb, :]
                l11 = torch.tril(slab_t[:, piv].T, -1) + eye
                c1t = at[k0 + nb:, :][:, piv]
                u12t = matmul_hi(c1t, linv.T)
                u12t = u12t + matmul_hi(c1t - matmul_hi(u12t, l11.T), linv.T)
            with metrics.step_timer("getrf", "update"):
                at[k0 + nb:, :] -= matmul(u12t, slab_t * act)
                at[k0 + nb:, piv] = u12t
    return _scattered_tail(at, torch.cat(pivs), act, m, k)


#: panel width of the scattered driver (the fused kernel's nb) and the
#: inner block its call passes (the kernel's default, as in the JAX
#: package, whose driver passes no ib)
_SCATTERED_NB = 512
_SCATTERED_IB = 16


def _use_scattered(av, nb: int) -> bool:
    """Eligibility of the scattered driver: f32 2-D matrices on a uniform
    nb grid whose (nb, m) panel the ``getrf_panel_fused`` grid can hold
    in shared memory (in place of the JAX package's m ≤ 16384 VMEM
    bound).  Whether an eligible matrix takes it is the ``lu_driver``
    site's decision."""
    from .. import config

    if config.use_kernels_mode() == "off" or av.ndim != 2:
        return False
    m, n = av.shape
    return (av.dtype == torch.float32 and min(m, n) % nb == 0 and m >= nb
            and m % 8 == 0 and av.device.type in ("cpu", "cuda")
            and smem.lu_panel_fits(m, nb, _SCATTERED_IB, av.device))


def _choose_lu_driver(av) -> str:
    """The ``lu_driver`` site decision for one operand."""
    m, n = (av.shape[0], av.shape[1]) if av.ndim == 2 else (0, 0)
    return select_backend("lu_driver", m=m, n=n, nb=_SCATTERED_NB,
                          dtype=av.dtype, device=av.device,
                          eligible=_use_scattered(av, _SCATTERED_NB))


def _getrf_partial(av, nb: int, raw_method=MethodLU.Auto):
    """The PartialPiv dispatch.  With ``SLATE_TPU_TORCH_ABFT`` on, square
    real operands go through the ABFT layer
    (:func:`slate_tpu_torch.resilience.abft.getrf_guarded`: the
    checksum-carried loop in place of the recursion, the checksum
    envelope around the scattered driver); off, this is one environment
    read and :func:`_getrf_partial_impl`."""
    from ..resilience import abft as _abft

    if _abft.eligible(av):
        return _abft.getrf_guarded(av, nb, raw_method)
    return _getrf_partial_impl(av, nb, raw_method)


def _getrf_partial_impl(av, nb: int, raw_method=MethodLU.Auto):
    """The PartialPiv drivers behind the ``ooc`` gate
    (``slate_tpu/linalg/lu.py:862-871``): the out-of-core driver
    :func:`slate_tpu_torch.linalg.ooc.getrf_ooc` where the ``ooc`` site
    answers ``"pool"`` (same ``(lu, perm)`` contract, tile edge
    ``SLATE_TPU_TORCH_OOC_NB``), else :func:`_getrf_incore`."""
    from . import ooc as _ooc

    if _ooc.choose(av) == "pool":
        return _ooc.getrf_ooc(av)
    return _getrf_incore(av, nb, raw_method)


def _getrf_incore(av, nb: int, raw_method=MethodLU.Auto):
    """The in-core PartialPiv drivers in the JAX package's order
    (``slate_tpu/linalg/lu.py:874-894``): the scattered driver where the
    ``lu_driver`` site picks it; else, for matrices taller than
    :data:`_MAX_LU_PANEL_ROWS`, the tall-panel loop (true partial
    pivoting under an explicit ``MethodLU.PartialPiv``, the tournament
    under ``Auto``); else the blocked recursion.  Also what the
    out-of-core driver's panel factor calls
    (:func:`slate_tpu_torch.linalg.ooc._panel_lu`), which must never
    re-enter the ``ooc`` gate (a forced pool would recurse)."""
    if _choose_lu_driver(av) == "scattered":
        return getrf_scattered(av, _SCATTERED_NB)
    if av.ndim == 2 and av.shape[0] > _MAX_LU_PANEL_ROWS:
        tall = "pp" if raw_method is MethodLU.PartialPiv else "tournament"
        return getrf_panels(av, max(nb, 512), tall_panel=tall)
    return getrf_rec(av, nb)


@instrument_driver("getrf")
def getrf(a, opts: Optional[Options] = None, *, device=None):
    """LU factorization with partial pivoting (reference ``slate::getrf``).
    Returns ``(LU, perm)`` with ``A[perm] = L·U``, LU packed in one
    matrix and perm an int64 tensor.  ``Option.MethodLU`` picks
    PartialPiv (the default), CALU (tournament pivots,
    :func:`getrf_tntpiv`) or NoPiv."""
    dev = _device_of(a, device=device)
    av = _arr(a, dev)
    nb = _nb(a, opts)
    raw_method = get_option(opts, "method_lu", MethodLU.Auto)
    method = select_lu(raw_method)
    if method is MethodLU.NoPiv:
        lu = getrf_nopiv_rec(av, nb, int(get_option(opts, "inner_blocking")))
        perm = torch.arange(av.shape[0], device=av.device)
    elif method is MethodLU.CALU:
        lu, perm = _getrf_calu(av, nb)
    elif method is MethodLU.PartialPiv:
        lu, perm = _getrf_partial(av, nb, raw_method)
    else:
        raise NotImplementedError(f"MethodLU.{method.name} is not "
                                  "implemented (supported: PartialPiv, "
                                  "CALU, NoPiv)")
    return _wrap_like(a, lu), perm


def _getrf_calu(av, nb: int):
    """The blocked recursion over the tournament panel
    :func:`_panel_lu_tntpiv`: ``(LU, perm)`` of a bare tensor."""
    return getrf_rec(av, nb, panel=lambda p: _panel_lu_tntpiv(p, nb))


def getrf_tntpiv(a, opts: Optional[Options] = None, *, device=None):
    """CALU tournament-pivot LU — reference ``slate::getrf_tntpiv``
    (``src/getrf_tntpiv.cc``): the blocked recursion over
    :func:`_panel_lu_tntpiv`.  Returns ``(LU, perm)`` as :func:`getrf`."""
    dev = _device_of(a, device=device)
    av = _arr(a, dev)
    lu, perm = _getrf_calu(av, _nb(a, opts))
    return _wrap_like(a, lu), perm


def getrf_nopiv_rec(a, nb: int, ib: int = 128):
    """Blocked right-looking LU without pivoting."""
    m, n = a.shape
    if m < n:
        f_l = getrf_nopiv_rec(a[:, :m], nb, ib)
        u_r = torch.linalg.solve_triangular(f_l, a[:, m:], upper=False,
                                            unitriangular=True)
        return torch.cat([f_l, u_r], dim=1)
    if n <= nb:
        return _panel_lu_nopiv(a, ib)
    n1 = blocks._split(n, nb)
    f1 = getrf_nopiv_rec(a[:, :n1], nb, ib)
    u12 = torch.linalg.solve_triangular(f1[:n1], a[:n1, n1:], upper=False,
                                        unitriangular=True)
    f2 = getrf_nopiv_rec(a[n1:, n1:] - matmul(f1[n1:], u12), nb, ib)
    top = torch.cat([f1[:n1], u12], dim=1)
    bot = torch.cat([f1[n1:], f2], dim=1)
    return torch.cat([top, bot], dim=0)


def getrf_nopiv(a, opts: Optional[Options] = None, *, device=None):
    """Reference ``slate::getrf_nopiv``.  ``Option.InnerBlocking`` sets
    the unblocked panel width."""
    dev = _device_of(a, device=device)
    ib = int(get_option(opts, "inner_blocking"))
    return _wrap_like(a, getrf_nopiv_rec(_arr(a, dev), _nb(a, opts), ib))


# ---------------------------------------------------------------------------
# Solves / inverse
# ---------------------------------------------------------------------------

def _lu_solve(luv, perm, bv, nb: int):
    """permuteRows → trsm(L, unit) → trsm(U) (reference ``src/getrs.cc``)."""
    y = blocks.trsm_rec(Side.Left, Uplo.Lower, Diag.Unit, luv, bv[perm], nb)
    return blocks.trsm_rec(Side.Left, Uplo.Upper, Diag.NonUnit, luv, y, nb)


@instrument_driver("getrs")
def getrs(lu, perm, b, op: Op = Op.NoTrans, opts: Optional[Options] = None,
          *, device=None):
    """Solve op(A)·X = B from the LU factor (reference ``slate::getrs``)."""
    dev = _device_of(lu, b, device=device)
    luv, bv = _arr(lu, dev), _arr(b, dev)
    perm = torch.as_tensor(perm, device=dev).long()
    nb = _nb(lu, opts)
    if op is Op.NoTrans:
        x = _lu_solve(luv, perm, bv, nb)
    else:
        # op(A) = Uᵗ·Lᵗ·P (A[perm] = LU): Uᵗ y = B, Lᵗ w = y, x = Pᵗ w
        t = luv.mT if op is Op.Trans else luv.mH
        y = blocks.trsm_rec(Side.Left, Uplo.Lower, Diag.NonUnit, t, bv, nb)
        w = blocks.trsm_rec(Side.Left, Uplo.Upper, Diag.Unit, t, y, nb)
        x = torch.empty_like(w)
        x[perm] = w
    return _wrap_like(b, x)


@instrument_driver("gesv")
def gesv(a, b, opts: Optional[Options] = None, *, device=None):
    """Factor + solve (reference ``slate::gesv``).  Returns
    ``(lu, perm, x)``."""
    dev = _device_of(a, device=device)
    lu, perm = getrf(a, opts, device=dev)
    x = getrs(lu, perm, b, opts=opts, device=dev)
    return lu, perm, x


@instrument_driver("getri")
def getri(lu, perm, opts: Optional[Options] = None, *, device=None):
    """Matrix inverse from the LU factor (reference ``slate::getri``):
    A⁻¹ = U⁻¹·L⁻¹·P, two triangular inverses, one product and a column
    gather."""
    dev = _device_of(lu, device=device)
    luv = _arr(lu, dev)
    n = luv.shape[-1]
    nb = _nb(lu, opts)
    uinv = blocks.trtri_rec(Uplo.Upper, Diag.NonUnit, luv, nb)
    linv = blocks.trtri_rec(Uplo.Lower, Diag.Unit, luv, nb)
    linv = torch.tril(linv, -1) + torch.eye(n, dtype=luv.dtype,
                                            device=luv.device)
    prod = matmul(torch.triu(uinv), linv)
    perm = torch.as_tensor(perm, device=dev).long()
    return _wrap_like(lu, prod[:, inverse_perm(perm)])


def getrs_nopiv(lu, b, op: Op = Op.NoTrans, opts: Optional[Options] = None,
                *, device=None):
    """Solve from a no-pivot factor (reference ``slate::getrs_nopiv``)."""
    dev = _device_of(lu, b, device=device)
    n = _arr(lu, dev).shape[-1]
    return getrs(lu, torch.arange(n, device=dev), b, op=op, opts=opts,
                 device=dev)


def gesv_nopiv(a, b, opts: Optional[Options] = None, *, device=None):
    """Factor without pivoting + solve (reference ``slate::gesv_nopiv``);
    stable only for diagonally dominant or well-conditioned systems.
    Returns ``(lu, x)``."""
    dev = _device_of(a, device=device)
    lu = getrf_nopiv(a, opts, device=dev)
    return lu, getrs_nopiv(lu, b, opts=opts, device=dev)


# ---------------------------------------------------------------------------
# Mixed precision + iterative refinement (gesv_mixed / gesv_mixed_gmres)
# ---------------------------------------------------------------------------

def _getrf_lo(av, lo, nb, anorm):
    """Low-precision LU leg of the mixed drivers: ``getrf_rec`` of ``av``
    in ``lo`` (fp32: its panels through the ``lu_panel`` site, the
    ``getrf_panel_linv`` kernel on the card, its products through the
    ``matmul`` site).  Where :func:`~._refine.use_split_leg` says so it
    factors ONCE under :func:`~._refine.split_factor_leg` (every product
    a bf16x3 split), then a Higham–Tisseur probe of the fresh factor
    demotes to the stock fp32 factor where κ(A)·n·ε₃₂ passes 0.25.  The
    JAX package's branch calls itself instead of factoring
    (``slate_tpu/linalg/lu.py:1027-1044``) and never ends; this one
    factors once, twice when demoted."""
    from ._refine import note_split_leg, split_factor_leg, use_split_leg

    a_lo = av.to(lo)
    if not use_split_leg(lo, av.device):
        return getrf_rec(a_lo, nb)
    from .condest import refine_kappa_eps

    with split_factor_leg():
        lu_lo, perm = getrf_rec(a_lo, nb)
    dev = lu_lo.device
    ke = refine_kappa_eps(
        lambda v: getrs(lu_lo, perm, v.to(dev), device=dev),
        lambda v: getrs(lu_lo, perm, v.to(dev), op=Op.ConjTrans, device=dev),
        av.shape[-1], anorm, lo)
    if note_split_leg("gesv_mixed", ke):
        return getrf_rec(a_lo, nb)
    return lu_lo, perm


def _gesv_mixed_setup(a, b, opts, tol, device):
    import math

    from .norms import norm as _norm
    from ._refine import lo_dtype

    dev = _device_of(a, b, device=device)
    av, bv = _arr(a, dev), _arr(b, dev)
    n = av.shape[-1]
    nb = _nb(a, opts)
    itermax = int(get_option(opts, "max_iterations", 30))
    use_fallback = bool(get_option(opts, "use_fallback_solver", True))
    eps = torch.finfo(av.dtype).eps
    # reference stopping criterion: ||r||∞ ≤ ||x||∞ · ||A||∞ · ε · √n
    anorm = _norm(Norm.Inf, av, device=dev)
    thresh = float(tol) if tol is not None else float(eps) * math.sqrt(n)
    lo = lo_dtype(av.dtype)
    lu_lo, perm = _getrf_lo(av, lo, nb, anorm)

    def solve_lo(r):
        return _lu_solve(lu_lo, perm, r.to(lo), nb).to(av.dtype)

    full = []                      # lazily factored, shared by columns

    def solve_full(bv2):
        # full-precision fallback (reference gesv_mixed.cc); the refine
        # cores always pass a 2-D block
        if not full:
            full.append(getrf_rec(av, nb))
        return _lu_solve(full[0][0], full[0][1], bv2, nb)

    return av, bv, dict(anorm=anorm, thresh=thresh, itermax=itermax,
                        use_fallback=use_fallback), solve_lo, solve_full


def gesv_mixed(a, b, opts: Optional[Options] = None, *, tol=None,
               return_info: bool = False, device=None):
    """Mixed-precision LU solve with iterative refinement — reference
    ``slate::gesv_mixed``: factor in low precision (fp32), refine the
    residual in working precision, fall back to a full-precision factor
    if refinement stalls (``Option.UseFallbackSolver``).  Returns
    ``(x, iters)``; ``iters < 0`` flags the fallback."""
    from ._refine import ir_refine

    av, bv, kw, solve_lo, solve_full = _gesv_mixed_setup(a, b, opts, tol,
                                                         device)
    x, iters = ir_refine(av, bv, solve_lo, solve_full, **kw)
    return _wrap_like(b, x), iters


def gesv_mixed_gmres(a, b, opts: Optional[Options] = None, *, tol=None,
                     restart: int = 30, device=None):
    """GMRES-IR: FGMRES in working precision, left-preconditioned by the
    low-precision LU solve — reference ``slate::gesv_mixed_gmres``
    (itermax 30, fallback on stagnation; one right-hand side per GMRES
    sequence).  Returns ``(x, iters)``."""
    from ._refine import fgmres_refine

    av, bv, kw, precond, solve_full = _gesv_mixed_setup(a, b, opts, tol,
                                                        device)
    x, iters = fgmres_refine(av, bv, precond, solve_full, restart=restart,
                             **kw)
    return _wrap_like(b, x), iters


#: Deprecated camel-case alias kept by the reference (slate.hh).
gesvMixed = gesv_mixed
