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
``getrf_rec`` and refine in the working precision
(:mod:`slate_tpu_torch.linalg._refine`).

Not ported yet, each queued in ROADMAP.md: CALU (``_panel_lu_tntpiv``,
``getrf_tntpiv``), the tall-panel loop (``getrf_panels``,
``_tall_panel_lu*``), the split-precision leg of the mixed drivers and
the ABFT and out-of-core branches.
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


def _getrf_partial(av, nb: int):
    """The PartialPiv dispatch: the scattered driver or the blocked
    recursion, as the ``lu_driver`` site decides.  The JAX package wraps
    this in an ABFT envelope (off by default) and an out-of-core gate
    (``_getrf_partial_impl``, ``_getrf_incore``), both queued in
    ROADMAP.md.  It also sends matrices taller than 8192 rows to a
    tall-panel loop (tournament pivots under Auto) because XLA's fused
    LU overflows v5e scoped VMEM there; the recursion here takes those
    shapes with true partial pivoting."""
    if _choose_lu_driver(av) == "scattered":
        return getrf_scattered(av, _SCATTERED_NB)
    return getrf_rec(av, nb)


@instrument_driver("getrf")
def getrf(a, opts: Optional[Options] = None, *, device=None):
    """LU factorization with partial pivoting (reference ``slate::getrf``).
    Returns ``(LU, perm)`` with ``A[perm] = L·U``, LU packed in one
    matrix and perm an int64 tensor.  ``Option.MethodLU`` picks
    PartialPiv (the default) or NoPiv; CALU is not ported yet."""
    dev = _device_of(a, device=device)
    av = _arr(a, dev)
    nb = _nb(a, opts)
    method = select_lu(get_option(opts, "method_lu", MethodLU.Auto))
    if method is MethodLU.NoPiv:
        lu = getrf_nopiv_rec(av, nb, int(get_option(opts, "inner_blocking")))
        perm = torch.arange(av.shape[0], device=av.device)
    elif method is MethodLU.PartialPiv:
        lu, perm = _getrf_partial(av, nb)
    else:
        raise NotImplementedError(
            f"MethodLU.{method.name} is not ported yet (supported: "
            "PartialPiv, NoPiv; CALU is queued in ROADMAP.md)")
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
    ``matmul`` site).  The JAX package's split leg (bf16x3 products and
    a κ·ε probe) waits for ``ops/split_gemm.py``; ``use_split_leg``
    raises where the knob forces it."""
    from ._refine import use_split_leg

    use_split_leg(lo)
    return getrf_rec(av.to(lo), nb)


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
