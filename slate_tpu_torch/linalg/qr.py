"""QR / LQ family: geqrf, gelqf, unmqr, unmlq, ungqr, gels, cholqr — the
counterpart of ``slate_tpu/linalg/qr.py`` (reference ``src/geqrf.cc``,
``gelqf.cc``, ``unmqr.cc``, ``unmlq.cc``, ``gels.cc``, ``gels_qr.cc``,
``gels_cholqr.cc``, ``cholqr.cc``).

Compact-WY throughout, as in the JAX package: a panel's reflector chain
is I − V·T·Vᴴ, with T from the closed form T⁻¹ = strict_upper(VᴴV) +
diag(1/τ).  Factors are LAPACK-packed (V unit lower below the diagonal,
R on and above, Q = H₀·H₁⋯), so a factor made by one package is applied
by the other's ``unmqr``/``ungqr`` (the packed factor through
:func:`slate_tpu_torch.interop.matrix_from_numpy`, τ as a tensor).

fp32 ``geqrf`` under ``Auto`` asks the ``geqrf_panel`` site, which
answers ``"cholqr2"``: :func:`geqrf_panels`, whose 512-wide panels are
shifted CholQR² with the Householder reconstruction, three kernels per
panel (``chol_inv_panel`` twice, ``lu_inv_panel`` and ``trtri_panel``
once) and its products through the ``matmul`` site.  The explicit-nb recursion
(:func:`geqrf_rec`, also under ``gels_qr``, ``gelqf`` and the
conditioning guard's rerun) has a Householder panel leaf that is not a
Pallas kernel in the JAX package (an XLA column loop there): here it is
``torch.geqrf``.

``gels_mixed`` factors in fp32 through :func:`geqrf_rec` and refines
the semi-normal equations in the working precision
(:mod:`slate_tpu_torch.linalg._refine`); its split-precision leg waits
for ``ops/split_gemm.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..enums import Diag, MethodGels, Op, Side, Uplo
from ..method import select_backend, select_gels
from ..ops import blocks, kernels
from ..ops.blocks import _ct, matmul, matmul_hi
from ..ops.tile_ops import hermitize
from ..options import Options, get_option
from ..perf import metrics
from ..perf.metrics import instrument_driver
from .blas3 import _arr, _device_of, _nb, _wrap_like


def _reject_complex_trans(a, op: Op):
    """LAPACK/SLATE reject plain Trans for complex unmqr/unmlq — Qᵀ is
    not expressible from the stored reflectors without extra conjugation."""
    if op is Op.Trans and a.is_complex():
        from ..exceptions import SlateError
        raise SlateError("Op.Trans with a complex factor is unsupported "
                         "(use Op.ConjTrans), matching LAPACK unmqr/unmlq")


def _unit_lower(packed, k: int):
    """The unit-lower-trapezoid V (m×k) of a packed QR factor."""
    m = packed.shape[0]
    return torch.tril(packed[:, :k], -1) + torch.eye(
        m, k, dtype=packed.dtype, device=packed.device)


def larft_rec(v, tau):
    """Forward column-wise compact-WY T: H₀⋯H_{k−1} = I − V·T·Vᴴ, from
    the closed form T⁻¹ = strict_upper(VᴴV) + diag(1/τ) (one Gram product
    and one triangular inverse).  Columns with τⱼ = 0 (Hⱼ = I) get a zero
    row in T⁻¹'s strict upper part and a zero column in T, as ``dlarft``."""
    k = v.shape[1]
    dt = v.dtype
    if k == 1:
        return tau.reshape(1, 1).to(dt)
    s = matmul(_ct(v), v)                      # Gram matrix VᴴV
    zero = tau == 0
    safe_tau = torch.where(zero, torch.ones_like(tau), tau)
    zero_dt = torch.zeros((), dtype=dt, device=v.device)
    su = torch.where(zero[:, None], zero_dt, torch.triu(s, 1))
    tinv = su + torch.diag(1.0 / safe_tau).to(dt)
    t = blocks.trtri_rec(Uplo.Upper, Diag.NonUnit, tinv, max(32, k // 8))
    return torch.where(zero[None, :], zero_dt, torch.triu(t))


def _apply_block_reflector(v, t, c, *, forward: bool, hi: bool = False):
    """C ← (I − V·T·Vᴴ)·C if forward else (I − V·Tᴴ·Vᴴ)·C — LAPACK
    ``larfb`` (Left; callers handle the Right side by transposition).
    ``hi`` sends the three products to :func:`matmul_hi` (the eig
    back-transforms)."""
    mm = matmul_hi if hi else matmul
    tt = t if forward else _ct(t)
    return c - mm(v, mm(tt, mm(_ct(v), c)))


def apply_reflector_chain(vts, cv, forward: bool):
    """Apply a chain of tail-aligned block reflectors: each (V, T) panel
    spans the last ``V.shape[0]`` rows of C.  ``forward`` applies Q
    (panels last-to-first), else Qᴴ.  The counterpart of
    ``slate_tpu/linalg/qr.py:111-137``, whose products are pinned to an
    XLA dot at ``Precision.HIGHEST`` rather than its kernel: here they go
    to :func:`matmul_hi` (``torch.matmul``, full fp32 with TF32 off).
    Returns a new tensor."""
    n = cv.shape[0]
    out = cv.clone()
    for v, t in (vts[::-1] if forward else vts):
        r0 = n - v.shape[0]
        out[r0:] = _apply_block_reflector(v, t, out[r0:], forward=forward,
                                          hi=True)
    return out


# ---------------------------------------------------------------------------
# Factorizations
# ---------------------------------------------------------------------------

def _panel_geqrf(a):
    """Householder panel: returns ``(packed, taus)`` with LAPACK
    ``geqrf`` semantics, Hⱼ = I − τⱼ·vⱼ·vⱼᴴ, vⱼ[j] = 1, real β.

    Runs ``torch.geqrf`` (LAPACK on the CPU, cuSOLVER or MAGMA on the
    card).  Its ``larfg`` has the JAX package's conventions (β =
    −sign(Re α)·‖x‖, τ = (β − α)/β) but one: where the column below the
    diagonal is zero and α is not, LAPACK takes Hⱼ = I (τ = 0) and the JAX
    column loop reflects (τ = 2, β = −α, row j negated from column j on).
    That reflection is applied here, with no host read, so both packages
    return the same factor."""
    f, tau = torch.geqrf(a)
    k = tau.shape[0]
    flip = (tau == 0) & (torch.diagonal(f) != 0)
    upper = torch.ones((k, a.shape[1]), dtype=torch.bool,
                       device=a.device).triu_()
    f[:k] = torch.where(upper & flip[:, None], -f[:k], f[:k])
    return f, torch.where(flip, torch.full_like(tau, 2), tau)


def geqrf_rec(a, nb: int):
    """Blocked Householder QR: returns ``(packed, taus)`` LAPACK-style —
    the recursive equivalent of the reference driver loop
    ``src/geqrf.cc:196-277`` (panel geqrf, then the larfb trailing
    update)."""
    m, n = a.shape
    k = min(m, n)
    if n <= nb or m == 1:
        return _panel_geqrf(a)
    if k < n:  # wide: factor the left square part, apply Qᴴ to the rest
        f1, tau = geqrf_rec(a[:, :k], nb)
        v = _unit_lower(f1, k)
        t = larft_rec(v, tau)
        right = _apply_block_reflector(v, t, a[:, k:], forward=False)
        return torch.cat([f1, right], dim=1), tau
    n1 = blocks._split(n, nb)
    f1, tau1 = geqrf_rec(a[:, :n1], nb)
    v1 = _unit_lower(f1, n1)
    t1 = larft_rec(v1, tau1)
    # trailing update: Qᴴ·A_right = A_right − V·Tᴴ·(Vᴴ·A_right)
    c = _apply_block_reflector(v1, t1, a[:, n1:], forward=False)
    f2, tau2 = geqrf_rec(c[n1:], nb)
    top = torch.cat([f1[:n1], c[:n1]], dim=1)
    bot = torch.cat([f1[n1:], f2], dim=1)
    return torch.cat([top, bot], dim=0), torch.cat([tau1, tau2])


def _cholqr2(pan):
    """Shifted CholQR twice on a tall fp32 panel: ``(q, r, dev)`` with
    pan = q·r, r upper, and ``dev`` the first pass's departure from
    orthogonality, max(max|g₂ − I|, 1 − min diag(L₂)).  The tiny shift
    before the first Cholesky keeps the Gram factorization well posed
    for ill-conditioned panels (pan = q·r holds for any shift; the second
    pass restores orthogonality while dev < 1).  The two Gram products
    are full fp32 (``matmul_hi``); the other products go through the
    ``matmul`` site."""
    w = pan.shape[1]
    eye = torch.eye(w, dtype=pan.dtype, device=pan.device)
    gram = matmul_hi(_ct(pan), pan)
    eps = torch.finfo(pan.dtype).eps
    shift = (100.0 * w) * eps * torch.diagonal(gram).max()
    l1, l1inv = kernels.chol_inv_panel(gram + shift * eye)
    q = matmul(pan, _ct(l1inv))
    g2 = matmul_hi(_ct(q), q)
    l2, l2inv = kernels.chol_inv_panel(g2)
    # the elementwise max|g₂ − I| misses a spread near-null direction;
    # one eigenvalue collapsing drags min(diag(L₂)) toward √λ_min
    dev = torch.maximum((g2 - eye).abs().max(),
                        1.0 - torch.diagonal(l2).min())
    q = matmul(q, _ct(l2inv))
    r = _ct(matmul(l1, l2))
    return q, r, dev


def _householder_b(q):
    """``(s, B)`` with s = −sign(diag Q) and B = Q − [diag(s); 0], in
    place on ``q``: the block whose no-pivot LU gives the Householder
    vectors."""
    w = q.shape[1]
    s = torch.where(torch.diagonal(q[:w]) >= 0, -1.0, 1.0).to(q.dtype)
    q[:w].diagonal().sub_(s)
    return s, q


def _cholqr2_panel(pan):
    """Panel QR via shifted CholQR² and the Householder reconstruction
    (Ballard et al., "Reconstructing Householder Vectors from TSQR"):
    returns ``(y, rprime, tau, tmat, dev)`` with pan = (I − Y·T·Yᵀ)·R′
    (Y unit lower trapezoid, R′ = diag(s)·R upper, τᵢ = −sᵢ·Uᵢᵢ from the
    no-pivot LU of Q − [diag(s); 0], s = −sign(diag Q), whose diagonal
    has magnitude ≥ 1, so it needs no pivoting).  fp32, panel width a
    power of two ≥ 32; ``dev`` as in :func:`_cholqr2`."""
    w = pan.shape[1]
    q, r, dev = _cholqr2(pan)
    s, b = _householder_b(q)
    lu, _, uinv = kernels.lu_inv_panel(b[:w])
    ytop = torch.tril(lu, -1) + torch.eye(w, dtype=pan.dtype, device=pan.device)
    y = torch.cat([ytop, matmul(b[w:], uinv)], dim=0)
    tau = -s * torch.diagonal(lu)
    rprime = s[:, None] * r
    tinv = torch.triu(matmul(_ct(y), y), 1) + torch.diag(1.0 / tau)
    # T is upper: invert the lower triangle flip(T⁻¹) and flip back
    tmat = torch.triu(torch.flip(kernels.trtri_panel(torch.flip(tinv, (0, 1))),
                                 (0, 1)))
    return y, rprime, tau, tmat, dev


def _geqrf_panels_core(a, nb: int, use_cholqr: bool):
    """One pass of the blocked Householder loop on a private copy of
    ``a``, updated in place.  ``use_cholqr`` picks the panel: CholQR² for
    full-width power-of-two fp32 panels at least 2·nb tall (CholQR² wants
    a tall panel: a square one is as ill-conditioned as the matrix),
    else :func:`_panel_geqrf`.  Returns ``(packed, taus, devmax,
    any_cholqr)``, ``devmax`` the largest CholQR² departure (a tensor; 0
    when no panel took CholQR², 2 for a non-finite one)."""
    m, n = a.shape
    k = min(m, n)
    a = a.clone(memory_format=torch.contiguous_format)
    taus = []
    devmax = torch.zeros((), dtype=torch.float32, device=a.device)
    any_cholqr = False
    for k0 in range(0, k, nb):
        w = min(nb, k - k0)
        pan = a[k0:, k0:k0 + w]
        if use_cholqr and w == nb and (nb & (nb - 1)) == 0 and nb >= 32 \
                and pan.shape[0] >= 2 * nb and a.dtype == torch.float32:
            y, rp, tau, tmat, dev = _cholqr2_panel(pan)
            pan[:w] = rp + torch.tril(y[:w], -1)
            pan[w:] = y[w:]
            devmax = torch.maximum(devmax, torch.where(
                torch.isfinite(dev), dev, torch.full_like(dev, 2.0)))
            any_cholqr = True
        else:
            f, tau = _panel_geqrf(pan)
            y = _unit_lower(f, w)
            tmat = larft_rec(y, tau)
            pan.copy_(f)
        taus.append(tau)
        if k0 + w < n:
            c = a[k0:, k0 + w:]
            c -= matmul(y, matmul(_ct(tmat), matmul(_ct(y), c)))
    return a, torch.cat(taus), devmax, any_cholqr


def geqrf_panels(a, nb: int = 512):
    """Loop-based blocked Householder QR whose panel step is
    :func:`_cholqr2_panel`: returns ``(packed, taus)`` in exact LAPACK
    form.  Ragged, short or non-power-of-two panels take the Householder
    panel.

    Conditioning guard: CholQR² loses orthogonality once the first-pass
    Gram departure nears 1 (cond(panel) ≳ 1/√ε ≈ 3e3 in fp32).  The
    departure is aggregated over the panels and read on the host ONCE
    per call (one ``.item()``, the only host read of this path); at
    ``devmax ≥ 0.25`` the whole loop reruns with Householder panels, as
    the JAX package's one ``lax.cond`` does.  With metrics on, the gauge
    ``qr.cholqr2.devmax`` holds the last call's departure and the
    counter ``qr.cholqr2.reruns`` counts the reruns."""
    fast, taus, devmax, any_cholqr = _geqrf_panels_core(a, nb, True)
    if not any_cholqr:          # no panel used CholQR²: nothing to guard
        return fast, taus
    dm = devmax.item()
    metrics.set_gauge("qr.cholqr2.devmax", dm)
    if dm < 0.25:
        return fast, taus
    metrics.inc("qr.cholqr2.reruns")
    f2, t2, _, _ = _geqrf_panels_core(a, nb, False)
    return f2, t2


@instrument_driver("geqrf")
def geqrf(a, opts: Optional[Options] = None, *, device=None):
    """QR factorization — reference ``slate::geqrf`` (``src/geqrf.cc``).
    Returns ``(packed, taus)`` with R on and above the diagonal and the
    Householder V below (unit lower).

    Under ``method_factor`` Auto, fp32 2-D input asks the ``geqrf_panel``
    site: ``"cholqr2"`` is :func:`geqrf_panels` (512-wide panels for
    nb ≤ 256), ``"stock"`` is ``torch.geqrf``; other dtypes take
    ``torch.geqrf``.  An explicit method runs the nb recursion
    :func:`geqrf_rec`."""
    dev = _device_of(a, device=device)
    av = _arr(a, dev)
    method = get_option(opts, "method_factor", "auto")
    nb = _nb(a, opts)
    nbsel = 512 if nb <= 256 else nb
    if method == "auto" and av.dtype == torch.float32 and av.ndim == 2 \
            and select_backend("geqrf_panel", m=int(av.shape[0]),
                               n=int(av.shape[1]), nb=nbsel, dtype=av.dtype,
                               device=av.device) == "cholqr2":
        packed, taus = geqrf_panels(av, nbsel)
    elif method == "auto":
        packed, taus = torch.geqrf(av)
    else:
        packed, taus = geqrf_rec(av, nb)
    return _wrap_like(a, packed), taus


def gelqf(a, opts: Optional[Options] = None, *, device=None):
    """LQ factorization — reference ``slate::gelqf`` (``src/gelqf.cc``),
    as the adjoint of the QR of Aᴴ: packed holds L on and below the
    diagonal and Vᴴ above (LAPACK ``gelqf`` layout).  Returns
    ``(packed, taus)``."""
    dev = _device_of(a, device=device)
    av = _arr(a, dev)
    f, taus = geqrf_rec(_ct(av).resolve_conj(), _nb(a, opts))
    return _wrap_like(a, _ct(f).resolve_conj().contiguous()), taus


# ---------------------------------------------------------------------------
# Q application / generation
# ---------------------------------------------------------------------------

def unmqr_rec(packed, taus, c, side: Side, op: Op, nb: int):
    """Apply Q (or Qᴴ) from a packed QR factor — reference
    ``slate::unmqr`` (``src/unmqr.cc``), a blocked larfb chain: splitting
    the chain Q = Q₁·Q₂ gives the four side/op orders, Q₂ acting as the
    identity on the first k₁ rows/columns."""
    k = taus.shape[0]
    if k <= nb:
        v = _unit_lower(packed, k)
        t = larft_rec(v, taus)
        if side is Side.Left:
            return _apply_block_reflector(v, t, c, forward=op is Op.NoTrans)
        # Right: C·(I − V·T·Vᴴ) = C − ((C·V)·T)·Vᴴ
        tt = t if op is Op.NoTrans else _ct(t)
        return c - matmul(matmul(matmul(c, v), tt), _ct(v))
    k1 = blocks._split(k, nb)
    p1, tau1 = packed[:, :k1], taus[:k1]
    p2, tau2 = packed[k1:, k1:], taus[k1:]
    if side is Side.Left:
        if op is Op.NoTrans:       # Q·C = Q₁·(Q₂·C)
            c2 = unmqr_rec(p2, tau2, c[k1:], side, op, nb)
            c = torch.cat([c[:k1], c2], dim=0)
            return unmqr_rec(p1, tau1, c, side, op, nb)
        c = unmqr_rec(p1, tau1, c, side, op, nb)     # Qᴴ·C = Q₂ᴴ·(Q₁ᴴ·C)
        c2 = unmqr_rec(p2, tau2, c[k1:], side, op, nb)
        return torch.cat([c[:k1], c2], dim=0)
    if op is Op.NoTrans:           # C·Q = (C·Q₁)·Q₂
        c = unmqr_rec(p1, tau1, c, side, op, nb)
        c2 = unmqr_rec(p2, tau2, c[:, k1:], side, op, nb)
        return torch.cat([c[:, :k1], c2], dim=1)
    c2 = unmqr_rec(p2, tau2, c[:, k1:], side, op, nb)   # C·Qᴴ = (C·Q₂ᴴ)·Q₁ᴴ
    c = torch.cat([c[:, :k1], c2], dim=1)
    return unmqr_rec(p1, tau1, c, side, op, nb)


def unmqr(side: Side, op: Op, a_factor, taus, c,
          opts: Optional[Options] = None, *, device=None):
    """Reference ``slate::unmqr``: C ← op(Q)·C or C·op(Q)."""
    dev = _device_of(a_factor, c, device=device)
    av, cv, tv = _arr(a_factor, dev), _arr(c, dev), _arr(taus, dev)
    _reject_complex_trans(av, op)
    out = unmqr_rec(av, tv, cv, side, op, _nb(a_factor, opts))
    return _wrap_like(c, out)


def unmlq(side: Side, op: Op, a_factor, taus, c,
          opts: Optional[Options] = None, *, device=None):
    """Apply the LQ's Q — reference ``slate::unmlq`` (``src/unmlq.cc``).
    With Q_lq = Q̃ᴴ of the underlying QR of Aᴴ, applying Q_lq is applying
    Q̃ with the opposite op."""
    dev = _device_of(a_factor, c, device=device)
    av, cv, tv = _arr(a_factor, dev), _arr(c, dev), _arr(taus, dev)
    _reject_complex_trans(av, op)
    packed = _ct(av).resolve_conj()            # back to QR-of-Aᴴ layout
    flip = {Op.NoTrans: Op.ConjTrans if cv.is_complex() else Op.Trans,
            Op.Trans: Op.NoTrans, Op.ConjTrans: Op.NoTrans}
    out = unmqr_rec(packed, tv, cv, side, flip[op], _nb(a_factor, opts))
    return _wrap_like(c, out)


def ungqr(a_factor, taus, n_cols: Optional[int] = None,
          opts: Optional[Options] = None, *, device=None):
    """The explicit Q, its first ``n_cols`` columns (default k) — LAPACK
    ``ungqr`` (the reference applies ``unmqr`` to the identity)."""
    dev = _device_of(a_factor, device=device)
    av, tv = _arr(a_factor, dev), _arr(taus, dev)
    m = av.shape[0]
    n_cols = tv.shape[0] if n_cols is None else n_cols
    eye = torch.eye(m, n_cols, dtype=av.dtype, device=dev)
    return unmqr_rec(av, tv, eye, Side.Left, Op.NoTrans, _nb(a_factor, opts))


# ---------------------------------------------------------------------------
# Least squares
# ---------------------------------------------------------------------------

def gels_qr(a, b, opts: Optional[Options] = None, *, device=None):
    """Least squares via QR — reference ``slate::gels_qr``
    (``src/gels_qr.cc``): minimum residual for m ≥ n, minimum norm via
    LQ for m < n.  Runs :func:`geqrf_rec`."""
    dev = _device_of(a, b, device=device)
    av, bv = _arr(a, dev), _arr(b, dev)
    nb = _nb(a, opts)
    m, n = av.shape
    squeeze = bv.ndim == 1
    if squeeze:
        bv = bv[:, None]
    if m >= n:
        f, taus = geqrf_rec(av, nb)
        c = unmqr_rec(f, taus, bv, Side.Left,
                      Op.ConjTrans if av.is_complex() else Op.Trans, nb)
        x = blocks.trsm_rec(Side.Left, Uplo.Upper, Diag.NonUnit,
                            f[:n], c[:n], nb)
    else:
        # minimum norm: A = L·Q, x = Qᴴ·[L⁻¹b; 0]
        f, taus = geqrf_rec(_ct(av).resolve_conj(), nb)   # QR of Aᴴ (n×m)
        l = _ct(torch.triu(f[:m]))                       # L = R̃ᴴ (m×m lower)
        y = blocks.trsm_rec(Side.Left, Uplo.Lower, Diag.NonUnit, l, bv, nb)
        z = torch.cat([y, torch.zeros((n - m, bv.shape[1]), dtype=av.dtype,
                                      device=dev)], dim=0)
        x = unmqr_rec(f, taus, z, Side.Left, Op.NoTrans, nb)
    if squeeze:
        x = x[:, 0]
    return _wrap_like(b, x)


def cholqr(a, opts: Optional[Options] = None, *,
           device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cholesky QR — reference ``slate::cholqr`` (``src/cholqr.cc``):
    R = chol(AᴴA)ᴴ (upper), Q = A·R⁻¹: one herk, one potrf, one trsm.
    Returns ``(Q, R)``."""
    dev = _device_of(a, device=device)
    av = _arr(a, dev)
    nb = _nb(a, opts)
    n = av.shape[1]
    gram = blocks.herk_rec(Uplo.Lower, 1.0, _ct(av), 0.0,
                           torch.zeros((n, n), dtype=av.dtype, device=dev),
                           nb, conj=av.is_complex())
    # herk fills only the lower triangle meaningfully; potrf_rec wants full
    l = blocks.potrf_rec(hermitize(Uplo.Lower, gram), nb)
    r = _ct(l).resolve_conj()
    q = blocks.trsm_rec(Side.Right, Uplo.Upper, Diag.NonUnit, r, av, nb)
    return q, r


def gels_cholqr(a, b, opts: Optional[Options] = None, *, device=None):
    """Least squares via CholQR — reference ``slate::gels_cholqr``
    (``src/gels_cholqr.cc``): solve R·x = Qᴴ·b."""
    dev = _device_of(a, b, device=device)
    av, bv = _arr(a, dev), _arr(b, dev)
    nb = _nb(a, opts)
    squeeze = bv.ndim == 1
    if squeeze:
        bv = bv[:, None]
    q, r = cholqr(a, opts, device=dev)
    x = blocks.trsm_rec(Side.Left, Uplo.Upper, Diag.NonUnit,
                        r, matmul(_ct(q), bv), nb)
    if squeeze:
        x = x[:, 0]
    return _wrap_like(b, x)


@instrument_driver("gels")
def gels(a, b, opts: Optional[Options] = None, *, device=None):
    """Least-squares driver — reference ``slate::gels`` (``src/gels.cc``):
    CholQR when ``method_gels`` (Auto by :func:`~slate_tpu_torch.method.
    select_gels`: m ≥ 3n) says so and m ≥ n, else QR."""
    dev = _device_of(a, b, device=device)
    m, n = _arr(a, dev).shape
    method = select_gels(get_option(opts, "method_gels", MethodGels.Auto),
                         m, n)
    if method is MethodGels.CholQR and m >= n:
        return gels_cholqr(a, b, opts, device=dev)
    return gels_qr(a, b, opts, device=dev)


def _gels_lo_factor(av, lo, nb: int):
    """The low leg of :func:`gels_mixed`: R of ``geqrf_rec`` of ``av`` in
    ``lo`` (fp32: its products through the ``matmul`` site).  The JAX
    package's split leg waits for ``ops/split_gemm.py``; ``use_split_leg``
    raises where the knob forces it."""
    from ._refine import use_split_leg

    use_split_leg(lo)
    f, _taus = geqrf_rec(av.to(lo), nb)
    return torch.triu(f[:av.shape[1]])


def gels_mixed(a, b, opts: Optional[Options] = None, *, tol=None,
               device=None):
    """Mixed-precision least squares with iterative refinement (the JAX
    package's corrected semi-normal equations over the shared refine
    core; the reference has no gels_mixed): factor A = Q·R once in low
    precision, then iterate the normal-equation residual s = Aᴴ(b − A·x),
    each correction solving Rᴴ·R·d = s against the low factor.
    Overdetermined shapes only (m ≥ n).  Returns ``(x, iters)``;
    negative ``iters`` flags the working-precision :func:`gels_qr`
    fallback."""
    import math

    from ..enums import Norm
    from .norms import norm as _norm
    from ._refine import ir_refine_core, lo_dtype

    dev = _device_of(a, b, device=device)
    av, bv = _arr(a, dev), _arr(b, dev)
    m, n = av.shape
    if m < n:
        raise ValueError("gels_mixed refines overdetermined systems "
                         "(m >= n); use gels for minimum-norm shapes")
    nb = _nb(a, opts)
    itermax = int(get_option(opts, "max_iterations", 30))
    use_fallback = bool(get_option(opts, "use_fallback_solver", True))
    squeeze = bv.ndim == 1
    if squeeze:
        bv = bv[:, None]
    eps = float(torch.finfo(av.dtype).eps)
    # the refined operator is AᴴA: ‖AᴴA‖∞ ≤ ‖A‖₁·‖A‖∞
    anorm2 = float(_norm(Norm.One, av, device=dev)) \
        * float(_norm(Norm.Inf, av, device=dev))
    thresh = float(tol) if tol is not None else eps * math.sqrt(n)

    lo = lo_dtype(av.dtype)
    r_lo = _gels_lo_factor(av, lo, nb)
    ah = _ct(av)

    def solve_lo(s):
        w = blocks.trsm_rec(Side.Left, Uplo.Lower, Diag.NonUnit,
                            _ct(r_lo), s.to(lo), nb)
        d = blocks.trsm_rec(Side.Left, Uplo.Upper, Diag.NonUnit, r_lo, w, nb)
        return d.to(av.dtype)

    def solve_full(_s0):
        # working-precision fallback: gels_qr on the ORIGINAL right-hand
        # side (the core hands over the normal-equation one)
        return _arr(gels_qr(av, bv, opts, device=dev), dev)

    def residual(x):
        return matmul_hi(ah, bv - matmul_hi(av, x))

    s0 = residual(torch.zeros((n, bv.shape[1]), dtype=av.dtype, device=dev))
    x, iters = ir_refine_core(s0, solve_lo, solve_full, residual,
                              anorm=anorm2, thresh=thresh, itermax=itermax,
                              use_fallback=use_fallback)
    if squeeze:
        x = x[:, 0]
    return _wrap_like(b, x), iters
