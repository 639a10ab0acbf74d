"""Recursive blocked Level-3 building blocks — the counterpart of
``slate_tpu/ops/blocks.py:49-420`` and ``:457-640``.

Each op is a recursive blocked algorithm over one dense tensor whose
base case is an (nb, nb) tile op, and whose every split level exposes
one large product through :func:`matmul`.  As in the JAX package the
transposition op has already been applied by the caller, so only NoTrans
cases appear here.
"""

from __future__ import annotations

import torch

from ..enums import Diag, Side, Uplo
from ..grid import ceildiv
from . import kernels


def matmul(a, b):
    """2-D product dispatched by the ``matmul`` site
    (:func:`~slate_tpu_torch.perf.autotune.choose_matmul`): the
    hand-written kernel for 128-aligned fp32 shapes on the card, its
    plain version on the CPU; ``"ozaki"`` (fp64,
    :func:`slate_tpu_torch.ops.ozaki.matmul_f64`) and ``"split3"`` /
    ``"split6"`` (fp32, :mod:`slate_tpu_torch.ops.split_gemm`) where a
    knob or a pin asks for them; ``torch.matmul`` otherwise (other
    dtypes, ragged shapes, batched operands)."""
    if a.ndim == 2 and b.ndim == 2 and a.dtype == b.dtype \
            and a.dtype.is_floating_point:
        from ..perf.autotune import choose_matmul

        backend = choose_matmul(a.shape, b.shape, a.dtype, a.device)
        if backend == "kernel":
            return kernels.matmul(a, b)
        if backend == "plain":
            return kernels.matmul_plain(a, b)
        if backend == "ozaki":
            from .ozaki import matmul_f64

            return matmul_f64(a, b)
        if backend in ("split3", "split6"):
            from .split_gemm import matmul_split3, matmul_split6

            return (matmul_split3 if backend == "split3"
                    else matmul_split6)(a, b)
    return torch.matmul(a, b)


def matmul_hi(a, b):
    """Full-precision product for accuracy-critical compositions (potri's
    two stages).  The reference pins these to ``Precision.HIGHEST`` with
    an XLA dot rather than its kernel; here that is ``torch.matmul``,
    full fp32 because TF32 is off (:mod:`slate_tpu_torch.config`)."""
    return torch.matmul(a, b)


def _split(n: int, nb: int) -> int:
    """Split point for recursion: half of n rounded up to a multiple of nb."""
    return max(nb, ceildiv(n, 2 * nb) * nb)


def _ct(a):
    """Conjugate transpose (a view)."""
    return a.mH


def _t(a, conj: bool):
    return a.mH if conj else a.mT


# ---------------------------------------------------------------------------
# Cholesky
# ---------------------------------------------------------------------------

def potrf_rec(a, nb: int, nan_on_fail: bool = False):
    """Blocked lower Cholesky; returns L (zeros above the diagonal).  A
    leaf that is not positive definite raises, as
    ``torch.linalg.cholesky`` does; with ``nan_on_fail`` its lower
    triangle comes back NaN instead, as the JAX package's leaf
    (``lax.linalg.cholesky``) returns it, with no host sync."""
    n = a.shape[-1]
    if n <= nb:
        if not nan_on_fail:
            return torch.linalg.cholesky(a)
        l, info = torch.linalg.cholesky_ex(a)
        return torch.where((info == 0)[..., None, None], l,
                           torch.tril(torch.full_like(l, float("nan"))))
    n1 = _split(n, nb)
    a11 = a[..., :n1, :n1]
    a21 = a[..., n1:, :n1]
    a22 = a[..., n1:, n1:]
    l11 = potrf_rec(a11, nb, nan_on_fail)
    # L21 = A21 · L11^{-H}
    l21 = torch.linalg.solve_triangular(_ct(l11), a21, upper=True, left=False)
    l22 = potrf_rec(a22 - matmul(l21, _ct(l21)), nb, nan_on_fail)
    top = torch.cat([l11, torch.zeros_like(_t(a21, False))], dim=-1)
    bot = torch.cat([l21, l22], dim=-1)
    return torch.cat([top, bot], dim=-2)


# ---------------------------------------------------------------------------
# Triangular solve / multiply
# ---------------------------------------------------------------------------

def trsm_rec(side: Side, uplo: Uplo, diag: Diag, a, b, nb: int):
    """X with A·X = B (Left) or X·A = B (Right); ``a`` is the effective
    triangle (op already applied)."""
    unit = diag is Diag.Unit
    n = a.shape[-1]
    if n <= nb:
        return torch.linalg.solve_triangular(
            a, b, upper=(uplo is Uplo.Upper), left=(side is Side.Left),
            unitriangular=unit)
    n1 = _split(n, nb)
    a11 = a[..., :n1, :n1]
    a22 = a[..., n1:, n1:]
    if side is Side.Left:
        b1, b2 = b[..., :n1, :], b[..., n1:, :]
        if uplo is Uplo.Lower:
            a21 = a[..., n1:, :n1]
            x1 = trsm_rec(side, uplo, diag, a11, b1, nb)
            x2 = trsm_rec(side, uplo, diag, a22, b2 - matmul(a21, x1), nb)
        else:
            a12 = a[..., :n1, n1:]
            x2 = trsm_rec(side, uplo, diag, a22, b2, nb)
            x1 = trsm_rec(side, uplo, diag, a11, b1 - matmul(a12, x2), nb)
        return torch.cat([x1, x2], dim=-2)
    b1, b2 = b[..., :, :n1], b[..., :, n1:]
    if uplo is Uplo.Lower:
        a21 = a[..., n1:, :n1]
        x2 = trsm_rec(side, uplo, diag, a22, b2, nb)
        x1 = trsm_rec(side, uplo, diag, a11, b1 - matmul(x2, a21), nb)
    else:
        a12 = a[..., :n1, n1:]
        x1 = trsm_rec(side, uplo, diag, a11, b1, nb)
        x2 = trsm_rec(side, uplo, diag, a22, b2 - matmul(x1, a12), nb)
    return torch.cat([x1, x2], dim=-1)


def _tri(a, uplo: Uplo, diag: Diag):
    """Materialise the triangle (with an implicit unit diagonal if asked)."""
    t = torch.tril(a) if uplo is Uplo.Lower else torch.triu(a)
    if diag is Diag.Unit:
        t = t.clone()
        t.diagonal(dim1=-2, dim2=-1).fill_(1)
    return t


def trmm_rec(side: Side, uplo: Uplo, diag: Diag, a, b, nb: int):
    """B ← A·B (Left) or B·A (Right); ``a`` the effective triangle."""
    n = a.shape[-1]
    if n <= nb:
        t = _tri(a, uplo, diag)
        return matmul(t, b) if side is Side.Left else matmul(b, t)
    n1 = _split(n, nb)
    a11 = a[..., :n1, :n1]
    a22 = a[..., n1:, n1:]
    if side is Side.Left:
        b1, b2 = b[..., :n1, :], b[..., n1:, :]
        if uplo is Uplo.Lower:
            a21 = a[..., n1:, :n1]
            y2 = trmm_rec(side, uplo, diag, a22, b2, nb) + matmul(a21, b1)
            y1 = trmm_rec(side, uplo, diag, a11, b1, nb)
        else:
            a12 = a[..., :n1, n1:]
            y1 = trmm_rec(side, uplo, diag, a11, b1, nb) + matmul(a12, b2)
            y2 = trmm_rec(side, uplo, diag, a22, b2, nb)
        return torch.cat([y1, y2], dim=-2)
    b1, b2 = b[..., :, :n1], b[..., :, n1:]
    if uplo is Uplo.Lower:
        a21 = a[..., n1:, :n1]
        y1 = trmm_rec(side, uplo, diag, a11, b1, nb) + matmul(b2, a21)
        y2 = trmm_rec(side, uplo, diag, a22, b2, nb)
    else:
        a12 = a[..., :n1, n1:]
        y2 = trmm_rec(side, uplo, diag, a22, b2, nb) + matmul(b1, a12)
        y1 = trmm_rec(side, uplo, diag, a11, b1, nb)
    return torch.cat([y1, y2], dim=-1)


# ---------------------------------------------------------------------------
# Rank-k update on a triangle
# ---------------------------------------------------------------------------

def herk_rec(uplo: Uplo, alpha, a, beta, c, nb: int, conj: bool = True):
    """C ← α·A·A^H + β·C on the ``uplo`` triangle (full tiles at the
    base; the caller restores the other triangle).  ``conj=False`` is
    syrk."""
    n = c.shape[-1]
    if n <= nb:
        return alpha * matmul(a, _t(a, conj)) + beta * c
    n1 = _split(n, nb)
    a1, a2 = a[..., :n1, :], a[..., n1:, :]
    c11 = herk_rec(uplo, alpha, a1, beta, c[..., :n1, :n1], nb, conj)
    c22 = herk_rec(uplo, alpha, a2, beta, c[..., n1:, n1:], nb, conj)
    if uplo is Uplo.Lower:
        c21 = alpha * matmul(a2, _t(a1, conj)) + beta * c[..., n1:, :n1]
        top = torch.cat([c11, c[..., :n1, n1:]], dim=-1)
        bot = torch.cat([c21, c22], dim=-1)
    else:
        c12 = alpha * matmul(a1, _t(a2, conj)) + beta * c[..., :n1, n1:]
        top = torch.cat([c11, c12], dim=-1)
        bot = torch.cat([c[..., n1:, :n1], c22], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _conj_scalar(x):
    """ᾱ of a Python/numpy scalar or a 0-d tensor (a real one unchanged)."""
    if isinstance(x, torch.Tensor):
        return x.conj()
    c = complex(x)
    return c.conjugate() if c.imag else x


def her2k_rec(uplo: Uplo, alpha, a, b, beta, c, nb: int, conj: bool = True):
    """C ← α·A·Bᴴ + ᾱ·B·Aᴴ + β·C on the ``uplo`` triangle (full tiles at
    the base; the caller restores the other triangle).  ``conj=False`` is
    syr2k, with ᾱ → α."""
    alpha2 = _conj_scalar(alpha) if conj else alpha
    n = c.shape[-1]
    if n <= nb:
        return (alpha * matmul(a, _t(b, conj))
                + alpha2 * matmul(b, _t(a, conj)) + beta * c)
    n1 = _split(n, nb)
    a1, a2 = a[..., :n1, :], a[..., n1:, :]
    b1, b2 = b[..., :n1, :], b[..., n1:, :]
    c11 = her2k_rec(uplo, alpha, a1, b1, beta, c[..., :n1, :n1], nb, conj)
    c22 = her2k_rec(uplo, alpha, a2, b2, beta, c[..., n1:, n1:], nb, conj)
    if uplo is Uplo.Lower:
        c21 = (alpha * matmul(a2, _t(b1, conj))
               + alpha2 * matmul(b2, _t(a1, conj)) + beta * c[..., n1:, :n1])
        top = torch.cat([c11, c[..., :n1, n1:]], dim=-1)
        bot = torch.cat([c21, c22], dim=-1)
    else:
        c12 = (alpha * matmul(a1, _t(b2, conj))
               + alpha2 * matmul(b1, _t(a2, conj)) + beta * c[..., :n1, n1:])
        top = torch.cat([c11, c12], dim=-1)
        bot = torch.cat([c[..., n1:, :n1], c22], dim=-1)
    return torch.cat([top, bot], dim=-2)


# ---------------------------------------------------------------------------
# Triangular inverse and L^H·L / U·U^H products (potri)
# ---------------------------------------------------------------------------

def trtri_rec(uplo: Uplo, diag: Diag, a, nb: int, hi: bool = False):
    """Blocked triangular inverse.  A lower non-unit fp32 power-of-two
    base tile goes to the ``trtri_panel`` site (the kernel on the card,
    its plain version on the CPU); other tiles are solved against I.
    ``hi`` routes the assembly products through :func:`matmul_hi`."""
    n = a.shape[-1]
    unit = diag is Diag.Unit
    mm = matmul_hi if hi else matmul
    if n <= nb:
        if (a.ndim == 2 and uplo is Uplo.Lower and not unit
                and a.dtype == torch.float32 and n >= 32
                and (n & (n - 1)) == 0):
            from ..perf.autotune import choose_trtri_panel

            backend = choose_trtri_panel(n, a.dtype, a.device)
            if backend == "kernel":
                return kernels.trtri_panel(a)
            if backend == "plain":
                return kernels.trtri_panel_plain(a)
        eye = torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape)
        return torch.linalg.solve_triangular(
            a, eye, upper=(uplo is Uplo.Upper), unitriangular=unit)
    n1 = _split(n, nb)
    a11 = a[..., :n1, :n1]
    a22 = a[..., n1:, n1:]
    x11 = trtri_rec(uplo, diag, a11, nb, hi)
    x22 = trtri_rec(uplo, diag, a22, nb, hi)
    if uplo is Uplo.Lower:
        a21 = a[..., n1:, :n1]
        x21 = -mm(x22, mm(a21, x11))
        top = torch.cat([x11, torch.zeros_like(a21.mT)], dim=-1)
        bot = torch.cat([x21, x22], dim=-1)
    else:
        a12 = a[..., :n1, n1:]
        x12 = -mm(x11, mm(a12, x22))
        top = torch.cat([x11, x12], dim=-1)
        bot = torch.cat([torch.zeros_like(a12.mT), x22], dim=-1)
    return torch.cat([top, bot], dim=-2)


def lauum_rec(uplo: Uplo, a, nb: int, conj: bool = True, hi: bool = False):
    """Triangular product (LAPACK ``lauum``): Lower → L^H·L, Upper →
    U·U^H.  The ``uplo`` triangle of the Hermitian result is valid."""
    n = a.shape[-1]
    mm = matmul_hi if hi else matmul
    if n <= nb:
        t = torch.tril(a) if uplo is Uplo.Lower else torch.triu(a)
        return mm(_t(t, conj), t) if uplo is Uplo.Lower else mm(t, _t(t, conj))
    n1 = _split(n, nb)
    a11 = a[..., :n1, :n1]
    a22 = a[..., n1:, n1:]
    r11 = lauum_rec(uplo, a11, nb, conj, hi)
    r22 = lauum_rec(uplo, a22, nb, conj, hi)
    if uplo is Uplo.Lower:
        l21 = a[..., n1:, :n1]
        l22 = torch.tril(a22)
        r11 = r11 + mm(_t(l21, conj), l21)
        r21 = mm(_t(l22, conj), l21)
        top = torch.cat([r11, _t(r21, conj)], dim=-1)
        bot = torch.cat([r21, r22], dim=-1)
    else:
        u12 = a[..., :n1, n1:]
        u22 = torch.triu(a22)
        r11 = r11 + mm(u12, _t(u12, conj))
        r12 = mm(u12, _t(u22, conj))
        top = torch.cat([r11, r12], dim=-1)
        bot = torch.cat([_t(r12, conj), r22], dim=-1)
    return torch.cat([top, bot], dim=-2)


# ---------------------------------------------------------------------------
# Right-looking Cholesky whose whole step, or whole factorization, is one
# kernel launch (the ``fused`` and ``full`` depths of the potrf_step site)
# ---------------------------------------------------------------------------

def potrf_steps(a, nb: int = 512, tc=None):
    """Right-looking blocked Cholesky whose WHOLE step — diagonal
    chol + inverse, L21 = A21·L11⁻ᵀ, the symmetric rank-nb trailing
    update — is one ``potrf_step_fused`` launch per block column, on one
    private copy of ``a`` updated in place.  nb a power of two ≥ 128
    dividing n (:func:`slate_tpu_torch.ops.smem.potrf_fused_fits`); the
    trailing tile edge tc defaults to nb.  Returns L (zeros above the
    diagonal)."""
    from ..perf import metrics

    n = a.shape[-1]
    tc = tc or nb
    a = a.clone(memory_format=torch.contiguous_format)
    metrics.inc("step.potrf.steps", float(n // nb))
    with metrics.step_timer("potrf", "fused"):
        for k0 in range(0, n, nb):
            kernels.potrf_step_fused(a, k0, nb=nb, tc=tc)
    return a.tril_()


def potrf_full(a, nb: int = 512, tc=None):
    """Right-looking blocked Cholesky whose WHOLE factorization is one
    ``potrf_full_fused`` launch, on one private copy of ``a``; same
    shapes and result contract as :func:`potrf_steps`."""
    from ..perf import metrics

    n = a.shape[-1]
    tc = tc or nb
    a = a.clone(memory_format=torch.contiguous_format)
    metrics.inc("step.potrf.steps", float(n // nb))
    with metrics.step_timer("potrf", "full"):
        kernels.potrf_full_fused(a, nb=nb, tc=tc)
    return a.tril_()


# ---------------------------------------------------------------------------
# Right-looking strip Cholesky over the chol_inv_panel kernel
# ---------------------------------------------------------------------------

def potrf_panels(a, nb: int = 512):
    """Right-looking blocked Cholesky whose panel step is the
    ``chol_inv_panel`` kernel (L and L⁻¹ of the diagonal block in one
    launch): every panel trsm becomes a product against L⁻¹, and the
    trailing update touches only block-column strips at or below the
    diagonal.  fp32 power-of-two panels take the kernel; a ragged last
    panel takes :func:`_chol_panel_stock`."""

    def panel(akk, w):
        if w == nb and (nb & (nb - 1)) == 0 and a.dtype == torch.float32:
            return kernels.chol_inv_panel(akk)
        return _chol_panel_stock(akk, w)

    return _potrf_strips(a, nb, panel)


def _chol_panel_stock(akk, w):
    """Stock base-case panel: factor + explicit inverse.  Reads only the
    stored lower triangle (the strip updates leave stale values above),
    as ``torch.linalg.cholesky`` does."""
    lkk = torch.linalg.cholesky(akk)
    linv = torch.linalg.solve_triangular(
        lkk, torch.eye(w, dtype=akk.dtype, device=akk.device), upper=False)
    return lkk, linv


def _potrf_strips(a, nb, panel):
    """Strip-wise right-looking Cholesky core: ``panel(akk, w)`` returns
    the diagonal block's (L, L⁻¹); the panel trsm-as-product and the
    triangular trailing update in block-column strips are shared.

    Works in place on one private copy of ``a`` (the JAX package builds
    a new array per ``.at[].set/.add``): the diagonal block, the L21
    panel and each trailing strip are overwritten where they lie."""
    from ..perf import metrics
    from ..perf.autotune import choose_matmul
    from .split_gemm import matmul_sliced, split_slices

    a = a.clone()
    n = a.shape[-1]
    # strip width as in the JAX package, a multiple of nb so that a strip
    # boundary never falls inside a later diagonal block (a strip updates
    # only rows at or below its own start, so an interior boundary would
    # leave that block's upper triangle stale)
    ws = nb * max(1, 2048 // nb)
    for k0 in range(0, n, nb):
        w = min(nb, n - k0)
        akk = a[k0:k0 + w, k0:k0 + w]
        with metrics.step_timer("potrf", "panel"):
            lkk, linv = panel(akk, w)
            akk.copy_(lkk)
        if k0 + w < n:
            with metrics.step_timer("potrf", "trsm"):
                l21 = a[k0 + w:, k0:k0 + w]
                l21.copy_(matmul(l21, _ct(linv)))
            nstrips = len(range(k0 + w, n, ws))
            metrics.count_hbm_roundtrips(1.0 + nstrips)
            # LP-GEMM operand folding: where the strip products resolve to
            # a split backend, the panel splits into its bf16 slices once
            # a step and every strip reads windows of the same slices (the
            # elementwise split commutes with slicing); the site is asked
            # at the first strip's shape
            sl = sr = None
            if a.dtype == torch.float32:
                mrem = n - (k0 + w)
                sbk = choose_matmul((mrem, w), (w, min(ws, mrem)), a.dtype,
                                    a.device)
                if sbk in ("split3", "split6"):
                    sl = split_slices(l21)
                    sr = tuple(_ct(x) for x in sl)
            with metrics.step_timer("potrf", "update"):
                for j0 in range(k0 + w, n, ws):
                    jw = min(ws, n - j0)
                    o = j0 - (k0 + w)
                    if sl is not None:
                        upd = matmul_sliced(
                            sbk, tuple(x[o:] for x in sl),
                            tuple(x[:, o:o + jw] for x in sr))
                    else:
                        upd = matmul(l21[o:], _ct(l21[o:o + jw]))
                    a[j0:, j0:j0 + jw] -= upd
    return a.tril_()


# ---------------------------------------------------------------------------
# fp64 strip Cholesky: the fp32 chol_inv_panel kernel as the seed, two fp64
# Newton steps, the products through the fp64 matmul site
# ---------------------------------------------------------------------------

def _chol_panel_refine_f64(akk):
    """fp64 (L, L⁻¹) of a power-of-two diagonal block
    (``slate_tpu/ops/blocks.py:643-716``): the fp32 image factored by the
    ``chol_inv_panel`` kernel, then one fp64 Newton step on the factor
    (F = X₀(A − L₀L₀ᵀ)X₀ᵀ, L₁ = L₀(I + tril(F, −1) + diag(F)/2)) and one on
    the inverse (X₁ = X₀ + X₀(I − L₁X₀)), then a second step of each from
    residual-scale fp32 products (A − L₁L₁ᵀ = r − L₁ΔLᵀ − ΔL·L₀ᵀ and
    I − L₂X₁ = (I − L₁X₁)² − ΔL₂X₁, identities).

    Only the two products of fp32-exact operands against themselves at
    full scale, L₀L₀ᵀ and L₀X₀, go through :func:`matmul` (the fp64 site:
    the ``ozaki_matmul`` kernel or DGEMM); every other product multiplies
    an O(ε₃₂) residual in fp32 ``torch.matmul`` (TF32 off), which gives
    the O(ε₃₂²) absolute accuracy the correction needs.  A block whose fp32
    image is not positive definite gives NaN, which the driver
    (:func:`slate_tpu_torch.linalg.cholesky.potrf`) answers by rerunning
    the stock factor."""
    w = akk.shape[-1]
    eye = torch.eye(w, dtype=torch.float64, device=akk.device)
    asym = torch.tril(akk) + _ct(torch.tril(akk, -1))
    l0_32, x0_32 = kernels.chol_inv_panel(asym.to(torch.float32))
    l0_32 = torch.tril(l0_32)
    x0_32 = torch.tril(x0_32)
    l0 = l0_32.to(torch.float64)
    x0 = x0_32.to(torch.float64)
    mm32 = torch.matmul

    def corr(f):
        return torch.tril(f, -1) + torch.diag(0.5 * torch.diagonal(f))

    # r = A − L₀L₀ᵀ: cancellation at full scale, the exact-product path
    r = asym - matmul(l0, _ct(l0))
    f1 = mm32(mm32(x0_32, r.to(torch.float32)), x0_32.T)
    dl1 = mm32(l0_32, corr(f1))
    l1 = torch.tril(l0 + dl1.to(torch.float64))
    # I − L₁X₀ = (I − L₀X₀) − ΔL·X₀
    e1 = (eye - matmul(l0, x0)) - mm32(dl1, x0_32).to(torch.float64)
    e1_32 = e1.to(torch.float32)
    x1 = torch.tril(x0 + mm32(x0_32, e1_32).to(torch.float64))

    # the second step, on residual-scale fp32 products alone
    l1_32 = l1.to(torch.float32)
    x1_32 = x1.to(torch.float32)
    r2 = r - (mm32(l1_32, dl1.T).to(torch.float64)
              + mm32(dl1, l0_32.T).to(torch.float64))
    f2 = mm32(mm32(x1_32, r2.to(torch.float32)), x1_32.T)
    dl2 = mm32(l1_32, corr(f2))
    l2 = torch.tril(l1 + dl2.to(torch.float64))
    e2 = (mm32(e1_32, e1_32) - mm32(dl2, x1_32)).to(torch.float64)
    x2 = torch.tril(x1 + mm32(x1_32, e2.to(torch.float32))
                    .to(torch.float64))
    return l2, x2


def _chol_panel_nan(akk, w):
    """:func:`_chol_panel_stock` for a panel of the fp64 driver, with a
    factor that is not positive definite returned as NaN (as the JAX
    package's XLA panel returns it) instead of raised."""
    lkk, info = torch.linalg.cholesky_ex(akk)
    lkk = torch.where(info == 0, lkk, torch.full_like(lkk, float("nan")))
    linv = torch.linalg.solve_triangular(
        lkk, torch.eye(w, dtype=akk.dtype, device=akk.device), upper=False)
    return lkk, linv


def potrf_panels_f64(a, nb: int = 512):
    """fp64 :func:`potrf_panels` (``slate_tpu/ops/blocks.py:718-733``):
    the same strips, each power-of-two panel
    :func:`_chol_panel_refine_f64`, a ragged one
    :func:`_chol_panel_nan`, the products through :func:`matmul`.  A block
    whose fp32 seed breaks down propagates NaN to the driver."""

    def panel(akk, w):
        if w == nb and (nb & (nb - 1)) == 0:
            return _chol_panel_refine_f64(akk)
        return _chol_panel_nan(akk, w)

    return _potrf_strips(a, nb, panel)
