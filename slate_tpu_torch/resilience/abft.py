"""Algorithm-based fault tolerance: checksum-carried factorizations
(Huang–Abraham) with a detect → correct → recompute → restart ladder —
the port of ``slate_tpu/resilience/abft.py``.

**The invariant.**  For LU, carry one checksum block-row and one checksum
block-column, ``W = [A, A·e; eᵀA, eᵀAe]``; factoring the real rows
right-looking with the checksum row riding the trailing product as one
extra L₂₁ row (multipliers ``cs·U₁₁⁻¹``) and the checksum column as one
extra U₁₂ column keeps, after EVERY step,

* checksum row == column sums of the live trailing Schur complement,
* checksum col == row sums of the live trailing Schur complement.

Cholesky carries the block-row only (the trailing block is symmetric, so
a corrupted column is found off the symmetry residual).  The maintenance
IS the trailing product: the augmented operands add one block-row and
column to the same :func:`~slate_tpu_torch.ops.blocks.matmul` call.  On
the card the block is 128 wide (one checksum lane, 127 zero lanes;
:func:`~slate_tpu_torch.ops.smem.checksum_block_rows`) so that product
stays on the ``matmul`` kernel; on the CPU it is the JAX package's.

**Per step: verify → correct → recompute**, then restart and stock retry:

1. **verify** — syndromes under tolerance: continue (``abft.checks``);
2. **correct** — exactly one row and one column syndrome fire and agree:
   one corrupted element, corrected in place (``abft.detected``,
   ``abft.corrected``);
3. **recompute** — anything else: restore the step's entry state and
   rerun that step only (``abft.recomputed``);
4. **restart** — an injected ``device_loss`` at a step boundary rewinds
   to the last ``SLATE_TPU_TORCH_CKPT_EVERY_STEPS`` snapshot
   (``ckpt.restored``, ``abft.restarted``);
5. **stock retry** — a result still dirty flows out to the health gate
   (``SLATE_TPU_TORCH_HEALTH=retry``), which reruns on the stock backend.

**Where the sums are taken.**  The JAX package copies the trailing block
to the host every step (``slate_tpu/resilience/abft.py:295-300, 557``).
At n = 8192 that is about 1.4 GB over PCIe against a factorization of
tens of ms, so here the column and row sums, the finiteness test and
max|S| are computed on the card and only those O(n) vectors come to the
host, where one numpy function (:func:`_judge`) applies the JAX package's
thresholds: the same decisions on the same sums.

**Depths.**  :func:`getrf_abft` / :func:`potrf_abft` are the composed
step loops (panels through the ``lu_panel`` site, i.e. the
``getrf_panel_linv`` kernel on the card, and the tall-panel rungs).  The
kernel-owned paths — the scattered LU driver and its fused/full depths,
the Cholesky strip driver and its fused/full depths — run inside a
checksum ENVELOPE (:func:`_envelope`): the input's checksums taken first,
the factor identities ``(eᵀL)U = eᵀA`` and ``L(Ue) = (Ae)[perm]``
verified after the run, the invocation recomputed once on a detection.
The distributed drivers verify the same identities on their global
factors.  A kernel that fails to build or launch is never caught here.

**Knobs.**  ``SLATE_TPU_TORCH_ABFT = off | verify | correct`` (default
off; ``1``/``on`` mean ``correct``): ``verify`` detects and counts only.
``SLATE_TPU_TORCH_ABFT_TOL`` scales the syndrome tolerance (default 1).
The JAX package also feeds each rung to its live telemetry sentinel,
which is not ported yet; here each rung is counted and recorded in the
flight recorder.
"""

from __future__ import annotations

import math
import os
import warnings
from typing import Callable

import numpy as np
import torch

from ..perf import blackbox, metrics

__all__ = [
    "ENV_ABFT", "ENV_TOL", "augment_lu", "checksums", "classify",
    "correct_single", "enabled", "getrf_abft", "getrf_guarded", "mode",
    "potrf_abft", "potrf_guarded", "syndromes", "tol_scale",
    "verify_chol_factors", "verify_lu_factors",
]

ENV_ABFT = "SLATE_TPU_TORCH_ABFT"
ENV_TOL = "SLATE_TPU_TORCH_ABFT_TOL"

MODES = ("off", "verify", "correct")

#: syndromes are judged against ``_RTOL_FACTOR · tol · ε · √n · (|checksum|
#: + |fresh sum| + scale)``: the roundoff of n-term sums carried through
#: ~n/nb rank-nb updates, with headroom
_RTOL_FACTOR = 64.0


def mode() -> str:
    """The ABFT tier (``SLATE_TPU_TORCH_ABFT``): ``off``, ``verify`` or
    ``correct`` (``1``/``on``/``true``/``yes`` alias it)."""
    raw = os.environ.get(ENV_ABFT, "").strip().lower()
    if raw in ("correct", "1", "on", "true", "yes"):
        return "correct"
    if raw == "verify":
        return "verify"
    return "off"


def enabled() -> bool:
    return mode() != "off"


def tol_scale() -> float:
    """The ``SLATE_TPU_TORCH_ABFT_TOL`` multiplier (default 1.0)."""
    try:
        return float(os.environ.get(ENV_TOL, "").strip() or 1.0)
    except ValueError:
        return 1.0


def _escalate(driver: str, rung: str, detail: str = "") -> None:
    """Count one ladder rung (``abft.<rung>``) and record it."""
    metrics.inc("abft." + rung)
    blackbox.record("abft." + rung, driver=driver, detail=detail[:200])


# ---------------------------------------------------------------------------
# Checksum arithmetic (numpy, the JAX package's)
# ---------------------------------------------------------------------------

def checksums(a):
    """``(column sums, row sums)`` of a 2-D array: ``(eᵀA, A·e)``."""
    a = np.asarray(a)
    return a.sum(axis=0), a.sum(axis=1)


def syndromes(s, cs_row, cs_col):
    """``(row_syn, col_syn)`` of a block against its carried checksums:
    ``row_syn[j] = cs_row[j] − Σᵢ S[i,j]``, ``col_syn[i] = cs_col[i] −
    Σⱼ S[i,j]``; a single corruption ``S[i,j] += δ`` shows as
    ``row_syn[j] = col_syn[i] = −δ``."""
    s = np.asarray(s)
    return (np.asarray(cs_row) - s.sum(axis=0),
            np.asarray(cs_col) - s.sum(axis=1))


def _thresholds(syn, cs, sums, n: int, dtype, scale: float):
    eps = float(np.finfo(dtype).eps)
    rtol = _RTOL_FACTOR * tol_scale() * eps * math.sqrt(max(float(n), 16.0))
    return rtol * (np.abs(cs) + np.abs(sums) + scale)


def _judge(colsum, rowsum, cs_row, cs_col, n: int, dtype, scale: float):
    """The verdict of :func:`classify` from a finite block's column and
    row sums (host vectors): ``(kind, i, j, delta)``."""
    row_syn = np.asarray(cs_row) - colsum
    col_syn = np.asarray(cs_col) - rowsum
    thr_r = _thresholds(row_syn, np.asarray(cs_row), colsum, n, dtype, scale)
    thr_c = _thresholds(col_syn, np.asarray(cs_col), rowsum, n, dtype, scale)
    # a non-finite syndrome (the corruption overflowed) is corrupt
    bad_r = ~np.isfinite(row_syn) | (np.abs(row_syn) > thr_r)
    bad_c = ~np.isfinite(col_syn) | (np.abs(col_syn) > thr_c)
    if not bad_r.any() and not bad_c.any():
        return "clean", -1, -1, 0.0
    if bad_r.sum() == 1 and bad_c.sum() == 1:
        j = int(np.argmax(bad_r))
        i = int(np.argmax(bad_c))
        dr, dc = float(row_syn[j]), float(col_syn[i])
        # one flipped element shows the same syndrome on both axes
        if math.isfinite(dr) and math.isfinite(dc) \
                and abs(dr - dc) <= max(float(thr_r[j]), float(thr_c[i])):
            return "single", i, j, 0.5 * (dr + dc)
    return "multi", -1, -1, 0.0


def classify(s, cs_row, cs_col, dtype=None, scale=None):
    """Judge one trailing block against its checksums: ``(kind, i, j,
    delta)`` with kind ``"clean"``, ``"single"`` (one row and one column
    syndrome fire and agree; ADD ``delta`` at ``(i, j)``), ``"nonfinite"``
    (the block holds NaN/Inf: an input's info signal, the health gates'
    domain, never a recompute) or ``"multi"``."""
    s = np.asarray(s)
    if s.size == 0:
        return "clean", -1, -1, 0.0
    if not np.isfinite(s).all():
        return "nonfinite", -1, -1, 0.0
    if dtype is None:
        dtype = s.dtype
    if scale is None:
        scale = max(1.0, float(np.max(np.abs(s))))
    return _judge(s.sum(axis=0), s.sum(axis=1), cs_row, cs_col,
                  max(s.shape), dtype, scale)


def correct_single(s, i: int, j: int, delta: float):
    """A copy of ``s`` with the located corruption corrected:
    ``S[i,j] += delta``."""
    out = np.array(s, copy=True)
    out[i, j] += delta
    return out


def augment_lu(a):
    """``[A, A·e; eᵀA, eᵀAe]``, the checksum-augmented LU operand, with one
    extra block-row and block-column :func:`~slate_tpu_torch.ops.smem.
    checksum_block_rows` wide (the checksum in lane 0, zeros past it).  A
    numpy input gives numpy (the JAX package's layout); a tensor gives a
    tensor on its device."""
    from ..ops import smem

    if isinstance(a, torch.Tensor):
        m, n = a.shape
        cb = smem.checksum_block_rows(a.dtype, a.device)
        w = torch.zeros((m + cb, n + cb), dtype=a.dtype, device=a.device)
        w[:m, :n] = a
        w[m, :n] = a.sum(dim=0)
        w[:m, n] = a.sum(dim=1)
        w[m, n] = a.sum()
        return w
    a = np.asarray(a)
    m, n = a.shape
    cb = smem.checksum_block_rows(a.dtype)
    w = np.zeros((m + cb, n + cb), a.dtype)
    w[:m, :n] = a
    w[m, :n] = a.sum(axis=0)
    w[:m, n] = a.sum(axis=1)
    w[m, n] = a.sum()
    return w


def _augment_potrf(a):
    """``[A; eᵀA]`` with the checksum block-row of
    :func:`augment_lu`'s height."""
    from ..ops import smem

    n = a.shape[-1]
    cb = smem.checksum_block_rows(a.dtype, a.device)
    w = torch.zeros((n + cb, n), dtype=a.dtype, device=a.device)
    w[:n] = a
    w[n] = a.sum(dim=0)
    return w


# ---------------------------------------------------------------------------
# The checksum-carried composed step loops
# ---------------------------------------------------------------------------

def _seam(site: str = "driver.update"):
    """The trailing-update fault seam:
    :func:`slate_tpu_torch.resilience.inject.fault_here`."""
    from . import inject

    return inject.fault_here(site)


def _apply_bitflip(w, r0: int, r1: int, c0: int, c1: int,
                   site: str = "driver.update") -> None:
    """Flip one seeded exponent bit inside ``w[r0:r1, c0:c1]`` (the live
    trailing block), in place."""
    from . import inject

    if r1 <= r0 or c1 <= c0:
        return
    i, j = inject._flip_site((r1 - r0, c1 - c0), site)
    v = inject.flip_exponent_bit(w[r0 + i, c0 + j].cpu().numpy())
    w[r0 + i, c0 + j] = torch.as_tensor(v, device=w.device)


def _block_sums(s):
    """``(colsum, rowsum, finite, scale)`` of a device block, with ONE
    transfer of O(rows + cols) values to the host."""
    packed = torch.cat([s.sum(dim=0), s.sum(dim=1),
                        s.abs().amax().reshape(1),
                        torch.isfinite(s).all().to(s.dtype).reshape(1)])
    h = packed.cpu().numpy()
    nc = s.shape[1]
    nr = s.shape[0]
    return h[:nc], h[nc:nc + nr], bool(h[-1]), max(1.0, float(h[-2]))


def _classify_device(s, cs_row, cs_col):
    """:func:`classify` of a block on the card: its sums there, the
    verdict on the host."""
    if s.numel() == 0:
        return "clean", -1, -1, 0.0
    colsum, rowsum, finite, scale = _block_sums(s)
    if not finite:
        return "nonfinite", -1, -1, 0.0
    return _judge(colsum, rowsum, cs_row, cs_col, max(s.shape),
                  np.dtype(str(s.dtype).replace("torch.", "")), scale)


def _verify_and_heal(w, m: int, n: int, t0: int, driver: str) -> str:
    """The per-step verify and correct rungs on the augmented working
    matrix ``w`` (real block ``[:m, :n]``, checksum row ``m``, column
    ``n``), trailing from ``t0``; corrects in place.  Returns ``"clean"``,
    ``"corrected"`` or ``"dirty"`` (recompute the step)."""
    if t0 >= min(m, n):
        return "clean"
    metrics.inc("abft.checks")
    s = w[t0:m, t0:n]
    cs_row = w[m, t0:n].cpu().numpy()
    cs_col = w[t0:m, n].cpu().numpy()
    kind, i, j, delta = _classify_device(s, cs_row, cs_col)
    if kind == "clean":
        return "clean"
    if kind == "nonfinite":
        # the operand's info signal (or a poisoned input): health-gate
        # domain, not silent corruption
        metrics.inc("abft.nonfinite_input")
        return "clean"
    _escalate(driver, "detected", "step syndrome at trailing offset %d" % t0)
    if mode() != "correct":
        return "clean"                   # verify tier: count, never act
    if kind == "single":
        w[t0 + i, t0 + j] += delta
        if _classify_device(s, cs_row, cs_col)[0] == "clean":
            _escalate(driver, "corrected",
                      "single element (%d, %d)" % (t0 + i, t0 + j))
            return "corrected"
    return "dirty"


def _panel_factor(pan, tall_panel: str):
    """The loop's panel: the ``lu_panel`` site's leaf (``(lu, perm,
    linv)`` from the ``getrf_panel_linv`` kernel, or the stock ``(lu,
    perm)``), the tall-panel rungs past :data:`~slate_tpu_torch.linalg.lu.
    _MAX_LU_PANEL_ROWS` — :func:`~slate_tpu_torch.linalg.lu.getrf_panels`'
    ladder."""
    from ..linalg import lu as _lu

    if pan.shape[0] > _lu._MAX_LU_PANEL_ROWS:
        if tall_panel == "pp":
            return _lu._tall_panel_lu_pp(pan)
        return _lu._tall_panel_lu(pan)
    return _lu._panel_lu_auto(pan)


def _lu_step(wmat, gperm, k0: int, wpan: int, m: int, n: int,
             tall_panel: str) -> None:
    """One right-looking LU step on the augmented carry, in place: the
    panel on the real rows, their permutation (checksum rows never
    pivot), U₁₂ including the checksum column, the checksum row's
    multipliers, and ONE trailing product whose L₂₁ carries the checksum
    row."""
    from ..linalg import lu as _lu
    from ..ops.blocks import matmul

    out = _panel_factor(wmat[k0:m, k0:k0 + wpan], tall_panel)
    lu_p, pl = out[0], out[1]
    linv = out[2] if len(out) > 2 else None
    body = wmat[k0:m].index_select(0, pl)
    body[:, k0:k0 + wpan] = lu_p
    wmat[k0:m] = body
    gperm[k0:] = gperm[k0:].index_select(0, pl)
    c_lo = k0 + wpan
    l11 = lu_p[:wpan]
    right = wmat[k0:c_lo, c_lo:]
    if linv is not None:
        u12 = _lu._u12_with_linv(l11, linv, right)
    else:
        u12 = torch.linalg.solve_triangular(torch.tril(l11, -1), right,
                                            upper=False, unitriangular=True)
    wmat[k0:c_lo, c_lo:] = u12
    # the checksum row's multipliers l_cs = cs_panel · U₁₁⁻¹ (the extra
    # L21 block-row that makes the checksum ride the product)
    l_cs = torch.linalg.solve_triangular(torch.triu(l11), wmat[m:, k0:c_lo],
                                         upper=True, left=False)
    wmat[m:, k0:c_lo] = l_cs
    l21aug = torch.cat([lu_p[wpan:], l_cs], dim=0)
    wmat[c_lo:, c_lo:] -= matmul(l21aug, u12)


def getrf_abft(av, nb: int = 512, tall_panel: str = "tournament"):
    """Checksum-carried right-looking partial-pivot LU (the composed rung):
    ``av[perm] = L·U`` with the checksum block-row and column riding each
    step's ONE trailing product, a verify after each step, in-place
    correction of one element, recompute of a poisoned step, and
    ``SLATE_TPU_TORCH_CKPT_EVERY_STEPS``-cadence snapshots (device
    copies) for a device-loss restart.  Square real matrices.  Returns
    ``(lu, perm)``."""
    from . import checkpoint as _ckpt
    from .retry import transient_infra

    m, n = av.shape
    if m != n:
        raise ValueError("getrf_abft handles square matrices; "
                         "non-square shapes take the envelope path")
    wmat = augment_lu(av)
    gperm = torch.arange(m, device=av.device)
    every = _ckpt.every_steps()
    ck = None                              # None: restart from the input
    k0 = restarts = redo = 0
    healing = True
    while k0 < n:
        wpan = min(nb, n - k0)
        entry = (wmat[k0:].clone(), gperm.clone())   # the recompute state
        try:
            _seam("step.boundary")         # device_loss fires here
            _lu_step(wmat, gperm, k0, wpan, m, n, tall_panel)
            if _seam() == "bitflip":
                _apply_bitflip(wmat, k0 + wpan, m, k0 + wpan, n)
            if healing:
                status = _verify_and_heal(wmat, m, n, k0 + wpan, "getrf")
                if status == "dirty":
                    if redo >= 2:
                        # survived two recomputes: stop paying the verify
                        # tax and let the health gate judge the result
                        _unrecovered("getrf")
                        healing = False
                    else:
                        redo += 1
                        _escalate("getrf", "recomputed",
                                  "step at column %d" % k0)
                        wmat[k0:], gperm = entry
                        continue
                else:
                    redo = 0
        except Exception as e:
            if not transient_infra(e) or restarts >= 3:
                raise
            restarts += 1
            metrics.inc("ckpt.restored")
            _escalate("getrf", "restarted", str(e))
            _maybe_loss_trigger("getrf", e)
            if ck is None:
                k0, wmat = 0, augment_lu(av)
                gperm = torch.arange(m, device=av.device)
            else:
                k0, wmat, gperm = ck[0], ck[1].clone(), ck[2].clone()
            continue
        k0 += wpan
        if every and k0 < n and (k0 // nb) % every == 0:
            ck = (k0, wmat.clone(), gperm.clone())
            metrics.inc("ckpt.saved")
    return wmat[:m, :n].contiguous(), gperm


def _potrf_step(wmat, k0: int, wpan: int, n: int) -> None:
    """One right-looking Cholesky step on ``[A; cs]``, in place: the
    diagonal factor, L₂₁ and the checksum row's multipliers, and ONE
    trailing product with the checksum block-row riding as the extra L₂₁
    row."""
    from ..ops.blocks import matmul

    c_lo = k0 + wpan
    # a block that is not positive definite factors to NaN (the info
    # signal, as XLA's Cholesky returns it) instead of raising
    l11, info = torch.linalg.cholesky_ex(wmat[k0:c_lo, k0:c_lo])
    l11 = torch.where(info == 0, l11, torch.full_like(l11, float("nan")))
    l21 = torch.linalg.solve_triangular(l11.mT, wmat[c_lo:n, k0:c_lo],
                                        upper=True, left=False)
    l_cs = torch.linalg.solve_triangular(l11.mT, wmat[n:, k0:c_lo],
                                         upper=True, left=False)
    wmat[k0:c_lo, k0:c_lo] = l11
    wmat[c_lo:n, k0:c_lo] = l21
    wmat[n:, k0:c_lo] = l_cs
    if c_lo < n:
        l21aug = torch.cat([l21, l_cs], dim=0)
        wmat[c_lo:, c_lo:n] -= matmul(l21aug, l21.mT)


def _verify_potrf(wmat, n: int, t0: int) -> str:
    """Cholesky per-step verify: row syndromes off the carried checksum
    row, the column off the symmetry residual; corrects in place."""
    if t0 >= n:
        return "clean"
    metrics.inc("abft.checks")
    s = wmat[t0:n, t0:n]
    colsum, _, finite, scale = _block_sums(s)
    if not finite:
        # the non-SPD info signal (a NaN factor): health-gate domain
        metrics.inc("abft.nonfinite_input")
        return "clean"
    dt = np.dtype(str(s.dtype).replace("torch.", ""))
    cs_row = wmat[n, t0:n].cpu().numpy()
    row_syn = cs_row - colsum
    thr = _thresholds(row_syn, cs_row, colsum, n - t0, dt, scale)
    bad = ~np.isfinite(row_syn) | (np.abs(row_syn) > thr)
    if not bad.any():
        return "clean"
    _escalate("potrf", "detected", "step syndrome at trailing offset %d" % t0)
    if mode() != "correct":
        return "clean"
    if bad.sum() == 1:
        j = int(np.argmax(bad))
        sym = (s[:, j] - s[j, :]).abs().cpu().numpy()
        i = int(np.argmax(sym)) if float(sym.max()) > float(thr[j]) else j
        s[i, j] += float(row_syn[j])
        colsum2 = _block_sums(s)[0]
        if not (np.abs(cs_row - colsum2) > thr).any():
            _escalate("potrf", "corrected",
                      "single element (%d, %d)" % (t0 + i, t0 + j))
            return "corrected"
    return "dirty"


def potrf_abft(full, nb: int = 512):
    """Checksum-carried right-looking Cholesky (the composed rung): the
    checksum block-row rides each step's trailing product; returns the
    lower factor (the upper triangle zero)."""
    from . import checkpoint as _ckpt
    from .retry import transient_infra

    n = full.shape[-1]
    wmat = _augment_potrf(full)
    every = _ckpt.every_steps()
    ck = None
    k0 = restarts = redo = 0
    healing = True
    while k0 < n:
        wpan = min(nb, n - k0)
        entry = wmat[k0:, k0:].clone()     # a step writes only there
        try:
            _seam("step.boundary")
            _potrf_step(wmat, k0, wpan, n)
            if _seam() == "bitflip":
                _apply_bitflip(wmat, k0 + wpan, n, k0 + wpan, n)
            if healing:
                status = _verify_potrf(wmat, n, k0 + wpan)
                if status == "dirty":
                    if redo >= 2:
                        _unrecovered("potrf")
                        healing = False    # see getrf_abft
                    else:
                        redo += 1
                        _escalate("potrf", "recomputed",
                                  "step at column %d" % k0)
                        wmat[k0:, k0:] = entry
                        continue
                else:
                    redo = 0
        except Exception as e:
            if not transient_infra(e) or restarts >= 3:
                raise
            restarts += 1
            metrics.inc("ckpt.restored")
            _escalate("potrf", "restarted", str(e))
            _maybe_loss_trigger("potrf", e)
            if ck is None:
                k0, wmat = 0, _augment_potrf(full)
            else:
                k0, wmat = ck[0], ck[1].clone()
            continue
        k0 += wpan
        if every and k0 < n and (k0 // nb) % every == 0:
            ck = (k0, wmat.clone())
            metrics.inc("ckpt.saved")
    return torch.tril(wmat[:n, :n])


def _maybe_loss_trigger(driver: str, e: Exception) -> None:
    """The flight recorder's device-loss trigger for a loss a composed loop
    absorbed."""
    from . import inject

    if isinstance(e, inject.DeviceLoss):
        blackbox.trigger("device_loss", "%s: %s" % (driver, e))


def _unrecovered(driver: str) -> None:
    metrics.inc("abft.unrecovered")
    blackbox.record("abft.unrecovered", driver=driver)
    warnings.warn(
        "%s: ABFT verify still failing after recompute; the result flows "
        "to the health gate (SLATE_TPU_TORCH_HEALTH) for the stock-backend "
        "rung" % driver, RuntimeWarning, stacklevel=3)


# ---------------------------------------------------------------------------
# Factor-identity verification: the envelope of the kernel-owned paths and
# the distributed drivers
# ---------------------------------------------------------------------------

def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _np_dtype(x):
    return np.dtype(str(x.dtype).replace("torch.", "")) \
        if isinstance(x, torch.Tensor) else np.asarray(x).dtype


def verify_lu_factors(cs_row0, cs_col0, lu, perm, dtype=None):
    """Verify finished LU factors against the operand's checksums:
    ``row_syn = (eᵀL)·U − eᵀA`` and ``col_syn = L·(U·e) − (A·e)[perm]``,
    two O(n²) matvec sweeps, run where ``lu`` lies (a tensor on the card
    sends two vectors to the host).  Returns ``(ok, detail)``."""
    lu = torch.as_tensor(lu)
    if not bool(torch.isfinite(lu).all()):
        # a NaN/Inf factor is the info signal (singular or poisoned
        # input), the health gates' domain
        metrics.inc("abft.nonfinite_input")
        return True, "nonfinite factors (info signal; health-gate domain)"
    n = lu.shape[0]
    low = torch.tril(lu, -1)
    up = torch.triu(lu)
    row = (low.sum(dim=0) + 1) @ up
    u_e = up.sum(dim=1)
    col = low @ u_e + u_e
    amax = lu.abs().amax()
    h = torch.cat([row, col, amax.reshape(1)]).cpu().numpy()
    row, col, scale = h[:n], h[n:2 * n], max(1.0, float(h[-1]))
    if dtype is None:
        dtype = _np_dtype(lu)
    cs_row0 = _host(cs_row0)
    cs_col0 = _host(cs_col0)[_host(perm)]
    thr_r = _thresholds(row, cs_row0, row, n, dtype, scale)
    thr_c = _thresholds(col, cs_col0, col, n, dtype, scale)
    syn_r, syn_c = row - cs_row0, col - cs_col0
    bad_r = ~np.isfinite(syn_r) | (np.abs(syn_r) > thr_r)
    bad_c = ~np.isfinite(syn_c) | (np.abs(syn_c) > thr_c)
    if not bad_r.any() and not bad_c.any():
        return True, ""
    return False, ("factor syndromes: %d column(s), %d row(s)"
                   % (int(bad_r.sum()), int(bad_c.sum())))


def verify_chol_factors(cs_row0, l, dtype=None):
    """Verify a finished Cholesky factor: ``row_syn = (eᵀL)·Lᴴ − eᵀA``,
    run where ``l`` lies.  Returns ``(ok, detail)``."""
    l = torch.as_tensor(l)
    if not bool(torch.isfinite(l).all()):
        metrics.inc("abft.nonfinite_input")
        return True, "nonfinite factors (info signal; health-gate domain)"
    n = l.shape[0]
    lmat = torch.tril(l)
    row = lmat.sum(dim=0) @ lmat.mH
    h = torch.cat([row, l.abs().amax().reshape(1).to(row.dtype)]) \
        .cpu().numpy()
    row, scale = h[:n], max(1.0, float(abs(h[-1])))
    if dtype is None:
        dtype = _np_dtype(l)
    cs_row0 = _host(cs_row0)
    thr = _thresholds(row, cs_row0, row, n, dtype, scale)
    syn = row - cs_row0
    bad = ~np.isfinite(syn) | (np.abs(syn) > thr)
    if not bad.any():
        return True, ""
    return False, "factor syndromes: %d column(s)" % int(bad.sum())


_UNSET = object()


def _envelope(driver: str, run: Callable, corrupt: Callable,
              verify: Callable, out=_UNSET):
    """The checksum envelope of a kernel-owned invocation: run it, apply
    the trailing-update fault seam to its output, verify the factor
    identities, and on a detection recompute the invocation once (for a
    ``full`` depth the invocation is the step).  ``out`` is a first result
    the caller already holds (the distributed drivers); ``run`` stays the
    recompute.  ``verify(out)`` returns ``(ok, detail)``."""
    if out is _UNSET:
        out = run()
    out = corrupt(out)
    metrics.inc("abft.checks")
    ok, detail = verify(out)
    if ok:
        return out
    _escalate(driver, "detected", detail)
    if mode() != "correct":
        return out
    _escalate(driver, "recomputed", "whole-invocation recompute")
    out2 = corrupt(run())
    metrics.inc("abft.checks")
    if not verify(out2)[0]:
        _unrecovered(driver)
    return out2


# ---------------------------------------------------------------------------
# Driver-facing dispatch
# ---------------------------------------------------------------------------

def eligible(av) -> bool:
    """The ABFT layer's gate on one driver operand: the knob on and a 2-D
    square real floating tensor (other shapes keep the unguarded path
    and the health gates)."""
    if not enabled():
        return False
    if getattr(av, "ndim", 0) != 2 or av.shape[0] != av.shape[1]:
        return False
    return isinstance(av, torch.Tensor) and av.is_floating_point()


def _corrupt_update(x):
    """The ``driver.update`` seam on a finished factor: one seeded
    exponent-bit flip where a ``bitflip`` fires."""
    from . import inject

    if _seam() != "bitflip":
        return x
    return inject.corrupt_bitflip(x, "driver.update")[0]


def getrf_guarded(av, nb: int, raw_method=None):
    """ABFT dispatch of the partial-pivot LU driver: the composed loop
    where the ``lu_driver`` site answers the recursion, the envelope
    around the scattered driver (whose kernels own their steps).  Callers
    ensure :func:`eligible`."""
    from ..enums import MethodLU
    from ..linalg import lu as _lu

    if _lu._choose_lu_driver(av) != "scattered":
        tall = "pp" if raw_method is MethodLU.PartialPiv else "tournament"
        return getrf_abft(av, nb, tall_panel=tall)
    cs_row0, cs_col0 = av.sum(dim=0), av.sum(dim=1)

    def run():
        return _lu._getrf_partial_impl(av, nb, raw_method)

    def corrupt(out):
        return _corrupt_update(out[0]), out[1]

    def verify(out):
        return verify_lu_factors(cs_row0, cs_col0, out[0], out[1])

    return _envelope("getrf", run, corrupt, verify)


def potrf_guarded(full, nb: int, branch: str, dispatch: Callable):
    """ABFT dispatch of potrf: the composed loop for the ``stock`` branch
    (the JAX package's ``xla``), the envelope around every other branch —
    the kernel-owned ones (``panels``, ``fused``, ``full``, ``ozaki``) and
    an explicit ``method_factor`` (``recursive``), which keeps running as
    asked."""
    if branch == "stock":
        return potrf_abft(full, nb)
    cs_row0 = full.sum(dim=0)

    def corrupt(l):
        from . import inject

        if _seam() != "bitflip":
            return l
        # the factor's upper triangle is structurally zero: land the
        # seeded flip in the lower triangle
        i, j = inject._flip_site(l.shape, "driver.update")
        i, j = max(i, j), min(i, j)
        out = l.clone()
        out[i, j] = torch.as_tensor(
            inject.flip_exponent_bit(out[i, j].cpu().numpy()),
            device=out.device)
        return out

    def verify(l):
        return verify_chol_factors(cs_row0, l)

    return _envelope("potrf", dispatch, corrupt, verify)
