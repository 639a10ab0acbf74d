"""Batched many-problem drivers: ``potrf / potrs / posv / getrf / getrs /
gesv / geqrf / gels / heev`` over a LEADING BATCH DIM — the counterpart
of ``slate_tpu/linalg/batched.py``, the serving workload: thousands of
small independent solves, each batch owned by one launch.

Two backends per factorization, chosen by the ``batched_potrf`` /
``batched_lu`` sites (:mod:`slate_tpu_torch.perf.autotune`) on
pow2-bucketed (batch, n) keys:

* ``"kernel"`` — one launch of the hand-written ``potrf_batched`` /
  ``getrf_batched`` kernel (``csrc/``), one block per problem, every
  problem factored to completion in the launch (``"plain"``, its plain
  PyTorch version, for a batch on the CPU);
* ``"stock"`` — ``torch.linalg.cholesky`` / ``torch.linalg.lu_factor``
  over the batch (cuSOLVER on the card), the counterpart of the JAX
  package's ``"vmapped"``; taken for fp64, for shapes the kernels do not
  take, and under ``SLATE_TPU_TORCH_USE_KERNELS=0``.

The triangular solves are ``torch.linalg.solve_triangular``, as the JAX
package leaves them to ``lax.linalg.triangular_solve``; QR, least squares
and the eigensolver have one (stock) backend.

Every driver places its operands on ``device`` (``cuda`` unless the
caller names another, as every entry point of the port).  The async
serving front door over these drivers is :mod:`slate_tpu_torch.serve`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..exceptions import SlateError
from ..matrix import to_tensor
from ..method import select_backend
from ..ops import kernels, smem
from ..options import Options
from ..perf import metrics
from ..perf.metrics import instrument_driver

__all__ = [
    "potrf_batched", "potrs_batched", "posv_batched",
    "getrf_batched", "getrs_batched", "gesv_batched",
    "geqrf_batched", "gels_batched", "heev_batched",
]


def _check_batched(a, name: str, device, square: bool = True):
    av = to_tensor(a, device)
    if av.ndim != 3:
        raise SlateError(f"{name} requires a (batch, m, n) operand, "
                         f"got shape {tuple(av.shape)}")
    if square and av.shape[-1] != av.shape[-2]:
        raise SlateError(f"{name} requires square problems, "
                         f"got shape {tuple(av.shape)}")
    return av


def _rhs_3d(b, bsz: int, device):
    """A batched right-hand side as (B, n, k); returns ``(bv, squeeze)``."""
    bv = to_tensor(b, device)
    if bv.ndim == 2 and bv.shape[0] == bsz:
        return bv[:, :, None], True
    if bv.ndim != 3:
        raise SlateError(f"batched rhs must be (batch, n) or "
                         f"(batch, n, k), got shape {tuple(bv.shape)}")
    return bv, False


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------

def _potrf_stock(a):
    return torch.linalg.cholesky(a)


def _getrf_stock(a):
    lu, ipiv = torch.linalg.lu_factor(a)
    p, _, _ = torch.lu_unpack(lu, ipiv, unpack_data=False)
    # a = P·L·U, so row i of L·U is row perm[i] of a, with P[perm[i], i] = 1
    return lu, p.argmax(dim=-2)


def _grid_eligible(kernel: str, bsz: int, n: int, m: int, dtype) -> bool:
    """Shape gate of the batched kernels: square fp32 problems that
    ``kernel`` takes (:func:`slate_tpu_torch.ops.smem.batched_fits`).
    Whether an eligible shape takes the kernel is the site's decision
    (:mod:`slate_tpu_torch.perf.autotune`, which also honours
    ``config.use_kernels``)."""
    return (m == n and bsz >= 1 and dtype == torch.float32
            and smem.batched_fits(kernel, n))


def _potrf_grid(a):
    return kernels.potrf_batched(a.contiguous())


def _getrf_grid(a):
    """The kernel on the transposed batch, then the pivot gather and
    transpose back to row-major packed LU (``batched.py:159-170``)."""
    out, piv = kernels.getrf_batched(a.mT.contiguous())
    lu_t = out.gather(2, piv[:, None, :].expand_as(out))
    return lu_t.mT.contiguous(), piv


# ---------------------------------------------------------------------------
# Residual probes
# ---------------------------------------------------------------------------

def _probe_x(n: int, seed: int, like) -> torch.Tensor:
    """The probe vector, as an (n, 1) column (numpy's generator, so the
    probe is the same on every device)."""
    x = np.random.default_rng(seed).standard_normal((n, 1))
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _scaled(num, a, x, n: int) -> float:
    eps = float(torch.finfo(a.dtype).eps)
    den = (torch.linalg.matrix_norm(a.float())
           * float(torch.linalg.vector_norm(x.float())) * eps * n)
    return float((num / den).max())


def batched_factor_resid_potrf(spd, l) -> float:
    """Max scaled matvec residual ‖L(Lᵀx) − Ax‖ over the batch (the
    reference tester's criterion, O(n²) per problem); inf for a
    non-finite factor."""
    if not bool(torch.isfinite(l).all()):
        return float("inf")
    n = spd.shape[-1]
    x = _probe_x(n, 23, spd)
    lt = torch.tril(l)
    r = torch.linalg.vector_norm(
        (lt @ (lt.mT @ x) - spd @ x).float(), dim=(-2, -1))
    return _scaled(r, spd, x, n)


def batched_factor_resid_lu(a, out) -> float:
    """Max scaled matvec residual of L·(U·x) = A[perm]·x over the batch;
    inf for a non-finite factor."""
    lu, perm = out
    if not bool(torch.isfinite(lu).all()):
        return float("inf")
    n = a.shape[-1]
    x = _probe_x(n, 24, a)
    y = torch.triu(lu) @ x
    z = torch.tril(lu, -1) @ y + y
    ap = a.gather(1, perm[:, :, None].expand_as(a))
    r = torch.linalg.vector_norm((z - ap @ x).float(), dim=(-2, -1))
    return _scaled(r, a, x, n)


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

@instrument_driver("potrf_batched")
def potrf_batched(a, opts: Optional[Options] = None, *, device=None):
    """Batched Cholesky: ``a`` (B, n, n) SPD → the (B, n, n) lower
    factors (upper triangles zero).  Backend per pow2-bucketed
    (B, n, dtype, device) key through the ``batched_potrf`` site."""
    av = _check_batched(a, "potrf_batched", device)
    bsz, m, n = av.shape
    metrics.inc("batched.problems", float(bsz))
    choice = select_backend(
        "batched_potrf", b=bsz, n=n, dtype=av.dtype, device=av.device,
        eligible=_grid_eligible("potrf_batched", bsz, n, m, av.dtype))
    if choice == "stock":
        return _potrf_stock(av)
    return _potrf_grid(av)


def potrs_batched(l, b, *, device=None):
    """Solve A·X = B from the lower Cholesky factors L (B, n, n); ``b`` is
    (B, n) or (B, n, k)."""
    lv = _check_batched(l, "potrs_batched", device)
    bv, squeeze = _rhs_3d(b, lv.shape[0], lv.device)
    y = torch.linalg.solve_triangular(lv, bv, upper=False)
    x = torch.linalg.solve_triangular(lv.mT, y, upper=True)
    return x[:, :, 0] if squeeze else x


@instrument_driver("posv_batched")
def posv_batched(a, b, opts: Optional[Options] = None, *, device=None):
    """Batched factor + solve for SPD systems — returns ``(L, X)``."""
    l = potrf_batched(a, opts, device=device)
    return l, potrs_batched(l, b, device=l.device)


@instrument_driver("getrf_batched")
def getrf_batched(a, opts: Optional[Options] = None, *, device=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched partial-pivot LU: ``a`` (B, n, n) → ``(LU, perm)`` with
    ``a[i][perm[i]] = L·U`` per problem, LU packed LAPACK-style and perm
    int64 — :func:`slate_tpu_torch.linalg.lu.getrf`'s contract with a
    leading batch dim.  Backend through the ``batched_lu`` site."""
    av = _check_batched(a, "getrf_batched", device)
    bsz, m, n = av.shape
    metrics.inc("batched.problems", float(bsz))
    choice = select_backend(
        "batched_lu", b=bsz, n=n, dtype=av.dtype, device=av.device,
        eligible=_grid_eligible("getrf_batched", bsz, n, m, av.dtype))
    if choice == "stock":
        return _getrf_stock(av)
    return _getrf_grid(av)


def getrs_batched(lu, perm, b, *, device=None):
    """Batched solve from the LU factors: the row gather, then the
    unit-lower and upper triangular solves."""
    luv = _check_batched(lu, "getrs_batched", device)
    bv, squeeze = _rhs_3d(b, luv.shape[0], luv.device)
    pv = to_tensor(perm, luv.device).long()
    bp = bv.gather(1, pv[:, :, None].expand_as(bv))
    y = torch.linalg.solve_triangular(luv, bp, upper=False,
                                      unitriangular=True)
    x = torch.linalg.solve_triangular(luv, y, upper=True)
    return x[:, :, 0] if squeeze else x


@instrument_driver("gesv_batched")
def gesv_batched(a, b, opts: Optional[Options] = None, *, device=None):
    """Batched factor + solve — returns ``(LU, perm, X)``."""
    lu, perm = getrf_batched(a, opts, device=device)
    return lu, perm, getrs_batched(lu, perm, b, device=lu.device)


@instrument_driver("geqrf_batched")
def geqrf_batched(a, opts: Optional[Options] = None, *, device=None):
    """Batched QR: ``a`` (B, m, n) → ``(packed, taus)``, the Householder
    factors packed LAPACK-style per problem (``torch.geqrf``), through
    the ``batched_qr`` site."""
    av = _check_batched(a, "geqrf_batched", device, square=False)
    bsz, m, n = av.shape
    metrics.inc("batched.problems", float(bsz))
    select_backend("batched_qr", b=bsz, m=m, n=n, dtype=av.dtype,
                   device=av.device)
    return torch.geqrf(av)


@instrument_driver("gels_batched")
def gels_batched(a, b, opts: Optional[Options] = None, *, device=None):
    """Batched least squares min ‖A·X − B‖₂ for tall problems (m ≥ n):
    reduced QR and one triangular solve.  ``b`` is (B, m) or (B, m, k);
    returns X (B, n[, k])."""
    av = _check_batched(a, "gels_batched", device, square=False)
    bsz, m, n = av.shape
    if m < n:
        raise SlateError("gels_batched requires m >= n per problem "
                         f"(got {tuple(av.shape)}); use gels per problem "
                         "for minimum-norm underdetermined solves")
    metrics.inc("batched.problems", float(bsz))
    bv, squeeze = _rhs_3d(b, bsz, av.device)
    select_backend("batched_qr", b=bsz, m=m, n=n, dtype=av.dtype,
                   device=av.device)
    q, r = torch.linalg.qr(av, mode="reduced")
    x = torch.linalg.solve_triangular(r, q.mT @ bv, upper=True)
    return x[:, :, 0] if squeeze else x


@instrument_driver("heev_batched")
def heev_batched(a, opts: Optional[Options] = None, *, device=None):
    """Batched Hermitian eigensolver: ``a`` (B, n, n) → ``(w, z)``,
    eigenvalues ascending (B, n) and eigenvectors in the columns of ``z``
    (B, n, n), through the ``batched_heev`` site."""
    av = _check_batched(a, "heev_batched", device)
    bsz, n, _ = av.shape
    metrics.inc("batched.problems", float(bsz))
    select_backend("batched_heev", b=bsz, n=n, dtype=av.dtype,
                   device=av.device)
    return torch.linalg.eigh(av)
