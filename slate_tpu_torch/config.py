"""Global configuration.

Precision: every fp32 product in this package is a full fp32 product.
The JAX package accumulates its kernels at ``Precision.HIGHEST``
(``slate_tpu/ops/pallas_kernels.py:83-87``), and the drivers' residual
gates (≤ 3·ε·n in the reference tester's units) fail at TF32's ~1e-3, so
TF32 is switched off here for cuBLAS products and cuDNN alike, and the
hand-written kernels (``csrc/*.cu``) multiply in FFMA or in 3xTF32.  The
one exception is asked for by name: the bf16x3 split products of
``SLATE_TPU_TORCH_SPLIT_GEMM`` and of the mixed drivers' split leg, at
≈ (2⁷ + 3k)·ε₃₂ componentwise (:mod:`slate_tpu_torch.ops.split_gemm`).

Knobs (environment, read once at import; the ``SLATE_TPU_TORCH_`` prefix
keeps them apart from the JAX package's ``SLATE_TPU_`` knobs, so both
packages can run in one process):

* ``SLATE_TPU_TORCH_NB`` — the global block size default (int, 256).
* ``SLATE_TPU_TORCH_USE_KERNELS`` ∈ {auto, 1, 0} — the tri-state in
  place of the reference's ``SLATE_TPU_USE_PALLAS``: ``auto`` and ``1``
  route every eligible site to the hand-written kernel (its plain PyTorch
  version for a tensor on the CPU); ``0`` routes every site to the stock
  PyTorch op.
* ``SLATE_TPU_TORCH_SPLIT_GEMM`` ∈ {auto, 1, 0} — the bf16x3/bf16x6
  split-precision fp32 products (:mod:`slate_tpu_torch.ops.split_gemm`,
  the ``split_matmul`` kernel; the JAX package's
  ``SLATE_TPU_SPLIT_GEMM``).  ``1`` answers ``split3`` at every real
  fp32 2-D ``matmul`` site, ragged shapes too; ``auto`` leaves the
  ``matmul`` site as it is but takes the split factor leg of the mixed
  drivers on a CUDA device (the JAX package takes it on its TPU only);
  ``0`` turns the split off everywhere
  (:func:`slate_tpu_torch.linalg._refine.use_split_leg`).
* ``SLATE_TPU_TORCH_F64_MXU`` ∈ {auto, 1, 0} — the Ozaki int8-slice
  fp64 products (:mod:`slate_tpu_torch.ops.ozaki`, the ``ozaki_matmul``
  kernel) and the fp64 Cholesky's Newton panels (the JAX package's
  ``SLATE_TPU_F64_MXU``).  ``1`` answers ``ozaki`` at every real fp64
  2-D ``matmul`` site and ``ozaki_newton`` at ``potrf_panel_f64``;
  ``auto`` and ``0`` keep the stock fp64 products and cuSOLVER's
  factor (the JAX package times the two on its chip; the port has no
  timing table yet).  ``SLATE_TPU_TORCH_F64_SLICES`` (8, or 9 for the
  full 53-bit split) sets the slices of each operand.
* ``SLATE_TPU_TORCH_SCATTERED_LU`` ∈ {1, 0}, default 1 — the LU driver
  (``lu_driver`` site): ``1`` takes the scattered-row driver wherever it
  is shape-eligible, ``0`` forces the blocked recursion
  (:func:`slate_tpu_torch.linalg.lu.getrf_rec`) everywhere, to compare
  the two drivers on one shape.
* ``SLATE_TPU_TORCH_QDWH`` ∈ {auto, 1, 0} — heev and svd through the
  QDWH spectral tier (:mod:`slate_tpu_torch.linalg.polar`, the JAX
  package's ``SLATE_TPU_QDWH``).  ``1`` answers ``qdwh`` at the
  ``eig_driver`` / ``svd_driver`` sites wherever they are eligible,
  ``0`` answers ``twostage`` everywhere, and ``auto`` answers
  ``twostage`` unless a pin names ``qdwh`` (the JAX package times the two
  on its chip and answers so off it).
* ``SLATE_TPU_TORCH_OOC`` ∈ {auto, 1, 0} — square fp32/fp64
  factorizations through the out-of-core tile pool
  (:mod:`slate_tpu_torch.linalg.ooc` over
  :mod:`slate_tpu_torch.ops.tilepool`: a pinned host tile grid, a bounded
  window of tiles on the card, LRU eviction, dirty write-back and
  prefetch on a side stream; the JAX package's ``SLATE_TPU_OOC``).  ``1``
  takes the pool wherever the ``ooc`` site's shape gate admits it, ``0``
  never; ``auto`` weighs 3·n²·itemsize against the card's memory
  (``SLATE_TPU_TORCH_OOC_HBM_MB`` overrides it) on a CUDA operand and
  stays in core elsewhere unless a pin names ``pool``.  The pool's own
  knobs, ``SLATE_TPU_TORCH_OOC_{NB,WINDOW_TILES,PREFETCH_DEPTH}``, are
  read at each call.
"""

from __future__ import annotations

import os

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

default_block_size = int(os.environ.get("SLATE_TPU_TORCH_NB", "256"))


def _tri_state(env: str):
    """Parse a force-off / force-on / auto knob: False, True or ``"auto"``."""
    raw = os.environ.get(env, "auto").strip().lower()
    if raw in ("1", "true", "on", "yes"):
        return True
    if raw in ("0", "false", "off", "no", ""):
        return False
    return "auto"


#: Route eligible sites through the hand-written kernels
#: (:mod:`slate_tpu_torch.ops.kernels`); see the module docstring.
use_kernels = _tri_state("SLATE_TPU_TORCH_USE_KERNELS")


def use_kernels_mode() -> str:
    """Resolve :data:`use_kernels` to ``"auto" | "on" | "off"`` (reads the
    module global, so tests may monkeypatch it)."""
    v = use_kernels
    return "auto" if v == "auto" else ("on" if v else "off")


#: Split-precision fp32 products and the mixed drivers' split factor
#: leg; see the module docstring.
split_gemm = _tri_state("SLATE_TPU_TORCH_SPLIT_GEMM")


def split_gemm_mode() -> str:
    """Resolve :data:`split_gemm` to ``"auto" | "on" | "off"``."""
    v = split_gemm
    return "auto" if v == "auto" else ("on" if v else "off")


#: Ozaki fp64 products and Newton panels; see the module docstring.
f64_mxu = _tri_state("SLATE_TPU_TORCH_F64_MXU")


def f64_mxu_mode() -> str:
    """Resolve :data:`f64_mxu` to ``"auto" | "on" | "off"``."""
    v = f64_mxu
    return "auto" if v == "auto" else ("on" if v else "off")


def resolve_device(device=None) -> torch.device:
    """The device an entry point places its host inputs on: ``cuda``
    unless the caller names another.  Asking for ``cuda`` where there is
    no card raises; nothing falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        from .exceptions import SlateError
        raise SlateError("no CUDA device is available; pass device='cpu' "
                         "to run on the host")
    return dev


#: Partial-pivot LU driver knob (a bool; tests and ``chip_smoke.py`` set
#: it to False to force the blocked recursion); see the module docstring.
scattered_lu = _tri_state("SLATE_TPU_TORCH_SCATTERED_LU") is not False


#: heev and svd through the QDWH tier; see the module docstring.
qdwh = _tri_state("SLATE_TPU_TORCH_QDWH")


def qdwh_mode() -> str:
    """Resolve :data:`qdwh` to ``"auto" | "on" | "off"``."""
    v = qdwh
    return "auto" if v == "auto" else ("on" if v else "off")


#: Out-of-core tile-pool drivers; see the module docstring.
ooc = _tri_state("SLATE_TPU_TORCH_OOC")


def ooc_mode() -> str:
    """Resolve :data:`ooc` to ``"auto" | "on" | "off"``."""
    v = ooc
    return "auto" if v == "auto" else ("on" if v else "off")
