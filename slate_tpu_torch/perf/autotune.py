"""Static backend decisions for the port's multi-backend sites — the
counterpart of ``slate_tpu/perf/autotune.py``, without timing.

Each site returns one of:

* ``"kernel"`` — the hand-written CUDA kernel
  (:mod:`slate_tpu_torch.ops.kernels`), for an eligible shape on a CUDA
  tensor;
* ``"plain"`` — the kernel's plain PyTorch version, for an eligible
  shape on a CPU tensor;
* ``"stock"`` — the stock PyTorch op (``torch.matmul``,
  ``torch.linalg``), for shapes the kernel does not take or when
  ``SLATE_TPU_TORCH_USE_KERNELS=0``.

The ``matmul`` site also answers ``"ozaki"`` (fp64, the ``ozaki_matmul``
kernel) and ``"split3"`` / ``"split6"`` (fp32, the ``split_matmul``
kernel) where a knob, a pin or this thread's :func:`split_leg` asks for
them; ``potrf_panel_f64`` answers ``"ozaki_newton"`` (the fp64 Newton
panels) or ``"stock"``.  :func:`suppress_knob_records` keeps a forced
leg's resolutions out of :func:`decisions`.  Both are thread-local: a
mixed driver's split leg in one thread changes neither the answers nor
the census of another.

The ``geqrf_panel`` site returns a driver instead: ``"cholqr2"`` (the
CholQR² panel loop over the ``chol_inv_panel``, ``lu_inv_panel`` and
``trtri_panel`` kernels) or ``"stock"`` (``torch.geqrf``).

The ``chase`` site returns ``"kernel"`` (the ``hb2st_wavefront`` or
``tb2bd_wavefront`` kernel) or ``"host_native"`` (the host chase of
:mod:`slate_tpu_torch.native`); ``eig_driver`` and ``svd_driver`` answer
``"twostage"`` or ``"qdwh"`` (:func:`_driver_site`), and ``qdwh_step``
the Halley variant of one QDWH iteration, ``"qr"`` or ``"chol"``.
The ``ooc`` site answers ``"pool"`` (the out-of-core tile pool) or
``"incore"`` (:func:`choose_ooc`).

The four sites of the distributed drivers (:mod:`slate_tpu_torch.parallel`)
keep the JAX package's rung names, so one pin string means the same
thing to both packages: ``dist_panel`` (``"xla"``, ``"pallas_panel"``,
``"pallas_fused"``: the stock solves, the ``chol_inv_panel`` /
``trtri_panel`` kernels with products around them, or the fused
``chol_l21_panel`` / ``lu_u12_panel`` kernels), ``dist_pivot``
(``"maxloc"``, ``"tournament"``), ``dist_chunk`` (``"whole"``, ``"2"``,
``"4"``) and ``dist_lookahead`` (``"1"`` … ``"4"``).  On ``cuda`` their
defaults are the JAX package's defaults on its chip; elsewhere its
off-chip answers.  :data:`FORCE_ENV` pins any rung the key offers.

The two step-depth sites, ``potrf_step`` and ``lu_step``, return a depth
of their driver instead: ``"composed"`` (the panel kernel and the glue
around it), ``"fused"`` (one kernel launch per step; for LU also
``"fused_trsm"``, whose rank-nb update stays outside the kernel) or
``"full"`` (one launch per factorization).  With no pin they answer
``"composed"``: the JAX package times the ladder on its chip, and the
port has no timing table yet.  ``SLATE_TPU_TORCH_AUTOTUNE_FORCE``
(``"potrf_step=full,lu_step=fused"``, read at each call, the counterpart
of the JAX package's ``SLATE_TPU_AUTOTUNE_FORCE``) pins a depth where the
call site's gate admits it; a pinned depth outside the key's ladder is
ignored with a warning, once per (site, depth).

:func:`decisions` lists what each site resolved to, keyed
``"<site>|<key>"``; ``decisions(with_reasons=True)`` gives ``(backend,
reason)`` pairs for the sites that record a reason.
"""

from __future__ import annotations

import os
import threading
import warnings
from contextlib import contextmanager

import torch

from .. import config
from .sweep import pow2_bucket

_decisions: dict = {}
_reasons: dict = {}
_lock = threading.Lock()
#: this thread's scopes: ``suppress`` (:func:`suppress_knob_records`) and
#: ``split_leg`` (:func:`split_leg`) nesting depths
_local = threading.local()

#: the pin variable, ``"<site>=<backend>,..."``
FORCE_ENV = "SLATE_TPU_TORCH_AUTOTUNE_FORCE"

#: Halley weight at or under which the ``qdwh_step`` site answers the
#: Cholesky variant: κ(I + c·XᴴX) ≈ c near convergence (the JAX package's
#: ``qdwh_switch_c`` default)
QDWH_SWITCH_C = 100.0
_warned_forces: set = set()


def _record(site: str, key: tuple, backend: str, reason=None) -> str:
    """Store the decision (unless :func:`suppress_knob_records` is active)
    and return ``backend``."""
    if getattr(_local, "suppress", 0):
        return backend
    k = "%s|%s" % (site, ",".join(map(str, key)))
    with _lock:
        _decisions[k] = backend
        if reason is not None:
            _reasons[k] = reason
    return backend


@contextmanager
def suppress_knob_records():
    """While active in this thread, its sites resolve as usual but leave
    :func:`decisions` untouched: a leg that forces a knob for its scope
    (the mixed drivers' split factor leg, the safe backend) must not
    write its forced answers into the census.  Other threads record as
    usual."""
    _local.suppress = getattr(_local, "suppress", 0) + 1
    try:
        yield
    finally:
        _local.suppress -= 1


@contextmanager
def split_leg():
    """While active in this thread, every fp32 product at the ``matmul``
    site resolves to ``"split3"``, at any shape, as under
    ``SLATE_TPU_TORCH_SPLIT_GEMM=1`` (``SLATE_TPU_TORCH_USE_KERNELS=0``
    still answers stock), and the resolutions stay out of the census.
    The mixed drivers' split factor leg
    (:func:`slate_tpu_torch.linalg._refine.split_factor_leg`) writes no
    module global, so it cannot race another thread's knobs."""
    _local.split_leg = getattr(_local, "split_leg", 0) + 1
    try:
        with suppress_knob_records():
            yield
    finally:
        _local.split_leg -= 1


def decisions(with_reasons: bool = False) -> dict:
    """Every site decision made so far in this process; with
    ``with_reasons``, ``(backend, reason)`` pairs (reason None where the
    site records none)."""
    with _lock:
        if with_reasons:
            return {k: (v, _reasons.get(k)) for k, v in _decisions.items()}
        return dict(_decisions)


def _forced(site: str):
    """The depth or backend :data:`FORCE_ENV` pins for ``site``, or None."""
    for part in os.environ.get(FORCE_ENV, "").split(","):
        if "=" in part:
            k, v = part.split("=", 1)
            if k.strip() == site:
                return v.strip()
    return None


def _warn_bad_force(site: str, forced: str, names) -> None:
    """A pin naming a backend this key does not offer must not fail
    silently — the user believes the pin is active.  Warn once per
    (site, value)."""
    with _lock:
        if (site, forced) in _warned_forces:
            return
        _warned_forces.add((site, forced))
    warnings.warn("%s pins %s=%r but this key's candidates are %s; the pin "
                  "is ignored here" % (FORCE_ENV, site, forced, list(names)))


#: the depth ladders of the two step sites where the call site's gate
#: holds (the step and full kernels of a family share one gate)
_STEP_DEPTHS = {"potrf_step": ["composed", "fused", "full"],
                "lu_step": ["composed", "fused", "fused_trsm", "full"]}


def _choose_depth(site: str, key: tuple, eligible: bool) -> str:
    """A step-depth site: the pinned depth where the ladder has it, else
    ``"composed"`` with the reason recorded."""
    if config.use_kernels_mode() == "off":
        depths, reason = ["composed"], "kernels off"
    elif not eligible:
        depths, reason = ["composed"], "ineligible"
    else:
        depths = _STEP_DEPTHS[site]
        reason = "default: no timed decision on this card yet"
    forced = _forced(site)
    if forced is not None:
        if forced in depths:
            return _record(site, key, forced, "forced")
        _warn_bad_force(site, forced, depths)
    return _record(site, key, "composed", reason)


def _kernel_or_plain(device) -> str:
    return "kernel" if torch.device(device).type == "cuda" else "plain"


def choose_matmul(shape_a, shape_b, dtype, device) -> str:
    """2-D real product, with the JAX package's precedence
    (``slate_tpu/perf/autotune.py:853-980``):

    * fp64: ``"ozaki"`` (:func:`slate_tpu_torch.ops.ozaki.matmul_f64`, the
      ``ozaki_matmul`` kernel) under ``SLATE_TPU_TORCH_F64_MXU=1`` or the
      pin ``matmul=ozaki``, else ``"stock"`` (cuBLAS DGEMM: the int8 route
      cannot beat it on an H100, see :mod:`~slate_tpu_torch.ops.ozaki`);
    * fp32: ``"split3"`` (:mod:`slate_tpu_torch.ops.split_gemm`, the
      ``split_matmul`` kernel) at any shape, ragged too, under
      ``SLATE_TPU_TORCH_SPLIT_GEMM=1`` or in this thread's
      :func:`split_leg`; else the pin ``matmul=split3`` or
      ``matmul=split6`` unless the split knob is off; else the ``matmul``
      kernel for shapes with every dim a multiple of 128 (the eligibility
      of ``slate_tpu/perf/autotune.py:921-924``), its plain version on the
      CPU, ``torch.matmul`` otherwise.

    Every other dtype, and every product under
    ``SLATE_TPU_TORCH_USE_KERNELS=0``, is ``"stock"``."""
    m, k = int(shape_a[0]), int(shape_a[1])
    n = int(shape_b[1])
    key = (m, k, n, str(dtype).replace("torch.", ""),
           torch.device(device).type)
    if config.use_kernels_mode() == "off":
        return _record("matmul", key, "stock", "kernels off")
    forced = _forced("matmul")
    if dtype == torch.float64:
        mode = config.f64_mxu_mode()
        if mode == "on":
            return _record("matmul", key, "ozaki", "forced-config")
        if mode != "off" and forced == "ozaki":
            return _record("matmul", key, "ozaki", "forced")
        return _record("matmul", key, "stock", "default: cuBLAS DGEMM")
    if dtype != torch.float32:
        return _record("matmul", key, "stock", "ineligible")
    smode = config.split_gemm_mode()
    if smode == "on" or getattr(_local, "split_leg", 0):
        # the split needs no tile alignment: ragged shapes take it too
        return _record("matmul", key, "split3", "forced-config")
    if smode != "off" and forced in ("split3", "split6"):
        return _record("matmul", key, forced, "forced")
    if m % 128 or k % 128 or n % 128:
        return _record("matmul", key, "stock", "ineligible")
    return _record("matmul", key, _kernel_or_plain(device))


def choose_potrf_panel(n: int, nb: int, dtype, device) -> str:
    """f32 Cholesky driver: the strip driver over the ``chol_inv_panel``
    kernel (``"kernel"``/``"plain"``) or ``torch.linalg.cholesky``
    (``"stock"``, also where :data:`FORCE_ENV` pins ``potrf_panel=stock``:
    the ABFT layer's checksum-carried loop takes that branch)."""
    key = (n, nb, str(dtype).replace("torch.", ""), torch.device(device).type)
    if dtype != torch.float32 or config.use_kernels_mode() == "off":
        return _record("potrf_panel", key, "stock")
    if _forced("potrf_panel") == "stock":
        return _record("potrf_panel", key, "stock", "forced")
    return _record("potrf_panel", key, _kernel_or_plain(device))


def choose_potrf_panel_f64(n: int, nb: int, device) -> str:
    """fp64 Cholesky driver (``slate_tpu/perf/autotune.py:1054-1097``):
    ``"ozaki_newton"`` (:func:`slate_tpu_torch.ops.blocks.
    potrf_panels_f64`: the fp32 ``chol_inv_panel`` kernel as the seed of
    each panel, two fp64 Newton steps, the products through the fp64
    ``matmul`` site) under ``SLATE_TPU_TORCH_F64_MXU=1`` or the pin
    ``potrf_panel_f64=ozaki_newton``, else ``"stock"``
    (``torch.linalg.cholesky``): the JAX package times the two on its
    chip, and the port has no timing table yet."""
    key = (n, nb, "float64", torch.device(device).type)
    if config.use_kernels_mode() == "off":
        return _record("potrf_panel_f64", key, "stock", "kernels off")
    mode = config.f64_mxu_mode()
    if mode == "on":
        return _record("potrf_panel_f64", key, "ozaki_newton", "forced-config")
    forced = _forced("potrf_panel_f64")
    if forced is not None and mode != "off":
        if forced in ("ozaki_newton", "stock"):
            return _record("potrf_panel_f64", key, forced, "forced")
        _warn_bad_force("potrf_panel_f64", forced, ("ozaki_newton", "stock"))
    return _record("potrf_panel_f64", key, "stock",
                   "default: no timed decision on this card yet")


def choose_potrf_step(n: int, nb: int, dtype, device,
                      eligible: bool = False) -> str:
    """Step depth of the f32 Cholesky driver: ``"composed"`` (the strip
    driver over ``chol_inv_panel``, :func:`~slate_tpu_torch.ops.blocks.
    potrf_panels`), ``"fused"`` (one ``potrf_step_fused`` launch per step,
    :func:`~slate_tpu_torch.ops.blocks.potrf_steps`) or ``"full"`` (one
    ``potrf_full_fused`` launch, :func:`~slate_tpu_torch.ops.blocks.
    potrf_full`).  ``eligible`` is the call site's gate of both kernels
    (``ops.smem.potrf_fused_fits``).  The depth is ``"composed"`` unless
    :data:`FORCE_ENV` pins another the gate admits (module docstring)."""
    key = (n, nb, str(dtype).replace("torch.", ""), torch.device(device).type)
    return _choose_depth("potrf_step", key, eligible)


def choose_trtri_panel(n: int, dtype, device) -> str:
    """Lower non-unit triangular-inverse tile: the ``trtri_panel`` kernel
    or ``solve_triangular`` against I.  Eligibility (f32, power-of-two
    n ≥ 32, 2-D) is checked by the call site
    (:func:`slate_tpu_torch.ops.blocks.trtri_rec`)."""
    key = (n, str(dtype).replace("torch.", ""), torch.device(device).type)
    if config.use_kernels_mode() == "off":
        return _record("trtri_panel", key, "stock")
    return _record("trtri_panel", key, _kernel_or_plain(device))


def choose_lu_panel(m: int, w: int, dtype, device, eligible: bool) -> str:
    """Panel leaf of the blocked LU recursion: the ``getrf_panel_linv``
    kernel (``"kernel"``/``"plain"``) where the call site's shape and
    shared-memory gate holds (``linalg.lu._use_kernel_panel``), else
    ``torch.linalg.lu_factor`` (``"stock"``)."""
    key = (m, w, str(dtype).replace("torch.", ""), torch.device(device).type)
    if not eligible or config.use_kernels_mode() == "off":
        return _record("lu_panel", key, "stock")
    return _record("lu_panel", key, _kernel_or_plain(device))


def choose_lu_driver(m: int, n: int, nb: int, dtype, device,
                     eligible: bool) -> str:
    """Partial-pivot getrf driver: ``"scattered"`` (the scattered-row
    driver over the ``getrf_panel_fused`` kernel) where the call site's
    gate holds (``linalg.lu._use_scattered``) and ``config.scattered_lu``
    (``SLATE_TPU_TORCH_SCATTERED_LU``) is on, else ``"rec"`` (the
    blocked recursion).  The JAX package defaults to ``"rec"`` off a TPU
    only because it has no kernel there; the port has one on the card."""
    key = (m, n, nb, str(dtype).replace("torch.", ""),
           torch.device(device).type)
    if not eligible or not config.scattered_lu:
        return _record("lu_driver", key, "rec")
    return _record("lu_driver", key, "scattered")


def choose_lu_step(m: int, n: int, nb: int, dtype, device,
                   eligible: bool = False) -> str:
    """Step depth of the scattered LU driver: ``"composed"`` (the
    ``getrf_panel_fused`` kernel and the PyTorch glue), ``"fused"`` (one
    ``getrf_step_fused`` launch per step), ``"fused_trsm"`` (the same
    kernel with the rank-nb update left to the ``matmul`` site) or
    ``"full"`` (one ``getrf_full_fused`` launch).  ``eligible`` is the
    call site's gate of both kernels (``ops.smem.lu_fused_fits``).  The
    depth is ``"composed"`` unless :data:`FORCE_ENV` pins another the gate
    admits (module docstring)."""
    key = (m, n, nb, str(dtype).replace("torch.", ""),
           torch.device(device).type)
    return _choose_depth("lu_step", key, eligible)


def choose_geqrf_panel(m: int, n: int, nb: int, dtype, device) -> str:
    """fp32 QR driver (the caller asks only for 2-D fp32 input):
    ``"cholqr2"`` (:func:`slate_tpu_torch.linalg.qr.geqrf_panels`, the
    shifted-CholQR² panels with the Householder reconstruction, whose
    kernels run their plain versions on the CPU) or ``"stock"``
    (``torch.geqrf``, the counterpart of XLA's
    ``jnp.linalg.qr(mode="raw")``), which is also the answer for other
    dtypes and under ``SLATE_TPU_TORCH_USE_KERNELS=0``.  The JAX package
    answers ``"xla"`` off its chip only because it has no kernel there
    (``slate_tpu/perf/autotune.py:1640-1641``); the port has its kernels
    on the card."""
    key = (m, n, nb, str(dtype).replace("torch.", ""),
           torch.device(device).type)
    if config.use_kernels_mode() == "off":
        return _record("geqrf_panel", key, "stock", "kernels off")
    if dtype != torch.float32:
        return _record("geqrf_panel", key, "stock", "ineligible")
    return _record("geqrf_panel", key, "cholqr2", "the kernels' driver")


def _batched_key(dims, dtype, device) -> tuple:
    """A batched site's key: every dim pow2-bucketed (floor 8, the JAX
    package's ``_bucket_dim``), so one decision serves a bucket — the
    serving queue pads its batches to the same buckets."""
    return tuple(pow2_bucket(d) for d in dims) + (
        str(dtype).replace("torch.", ""), torch.device(device).type)


def _batched_common(site: str, b: int, n: int, dtype, device,
                    eligible: bool) -> str:
    key = _batched_key((b, n), dtype, device)
    if not eligible or config.use_kernels_mode() == "off":
        return _record(site, key, "stock")
    return _record(site, key, _kernel_or_plain(device))


def choose_batched_potrf(b: int, n: int, dtype, device,
                         eligible: bool) -> str:
    """Leading-batch-dim Cholesky (:func:`slate_tpu_torch.linalg.batched.
    potrf_batched`): the ``potrf_batched`` kernel (``"kernel"`` on CUDA,
    its plain version ``"plain"`` on the CPU) where the call site's gate
    holds (``linalg.batched._grid_eligible``: fp32, n ≥ 32, n % 32 == 0),
    else ``torch.linalg.cholesky`` (``"stock"``, the counterpart of the
    JAX package's ``"vmapped"``).  The JAX package defaults to
    ``"vmapped"`` off a TPU only because it has no kernel there
    (``slate_tpu/perf/autotune.py:1815-1820``); the port has one on the
    card."""
    return _batched_common("batched_potrf", b, n, dtype, device, eligible)


def choose_batched_lu(b: int, n: int, dtype, device, eligible: bool) -> str:
    """Leading-batch-dim partial-pivot LU (:func:`slate_tpu_torch.linalg.
    batched.getrf_batched`): the ``getrf_batched`` kernel (``"kernel"`` /
    ``"plain"``) where the call site's gate holds (fp32, n ≥ 32,
    n % 32 == 0, n ≤ 864), else ``torch.linalg.lu_factor``
    (``"stock"``).  As :func:`choose_batched_potrf`, the port takes its
    kernel on the card where the JAX package would take ``"vmapped"``."""
    return _batched_common("batched_lu", b, n, dtype, device, eligible)


def choose_batched_qr(b: int, m: int, n: int, dtype, device) -> str:
    """Leading-batch-dim QR and least squares: one candidate today,
    ``"stock"`` (``torch.geqrf`` / ``torch.linalg.qr``), registered so
    the site is enumerable, as in the JAX package."""
    return _record("batched_qr", _batched_key((b, m, n), dtype, device),
                   "stock")


def choose_batched_heev(b: int, n: int, dtype, device) -> str:
    """Leading-batch-dim Hermitian eigensolver: one candidate today,
    ``"stock"`` (``torch.linalg.eigh``)."""
    return _record("batched_heev", _batched_key((b, n), dtype, device),
                   "stock")


def choose_chase(kind: str, n: int, kd: int, dtype, device,
                 eligible: bool) -> str:
    """Stage-2 bulge-chase backend of the two-stage eigensolver (``kind``
    ``"hb2st"``) and SVD (``"tb2bd"``): ``"kernel"`` (ONE launch of the
    ``hb2st_wavefront`` / ``tb2bd_wavefront`` kernel, the band and its
    logs staying on the card) or ``"host_native"`` (the band pulled to
    the host and chased by :mod:`slate_tpu_torch.native`, the packed logs
    shipped back).
    ``eligible`` is the call site's gate (``linalg._chase.eligible``:
    vectors wanted, kd ≥ 4, n > kd + 2); the kernel also takes only real
    fp32/fp64.  ``"kernel"`` on a CUDA operand where both hold;
    ``"host_native"`` otherwise, on the CPU and under
    ``SLATE_TPU_TORCH_USE_KERNELS=0``.  A :data:`FORCE_ENV` pin
    ``chase=kernel`` takes the kernel route on the CPU too, where the
    kernel's wrapper runs its plain version (as the JAX tests pin
    ``chase=pallas_wavefront`` off the TPU); ``chase=host_native`` pins
    the host chase on the card."""
    dt = str(dtype).replace("torch.", "")
    key = (kind, n, kd, dt, torch.device(device).type)
    names = ("kernel", "host_native")
    if not eligible or dtype not in (torch.float32, torch.float64):
        return _record("chase", key, "host_native", "ineligible")
    if config.use_kernels_mode() == "off":
        return _record("chase", key, "host_native", "kernels off")
    forced = _forced("chase")
    if forced is not None:
        if forced in names:
            return _record("chase", key, forced, "forced")
        _warn_bad_force("chase", forced, names)
    if torch.device(device).type == "cuda":
        return _record("chase", key, "kernel", "the kernel on the card")
    return _record("chase", key, "host_native", "default off the card")


def _driver_site(site: str, key: tuple, eligible: bool) -> str:
    """The whole-driver ladder of heev and svd (``"twostage"``,
    ``"qdwh"``), as the JAX package resolves it off its chip
    (``slate_tpu/perf/autotune.py:2048-2065``): ineligible keys answer
    ``"twostage"``; ``SLATE_TPU_TORCH_QDWH`` on or off
    (:func:`slate_tpu_torch.config.qdwh_mode`) answers ``"qdwh"`` or
    ``"twostage"``; under ``auto`` a :data:`FORCE_ENV` pin of either name
    is answered as it is (any other pin is warned about and ignored), and
    the default is ``"twostage"``: the JAX package times the two on its
    chip, and the port has no timing table yet."""
    names = ("twostage", "qdwh")
    if not eligible:
        return _record(site, key, "twostage", "ineligible")
    mode = config.qdwh_mode()
    if mode == "off":
        return _record(site, key, "twostage", "forced-config")
    if mode == "on":
        return _record(site, key, "qdwh", "forced-config")
    forced = _forced(site)
    if forced in names:
        return _record(site, key, forced, "forced")
    if forced is not None:
        _warn_bad_force(site, forced, names)
    return _record(site, key, "twostage",
                   "default: no timed decision on this card yet")


def choose_eig_driver(n: int, dtype, device, eligible: bool) -> str:
    """Whole-driver site of heev: ``"twostage"`` (he2hb → bulge chase →
    tridiagonal solve) or ``"qdwh"`` (spectral divide and conquer over
    the QDWH polar factor, :mod:`slate_tpu_torch.linalg.polar`; all
    geqrf/potrf/gemm work on the card), by :func:`_driver_site`.
    ``eligible`` is the call site's gate (``MethodEig.Auto`` only); n < 4
    is ineligible, as in the JAX package
    (``slate_tpu/perf/autotune.py:2033``)."""
    return _driver_site("eig_driver", (pow2_bucket(n), str(dtype).replace(
        "torch.", ""), torch.device(device).type), eligible and n >= 4)


def choose_svd_driver(m: int, n: int, dtype, device, eligible: bool) -> str:
    """Whole-driver site of svd (callers guarantee m ≥ n), the ladder of
    :func:`choose_eig_driver` (``slate_tpu/perf/autotune.py:2107``);
    ``"qdwh"`` is the polar factor, then QDWH-eig of its Hermitian
    factor.  n < 4 is ineligible, as there."""
    key = (pow2_bucket(m), pow2_bucket(n), str(dtype).replace("torch.", ""),
           torch.device(device).type)
    return _driver_site("svd_driver", key, eligible and n >= 4)


def choose_qdwh_step(n: int, c: float, dtype, device) -> str:
    """The Halley variant of one QDWH iteration
    (``slate_tpu/perf/autotune.py:2192-2220``): ``"qr"`` (the stacked-QR
    step, backward stable at any conditioning) or ``"chol"``
    (chol(I + c·XᴴX) and two triangular solves, about half the work, safe
    once c is moderate since κ(I + c·XᴴX) ≈ c near convergence).  No
    probe, as there: ``"chol"`` where c ≤ :data:`QDWH_SWITCH_C`, else
    ``"qr"``; a :data:`FORCE_ENV` pin ``qdwh_step=qr|chol`` overrides.
    The key holds the c-decade, as the JAX package's does."""
    import math

    cd = 0 if c <= 1.0 else min(17, int(math.log10(c)))
    key = (pow2_bucket(n), "c1e%d" % cd, str(dtype).replace("torch.", ""),
           torch.device(device).type)
    names = ("qr", "chol")
    forced = _forced("qdwh_step")
    if forced is not None:
        if forced in names:
            return _record("qdwh_step", key, forced, "forced")
        _warn_bad_force("qdwh_step", forced, names)
    return _record("qdwh_step", key,
                   "chol" if c <= QDWH_SWITCH_C else "qr",
                   "heuristic: c against QDWH_SWITCH_C")


def _dist_site(site: str, key: tuple, names, default: str,
               reason: str) -> str:
    """A distributed site: a :data:`FORCE_ENV` pin among ``names`` as it
    is, any other pin warned about and ignored, else ``default``."""
    forced = _forced(site)
    if forced is not None:
        if forced in names:
            return _record(site, key, forced, "forced")
        _warn_bad_force(site, forced, names)
    return _record(site, key, default, reason)


def choose_dist_panel(op: str, nb: int, dtype, device, eligible: bool,
                      eligible_panel: bool, eligible_fused: bool,
                      m=None, w=None) -> str:
    """Per-step panel solve of ppotrf (``op`` ``"potrf"``), pgetrf
    (``"getrf"``) and pgeqrf (``"geqrf"``): ``"xla"`` (``torch.linalg``
    cholesky and triangular solves; pgeqrf's Householder panel),
    ``"pallas_panel"`` (the ``chol_inv_panel`` / ``trtri_panel`` kernel
    and products around it; pgeqrf's CholQR² panel) or
    ``"pallas_fused"`` (one ``chol_l21_panel`` / ``lu_u12_panel`` launch
    a solve; not a rung of ``"geqrf"``).  The call site
    (:func:`slate_tpu_torch.parallel.dist_util.dist_panel_backend`) gives
    the three gates: ``eligible`` (a real float dtype and a power-of-two
    nb in [32, 1024], fp32 on the card), ``eligible_panel`` (fp32: the
    panel kernels' wrappers take fp32 only) and ``eligible_fused`` (the
    fused kernels' shape rule, :func:`slate_tpu_torch.ops.kernels.
    fused_panel_fits`, at the panel height ``m`` / block-row width
    ``w``).  On ``cuda`` for fp32, and anywhere under
    ``SLATE_TPU_TORCH_USE_KERNELS=1``, the default is the last rung
    eligible (``"pallas_fused"`` where it is: the JAX package's default
    on its chip, ``slate_tpu/perf/autotune.py:1481-1482``), else
    ``"xla"``, which is also the answer with kernels off unless a pin
    names another rung.  ``"geqrf"`` keeps ``"xla"`` on the card too, as
    the JAX package does on its chip (``op != "geqrf"`` there); its
    ``"pallas_panel"`` is taken under a pin or
    ``SLATE_TPU_TORCH_USE_KERNELS=1``."""
    dt = str(dtype).replace("torch.", "")
    key = (op, nb, dt, torch.device(device).type) \
        + (() if m is None else ("m%d" % pow2_bucket(m),)) \
        + (() if w is None else ("w%d" % pow2_bucket(w),))
    if not eligible:
        return _record("dist_panel", key, "xla", "ineligible")
    names = ["xla"] + (["pallas_panel"] if eligible_panel else []) \
        + (["pallas_fused"] if eligible_fused and op != "geqrf" else [])
    mode = config.use_kernels_mode()
    if mode == "off":
        default, reason = "xla", "kernels off"
    elif mode == "on":
        default, reason = names[-1], "kernels on"
    elif op == "geqrf":
        default, reason = "xla", "geqrf keeps the Householder panel"
    elif torch.device(device).type == "cuda" and dtype == torch.float32:
        default, reason = names[-1], "kernels on"
    else:
        default, reason = "xla", "default off the card"
    return _dist_site("dist_panel", key, names, default, reason)


def choose_dist_pivot(nb: int, p: int, dtype, device, eligible: bool) -> str:
    """Pivot search of pgetrf's replicated panel: ``"maxloc"`` (the
    per-column argmax chain over the whole panel) or ``"tournament"``
    (CALU: per-grid-row candidates and a pairwise tournament).  On
    ``cuda`` with p > 1 the default is ``"tournament"``, else
    ``"maxloc"`` (``slate_tpu/perf/autotune.py:1485-1511``)."""
    key = (nb, p, str(dtype).replace("torch.", ""),
           torch.device(device).type)
    names = ("maxloc", "tournament")
    if not eligible:
        return _record("dist_pivot", key, "maxloc", "ineligible")
    if torch.device(device).type == "cuda" and p > 1:
        return _dist_site("dist_pivot", key, names, "tournament",
                          "default on the card, p > 1")
    return _dist_site("dist_pivot", key, names, "maxloc", "default")


def choose_dist_chunk(op: str, nb: int, dtype, p: int, q: int,
                      device) -> str:
    """Slices of each fused panel broadcast: ``"whole"`` (one all-reduce)
    or ``"2"`` / ``"4"`` (that many narrower ones; the same bytes and
    values).  On ``cuda`` the default is ``"2"`` for nb ≥ 1024 and
    ``"whole"`` below (``slate_tpu/perf/autotune.py:1514-1539``)."""
    key = (op, p, q, nb, str(dtype).replace("torch.", ""),
           torch.device(device).type)
    names = ("whole", "2", "4")
    if torch.device(device).type == "cuda" and nb >= 1024:
        return _dist_site("dist_chunk", key, names, "2",
                          "default on the card, nb >= 1024")
    return _dist_site("dist_chunk", key, names, "whole", "default")


def choose_dist_lookahead(op: str, nt: int, nb: int, dtype, device) -> str:
    """Depth D of the distributed factorizations' lookahead panel ring
    (``"1"`` … ``"4"``).  On ``cuda`` the default is ``"2"`` for nt ≥ 8
    and ``"1"`` below (``slate_tpu/perf/autotune.py:1542-1566``)."""
    key = (op, nt, nb, str(dtype).replace("torch.", ""),
           torch.device(device).type)
    names = ("1", "2", "3", "4")
    if torch.device(device).type == "cuda" and nt >= 8:
        return _dist_site("dist_lookahead", key, names, "2",
                          "default on the card, nt >= 8")
    return _dist_site("dist_lookahead", key, names, "1", "default")


def choose_ooc(n: int, nb: int, dtype, device, eligible: bool) -> str:
    """Residency of one square factorization on one card
    (``slate_tpu/perf/autotune.py:1378-1423``): ``"pool"`` (the
    out-of-core drivers of :mod:`slate_tpu_torch.linalg.ooc` over the
    pinned host tile grid of :mod:`slate_tpu_torch.ops.tilepool`) or
    ``"incore"`` (every other driver; the matrix stays on the card).
    ``eligible`` is the call site's gate (``linalg.ooc.pool_eligible``).
    ``SLATE_TPU_TORCH_OOC`` on or off answers ``"pool"`` or
    ``"incore"``; under ``auto`` a :data:`FORCE_ENV` pin of either name is
    answered as it is, and otherwise the answer is analytic, as the JAX
    package's on its chip: on a CUDA operand ``"pool"`` where operand,
    factor and workspace, 3·n²·itemsize, exceed the card's memory
    (:func:`slate_tpu_torch.ops.tilepool.hbm_budget_bytes`), else
    ``"incore"``; off the card ``"incore"``."""
    dt = str(dtype).replace("torch.", "")
    key = (n, nb, dt, torch.device(device).type)
    names = ("incore", "pool")
    if not eligible:
        return _record("ooc", key, "incore", "ineligible")
    mode = config.ooc_mode()
    if mode == "off":
        return _record("ooc", key, "incore", "forced-config")
    if mode == "on":
        return _record("ooc", key, "pool", "forced-config")
    forced = _forced("ooc")
    if forced is not None:
        if forced in names:
            return _record("ooc", key, forced, "forced")
        _warn_bad_force("ooc", forced, names)
    if torch.device(device).type != "cuda":
        return _record("ooc", key, "incore", "default off the card")
    from ..ops import tilepool

    need = 3.0 * n * n * dtype.itemsize
    if need > tilepool.hbm_budget_bytes(device):
        return _record("ooc", key, "pool",
                       "analytic: 3*n^2*itemsize over the card's memory")
    return _record("ooc", key, "incore",
                   "analytic: 3*n^2*itemsize within the card's memory")


_SITES = {
    "batched_heev": choose_batched_heev,
    "batched_lu": choose_batched_lu,
    "batched_potrf": choose_batched_potrf,
    "batched_qr": choose_batched_qr,
    "chase": choose_chase,
    "dist_chunk": choose_dist_chunk,
    "dist_lookahead": choose_dist_lookahead,
    "dist_panel": choose_dist_panel,
    "dist_pivot": choose_dist_pivot,
    "eig_driver": choose_eig_driver,
    "geqrf_panel": choose_geqrf_panel,
    "lu_panel": choose_lu_panel,
    "lu_driver": choose_lu_driver,
    "lu_step": choose_lu_step,
    "matmul": choose_matmul,
    "ooc": choose_ooc,
    "potrf_panel": choose_potrf_panel,
    "potrf_panel_f64": choose_potrf_panel_f64,
    "potrf_step": choose_potrf_step,
    "qdwh_step": choose_qdwh_step,
    "svd_driver": choose_svd_driver,
    "trtri_panel": choose_trtri_panel,
}


def select(op: str, **key) -> str:
    """Dispatch ``op`` to its site chooser with ``key`` as keywords."""
    try:
        fn = _SITES[op]
    except KeyError:
        raise KeyError(f"unknown backend site {op!r}") from None
    return fn(**key)
