"""Stage-2 bulge-chase dispatch of the two-stage eigensolver and SVD —
``slate_tpu/linalg/_chase.py``.

* :func:`backend` resolves the ``chase`` site
  (:func:`slate_tpu_torch.perf.autotune.choose_chase`): ``"kernel"`` (the
  ``hb2st_wavefront`` or ``tb2bd_wavefront`` kernel, ONE launch per
  chase chunk, the band and the reflector logs staying on the card; its
  plain version on a CPU tensor) or ``"host_native"`` (the band pulled
  to the host and chased by :mod:`slate_tpu_torch.native`, the packed
  logs shipped back).
* The ``*_device`` helpers run the kernel route and hand back the logs
  as tensors on the band's device — no host repacking.
* Every transfer of band or log state between host and card made by
  either route is counted into ``chase.host_bytes`` (``perf.metrics``),
  so "nothing crosses on the kernel route" is observable; an O(n·kd)
  band upload the caller makes anyway is counted under
  ``chase.ingest_bytes``.  The O(n) (d, e) handoff to the host
  tridiagonal or bidiagonal solve is neither.
* The distributed drivers' checkpointed chases keep one band snapshot
  a sweep chunk (:func:`snapshots_fit_device`, :func:`snapshot_store`,
  :func:`snapshot_restore`): on the card while they fit the budget, else
  spilled to the host and counted into ``chase.host_bytes``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import kernels
from ..perf import metrics
from ..perf.autotune import select as _select

#: narrower windows take the host chase (the JAX kernel's patch needs
#: kd ≥ 4, and the kernel keeps its gate)
_MIN_KD = 4

#: device-memory budget of the distributed drivers' checkpoint snapshots
#: (all live from pass 1 until pass 2 consumes them in reverse); past it
#: they spill to the host, an O(n·kd·nchunks) transfer counted into
#: ``chase.host_bytes`` (the JAX package's default; tests lower it
#: through :func:`slate_tpu_torch.parallel.launch.snapshot_budget`)
_SNAP_BUDGET_BYTES = 2048e6


def snapshots_fit_device(nbytes_one: int, nchunks: int) -> bool:
    """True when every checkpoint snapshot of one chase can stay in
    device memory at once."""
    return float(nbytes_one) * max(nchunks, 1) <= _SNAP_BUDGET_BYTES


def snapshot_store(band) -> np.ndarray:
    """Spill one checkpoint snapshot to the host (counted as traffic); a
    copy, so the caller may go on chasing ``band`` in place."""
    arr = band.detach().cpu().numpy().copy()
    _count_tunnel(arr.nbytes)
    return arr


def snapshot_restore(arr: np.ndarray, device):
    """Upload one spilled snapshot to ``device`` for pass 2's log
    regeneration (counted as traffic)."""
    _count_tunnel(arr.nbytes)
    return torch.from_numpy(arr).to(device)


def eligible(n: int, kd: int, want_vectors: bool) -> bool:
    """Shape gate of the kernel route: vectors wanted (values-only
    callers need no log, and the host chase is O(n·kd) for them), a
    wide-enough band, and rows for at least one sweep."""
    return bool(want_vectors) and kd >= _MIN_KD and n > kd + 2


def backend(kind: str, n: int, kd: int, dtype, device,
            want_vectors: bool) -> str:
    """Resolve (and record) the chase decision for one problem."""
    return _select("chase", kind=kind, n=n, kd=kd, dtype=dtype,
                   device=device, eligible=eligible(n, kd, want_vectors))


def _count_tunnel(nbytes: int) -> None:
    metrics.inc("chase.host_bytes", float(nbytes))


def _mark_device_path() -> None:
    """The kernel route's observability contract: the dispatch counter
    ticks and ``chase.host_bytes`` materializes at 0, so
    ``metrics.snapshot()`` reports the zero explicitly."""
    metrics.inc("chase.dispatch.kernel")
    metrics.inc("chase.host_bytes", 0.0)


def mark_host_path(kind: str, log_arrays=()) -> None:
    """Count a host chase dispatch whose packed reflector log is about to
    cross to the card for the WY back-transform."""
    metrics.inc("chase.dispatch.host_native")
    _count_tunnel(sum(np.asarray(a).nbytes for a in log_arrays
                      if a is not None))


def split_hh_log(vt, kd: int, s0: np.ndarray):
    """Split a kernel log ``(nsweeps, tmax, kd+1)`` into the ``(v3, t2,
    s0)`` triple :func:`slate_tpu_torch.linalg.eig.unmtr_hb2st_hh`
    consumes — two views, no copy."""
    return vt[:, :, 1:], vt[:, :, 0], s0


def _log_s0(n: int, lo: int, hi: int) -> np.ndarray:
    """First reflector row of each sweep of ``[lo, hi)``: sweep j's first
    window starts at row j + 1."""
    hi = min(hi, max(n - 2, 0))
    return np.arange(lo + 1, hi + 1, dtype=np.int32)


def hb2st_abw_from_dense(band, kd_eff: int):
    """WIDE lower-band storage ``(n, 2·kd+2)`` (``abw[c, d]`` = A[c+d, c])
    gathered from a dense Hermitian band on its own device — the dense
    band never visits the host."""
    n = band.shape[0]
    dev = band.device
    c = torch.arange(n, device=dev)[:, None]
    d = torch.arange(2 * kd_eff + 2, device=dev)[None, :]
    r = c + d
    vals = band[r.clamp(max=n - 1), c.expand_as(r)]
    if vals.is_complex():
        vals = torch.where(d == 0, vals.real.to(vals.dtype), vals)
    return torch.where((d <= kd_eff) & (r < n), vals,
                       torch.zeros((), dtype=vals.dtype, device=dev))


def hb2st_abw_from_ab(ab: np.ndarray, kd_eff: int, device):
    """WIDE band storage on ``device`` from a host ``(n, kd+2)`` lower
    storage — ONE O(n·kd) upload, counted as ingestion."""
    n = ab.shape[0]
    abw = np.zeros((n, 2 * kd_eff + 2), dtype=ab.dtype)
    w = min(ab.shape[1], kd_eff + 1)
    abw[:, :w] = ab[:, :w]
    metrics.inc("chase.ingest_bytes", float(abw.nbytes))
    return torch.from_numpy(abw).to(device)


def hb2st_device(abw, kd_eff: int, j0: int = 0, j1=None,
                 want_log: bool = True):
    """One chase chunk over sweeps ``[j0, j1)`` on the band's device, in
    place: returns ``(abw, log)`` with ``log = (v3, t2, s0)`` (None when
    not ``want_log``) — ONE ``hb2st_wavefront`` launch."""
    n = abw.shape[0]
    if j1 is None:
        j1 = max(n - 2, 0)
    with metrics.timer("chase.hb2st"):
        abw, vt = kernels.hb2st_wavefront(abw, kd_eff, j0, j1)
        if metrics.enabled() and abw.is_cuda:
            # the launch is asynchronous: sync inside the timer so it
            # measures the chase, not its enqueue (only with metrics on)
            torch.cuda.synchronize(abw.device)
    _mark_device_path()
    if not want_log:
        return abw, None
    return abw, split_hh_log(vt, kd_eff, _log_s0(n, j0, j1))


def hb2st_d_e(abw, n: int):
    """The chased tridiagonal (d, e) on the host — the O(n) handoff to the
    tridiagonal solve, not part of the band/log traffic."""
    d = abw[:, 0].real.cpu().numpy().copy()
    e_c = abw[:n - 1, 1].cpu().numpy().copy()
    return d, e_c


# ---------------------------------------------------------------------------
# tb2bd (upper triangular band → bidiagonal)
# ---------------------------------------------------------------------------

def tb2bd_st_from_dense(band_sq, kd_eff: int):
    """Row-major general-band storage ``(n, 3·kd+2)`` (``st[r, c−r+kd]``
    = A[r, c]) gathered from the dense upper-triangular band middle
    factor on its own device — the dense band never visits the host."""
    n = band_sq.shape[0]
    dev = band_sq.device
    r = torch.arange(n, device=dev)[:, None]
    d = torch.arange(3 * kd_eff + 2, device=dev)[None, :]
    c = r + d - kd_eff
    vals = band_sq[r.expand_as(c), c.clamp(0, n - 1)]
    return torch.where((c >= r) & (c <= r + kd_eff) & (c < n), vals,
                       torch.zeros((), dtype=vals.dtype, device=dev))


def tb2bd_st_from_ab(ab: np.ndarray, kd_eff: int, device):
    """General-band storage on ``device`` from a host ``(n, kd+3)`` upper
    storage (``ab[c, (c−r)+1]`` = A[r, c]) — ONE O(n·kd) upload, counted
    as ingestion."""
    n = ab.shape[0]
    st = np.zeros((n, 3 * kd_eff + 2), dtype=np.float64)
    for dd in range(kd_eff + 1):
        st[:n - dd, dd + kd_eff] = ab[dd:, dd + 1]
    metrics.inc("chase.ingest_bytes", float(st.nbytes))
    return torch.from_numpy(st).to(device)


def tb2bd_device(st, kd_eff: int, s0: int = 0, s1=None,
                 want_log: bool = True):
    """One bidiagonal chase chunk over sweeps ``[s0, s1)`` on the band's
    device, in place: returns ``(st, ulog, vlog)`` with each log a
    ``(v3, t2, s0)`` triple (None when not ``want_log``) — ONE
    ``tb2bd_wavefront`` launch."""
    n = st.shape[0]
    if s1 is None:
        s1 = max(n - 1, 0)
    with metrics.timer("chase.tb2bd"):
        st, ut, vt = kernels.tb2bd_wavefront(st, kd_eff, s0, s1)
        if metrics.enabled() and st.is_cuda:
            torch.cuda.synchronize(st.device)
    _mark_device_path()
    if not want_log:
        return st, None, None
    rows = _log_s0(n, s0, s1)
    return (st, split_hh_log(ut, kd_eff, rows),
            split_hh_log(vt, kd_eff, rows))


def tb2bd_d_e(st, kd_eff: int, n: int):
    """(d, e) of the chased bidiagonal on the host — the O(n) handoff to
    the bidiagonal solve."""
    d = st[:, kd_eff].cpu().numpy().copy()
    e = st[:n - 1, kd_eff + 1].cpu().numpy().copy()
    return d, e
