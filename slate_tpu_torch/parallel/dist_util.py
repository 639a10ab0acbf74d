"""Shared plumbing of the lookahead-pipelined distributed factorizations
and the layout moves — the counterpart of
``slate_tpu/parallel/dist_util.py``: the local↔global row map, the fused
panel broadcasts, the staged step windows, the four ``dist_*`` site
resolvers, ``peye``, ``ptranspose``, ``predistribute`` and
``phermitize``, the placed move between any two layouts (``_move``: the
two-stage middle's rows → column slabs → block-cyclic moves and its
gathers), the drivers' stage timer (``_stage``), the agreement helpers
(``agree_flag``, ``agree_values``), the measured step timeline
(``run_timeline``, ``timeline_steps``, ``clear_timeline``), the
broadcasts' fault seam (``_inject_bcast``) and the ABFT layout
(``_natural_padded``).

The JAX package runs the step plumbing inside ``shard_map`` with a traced
step k and masks every rank-dependent choice
(``jnp.where(k % q == c, ...)``); here k is a Python int and each rank
knows its static (r, c), so those masks are plain branches.  Its layout
moves are permutations of the whole array that XLA's partitioner lowers
to collectives; here each is one ``psum`` of the placed storage
(:func:`~.dist._storage`), which puts the whole padded matrix on every
rank, and then each rank keeps its new blocks.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch

from ..enums import Uplo
from ..grid import ceildiv
from ..ops import kernels
from ..perf import metrics
from .dist import (DistMatrix, _natural, _storage, _take, like,
                   local_indices)
from .mesh import BOTH, mesh_grid_shape


def local_grows(ml: int, nb: int, p: int, r: int) -> np.ndarray:
    """Global row index of each local row on grid row ``r`` (local block
    ``il`` ↦ global block ``il·p + r``), as a host array."""
    lrows = np.arange(ml * nb)
    return ((lrows // nb) * p + r) * nb + lrows % nb


def count_collective(kind: str, nbytes: int, calls: int = 1) -> None:
    """``calls`` all-reduces issued and their bytes, as
    ``collective.<kind>.count`` / ``.bytes`` (the JAX package counts once
    per compiled step body, at trace time; here every executed
    collective counts)."""
    if metrics.enabled():
        metrics.inc("collective.%s.count" % kind, float(calls))
        metrics.inc("collective.%s.bytes" % kind, float(nbytes))


def _inject_bcast(out):
    """The fused broadcasts' fault seam (site ``dist.bcast``,
    :mod:`slate_tpu_torch.resilience.inject`): with no plan, one
    environment read; an ``error`` raises, ``nan``/``inf`` poisons one
    element of the replicated buffer (the corruption the drivers'
    residual gates must catch)."""
    from ..resilience import inject

    kind = inject.poll("dist.bcast")
    if kind == "error":
        raise inject.InjectedFault("dist.bcast")
    if kind in ("nan", "inf"):
        out[(0,) * out.ndim] = float("nan") if kind == "nan" \
            else float("inf")
    return out


def bcast_block_col(mesh, col_loc, grows, own: bool, M: int,
                    chunks: int = 1):
    """Fused panel broadcast, one collective a step: the owner column's
    ranks place their rows of the global block column at their global
    offsets in an (M, w) zero buffer and one ``psum`` over both axes
    replicates the assembled panel (each global row has exactly one
    nonzero contributor).  ``col_loc`` gives the shape on a rank that
    does not own the column and is read only where ``own``.  ``chunks``
    > 1 splits the psum into that many column slices (the same bytes and
    values).  ``grows`` are the global rows of ``col_loc``'s rows."""
    dt, dev = col_loc.dtype, col_loc.device
    w = col_loc.shape[1]
    chunks = max(1, min(int(chunks), w))
    count_collective("bcast_col", M * w * col_loc.element_size(), chunks)
    idx = torch.as_tensor(grows, device=dev)
    csz = ceildiv(w, chunks)
    parts = []
    for i in range(0, w, csz):
        buf = torch.zeros((M, min(csz, w - i)), dtype=dt, device=dev)
        if own:
            buf[idx] = col_loc[:, i:i + csz]
        parts.append(mesh.psum(buf, BOTH))
    return _inject_bcast(parts[0] if len(parts) == 1
                         else torch.cat(parts, dim=1))


def bcast_block_row(mesh, row_loc, gcols, own: bool, N: int,
                    chunks: int = 1):
    """Row-space mirror of :func:`bcast_block_col`: replicate a global
    block row (w, N) with one collective; ``chunks`` splits along the w
    rows."""
    dt, dev = row_loc.dtype, row_loc.device
    w = row_loc.shape[0]
    chunks = max(1, min(int(chunks), w))
    count_collective("bcast_row", w * N * row_loc.element_size(), chunks)
    idx = torch.as_tensor(gcols, device=dev)
    csz = ceildiv(w, chunks)
    parts = []
    for i in range(0, w, csz):
        buf = torch.zeros((min(csz, w - i), N), dtype=dt, device=dev)
        if own:
            buf[:, idx] = row_loc[i:i + csz]
        parts.append(mesh.psum(buf, BOTH))
    return _inject_bcast(parts[0] if len(parts) == 1
                         else torch.cat(parts, dim=0))


def stage_bounds(nt: int, nstages: int = 4):
    """Split the ``nt`` steps into up to ``nstages`` contiguous runs, each
    with a smaller static local trailing window (see :func:`staged_fori`)."""
    s = max(1, min(nstages, nt))
    return [round(i * nt / s) for i in range(s + 1)]


def staged_fori(bounds, p: int, q: int, nb: int, make_body, carry,
                k_lo: int = 0, k_hi: Optional[int] = None):
    """Run the staged factorization loop: steps [ks, ke) of a stage touch
    only global blocks ≥ ks, so every live local row sits at offset ≥
    ``(ks // p)·nb`` and every live local column at ≥ ``(ks // q)·nb``;
    ``make_body(row0, col0)`` returns the stage's step body, called as
    ``carry = body(k, carry)``.  ``k_lo``/``k_hi`` run only steps
    [k_lo, k_hi) from ``carry`` (the chunked runners: checkpoints and the
    measured timeline).  Each step keeps its stage's window, so a run in
    chunks does the monolithic run's products at their shapes and its
    factors are bitwise the monolithic ones.  (The JAX package clips the
    stage bounds to the chunk, ``_range_bounds``, and so starts a chunk's
    window at its first step; a product at another shape may take
    another kernel configuration here.)"""
    k_hi = bounds[-1] if k_hi is None else k_hi
    for s in range(len(bounds) - 1):
        ks, ke = max(bounds[s], k_lo), min(bounds[s + 1], k_hi)
        if ks >= ke:
            continue
        body = make_body((bounds[s] // p) * nb, (bounds[s] // q) * nb)
        for k in range(ks, ke):
            carry = body(k, carry)
    return carry


def agree_flag(mesh, flag: bool, kind: str = "agree") -> bool:
    """True on every rank when ``flag`` is true on any: one psum of a
    one-element buffer (``collective.<kind>``).  The serial stub returns
    ``flag``."""
    buf = torch.tensor([1.0 if flag else 0.0], dtype=torch.float64,
                       device=mesh.device)
    count_collective(kind, 8)
    return bool(mesh.psum(buf, BOTH)[0] > 0)


def agree_values(mesh, *values, kind: str = "agree"):
    """Rank (0, 0)'s ``values`` on every rank: one psum of a buffer only
    rank (0, 0) fills (``collective.<kind>``).  Returns Python floats."""
    mine = (mesh.r, mesh.c) == (0, 0)
    buf = torch.tensor([float(v) if mine else 0.0 for v in values],
                       dtype=torch.float64, device=mesh.device)
    count_collective(kind, 8 * len(values))
    return mesh.psum(buf, BOTH).tolist()


# ---------------------------------------------------------------------------
# The measured step timeline
# ---------------------------------------------------------------------------

_timeline_steps: list = []


def timeline_steps() -> list:
    """Copies of the latest timeline run's rows (``{"driver", "k0", "k1",
    "wall_s", "bcast_bytes", "bcast_count"}``); empty before one."""
    return [dict(r) for r in _timeline_steps]


def clear_timeline() -> None:
    del _timeline_steps[:]


def run_timeline(driver: str, nt: int, window: int, run_chunk,
                 device=None):
    """Drive ``run_chunk(carry, k0, k1)`` over ``[0, nt)`` one
    ``window``-step chunk at a time, measuring each: its host wall
    (synchronized with the card when ``device`` is a CUDA device), its
    ``collective.bcast_*`` byte and count deltas (while metrics are on),
    a ``dist.step.<driver>`` timer, a :class:`slate_tpu_torch.trace.Block`
    span and a ``dist.step`` flight-recorder event.  The chunks run the
    monolithic driver's steps (:func:`staged_fori`), so the factors are
    bitwise the monolithic ones.  Returns the final carry; the rows land
    in :func:`timeline_steps`."""
    import time as _time

    from .. import trace as _trace
    from ..perf import blackbox

    cuda = device is not None and torch.device(device).type == "cuda"
    window = max(1, int(window))
    steps = []
    carry = None
    k = 0
    while k < nt:
        k1 = min(k + window, nt)
        before = metrics.snapshot()
        if cuda:
            torch.cuda.synchronize(device)
        t0 = _time.perf_counter()
        with _trace.Block("dist.%s.k%d" % (driver, k)):
            carry = run_chunk(carry, k, k1)
            if cuda:
                torch.cuda.synchronize(device)
        wall = _time.perf_counter() - t0
        c = metrics.snapshot_delta(before, metrics.snapshot())["counters"]
        row = {"driver": driver, "k0": int(k), "k1": int(k1),
               "wall_s": wall,
               "bcast_bytes": float(
                   c.get("collective.bcast_col.bytes", 0.0)
                   + c.get("collective.bcast_row.bytes", 0.0)),
               "bcast_count": float(
                   c.get("collective.bcast_col.count", 0.0)
                   + c.get("collective.bcast_row.count", 0.0))}
        steps.append(row)
        metrics.observe_time("dist.step.%s" % driver, wall)
        blackbox.record("dist.step", **row)
        k = k1
    _timeline_steps[:] = steps
    return carry


def _natural_padded(dm: DistMatrix, data=None):
    """The whole padded matrix in natural (unshuffled) order on every rank
    (``data`` in place of ``dm.data``): the layout the ABFT factor
    identities are verified in, since the drivers factor the padded
    matrix.  One psum of the placed storage."""
    x = dm if data is None else like(dm, data)
    return _natural(x, _storage(x), dm.mtp * dm.row_nb, dm.ntp * dm.nb)


def dist_panel_backend(op: str, nb: int, dtype, device, m=None,
                       w=None) -> str:
    """The ``dist_panel`` site for a driver's per-step panel solve
    (:func:`slate_tpu_torch.perf.autotune.choose_dist_panel`).
    Eligibility: a real float dtype, a power-of-two nb in [32, 1024],
    fp32 on the card (the kernels are fp32 kernels; the CPU runs their
    plain versions in any real float, as the JAX package's interpret
    mode does).  ``pallas_panel`` needs fp32 (its two kernels' wrappers
    take nothing else); ``pallas_fused`` needs the fused kernels' own
    shape rule (:func:`~slate_tpu_torch.ops.kernels.fused_panel_fits`) at
    the panel height ``m`` (ppotrf) or the widest block row ``w``
    (pgetrf).  The JAX package gates that rung on its VMEM budget
    instead, which the port does not copy.  ``"geqrf"``'s kernel rung is
    the CholQR² panel (:func:`slate_tpu_torch.linalg.qr._cholqr2_panel`),
    an fp32 path on either device, so its eligibility narrows to fp32
    (``slate_tpu/parallel/dist_util.py:80-81``)."""
    from ..perf.autotune import choose_dist_panel

    dev = torch.device(device)
    real = dtype in (torch.float32, torch.float64)
    eligible = (real and 32 <= nb <= 1024 and nb & (nb - 1) == 0
                and (dtype == torch.float32 or dev.type == "cpu")
                and (op != "geqrf" or dtype == torch.float32))
    dims = tuple(d for d in (m, w) if d is not None)
    return choose_dist_panel(op, nb, dtype, dev, eligible,
                             dtype == torch.float32,
                             kernels.fused_panel_fits(nb, dims, dev), m, w)


def dist_pivot_backend(nb: int, p: int, dtype, device) -> str:
    """The ``dist_pivot`` site for pgetrf's panel pivot search."""
    from ..perf.autotune import choose_dist_pivot

    eligible = dtype.is_floating_point and nb >= 2 and p >= 1
    return choose_dist_pivot(nb, p, dtype, torch.device(device), eligible)


def dist_chunk_slices(op: str, nb: int, dtype, mesh) -> int:
    """The ``dist_chunk`` site: how many slices each fused panel
    broadcast splits into, as an int clamped to [1, nb]."""
    from ..perf.autotune import choose_dist_chunk

    p, q = mesh_grid_shape(mesh)
    name = choose_dist_chunk(op, nb, dtype, p, q, mesh.device)
    n = 1 if name == "whole" else int(name)
    return max(1, min(n, nb))


def dist_lookahead_depth(op: str, nt: int, nb: int, dtype, device) -> int:
    """The ``dist_lookahead`` site: the depth D of the panel ring, as an
    int clamped to the step count."""
    from ..perf.autotune import choose_dist_lookahead

    name = choose_dist_lookahead(op, nt, nb, dtype, torch.device(device))
    return max(1, min(int(name), max(1, nt)))


# ---------------------------------------------------------------------------
# Layout moves
# ---------------------------------------------------------------------------

def peye(n: int, nb: int, mesh, dtype=torch.float32,
         pad_mult: Optional[int] = None) -> DistMatrix:
    """The n×n identity, each rank building its own shard (nothing is
    communicated); the tile counts padded to a multiple of ``pad_mult``
    (default lcm(p, q)), the padding zero."""
    p, q = mesh_grid_shape(mesh)
    mult = pad_mult or math.lcm(p, q)
    ntp = ceildiv(ceildiv(n, nb), mult) * mult
    dev = mesh.device
    grows = torch.as_tensor(local_grows(ntp // p, nb, p, mesh.r), device=dev)
    gcols = torch.as_tensor(local_grows(ntp // q, nb, q, mesh.c), device=dev)
    eye = (grows[:, None] == gcols[None, :]) & (grows[:, None] < n)
    return DistMatrix(eye.to(dtype), n, n, nb, mesh)


def _square_tiles(name: str, dm: DistMatrix) -> None:
    if dm.row_nb != dm.nb:
        raise ValueError(f"{name} needs square tiles (mb == nb)")


def _regrid(nat, mesh, mtp: int, ntp: int, nb: int) -> torch.Tensor:
    """This rank's shard of the natural-order matrix ``nat`` laid out as
    mtp×ntp tiles of nb on ``mesh``, zero past ``nat``'s extent."""
    p, q = mesh_grid_shape(mesh)
    rows = local_indices(mtp, p, mesh.r, nb)
    cols = local_indices(ntp, q, mesh.c, nb)
    return _take(nat, rows, cols, nat.shape[0], nat.shape[1], torch.zeros(
        (len(rows), len(cols)), dtype=nat.dtype, device=mesh.device))


@contextlib.contextmanager
def _stage(name: str, mesh):
    """A metrics timer around one stage, synchronized with the card at
    its end while metrics are on (host wall otherwise)."""
    with metrics.timer(name):
        yield
        if metrics.enabled() and mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)


def _col_bounds(n: int, mesh) -> list:
    """Column slabs of the distributed middle: rank d (row-major grid
    order) holds every row of columns [b[d], b[d+1])."""
    nr = mesh.p * mesh.q
    return [d * n // nr for d in range(nr + 1)]


def _move(mesh, x, rows: np.ndarray, cols: np.ndarray, dst):
    """Move a matrix between two layouts over the same ranks: this rank
    holds ``x``, the entries at global ``rows`` × ``cols`` (each entry
    held by one rank); ``dst(d)`` gives rank d's global (rows, cols),
    ascending.  One psum a destination rank of a buffer its block's
    size, each entry placed by its holder — one psum in all where every
    rank's destination is the same (a gather); returns this rank's block
    (zero where no rank held an entry)."""
    me = mesh.r * mesh.q + mesh.c
    dev = x.device
    dsts = [dst(d) for d in range(mesh.p * mesh.q)]
    shared = all(np.array_equal(dr, dsts[0][0]) and
                 np.array_equal(dc, dsts[0][1]) for dr, dc in dsts)
    out = None
    for d in ([me] if shared else range(len(dsts))):
        drows, dcols = dsts[d]
        buf = torch.zeros((len(drows), len(dcols)), dtype=x.dtype,
                          device=dev)
        pr = np.searchsorted(drows, rows)
        rin = np.flatnonzero((pr < len(drows)) & (drows[np.minimum(
            pr, len(drows) - 1)] == rows)) if len(drows) else pr[:0]
        pc = np.searchsorted(dcols, cols)
        cin = np.flatnonzero((pc < len(dcols)) & (dcols[np.minimum(
            pc, len(dcols) - 1)] == cols)) if len(dcols) else pc[:0]
        if len(rin) and len(cin):
            src = x.index_select(0, torch.as_tensor(rin, device=dev)) \
                .index_select(1, torch.as_tensor(cin, device=dev))
            buf[torch.as_tensor(pr[rin], device=dev)[:, None],
                torch.as_tensor(pc[cin], device=dev)[None, :]] = src
        mesh.psum(buf, BOTH)
        if d == me:
            out = buf
    return out


def _rows_to_cols(mesh, x, rows: np.ndarray, m: int, n: int):
    """Rows → column slabs (:func:`_col_bounds`) of an (m, n) matrix whose
    global ``rows`` this rank holds, each row whole: returns this rank's
    (m, slab) block."""
    b = _col_bounds(n, mesh)
    allrows = np.arange(m)
    return _move(mesh, x, rows, np.arange(n),
                 lambda d: (allrows, np.arange(b[d], b[d + 1])))


def ptranspose(dm: DistMatrix, conj: bool = False) -> DistMatrix:
    """Aᵀ (Aᴴ where ``conj``) as a DistMatrix on the same mesh, the whole
    padded storage transposed (padding included) and its tile counts
    padded to multiples of lcm(p, q), as the JAX package's
    ``ptranspose`` lays it out (``slate_tpu/parallel/dist_util.py:596``)."""
    _square_tiles("ptranspose", dm)
    p, q = dm.grid_shape
    lcm = math.lcm(p, q)
    mtp2 = ceildiv(dm.ntp, lcm) * lcm      # new row tiles = old column tiles
    ntp2 = ceildiv(dm.mtp, lcm) * lcm
    nat = _natural(dm, _storage(dm), dm.mtp * dm.nb, dm.ntp * dm.nb)
    at = nat.mT.conj().resolve_conj() if conj else nat.mT
    return DistMatrix(_regrid(at, dm.mesh, mtp2, ntp2, dm.nb), dm.n, dm.m,
                      dm.nb, dm.mesh)


def _same_ranks(a, b) -> bool:
    if a.p * a.q != b.p * b.q:
        return False
    if a.groups is None or b.groups is None:
        return a.groups is b.groups
    return a.groups[BOTH] is b.groups[BOTH]


def predistribute(dm: DistMatrix, nb_new: Optional[int] = None,
                  mesh_new=None) -> DistMatrix:
    """Re-tile a distributed matrix to a new block size and/or a new grid
    over the same ranks (reference ``slate::redistribute``,
    ``src/redistribute.cc:20``): the m×n matrix (its padding dropped) in
    tiles of ``nb_new``, the tile counts padded to multiples of the new
    grid's lcm(p, q).  A grid over other ranks raises ``ValueError``."""
    _square_tiles("predistribute", dm)
    nb_new = nb_new or dm.nb
    mesh_new = dm.mesh if mesh_new is None else mesh_new
    if not _same_ranks(dm.mesh, mesh_new):
        raise ValueError("predistribute moves a matrix between grids over "
                         "the same ranks; %r is not over the ranks of %r"
                         % (mesh_new, dm.mesh))
    p2, q2 = mesh_grid_shape(mesh_new)
    lcm2 = math.lcm(p2, q2)
    mtp2 = ceildiv(ceildiv(dm.m, nb_new), lcm2) * lcm2
    ntp2 = ceildiv(ceildiv(dm.n, nb_new), lcm2) * lcm2
    nat = _natural(dm, _storage(dm), dm.m, dm.n).to(mesh_new.device)
    return DistMatrix(_regrid(nat, mesh_new, mtp2, ntp2, nb_new), dm.m,
                      dm.n, nb_new, mesh_new)


def phermitize(a: DistMatrix, uplo: Uplo) -> DistMatrix:
    """Fill the unreferenced triangle from the stored one:
    A ← tri(A) + tri(A)ᴴ − diag (a single stored triangle made the full
    Hermitian matrix the dense distributed kernels take)."""
    from .dist_aux import ptri_mask

    keep = ptri_mask(a, uplo)
    mirror = ptranspose(keep, conj=True)
    dmat = ptri_mask(ptri_mask(keep, Uplo.Lower), Uplo.Upper)
    return like(a, keep.data + mirror.data - dmat.data.conj())
