"""Shared plumbing of the lookahead-pipelined distributed factorizations —
the part of ``slate_tpu/parallel/dist_util.py`` that ppotrf, pgetrf and
their solves run: the local↔global row map, the fused panel broadcasts,
the staged step windows and the four ``dist_*`` site resolvers.

The JAX package runs these inside ``shard_map`` with a traced step k and
masks every rank-dependent choice (``jnp.where(k % q == c, ...)``); here
k is a Python int and each rank knows its static (r, c), so those masks
are plain branches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..grid import ceildiv
from ..ops import kernels
from ..perf import metrics
from .mesh import BOTH, mesh_grid_shape


def local_grows(ml: int, nb: int, p: int, r: int) -> np.ndarray:
    """Global row index of each local row on grid row ``r`` (local block
    ``il`` ↦ global block ``il·p + r``), as a host array."""
    lrows = np.arange(ml * nb)
    return ((lrows // nb) * p + r) * nb + lrows % nb


def _count(kind: str, chunks: int, nbytes: int) -> None:
    """One count per all-reduce issued and its bytes (the JAX package
    counts once per compiled step body, at trace time; here every
    executed broadcast counts)."""
    if metrics.enabled():
        metrics.inc("collective.bcast_%s.count" % kind, float(chunks))
        metrics.inc("collective.bcast_%s.bytes" % kind, float(nbytes))


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
    _count("col", chunks, M * w * col_loc.element_size())
    idx = torch.as_tensor(grows, device=dev)
    csz = ceildiv(w, chunks)
    parts = []
    for i in range(0, w, csz):
        buf = torch.zeros((M, min(csz, w - i)), dtype=dt, device=dev)
        if own:
            buf[idx] = col_loc[:, i:i + csz]
        parts.append(mesh.psum(buf, BOTH))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def bcast_block_row(mesh, row_loc, gcols, own: bool, N: int,
                    chunks: int = 1):
    """Row-space mirror of :func:`bcast_block_col`: replicate a global
    block row (w, N) with one collective; ``chunks`` splits along the w
    rows."""
    dt, dev = row_loc.dtype, row_loc.device
    w = row_loc.shape[0]
    chunks = max(1, min(int(chunks), w))
    _count("row", chunks, w * N * row_loc.element_size())
    idx = torch.as_tensor(gcols, device=dev)
    csz = ceildiv(w, chunks)
    parts = []
    for i in range(0, w, csz):
        buf = torch.zeros((min(csz, w - i), N), dtype=dt, device=dev)
        if own:
            buf[:, idx] = row_loc[i:i + csz]
        parts.append(mesh.psum(buf, BOTH))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def stage_bounds(nt: int, nstages: int = 4):
    """Split the ``nt`` steps into up to ``nstages`` contiguous runs, each
    with a smaller static local trailing window (see :func:`staged_fori`)."""
    s = max(1, min(nstages, nt))
    return [round(i * nt / s) for i in range(s + 1)]


def staged_fori(bounds, p: int, q: int, nb: int, make_body, carry):
    """Run the staged factorization loop: steps [ks, ke) of a stage touch
    only global blocks ≥ ks, so every live local row sits at offset ≥
    ``(ks // p)·nb`` and every live local column at ≥ ``(ks // q)·nb``;
    ``make_body(row0, col0)`` returns the stage's step body, called as
    ``carry = body(k, carry)``."""
    for s in range(len(bounds) - 1):
        ks, ke = bounds[s], bounds[s + 1]
        body = make_body((ks // p) * nb, (ks // q) * nb)
        for k in range(ks, ke):
            carry = body(k, carry)
    return carry


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
    instead, which the port does not copy."""
    from ..perf.autotune import choose_dist_panel

    dev = torch.device(device)
    real = dtype in (torch.float32, torch.float64)
    eligible = (real and 32 <= nb <= 1024 and nb & (nb - 1) == 0
                and (dtype == torch.float32 or dev.type == "cpu"))
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
