"""Process grids over ``torch.distributed`` — the counterpart of
``slate_tpu/parallel/mesh.py``.

The JAX package builds a ``jax.sharding.Mesh`` with axes ``('p', 'q')``
over its devices and runs one program per device under ``shard_map``.
Here one process runs per grid position (:mod:`.launch` starts them) and
a :class:`Mesh` holds that process's p×q shape, its coordinates (r, c),
its device and three process groups: axis ``'p'`` (the ranks sharing c),
axis ``'q'`` (the ranks sharing r) and both axes.  The drivers' only
collectives are :meth:`Mesh.psum` and :meth:`Mesh.pmax` over those
groups (an all-reduce, which NCCL and Gloo both offer for CUDA tensors);
JAX's ``all_gather`` becomes a ``psum`` of a zero-filled buffer with each
rank's rows placed.

With no process group and a 1×1 grid :func:`make_grid_mesh` returns the
serial stub, whose collectives are identities, as the JAX package's 1×1
mesh is.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..config import resolve_device
from ..grid import ProcessGrid, choose_grid

AXIS_P = "p"
AXIS_Q = "q"
BOTH = (AXIS_P, AXIS_Q)


def _axes_key(axes) -> tuple:
    if isinstance(axes, str):
        axes = (axes,)
    key = tuple(sorted(set(axes)))
    if not key or any(a not in BOTH for a in key):
        raise ValueError("mesh axes are %s, got %r" % (BOTH, axes))
    return key


class Mesh:
    """This process's place in a p×q grid: ``p``, ``q``, its coordinates
    ``r``, ``c``, its ``device`` and the process groups of each axis set
    (None in the serial stub)."""

    def __init__(self, p: int, q: int, r: int, c: int, device,
                 groups: Optional[dict] = None):
        self.p, self.q, self.r, self.c = p, q, r, c
        self.device = torch.device(device)
        self.groups = groups

    def axis_index(self, axis: str) -> int:
        if axis == AXIS_P:
            return self.r
        if axis == AXIS_Q:
            return self.c
        raise ValueError("mesh axes are %s, got %r" % (BOTH, axis))

    def _reduce(self, x, axes, op):
        if self.groups is None:
            return x
        dist.all_reduce(x, op=op, group=self.groups[_axes_key(axes)])
        return x

    def psum(self, x, axes=BOTH):
        """Sum ``x`` over the ranks of ``axes``, IN PLACE (the caller
        passes a buffer it owns); returns ``x``."""
        return self._reduce(x, axes, dist.ReduceOp.SUM)

    def pmax(self, x, axes=BOTH):
        """Elementwise maximum of ``x`` over the ranks of ``axes``, in
        place; returns ``x``."""
        return self._reduce(x, axes, dist.ReduceOp.MAX)

    def __repr__(self):
        return ("Mesh(%dx%d, rank (%d, %d), %s, %s)"
                % (self.p, self.q, self.r, self.c, self.device,
                   "serial" if self.groups is None else
                   dist.get_backend()))


def _coords(rank: int, p: int, q: int, grid_order: str) -> Tuple[int, int]:
    """Grid coordinates of ``rank``: row-major ("row", BLACS 'R') or
    column-major ("col"), as ``make_grid_mesh`` of the JAX package lays
    its flat device list on the grid."""
    if grid_order == "row":
        return rank // q, rank % q
    return rank % p, rank // p


def make_grid_mesh(p: Optional[int] = None, q: Optional[int] = None,
                   grid_order: str = "row", device=None) -> Mesh:
    """This process's :class:`Mesh` of a p×q grid over the initialized
    ``torch.distributed`` world (the squarest grid of the world's size by
    default).  ``device`` defaults to ``cuda:<local rank % device
    count>`` (``LOCAL_RANK``, else the rank) and goes through
    :func:`~slate_tpu_torch.config.resolve_device`, so asking for the
    card where there is none raises.  With no process group the grid
    must be 1×1 and the serial stub is returned.  Every rank of the
    world must call this, in the same order: it creates process groups."""
    if grid_order not in ("row", "col"):
        raise ValueError("grid_order must be 'row' or 'col', got %r"
                         % (grid_order,))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if p is None and q is None:
        p, q = choose_grid(world)
    elif p is None:
        p = world // q
    elif q is None:
        q = world // p
    if p * q != world:
        raise ValueError("grid %dx%d does not match a world of %d process%s%s"
                         % (p, q, world, "" if world == 1 else "es",
                            "" if dist.is_initialized() else
                            " (torch.distributed is not initialized)"))
    rank = dist.get_rank() if dist.is_initialized() else 0
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    r, c = _coords(rank, p, q, grid_order)
    if not dist.is_initialized():
        return Mesh(1, 1, 0, 0, dev)
    everyone = list(range(world))
    members = {(AXIS_P,): [[i for i in everyone
                            if _coords(i, p, q, grid_order)[1] == cc]
                           for cc in range(q)],
               (AXIS_Q,): [[i for i in everyone
                            if _coords(i, p, q, grid_order)[0] == rr]
                           for rr in range(p)],
               BOTH: [everyone]}
    groups = {}
    for key, sets in members.items():
        for ranks in sets:
            # every rank creates every group, in one order
            g = dist.group.WORLD if len(ranks) == world else \
                dist.new_group(ranks)
            if rank in ranks:
                groups[key] = g
    return Mesh(p, q, r, c, dev, groups)


def default_mesh() -> Mesh:
    return make_grid_mesh()


def mesh_grid_shape(mesh: Mesh) -> Tuple[int, int]:
    return mesh.p, mesh.q


def grid_of(mesh: Mesh) -> ProcessGrid:
    return ProcessGrid(mesh.p, mesh.q)
