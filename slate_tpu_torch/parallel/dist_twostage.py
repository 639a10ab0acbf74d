"""Distributed two-stage reductions — the counterpart of
``slate_tpu/parallel/dist_twostage.py``.

Ported so far: :func:`_papply_q`, the distributed application of a packed
column-panel reflector chain, which ``punmlq`` takes for Q̃ᴴ·B and which
the two-stage drivers (pheev, psvd) will take for their back-transforms.
"""

from __future__ import annotations

import torch

from ..ops.blocks import matmul as _mm
from .dist_util import local_grows
from .mesh import AXIS_P, AXIS_Q, mesh_grid_shape


def _papply_q(mesh, fac_loc, tmats, z_loc, nb: int, npanels: int,
              shift_blocks: int, forward: bool):
    """Z ← Q·Z (``forward``: panels last to first with T) or Qᴴ·Z (first
    to last with Tᴴ) for the packed column panels of ``fac_loc`` (this
    rank's shard) and the replicated T blocks ``tmats``, on a
    row-distributed Z; returns the new local block of Z.  Panel k's V
    starts ``shift_blocks`` blocks below the diagonal (1 for he2hb, 0
    for ge2tb and QR).  A step: the factor's block column k along 'q'
    (one ``psum``), Vᴴ·Z along 'p' (one ``psum``), the local rank-nb
    update (``slate_tpu/parallel/dist_twostage.py:315-352``; reference
    ``unmtr_he2hb`` / ``unmbr_ge2tb`` fan-out)."""
    p, q = mesh_grid_shape(mesh)
    r, c = mesh.r, mesh.c
    ml = fac_loc.shape[0] // nb
    dt, dev = fac_loc.dtype, fac_loc.device
    grows = local_grows(ml, nb, p, r)
    cc = torch.arange(nb, device=dev)[None, :]
    one = torch.ones((), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    z_loc = z_loc.clone()
    for i in range(npanels):
        k = npanels - 1 - i if forward else i
        colk = torch.zeros((ml * nb, nb), dtype=dt, device=dev)
        if k % q == c:
            colk.copy_(fac_loc[:, (k // q) * nb:(k // q + 1) * nb])
        mesh.psum(colk, AXIS_Q)
        relc = torch.as_tensor(grows - (k + shift_blocks) * nb,
                               device=dev)[:, None]
        v_loc = torch.where(relc > cc, colk,
                            torch.where(relc == cc, one, zero))
        v_loc = v_loc * (relc >= 0).to(dt)
        tmat = tmats[k]
        tt = tmat if forward else tmat.mH
        w = mesh.psum(_mm(v_loc.mH, z_loc), AXIS_P)
        z_loc -= _mm(v_loc, _mm(tt, w))
    return z_loc
