"""What the LU panel kernels can hold on the card — the counterpart of
``slate_tpu/ops/vmem.py`` (``fits``, ``:65``).

A TPU kernel keeps a whole panel in one core's VMEM (tens of MB).  On an
H100 a block has at most 227 KB of dynamic shared memory, so the panel
kernels (``csrc/lu_panel.cuh``) spread the panel's lanes over a
cooperative grid of co-resident blocks, each holding its own lanes in
shared memory.  The kernel's launcher (``plan_grid``) starts from one
block per SM, never fewer than 32 lanes a block, and refuses the panel
when that first grid's share of shared memory does not fit one block;
only then does it ask the occupancy query how many blocks may share an
SM.  The gates in :mod:`slate_tpu_torch.linalg.lu` need only the first
step, which this module repeats, so they decide what the kernel will
accept.  The grid itself is sized by the launcher alone.

On the card the SM count comes from the device; everywhere else (the CPU
tests) the H100's constants answer, so the gates decide the same way.
"""

from __future__ import annotations

import torch

#: H100 SXM: streaming multiprocessors
SMS = 132
#: shared memory one block may opt into (bytes), and the panel kernels'
#: static share of it (their reduction scratch)
BLOCK_SMEM_MAX = 232448
STATIC_SMEM = 80
#: fewest lanes a panel-kernel block takes, and the widest inner block
#: (kept equal to lu_panel.cuh's MIN_LANES and MAX_IB)
MIN_LANES = 32
MAX_IB = 32


def _ceildiv(a: int, b: int) -> int:
    return -(-a // b)


def sm_count(device=None) -> int:
    """SMs of ``device`` when it is a CUDA device, else the H100's."""
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.get_device_properties(
            torch.device(device)).multi_processor_count
    return SMS


def fits(nbytes: float) -> bool:
    """True when one block's dynamic shared memory can hold ``nbytes``."""
    return nbytes <= BLOCK_SMEM_MAX - STATIC_SMEM


def lu_panel_bytes(m: int, w: int, ib: int, grid: int) -> int:
    """Dynamic shared memory of one panel-kernel block on a grid of
    ``grid`` blocks: its lanes of the (w, m) panel, the ib published pivot
    columns of the current block, its owned columns of L11⁻¹, the ib×ib
    block inverse and products, its act mask and block-pivot marks, and
    64 words of reduction scratch (``lu_panel.cuh``, ``smem_floats``)."""
    chunk = _ceildiv(m, grid)
    nown = _ceildiv(w, grid)
    return 4 * (w * chunk + ib * w + nown * w + ib * ib + ib * nown
                + 2 * chunk + 64)


def lu_panel_fits(m: int, w: int, ib: int, device=None) -> bool:
    """The shared-memory gate of the LU panel kernels: a (w, m) panel's
    share on ``min(SMs, ceil(m / 32))`` blocks fits one block."""
    if m < 1 or w < 1 or not 1 <= ib <= MAX_IB or w % ib:
        return False
    grid = max(1, min(sm_count(device), _ceildiv(m, MIN_LANES)))
    return fits(lu_panel_bytes(m, w, ib, grid))
