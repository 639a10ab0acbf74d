"""Out-of-core getrf/potrf — right-looking factorizations over the host
tile pool, the port of ``slate_tpu/linalg/ooc.py:53-267``.

The matrix lives in host memory as a tile grid
(:class:`slate_tpu_torch.ops.tilepool.TilePool`) and each step assembles
its panel and strips from the pool's bounded window of tiles on the
device.  The in-core code does every flop: the LU panel factors through
:func:`_panel_lu` (on the card, the scattered driver's
``getrf_panel_fused`` kernel, or for a panel too tall for it the blocked
recursion on ``getrf_panel_linv`` leaves), the strip and tile updates through
:func:`slate_tpu_torch.ops.blocks.matmul` (the ``matmul`` kernel).  The
pool decides only where the operands live, and prefetches the next
strip's tiles while the current one computes.

Residency never changes arithmetic: the same operations run in the same
order whatever the window, so a forced two-tile window, a window with
prefetch off and an all-resident window give bitwise-identical factors.

With ``SLATE_TPU_TORCH_CKPT_EVERY_STEPS`` set the step loop runs under
:func:`slate_tpu_torch.resilience.checkpoint.run_checkpointed`: the pool
is flushed at each window boundary, so the snapshot is the exact host
image, and an injected ``device_loss`` rewinds to the last boundary and
replays bitwise.

Dispatch: the ``ooc`` site (:func:`choose`,
:func:`slate_tpu_torch.perf.autotune.choose_ooc`) answers ``"pool"`` or
``"incore"`` per (n, nb, dtype, device); ``SLATE_TPU_TORCH_OOC`` forces
it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..ops.tilepool import ooc_nb
from ..perf import metrics

__all__ = ["getrf_ooc", "potrf_ooc", "ooc_nb", "pool_eligible", "choose"]

#: the pool pays off only when the tile grid is at least this many tiles
#: on a side (a 1×1 grid is in core by definition)
_OOC_MIN_GRID = 2


def pool_eligible(av) -> bool:
    """Shape and dtype gate of the out-of-core drivers: a real square
    fp32/fp64 tensor on a uniform ``ooc_nb()`` grid of at least 2×2
    tiles, on the CPU or a card whose current stream is not capturing a
    graph (the pool's copies and host reads cannot be captured; the
    counterpart of the JAX package's tracer check).  Whether an eligible
    operand takes the pool is the ``ooc`` site's decision."""
    if not isinstance(av, torch.Tensor) or av.ndim != 2:
        return False
    if av.device.type not in ("cpu", "cuda"):
        return False
    if av.is_cuda and torch.cuda.is_current_stream_capturing():
        return False
    m, n = int(av.shape[0]), int(av.shape[1])
    if m != n or av.dtype not in (torch.float32, torch.float64):
        return False
    t = ooc_nb()
    return n % t == 0 and n // t >= _OOC_MIN_GRID


def choose(av) -> str:
    """The ``ooc`` site's decision for one operand, shared by the getrf
    and potrf dispatches."""
    from ..method import select_backend

    n = int(av.shape[-1]) if getattr(av, "ndim", 0) == 2 else 0
    return select_backend("ooc", n=n, nb=ooc_nb(), dtype=av.dtype,
                          device=getattr(av, "device", "cpu"),
                          eligible=pool_eligible(av))


def _operand(a, device):
    """``a`` as a tensor, and the device the steps run on: ``device``,
    else the tensor's own, else ``cuda``."""
    src = a if isinstance(a, torch.Tensor) else torch.as_tensor(
        np.asarray(a))
    if device is not None:
        return src, resolve_device(device)
    if isinstance(a, torch.Tensor):
        return src, src.device
    return src, resolve_device(None)


# ---------------------------------------------------------------------------
# getrf
# ---------------------------------------------------------------------------

def _panel_lu(panel, nb: int):
    """``(lu, perm)`` of one ``(m_k, nb)`` column panel with true partial
    pivoting, as the JAX package's scattered driver gives every panel of
    up to 16384 rows.  The in-core drivers
    (:func:`slate_tpu_torch.linalg.lu._getrf_incore`, never the ``ooc``
    gate, or a forced pool would recurse), but a panel taller than the
    tall loop's threshold that the scattered driver cannot hold (on the
    card: more than 12144 rows at nb 512) takes the blocked recursion on
    ``getrf_panel_linv`` leaves of the widest width the kernel holds at
    m_k rows (256 at 16384), not the Auto tall loop's tournament; where no
    leaf fits, the tall loop's partial-pivot form."""
    from ..enums import MethodLU
    from . import lu as _lu

    m = int(panel.shape[0])
    if m <= _lu._MAX_LU_PANEL_ROWS or \
            _lu._choose_lu_driver(panel) == "scattered":
        return _lu._getrf_incore(panel, nb)
    w = nb
    while w > 64 and not _lu._use_kernel_panel(m, w, panel.dtype,
                                                panel.device):
        w //= 2
    if _lu._use_kernel_panel(m, w, panel.dtype, panel.device):
        return _lu.getrf_rec(panel, w)
    return _lu._getrf_incore(panel, nb, MethodLU.PartialPiv)


def _getrf_steps(pool, perm: np.ndarray, k0: int, k1: int) -> np.ndarray:
    """Right-looking LU steps ``k ∈ [k0, k1)`` on the pool in place;
    returns the updated global row permutation.  A step factors the
    block column's panel with the in-core driver, then takes every other
    block column's rows-below-k strip, swaps its rows (both sides of the
    panel, the LAPACK contract), solves with the unit-lower L11 and
    updates it with one rank-nb product, in the JAX package's order."""
    from ..ops import blocks

    g, nb = pool.gi, pool.nb
    for k in range(k0, k1):
        rows = list(range(k, g))
        pool.prefetch((i, k) for i in rows)
        with metrics.step_timer("getrf", "panel"):
            panel = torch.cat([pool.get(i, k) for i in rows], dim=0)
            lu_p, piv = _panel_lu(panel, nb)
        for t, i in enumerate(rows):
            pool.put(i, k, lu_p[t * nb:(t + 1) * nb])
        piv_np = piv.cpu().numpy()
        perm = perm.copy()
        perm[k * nb:] = perm[k * nb:][piv_np]
        l11 = lu_p[:nb]
        l21 = lu_p[nb:]
        # trailing columns first: their tiles are the next step's
        # working set, so they end the step most recently used
        for j in list(range(k + 1, g)) + list(range(k)):
            pool.prefetch((i, j) for i in rows)
            strip = torch.cat([pool.get(i, j) for i in rows], dim=0)
            with metrics.step_timer("getrf", "pivot"):
                strip = strip[piv]
            if j > k:
                with metrics.step_timer("getrf", "trsm"):
                    u = torch.linalg.solve_triangular(
                        l11, strip[:nb], upper=False, left=True,
                        unitriangular=True)
                if strip.shape[0] > nb:
                    with metrics.step_timer("getrf", "update"):
                        rest = strip[nb:] - blocks.matmul(l21, u)
                    strip = torch.cat([u, rest], dim=0)
                else:
                    strip = u
            for t, i in enumerate(rows):
                pool.put(i, j, strip[t * nb:(t + 1) * nb])
    return perm


def getrf_ooc(a, nb: int | None = None, capacity: int | None = None,
              depth: int | None = None, to_device: bool = True, *,
              device=None):
    """Out-of-core partial-pivot LU over the host tile pool: ``(lu, perm)``
    with ``A[perm] = L·U`` as the in-core drivers return it.  ``nb``
    defaults to :func:`ooc_nb`, ``capacity``/``depth`` to the window and
    prefetch knobs.  The steps run on ``device`` (default: the operand's
    device, ``cuda`` for host data); ``to_device=False`` returns CPU
    tensors, the only form for a factor larger than the card."""
    from ..ops.tilepool import TilePool

    src, dev = _operand(a, device)
    nb = int(nb) if nb else ooc_nb()
    if src.ndim != 2 or src.shape[0] != src.shape[1] or src.shape[0] % nb:
        raise ValueError("getrf_ooc needs a square matrix on a uniform "
                         "%d-tile grid, got %s" % (nb, tuple(src.shape)))
    m = int(src.shape[0])
    g = m // nb
    out_dev = dev if to_device else None
    from ..resilience import checkpoint

    every = checkpoint.every_steps()
    if every > 0 and g > 1:
        def run_chunk(carry, k0, k1):
            host, perm = carry if carry is not None \
                else (src, np.arange(m))
            pool = TilePool(host, nb, capacity, depth, op="getrf",
                            device=dev)
            perm = _getrf_steps(pool, np.asarray(perm), k0, k1)
            return (pool.array(), perm)

        host, perm = checkpoint.run_checkpointed(g, every, run_chunk,
                                                 label="getrf_ooc")
        lu = host if out_dev is None else host.to(out_dev)
    else:
        pool = TilePool(src, nb, capacity, depth, op="getrf", device=dev)
        perm = _getrf_steps(pool, np.arange(m), 0, g)
        lu = pool.array(out_dev)
    perm = torch.as_tensor(np.asarray(perm), dtype=torch.int64)
    return lu, perm if out_dev is None else perm.to(out_dev)


# ---------------------------------------------------------------------------
# potrf
# ---------------------------------------------------------------------------

def _potrf_steps(pool, k0: int, k1: int) -> None:
    """Right-looking tiled Cholesky steps ``k ∈ [k0, k1)``: the diagonal
    tile's factor (symmetrized first, as ``lax.linalg.cholesky`` does),
    the block column's solves, and the symmetric rank-nb update of the
    lower tiles, one full-nb product a tile, so tiling changes nothing
    bitwise."""
    from ..ops import blocks

    g = pool.gi
    for k in range(k0, k1):
        with metrics.step_timer("potrf", "panel"):
            akk = pool.get(k, k)
            lkk = torch.tril(torch.linalg.cholesky((akk + akk.mT) / 2))
        pool.put(k, k, lkk)
        below = list(range(k + 1, g))
        pool.prefetch((i, k) for i in below)
        for i in below:
            with metrics.step_timer("potrf", "trsm"):
                lik = torch.linalg.solve_triangular(
                    lkk.mT, pool.get(i, k), upper=True, left=False)
            pool.put(i, k, lik)
        for j in below:
            ljk_t = pool.get(j, k).mT
            pool.prefetch((i, j) for i in range(j, g))
            for i in range(j, g):
                with metrics.step_timer("potrf", "update"):
                    upd = pool.get(i, j) - blocks.matmul(pool.get(i, k),
                                                         ljk_t)
                pool.put(i, j, upd)


def potrf_ooc(a, nb: int | None = None, capacity: int | None = None,
              depth: int | None = None, to_device: bool = True, *,
              device=None):
    """Out-of-core Cholesky over the host tile pool: the lower-triangular
    factor (the ``_potrf_dispatch`` contract; ``linalg.cholesky.potrf``
    wraps it).  Placement as :func:`getrf_ooc`."""
    from ..ops.tilepool import TilePool

    src, dev = _operand(a, device)
    nb = int(nb) if nb else ooc_nb()
    n = int(src.shape[-1])
    if src.ndim != 2 or src.shape[0] != n or n % nb:
        raise ValueError("potrf_ooc needs a square matrix on a uniform "
                         "%d-tile grid, got %s" % (nb, tuple(src.shape)))
    g = n // nb
    out_dev = dev if to_device else None
    from ..resilience import checkpoint

    every = checkpoint.every_steps()
    if every > 0 and g > 1:
        def run_chunk(carry, k0, k1):
            pool = TilePool(src if carry is None else carry, nb, capacity,
                            depth, op="potrf", device=dev)
            _potrf_steps(pool, k0, k1)
            return pool.array()

        host = checkpoint.run_checkpointed(g, every, run_chunk,
                                           label="potrf_ooc")
        host = host if out_dev is None else host.to(out_dev)
    else:
        pool = TilePool(src, nb, capacity, depth, op="potrf", device=dev)
        _potrf_steps(pool, 0, g)
        host = pool.array(out_dev)
    return host.tril_()
