"""Debug invariants — the port of ``slate_tpu/debug.py:23-122`` (the
reference's ``Debug`` class, ``src/auxiliary/Debug.cc``): value sanity
per tile, the layout of a distributed matrix, the leak counters of a
memory pool and the device allocator's gauges.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from .exceptions import SlateError

__all__ = ["check_dist_layout", "check_finite", "check_pool_leaks",
           "device_memory_stats", "memory_stats"]


def check_finite(a, nb: int = 256, name: str = "A") -> None:
    """Raise :class:`SlateError` listing every (i, j) tile of ``a`` (a
    Matrix-family object, a tensor or array-like) holding a NaN or Inf —
    the role of the reference's per-tile dumps (``Debug::printTiles_``)."""
    arr = getattr(a, "array", a)
    arr = arr if isinstance(arr, torch.Tensor) else torch.as_tensor(arr)
    finite = torch.isfinite(arr)
    if bool(finite.all()):
        return
    m, n = arr.shape[-2], arr.shape[-1]
    mt, nt = -(-m // nb), -(-n // nb)
    # a tile is bad where any of its elements (in any batch entry) is
    bad_el = (~finite).reshape(-1, m, n).any(0)
    pad = torch.zeros((mt * nb, nt * nb), dtype=torch.bool,
                      device=bad_el.device)
    pad[:m, :n] = bad_el
    tiles = pad.reshape(mt, nb, nt, nb).any(3).any(1).nonzero().tolist()
    bad: List[Tuple[int, int]] = [(int(i), int(j)) for i, j in tiles]
    raise SlateError(f"{name}: non-finite values in tiles {bad} (nb={nb})")


def check_dist_layout(dm) -> None:
    """Validate a :class:`~slate_tpu_torch.parallel.dist.DistMatrix`'s
    layout (``Debug::checkTilesLayout``): this rank's shard a whole number
    of tiles, the tile grid divisible by the process grid, the true dims
    inside the padded storage."""
    p, q = dm.grid_shape
    h, w = dm.data.shape
    if h % dm.row_nb or w % dm.nb:
        raise SlateError(f"local shard {tuple(dm.data.shape)} not a multiple "
                         f"of the tile ({dm.row_nb}, {dm.nb})")
    if dm.mtp % p or dm.ntp % q:
        raise SlateError(f"tile grid {dm.mtp}x{dm.ntp} not divisible by "
                         f"process grid {p}x{q}")
    mp, np_ = dm.mtp * dm.row_nb, dm.ntp * dm.nb
    if dm.m > mp or dm.n > np_:
        raise SlateError(f"true dims ({dm.m},{dm.n}) exceed padded storage "
                         f"({mp}, {np_})")


def check_pool_leaks(pool) -> None:
    """Leak check on a memory pool with ``num_allocated`` / ``num_free``
    counters (``Debug::checkHostMemoryLeaks``, ``Debug.cc:316``): every
    allocated block must have been returned."""
    outstanding = pool.num_allocated - pool.num_free
    if outstanding:
        raise SlateError(
            f"memory pool leak: {outstanding} block(s) outstanding "
            f"({pool.num_allocated} allocated, {pool.num_free} free)")


def device_memory_stats() -> list:
    """The caching allocator's gauges per visible card
    (``torch.cuda.memory_stats``): one dict each with ``device``,
    ``platform``, ``bytes_in_use``, ``peak_bytes_in_use``,
    ``bytes_reserved``, ``bytes_limit`` (the card's memory) and
    ``num_allocs``; ``[]`` where there is no card."""
    if not torch.cuda.is_available():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        row = {"device": str(i), "platform": "cuda",
               "bytes_limit": int(
                   torch.cuda.get_device_properties(i).total_memory)}
        for k, key in (("bytes_in_use", "allocated_bytes.all.current"),
                       ("peak_bytes_in_use", "allocated_bytes.all.peak"),
                       ("bytes_reserved", "reserved_bytes.all.current"),
                       ("num_allocs", "allocation.all.allocated")):
            if key in stats:
                row[k] = int(stats[key])
        out.append(row)
    return out


def memory_stats() -> dict:
    """The host library's availability and thread count
    (``Debug::printNumFreeMemBlocks`` territory) and, under
    ``"devices"``, :func:`device_memory_stats`."""
    devices = device_memory_stats()
    from . import native

    if not native.available():
        return {"available": False, "devices": devices}
    return {"available": True, "host_threads": native.num_threads(),
            "devices": devices}
