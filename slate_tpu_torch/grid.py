"""Process grid and 2-D block-cyclic layout math — the part of
``slate_tpu/grid.py`` that :mod:`slate_tpu_torch.matrix` and
:mod:`slate_tpu_torch.parallel` need (numpy only).

The cyclic layout is stored in *cyclic-shuffled order* along each tile
axis (:func:`cyclic_permutation`): all tiles with ``i % p == 0`` first,
then residue 1, and so on, so grid row ``r`` owns one contiguous run of
the storage — exactly the tiles ``{i : i % p == r}``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

from .enums import GridOrder


def ceildiv(a: int, b: int) -> int:
    return -(-a // b)


def pad_to(a: int, b: int) -> int:
    return ceildiv(a, b) * b


@dataclasses.dataclass(frozen=True)
class ProcessGrid:
    """A p×q process grid; ``order`` Col means rank = (i%p) + (j%q)*p."""

    p: int
    q: int
    order: GridOrder = GridOrder.Col

    @property
    def size(self) -> int:
        return self.p * self.q

    def tile_rank(self, i: int, j: int) -> int:
        """Owning rank of global tile (i, j)."""
        if self.order is GridOrder.Col:
            return (i % self.p) + (j % self.q) * self.p
        return (i % self.p) * self.q + (j % self.q)


def cyclic_permutation(nt: int, q: int) -> np.ndarray:
    """Permutation placing tiles in cyclic-shuffled storage order:
    ``perm[s]`` is the global tile stored at position ``s``, grouped by
    residue ``i % q``."""
    perm = np.empty(nt, dtype=np.int64)
    s = 0
    for r in range(q):
        for i in range(r, nt, q):
            perm[s] = i
            s += 1
    return perm


def map_permutation(nt: int, p: int, block_map) -> np.ndarray:
    """Storage permutation for a user tile map (separable per axis):
    ``block_map(i)`` is the grid coordinate in ``[0, p)`` owning global
    block ``i``.  Storage groups blocks by owner, ascending within each,
    as :func:`cyclic_permutation` does for the block-cyclic default.
    Every owner must receive exactly ``nt // p`` blocks."""
    groups = [[] for _ in range(p)]
    for i in range(nt):
        r = int(block_map(i))
        if not (0 <= r < p):
            raise ValueError(f"tile map sent block {i} to {r} "
                             f"outside [0, {p})")
        groups[r].append(i)
    want = nt // p
    for r, g in enumerate(groups):
        if len(g) != want:
            raise ValueError(
                f"tile map unbalanced: grid coordinate {r} owns {len(g)} of "
                f"{nt} blocks, need exactly {want}; pad or rebalance the map")
    return np.asarray([i for g in groups for i in g], dtype=np.int64)


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv


def choose_grid(n_devices: int) -> Tuple[int, int]:
    """The squarest p×q factorisation of ``n_devices``."""
    p = int(math.isqrt(n_devices))
    while n_devices % p != 0:
        p -= 1
    return p, n_devices // p


def local_tile_counts(mt: int, p: int) -> np.ndarray:
    """Tiles per residue class: counts[r] = |{i < mt : i % p == r}|."""
    base = mt // p
    extra = mt % p
    return np.array([base + (1 if r < extra else 0) for r in range(p)])
