"""Process grid math — the part of ``slate_tpu/grid.py`` that
:mod:`slate_tpu_torch.matrix` needs."""

from __future__ import annotations

import dataclasses

from .enums import GridOrder


def ceildiv(a: int, b: int) -> int:
    return -(-a // b)


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
