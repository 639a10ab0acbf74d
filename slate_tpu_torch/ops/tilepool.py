"""Host-memory tile pool — the software residency of the out-of-core
factorizations, the port of ``slate_tpu/ops/tilepool.py:57-265``.

A matrix lives in host memory as a tile-major ``(gi, gj, nb, nb)`` grid
(pinned where the pool's device is a card, so every tile is one
contiguous block and each transfer runs at the pinned rate without a
pageable staging copy), and a BOUNDED window of tiles lives on the
device:

* **LRU residency** — :meth:`TilePool.get` returns the device copy of a
  tile, fetching it on a miss and evicting the least-recently-used
  resident tile once the window is full;
* **dirty write-back** — a tile installed by :meth:`TilePool.put` is
  dirty and goes back to host memory exactly once, at eviction or
  :meth:`TilePool.flush`;
* **prefetch** — :meth:`TilePool.prefetch` issues the host→device copies
  of the tiles the next strip needs without waiting for them.

On a card every copy, both ways, runs on one side stream of the pool
(``copy``): a fetch is ``copy_(…, non_blocking=True)`` there with an
event recorded after it, and :meth:`get` makes the current stream wait
on that event (the tile was allocated on the copy stream, so it is
recorded on the current one for the caching allocator).  A write-back
waits on the event :meth:`put` recorded on the current stream after the
tile was made, then copies device→host on the same copy stream, so a
later fetch of the same tile is ordered after it; the evicted tile is
recorded on the copy stream so its memory is not reused before the copy
ends.  :meth:`flush` and :meth:`array` synchronize the copy stream
before host memory is read.  With ``device="cpu"`` the device tiles are
host copies and no stream or event is made; the bookkeeping is the same.

Pinning is not optional on a card: if the pinned grid cannot be
allocated the pool raises, rather than turning synchronous.

Counters (through :mod:`slate_tpu_torch.perf.metrics`, nothing while it
is off): ``ooc.prefetch.hits``, ``ooc.prefetch.misses``,
``ooc.evictions``, ``ooc.write_backs`` and the two-way byte odometer
``ooc.host_bytes``, as in the JAX package; the timer
``step.<op>.host`` around each miss and write-back (host wall: the
enqueue on a card).  On a card with metrics on, each copy is also timed
with CUDA events and the copy stream's busy seconds go to the timer
``ooc.link`` when the pool is read back (:meth:`array`).

Importing this module allocates nothing and reads no knob.
"""

from __future__ import annotations

import os
from collections import OrderedDict

import torch

from ..perf import metrics

__all__ = [
    "TilePool", "DEFAULT_WINDOW_TILES", "DEFAULT_PREFETCH_DEPTH",
    "window_tiles", "prefetch_depth", "hbm_budget_bytes", "ooc_nb",
]

#: resident-window size (tiles) when ``SLATE_TPU_TORCH_OOC_WINDOW_TILES``
#: is unset: 64 fp32 512² tiles, 64 MiB on the card
DEFAULT_WINDOW_TILES = 64

#: tiles fetched ahead by one :meth:`TilePool.prefetch` when
#: ``SLATE_TPU_TORCH_OOC_PREFETCH_DEPTH`` is unset
DEFAULT_PREFETCH_DEPTH = 4


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


def window_tiles() -> int:
    """Resident-window capacity in tiles
    (``SLATE_TPU_TORCH_OOC_WINDOW_TILES``, at least 2)."""
    return max(2, _env_int("SLATE_TPU_TORCH_OOC_WINDOW_TILES",
                           DEFAULT_WINDOW_TILES))


def prefetch_depth() -> int:
    """Prefetch look-ahead in tiles (``SLATE_TPU_TORCH_OOC_PREFETCH_DEPTH``;
    0 turns prefetching off)."""
    return max(0, _env_int("SLATE_TPU_TORCH_OOC_PREFETCH_DEPTH",
                           DEFAULT_PREFETCH_DEPTH))


def hbm_budget_bytes(device=None) -> int:
    """The device memory the ``ooc`` site weighs a working set against:
    ``SLATE_TPU_TORCH_OOC_HBM_MB`` MiB where set, else the card's
    ``total_memory`` (``device``, default the current card).  The JAX
    package's default is one TPU's HBM; the port's is the card's own."""
    mb = _env_int("SLATE_TPU_TORCH_OOC_HBM_MB", 0)
    if mb > 0:
        return mb * (1 << 20)
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError("hbm_budget_bytes: %s is not a card; set "
                         "SLATE_TPU_TORCH_OOC_HBM_MB" % dev)
    return int(torch.cuda.get_device_properties(dev).total_memory)


def ooc_nb() -> int:
    """The out-of-core tile edge (``SLATE_TPU_TORCH_OOC_NB``, default 512,
    at least 8)."""
    return max(8, _env_int("SLATE_TPU_TORCH_OOC_NB", 512))


def _owned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where it is contiguous and owns exactly its storage,
    else a copy that does: a row slice of a strip would keep the whole
    strip alive, and the window would bound nothing."""
    if t.is_contiguous() and t.storage_offset() == 0 and \
            t.untyped_storage().nbytes() == t.numel() * t.element_size():
        return t
    return t.clone(memory_format=torch.contiguous_format)


class TilePool:
    """A bounded window of device tiles over a host tile grid.

    ``a`` (a 2-D tensor on the CPU or a card) is copied into a
    zero-padded ``(gi, gj, nb, nb)`` host grid.  ``device`` is where the
    tiles live (default: ``a``'s device).
    ``capacity`` bounds the resident tiles (default :func:`window_tiles`,
    at least 2), ``depth`` the prefetch look-ahead (default
    :func:`prefetch_depth`); ``op`` names the driver in the
    ``step.<op>.host`` timer.

    A tile returned by :meth:`get` stays valid after its eviction (the
    pool drops its reference, not the tensor), so a caller may assemble
    a strip wider than the window.  Residency never changes arithmetic.
    """

    def __init__(self, a: torch.Tensor, nb: int,
                 capacity: int | None = None, depth: int | None = None,
                 op: str = "ooc", device=None):
        if not isinstance(a, torch.Tensor) or a.ndim != 2:
            raise ValueError("TilePool needs a 2-D tensor, got %r"
                             % (getattr(a, "shape", type(a)),))
        self.device = torch.device(device) if device is not None \
            else a.device
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError("TilePool: no tiles on %s" % self.device)
        self.nb = int(nb)
        self.m, self.n = int(a.shape[0]), int(a.shape[1])
        self.gi = -(-self.m // self.nb)
        self.gj = -(-self.n // self.nb)
        self.dtype = a.dtype
        self.op = op
        on_card = self.device.type == "cuda"
        # pinned on a card; torch raises if the pages cannot be pinned.
        # Filled a tile at a time, so a card operand costs one tile of
        # staging on the card, never a second copy of the matrix.
        self.host = torch.zeros((self.gi, self.gj, self.nb, self.nb),
                                dtype=self.dtype, pin_memory=on_card)
        for i, j, rows, cols in self._tiles():
            self.host[i, j, :rows.stop - rows.start,
                      :cols.stop - cols.start].copy_(a[rows, cols])
        self.capacity = max(2, int(capacity) if capacity is not None
                            else window_tiles())
        self.depth = int(depth) if depth is not None else prefetch_depth()
        self._resident: OrderedDict = OrderedDict()   # (i, j) -> tile
        self._dirty: set = set()
        self._prefetched: set = set()
        #: total bytes moved across the host link, both directions
        self.bytes_moved = 0
        self._copy = torch.cuda.Stream(self.device) if on_card else None
        self._ready: dict = {}      # (i, j) -> event after its fetch
        self._made: dict = {}       # (i, j) -> event after its put
        self._timed: list = []      # (start, end) events of each copy

    # -- geometry ----------------------------------------------------------

    @property
    def tile_bytes(self) -> int:
        return self.nb * self.nb * self.host.element_size()

    # -- the copies ----------------------------------------------------------

    def _copy_events(self):
        """(start event or None, end event) of one copy on the copy
        stream: timed where metrics are on."""
        if metrics.enabled():
            start = torch.cuda.Event(enable_timing=True)
            start.record(self._copy)
            return start, torch.cuda.Event(enable_timing=True)
        return None, torch.cuda.Event()

    def _fetch(self, i: int, j: int):
        """host → device copy of one tile, not waited for: on a card the
        copy is queued on the copy stream and the tile's event recorded
        (:meth:`get` waits on it)."""
        self.bytes_moved += self.tile_bytes
        metrics.inc("ooc.host_bytes", float(self.tile_bytes))
        if self._copy is None:
            return self.host[i, j].clone()
        with torch.cuda.stream(self._copy):
            start, end = self._copy_events()
            dev = torch.empty((self.nb, self.nb), dtype=self.dtype,
                              device=self.device)
            dev.copy_(self.host[i, j], non_blocking=True)
            end.record(self._copy)
        if start is not None:
            self._timed.append((start, end))
        self._ready[(i, j)] = end
        return dev

    def _write_back(self, key, dev) -> None:
        """device → host copy of one dirty tile (exact)."""
        with metrics.step_timer(self.op, "host"):
            if self._copy is None:
                self.host[key].copy_(dev)
            else:
                made = self._made.pop(key, None)
                if made is None:
                    self._copy.wait_stream(torch.cuda.current_stream(
                        self.device))
                else:
                    self._copy.wait_event(made)
                with torch.cuda.stream(self._copy):
                    start, end = self._copy_events()
                    self.host[key].copy_(dev, non_blocking=True)
                    if start is not None:
                        end.record(self._copy)
                        self._timed.append((start, end))
                dev.record_stream(self._copy)
        self.bytes_moved += self.tile_bytes
        metrics.inc("ooc.host_bytes", float(self.tile_bytes))
        metrics.inc("ooc.write_backs")

    def _drop(self, key) -> None:
        self._ready.pop(key, None)
        self._made.pop(key, None)

    # -- the residency protocol --------------------------------------------

    def _evict_to_capacity(self, keep=()) -> None:
        while len(self._resident) > self.capacity:
            victim = next((k for k in self._resident if k not in keep),
                          None)
            if victim is None:
                return            # everything pinned by the caller
            dev = self._resident.pop(victim)
            self._prefetched.discard(victim)
            if victim in self._dirty:
                self._dirty.discard(victim)
                self._write_back(victim, dev)
            self._drop(victim)
            metrics.inc("ooc.evictions")

    def _arrived(self, key, dev):
        """``dev`` made usable on the current stream: wait on its fetch's
        event once, and record it there for the caching allocator."""
        ev = self._ready.pop(key, None)
        if ev is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ev)
            dev.record_stream(cur)
        return dev

    def get(self, i: int, j: int):
        """The device copy of tile (i, j): a window hit costs nothing, a
        miss one host→device copy, and may evict the LRU resident tile
        (writing it back first when dirty)."""
        key = (i, j)
        dev = self._resident.get(key)
        if dev is not None:
            self._resident.move_to_end(key)
            if key in self._prefetched:
                self._prefetched.discard(key)
                metrics.inc("ooc.prefetch.hits")
            return self._arrived(key, dev)
        metrics.inc("ooc.prefetch.misses")
        with metrics.step_timer(self.op, "host"):
            dev = self._fetch(i, j)
        self._resident[key] = dev
        self._evict_to_capacity(keep=(key,))
        return self._arrived(key, dev)

    def put(self, i: int, j: int, dev) -> None:
        """Install a computed tile as the resident copy and mark it dirty
        (host memory is stale until write-back).  A tile that does not
        own exactly its storage is copied first."""
        key = (i, j)
        dev = _owned(dev)
        self._drop(key)
        if self._copy is not None:
            made = torch.cuda.Event()
            made.record(torch.cuda.current_stream(self.device))
            self._made[key] = made
        self._resident[key] = dev
        self._resident.move_to_end(key)
        self._dirty.add(key)
        self._prefetched.discard(key)
        self._evict_to_capacity(keep=(key,))

    def prefetch(self, coords) -> int:
        """Queue the host→device copies of up to ``depth`` of ``coords``
        not yet resident, without waiting; returns the copies issued."""
        budget = min(self.depth, max(0, self.capacity - 1))
        issued = 0
        for key in coords:
            if issued >= budget:
                break
            if key in self._resident:
                continue
            self._resident[key] = self._fetch(*key)
            self._prefetched.add(key)
            self._evict_to_capacity(keep=(key,))
            issued += 1
        return issued

    # -- coherence ----------------------------------------------------------

    def flush(self) -> None:
        """Write back every dirty resident tile; once the copy stream is
        synchronized (here on a card) host memory is the exact image of
        the computation so far."""
        for key in list(self._dirty):
            self._write_back(key, self._resident[key])
        self._dirty.clear()
        if self._copy is not None:
            self._copy.synchronize()
            if self._timed:
                metrics.observe_time("ooc.link", sum(
                    s.elapsed_time(e) for s, e in self._timed) / 1e3)
                self._timed.clear()

    def _tiles(self):
        """(i, j, rows, cols) of every tile, its rows and columns of the
        (m, n) matrix as slices (the last ones trimmed)."""
        nbk = self.nb
        for i in range(self.gi):
            for j in range(self.gj):
                yield (i, j, slice(i * nbk, min((i + 1) * nbk, self.m)),
                       slice(j * nbk, min((j + 1) * nbk, self.n)))

    def array(self, device=None) -> torch.Tensor:
        """Flush and return the trimmed (m, n) matrix, a copy: on the CPU
        by default, else on ``device``, written there a tile at a time
        (one tile of staging, never a second copy of the matrix)."""
        self.flush()
        out = torch.empty((self.m, self.n), dtype=self.dtype,
                          device=device if device is not None else "cpu")
        for i, j, rows, cols in self._tiles():
            out[rows, cols].copy_(self.host[i, j, :rows.stop - rows.start,
                                            :cols.stop - cols.start])
        return out

    def host_gb_transferred(self) -> float:
        return self.bytes_moved / 1e9
