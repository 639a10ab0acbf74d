"""What the kernels can hold on the card — the counterpart of
``slate_tpu/ops/vmem.py`` (``fits``, ``:65``; ``batch_per_launch``,
``:101``).

**LU panels.**
A TPU kernel keeps a whole panel in one core's VMEM (tens of MB).  On an
H100 a block has at most 227 KB of dynamic shared memory, so the panel
kernels (``csrc/lu_panel.cuh``) keep the (w, m) panel in device memory
(L2) and hold in shared memory only what runs from it: the LEAF cluster
of C blocks the ib rows of the current inner block for every active lane
(``⌈m / C⌉`` lanes a block), every other block an update tile's U12 rows
and the pivot lanes' rows for the block row of L11⁻¹.  Both roles run in
one launch, so a block's share is the larger
(:func:`lu_panel_cluster_bytes`); the kernel has no static shared memory.
The launcher takes C = 16 and sizes the grid by the occupancy query.
:func:`lu_panel_fits`, the drivers' gate in
:mod:`slate_tpu_torch.linalg.lu`, admits the panels the kernels took
before their leaf clusters (:func:`lu_panel_bytes` on the first grid
fits a block) whose share at C = 16 fits a block too; the cluster's share
alone would admit larger panels, which no run has measured.

:func:`lu_panel_bytes` is the share of the panel that the fused step and
full kernels (``csrc/lu_full.cuh``) run over their lanes: each block of
their cooperative grid keeps all w rows of its lanes in shared memory.

**Batched kernels.**  The JAX package budgets ``bt`` whole problems of
3·n²·4 bytes each against ~100 MB of VMEM per grid step
(``slate_tpu/linalg/batched.py:114-128``).  Here each problem is held on
chip by one block or one thread-block cluster; there is no ``bt`` to
plan.  Each kernel has two routes, planned from n
(:func:`potrf_batched_plan`, :func:`getrf_batched_plan`; the kernels'
``slate_<name>_plan`` entries are checked equal to them when
``ops/kernels.py`` loads the library):

* ``potrf_batched`` (``csrc/potrf_batched.cu``) — ``smem``: the problem's
  lower triangle in one block's shared memory as (n/32)(n/32 + 1)/2 tiles
  of 32 × 33 floats plus one for the diagonal block's inverse
  (:func:`potrf_batched_bytes`; n ≤ 288 on the H100); ``l2``: one block
  works from the output buffer in device memory with a fixed 42 KB of
  staging tiles, so no n is too large for it;
* ``getrf_batched`` (``csrc/getrf_batched.cu``) — ``smem``: the problem
  split by 32-row blocks over the shared memory of a cluster of C ≤ 16
  blocks, C the smallest whose shares fit
  (:func:`getrf_batched_cluster_bytes`; C = 1 to n = 224, 2 at 256, the
  route to n = 800); ``l2``: one block per problem, the problem in device
  memory, its current 32-row block and U12 rows in shared memory
  (:func:`getrf_batched_bytes`), which must fit one block: n ≤ 864.

:func:`batched_fits` is the shape gate (n ≥ 32 on the 32 grid, and for
``getrf_batched`` n ≤ 864); the kernels' launchers refuse the same shapes.

**Fused and full factorization steps.**  The JAX package gates its
fused step kernels on VMEM: the (n, nb) Cholesky block column, or the
(nb, m) LU panel with its one-hot matrix, resident next to a
double-buffered (tc, ·) trailing chunk, and twice that for the full
kernels' lookahead buffer (``slate_tpu/ops/blocks.py:423-510``,
``slate_tpu/linalg/lu.py:586-650``).  The CUDA kernels keep none of that
in shared memory: each is one cooperative grid whose blocks must all be
co-resident, and what one block holds is

* ``potrf_step_fused`` and ``potrf_full_fused`` (``csrc/potrf_grid.cuh``,
  one step at k0 and the loop of steps): 256-thread blocks, one an SM,
  with ``tri_grid.cuh``'s static staging blocks (:data:`TRI_GRID_SMEM`),
  whatever n and nb; the diagonal block's Schur complement, L11, L11⁻¹
  and the block column stay in device memory;
* ``getrf_step_fused`` and ``getrf_full_fused`` (``csrc/lu_full.cuh``, one
  step at k0 and the loop of steps): the panel kernel's share of the
  (nb, m) panel (:func:`lu_panel_bytes`; they hold their lanes' indices
  and the columns they were pivoted at where the panel kernel holds its
  mask and block-pivot marks, the same words, and pad their pivot
  columns' rows out of the formula's 64 spare words), which the trailing
  phase then reuses for its product tiles (:func:`lu_full_bytes`: the
  32-tiles' slabs, then the step's pivot lanes and a tile's lanes); the
  next panel stays in the carry.

The chunk height tc changes no shared memory here, and neither n nor nb
does for the Cholesky kernels, whose staging is fixed; the LU step and
full kernels take the same bytes at every shape.  So one gate serves
both depths: :func:`potrf_fused_fits` and :func:`lu_fused_fits`.  They
keep the shape rules of the JAX gates with tc = nb, the JAX package's
choice whenever its VMEM budget allows (f32, nb | n, nb a power of two
≥ 128 for potrf and a multiple of 128 for LU).  The kernels' wrappers
refuse the same shapes, and ``ops/kernels.py`` checks the kernels' own
shared-memory formulas against these when it loads them.

**Bulge chases.**  The TPU kernels copy a chase task's dense patch into
VMEM (1.06 MB fp32 at kd = 256).  ``hb2st_wavefront`` and
``tb2bd_wavefront`` (``csrc/chase.cuh``) run each task on a cluster of C
blocks instead and split its window between their shared memory
(:func:`chase_window_values`); where a block's share at C = 16 does not
fit, the window stays in the band (:func:`chase_route`).  C comes from
the card's cluster occupancy (:func:`chase_plan`, which the kernels'
plan restates); every band width the chase site admits gets a route.

On the card the SM count comes from the device; everywhere else (the CPU
tests) the H100's constants answer, so the gates decide the same way.
"""

from __future__ import annotations

import torch

from .. import config

#: H100 SXM: streaming multiprocessors
SMS = 132
#: shared memory one block may opt into (bytes), and the step and full LU
#: kernels' static share of it (their reduction scratch)
BLOCK_SMEM_MAX = 232448
STATIC_SMEM = 80
#: fewest lanes a block of the step and full LU kernels takes, and the
#: widest inner block (kept equal to lu_panel.cuh's MIN_LANES and MAX_IB)
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
    """Dynamic shared memory of the panel of ``lu_full.cuh``'s step and
    full kernels on a grid of ``grid`` blocks: a block's lanes of the
    (w, m) panel, the ib published pivot columns of the current block, its
    owned columns of L11⁻¹, the ib×ib block inverse and products, its lanes
    and block-pivot marks, and 64 spare words (``lu_panel.cuh``,
    ``smem_floats``)."""
    chunk = _ceildiv(m, grid)
    nown = _ceildiv(w, grid)
    return 4 * (w * chunk + ib * w + nown * w + ib * ib + ib * nown
                + 2 * chunk + 64)


def _first_grid(m: int, device=None) -> int:
    """The step and full LU kernels' first grid for m lanes (and the
    panel kernels' gate's): one block per SM, never fewer than 32 lanes a
    block."""
    return max(1, min(sm_count(device), _ceildiv(m, MIN_LANES)))


#: the panel kernels' words of per-block scalars, update tile rows, linv
#: columns a block and rows of X it stages at once, and the leaf
#: cluster's blocks (``lu_panel.cuh`` HEAD, RG, LC, KC, MAX_CLUSTER)
PANEL_HEAD = 160
PANEL_TILE_ROWS = 32
PANEL_LINV_COLS = 64
PANEL_LINV_ROWS = 64
PANEL_CLUSTER = 16


def lu_panel_leaf_floats(m: int, ib: int, cluster: int) -> int:
    """Shared memory of one block of the panel kernels' leaf cluster of
    ``cluster`` blocks, in floats: the per-block scalars, three buffers
    of the candidates the cluster's blocks push each column (a slot's
    rows, then |value| and lane in 16 more bytes), the inner block's L and
    the next rows' U12, the rows of its ⌈m / cluster⌉ lanes, their lanes
    and pivot columns; a slot's rows take the least power of two ≥
    max(4, ib) words (``lu_panel.cuh``, ``leaf_floats``, ``slot_words``)."""
    cs = _ceildiv(m, cluster)
    rows = 4
    while rows < ib:
        rows *= 2
    return (PANEL_HEAD + 3 * cluster * (rows + 4) + 2 * ib * rows + rows * cs
            + 2 * cs)


def lu_panel_update_floats(w: int, ib: int) -> int:
    """Shared memory of one updater block of the panel kernels, in
    floats: the per-block scalars, an update tile's U12 rows, the L of the
    current and previous inner blocks and the block inverse, the pivot
    lanes' rows before the block, the linv sums and a staged block of
    L11⁻¹ (``lu_panel.cuh``, ``update_floats``)."""
    return (PANEL_HEAD + ib * PANEL_TILE_ROWS + 3 * ib * ib + ib * w
            + ib * PANEL_LINV_COLS + PANEL_LINV_ROWS * PANEL_LINV_COLS)


def lu_panel_cluster_bytes(m: int, w: int, ib: int) -> int:
    """Dynamic shared memory of one block of the LU panel kernels
    (``getrf_panel_linv``, ``getrf_panel_fused``) for a (w, m) panel: the
    larger of the two roles' at a leaf cluster of :data:`PANEL_CLUSTER`
    blocks (``lu_panel.cuh``, ``panel_floats``; the launch asks for at
    least half an SM's, so that no two blocks share an SM)."""
    return 4 * max(lu_panel_leaf_floats(m, ib, PANEL_CLUSTER),
                   lu_panel_update_floats(w, ib))


def lu_panel_fits(m: int, w: int, ib: int, device=None) -> bool:
    """The shared-memory gate of the LU panel kernels: the panels they
    took before their leaf clusters (a (w, m) panel's share of
    :func:`lu_panel_bytes` on ``min(SMs, ceil(m / 32))`` blocks fits one
    block), where the kernels' own share (:func:`lu_panel_cluster_bytes`)
    fits one block too."""
    if m < 1 or w < 1 or not 1 <= ib <= MAX_IB or w % ib:
        return False
    return (fits(lu_panel_bytes(m, w, ib, _first_grid(m, device)))
            and lu_panel_cluster_bytes(m, w, ib) <= BLOCK_SMEM_MAX)


#: the batched kernels' inner block (potrf_batched.cu, getrf_batched.cu IB)
BATCHED_IB = 32
#: warps of a getrf_batched block (lu_panel.cuh NWARP)
GETRF_BATCHED_WARPS = 8
#: the batched kernels' two routes (potrf_batched.cu, getrf_batched.cu
#: Route): the problem on chip, or in device memory (L2)
BATCHED_ROUTES = ("smem", "l2")
#: floats of a potrf_batched smem-route tile: 32 rows padded to 33
POTRF_TILE = 32 * 33
#: potrf_batched's l2-route staging (tri_panel.cuh Smem: two 32 × 132
#: slabs, two 32 × 33 blocks), static shared memory
POTRF_L2_SMEM = 4 * (2 * 32 * 132 + 2 * 32 * 33)
#: getrf_batched's smem route: the widest cluster, a U12 chunk's row
#: stride, a warp candidate's words (getrf_batched.cu MAX_CLUSTER, UCS, SLOT)
GETRF_CLUSTER = 16
GETRF_U12_STRIDE = 68
GETRF_SLOT = 36


def potrf_batched_bytes(n: int) -> int:
    """Dynamic shared memory of a ``potrf_batched`` smem-route block: the
    lower triangle's (n/32)(n/32 + 1)/2 tiles and the inverse's tile
    (``potrf_batched.cu`` smem_route_bytes)."""
    nt = n // BATCHED_IB
    return 4 * (nt * (nt + 1) // 2 + 1) * POTRF_TILE


def potrf_batched_plan(n: int) -> tuple:
    """``(route, bytes)`` of ``potrf_batched`` at n (``potrf_batched.cu``
    slate_potrf_batched_plan): ``smem`` where :func:`potrf_batched_bytes`
    fits one block, with those bytes; else ``l2`` with its static
    staging."""
    b = potrf_batched_bytes(n)
    return ("smem", b) if b <= BLOCK_SMEM_MAX else ("l2", POTRF_L2_SMEM)


def getrf_batched_cluster_bytes(n: int, row_blocks: int) -> int:
    """Dynamic shared memory of a ``getrf_batched`` smem-route block that
    owns ``row_blocks`` 32-row blocks of an (n, n) problem: its rows, a
    64-row chunk's U12 (row stride 68), the row block's L11 (32 × 33), each
    lane's pivot column and each column's pivot lane, two sets of the
    warps' candidates, the row block's 32 pivots (``getrf_batched.cu``
    cluster_floats)."""
    ib = BATCHED_IB
    return 4 * (row_blocks * ib * n + ib * GETRF_U12_STRIDE + ib * (ib + 1) + 2 * n
                + 2 * GETRF_BATCHED_WARPS * GETRF_SLOT + ib)


def getrf_batched_plan(n: int) -> tuple:
    """``(route, cluster, bytes)`` of ``getrf_batched`` at n
    (``getrf_batched.cu`` slate_getrf_batched_plan): with R the most row
    blocks a block's share holds, C = ⌈(n/32) / R⌉; where C ≤ 16 the
    ``smem`` route on clusters of C blocks of ⌈(n/32) / C⌉ row blocks each,
    else ``l2`` (one block, :func:`getrf_batched_bytes`)."""
    nt = n // BATCHED_IB
    r = 0
    while r < nt and getrf_batched_cluster_bytes(n, r + 1) <= BLOCK_SMEM_MAX:
        r += 1
    c = _ceildiv(nt, r) if r else GETRF_CLUSTER + 1
    if c <= GETRF_CLUSTER:
        return "smem", c, getrf_batched_cluster_bytes(n, _ceildiv(nt, c))
    return "l2", 1, getrf_batched_bytes(n)


def getrf_batched_bytes(n: int) -> int:
    """Dynamic shared memory of one ``getrf_batched`` l2-route block: the
    current 32 rows of its (n, n) problem, the block's U12 rows, the
    active mask and block-pivot marks, the block's 32 pivots and the argmax
    scratch (``getrf_batched.cu``, ``smem_floats``).  The kernel has no
    static shared memory."""
    ib = BATCHED_IB
    return 4 * (2 * ib * n + 2 * n + ib + 2 * GETRF_BATCHED_WARPS + 4)


def batched_fits(kernel: str, n: int) -> bool:
    """The shape gate of the batched kernels (see the module docstring):
    ``kernel`` is ``"potrf_batched"`` or ``"getrf_batched"``."""
    if n < BATCHED_IB or n % BATCHED_IB:
        return False
    if kernel == "potrf_batched":
        return True
    if kernel == "getrf_batched":
        return getrf_batched_bytes(n) <= BLOCK_SMEM_MAX
    raise KeyError(f"no batched kernel {kernel!r}")


# ---------------------------------------------------------------------------
# Fused and full factorization steps
# ---------------------------------------------------------------------------

#: tri_grid.cuh's SMEM_FLOATS, the one shared allocation of a block of its
#: grids (potrf_step_fused, potrf_full_fused): eight 32 × 36 blocks
TRI_GRID_SMEM = 4 * 8 * 32 * 36
#: the work-unit edge of the fused kernels' products (potrf_grid.cuh T,
#: lu_full.cuh TT)
STEP_TILE = 128
#: floats of dynamic shared memory lu_full.cuh's trailing phase needs
#: besides the step's nb pivot lanes: tri_grid.cuh's staging blocks (its
#: 32-tiles' two 64 × 36 slabs of each operand; TILE_FLOATS), then a
#: tile's 128 lanes
LU_FULL_TRAIL_FLOATS = 8 * 32 * 36 + 128


def potrf_fused_fits(n: int, nb: int, dtype) -> bool:
    """The gate of ``potrf_step_fused`` and ``potrf_full_fused`` (the
    ``fused`` and ``full`` depths of the Cholesky driver): f32, nb a power
    of two ≥ 128 dividing n, and n > nb.  Their shared memory is fixed
    (:data:`TRI_GRID_SMEM`), so the shape rule is the whole gate.
    Whether an eligible shape takes a kernel is the ``potrf_step`` site's
    decision."""
    return (dtype == torch.float32 and nb >= STEP_TILE and nb & (nb - 1) == 0
            and n > nb and n % nb == 0)


def lu_full_bytes(m: int, nb: int, ib: int, grid: int) -> int:
    """Dynamic shared memory of one block of ``getrf_step_fused`` or
    ``getrf_full_fused`` on a grid of ``grid`` blocks: the panel phase's
    share (:func:`lu_panel_bytes`) or the trailing phase's, whichever is
    larger (``lu_panel.cuh`` ``dyn_floats`` with ``lu_full.cuh``'s
    ``trail_floats``)."""
    return max(lu_panel_bytes(m, nb, ib, grid), 4 * (LU_FULL_TRAIL_FLOATS + nb))


def lu_fused_fits(m: int, n: int, nb: int, dtype, device=None) -> bool:
    """The gate of ``getrf_step_fused`` and ``getrf_full_fused`` (the
    ``fused``, ``fused_trsm`` and ``full`` depths of the scattered LU
    driver) for an (m, n) matrix whose transposed carry is (n, m): f32,
    nb a multiple of 128 dividing n, m ≥ nb, and the kernels' share of
    one block (:func:`lu_full_bytes`) at the first grid the launcher
    tries (one block per SM, ≥ 32 lanes a block) fitting the opt-in
    limit.  The scattered driver's own gate (``linalg.lu._use_scattered``)
    is the caller's."""
    if dtype != torch.float32 or m < nb or nb % STEP_TILE or n % nb:
        return False
    return fits(lu_full_bytes(m, nb, 16, _first_grid(m, device)))


# ---------------------------------------------------------------------------
# Bulge chases
# ---------------------------------------------------------------------------

#: the chase kernels' threads and warps a block and largest cluster
#: (``csrc/chase.cuh`` NT, NW, MAX_CLUSTER)
CHASE_THREADS = 512
CHASE_WARPS = CHASE_THREADS // 32
CHASE_CLUSTER = 16
#: the chase kernels' two routes (``chase.cuh`` Route): the task's window
#: in the cluster's shared memory, or left in the band (L2)
CHASE_ROUTES = ("smem", "l2")


def chase_share(kd: int, cluster: int) -> int:
    """Columns (or rows) of a kd-wide block that one block of a cluster of
    ``cluster`` owns."""
    return _ceildiv(kd, cluster)


def chase_window_values(kind: str, kd: int, cluster: int) -> int:
    """Values of a chase task's window one block holds on the shared-memory
    route (``chase.cuh`` window_values): ``hb2st`` its columns of the
    (kd, kd) bulge block and its pairs (c, L−1−c) of the symmetric block's
    stored columns (kd + 1 slots a pair); ``tb2bd`` its columns of the
    off-diagonal block and its rows of the diagonal block (a row stride of
    share + 1)."""
    s = chase_share(kd, cluster)
    if kind == "hb2st":
        return s * kd + _ceildiv(_ceildiv(kd, 2), cluster) * (kd + 1)
    if kind == "tb2bd":
        return s * kd + kd * (s + 1)
    raise KeyError(f"no chase {kind!r}")


def chase_block_bytes(kind: str, kd: int, dtype, cluster: int, route: str) -> int:
    """Dynamic shared memory of one block of a chase kernel (``chase.cuh``
    smem_bytes; ``ops/kernels.py`` checks the two agree when it loads the
    kernel): the vectors u, v, y and the exchange buffer (kd each), the
    block's local dots (its share), the row partials and the block
    reduction, and on the ``smem`` route the window's share."""
    size = torch.empty((), dtype=dtype).element_size()
    vec = 4 * kd + chase_share(kd, cluster) + CHASE_THREADS + CHASE_WARPS
    win = chase_window_values(kind, kd, cluster) if route == "smem" else 0
    return size * (vec + win)


def chase_route(kind: str, kd: int, dtype) -> str:
    """The route of a chase shape: ``smem`` when a block's share of the
    window at the largest cluster fits the opt-in limit, else ``l2``."""
    return ("smem" if chase_block_bytes(kind, kd, dtype, CHASE_CLUSTER, "smem")
            <= BLOCK_SMEM_MAX else "l2")


def chase_plan(kind: str, kd: int, dtype, nl: int, clusters) -> tuple:
    """``(G, C, route)`` of a chase with ``nl`` live tasks a stagger
    (``chase.cuh`` plan): the shape's route; then of the cluster sizes
    C = 16, 8, 4, 2, 1 whose block share fits, the one that runs each
    stagger in the fewest rounds, ⌈nl / clusters[C]⌉, the larger on a tie;
    G = min(nl, clusters[C]) clusters.  ``clusters`` maps C to the clusters
    the card holds at once (the occupancy query's answer on the card)."""
    route = chase_route(kind, kd, dtype)
    best = None
    c = CHASE_CLUSTER
    while c >= 1:
        n = clusters.get(c, 0)
        if chase_block_bytes(kind, kd, dtype, c, route) <= BLOCK_SMEM_MAX and n >= 1:
            rounds = _ceildiv(max(nl, 1), n)
            if best is None or rounds < best[0]:
                best = (rounds, min(max(nl, 1), n), c)
        c //= 2
    if best is None:
        raise ValueError(f"{kind} at kd = {kd} {dtype}: no cluster fits a block")
    return best[1], best[2], route


# ---------------------------------------------------------------------------
# ABFT checksum blocks
# ---------------------------------------------------------------------------

#: rows of the JAX package's checksum block-row, by itemsize: one checksum
#: lane padded to the TPU's sublane tile (``slate_tpu/ops/vmem.py:85``)
_SUBLANE_ROWS = {4: 8, 8: 4}
#: the ``matmul`` site's alignment: the kernel takes a product only when
#: every dimension is a multiple of it
#: (:func:`slate_tpu_torch.perf.autotune.choose_matmul`)
MATMUL_ALIGN = 128


def checksum_block_rows(dtype, device=None) -> int:
    """Height of the ABFT checksum block-row and width of its block-column
    (:mod:`slate_tpu_torch.resilience.abft`): ONE checksum lane, the rest
    zero.  On the card the block is :data:`MATMUL_ALIGN` wide, so an
    augmented trailing product keeps every dimension a multiple of 128
    and rides the ``matmul`` kernel, as the JAX package's checksum rides
    its trailing product (about 1.6 % more trailing work at n = 8192,
    nb = 512).  Elsewhere it is the JAX package's sublane-padded height
    (8 rows fp32, 4 fp64), so the CPU's augmented operands are the JAX
    package's."""
    import numpy as np

    if device is not None and torch.device(device).type == "cuda":
        return MATMUL_ALIGN
    return _SUBLANE_ROWS.get(np.dtype(str(dtype).replace("torch.", "")).itemsize, 8)
