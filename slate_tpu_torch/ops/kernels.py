"""The hand-written CUDA kernels — the counterpart of
``slate_tpu/ops/pallas_kernels.py``: one CUDA kernel for each of its
21 Pallas entry points (``tzset`` and ``tzscale`` share one kernel).

Each kernel has three things here:

* a wrapper (:func:`matmul`, :func:`chol_inv_panel`, :func:`trtri_panel`,
  :func:`lu_inv_panel`, :func:`getrf_panel_linv`, :func:`getrf_panel_fused`,
  :func:`potrf_batched`, :func:`getrf_batched`, :func:`potrf_step_fused`,
  :func:`potrf_full_fused`, :func:`getrf_step_fused`,
  :func:`getrf_full_fused`, :func:`hb2st_wavefront`,
  :func:`tb2bd_wavefront`, :func:`chol_l21_panel`,
  :func:`lu_u12_panel`, :func:`tile_norms`, :func:`tzset`,
  :func:`tzscale`, :func:`geadd`, :func:`gescale_row_col`, and the two
  kernels that replace XLA dots rather than Pallas kernels,
  :func:`split_matmul` and :func:`ozaki_matmul`) that checks device,
  dtype, shape and strides, allocates its outputs and scratch with
  ``torch.empty``, launches the kernel on the current CUDA stream and
  raises if the launch fails.  Given CPU tensors it runs the plain
  version instead — only because the tensors are on the CPU; on a CUDA
  tensor it launches the kernel or raises;
* a plain PyTorch version (``*_plain``) of the same blocked algorithm,
  which the CPU tests use and ``chip_smoke.py`` holds the kernel against;
* a launch count in :data:`launches`, raised by one where the wrapper
  launches the kernel and nowhere else.

Loading a library and counting a launch are safe from several threads
(the serving queue launches from its dispatcher thread); they take
separate locks, so a count never waits on a build.

The sources are ``slate_tpu_torch/csrc/*.cu``, built by
:mod:`slate_tpu_torch.ops._build`.
"""

from __future__ import annotations

import ctypes
import threading

import torch

#: kernel name -> launches since the last :func:`reset_launches`
launches = {"matmul": 0, "chol_inv_panel": 0, "trtri_panel": 0,
            "lu_inv_panel": 0, "getrf_panel_linv": 0, "getrf_panel_fused": 0,
            "potrf_batched": 0, "getrf_batched": 0,
            "potrf_step_fused": 0, "potrf_full_fused": 0,
            "getrf_step_fused": 0, "getrf_full_fused": 0,
            "hb2st_wavefront": 0, "tb2bd_wavefront": 0,
            "chol_l21_panel": 0, "lu_u12_panel": 0,
            "tile_norms": 0, "tzset": 0, "tzscale": 0, "geadd": 0,
            "gescale_row_col": 0, "split_matmul": 0, "ozaki_matmul": 0}

IB = 32

_P, _I64, _I, _D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_double
_LU_ARGS = [_P] * 7 + [_I] * 5
_SIGNATURES = {
    "matmul": ("slate_matmul_f32",
               [_P, _I64, _I64, _P, _I64, _I64, _P, _I, _I, _I, _P, _I, _I,
                _P]),
    "chol_inv_panel": ("slate_chol_inv_panel_f32",
                       [_P, _I64, _P, _P, _P, _I, _I, _P]),
    "trtri_panel": ("slate_trtri_panel_f32", [_P, _I64, _P, _P, _I, _I, _I, _P]),
    "lu_inv_panel": ("slate_lu_inv_panel_f32",
                     [_P, _I64, _P, _P, _P, _P, _I, _I, _P]),
    "getrf_panel_linv": ("slate_getrf_panel_linv_f32",
                         [_P, _I64, _P] + _LU_ARGS + [_P]),
    "getrf_panel_fused": ("slate_getrf_panel_fused_f32",
                          [_P, _I64, _I64] + _LU_ARGS + [_P]),
    "potrf_batched": ("slate_potrf_batched_f32", [_P, _P, _P, _I, _I, _P]),
    "getrf_batched": ("slate_getrf_batched_f32", [_P, _P, _P, _I, _I, _P]),
    "potrf_step_fused": ("slate_potrf_step_fused_f32",
                         [_P, _I64] + [_P] * 4 + [_I] * 5 + [_P]),
    "potrf_full_fused": ("slate_potrf_full_fused_f32",
                         [_P, _I64] + [_P] * 4 + [_I] * 4 + [_P]),
    "getrf_step_fused": ("slate_getrf_step_fused_f32",
                         [_P, _I64, _I64, _I] + [_P] * 15 + [_I] * 5 + [_P]),
    "getrf_full_fused": ("slate_getrf_full_fused_f32",
                         [_P, _I64, _I] + [_P] * 14 + [_I] * 4 + [_P]),
    # one symbol per dtype: "%s" is f32 or f64
    "hb2st_wavefront": ("slate_hb2st_wavefront_%s",
                        [_P, _I64] + [_I] * 4 + [_P] + [_I] * 2 + [_P]),
    "tb2bd_wavefront": ("slate_tb2bd_wavefront_%s",
                        [_P, _I64] + [_I] * 4 + [_P] * 2 + [_I] * 2 + [_P]),
    "chol_l21_panel": ("slate_chol_l21_panel_f32",
                       [_P, _I64, _P, _I64] + [_P] * 4 + [_I] * 3 + [_P]),
    "lu_u12_panel": ("slate_lu_u12_panel_f32",
                     [_P, _I64, _P, _I64] + [_P] * 6 + [_I] * 3 + [_P]),
    "tile_norms": ("slate_tile_norms_%s", [_P, _P, _I, _I64, _I, _P]),
    "tz": ("slate_tz_%s", [_P, _P] + [_I] * 4 + [_D, _D, _P]),
    "geadd": ("slate_geadd_%s", [_D, _P, _D, _P, _P, _I, _I, _P]),
    "gescale_row_col": ("slate_gescale_row_col_%s", [_P] * 4 + [_I, _I, _P]),
    "split_matmul": ("slate_split_matmul",
                     [_P] * 3 + [_I64] * 2 + [_P] * 3 + [_I64] * 2
                     + [_P, _I, _I, _I, _P, _I, _I, _I, _P]),
    "ozaki_matmul": ("slate_ozaki_matmul", [_P] * 5 + [_I] * 4 + [_P]),
}
_fns: dict = {}
_fns_lock = threading.Lock()     # the entry-point cache; held across a build
_lock = threading.Lock()         # the launch counts


def reset_launches() -> None:
    with _lock:
        for k in launches:
            launches[k] = 0


def _fn(name: str, dt=None):
    """The C entry of kernel ``name`` (of dtype suffix ``dt`` for a
    kernel with one entry per dtype)."""
    with _fns_lock:
        fn = _fns.get((name, dt))
        if fn is None:
            from . import _build

            lib = _build.library(name)
            check = _SMEM_CHECKS.get(name)
            if check is not None:
                check(lib, name)
            sym, argtypes = _SIGNATURES[name]
            fn = getattr(lib, sym % dt if dt else sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[(name, dt)] = fn
        return fn


def _c_batched_plan(lib, name: str, n: int) -> tuple:
    """The batched kernel's own plan at n (``slate_<name>_plan``): ``(route,
    bytes)`` for ``potrf_batched``, ``(route, cluster, bytes)`` for
    ``getrf_batched``, the route by name."""
    from . import smem

    outs = 2 if name == "potrf_batched" else 3
    fn = getattr(lib, "slate_%s_plan" % name)
    fn.argtypes = [_I] + [ctypes.POINTER(ctypes.c_int)] * outs
    fn.restype = ctypes.c_int
    got = [ctypes.c_int(0) for _ in range(outs)]
    rc = fn(n, *map(ctypes.byref, got))
    if rc != 0:
        raise RuntimeError("%s: no plan at n = %d: CUDA error %d" % (name, n, rc))
    vals = [g.value for g in got]
    return (smem.BATCHED_ROUTES[vals[0]],) + tuple(vals[1:])


def _check_batched_plan(lib, name: str) -> None:
    """Raise unless the batched kernel's plan (its C entry
    ``slate_<name>_plan``: route, cluster, shared bytes) is
    :func:`smem.potrf_batched_plan` / :func:`smem.getrf_batched_plan` at
    every n on the 32 grid to 1024, so the gate, the wrapper and the
    kernel cannot drift apart."""
    from . import smem

    py_plan = getattr(smem, name + "_plan")
    for n in range(smem.BATCHED_IB, 1025, smem.BATCHED_IB):
        got, want = _c_batched_plan(lib, name, n), py_plan(n)
        if got != want:
            raise RuntimeError("%s: the kernel plans %s at n = %d, ops/smem.py "
                               "plans %s" % (name, got, n, want))


def _check_static_smem(lib, name: str, want: int) -> None:
    c_bytes = getattr(lib, "slate_%s_smem_bytes" % name)
    c_bytes.argtypes, c_bytes.restype = [], _I64
    if c_bytes() != want:
        raise RuntimeError("%s: the kernel takes %d B of shared memory, "
                           "ops/smem.py counts %d B" % (name, c_bytes(), want))


def _check_potrf_smem(lib, name: str) -> None:
    """The same check for the cooperative Cholesky kernels, ``tri_grid.cuh``
    grids: one block's static shared memory is :data:`smem.TRI_GRID_SMEM`."""
    from . import smem

    _check_static_smem(lib, name, smem.TRI_GRID_SMEM)


def _check_lu_step_smem(lib, name: str) -> None:
    """The same check for the fused LU kernels: one block's dynamic
    shared memory is :func:`smem.lu_full_bytes` (both kernels) over panels
    and grids on both sides of the point where the panel's share passes
    the product tiles'."""
    from . import smem

    c_bytes = getattr(lib, "slate_%s_smem_bytes" % name)
    c_bytes.argtypes, c_bytes.restype = [_I] * 4, _I64
    for m in (128, 256, 2048, 8192, 12144):
        for nb in (128, 512):
            for grid in (1, 8, 64, 132):
                want = smem.lu_full_bytes(m, nb, 16, grid)
                if c_bytes(m, nb, 16, grid) != want:
                    raise RuntimeError(
                        "%s: the kernel takes %d B of shared memory at (m, "
                        "nb, grid) = (%d, %d, %d), ops/smem.py counts %d B"
                        % (name, c_bytes(m, nb, 16, grid), m, nb, grid, want))


def _check_lu_panel_smem(lib, name: str) -> None:
    """The same check for the LU panel kernels: one block's dynamic shared
    memory is :func:`smem.lu_panel_cluster_bytes` over panels and inner
    blocks on both sides of the point where the leaf's share passes the
    updaters'."""
    from . import smem

    c_bytes = getattr(lib, "slate_%s_smem_bytes" % name)
    c_bytes.argtypes, c_bytes.restype = [_I] * 3, _I64
    for m in (256, 2048, 8192, 12144, 24576, 49152):
        for w, ib in ((256, 32), (512, 16), (64, 8)):
            want = smem.lu_panel_cluster_bytes(m, w, ib)
            if c_bytes(m, w, ib) != want:
                raise RuntimeError(
                    "%s: the kernel takes %d B of shared memory at (m, w, ib) "
                    "= (%d, %d, %d), ops/smem.py counts %d B"
                    % (name, c_bytes(m, w, ib), m, w, ib, want))


def _check_chase_smem(lib, name: str) -> None:
    """The same check for the chase kernels: one block's dynamic shared
    memory is :func:`smem.chase_block_bytes` on both routes, at every
    cluster size, in fp32 and fp64, at band widths on both sides of the
    point where the shared-memory route stops fitting."""
    from . import smem

    kind = name.split("_")[0]
    c_bytes = getattr(lib, "slate_%s_smem_bytes" % name)
    c_bytes.argtypes, c_bytes.restype = [_I] * 4, _I64
    for kd in (4, 64, 255, 256, 512, 768, 1024):
        for dtype in (torch.float32, torch.float64):
            size = torch.empty((), dtype=dtype).element_size()
            for cluster in (1, 2, 4, 8, 16):
                for route, r in enumerate(smem.CHASE_ROUTES):
                    want = smem.chase_block_bytes(kind, kd, dtype, cluster, r)
                    got = c_bytes(kd, size, cluster, route)
                    if got != want:
                        raise RuntimeError(
                            "%s: the kernel takes %d B of shared memory at (kd, "
                            "%s, cluster %d, route %s), ops/smem.py counts %d B"
                            % (name, got, kd, dtype, cluster, r, want))


_SMEM_CHECKS = {"potrf_batched": _check_batched_plan,
                "getrf_batched": _check_batched_plan,
                "hb2st_wavefront": _check_chase_smem,
                "tb2bd_wavefront": _check_chase_smem,
                "getrf_panel_linv": _check_lu_panel_smem,
                "getrf_panel_fused": _check_lu_panel_smem,
                "potrf_step_fused": _check_potrf_smem,
                "potrf_full_fused": _check_potrf_smem,
                "getrf_step_fused": _check_lu_step_smem,
                "getrf_full_fused": _check_lu_step_smem}


def _launch(name: str, device: torch.device, *args, dt=None,
            count: bool = True, counter=None) -> None:
    """Launch library ``name``'s kernel; one launch is counted under
    ``counter`` (default ``name``: ``tz`` serves two counters)."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _fn(name, dt)(*args, stream)
    if rc != 0:
        raise RuntimeError("%s kernel launch failed: CUDA error %d"
                           % (counter or name, rc))
    if count:
        _count(counter or name)


def _count(name: str) -> None:
    with _lock:
        launches[name] += 1


def _on_cpu(*ts) -> bool:
    """True when every tensor is on the CPU; raises on a mix of devices
    or a device that is neither the CPU nor CUDA."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError("operands on different devices: %s" % sorted(map(str, devs)))
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError("unsupported device %s" % dev)
    return dev.type == "cpu"


def _check_f32_2d(name: str, *ts) -> None:
    for t in ts:
        if t.dtype != torch.float32 or t.ndim != 2:
            raise ValueError("%s takes 2-D float32 tensors, got %s %s"
                             % (name, t.dtype, tuple(t.shape)))


def _check_panel(name: str, a) -> int:
    _check_f32_2d(name, a)
    nb = a.shape[-1]
    if a.shape[0] != nb or nb < IB or nb & (nb - 1):
        raise ValueError("%s needs a square power-of-two block of edge ≥ %d, "
                         "got %s" % (name, IB, tuple(a.shape)))
    return nb


def _check_rows(name: str, a) -> None:
    if a.stride(1) != 1 or a.stride(0) < a.shape[1]:
        raise ValueError("%s needs unit column stride and row stride ≥ "
                         "the width, got strides %s" % (name, a.stride()))


# ---------------------------------------------------------------------------
# matmul (replaces pallas_kernels.matmul, slate_tpu/ops/pallas_kernels.py:95)
# ---------------------------------------------------------------------------

def matmul_plain(a, b, bk: int = 512):
    """C = A·B accumulated over K slabs of ``bk``, as the Pallas kernel's
    K grid accumulates in VMEM; full fp32 (TF32 is off, see config)."""
    k = a.shape[1]
    acc = a[:, :min(bk, k)] @ b[:min(bk, k)]
    for k0 in range(bk, k, bk):
        acc += a[:, k0:k0 + bk] @ b[k0:k0 + bk]
    return acc


#: the matmul kernel's output tile and K slab (csrc/matmul.cu BM, BN, BK);
#: a part of K holds at least MATMUL_MIN_SLABS slabs, and K is cut into at
#: most MATMUL_MOST_PARTS parts
MATMUL_TILE, MATMUL_SLAB = 128, 32
MATMUL_MIN_SLABS, MATMUL_MOST_PARTS = 8, 32

#: matmul calls since import by the kernel's staging: "async" (cp.async
#: copies) or "registers" (the instantiation that stages any view through
#: registers); :func:`reset_launches` leaves them
matmul_stagings = {"async": 0, "registers": 0}


def matmul_part_slabs(k: int, s: int) -> int:
    """The slabs of :data:`MATMUL_SLAB` in each of the ``s`` parts the
    matmul kernel cuts K = ``k`` into: ⌈⌈k/slab⌉/s⌉, the last part ending
    at ``k``."""
    slabs = -(-k // MATMUL_SLAB)
    return -(-slabs // s)


def matmul_splits(m: int, n: int, k: int, sms: int, bm: int = MATMUL_TILE,
                  bn: int = MATMUL_TILE) -> int:
    """The parts the matmul kernel (or ``split_matmul``, whose output
    tiles are ``bm`` × ``bn``) cuts K into for an (m, k)·(k, n) product
    on a card of ``sms`` SMs: 1 where the output's tiles fill the SMs.
    Else each s whose parts (:func:`matmul_part_slabs`) are none empty
    costs ⌈tiles·s / sms⌉ waves × its slabs a part, and the smallest s
    within 5 % of the least cost wins (each part's partial tile costs a
    write and a read of workspace)."""
    tiles = -(-m // bm) * -(-n // bn)
    slabs = -(-k // MATMUL_SLAB)
    if tiles >= sms:
        return 1
    cost = {}
    for s in range(1, min(MATMUL_MOST_PARTS, slabs // MATMUL_MIN_SLABS) + 1):
        per = matmul_part_slabs(k, s)
        if (s - 1) * per < slabs:
            cost[s] = -(-tiles * s // sms) * per
    if not cost:
        return 1
    least = min(cost.values())
    return min(s for s, c in cost.items() if c <= 1.05 * least)


def matmul_plan(a, b, sms: int):
    """``(splits, staging)`` of the matmul kernel for CUDA tensors ``a``·
    ``b``: the parts of K (:func:`matmul_splits`) and the staging the
    kernel takes for their pointers and strides (see
    :data:`matmul_stagings`)."""
    staging = _fns.get("matmul_staging")
    if staging is None:
        from . import _build

        staging = _build.library("matmul").slate_matmul_f32_staging
        staging.argtypes, staging.restype = [_P, _I64, _I64, _P, _I64, _I64], _I
        _fns["matmul_staging"] = staging
    regs = staging(a.data_ptr(), a.stride(0), a.stride(1), b.data_ptr(),
                   b.stride(0), b.stride(1))
    return (matmul_splits(a.shape[0], b.shape[1], a.shape[1], sms),
            "registers" if regs else "async")


def _matmul_launch(a, b, splits: int):
    """One counted launch of the matmul kernel with ``splits`` parts of K
    (its fp32 workspace allocated here, on the current stream's
    allocator)."""
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    w = (torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
         if splits > 1 else None)
    _launch("matmul", a.device, a.data_ptr(), a.stride(0), a.stride(1),
            b.data_ptr(), b.stride(0), b.stride(1), c.data_ptr(), m, n, k,
            None if w is None else w.data_ptr(), splits,
            matmul_part_slabs(k, splits))
    return c


def matmul(a, b):
    """C = A·B, fp32 in and out, at fp32-class accuracy (3xTF32 on the
    tensor cores, ``csrc/matmul.cu``).  M and N must be multiples of 128,
    K of 16.  ``a`` and ``b`` may be strided views (a transposed view
    needs no copy); the output is a new contiguous tensor.  One launch
    counted per call, whether K is split or not."""
    _check_f32_2d("matmul", a, b)
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError("matmul: inner dims differ: %s · %s"
                         % (tuple(a.shape), tuple(b.shape)))
    if _on_cpu(a, b):
        return matmul_plain(a, b)
    if m % 128 or n % 128 or k % 16:
        raise ValueError("matmul kernel needs M, N % 128 == 0 and K % 16 == 0, "
                         "got (%d, %d)·(%d, %d)" % (m, k, k2, n))
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    splits, staging = matmul_plan(a, b, sms)
    c = _matmul_launch(a, b, splits)
    with _lock:
        matmul_stagings[staging] += 1
    return c


# ---------------------------------------------------------------------------
# Panel kernels (replace pallas_kernels.chol_inv_panel :395 and
# trtri_panel :571)
# ---------------------------------------------------------------------------

def _chol_unblocked(blk):
    """Right-looking unblocked Cholesky of the lower triangle of an
    (..., ib, ib) block (the reference's _chol_unblocked)."""
    a = torch.tril(blk)
    for j in range(a.shape[-1]):
        inv = 1.0 / torch.sqrt(a[..., j, j])
        a[..., j, j] = a[..., j, j] * inv
        a[..., j + 1:, j] *= inv[..., None]
        v = a[..., j + 1:, j]
        a[..., j + 1:, j + 1:] -= v[..., :, None] * v[..., None, :]
    return torch.tril(a)


def _trtri_unblocked(l):
    """Row-by-row forward substitution: inverse of a lower non-unit
    (..., ib, ib) block (the reference's _trtri_unblocked)."""
    ib = l.shape[-1]
    x = torch.zeros_like(l)
    eye = torch.eye(ib, dtype=l.dtype, device=l.device)
    for i in range(ib):
        x[..., i, :] = ((eye[i] - (l[..., i, None, :i] @ x[..., :i, :])[..., 0, :])
                        / l[..., i, i, None])
    return x


def _chol_blocked(l, inv=None, ib: int = IB) -> None:
    """In place on the lower-triangular (..., n, n) ``l``: the ib-blocked
    right-looking Cholesky of ``_chol_blocked_value`` — per block the
    unblocked Cholesky and its inverse B⁻¹, L21 = A21·B⁻ᵀ, the trailing
    update (the full trailing square; the caller keeps the lower
    triangle).  With ``inv``, every block inverse is stored on its
    diagonal."""
    n = l.shape[-1]
    for k0 in range(0, n, ib):
        blk = _chol_unblocked(l[..., k0:k0 + ib, k0:k0 + ib])
        l[..., k0:k0 + ib, k0:k0 + ib] = blk
        binv = _trtri_unblocked(blk)
        if inv is not None:
            inv[..., k0:k0 + ib, k0:k0 + ib] = binv
        if k0 + ib < n:
            l21 = l[..., k0 + ib:, k0:k0 + ib] @ binv.mT
            l[..., k0 + ib:, k0:k0 + ib] = l21
            l[..., k0 + ib:, k0 + ib:] -= l21 @ l21.mT


def _block_inv_doubling(l, inv, nb: int, ib: int) -> None:
    """In place: assemble the lower inverse in ``inv`` (its diagonal
    ib-blocks hold the block inverses, the rest zero) by recursive
    doubling, [[L11, 0], [L21, L22]]⁻¹ = [[X11, 0], [-X22·L21·X11, X22]]."""
    s = ib
    while s < nb:
        for o in range(0, nb - s, 2 * s):
            x11 = inv[o:o + s, o:o + s]
            x22 = inv[o + s:o + 2 * s, o + s:o + 2 * s]
            l21 = l[o + s:o + 2 * s, o:o + s]
            inv[o + s:o + 2 * s, o:o + s] = -(x22 @ (l21 @ x11))
        s *= 2


def chol_inv_panel_plain(a):
    """Plain version of :func:`chol_inv_panel`: the same ib = 32 blocked
    algorithm in PyTorch ops.  Reads only the lower triangle of ``a``."""
    nb = a.shape[-1]
    ib = min(IB, nb)
    l = torch.tril(a)
    inv = torch.zeros_like(l)
    _chol_blocked(l, inv, ib)
    l = torch.tril(l)
    _block_inv_doubling(l, inv, nb, ib)
    return l, inv


def chol_inv_panel(a):
    """``(L, L⁻¹)`` of an (nb, nb) SPD block, both lower triangular, nb a
    power of two ≥ 32, fp32.  Reads only the lower triangle of ``a``,
    which may be a view with any row stride ≥ nb."""
    nb = _check_panel("chol_inv_panel", a)
    if _on_cpu(a):
        return chol_inv_panel_plain(a)
    _check_rows("chol_inv_panel", a)
    l = torch.empty((nb, nb), dtype=torch.float32, device=a.device)
    linv = torch.empty_like(l)
    # the Schur complement, then the doubling's products (nb²/4)
    work = torch.empty(nb * nb, dtype=torch.float32, device=a.device)
    _launch("chol_inv_panel", a.device, a.data_ptr(), a.stride(0),
            l.data_ptr(), linv.data_ptr(), work.data_ptr(), nb,
            _plan("chol_inv_panel", a.device, nb))
    return l, linv


def trtri_panel_plain(l):
    """Plain version of :func:`trtri_panel`: per-ib block inverses plus
    recursive doubling.  Reads only the lower triangle of ``l``."""
    nb = l.shape[-1]
    ib = min(IB, nb)
    lt = torch.tril(l)
    inv = torch.zeros_like(lt)
    for k0 in range(0, nb, ib):
        inv[k0:k0 + ib, k0:k0 + ib] = _trtri_unblocked(
            lt[k0:k0 + ib, k0:k0 + ib])
    _block_inv_doubling(lt, inv, nb, ib)
    return inv


#: the widest nb whose trtri_panel launch is one thread-block cluster (a
#: hardware barrier between the doubling's products) rather than a
#: cooperative grid (csrc/trtri_panel.cu)
TRTRI_CLUSTER_NB = 256


def trtri_panel(l):
    """Inverse of a lower non-unit (nb, nb) triangle, nb a power of two
    ≥ 32, fp32.  Reads only the lower triangle of ``l``, which may be a
    view with any row stride ≥ nb."""
    nb = _check_panel("trtri_panel", l)
    if _on_cpu(l):
        return trtri_panel_plain(l)
    _check_rows("trtri_panel", l)
    linv = torch.empty((nb, nb), dtype=torch.float32, device=l.device)
    work = torch.empty((nb // 2) ** 2, dtype=torch.float32, device=l.device)
    cluster = int(nb <= TRTRI_CLUSTER_NB)
    _launch("trtri_panel", l.device, l.data_ptr(), l.stride(0),
            linv.data_ptr(), work.data_ptr(), nb,
            _plan("trtri_panel", l.device, nb, cluster), cluster)
    return linv


# ---------------------------------------------------------------------------
# No-pivot LU panel (replaces pallas_kernels.lu_inv_panel :537)
# ---------------------------------------------------------------------------

def _lu_unblocked(blk):
    """Unblocked right-looking no-pivot LU of an (ib, ib) block, packed:
    unit L strictly below the diagonal, U on and above (the reference's
    _lu_unblocked)."""
    a = blk.clone()
    for j in range(a.shape[-1] - 1):
        a[j + 1:, j] /= a[j, j]
        a[j + 1:, j + 1:] -= a[j + 1:, j, None] * a[j, None, j + 1:]
    return a


def _triu_tri_unblocked(u):
    """Inverse of an upper non-unit (ib, ib) block by row-wise back
    substitution from the last row (the reference's _triu_tri_unblocked)."""
    ib = u.shape[-1]
    x = torch.zeros_like(u)
    eye = torch.eye(ib, dtype=u.dtype, device=u.device)
    for i in range(ib - 1, -1, -1):
        x[i] = (eye[i] - u[i, i + 1:] @ x[i + 1:]) / u[i, i]
    return x


def _block_uinv_doubling(u, inv, nb: int, ib: int) -> None:
    """In place: the upper inverse in ``inv`` (its diagonal ib-blocks hold
    the block inverses, the rest zero) by recursive doubling,
    [[U11, U12], [0, U22]]⁻¹ = [[X11, -X11·U12·X22], [0, X22]]."""
    s = ib
    while s < nb:
        for o in range(0, nb - s, 2 * s):
            x11 = inv[o:o + s, o:o + s]
            x22 = inv[o + s:o + 2 * s, o + s:o + 2 * s]
            u12 = u[o:o + s, o + s:o + 2 * s]
            inv[o:o + s, o + s:o + 2 * s] = -(x11 @ (u12 @ x22))
        s *= 2


def lu_inv_panel_plain(a):
    """Plain version of :func:`lu_inv_panel`: the same ib = 32 blocked
    algorithm in PyTorch ops — per block the unblocked LU and the inverses
    of its two triangles, L21 = A21·U11⁻¹, U12 = L11⁻¹·A12 and the
    trailing update, then both inverses by recursive doubling."""
    nb = a.shape[-1]
    ib = min(IB, nb)
    lu = a.clone()
    linv = torch.zeros_like(lu)
    uinv = torch.zeros_like(lu)
    eye = torch.eye(ib, dtype=a.dtype, device=a.device)
    for k0 in range(0, nb, ib):
        k1 = k0 + ib
        blk = _lu_unblocked(lu[k0:k1, k0:k1])
        lu[k0:k1, k0:k1] = blk
        lb = _trtri_unblocked(torch.tril(blk, -1) + eye)
        ub = _triu_tri_unblocked(torch.triu(blk))
        linv[k0:k1, k0:k1] = lb
        uinv[k0:k1, k0:k1] = ub
        if k1 < nb:
            l21 = lu[k1:, k0:k1] @ ub
            u12 = lb @ lu[k0:k1, k1:]
            lu[k1:, k0:k1] = l21
            lu[k0:k1, k1:] = u12
            lu[k1:, k1:] -= l21 @ u12
    _block_inv_doubling(torch.tril(lu, -1), linv, nb, ib)
    _block_uinv_doubling(torch.triu(lu), uinv, nb, ib)
    return lu, linv, uinv


def lu_inv_panel(a):
    """No-pivot LU of an (nb, nb) fp32 block with the inverses of both
    factors: ``(LU, L⁻¹, U⁻¹)`` with LU packed (unit L strictly below the
    diagonal, U on and above), L⁻¹ lower and U⁻¹ upper.  nb a power of two
    ≥ 32; ``a`` may be a view with any row stride ≥ nb.  The caller
    vouches that no pivoting is needed (the CholQR² reconstruction's
    Q − diag(s) has |diagonal| ≥ 1)."""
    nb = _check_panel("lu_inv_panel", a)
    if _on_cpu(a):
        return lu_inv_panel_plain(a)
    _check_rows("lu_inv_panel", a)
    lu = torch.empty((nb, nb), dtype=torch.float32, device=a.device)
    linv, uinv = torch.empty_like(lu), torch.empty_like(lu)
    # the Schur complement, then both doublings' products (nb²/4 each)
    work = torch.empty(nb * nb, dtype=torch.float32, device=a.device)
    _launch("lu_inv_panel", a.device, a.data_ptr(), a.stride(0),
            lu.data_ptr(), linv.data_ptr(), uinv.data_ptr(), work.data_ptr(),
            nb, _plan("lu_inv_panel", a.device, nb))
    return lu, linv, uinv


# ---------------------------------------------------------------------------
# Partial-pivot LU panels (replace pallas_kernels.getrf_panel_linv :873 and
# getrf_panel_fused :1080)
# ---------------------------------------------------------------------------

def _lu_panel_plain(x, act, ib: int):
    """In place on the (w, m) lane-major panel ``x``: the blocked
    elimination of ``csrc/lu_panel.cuh`` in PyTorch ops.  Per column the
    masked argmax (lowest lane among equal maxima), the multipliers in the
    pivot row's lanes and the rank-1 update of the rows left in the ib
    block; per block the U12 forward substitution, the delayed rank-ib
    update of the rows past it and the block row of L11⁻¹.  Returns
    ``(piv, act_out, linv)``."""
    w, m = x.shape
    dev, dt = x.device, x.dtype
    act = act.reshape(-1).to(dt).clone()
    lanes = torch.arange(m, device=dev)
    piv = torch.empty(w, dtype=torch.int64, device=dev)
    linv = torch.zeros((w, w), dtype=dt, device=dev)
    eye = torch.eye(ib, dtype=dt, device=dev)
    for b0 in range(0, w, ib):
        b1 = b0 + ib
        pcols = torch.empty((ib, w), dtype=dt, device=dev)
        for jj in range(ib):
            j = b0 + jj
            mag = torch.where(act > 0, x[j].abs(), -1.0)
            p = torch.argmax(mag)
            found = mag[p] >= 0
            p = torch.where(found, p, m)
            pc = torch.where(found, x[:, p.clamp(max=m - 1)], 0.0)
            pcols[jj] = pc
            piv[j] = p
            pval = pc[j]
            safe = torch.where(pval == 0, 1.0, pval)
            live = (act > 0) & (lanes != p)
            mult = torch.where(live, x[j] / safe, 0.0)
            x[j] = torch.where(live, mult, x[j])
            if j + 1 < b1:
                x[j + 1:b1] -= pc[j + 1:b1, None] * mult[None, :]
            act = act * (lanes != p)
        lb = torch.tril(pcols[:, b0:b1], -1)
        if b1 < w:
            u = pcols[:, b1:].clone()
            for jj in range(1, ib):
                u[jj] -= lb[jj, :jj] @ u[:jj]
            x[b1:] -= u.T @ (x[b0:b1] * (act > 0))
            pb = piv[b0:b1]
            ok = pb < m
            pbc = pb.clamp(max=m - 1)
            x[b1:, pbc] = torch.where(ok[None, :], u.T, x[b1:, pbc])
        xbb = torch.zeros((ib, ib), dtype=dt, device=dev)
        for jj in range(ib):
            xbb[jj] = eye[jj] - lb[jj, :jj] @ xbb[:jj]
        linv[b0:b1, b0:b1] = xbb
        if b0:
            linv[b0:b1, :b0] = -(xbb @ (pcols[:, :b0] @ linv[:b0, :b0]))
    return piv, act.reshape(1, m), linv


def _check_lu_panel(name: str, x, act, w: int, m: int, ib: int) -> None:
    _check_f32_2d(name, x)
    if act.dtype != torch.float32 or act.numel() != m:
        raise ValueError("%s needs a float32 active mask of %d lanes, got "
                         "%s %s" % (name, m, act.dtype, tuple(act.shape)))
    if not 1 <= ib <= 32 or w % ib:
        raise ValueError("%s needs 1 <= ib <= 32 dividing the panel width, "
                         "got w = %d, ib = %d" % (name, w, ib))


_plans: dict = {}


def _plan(name: str, dev, *args, outs: int = 1):
    """The cooperative grid of kernel ``name`` (its C entry
    ``slate_<name>_plan(*args, &out…)`` with ``outs`` results, an
    occupancy query), cached per device and arguments: an int, or a
    tuple of ``outs`` ints."""
    key = (name, dev.index) + args
    grid = _plans.get(key)
    if grid is None:
        from . import _build

        plan = getattr(_build.library(name), "slate_%s_plan" % name)
        plan.argtypes = [_I] * len(args) + [ctypes.POINTER(ctypes.c_int)] * outs
        plan.restype = ctypes.c_int
        got = [ctypes.c_int(0) for _ in range(outs)]
        with torch.cuda.device(dev):
            rc = plan(*args, *map(ctypes.byref, got))
        if rc != 0:
            raise RuntimeError("%s: no cooperative grid for %s: CUDA error %d"
                               % (name, args, rc))
        grid = _plans[key] = (got[0].value if outs == 1
                              else tuple(g.value for g in got))
    return grid


def lu_panel_plan(name: str, dev, m: int, w: int, ib: int):
    """``(grid, cluster)`` of the LU panel kernel ``name`` for a (w, m)
    panel: every block of the clusters the card holds at once, and the
    leaf cluster's size (``lu_panel.cuh``'s ``plan``)."""
    return _plan(name, dev, m, w, ib, outs=2)


def _lu_launch(name: str, dev, act, m: int, w: int, ib: int, *head):
    """Plan the launch (:func:`lu_panel_plan`), allocate the outputs and
    the scratch (the list of active lanes, their pivot columns and count,
    three inner blocks' pivot rows, the grid barrier's and the leaf's
    counters), launch.
    ``head`` are the kernel's leading arguments (panel pointers and
    strides).  Returns ``(piv, act_out, linv)``."""
    grid, cluster = lu_panel_plan(name, dev, m, w, ib)
    act_out = torch.empty((1, m), dtype=torch.float32, device=dev)
    piv = torch.empty(w, dtype=torch.int64, device=dev)
    linv = torch.empty((w, w), dtype=torch.float32, device=dev)
    iwork = torch.empty(2 * m + 1, dtype=torch.int32, device=dev)
    lblk = torch.empty(3 * ib * ib, dtype=torch.float32, device=dev)
    bar = torch.zeros(2, dtype=torch.int32, device=dev)
    act = act.reshape(-1).contiguous()
    _launch(name, dev, *head, act.data_ptr(), act_out.data_ptr(),
            piv.data_ptr(), linv.data_ptr(), iwork.data_ptr(),
            lblk.data_ptr(), bar.data_ptr(), m, w, ib, grid, cluster)
    return piv, act_out, linv


def getrf_panel_linv_plain(slab, act, ib: int = 32):
    """Plain version of :func:`getrf_panel_linv` (out of place)."""
    out = slab.clone()
    piv, act_out, linv = _lu_panel_plain(out, act, min(ib, slab.shape[0]))
    return out, piv, act_out, linv


def getrf_panel_linv(slab, act, ib: int = 32):
    """TRUE partial-pivot LU of a transposed (w, m) fp32 panel, out of
    place: returns ``(slab', piv, act_out, linv)`` with ``piv`` the w
    pivot lanes (int64) in factorization order, ``act_out`` the (1, m)
    active mask after the panel and ``linv`` the (w, w) inverse of the
    unit-lower pivot block.  ``act`` is a float32 (1, m) or (m,) mask,
    > 0 for an active lane.  ``slab`` needs unit lane stride."""
    w, m = slab.shape
    ib = min(ib, w)
    _check_lu_panel("getrf_panel_linv", slab, act, w, m, ib)
    if _on_cpu(slab, act):
        return getrf_panel_linv_plain(slab, act, ib)
    _check_rows("getrf_panel_linv", slab)
    out = torch.empty((w, m), dtype=torch.float32, device=slab.device)
    piv, act_out, linv = _lu_launch(
        "getrf_panel_linv", slab.device, act, m, w, ib,
        slab.data_ptr(), slab.stride(0), out.data_ptr())
    return out, piv, act_out, linv


def _check_fused(carry, k0: int, nb: int, bb: int, ib: int,
                 name: str = "getrf_panel_fused") -> None:
    if nb % bb or bb % ib or k0 % bb or k0 < 0 or k0 + nb > carry.shape[0]:
        raise ValueError("%s needs bb | nb, ib | bb, bb | k0 and k0 + nb <= "
                         "rows, got k0 = %d, nb = %d, bb = %d, ib = %d, rows = "
                         "%d" % (name, k0, nb, bb, ib, carry.shape[0]))


def getrf_panel_fused_plain(carry, act, k0: int, nb: int = 512,
                            bb: int = 128, ib: int = 16):
    """Plain version of :func:`getrf_panel_fused` (in place on ``carry``)."""
    bb = min(bb, nb)
    ib = min(ib, bb)
    _check_fused(carry, k0, nb, bb, ib)
    piv, act_out, linv = _lu_panel_plain(carry[k0:k0 + nb], act, ib)
    return carry, piv, act_out, linv


def getrf_panel_fused(carry, act, k0: int, nb: int = 512, bb: int = 128,
                      ib: int = 16):
    """TRUE partial-pivot LU of rows [k0, k0 + nb) of the transposed
    (n, m) fp32 carry, IN PLACE (the counterpart of the TPU kernel's
    aliased carry; no other row is read or written).  Returns
    ``(carry, piv, act_out, linv)`` as :func:`getrf_panel_linv`.  ``bb``
    is the reference's column-block step: it must divide ``nb`` and be a
    multiple of ``ib``; the panel stays resident for its whole width
    here, so it does not change the arithmetic."""
    n_rows, m = carry.shape
    bb = min(bb, nb)
    ib = min(ib, bb)
    _check_lu_panel("getrf_panel_fused", carry, act, nb, m, ib)
    _check_fused(carry, k0, nb, bb, ib)
    if _on_cpu(carry, act):
        return getrf_panel_fused_plain(carry, act, k0, nb, bb, ib)
    _check_rows("getrf_panel_fused", carry)
    piv, act_out, linv = _lu_launch(
        "getrf_panel_fused", carry.device, act, m, nb, ib,
        carry.data_ptr(), carry.stride(0), k0)
    return carry, piv, act_out, linv


# ---------------------------------------------------------------------------
# Batched kernels (replace pallas_kernels.potrf_batched :2323 and
# getrf_batched :2433): each problem on chip, one block (potrf) or one
# cluster (getrf) a problem; past the on-chip route, one block a problem
# in device memory
# ---------------------------------------------------------------------------

def batched_plan(name: str, dev, n: int) -> tuple:
    """The plan of batched kernel ``name`` at n, from the kernel's own C
    entry on ``dev``'s library (the one :func:`smem.potrf_batched_plan` /
    :func:`smem.getrf_batched_plan` restate): ``(route, bytes)`` or
    ``(route, cluster, bytes)``."""
    from . import _build

    _fn(name)      # loads the library and checks the two plans agree
    with torch.cuda.device(dev):
        return _c_batched_plan(_build.library(name), name, n)


def _check_batched(name: str, a) -> tuple:
    from . import smem

    if a.dtype != torch.float32 or a.ndim != 3 or a.shape[1] != a.shape[2]:
        raise ValueError("%s takes a (batch, n, n) float32 tensor, got %s %s"
                         % (name, a.dtype, tuple(a.shape)))
    bsz, n = a.shape[0], a.shape[-1]
    if bsz < 1 or not smem.batched_fits(name, n):
        raise ValueError("%s takes n >= 32, n %% 32 == 0 and a problem whose "
                         "working set fits the kernel (ops/smem.py), got %s"
                         % (name, tuple(a.shape)))
    return bsz, n


def _check_contiguous(name: str, a) -> None:
    if not a.is_contiguous():
        raise ValueError("%s needs a contiguous batch, got strides %s"
                         % (name, a.stride()))


def potrf_batched_plain(a):
    """Plain version of :func:`potrf_batched`: :func:`_chol_blocked` on
    every problem at once."""
    l = torch.tril(a)
    _chol_blocked(l)
    return torch.tril(l)


def potrf_batched(a):
    """Lower Cholesky factors of B SPD problems: (B, n, n) fp32 → (B, n,
    n), upper triangles zero.  Reads only each problem's lower triangle.
    n ≥ 32 and n % 32 == 0 (:func:`slate_tpu_torch.ops.smem.batched_fits`);
    on the card ``a`` must be contiguous."""
    from . import smem

    bsz, n = _check_batched("potrf_batched", a)
    if _on_cpu(a):
        return potrf_batched_plain(a)
    _check_contiguous("potrf_batched", a)
    l = torch.empty_like(a)
    work = None        # the l2 route's scratch, (batch, n - 32, 32)
    if smem.potrf_batched_plan(n)[0] == "l2":
        work = torch.empty((bsz, n - IB, IB), dtype=torch.float32, device=a.device)
    _launch("potrf_batched", a.device, a.data_ptr(), l.data_ptr(),
            None if work is None else work.data_ptr(), bsz, n)
    return l


def getrf_batched_plain(at):
    """Plain version of :func:`getrf_batched`: the elimination of
    :func:`_lu_panel_plain` over a batch of square lane-major problems —
    every column finds its pivot among the n − j active lanes, and no
    L11⁻¹ is formed.  Per column the masked argmax (lowest lane among
    equal maxima), the multipliers in the column's row and the unfused
    rank-1 update of the rows left in the ib block; per block the U12
    forward substitution and the delayed rank-ib update of the rows past
    it, pivot lanes taking their U12 rows."""
    x = at.clone()
    bsz, n, _ = x.shape
    ib = IB
    act = torch.ones((bsz, n), dtype=torch.bool, device=x.device)
    lanes = torch.arange(n, device=x.device)
    piv = torch.empty((bsz, n), dtype=torch.int64, device=x.device)
    for b0 in range(0, n, ib):
        b1 = b0 + ib
        for j in range(b0, b1):
            p = torch.where(act, x[:, j].abs(), -1.0).argmax(-1)
            piv[:, j] = p
            pc = x[:, j:b1].gather(2, p[:, None, None].expand(bsz, b1 - j, 1))[..., 0]
            safe = torch.where(pc[:, 0] == 0, 1.0, pc[:, 0])
            act &= lanes != p[:, None]
            mult = torch.where(act, x[:, j] / safe[:, None], 0.0)
            x[:, j] = torch.where(act, mult, x[:, j])
            if j + 1 < b1:
                x[:, j + 1:b1] -= pc[:, 1:, None] * mult[:, None, :]
        if b1 < n:
            pb = piv[:, b0:b1]
            lb = torch.tril(x[:, b0:b1].gather(
                2, pb[:, None, :].expand(bsz, ib, ib)).mT, -1)
            idx = pb[:, None, :].expand(bsz, n - b1, ib)
            u = x[:, b1:].gather(2, idx).mT.contiguous()
            for jj in range(1, ib):
                u[:, jj] -= (lb[:, jj, None, :jj] @ u[:, :jj])[:, 0]
            x[:, b1:] -= u.mT @ (x[:, b0:b1] * act[:, None, :])
            x[:, b1:].scatter_(2, idx, u.mT)
    return x, piv


def getrf_batched(at):
    """TRUE partial-pivot LU of B square problems held transposed
    (lane-major): ``at`` (B, n, n) fp32 → ``(out, piv)`` with ``piv`` (B,
    n) int64, the pivot lanes in factorization order; per problem
    ``out[b][:, piv[b]].T`` is the LAPACK-packed LU of ``at[b].T`` and
    ``piv[b]`` its row permutation.  n ≥ 32, n % 32 == 0 and n ≤ 864
    (:func:`slate_tpu_torch.ops.smem.batched_fits`); on the card ``at``
    must be contiguous."""
    bsz, n = _check_batched("getrf_batched", at)
    if _on_cpu(at):
        return getrf_batched_plain(at)
    _check_contiguous("getrf_batched", at)
    out = torch.empty_like(at)
    piv = torch.empty((bsz, n), dtype=torch.int64, device=at.device)
    _launch("getrf_batched", at.device, at.data_ptr(), out.data_ptr(),
            piv.data_ptr(), bsz, n)
    return out, piv


# ---------------------------------------------------------------------------
# Fused and full Cholesky (replace pallas_kernels.potrf_step_fused :1631 and
# potrf_full_fused :1738): one cooperative grid per launch, in place on the
# (n, n) carry
# ---------------------------------------------------------------------------

def _check_potrf_fused(name: str, a, nb: int, tc: int, k0: int = 0) -> int:
    from . import smem

    _check_f32_2d(name, a)
    n = a.shape[-1]
    t = smem.STEP_TILE
    if (a.shape[0] != n or nb < t or nb & (nb - 1) or n % nb or tc < t
            or tc % t or nb % tc or k0 % nb or not 0 <= k0 < n):
        raise ValueError("%s needs an (n, n) carry, nb a power of two >= %d "
                         "dividing n, %d | tc | nb and nb | k0 < n, got %s, "
                         "nb = %d, tc = %d, k0 = %d"
                         % (name, t, t, tuple(a.shape), nb, tc, k0))
    return n


def _potrf_step_plain(a, k0: int, nb: int, tc: int) -> None:
    """One step of ``csrc/potrf_grid.cuh`` in place: (L11, L11⁻¹) of the
    diagonal block (:func:`chol_inv_panel_plain`), L21 = A21·L11⁻ᵀ, and
    the trailing (tc, tc) tile pairs (i, j), i ≥ j, minus L21_i·L21_jᵀ.
    Both plain versions run it, so on the same input the ``fused`` and
    ``full`` depths agree bitwise."""
    n = a.shape[-1]
    akk = a[k0:k0 + nb, k0:k0 + nb]
    l, linv = chol_inv_panel_plain(akk)
    akk.copy_(l)
    r0 = k0 + nb
    if r0 == n:
        return
    col = a[r0:, k0:k0 + nb]
    l21 = col @ linv.T
    col.copy_(l21)
    for j0 in range(0, n - r0, tc):
        for i0 in range(j0, n - r0, tc):
            a[r0 + i0:r0 + i0 + tc, r0 + j0:r0 + j0 + tc] -= (
                l21[i0:i0 + tc] @ l21[j0:j0 + tc].T)


def potrf_step_fused_plain(a, k0: int, nb: int = 512, tc: int = 512):
    """Plain version of :func:`potrf_step_fused` (in place on ``a``)."""
    _potrf_step_plain(a, k0, nb, min(tc, nb))
    return a


def potrf_full_fused_plain(a, nb: int = 512, tc: int = 512):
    """Plain version of :func:`potrf_full_fused`: the step for every k0."""
    for k0 in range(0, a.shape[-1], nb):
        _potrf_step_plain(a, k0, nb, min(tc, nb))
    return a


def _potrf_launch(name: str, a, nb: int, tc: int, *tail):
    """Allocate the scratch (L11, L11⁻¹, nb² floats for the diagonal
    block's Schur complement and then its doubling's products, L21) and
    launch on a grid from ``slate_<name>_plan(n, nb, tc, &G)``."""
    n = a.shape[-1]
    dev = a.device
    f32 = dict(dtype=torch.float32, device=dev)
    lkk, linv, w = (torch.empty((nb, nb), **f32) for _ in range(3))
    l21 = torch.empty((max(n - nb, 1), nb), **f32)
    _launch(name, dev, a.data_ptr(), a.stride(0), lkk.data_ptr(),
            linv.data_ptr(), w.data_ptr(), l21.data_ptr(), n, nb, tc, *tail,
            _plan(name, dev, n, nb, tc))
    return a


def potrf_step_fused(a, k0: int, nb: int = 512, tc: int = 512):
    """One right-looking Cholesky step on the (n, n) fp32 carry at block
    column k0, IN PLACE (the TPU kernel's aliased carry): the diagonal
    block becomes L11 (zeros above it), the rows below it in the block
    column L21 = A21·L11⁻ᵀ, and the (tc, tc) trailing tile pairs on and
    below the diagonal lose L21_i·L21_jᵀ; rows and columns before k0 and
    the rest of the upper triangle pass through untouched (the driver
    keeps the lower triangle at the end).  nb a power of two ≥ 128
    dividing n; tc = min(tc, nb) a multiple of 128 dividing nb.  Returns
    ``a``.  On the card ``a`` needs unit column stride."""
    tc = min(tc, nb)
    _check_potrf_fused("potrf_step_fused", a, nb, tc, k0)
    if _on_cpu(a):
        return potrf_step_fused_plain(a, k0, nb, tc)
    _check_rows("potrf_step_fused", a)
    return _potrf_launch("potrf_step_fused", a, nb, tc, k0)


def potrf_full_fused(a, nb: int = 512, tc: int = 512):
    """The whole lower Cholesky factorization of the (n, n) fp32 carry in
    one launch, IN PLACE: :func:`potrf_step_fused` for k0 = 0, nb, …, with
    the same carry contract.  Returns ``a``."""
    tc = min(tc, nb)
    _check_potrf_fused("potrf_full_fused", a, nb, tc)
    if _on_cpu(a):
        return potrf_full_fused_plain(a, nb, tc)
    _check_rows("potrf_full_fused", a)
    return _potrf_launch("potrf_full_fused", a, nb, tc)


# ---------------------------------------------------------------------------
# Fused and full partial-pivot LU (replace pallas_kernels.getrf_step_fused
# :1317 and getrf_full_fused :1481): one step of lu_full.cuh at k0, or the
# loop of steps, in place on the transposed (n_rows, m) carry
# ---------------------------------------------------------------------------

def _panel_scratch(dev, grid: int, w: int):
    """The panel outputs of ``lu_full.cuh`` and its candidate scratch:
    ``(piv, linv, cand, cval, clane)``."""
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.empty(w, dtype=torch.int64, device=dev),
            torch.empty((w, w), **f32), torch.empty((2, grid, w), **f32),
            torch.empty((2, grid), **f32),
            torch.empty((2, grid), dtype=torch.int32, device=dev))


def _check_lu_step(name: str, at, act, k0: int, nb: int, bb: int,
                   ib: int) -> None:
    """The shapes :func:`smem.lu_fused_fits` admits: 128 | nb | rows."""
    from . import smem

    n_rows, m = at.shape
    _check_lu_panel(name, at, act, nb, m, ib)
    _check_fused(at, k0, nb, bb, ib, name)
    if nb % smem.STEP_TILE or n_rows % nb or k0 + nb > m:
        raise ValueError("%s needs 128 | nb | rows and k0 + nb <= lanes, got "
                         "(%d, %d), k0 = %d, nb = %d"
                         % (name, n_rows, m, k0, nb))


def _lu_trailing_plain(at, k0: int, nb: int, piv, act_out, linv,
                       update: bool) -> None:
    """The trailing phase of a step of ``csrc/lu_full.cuh`` in place: X₂ = 2X −
    X·(L11·X), U = C[:, piv]·X₂ᵀ over the rows past the panel, then (with
    ``update``) C[:, l] −= U·L[:, l] for the lanes active after the panel,
    and C[:, piv] = U."""
    r0 = k0 + nb
    if r0 >= at.shape[0]:
        return
    panel = at[k0:r0]
    eye = torch.eye(nb, dtype=at.dtype, device=at.device)
    l11 = torch.tril(panel[:, piv].T, -1) + eye
    x2 = 2.0 * linv - linv @ (l11 @ linv)
    rows = at[r0:]
    u = rows[:, piv] @ x2.T
    if update:
        rows -= u @ torch.where(act_out > 0, panel, 0.0)
    rows[:, piv] = u


def getrf_step_fused_plain(at, act, k0: int, nb: int = 512, bb: int = 128,
                           ib: int = 16, tc=None, update: bool = True):
    """Plain version of :func:`getrf_step_fused` (in place on ``at``):
    :func:`getrf_panel_fused_plain`, then the trailing phase."""
    at, piv, act_out, linv = getrf_panel_fused_plain(at, act, k0, nb, bb, ib)
    _lu_trailing_plain(at, k0, nb, piv, act_out, linv, update)
    return at, piv, act_out, linv


def getrf_full_fused_plain(at, act, nb: int = 512, bb: int = 128,
                           ib: int = 16, tc=None):
    """Plain version of :func:`getrf_full_fused`: the step for every k0
    (so on the same input it agrees bitwise with the ``fused`` depth)."""
    pivs = []
    act = act.reshape(1, -1)
    for k0 in range(0, min(at.shape), nb):
        at, piv, act, _ = getrf_step_fused_plain(at, act, k0, nb, bb, ib)
        pivs.append(piv)
    return at, torch.cat(pivs), act


def _lu_step_scratch(dev, rows: int, m: int, nb: int) -> list:
    """The scratch ``lu_full.cuh``'s step takes besides the panel's, for
    ``rows`` carry rows from the first panel on, in the kernels' argument
    order: L11, T and X₂ (nb² each), U and the gathered C[:, piv] of the
    trailing rows, the lanes still active at a step (two lists of m) and
    their counts, and a zeroed column-barrier counter."""
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    ts = [torch.empty((nb, nb), **f32) for _ in range(3)]
    ts += [torch.empty((max(rows - nb, 1), nb), **f32) for _ in range(2)]
    return ts + [torch.empty(2 * m, **i32), torch.empty(2, **i32),
                 torch.zeros(1, **i32)]


def getrf_step_fused(at, act, k0: int, nb: int = 512, bb: int = 128,
                     ib: int = 16, tc=None, update: bool = True):
    """One right-looking partial-pivot LU step on the transposed (n_rows,
    m) fp32 carry, IN PLACE: the panel of :func:`getrf_panel_fused` on
    rows [k0, k0 + nb), then the Newton-refined pivot-block inverse X₂,
    U = C[:, piv]·X₂ᵀ over the rows past the panel, and (``update``) the
    rank-nb update of the lanes active after the panel; U goes into the
    pivot lanes.  ``update=False`` is the ``fused_trsm`` depth: the
    caller applies the rank-nb update.  Returns ``(at, piv, act_out,
    linv)`` as :func:`getrf_panel_fused` (``linv`` the panel's inverse,
    before the Newton step).  nb a multiple of 128 dividing the row
    count, bb | nb, ib | bb, k0 + nb ≤ m.  ``tc`` only mirrors the JAX
    signature: each trailing row is updated alone, so no chunk height
    enters.  On the card ``at`` needs unit lane stride."""
    n_rows, m = at.shape
    bb = min(bb, nb)
    ib = min(ib, bb)
    _check_lu_step("getrf_step_fused", at, act, k0, nb, bb, ib)
    if _on_cpu(at, act):
        return getrf_step_fused_plain(at, act, k0, nb, bb, ib, update=update)
    _check_rows("getrf_step_fused", at)
    dev = at.device
    grid = _plan("getrf_step_fused", dev, m, nb, ib)
    act_out = torch.empty((1, m), dtype=torch.float32, device=dev)
    piv, linv, cand, cval, clane = _panel_scratch(dev, grid, nb)
    scratch = _lu_step_scratch(dev, n_rows - k0, m, nb)
    act = act.reshape(-1).contiguous()
    _launch("getrf_step_fused", dev, at.data_ptr(), at.stride(0), k0, n_rows,
            act.data_ptr(), act_out.data_ptr(), piv.data_ptr(),
            linv.data_ptr(), cand.data_ptr(), cval.data_ptr(),
            clane.data_ptr(), *(t.data_ptr() for t in scratch), m, nb, ib,
            int(bool(update)), grid)
    return at, piv, act_out, linv


def getrf_full_fused(at, act, nb: int = 512, bb: int = 128, ib: int = 16,
                     tc=None):
    """The whole partial-pivot LU of the transposed (n_rows, m) fp32 carry
    in one launch, IN PLACE: :func:`getrf_step_fused` for k0 = 0, nb, …
    below min(n_rows, m).  Returns ``(at, piv, act_out)`` with ``piv`` the
    min(n_rows, m) pivot lanes in factorization order; ``tc`` as in
    :func:`getrf_step_fused`."""
    n_rows, m = at.shape
    bb = min(bb, nb)
    ib = min(ib, bb)
    ktot = min(n_rows, m)
    _check_lu_step("getrf_full_fused", at, act, 0, nb, bb, ib)
    if ktot % nb:
        raise ValueError("getrf_full_fused needs nb | min(rows, lanes), got "
                         "(%d, %d), nb = %d" % (n_rows, m, nb))
    if _on_cpu(at, act):
        return getrf_full_fused_plain(at, act, nb, bb, ib)
    _check_rows("getrf_full_fused", at)
    dev = at.device
    grid = _plan("getrf_full_fused", dev, m, nb, ib)
    act_w = act.reshape(1, m).to(torch.float32).clone()
    piv = torch.empty(ktot, dtype=torch.int64, device=dev)
    _, linv, cand, cval, clane = _panel_scratch(dev, grid, nb)
    scratch = _lu_step_scratch(dev, n_rows, m, nb)
    _launch("getrf_full_fused", dev, at.data_ptr(), at.stride(0), n_rows,
            act_w.data_ptr(), piv.data_ptr(), linv.data_ptr(),
            cand.data_ptr(), cval.data_ptr(), clane.data_ptr(),
            *(t.data_ptr() for t in scratch), m, nb, ib, grid)
    return at, piv, act_w


# ---------------------------------------------------------------------------
# The distributed drivers' fused panels (replace pallas_kernels.chol_l21_panel
# :602 and lu_u12_panel :646): one cooperative grid each, the whole grid
# forms the (nb, nb) triangle's inverse (chol_l21_panel: with its Cholesky),
# then every block takes 128-wide tiles of the products
# ---------------------------------------------------------------------------

FUSED_TILE = 128


def fused_panel_fits(nb: int, dims=(), device="cuda") -> bool:
    """The two fused panel kernels' shape rule: on the card nb a power of
    two in [128, 1024] and every dim of ``dims`` (the panel height of
    :func:`chol_l21_panel`, the block-row width of :func:`lu_u12_panel`)
    a multiple of 128; on the CPU, where the plain versions run, nb a
    power of two in [32, 1024].  The ``dist_panel`` site calls the
    ``pallas_fused`` rung ineligible where this fails."""
    lo = FUSED_TILE if torch.device(device).type == "cuda" else IB
    if not (lo <= nb <= 1024 and nb & (nb - 1) == 0):
        return False
    return torch.device(device).type != "cuda" or all(
        d % FUSED_TILE == 0 for d in dims)


def _check_fused_panel(name: str, tri, other, dims) -> int:
    nb = tri.shape[-1]
    if (tri.ndim != 2 or other.ndim != 2 or tri.shape[0] != nb
            or tri.dtype != other.dtype
            or tri.dtype not in (torch.float32, torch.float64)):
        raise ValueError("%s takes a square (nb, nb) block and a 2-D operand "
                         "of one real float dtype, got %s %s and %s %s"
                         % (name, tri.dtype, tuple(tri.shape), other.dtype,
                            tuple(other.shape)))
    if not fused_panel_fits(nb, dims, tri.device):
        raise ValueError("%s needs nb a power of two in [%d, 1024]%s, got nb "
                         "= %d and %s" % (
                             name, FUSED_TILE if tri.is_cuda else IB,
                             " and 128 | %s on the card" % (dims,)
                             if tri.is_cuda else "", nb, tuple(other.shape)))
    return nb


def chol_l21_panel_plain(d, panel):
    """Plain version of :func:`chol_l21_panel`: :func:`chol_inv_panel_plain`
    of ``d``, then X = panel·L⁻ᵀ as one product."""
    l, linv = chol_inv_panel_plain(d)
    return l, panel @ linv.mT


def chol_l21_panel_scratch(nb: int) -> int:
    """Floats of scratch :func:`chol_l21_panel` hands its kernel: the nb²
    of ``chol_inv_grid`` (``csrc/tri_grid.cuh``), the Schur complement and
    then the doubling's products."""
    return nb * nb


def chol_l21_panel(d, panel):
    """``(L, X)`` of ppotrf's per-step panel: L the lower Cholesky factor
    of the (nb, nb) SPD block ``d`` (only its lower triangle is read;
    zeros above the diagonal) and X = panel·L⁻ᵀ for the full-height
    (M, nb) ``panel``.  On the card fp32, nb a power of two in [128,
    1024], M a multiple of 128; either operand may be a view with unit
    column stride and any row stride ≥ nb."""
    m = panel.shape[0]
    nb = _check_fused_panel("chol_l21_panel", d, panel, (m,))
    if panel.shape[1] != nb:
        raise ValueError("chol_l21_panel: the panel is %s, not (M, %d)"
                         % (tuple(panel.shape), nb))
    if _on_cpu(d, panel):
        return chol_l21_panel_plain(d, panel)
    _check_f32_2d("chol_l21_panel", d, panel)
    _check_rows("chol_l21_panel", d)
    _check_rows("chol_l21_panel", panel)
    dev = d.device
    f32 = dict(dtype=torch.float32, device=dev)
    l = torch.empty((nb, nb), **f32)
    linv = torch.empty((nb, nb), **f32)
    w = torch.empty(chol_l21_panel_scratch(nb), **f32)
    x = torch.empty((m, nb), **f32)
    _launch("chol_l21_panel", dev, d.data_ptr(), d.stride(0),
            panel.data_ptr(), panel.stride(0), l.data_ptr(), linv.data_ptr(),
            w.data_ptr(), x.data_ptr(), m, nb,
            _plan("chol_l21_panel", dev, m, nb))
    return l, x


def lu_u12_panel_plain(l11, rowblk):
    """Plain version of :func:`lu_u12_panel`: :func:`trtri_panel_plain` of
    L11, then u1 = L⁻¹·B, r1 = B − L11·u1, U = u1 + L⁻¹·r1 and
    dev = max|r1| / max(max|B|, tiny)."""
    linv = trtri_panel_plain(l11)
    u1 = linv @ rowblk
    r1 = rowblk - l11 @ u1
    tiny = torch.finfo(rowblk.dtype).tiny
    dev = r1.abs().max() / torch.clamp(rowblk.abs().max(), min=tiny)
    return u1 + linv @ r1, dev.reshape(1, 1)


def lu_u12_panel(l11, rowblk):
    """``(U, dev)`` of pgetrf's block-row solve: U = L11⁻¹·B with one
    residual correction, for the unit-lower (nb, nb) ``l11`` (its lower
    triangle and diagonal are read for the inverse, the whole block for
    the correction, as the TPU kernel does: the caller stores the unit
    diagonal and zeros above it) and the (nb, w) block row ``rowblk``;
    ``dev`` (1, 1) is the departure max|B − L11·L⁻¹B| / max|B| of the
    uncorrected solve, the caller's guard.  On the card fp32, nb a power
    of two in [128, 1024], w a multiple of 128; both operands may be
    views with unit column stride."""
    nb = _check_fused_panel("lu_u12_panel", l11, rowblk,
                            (rowblk.shape[1],))
    if rowblk.shape[0] != nb:
        raise ValueError("lu_u12_panel: the block row is %s, not (%d, w)"
                         % (tuple(rowblk.shape), nb))
    if _on_cpu(l11, rowblk):
        return lu_u12_panel_plain(l11, rowblk)
    _check_f32_2d("lu_u12_panel", l11, rowblk)
    _check_rows("lu_u12_panel", l11)
    _check_rows("lu_u12_panel", rowblk)
    dev = l11.device
    w = rowblk.shape[1]
    f32 = dict(dtype=torch.float32, device=dev)
    u = torch.empty((nb, w), **f32)
    linv = torch.empty((nb, nb), **f32)
    work = torch.empty((nb // 2) ** 2, **f32)
    r = torch.empty((nb, w), **f32)
    mx = torch.empty(2, dtype=torch.int32, device=dev)
    departure = torch.empty((1, 1), **f32)
    _launch("lu_u12_panel", dev, l11.data_ptr(), l11.stride(0),
            rowblk.data_ptr(), rowblk.stride(0), u.data_ptr(),
            linv.data_ptr(), work.data_ptr(), r.data_ptr(), mx.data_ptr(),
            departure.data_ptr(), nb, w, _plan("lu_u12_panel", dev, nb, w))
    return u, departure


# ---------------------------------------------------------------------------
# Householder band → tridiagonal bulge chase (replaces
# pallas_kernels.hb2st_wavefront :2033): one cooperative launch of
# thread-block clusters over the wavefront staggers t = 3·sweep + window,
# one cluster a task, in place on the wide band
# ---------------------------------------------------------------------------

def chase_plan(name: str, dev, n: int, kd: int, j0: int, j1: int, dtype):
    """``(clusters, cluster, route)`` of chase kernel ``name``'s launch over
    sweeps ``[j0, j1)``: G clusters of C blocks, and the route (``smem``:
    each task's window in its cluster's shared memory; ``l2``: left in
    the band), from the kernel's own plan (``chase.cuh`` plan, which
    :func:`smem.chase_plan` restates)."""
    from . import smem

    size = torch.empty((), dtype=dtype).element_size()
    g, c, route = _plan(name, dev, n, kd, j0, j1, size, outs=3)
    return g, c, smem.CHASE_ROUTES[route]


def chase_clusters(name: str, dev, kd: int, dtype) -> dict:
    """Clusters of each size C = 16, 8, 4, 2, 1 that the card holds at
    once for chase kernel ``name`` at band width ``kd`` on the shape's
    route (the occupancy query :func:`smem.chase_plan` takes); 0 where a
    block's share does not fit."""
    from . import _build, smem

    fn = getattr(_build.library(name), "slate_%s_clusters" % name)
    fn.argtypes, fn.restype = [_I] * 4 + [ctypes.POINTER(ctypes.c_int)], ctypes.c_int
    kind = name.split("_")[0]
    route = smem.chase_route(kind, kd, dtype)
    size = torch.empty((), dtype=dtype).element_size()
    out = {}
    c = smem.CHASE_CLUSTER
    while c >= 1:
        got = ctypes.c_int(0)
        if smem.chase_block_bytes(kind, kd, dtype, c, route) <= smem.BLOCK_SMEM_MAX:
            with torch.cuda.device(dev):
                rc = fn(kd, size, c, smem.CHASE_ROUTES.index(route), ctypes.byref(got))
            if rc != 0:
                raise RuntimeError("%s: occupancy query at cluster %d: CUDA error %d"
                                   % (name, c, rc))
        out[c] = got.value
        c //= 2
    return out


def hb_wave_meta(n: int, kd: int, j0: int = 0, j1=None):
    """Wavefront geometry of sweeps ``[j0, j1)`` (a copy of the JAX
    package's ``_hb_wave_meta``): ``(nsweeps, nwin_max, tmax, nl)`` — the
    sweep count, the most windows of a sweep (the log's middle dim,
    nwin_j = (n − 3 − j)//kd + 1), the last stagger and the most tasks
    live at one stagger."""
    j1 = min(j1 if j1 is not None else n - 2, n - 2)
    nwin = [(n - 3 - j) // kd + 1 for j in range(j0, max(j1, j0))]
    if not nwin:
        return 0, 0, 0, 1
    nwin_max = max(nwin)
    tmax = max(3 * js + nw - 1 for js, nw in enumerate(nwin))
    return len(nwin), nwin_max, tmax, min(len(nwin), nwin_max // 3 + 2)


def _band_block(abw, r: int, c: int, rows: int, cols: int):
    """The (rows, cols) view A[r:r+rows, c:c+cols] of the lower band
    ``abw`` (``abw[c, d]`` = A[c+d, c]): A[r+i, c+k] lies at flat offset
    c·(W−1) + r + i + k·(W−1).  Entries above the diagonal (r+i < c+k)
    alias other band entries and must not be written."""
    w = abw.shape[1]
    return abw.as_strided((rows, cols), (1, w - 1),
                          abw.storage_offset() + c * (w - 1) + r)


def _larfg_plain(x):
    """LAPACK-convention ``larfg`` of the live vector ``x`` as the JAX
    kernel's ``_wf_larfg`` (real): β = −sign(α)·‖x‖, τ = 0 and β = α for
    a zero tail, no safmin rescaling.  Returns ``(v, τ, β)`` with
    v[0] = 1 stored, as 0-d tensors where scalar (no host read)."""
    alpha = x[0]
    xnorm2 = (x[1:] * x[1:]).sum()
    anorm = torch.sqrt(alpha * alpha + xnorm2)
    beta = torch.where(alpha >= 0, -anorm, anorm)
    is_zero = xnorm2 == 0
    one = torch.ones((), dtype=x.dtype, device=x.device)
    tau = torch.where(is_zero, torch.zeros_like(alpha),
                      (beta - alpha) / torch.where(beta == 0, one, beta))
    denom = alpha - beta
    denom = torch.where(is_zero | (denom == 0), one, denom)
    v = torch.cat([one[None], x[1:] / denom])
    return v, tau, torch.where(is_zero, alpha, beta)


def _two_sided_plain(abw, r: int, length: int, v, tau) -> None:
    """S ← H·S·H on the Hermitian block S = A[r:r+L, r:r+L] (its lower
    triangle in the band), H = I − τ·v·vᵀ: w = τ·S·v, w −= ½·τ·(vᵀw)·v,
    S −= v·wᵀ + w·vᵀ on the stored triangle (``hh_two_sided``)."""
    s = _band_block(abw, r, r, length, length)
    low = torch.tril(s)
    wv = tau * ((low + torch.tril(s, -1).mT) @ v)
    wv = wv - (0.5 * tau * (v @ wv)) * v
    s.sub_(torch.tril(v[:, None] * wv[None, :] + wv[:, None] * v[None, :]))


def _tail_plain(abw, row: int, r: int, length: int, v, tau) -> None:
    """The length-1 trailing coupling (``hb_sweep_tail``): right-apply H
    to the single row A[row, r:r+L] past the window."""
    seg = _band_block(abw, row, r, 1, length)[0]
    seg.sub_(((seg @ v) * tau) * v)


def hb2st_wavefront_plain(abw, kd: int, j0: int = 0, j1=None):
    """Plain version of :func:`hb2st_wavefront`: the same task bodies in
    serial sweep-major order on band-storage views (equivalent to the
    wavefront order: same-stagger tasks touch disjoint rows).  In place
    on ``abw``; returns ``(abw, vt)``."""
    n = abw.shape[0]
    nsweeps, nwin_max, _, _ = hb_wave_meta(n, kd, j0, j1)
    vt = torch.zeros((nsweeps, max(nwin_max, 1), kd + 1), dtype=abw.dtype,
                     device=abw.device)
    for js in range(nsweeps):
        j = j0 + js
        nwin = (n - 3 - j) // kd + 1
        length = min(kd, n - 1 - j)
        col = abw[j, 1:1 + length]
        v, tau, beta = _larfg_plain(col.clone())
        col[0] = beta
        col[1:] = 0
        _two_sided_plain(abw, j + 1, length, v, tau)
        vt[js, 0, 0] = tau
        vt[js, 0, 1:1 + length] = v
        if nwin == 1 and n - (j + 1 + length) == 1:
            _tail_plain(abw, j + 1 + length, j + 1, length, v, tau)
        for w in range(1, nwin):
            r0 = j + 1 + (w - 1) * kd
            r1 = r0 + kd
            lt = min(kd, n - r1)
            u, tau_p = vt[js, w - 1, 1:], vt[js, w - 1, 0]
            blk = _band_block(abw, r1, r0, lt, kd)
            blk.sub_((tau_p * (blk @ u))[:, None] * u[None, :])
            v, tau, beta = _larfg_plain(blk[:, 0].clone())
            blk[0, 0] = beta
            blk[1:, 0] = 0
            blk[:, 1:].sub_(v[:, None] * (tau * (v @ blk[:, 1:]))[None, :])
            _two_sided_plain(abw, r1, lt, v, tau)
            vt[js, w, 0] = tau
            vt[js, w, 1:1 + lt] = v
            if w == nwin - 1 and n - (r1 + lt) == 1:
                _tail_plain(abw, r1 + lt, r1, lt, v, tau)
    return abw, vt


_HB2ST_DT = {torch.float32: "f32", torch.float64: "f64"}


def _check_hb2st(abw, kd: int) -> None:
    if abw.dtype not in _HB2ST_DT or abw.ndim != 2:
        raise ValueError("hb2st_wavefront takes a 2-D float32 or float64 band "
                         "(complex input takes the host chase), got %s %s"
                         % (abw.dtype, tuple(abw.shape)))
    if kd < 4 or abw.shape[1] != 2 * kd + 2:
        raise ValueError("hb2st_wavefront needs kd >= 4 and the wide band "
                         "(n, 2·kd + 2), got kd = %d, %s"
                         % (kd, tuple(abw.shape)))
    if not abw.is_contiguous():
        raise ValueError("hb2st_wavefront needs a contiguous band, got "
                         "strides %s" % (abw.stride(),))


def hb2st_wavefront(abw, kd: int, j0: int = 0, j1=None):
    """Householder band → tridiagonal chase over sweeps ``[j0, j1)``
    (default all n − 2) in ONE launch, IN PLACE on the wide lower band
    ``abw`` (n, 2·kd + 2), ``abw[c, d]`` = A[c+d, c], fp32 or fp64,
    kd ≥ 4, contiguous.  Returns ``(abw, vt)`` with the reflector log
    ``vt`` (nsweeps, nwin_max, kd + 1): ``vt[s, w, 0]`` = τ and
    ``vt[s, w, 1:]`` = v (v[0] = 1; zero past the window's length and in
    the rows past a sweep's windows), the padded layout
    :func:`slate_tpu_torch.linalg.eig.unmtr_hb2st_hh` consumes."""
    _check_hb2st(abw, kd)
    if _on_cpu(abw):
        return hb2st_wavefront_plain(abw, kd, j0, j1)
    n = abw.shape[0]
    nsweeps, nwin_max, _, _ = hb_wave_meta(n, kd, j0, j1)
    vt = torch.zeros((nsweeps, max(nwin_max, 1), kd + 1), dtype=abw.dtype,
                     device=abw.device)
    if nsweeps:
        j1 = j0 + nsweeps
        _launch("hb2st_wavefront", abw.device, abw.data_ptr(), abw.stride(0),
                n, kd, j0, j1, vt.data_ptr(), nwin_max, 1,
                dt=_HB2ST_DT[abw.dtype])
    return abw, vt


def hb2st_wavefront_barriers(abw, kd: int, j0: int = 0, j1=None) -> None:
    """The launch of :func:`hb2st_wavefront` with every task skipped: the
    same grid and the same grid barriers, nothing computed — a
    measurement of the barriers' share, not counted as a launch."""
    _check_hb2st(abw, kd)
    n = abw.shape[0]
    nsweeps, nwin_max, _, _ = hb_wave_meta(n, kd, j0, j1)
    scratch = torch.zeros((1, 1, kd + 1), dtype=abw.dtype, device=abw.device)
    _launch("hb2st_wavefront", abw.device, abw.data_ptr(), abw.stride(0), n,
            kd, j0, j0 + nsweeps, scratch.data_ptr(), nwin_max, 0,
            dt=_HB2ST_DT[abw.dtype], count=False)


# ---------------------------------------------------------------------------
# Householder upper band → bidiagonal bulge chase (replaces
# pallas_kernels.tb2bd_wavefront :2226): one cooperative launch of
# thread-block clusters over the wavefront staggers t = 3·sweep + block,
# one cluster a task, in place on the general band, two reflector logs
# ---------------------------------------------------------------------------

def tb_wave_meta(n: int, kd: int, s0: int = 0, s1=None):
    """Wavefront geometry of sweeps ``[s0, s1)`` (a copy of the JAX
    package's ``_tb_wave_meta``; s1 is clipped to n − 2, the last sweep
    with a block): ``(nsweeps, nblk_max, tmax, nl)`` — the sweep count,
    the most blocks of a sweep (the logs' middle dim, nblk(s) =
    (n − 2 − s)//kd + 1), the last stagger and the most tasks live at
    one stagger."""
    s1 = min(s1 if s1 is not None else n - 1, n - 2)
    nblk = [(n - 2 - s) // kd + 1 for s in range(s0, max(s1, s0))]
    if not nblk:
        return 0, 0, 0, 1
    nblk_max = max(nblk)
    tmax = max(3 * js + nb - 1 for js, nb in enumerate(nblk))
    return len(nblk), nblk_max, tmax, min(len(nblk), nblk_max // 3 + 2)


def _gen_block(st, kd: int, r: int, c: int, rows: int, cols: int):
    """The (rows, cols) view A[r:r+rows, c:c+cols] of the row-major
    general band ``st`` (``st[r, c−r+kd]`` = A[r, c]): A[r+i, c+k] lies
    at flat offset (r+i)·(W−1) + c + k + kd.  Valid while every c−r of
    the block lies in [−kd, 2kd+1]."""
    w = st.shape[1]
    return st.as_strided((rows, cols), (w - 1, 1),
                         st.storage_offset() + r * (w - 1) + c + kd)


def _tb_right(blk, v, tau) -> None:
    """blk ← blk·(I − τ·v·vᵀ) (each row: −= τ·(row·v)·v)."""
    blk.sub_((tau * (blk @ v))[:, None] * v[None, :])


def _tb_left(blk, u, tau) -> None:
    """blk ← (I − τ·u·uᵀ)·blk (each column: −= τ·(uᵀ·col)·u)."""
    blk.sub_(u[:, None] * (tau * (u @ blk))[None, :])


def tb2bd_wavefront_plain(st, kd: int, s0: int = 0, s1=None):
    """Plain version of :func:`tb2bd_wavefront`: the same task bodies in
    serial sweep-major order on band-storage views (equivalent to the
    wavefront order: same-stagger tasks touch disjoint rows and
    columns).  In place on ``st``; returns ``(st, ut, vt)``."""
    n = st.shape[0]
    nsweeps, nblk_max, _, _ = tb_wave_meta(n, kd, s0, s1)
    shape = (nsweeps, max(nblk_max, 1), kd + 1)
    ut = torch.zeros(shape, dtype=st.dtype, device=st.device)
    vt = torch.zeros(shape, dtype=st.dtype, device=st.device)
    for js in range(nsweeps):
        s = s0 + js
        nblk = (n - 2 - s) // kd + 1
        # window 0: the right reflector from row s beyond the
        # superdiagonal, then the left one from the first column below
        # the diagonal
        lv = min(kd, n - 1 - s)
        row = _gen_block(st, kd, s, s + 1, 1, lv)[0]
        v, tauv, beta = _larfg_plain(row.clone())
        row[0] = beta
        row[1:] = 0
        blk = _gen_block(st, kd, s + 1, s + 1, lv, lv)
        _tb_right(blk, v, tauv)
        u, tauu, beta = _larfg_plain(blk[:, 0].clone())
        blk[0, 0] = beta
        blk[1:, 0] = 0
        _tb_left(blk[:, 1:], u, tauu)
        vt[js, 0, 0], vt[js, 0, 1:1 + lv] = tauv, v
        ut[js, 0, 0], ut[js, 0, 1:1 + lv] = tauu, u
        for b in range(1, nblk):
            i_lo = (b - 1) * kd + 1 + s
            j_lo = i_lo + kd
            li, lj = min(kd, n - i_lo), min(kd, n - j_lo)
            u, tau_p = ut[js, b - 1, 1:1 + li], ut[js, b - 1, 0]
            # the previous left reflector on the off-diagonal block, the
            # next right reflector from its first row
            off = _gen_block(st, kd, i_lo, j_lo, li, lj)
            _tb_left(off, u, tau_p)
            v, tauv, beta = _larfg_plain(off[0].clone())
            off[0, 0] = beta
            off[0, 1:] = 0
            _tb_right(off[1:], v, tauv)
            # that reflector on the diagonal block, the next left
            # reflector from its first column
            dg = _gen_block(st, kd, j_lo, j_lo, lj, lj)
            _tb_right(dg, v, tauv)
            u, tauu, beta = _larfg_plain(dg[:, 0].clone())
            dg[0, 0] = beta
            dg[1:, 0] = 0
            _tb_left(dg[:, 1:], u, tauu)
            vt[js, b, 0], vt[js, b, 1:1 + lj] = tauv, v
            ut[js, b, 0], ut[js, b, 1:1 + lj] = tauu, u
    return st, ut, vt


def _check_tb2bd(st, kd: int) -> None:
    if st.dtype not in _HB2ST_DT or st.ndim != 2:
        raise ValueError("tb2bd_wavefront takes a 2-D float32 or float64 band "
                         "(complex input takes the host chase), got %s %s"
                         % (st.dtype, tuple(st.shape)))
    if kd < 4 or st.shape[1] != 3 * kd + 2:
        raise ValueError("tb2bd_wavefront needs kd >= 4 and the general band "
                         "(n, 3·kd + 2), got kd = %d, %s"
                         % (kd, tuple(st.shape)))
    if not st.is_contiguous():
        raise ValueError("tb2bd_wavefront needs a contiguous band, got "
                         "strides %s" % (st.stride(),))


def tb2bd_wavefront(st, kd: int, s0: int = 0, s1=None):
    """Householder upper band → bidiagonal chase over sweeps ``[s0, s1)``
    (default all, clipped to n − 2) in ONE launch, IN PLACE on the
    row-major general band ``st`` (n, 3·kd + 2), ``st[r, c−r+kd]`` =
    A[r, c], fp32 or fp64, kd ≥ 4, contiguous.  Returns ``(st, ut, vt)``:
    the left (U) and right (V) reflector logs, each (nsweeps, nblk_max,
    kd + 1) with τ at ``[..., 0]`` and v (v[0] = 1) after it, zero past a
    reflector's length and in the rows past a sweep's blocks — the
    layout :func:`slate_tpu_torch.linalg.eig.unmtr_hb2st_hh` consumes."""
    _check_tb2bd(st, kd)
    if _on_cpu(st):
        return tb2bd_wavefront_plain(st, kd, s0, s1)
    n = st.shape[0]
    nsweeps, nblk_max, _, _ = tb_wave_meta(n, kd, s0, s1)
    shape = (nsweeps, max(nblk_max, 1), kd + 1)
    ut = torch.zeros(shape, dtype=st.dtype, device=st.device)
    vt = torch.zeros(shape, dtype=st.dtype, device=st.device)
    if nsweeps:
        _launch("tb2bd_wavefront", st.device, st.data_ptr(), st.stride(0), n,
                kd, s0, s0 + nsweeps, ut.data_ptr(), vt.data_ptr(), nblk_max,
                1, dt=_HB2ST_DT[st.dtype])
    return st, ut, vt


def tb2bd_wavefront_barriers(st, kd: int, s0: int = 0, s1=None) -> None:
    """The launch of :func:`tb2bd_wavefront` with every task skipped: the
    same grid and the same grid barriers, nothing computed — a
    measurement of the barriers' share, not counted as a launch."""
    _check_tb2bd(st, kd)
    n = st.shape[0]
    nsweeps, nblk_max, _, _ = tb_wave_meta(n, kd, s0, s1)
    scratch = torch.zeros((2, 1, kd + 1), dtype=st.dtype, device=st.device)
    _launch("tb2bd_wavefront", st.device, st.data_ptr(), st.stride(0), n, kd,
            s0, s0 + nsweeps, scratch[0].data_ptr(), scratch[1].data_ptr(),
            nblk_max, 0, dt=_HB2ST_DT[st.dtype], count=False)


# ---------------------------------------------------------------------------
# Tile kernels (replace pallas_kernels.tile_norms :148, tzset :193 and
# tzscale :201 through _tz_call :207, geadd :232, gescale_row_col :253):
# no driver calls them, in either package; the drivers take the torch
# forms of ops/tile_ops.py, as the JAX drivers take the jnp forms
# ---------------------------------------------------------------------------

_TILE_DT = {torch.float32: "f32", torch.float64: "f64"}


def _tile_dt(name: str, *ts) -> str:
    """The dtype suffix of a CUDA call on ``ts``: one real dtype (fp32 or
    fp64), contiguous.  A complex tensor is a TypeError (the TPU kernels
    are real; complex input runs the plain version on the CPU)."""
    if any(t.dtype.is_complex for t in ts):
        raise TypeError("%s: the CUDA kernel takes float32 or float64, got "
                        "%s (complex input runs on the CPU)"
                        % (name, [str(t.dtype) for t in ts]))
    dt = ts[0].dtype
    if dt not in _TILE_DT or any(t.dtype != dt for t in ts):
        raise ValueError("%s: the CUDA kernel takes one dtype, float32 or "
                         "float64, got %s" % (name, [str(t.dtype) for t in ts]))
    for t in ts:
        if not t.is_contiguous():
            raise ValueError("%s needs contiguous tensors on the card, got "
                             "strides %s for shape %s"
                             % (name, t.stride(), tuple(t.shape)))
    return _TILE_DT[dt]


def _check_tiles(name: str, a, bm: int, bn: int):
    """``(m, n)`` of the 2-D ``a``; raises where the Pallas kernel's grid
    would (after bm = min(bm, m), m % bm != 0; likewise n).  bm and bn
    change no answer."""
    if a.ndim != 2:
        raise ValueError("%s takes a 2-D matrix, got %s"
                         % (name, tuple(a.shape)))
    m, n = a.shape
    bm, bn = min(bm, m), min(bn, n)
    if bm <= 0 or bn <= 0 or m % bm or n % bn:
        raise ValueError("%s: pad shapes to the tile grid: (%d, %d) in "
                         "(%d, %d) tiles" % (name, m, n, bm, bn))
    return m, n


def tile_norms_plain(x, norm: str = "max"):
    """Plain version of :func:`tile_norms` (any dtype the JAX kernel
    takes, complex included)."""
    if norm == "max":
        return x.abs().amax(dim=(1, 2))
    sq = x.real * x.real + x.imag * x.imag if x.is_complex() else x * x
    return sq.sum(dim=(1, 2))


def tile_norms(x, norm: str = "max"):
    """Per-tile partial norms of an (nt, mb, nb) tile batch: ``"max"`` →
    each tile's max|x| (NaN if the tile holds one), anything else → each
    tile's Σ|x|² (unsquared; the caller reduces and takes the root).
    Returns (nt,) in the real dtype of ``x``.  On the card ``x`` is
    contiguous fp32 or fp64."""
    if x.ndim != 3:
        raise ValueError("tile_norms takes an (nt, mb, nb) batch, got %s"
                         % (tuple(x.shape),))
    if _on_cpu(x):
        return tile_norms_plain(x, norm)
    dt = _tile_dt("tile_norms", x)
    nt, mb, nb = x.shape
    out = torch.empty(nt, dtype=x.dtype, device=x.device)
    _launch("tile_norms", x.device, x.data_ptr(), out.data_ptr(), nt,
            mb * nb, int(norm != "max"), dt=dt)
    return out


def _tz_plain(a, lower: bool, offdiag, diag, op: str):
    m, n = a.shape
    i = torch.arange(m, device=a.device)[:, None]
    j = torch.arange(n, device=a.device)[None, :]
    in_tri = (i >= j) if lower else (i <= j)
    on_diag = i == j
    off = torch.tensor(offdiag, dtype=a.dtype, device=a.device)
    dg = torch.tensor(diag, dtype=a.dtype, device=a.device)
    if op == "set":
        return torch.where(on_diag, dg, torch.where(in_tri, off, a))
    return torch.where(in_tri & ~on_diag, a * off,
                       torch.where(on_diag, a * dg, a))


def tzset_plain(a, lower: bool, offdiag_value, diag_value):
    """Plain version of :func:`tzset`."""
    return _tz_plain(a, lower, offdiag_value, diag_value, "set")


def tzscale_plain(a, lower: bool, offdiag_factor, diag_factor):
    """Plain version of :func:`tzscale`."""
    return _tz_plain(a, lower, offdiag_factor, diag_factor, "scale")


def _tz(name: str, a, lower, offdiag, diag, op: str, bm: int, bn: int):
    m, n = _check_tiles(name, a, bm, bn)
    if _on_cpu(a):
        return _tz_plain(a, lower, offdiag, diag, op)
    dt = _tile_dt(name, a)
    out = torch.empty_like(a)
    _launch("tz", a.device, a.data_ptr(), out.data_ptr(), m, n, int(lower),
            int(op == "scale"), float(offdiag), float(diag), dt=dt,
            counter=name)
    return out


def tzset(a, lower: bool, offdiag_value, diag_value, bm: int = 256,
          bn: int = 256):
    """A copy of ``a`` with its stored triangle (``lower``: i ≥ j, else
    i ≤ j) set to ``offdiag_value`` and its diagonal to ``diag_value``;
    the other triangle is kept (unlike ``tile_ops.tzset``, which zeroes
    it)."""
    return _tz("tzset", a, lower, offdiag_value, diag_value, "set", bm, bn)


def tzscale(a, lower: bool, offdiag_factor, diag_factor, bm: int = 256,
            bn: int = 256):
    """A copy of ``a`` with its strict stored triangle scaled by
    ``offdiag_factor`` and its diagonal by ``diag_factor``; the other
    triangle is kept."""
    return _tz("tzscale", a, lower, offdiag_factor, diag_factor, "scale",
               bm, bn)


def geadd_plain(alpha, a, beta, b):
    """Plain version of :func:`geadd`: each product rounded, then the
    sum, in B's dtype."""
    al = torch.tensor(alpha, dtype=a.dtype, device=a.device)
    be = torch.tensor(beta, dtype=b.dtype, device=b.device)
    return (al * a + be * b).to(b.dtype)


def geadd(alpha, a, beta, b, bm: int = 256, bn: int = 256):
    """α·A + β·B in B's dtype (out of place).  B is read even where β = 0,
    so a NaN or Inf in B stays in the result."""
    m, n = _check_tiles("geadd", a, bm, bn)
    if tuple(b.shape) != (m, n):
        raise ValueError("geadd: shapes differ: %s, %s"
                         % (tuple(a.shape), tuple(b.shape)))
    if _on_cpu(a, b):
        return geadd_plain(alpha, a, beta, b)
    dt = _tile_dt("geadd", a, b)
    out = torch.empty_like(b)
    _launch("geadd", a.device, float(alpha), a.data_ptr(), float(beta),
            b.data_ptr(), out.data_ptr(), m, n, dt=dt)
    return out


def gescale_row_col_plain(r, c, a):
    """Plain version of :func:`gescale_row_col`: (r[i]·A[i, j])·c[j]."""
    return (r[:, None] * a * c[None, :]).to(a.dtype)


def gescale_row_col(r, c, a, bm: int = 256, bn: int = 256):
    """diag(r)·A·diag(c) (out of place), r of length m, c of length n."""
    m, n = _check_tiles("gescale_row_col", a, bm, bn)
    if tuple(r.shape) != (m,) or tuple(c.shape) != (n,):
        raise ValueError("gescale_row_col: r %s and c %s do not fit A %s"
                         % (tuple(r.shape), tuple(c.shape), (m, n)))
    if _on_cpu(r, c, a):
        return gescale_row_col_plain(r, c, a)
    dt = _tile_dt("gescale_row_col", r, c, a)
    out = torch.empty_like(a)
    _launch("gescale_row_col", a.device, r.data_ptr(), c.data_ptr(),
            a.data_ptr(), out.data_ptr(), m, n, dt=dt)
    return out


# ---------------------------------------------------------------------------
# split_matmul: the slice-pair products of the bf16x3 / bf16x6 split gemm
# (replaces the XLA dots of slate_tpu/ops/split_gemm.py matmul_sliced3/6,
# not a Pallas kernel)
# ---------------------------------------------------------------------------

#: the split_matmul kernel's output tile rows by grade, and its columns
#: (csrc/split_matmul.cu Grade<G>::BM, BN); its K slab is MATMUL_SLAB
SPLIT_TILE_M = {"split3": 128, "split6": 64}
SPLIT_TILE_N = 128

def _check_split(sa, sb, grade: str):
    """The planes a grade reads (two of each operand for split3, three for
    split6) and ``(m, k, n)``; raises on anything else."""
    if grade not in SPLIT_TILE_M:
        raise ValueError("split_matmul grade must be split3 or split6, got %r"
                         % (grade,))
    need = 2 if grade == "split3" else 3
    if len(sa) < need or len(sb) < need:
        raise ValueError("split_matmul %s reads %d planes of each operand"
                         % (grade, need))
    sa, sb = tuple(sa[:need]), tuple(sb[:need])
    for t in sa + sb:
        if t.dtype != torch.bfloat16 or t.ndim != 2:
            raise ValueError("split_matmul takes 2-D bfloat16 planes, got %s %s"
                             % (t.dtype, tuple(t.shape)))
    m, k = sa[0].shape
    k2, n = sb[0].shape
    if any(t.shape != sa[0].shape for t in sa) or \
            any(t.shape != sb[0].shape for t in sb) or k != k2:
        raise ValueError("split_matmul: planes of %s · %s"
                         % ([tuple(t.shape) for t in sa],
                            [tuple(t.shape) for t in sb]))
    return sa, sb, m, k, n


def split_matmul_plain(sa, sb, grade: str = "split3"):
    """Plain version of :func:`split_matmul`: K-folded ``torch.cat`` of the
    planes as fp32, then one fp32 ``torch.matmul`` a diagonal (the
    products of bf16 slices are exact in fp32), as the JAX package's
    ``matmul_sliced3`` / ``matmul_sliced6`` fold them."""
    sa, sb, _, _, _ = _check_split(sa, sb, grade)

    def fold(xs, ys):
        return (torch.cat(xs, dim=1).to(torch.float32)
                @ torch.cat(ys, dim=0).to(torch.float32))

    if grade == "split6":
        d2 = fold(sa, sb[::-1])
        d1 = fold(sa[:2], (sb[1], sb[0]))
        d0 = sa[0].to(torch.float32) @ sb[0].to(torch.float32)
        return (d2 + d1) + d0
    return fold((sa[0], sa[0], sa[1]), (sb[0], sb[1], sb[0]))


def _one_layout(planes):
    """The planes with one set of strides, one of them unit (each plane
    copied contiguous otherwise)."""
    st = planes[0].stride()
    if 1 in st and all(p.stride() == st for p in planes):
        return planes
    return tuple(p.contiguous() for p in planes)


def split_matmul_staging(sa, sb, grade: str) -> str:
    """``"async"`` where the kernel copies these CUDA planes by cp.async,
    ``"registers"`` where it stages them through registers."""
    fn = _fns.get("split_matmul_staging")
    if fn is None:
        from . import _build

        fn = _build.library("split_matmul").slate_split_matmul_staging
        fn.argtypes = [_P] * 3 + [_I64] * 2 + [_P] * 3 + [_I64] * 2 + [_I]
        fn.restype = _I
        _fns["split_matmul_staging"] = fn
    pa = [t.data_ptr() for t in sa] + [None] * (3 - len(sa))
    pb = [t.data_ptr() for t in sb] + [None] * (3 - len(sb))
    regs = fn(*pa, sa[0].stride(0), sa[0].stride(1), *pb, sb[0].stride(0),
              sb[0].stride(1), 6 if grade == "split6" else 3)
    return "registers" if regs else "async"


def split_matmul(sa, sb, grade: str = "split3"):
    """fp32 ``C = Σ pairs sᵢ(A)·sⱼ(B)`` from bf16 slice planes
    (:func:`slate_tpu_torch.ops.split_gemm.split_slices`): ``sa`` the
    (m, k) planes of A, ``sb`` the (k, n) planes of B (a transposed view
    is read where it lies), ``grade`` ``"split3"`` (the pairs (0,0),
    (0,1), (1,0) in one accumulator) or ``"split6"`` (the diagonals
    i + j ≤ 2, ``(d2 + d1) + d0``).  Any m, k, n.  One launch counted per
    call, whether K is split or not."""
    sa, sb, m, k, n = _check_split(sa, sb, grade)
    if _on_cpu(*sa, *sb):
        return split_matmul_plain(sa, sb, grade)
    dev = sa[0].device
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=torch.float32, device=dev)
    sa, sb = _one_layout(sa), _one_layout(sb)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = matmul_splits(m, n, k, sms, SPLIT_TILE_M[grade], SPLIT_TILE_N)
    c = torch.empty((m, n), dtype=torch.float32, device=dev)
    w = (torch.empty((splits, m, n), dtype=torch.float32, device=dev)
         if splits > 1 else None)
    pa = [t.data_ptr() for t in sa] + [None] * (3 - len(sa))
    pb = [t.data_ptr() for t in sb] + [None] * (3 - len(sb))
    _launch("split_matmul", dev, *pa, sa[0].stride(0), sa[0].stride(1),
            *pb, sb[0].stride(0), sb[0].stride(1), c.data_ptr(), m, n, k,
            None if w is None else w.data_ptr(), splits,
            matmul_part_slabs(k, splits), 6 if grade == "split6" else 3)
    return c


# ---------------------------------------------------------------------------
# ozaki_matmul: the int8 pair products and fp64 combine of the Ozaki fp64
# gemm (replaces the XLA dots and combine of slate_tpu/ops/ozaki.py
# _chunk_matmul, not a Pallas kernel)
# ---------------------------------------------------------------------------

#: the ozaki_matmul kernel's output tile (csrc/ozaki_matmul.cu BM, BN)
OZAKI_TILE = 64


def _check_ozaki(ua, vb, ea, eb):
    if ua.dtype != torch.int8 or vb.dtype != torch.int8 or ua.ndim != 3 \
            or vb.ndim != 3:
        raise ValueError("ozaki_matmul takes 3-D int8 planes, got %s %s, %s %s"
                         % (ua.dtype, tuple(ua.shape), vb.dtype,
                            tuple(vb.shape)))
    nsl, m, kp = ua.shape
    if vb.shape[0] != nsl or vb.shape[2] != kp or not 1 <= nsl <= 9 \
            or kp % 32:
        raise ValueError("ozaki_matmul: planes %s and %s (same slices 1-9, "
                         "the same K, a multiple of 32)"
                         % (tuple(ua.shape), tuple(vb.shape)))
    kmax = 1 << (31 - 12 - max(1, (nsl - 1).bit_length()))
    if kp > kmax:
        raise ValueError("ozaki_matmul: K = %d passes %d, past which an int32 "
                         "diagonal sum may overflow" % (kp, kmax))
    n = vb.shape[1]
    if ea.dtype != torch.float64 or eb.dtype != torch.float64 \
            or tuple(ea.shape) != (m,) or tuple(eb.shape) != (n,):
        raise ValueError("ozaki_matmul: exponents %s %s, %s %s for (%d, %d)"
                         % (ea.dtype, tuple(ea.shape), eb.dtype,
                            tuple(eb.shape), m, n))
    return nsl, m, n, kp


def ozaki_matmul_plain(ua, vb, ea, eb):
    """Plain version of :func:`ozaki_matmul`: each diagonal's pair sums as
    fp64 ``torch.matmul`` of the integer-valued planes (exact: every
    partial sum is an integer below 2⁵³), combined in ascending order and
    rescaled in the kernel's order of operations."""
    nsl, m, n, kp = _check_ozaki(ua, vb, ea, eb)
    a64, b64 = ua.to(torch.float64), vb.to(torch.float64)
    acc = None
    for tot in range(nsl):
        g = None
        for t in range(tot + 1):
            p = a64[t] @ b64[tot - t].T
            g = p if g is None else g + p
        scaled = g * (2.0 ** (-6 * (tot + 2)))
        acc = scaled if acc is None else acc + scaled
    e = ea[:, None] + eb[None, :]
    e1 = torch.trunc(e * 0.5)
    return acc * torch.exp2(e1) * torch.exp2(e - e1)


def ozaki_matmul(ua, vb, ea, eb):
    """fp64 ``C`` from the int8 slice planes of the row-scaled A (``ua``,
    (nsl, m, kp), K fast) and of the column-scaled B laid K-major (``vb``,
    (nsl, n, kp)) with their exponents ``ea`` (m) and ``eb`` (n): the
    diagonals t + s = tot of the pair products summed exactly in int32,
    combined in fp64 with weights 2^(−6(tot+2)) in ascending order, then
    scaled by 2^(ea[i] + eb[j]) (:mod:`slate_tpu_torch.ops.ozaki`).  kp a
    multiple of 32 within the exact-sum bound; 1 ≤ nsl ≤ 9.  Bitwise
    :func:`ozaki_matmul_plain` on the same inputs."""
    nsl, m, n, kp = _check_ozaki(ua, vb, ea, eb)
    if _on_cpu(ua, vb, ea, eb):
        return ozaki_matmul_plain(ua, vb, ea, eb)
    dev = ua.device
    if m == 0 or n == 0:
        return torch.zeros((m, n), dtype=torch.float64, device=dev)
    ua, vb, ea, eb = (t.contiguous() for t in (ua, vb, ea, eb))
    c = torch.empty((m, n), dtype=torch.float64, device=dev)
    _launch("ozaki_matmul", dev, ua.data_ptr(), vb.data_ptr(), ea.data_ptr(),
            eb.data_ptr(), c.data_ptr(), m, n, kp, nsl)
    return c
