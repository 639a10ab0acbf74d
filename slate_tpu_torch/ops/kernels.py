"""The hand-written CUDA kernels — the counterpart of
``slate_tpu/ops/pallas_kernels.py`` for the kernels ported so far.

Each kernel has three things here:

* a wrapper (:func:`matmul`, :func:`chol_inv_panel`, :func:`trtri_panel`)
  that checks device, dtype, shape and strides, allocates its outputs and
  scratch with ``torch.empty``, launches the kernel on the current CUDA
  stream and raises if the launch fails.  Given CPU tensors it runs the
  plain version instead — only because the tensors are on the CPU; on a
  CUDA tensor it launches the kernel or raises;
* a plain PyTorch version (``*_plain``) of the same blocked algorithm,
  which the CPU tests use and ``chip_smoke.py`` holds the kernel against;
* a launch count in :data:`launches`, raised by one where the wrapper
  launches the kernel and nowhere else.

The sources are ``slate_tpu_torch/csrc/*.cu``, built by
:mod:`slate_tpu_torch.ops._build`.
"""

from __future__ import annotations

import ctypes

import torch

#: kernel name -> launches since the last :func:`reset_launches`
launches = {"matmul": 0, "chol_inv_panel": 0, "trtri_panel": 0}

IB = 32

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "matmul": ("slate_matmul_f32",
               [_P, _I64, _I64, _P, _I64, _I64, _P, _I, _I, _I, _P]),
    "chol_inv_panel": ("slate_chol_inv_panel_f32",
                       [_P, _I64, _P, _P, _P, _I, _P]),
    "trtri_panel": ("slate_trtri_panel_f32", [_P, _I64, _P, _P, _I, _P]),
}
_fns: dict = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        from . import _build

        sym, argtypes = _SIGNATURES[name]
        fn = getattr(_build.library(name), sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _launch(name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _fn(name)(*args, stream)
    if rc != 0:
        raise RuntimeError("%s kernel launch failed: CUDA error %d"
                           % (name, rc))
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


def matmul(a, b):
    """C = A·B, fp32 in and out.  M and N must be multiples of 128, K of
    16.  ``a`` and ``b`` may be strided views (a transposed view needs no
    copy); the output is a new contiguous tensor."""
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
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    _launch("matmul", a.device, a.data_ptr(), a.stride(0), a.stride(1),
            b.data_ptr(), b.stride(0), b.stride(1), c.data_ptr(), m, n, k)
    return c


# ---------------------------------------------------------------------------
# Panel kernels (replace pallas_kernels.chol_inv_panel :395 and
# trtri_panel :571)
# ---------------------------------------------------------------------------

def _chol_unblocked(blk):
    """Right-looking unblocked Cholesky of the lower triangle of an
    (ib, ib) block (the reference's _chol_unblocked)."""
    a = torch.tril(blk)
    for j in range(a.shape[0]):
        inv = 1.0 / torch.sqrt(a[j, j])
        a[j, j] = a[j, j] * inv
        a[j + 1:, j] *= inv
        v = a[j + 1:, j]
        a[j + 1:, j + 1:] -= torch.outer(v, v)
    return torch.tril(a)


def _trtri_unblocked(l):
    """Row-by-row forward substitution: inverse of a lower non-unit
    (ib, ib) block (the reference's _trtri_unblocked)."""
    ib = l.shape[0]
    x = torch.zeros_like(l)
    eye = torch.eye(ib, dtype=l.dtype, device=l.device)
    for i in range(ib):
        x[i] = (eye[i] - l[i, :i] @ x[:i]) / l[i, i]
    return x


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
    for k0 in range(0, nb, ib):
        blk = _chol_unblocked(l[k0:k0 + ib, k0:k0 + ib])
        l[k0:k0 + ib, k0:k0 + ib] = blk
        binv = _trtri_unblocked(blk)
        inv[k0:k0 + ib, k0:k0 + ib] = binv
        if k0 + ib < nb:
            l21 = l[k0 + ib:, k0:k0 + ib] @ binv.T
            l[k0 + ib:, k0:k0 + ib] = l21
            l[k0 + ib:, k0 + ib:] -= l21 @ l21.T
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
    work = torch.empty(max((nb // 2) ** 2, nb * IB), dtype=torch.float32,
                       device=a.device)
    _launch("chol_inv_panel", a.device, a.data_ptr(), a.stride(0),
            l.data_ptr(), linv.data_ptr(), work.data_ptr(), nb)
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
    _launch("trtri_panel", l.device, l.data_ptr(), l.stride(0),
            linv.data_ptr(), work.data_ptr(), nb)
    return linv
