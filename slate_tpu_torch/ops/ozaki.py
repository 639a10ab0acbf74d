"""Ozaki-style fp64 products from int8 slices — the counterpart of
``slate_tpu/ops/ozaki.py``.

1. Row-scale A (column-scale B) by the power of two that brings each
   row's (column's) largest magnitude into [1/4, 1) (:func:`_pow2_scale`,
   :func:`_mul_pow2`, both exact).
2. Slice the scaled operand into ``_W = 6``-bit windows: slice t holds
   bits [6t, 6(t + 1)) as an integer in [−64, 64] (:func:`_split_int8`,
   four windows on each fp32 image of the fp64 remainder; the f32 image's
   rounding spills ±1 into a group's last window and the fp64 remainder
   takes it back, so nothing is lost).
3. For each slice pair with t + s ≤ ``_SMAX`` an int8 product summed in
   int32, exact: every pair of one diagonal t + s is summed in ONE int32
   accumulator, which ``_KMAX`` keeps below 2³¹.
4. Combine the diagonals in fp64 in ascending order, each scaled by
   2^(−6(tot + 2)), and undo the row/column scaling.

The scaling and the split are elementwise passes in plain PyTorch, as
they are XLA passes in the JAX package; steps 3 and 4 run in the
``ozaki_matmul`` kernel (``csrc/ozaki_matmul.cu``: int8 ``mma.sync`` into
int32, then the fp64 combine and the rescale) on the card and in its
plain version (:func:`slate_tpu_torch.ops.kernels.ozaki_matmul_plain`,
fp64 products of the integer-valued slices, exact) on the CPU.  The
contraction is cut into chunks of at most ``_KMAX`` whose results are
summed in fp64 (:func:`matmul_f64`).

Error: exact up to the dropped pairs t + s > ``_SMAX``, ≈ k·2⁻⁴⁸ relative
to the row and column scales.  Real fp64 2-D only; non-finite inputs give
garbage, as there.  On an H100 the 36 int8 pair products of the default
8 slices are worth ~55 TFLOP/s of fp64 at the int8 peak, under cuBLAS
DGEMM's 67 on the fp64 tensor cores, so the ``matmul`` site keeps DGEMM
unless ``SLATE_TPU_TORCH_F64_MXU=1`` or a pin asks for ``ozaki``.
"""

from __future__ import annotations

import os

import torch

from . import kernels

_W = 6                        # mantissa bits per slice
# 8 slices · 6 bits = 48 bits + the pair tail ≈ k·ε₆₄-grade; pairs with
# t + s ≤ 7 keep 36 of the 64 products.  SLATE_TPU_TORCH_F64_SLICES=9 buys
# the full 53-bit split (45 pairs).
_NSL = int(os.environ.get("SLATE_TPU_TORCH_F64_SLICES", "8"))
_SMAX = _NSL - 1
# one diagonal sums up to _NSL pair products of k terms ≤ 2^{2W} each, so
# k ≤ 2^{31 − 2W − ceil(log2(_NSL))} keeps |sum| < 2^31 (65536 for 8)
_KMAX = 1 << (31 - 2 * _W - max(1, (_NSL - 1).bit_length()))
#: the kernel's K granule: the slices are zero-padded to a multiple of it
KPAD = 32


def _split_int8(r, nsl: int = _NSL):
    """Slice ``r`` (|r| < 1, fp64) into ``nsl`` 6-bit int8 windows, 4 per
    f32 image of the running remainder.  Every step is a power-of-two
    scale, a truncation, or an exactly representable difference."""
    slices = []
    rem = r
    t = 0
    while t < nsl:
        ngrp = min(4, nsl - t)
        c = rem.to(torch.float32)
        recon = None
        for j in range(ngrp):
            w = _W * (t + j + 1)
            d = torch.trunc(c * (2.0 ** w))
            term = d * (2.0 ** -w)
            c = c - term
            recon = term if recon is None else recon + term
            slices.append(d.to(torch.int8))
        t += ngrp
        if t < nsl:
            rem = rem - recon.to(torch.float64)
    return slices


def _pow2_scale(ax):
    """Integer-valued ``e`` with ``ax · 2^{−e} ∈ [1/4, 1)`` (0 where
    ``ax == 0``): log2 and floor with one-step fixups for the rounding of
    log2 at exact powers of two, tiny magnitudes boosted into the normal
    range first."""
    safe = torch.where(ax > 0, ax, torch.ones_like(ax))
    tiny = safe < 2.0 ** -900
    boosted = torch.where(tiny, safe * 2.0 ** 900, safe)
    e = torch.where(ax > 0,
                    torch.floor(torch.log2(boosted)) + 1.0
                    - torch.where(tiny, 900.0, 0.0), torch.zeros_like(ax))
    r = _mul_pow2(ax, -e)
    e = e + (r >= 1.0).to(e.dtype)        # overshoot: bring max below 1
    e = e - (r < 0.25).to(e.dtype)        # undershoot by a full step
    return e


def _mul_pow2(x, e):
    """``x · 2^e`` for integer-valued fp64 ``e``, exact, the scale split
    into two half-exponent factors: one ``exp2(e)`` is inf or zero for
    |e| ≳ 1024 even where the product is in range."""
    e1 = torch.trunc(e * 0.5)
    return x * torch.exp2(e1) * torch.exp2(e - e1)


def _planes(slices, kp: int):
    """The slices of one operand as one contiguous (nsl, rows, kp) int8
    tensor, K zero-padded to ``kp``."""
    rows, k = slices[0].shape
    out = torch.zeros((len(slices), rows, kp), dtype=torch.int8,
                      device=slices[0].device)
    for t, s in enumerate(slices):
        out[t, :, :k] = s
    return out


def _chunk_matmul(a, b):
    """One chunk of at most ``_KMAX`` contraction: scale, split, then the
    pair products and the combine in ``ozaki_matmul``."""
    ea = _pow2_scale(a.abs().amax(dim=1))
    eb = _pow2_scale(b.abs().amax(dim=0))
    ra = _mul_pow2(a, -ea[:, None])
    rb = _mul_pow2(b, -eb[None, :])
    k = a.shape[1]
    kp = -(-k // KPAD) * KPAD
    # B's slices laid K-major (rows of Bᵀ): the split is elementwise, so
    # the slices of rbᵀ are the transposed slices of rb
    ua = _planes(_split_int8(ra), kp)
    vb = _planes(_split_int8(rb.T), kp)
    return kernels.ozaki_matmul(ua, vb, ea, eb)


def matmul_f64(a, b):
    """``a @ b`` for real fp64 2-D operands through int8 slice products.
    Contractions longer than ``_KMAX`` are cut into even chunks whose
    results are summed in fp64, in order."""
    if a.dtype != torch.float64 or b.dtype != torch.float64:
        raise TypeError("matmul_f64 requires float64 operands")
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError("matmul_f64 is 2-D only")
    k = a.shape[1]
    if k == 0:
        return torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float64,
                           device=a.device)
    nchunks = -(-k // _KMAX)
    bounds = [(k * i) // nchunks for i in range(nchunks + 1)]
    out = None
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        part = _chunk_matmul(a[:, lo:hi], b[lo:hi, :])
        out = part if out is None else out + part
    return out
