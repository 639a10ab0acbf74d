"""Split-precision fp32 products (bf16x3 / bf16x6) — the counterpart of
``slate_tpu/ops/split_gemm.py``.

Each fp32 operand splits into three bf16 mantissa slices at their
natural scale (bf16 shares fp32's exponent, so no scaling is needed)::

    s0 = bf16(x);  r1 = x − f32(s0)
    s1 = bf16(r1); r2 = r1 − f32(s1)
    s2 = bf16(r2)

Every slice carries ≤ 8 mantissa bits, so a product sᵢ(a)·sⱼ(b) is exact
in fp32 and only the K-direction accumulation rounds.  The split itself
is an elementwise pass in plain PyTorch, as it is an XLA elementwise pass
in the JAX package; the slice-pair products run in the ``split_matmul``
kernel (``csrc/split_matmul.cu``: bf16 ``mma.sync`` into fp32
accumulators) on the card and in its plain version
(:func:`slate_tpu_torch.ops.kernels.split_matmul_plain`) on the CPU.

* **bf16x3** (:func:`matmul_split3`): the three dominant pairs
  s₀a·s₀b + s₀a·s₁b + s₁a·s₀b in one fp32 accumulator, ≈ (2⁷ + 3k)·ε₃₂
  componentwise — the pairs left out (s₁s₁, s₀s₂, s₂s₀) are each
  ≤ 2⁻¹⁶·|a||b|.
* **bf16x6** (:func:`matmul_split6`): the three slice-pair diagonals
  i + j ≤ 2 in three accumulators, summed smallest first,
  ``(d2 + d1) + d0``: ≈ 3k·ε₃₂ componentwise.

Real fp32 2-D operands only (the ``TypeError`` / ``ValueError`` guards of
the JAX package).  Non-finite inputs give NaN or garbage, as there.  The
selection is the ``matmul`` site (:func:`slate_tpu_torch.perf.autotune.
choose_matmul`, ``SLATE_TPU_TORCH_SPLIT_GEMM``).
"""

from __future__ import annotations

import torch

from . import kernels

#: bf16 mantissa slices per fp32 operand — 3×8 explicit bits cover the
#: 24-bit fp32 significand
NSLICES = 3


def _guard(a, b) -> None:
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(
            "split gemm is 2-D only (the blocked drivers' tile and "
            f"trailing-update products); got {a.ndim}-D @ {b.ndim}-D")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(
            "split gemm wants float32 operands (bf16x3 slices share "
            f"fp32's exponent range); got {a.dtype} @ {b.dtype}")


def split_slices(x):
    """The three bf16 mantissa slices of fp32 ``x`` (elementwise, any
    shape, the strides of ``x`` kept), with ``s0 + s1 + s2 == x`` to
    ~2⁻²⁵ relative.  The split commutes with slicing, so a panel split
    once feeds every strip product through windows of its slices."""
    s = []
    r = x
    for _ in range(NSLICES):
        si = r.to(torch.bfloat16)
        s.append(si)
        r = r - si.to(torch.float32)
    return tuple(s)


def matmul_sliced3(sa, sb):
    """bf16x3 product from pre-split operands: ``sa`` the lhs slices
    (each (m, k)), ``sb`` the rhs slices (each (k, n), a transposed view
    welcome): s₀a·s₀b + s₀a·s₁b + s₁a·s₀b in one fp32 accumulator."""
    return kernels.split_matmul(sa, sb, "split3")


def matmul_sliced6(sa, sb):
    """bf16x6 product from pre-split operands: the diagonals i + j ≤ 2
    in separate fp32 accumulators, returned as ``(d2 + d1) + d0``."""
    return kernels.split_matmul(sa, sb, "split6")


def matmul_sliced(backend: str, sa, sb):
    """A pre-split product by ``matmul`` site backend name (``"split3"``
    or ``"split6"``)."""
    if backend == "split6":
        return matmul_sliced6(sa, sb)
    return matmul_sliced3(sa, sb)


def matmul_split3(a, b):
    """fp32 ``a @ b`` through the bf16x3 split: ≈ (2⁷ + 3k)·ε₃₂
    componentwise at three bf16 passes."""
    _guard(a, b)
    return matmul_sliced3(split_slices(a), split_slices(b))


def matmul_split6(a, b):
    """fp32 ``a @ b`` through the bf16x6 split: ≈ 3k·ε₃₂ componentwise at
    six bf16 passes."""
    _guard(a, b)
    return matmul_sliced6(split_slices(a), split_slices(b))
