"""Drivers of the port (the slice ported so far)."""

from .blas3 import gemm, herk, syrk, trmm, trsm  # noqa: F401
from .cholesky import posv, potrf, potri, potrs, trtri, trtrm  # noqa: F401

__all__ = ["gemm", "herk", "syrk", "trmm", "trsm",
           "posv", "potrf", "potri", "potrs", "trtri", "trtrm"]
