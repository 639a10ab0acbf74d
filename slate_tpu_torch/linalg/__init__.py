"""Drivers of the port (the slice ported so far)."""

from .batched import (  # noqa: F401
    gels_batched, geqrf_batched, gesv_batched, getrf_batched, getrs_batched,
    heev_batched, posv_batched, potrf_batched, potrs_batched,
)
from .blas3 import gemm, herk, syrk, trmm, trsm  # noqa: F401
from .cholesky import posv, potrf, potri, potrs, trtri, trtrm  # noqa: F401
from .eig import (  # noqa: F401
    he2hb, heev, heev_vals, hegst, hegv, syev, sygst, sygv, unmtr_he2hb,
)
from .lu import (  # noqa: F401
    gesv, gesv_nopiv, getrf, getrf_nopiv, getri, getrs, getrs_nopiv,
)
from .qr import (  # noqa: F401
    cholqr, gelqf, gels, gels_cholqr, gels_qr, geqrf, ungqr, unmlq, unmqr,
)
from .svd import (  # noqa: F401
    bdsqr, ge2tb, gesvd, svd, svd_vals, tb2bd, unmbr_ge2tb, unmbr_tb2bd,
)

__all__ = ["gemm", "herk", "syrk", "trmm", "trsm",
           "posv", "potrf", "potri", "potrs", "trtri", "trtrm",
           "gesv", "gesv_nopiv", "getrf", "getrf_nopiv", "getri", "getrs",
           "getrs_nopiv",
           "cholqr", "gelqf", "gels", "gels_cholqr", "gels_qr", "geqrf",
           "ungqr", "unmlq", "unmqr",
           "he2hb", "heev", "heev_vals", "hegst", "hegv", "syev", "sygst",
           "sygv", "unmtr_he2hb",
           "bdsqr", "ge2tb", "gesvd", "svd", "svd_vals", "tb2bd",
           "unmbr_ge2tb", "unmbr_tb2bd",
           "gels_batched", "geqrf_batched", "gesv_batched", "getrf_batched",
           "getrs_batched", "heev_batched", "posv_batched", "potrf_batched",
           "potrs_batched"]
