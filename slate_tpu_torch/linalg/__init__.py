"""Drivers of the port (the slices ported so far)."""

from .band import (  # noqa: F401
    gbmm, gbsv, gbtrf, gbtrs, hbmm, pbsv, pbtrf, pbtrs, tbsm,
)
from .batched import (  # noqa: F401
    gels_batched, geqrf_batched, gesv_batched, getrf_batched, getrs_batched,
    heev_batched, posv_batched, potrf_batched, potrs_batched,
)
from .blas3 import (  # noqa: F401
    gemm, gemmA, gemmC, hemm, hemmA, hemmC, her2k, herk, symm, syr2k, syrk,
    trmm, trsm, trsmA, trsmB,
)
from .cholesky import (  # noqa: F401
    posv, posvMixed, posv_mixed, posv_mixed_gmres, potrf, potri, potrs,
    trtri, trtrm,
)
from .condest import (  # noqa: F401
    gecondest, norm1est, pocondest, refine_kappa_eps, spectral_interval,
    trcondest,
)
from .eig import (  # noqa: F401
    hb2st, he2hb, heev, heev_vals, hegst, hegv, stedc, stemr, steqr, sterf,
    syev, sygst, sygv, unmtr_hb2st, unmtr_he2hb,
)
from .hesv import hesv, hetrf, hetrs, sysv, sytrf, sytrs  # noqa: F401
from .lu import (  # noqa: F401
    gesv, gesvMixed, gesv_mixed, gesv_mixed_gmres, gesv_nopiv, getrf,
    getrf_nopiv, getrf_tntpiv, getri, getrs, getrs_nopiv,
)
from .norms import (  # noqa: F401
    col_norms, gbnorm, genorm, hbnorm, henorm, norm, synorm, trnorm,
)
from .polar import heev_qdwh, polar, svd_qdwh  # noqa: F401
from .qr import (  # noqa: F401
    cholqr, gelqf, gels, gels_cholqr, gels_mixed, gels_qr, geqrf, ungqr,
    unmlq, unmqr,
)
from .svd import (  # noqa: F401
    bdsqr, ge2tb, gesvd, svd, svd_vals, tb2bd, unmbr_ge2tb, unmbr_tb2bd,
)
from .util import add, copy, scale, scale_row_col, set  # noqa: F401
from ._stedc import (  # noqa: F401
    stedc_deflate, stedc_merge, stedc_secular, stedc_solve, stedc_sort,
    stedc_z_vector,
)

__all__ = ["gemm", "gemmA", "gemmC", "hemm", "hemmA", "hemmC", "her2k",
           "herk", "symm", "syr2k", "syrk", "trmm", "trsm", "trsmA", "trsmB",
           "posv", "posvMixed", "posv_mixed", "posv_mixed_gmres", "potrf",
           "potri", "potrs", "trtri", "trtrm",
           "gesv", "gesvMixed", "gesv_mixed", "gesv_mixed_gmres",
           "gesv_nopiv", "getrf", "getrf_nopiv", "getrf_tntpiv", "getri",
           "getrs", "getrs_nopiv",
           "hesv", "hetrf", "hetrs", "sysv", "sytrf", "sytrs",
           "heev_qdwh", "polar", "svd_qdwh",
           "cholqr", "gelqf", "gels", "gels_cholqr", "gels_mixed", "gels_qr",
           "geqrf", "ungqr", "unmlq", "unmqr",
           "hb2st", "he2hb", "heev", "heev_vals", "hegst", "hegv", "stedc",
           "stemr", "steqr", "sterf", "syev", "sygst", "sygv", "unmtr_hb2st",
           "unmtr_he2hb",
           "stedc_deflate", "stedc_merge", "stedc_secular", "stedc_solve",
           "stedc_sort", "stedc_z_vector",
           "bdsqr", "ge2tb", "gesvd", "svd", "svd_vals", "tb2bd",
           "unmbr_ge2tb", "unmbr_tb2bd",
           "gels_batched", "geqrf_batched", "gesv_batched", "getrf_batched",
           "getrs_batched", "heev_batched", "posv_batched", "potrf_batched",
           "potrs_batched",
           "col_norms", "gbnorm", "genorm", "hbnorm", "henorm", "norm",
           "synorm", "trnorm",
           "add", "copy", "scale", "scale_row_col", "set",
           "gecondest", "norm1est", "pocondest", "refine_kappa_eps",
           "spectral_interval", "trcondest",
           "gbmm", "gbsv", "gbtrf", "gbtrs", "hbmm", "pbsv", "pbtrf", "pbtrs",
           "tbsm"]
