"""Distributed execution over ``torch.distributed`` — the counterpart of
``slate_tpu/parallel``.

The JAX package runs its SPMD drivers under ``shard_map``, one program
per device of a ``('p', 'q')`` mesh; here one process runs per grid
position (:func:`.launch.run_spmd`, or a ``torch.distributed`` world the
caller initialized) and every rank calls the same driver on its own
shard.  The block-cyclic layout, the drivers' step loops and their site
decisions are the JAX package's.  With no process group a 1×1 grid is
the serial stub (:func:`make_grid_mesh`).

Ported: ``make_grid_mesh``, ``DistMatrix``, ``distribute``,
``undistribute``, ``pgemm`` (SUMMA and the A-stationary ``pgemm_a``),
``ppotrf``/``ppotrs``/``pposv``, ``pgetrf``/``pgetrs``/``pgesv``, the QR
family ``pgeqrf``/``pgels``/``punmqr_conj``/``pgelqf``/``punmlq``, the
distributed norms, rank-k updates, multiplies and triangular solves of
``dist_aux``, the layout moves ``peye``/``ptranspose``/
``predistribute``/``phermitize``, and the two-stage eigensolver and SVD
``phe2hb``/``pge2tb``/``pheev``/``psvd`` with their back-transforms
``punmtr_he2hb``/``punmbr_ge2tb_q``/``punmbr_ge2tb_p`` and band gathers
``band_tiles_to_dense``/``band_tiles_to_banded`` (the distributed middle
in :mod:`.dist_stedc` and :mod:`.dist_svd`), the band solvers and
multiplies ``ppbsv``/``pgbsv``/``pgbmm``/``phbmm``/``ptbsm`` (with
``dist_band.ppbtrf``/``pgbtrf``), the Hermitian-indefinite
``phetrf``/``phetrs``/``phesv``, the QDWH tier
``ppolar``/``pheev_qdwh``/``psvd_qdwh``, and the mixed-precision
drivers ``pposv_mixed``/``pposv_mixed_gmres``/``pgesv_mixed`` with
``pgetri`` and ``pgecondest``.  ``pgetrf``/``ppotrf`` also run under the
resilience layer: step checkpoints (``SLATE_TPU_TORCH_CKPT_EVERY_STEPS``,
pgetrf), the measured step timeline (``SLATE_TPU_TORCH_DIST_TIMELINE``)
and the ABFT envelope (``SLATE_TPU_TORCH_ABFT``).
"""

from .mesh import (default_mesh, grid_of, make_grid_mesh,  # noqa: F401
                   mesh_grid_shape)
from .dist import DistMatrix, distribute, undistribute  # noqa: F401
from .dist_blas3 import pgemm, pgemm_a, pgemm_auto  # noqa: F401
from .dist_factor import (ppotrf, ppotrs, pposv,  # noqa: F401
                          pposv_mixed, pposv_mixed_gmres)
from .dist_lu import (pgecondest, pgesv, pgesv_mixed,  # noqa: F401
                      pgetrf, pgetri, pgetrs)
from .dist_qr import pgeqrf, pgels, punmqr_conj  # noqa: F401
from .dist_aux import (  # noqa: F401
    pcolnorms, phemm, pher2k, pherk, pnorm, psymm, psyr2k, psyrk,
    ptri_mask, ptrmm, ptrsm,
)
from .dist_util import (peye, phermitize, predistribute,  # noqa: F401
                        ptranspose)
from .dist_qr import pgelqf, punmlq  # noqa: F401
from .dist_twostage import (  # noqa: F401
    band_tiles_to_banded, band_tiles_to_dense, pge2tb, phe2hb, pheev, psvd,
    punmbr_ge2tb_p, punmbr_ge2tb_q, punmtr_he2hb,
)
from .dist_qdwh import pheev_qdwh, ppolar, psvd_qdwh  # noqa: F401
from .dist_band import pgbmm, pgbsv, phbmm, ppbsv, ptbsm  # noqa: F401
from .dist_hesv import phesv, phetrf, phetrs  # noqa: F401

# ---------------------------------------------------------------------------
# User-tile-map ingestion: every public driver re-grids a DistMatrix
# distributed with a custom row_map/col_map to the canonical block-cyclic
# layout on entry (dist.canonical_args), rebound in the defining modules
# too so direct submodule imports are covered (as the JAX package does,
# slate_tpu/parallel/__init__.py:40-76).
# ---------------------------------------------------------------------------
from . import (dist_aux as _m_aux, dist_band as _m_band,  # noqa: E402
               dist_blas3 as _m_blas3, dist_factor as _m_factor,
               dist_hesv as _m_hesv, dist_lu as _m_lu,
               dist_qdwh as _m_qdwh, dist_qr as _m_qr,
               dist_twostage as _m_two, dist_util as _m_util)
from .dist import canonical_args as _canonical_args  # noqa: E402

_DRIVER_NAMES = {
    _m_blas3: ["pgemm", "pgemm_a"],
    _m_factor: ["ppotrf", "ppotrs", "pposv", "pposv_mixed",
                "pposv_mixed_gmres"],
    _m_lu: ["pgetrf", "pgetrs", "pgesv", "pgesv_mixed", "pgetri",
            "pgecondest"],
    _m_qr: ["pgeqrf", "pgels", "pgelqf", "punmqr_conj", "punmlq"],
    _m_aux: ["pcolnorms", "phemm", "pher2k", "pherk", "pnorm", "psymm",
             "psyr2k", "psyrk", "ptri_mask", "ptrmm", "ptrsm"],
    _m_util: ["predistribute", "ptranspose", "phermitize"],
    _m_band: ["pgbsv", "ppbsv", "pgbmm", "phbmm", "ptbsm", "ppbtrf",
              "pgbtrf"],
    _m_hesv: ["phetrf", "phetrs", "phesv"],
    _m_two: ["phe2hb", "pge2tb", "pheev", "psvd", "punmbr_ge2tb_p",
             "punmbr_ge2tb_q", "punmtr_he2hb"],
    _m_qdwh: ["pheev_qdwh", "ppolar", "psvd_qdwh"],
}
for _mod, _names in _DRIVER_NAMES.items():
    for _nm in _names:
        _f = getattr(_mod, _nm)
        if not hasattr(_f, "__wrapped_driver__"):
            _wrapped = _canonical_args(_f)
            setattr(_mod, _nm, _wrapped)
            if _nm in globals():
                globals()[_nm] = _wrapped
del _mod, _names, _nm, _f
