"""slate_tpu_torch — the PyTorch/CUDA port of ``slate_tpu`` for one
NVIDIA H100.

Same layout (``ops/``, ``linalg/``, ``perf/``, ``testing/``) and public
names as the JAX package, so each module is held against its namesake;
the Pallas kernels on the ported path are hand-written CUDA kernels
(``csrc/``, :mod:`slate_tpu_torch.ops.kernels`).  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.  The port imports no
JAX and nothing of ``slate_tpu``.

Ported so far: the fp32 single-device Cholesky path — ``gemm``,
``potrf``, ``potrs``, ``posv``, ``trtri``, ``trtrm``, ``potri`` (plus
``herk``/``syrk``, ``trmm``, ``trsm``) — and the fp32 single-device LU
path — ``getrf`` (partial pivot and no pivot), ``getrs``, ``gesv``,
``getri``, ``getrf_nopiv``, ``getrs_nopiv``, ``gesv_nopiv`` — the
batched drivers (``potrf_batched`` … ``heev_batched``) with the serving
queue in front of them (:mod:`slate_tpu_torch.serve`, also ``st.serve``),
and the QR family — ``geqrf``, ``gelqf``, ``unmqr``, ``unmlq``,
``ungqr``, ``cholqr``, ``gels``, ``gels_qr``, ``gels_cholqr`` — and the
two-stage Hermitian eigensolver — ``heev``, ``syev``, ``heev_vals``,
``hegst``/``hegv``, ``sygst``/``sygv`` (with ``he2hb`` and
``unmtr_he2hb``), whose band → tridiagonal chase is one launch of the
``hb2st_wavefront`` kernel on the card and the host chase of
:mod:`slate_tpu_torch.native` elsewhere — and the two-stage SVD —
``svd``, ``svd_vals``, ``gesvd`` (with ``ge2tb``, ``unmbr_ge2tb``,
``tb2bd``, ``unmbr_tb2bd`` and ``bdsqr``), whose band → bidiagonal chase
is one launch of the ``tb2bd_wavefront`` kernel on the card — and the
distributed drivers over ``torch.distributed`` (:mod:`.parallel`:
``pgemm``, ``ppotrf``/``ppotrs``/``pposv``, ``pgetrf``/``pgetrs``/
``pgesv`` on a block-cyclic ``DistMatrix``, one process per grid
position), whose per-step panels are the ``chol_l21_panel`` and
``lu_u12_panel`` kernels on the card — and the norms, condition
estimates, elementwise utilities and band solvers — ``norm``,
``col_norms``, ``gecondest``/``pocondest``/``trcondest``, ``add``,
``copy``, ``scale``, ``scale_row_col``, ``set``, ``gbmm``, ``hbmm``,
``pbtrf``/``pbtrs``/``pbsv``, ``gbtrf``/``gbtrs``/``gbsv``, ``tbsm`` —
with the mixed-precision solvers on them, ``posv_mixed``,
``gesv_mixed``, their ``_gmres`` forms and ``gels_mixed`` (fp32
factor, refined in the working precision).  The tile kernels
``tile_norms``, ``tzset``/``tzscale``, ``geadd`` and
``gescale_row_col`` are :mod:`slate_tpu_torch.ops.kernels`' public
entries, as in the JAX package no driver calls them.  Square fp32/fp64
``getrf``/``gesv`` and ``potrf``/``posv`` run out of core where the
``ooc`` site says so (:mod:`slate_tpu_torch.linalg.ooc` over the pinned
host tile pool of :mod:`slate_tpu_torch.ops.tilepool`).  The rest of the
core surface: ``symm``, ``hemm``, ``syr2k``, ``her2k`` and the
data-placement variants (``gemmA`` … ``trsmB``), the ``method.select_*``
heuristics, ``TrapezoidMatrix``, :mod:`.printing` (``print_matrix``,
``sprint_matrix``, ``redistribute``), :mod:`.debug` and
``testing.generate_matrix``.
"""

from . import config  # noqa: F401
from .enums import (  # noqa: F401
    Diag, GridOrder, Layout, MethodCholQR, MethodEig, MethodGels, MethodGemm,
    MethodHemm, MethodLU, MethodSVD, MethodTrsm, Norm, Op, Option, Side,
    Target, TileKind, Uplo,
)
from .exceptions import SlateError  # noqa: F401
from .grid import ProcessGrid  # noqa: F401
from .matrix import (  # noqa: F401
    BandMatrix, BaseBandMatrix, BaseMatrix, BaseTrapezoidMatrix,
    HermitianBandMatrix, HermitianMatrix, Matrix, SymmetricMatrix,
    TrapezoidMatrix, TriangularBandMatrix, TriangularMatrix, as_array,
)
from .options import Options, get_option  # noqa: F401
from . import method  # noqa: F401
from .linalg import *  # noqa: F401,F403
from .interop import (  # noqa: F401
    dist_from_numpy, dist_to_numpy, lu_batched_from_numpy,
    lu_batched_to_numpy, lu_from_numpy, lu_to_numpy, matrix_from_numpy,
    matrix_to_numpy,
)
from . import parallel, serve  # noqa: F401
from .printing import print_matrix, redistribute, sprint_matrix  # noqa: F401

__version__ = "0.1.0"
