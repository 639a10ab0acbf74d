"""Enumerations of the public surface — the port's own copy of
``slate_tpu/enums.py`` (same names, same string values, so a value read
from one package's enum names the same member in the other)."""

from __future__ import annotations

import enum


class Target(enum.Enum):
    """Execution target.  ``Devices`` is the CUDA card; the OpenMP-era
    host variants are aliases of ``Host``."""

    Host = "host"
    Devices = "devices"

    HostTask = "host"
    HostNest = "host"
    HostBatch = "host"


class Op(enum.Enum):
    NoTrans = "notrans"
    Trans = "trans"
    ConjTrans = "conjtrans"


class Uplo(enum.Enum):
    Lower = "lower"
    Upper = "upper"
    General = "general"


class Diag(enum.Enum):
    NonUnit = "nonunit"
    Unit = "unit"


class Side(enum.Enum):
    Left = "left"
    Right = "right"


class Norm(enum.Enum):
    """Matrix norm selector (LAPACK vocabulary; reference norm drivers)."""

    One = "one"
    Two = "two"
    Inf = "inf"
    Fro = "fro"
    Max = "max"


class Layout(enum.Enum):
    """Tile element layout (reference ``Tile.hh`` layout_); advisory here,
    kept for the LAPACK/ScaLAPACK layers, whose host buffers are
    ColMajor."""

    ColMajor = "colmajor"
    RowMajor = "rowmajor"


class GridOrder(enum.Enum):
    Col = "col"
    Row = "row"


class TileKind(enum.Enum):
    """Reference ``Tile.hh:120-124``; kept for the compat layers."""

    Workspace = "workspace"
    SlateOwned = "slate_owned"
    UserOwned = "user_owned"


class MOSI(enum.Enum):
    """Tile coherence states (reference ``MatrixStorage.hh:33-38``).  The
    caching allocator owns placement here, so they drive no copy; they
    name states for debugging tools."""

    Modified = "modified"
    Shared = "shared"
    Invalid = "invalid"
    OnHold = "onhold"


class Option(enum.Enum):
    """Per-call option keys (reference ``enums.hh:69-101``)."""

    ChunkSize = "chunk_size"
    Lookahead = "lookahead"
    BlockSize = "block_size"
    InnerBlocking = "inner_blocking"
    MaxPanelThreads = "max_panel_threads"
    Tolerance = "tolerance"
    Target = "target"
    HoldLocalWorkspace = "hold_local_workspace"
    Depth = "depth"
    MaxIterations = "max_iterations"
    UseFallbackSolver = "use_fallback_solver"
    PivotThreshold = "pivot_threshold"
    PrintVerbose = "print_verbose"
    PrintEdgeItems = "print_edgeitems"
    PrintWidth = "print_width"
    PrintPrecision = "print_precision"
    MethodCholQR = "method_cholqr"
    MethodEig = "method_eig"
    MethodFactor = "method_factor"
    MethodGels = "method_gels"
    MethodGemm = "method_gemm"
    MethodHemm = "method_hemm"
    MethodLU = "method_lu"
    MethodTrsm = "method_trsm"
    MethodSVD = "method_svd"
    #: route pheev's tridiagonal stage through the distributed D&C
    #: (``parallel.dist_stedc.pstedc``); default on for n ≥ 2048
    StedcDist = "stedc_dist"
    #: route psvd's bidiagonal stage through the checkpointed tb2bd and
    #: the Golub–Kahan pstedc middle; default on for n ≥ 2048
    SvdDist = "svd_dist"
    #: heev's whole-driver choice (``"twostage"`` or ``"qdwh"``),
    #: bypassing the ``eig_driver`` site
    EigDriver = "eig_driver"
    #: svd's whole-driver choice (``"twostage"`` or ``"qdwh"``), bypassing
    #: the ``svd_driver`` site
    SvdDriver = "svd_driver"
    #: QDWH divide-and-conquer crossover (default
    #: ``linalg.polar.QDWH_CROSSOVER``, 128)
    QdwhCrossover = "qdwh_crossover"


class MethodEig(enum.Enum):
    """Tridiagonal eigensolver of heev (reference ``enums.hh:60-63``)."""

    Auto = "auto"
    QR = "qr"
    DC = "dc"
    MRRR = "mrrr"
    Bisection = "bisection"


class MethodSVD(enum.Enum):
    """Bidiagonal solver of svd (JAX package ``enums.py:223-227``)."""

    Auto = "auto"
    QR = "qr"
    DC = "dc"
    Bisection = "bisection"


class MethodGels(enum.Enum):
    """Least-squares method (reference ``method.hh:236-268``)."""

    Auto = "auto"
    QR = "qr"
    CholQR = "cholqr"


class MethodLU(enum.Enum):
    """LU pivoting variant (reference ``method.hh:279-315``)."""

    Auto = "auto"
    PartialPiv = "partial"
    CALU = "calu"
    NoPiv = "nopiv"
    RBT = "rbt"
    BEAM = "beam"


class MethodGemm(enum.Enum):
    """gemm variant (reference ``method.hh:77-126``)."""

    Auto = "auto"
    GemmA = "A"
    GemmC = "C"


class MethodHemm(enum.Enum):
    """hemm variant (reference ``method.hh:128-160``)."""

    Auto = "auto"
    HemmA = "A"
    HemmC = "C"


class MethodTrsm(enum.Enum):
    """trsm variant (reference ``method.hh:25-66``)."""

    Auto = "auto"
    TrsmA = "A"
    TrsmB = "B"


class MethodCholQR(enum.Enum):
    """How CholQR forms its Gram matrix (reference ``method.hh:180-224``)."""

    Auto = "auto"
    GemmA = "gemmA"
    GemmC = "gemmC"
    HerkA = "herkA"
    HerkC = "herkC"
