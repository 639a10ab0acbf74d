"""Algorithm-variant selection and backend selection — the counterpart
of ``slate_tpu/method.py``.

The ``select_*`` functions are the reference's ``select_algo`` shape
heuristics (``include/slate/method.hh``): an explicit method stands,
``Auto`` picks from the problem's shape.  On one card the gemm, hemm and
trsm variants share one computation (:mod:`slate_tpu_torch.linalg.blas3`);
the choice is kept so reference call sites port unchanged.  Drivers call
:func:`select_backend` instead of touching kernel modules, so every
dispatch resolves in one table (:mod:`slate_tpu_torch.perf.autotune`)."""

from __future__ import annotations


def select_backend(op: str, **key) -> str:
    """Resolved backend of site ``op`` for this key, e.g.
    ``select_backend("potrf_panel", n=8192, nb=512, dtype=torch.float32,
    device=a.device)``."""

    from .perf.autotune import select

    return select(op, **key)


def select_lu(method, distributed: bool = False):
    """LU variant (reference ``MethodLU::select_algo``,
    ``method.hh:298-311``): an explicit choice stands; ``Auto`` is
    PartialPiv on one device and CALU on a mesh, as in the JAX package."""

    from .enums import MethodLU

    if method is not MethodLU.Auto:
        return method
    return MethodLU.CALU if distributed else MethodLU.PartialPiv


def select_gels(method, m: int, n: int):
    """Least-squares method (reference ``MethodGels::select_algo``,
    ``method.hh:252-268``): an explicit choice stands; ``Auto`` is CholQR
    for strongly tall systems (m ≥ 3n), Householder QR otherwise."""

    from .enums import MethodGels

    if method is not MethodGels.Auto:
        return method
    return MethodGels.CholQR if m >= 3 * n else MethodGels.QR


def select_gemm(method, b_nt: int, n_devices: int = 1):
    """Reference ``MethodGemm::select_algo`` (``method.hh:106-121``):
    gemmA when B is one block column, else gemmC."""

    from .enums import MethodGemm

    if method is not MethodGemm.Auto:
        return method
    return MethodGemm.GemmA if b_nt <= 1 else MethodGemm.GemmC


def select_trsm(method, b_nt: int, n_devices: int = 1):
    """Reference ``MethodTrsm::select_algo`` (``method.hh:47-66``): trsmA
    when B is one block column, else trsmB."""

    from .enums import MethodTrsm

    if method is not MethodTrsm.Auto:
        return method
    return MethodTrsm.TrsmA if b_nt <= 1 else MethodTrsm.TrsmB


def select_hemm(method, b_nt: int, n_devices: int = 1):
    """Reference ``MethodHemm::select_algo`` (``method.hh:148-160``):
    hemmA when B is one block column, else hemmC."""

    from .enums import MethodHemm

    if method is not MethodHemm.Auto:
        return method
    return MethodHemm.HemmA if b_nt <= 1 else MethodHemm.HemmC


def select_cholqr(method, m: int, n: int, n_devices: int = 1):
    """Reference ``MethodCholQR::select_algo`` (``method.hh:203-224``):
    the Gram matrix by herk for a tall matrix (m ≥ 2n), else by gemm."""

    from .enums import MethodCholQR

    if method is not MethodCholQR.Auto:
        return method
    return MethodCholQR.HerkC if m >= 2 * n else MethodCholQR.GemmC


def select_eig(method, n: int, want_vectors: bool):
    """Tridiagonal eigensolver of heev (reference ``src/heev.cc:141-176``):
    QR iteration for values only, divide and conquer with vectors."""

    from .enums import MethodEig

    if method is not MethodEig.Auto:
        return method
    return MethodEig.DC if want_vectors else MethodEig.QR


def select_svd(method, m: int, n: int, want_vectors: bool):
    """Bidiagonal solver of svd: QR iteration for values only, divide and
    conquer with vectors."""

    from .enums import MethodSVD

    if method is not MethodSVD.Auto:
        return method
    return MethodSVD.DC if want_vectors else MethodSVD.QR
