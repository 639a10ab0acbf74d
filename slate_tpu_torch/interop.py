"""State carried across from the JAX package: a JAX
``Matrix``/``HermitianMatrix`` holds one array plus uplo/diag/mb/nb, an
LU factor is a packed matrix and a permutation, a batched LU factor a
(B, n, n) and a (B, n) array; these functions turn that content, as
numpy and plain values, into the port's objects and back.  The port imports nothing of the JAX
package, so the caller does the JAX side (``np.asarray(m.data)``,
``m.uplo.value``, ...).
"""

from __future__ import annotations

import numpy as np
import torch

from . import matrix as _matrix
from .enums import Diag, Uplo

_KINDS = ("Matrix", "TriangularMatrix", "HermitianMatrix", "SymmetricMatrix",
          "BandMatrix", "TriangularBandMatrix", "HermitianBandMatrix")


def _enum(cls, v):
    return v if isinstance(v, cls) else cls(getattr(v, "value", v))


def matrix_from_numpy(kind: str, data, *, uplo=None, diag=None,
                      mb: int = 256, nb: int = 256, device=None,
                      kl=None, ku=None, kd=None):
    """The port's ``kind`` matrix over ``data`` (placed on ``device``,
    ``cuda`` by default).  ``uplo``/``diag`` take the port's enums, the
    JAX package's enums or their value strings (``"lower"``,
    ``"nonunit"``); the band kinds take their bandwidths (``kl``/``ku``
    for a BandMatrix, ``kd`` for the triangular and Hermitian bands)."""
    if kind not in _KINDS:
        raise ValueError(f"unknown matrix kind {kind!r}; one of {_KINDS}")
    cls = getattr(_matrix, kind)
    data = np.asarray(data)
    if kind == "Matrix":
        return cls(data, mb=mb, nb=nb, device=device)
    if kind == "BandMatrix":
        return cls(data, kl=kl, ku=ku, mb=mb, nb=nb, device=device)
    if kind == "HermitianBandMatrix":
        return cls(data, kd=kd, uplo=_enum(Uplo, uplo or Uplo.Lower), mb=mb,
                   nb=nb, device=device)
    if kind == "TriangularBandMatrix":
        return cls(data, kd=kd, uplo=_enum(Uplo, uplo or Uplo.Lower),
                   diag=_enum(Diag, diag or Diag.NonUnit), mb=mb, nb=nb,
                   device=device)
    return cls(data, uplo=_enum(Uplo, uplo or Uplo.Lower),
               diag=_enum(Diag, diag or Diag.NonUnit), mb=mb, nb=nb,
               device=device)


def matrix_to_numpy(m) -> dict:
    """What ``m`` holds, as ``{"kind", "data", "uplo", "diag", "mb",
    "nb"}`` with ``data`` a numpy array in storage orientation and the
    enums as their value strings (``uplo``/``diag`` are None where the
    class has none); a band matrix adds ``kl``, ``ku`` and, for the
    triangular and Hermitian bands, ``kd``."""
    if m.op.value != "notrans":
        raise ValueError("matrix_to_numpy takes a NoTrans view")
    tri = isinstance(m, (_matrix.BaseTrapezoidMatrix,
                         _matrix.TriangularBandMatrix,
                         _matrix.HermitianBandMatrix))
    diag = getattr(m, "diag", None)
    out = {"kind": type(m).__name__,
           "data": m.data.detach().cpu().resolve_conj().numpy(),
           "uplo": m.uplo.value if tri else None,
           "diag": diag.value if tri and diag is not None else None,
           "mb": m.mb, "nb": m.nb}
    if isinstance(m, _matrix.BaseBandMatrix):
        out.update(kl=m.kl, ku=m.ku)
        if hasattr(m, "kd"):
            out["kd"] = m.kd
    return out


def lu_from_numpy(data, perm, *, mb: int = 256, nb: int = 256, device=None):
    """An LU factor from the JAX package's ``getrf`` output: its packed
    factor (``np.asarray(lu.data)``) and its int32 permutation become the
    port's ``(Matrix, int64 tensor)`` on ``device``."""
    lu = matrix_from_numpy("Matrix", data, mb=mb, nb=nb, device=device)
    return lu, torch.as_tensor(np.asarray(perm, np.int64), device=lu.device)


def lu_to_numpy(lu, perm) -> dict:
    """The port's ``(Matrix, perm)`` as ``{"data", "perm", "mb", "nb"}``
    with numpy arrays (perm int64), for the JAX package's
    ``Matrix(jnp.asarray(d["data"]), ...)`` and a ``jnp`` perm."""
    out = matrix_to_numpy(lu)
    return {"data": out["data"], "perm": perm.detach().cpu().numpy(),
            "mb": out["mb"], "nb": out["nb"]}


def lu_batched_from_numpy(lu, perm, *, device=None):
    """A batched LU factor pair from the JAX package's ``getrf_batched``
    output — ``lu`` (B, n, n) packed factors and ``perm`` (B, n) row
    permutations (any integer type) — as the port's ``(float tensor,
    int64 tensor)`` on ``device``, ready for
    :func:`slate_tpu_torch.linalg.batched.getrs_batched`."""
    from .config import resolve_device

    dev = resolve_device(device)
    lu = np.asarray(lu)
    perm = np.asarray(perm, np.int64)
    if lu.ndim != 3 or lu.shape[1] != lu.shape[2] \
            or perm.shape != lu.shape[:2]:
        raise ValueError("a batched LU pair is (B, n, n) and (B, n), got %s "
                         "and %s" % (lu.shape, perm.shape))
    return torch.tensor(lu, device=dev), torch.tensor(perm, device=dev)


def lu_batched_to_numpy(lu, perm) -> dict:
    """The port's batched ``(LU, perm)`` as ``{"lu", "perm"}`` numpy
    arrays (perm int64), for the JAX package's
    ``getrs_batched(jnp.asarray(d["lu"]), jnp.asarray(d["perm"]), b)``."""
    return {"lu": lu.detach().cpu().numpy(),
            "perm": perm.detach().cpu().numpy().astype(np.int64)}


def dist_from_numpy(data, m: int, n: int, nb: int, mesh, mb=None,
                    row_map=None, col_map=None):
    """This rank's :class:`~slate_tpu_torch.parallel.DistMatrix` of a JAX
    ``DistMatrix``'s content: ``data`` is its padded, shuffled storage
    (``np.asarray(dm.data)``), the rest its fields.  The rank keeps the
    storage block of its grid position (r, c), on the mesh's device."""
    from .parallel.dist import DistMatrix

    data = np.asarray(data)
    h, w = data.shape[0] // mesh.p, data.shape[1] // mesh.q
    if h * mesh.p != data.shape[0] or w * mesh.q != data.shape[1]:
        raise ValueError("storage %s does not split over a %dx%d grid"
                         % (data.shape, mesh.p, mesh.q))
    shard = data[mesh.r * h:(mesh.r + 1) * h, mesh.c * w:(mesh.c + 1) * w]
    return DistMatrix(torch.tensor(shard, device=mesh.device), m, n, nb,
                      mesh, mb=mb, row_map=row_map, col_map=col_map)


def dist_to_numpy(dm):
    """The padded, shuffled storage of a DistMatrix as numpy, on every
    rank (its shards gathered by one ``psum``): the ``data`` of the JAX
    package's ``DistMatrix`` with the same fields, and the input of
    :func:`dist_from_numpy`."""
    from .parallel.dist import _storage

    return _storage(dm).detach().cpu().numpy()
