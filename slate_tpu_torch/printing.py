"""Matrix printing and redistribution — the port of
``slate_tpu/printing.py:28-109``.

* :func:`print_matrix` / :func:`sprint_matrix` — reference
  ``slate::print`` (``src/print.cc``) with its verbosity levels
  (``Option::PrintVerbose``): 0 silent, 1 the header, 2 the corners
  (``PrintEdgeItems``), 3 everything, 4 everything with tile rules.  The
  text is the JAX package's, character for character, for the same
  values (dtypes print by their numpy names).
* :func:`redistribute` — reference ``slate::redistribute``
  (``src/redistribute.cc:20``): a :class:`~slate_tpu_torch.parallel.dist.
  DistMatrix` moved to another grid or tile size by one gather and a
  re-scatter.  Like every distributed call, every rank of the grid calls
  it (so does :func:`sprint_matrix` of a DistMatrix: it gathers).
"""

from __future__ import annotations

import io
import sys

import numpy as np
import torch

from .matrix import BaseMatrix
from .parallel.dist import DistMatrix, distribute, undistribute

__all__ = ["print_matrix", "redistribute", "sprint_matrix"]


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().resolve_conj().resolve_neg().cpu().numpy()
    return np.asarray(t)


def _fmt(x, width, precision):
    if np.iscomplexobj(x):
        return (f"{x.real:{width}.{precision}f}"
                f"{x.imag:+{width - 1}.{precision}f}i")
    return f"{x:{width}.{precision}f}"


def sprint_matrix(label: str, a, verbose: int = 3, width: int = 10,
                  precision: int = 4, edgeitems: int = 3) -> str:
    """Render a matrix (Matrix family, DistMatrix, tensor or array-like)
    to a string — the worker behind :func:`print_matrix`."""
    if verbose <= 0:
        return ""
    out = io.StringIO()
    if isinstance(a, DistMatrix):
        p, q = a.grid_shape
        header = (f"% {label}: DistMatrix {a.m}x{a.n}, nb={a.nb}, "
                  f"grid={p}x{q}, dtype={_dtype_name(a.dtype)}")
        arr = _numpy(undistribute(a))
        nb = mb = a.nb
    elif isinstance(a, BaseMatrix):
        header = (f"% {label}: {type(a).__name__} {a.m}x{a.n}, "
                  f"mb={a.mb}, nb={a.nb}, dtype={_dtype_name(a.dtype)}")
        arr = _numpy(a.array)
        nb, mb = a.nb, a.mb
    else:
        arr = _numpy(a)
        header = f"% {label}: array {arr.shape}, dtype={arr.dtype}"
        mb = nb = max(1, arr.shape[0] if arr.ndim else 1)
    out.write(header + "\n")
    if verbose == 1 or arr.ndim != 2:
        return out.getvalue()
    m, n = arr.shape
    if verbose == 2 and (m > 2 * edgeitems or n > 2 * edgeitems):
        rows = list(range(min(edgeitems, m))) + \
            [-1] + list(range(max(m - edgeitems, edgeitems), m))
        cols = list(range(min(edgeitems, n))) + \
            [-1] + list(range(max(n - edgeitems, edgeitems), n))
    else:
        rows = list(range(m))
        cols = list(range(n))
    out.write(f"{label} = [\n")
    for i in rows:
        if i < 0:
            out.write("  ...\n")
            continue
        if verbose >= 4 and i > 0 and i % mb == 0:
            out.write("  " + "-" * (len(cols) * (width + 1)) + "\n")
        cells = []
        for j in cols:
            if j < 0:
                cells.append("...")
                continue
            if verbose >= 4 and j > 0 and j % nb == 0:
                cells.append("|")
            cells.append(_fmt(arr[i, j], width, precision))
        out.write("  " + " ".join(cells) + "\n")
    out.write("]\n")
    return out.getvalue()


def print_matrix(label: str, a, verbose: int = 3, width: int = 10,
                 precision: int = 4, edgeitems: int = 3,
                 file=None) -> None:
    """Print a matrix with the reference's verbosity semantics."""
    text = sprint_matrix(label, a, verbose, width, precision, edgeitems)
    if text:
        (file or sys.stdout).write(text)


def redistribute(a: DistMatrix, mesh=None, nb=None) -> DistMatrix:
    """``a`` on the grid ``mesh`` (default its own) with tile size ``nb``
    (default its own): the replicated matrix gathered by one psum
    (:func:`~slate_tpu_torch.parallel.dist.undistribute`), then each rank
    keeps its blocks of the new layout."""
    dense = undistribute(a)
    return distribute(dense, mesh if mesh is not None else a.mesh,
                      nb if nb is not None else a.nb)
