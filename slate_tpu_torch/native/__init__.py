"""Host bulge chases and the bidiagonal solve — the part of
``slate_tpu/native`` that the host routes of the two-stage eigensolver
and SVD call (``slate_tpu/native/__init__.py:343-639``), bound with
``ctypes``.

The source is ``chase.cc`` beside this file (OpenMP, no BLAS or LAPACK).
It is compiled at first use with ``g++ -O3 -mfma -fopenmp -shared -fPIC``
(FMA contraction as in the JAX package's ``-march=native`` build, but a
library that runs on any x86-64 host with FMA) into
``build/slate_tpu_torch/libchase-<digest>.so`` at the root of the
checkout, the digest covering the source and the flags, and never at
import.  Where no compiler is found :func:`available` is False and the
callers take their pure-Python fallbacks, as the JAX package's do.

``SLATE_TPU_TORCH_CHASE_SERIAL=1`` runs the Householder chases in serial
sweep order instead of the OpenMP wavefront (the two are bitwise equal).

:func:`bdsdc` is LAPACK ``dbdsdc`` from the scipy already installed,
called through its Cython C-API capsule
(``scipy.linalg.cython_lapack.__pyx_capi__``): scipy's own OpenBLAS, the
library the JAX package's runtime links (``runtime.cc:40-51``), with no
build step.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "chase.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "slate_tpu_torch"
FLAGS = ("-O3", "-mfma", "-fopenmp", "-shared", "-fPIC")

_lib = None
_lock = threading.Lock()
_build_error: str | None = None


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / ("libchase-%s.so" % h.hexdigest()[:16])


def _build(out: Path) -> str | None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + ".%d.tmp" % os.getpid())
    cmd = ["g++", *FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as ex:   # no toolchain
        return str(ex)
    if r.returncode != 0:
        return r.stderr[-2000:]
    os.replace(tmp, out)
    return None


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        out = lib_path()
        if not out.exists():
            _build_error = _build(out)
            if _build_error is not None:
                return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError as ex:
            _build_error = str(ex)
            return None
        i64, p = ctypes.c_int64, ctypes.c_void_p
        lib.slate_host_num_threads.restype = ctypes.c_int
        lib.slate_set_num_threads.argtypes = [ctypes.c_int]
        for name in ("slate_hb2st_f64", "slate_hb2st_c128"):
            fn = getattr(lib, name)
            fn.restype = i64
            fn.argtypes = [p, i64, i64, i64, p, p, p]
        lib.slate_hb2st_hh_f64.restype = i64
        lib.slate_hb2st_hh_f64.argtypes = [p, i64, i64, i64, p, p, p, p]
        for name in ("slate_hb2st_hh_range_f64", "slate_hb2st_hh_range_c128"):
            fn = getattr(lib, name)
            fn.restype = i64
            fn.argtypes = [p, i64, i64, i64, p, p, p, p, i64, i64]
        lib.slate_tb2bd_hh_f64.restype = i64
        lib.slate_tb2bd_hh_f64.argtypes = [p, i64, i64, i64] + [p] * 8
        lib.slate_tb2bd_hh_range_f64.restype = i64
        lib.slate_tb2bd_hh_range_f64.argtypes = ([p, i64, i64, i64] + [p] * 8
                                                 + [i64, i64])
        for name in ("slate_tb2bd_f64", "slate_tb2bd_c128"):
            fn = getattr(lib, name)
            fn.restype = i64
            fn.argtypes = [p, i64, i64, i64] + [p] * 6
        for name in ("slate_apply_rot_seq_f64", "slate_apply_rot_seq_c128",
                     "slate_apply_rot_skewed_f64",
                     "slate_apply_rot_skewed_c128"):
            getattr(lib, name).argtypes = [i64, i64, p, p, p, p, i64,
                                           ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    """True once the library is built and loaded (builds it on first
    call)."""
    return _load() is not None


def build_error() -> str | None:
    _load()
    return _build_error


def _need():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native chase unavailable: {_build_error}")
    return lib


def _c_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def num_threads() -> int:
    lib = _load()
    return lib.slate_host_num_threads() if lib else 1


def set_num_threads(n: int) -> None:
    """Cap the OpenMP thread pool of the wavefront chase."""
    lib = _load()
    if lib:
        lib.slate_set_num_threads(int(n))


def rot_count(n: int, kd: int) -> int:
    """Rotation count of the direct-to-tridiagonal Givens chase: per
    column j, entries at distance d = 2..min(kd, n-1-j) each start a
    chase of 1 + ⌊(n−1−j−d)/kd⌋ rotations."""
    total = 0
    for j in range(max(n - 2, 0)):
        dmax = min(kd, n - 1 - j)
        if dmax >= 2:
            d = np.arange(2, dmax + 1)
            total += int(np.sum(1 + (n - 1 - j - d) // kd))
    return total


def _stage2_dtype(dtype):
    return (np.complex128 if np.issubdtype(np.dtype(dtype),
                                           np.complexfloating)
            else np.float64)


def hb2st_banded(ab: np.ndarray, n: int, kd: int, want_rots: bool = True):
    """Givens band→tridiagonal chase on lower-band storage
    ``ab[(n, kd+2)]`` (``ab[j, d]`` = A[j+d, j]), in place.  Returns the
    rotation log ``(planes, cs, ss)``; empty arrays when ``want_rots`` is
    False (values-only callers skip the O(n²) log)."""
    lib = _need()
    assert ab.shape == (n, kd + 2) and ab.flags.c_contiguous
    fn = (lib.slate_hb2st_c128 if ab.dtype == np.complex128
          else lib.slate_hb2st_f64)
    if not want_rots:
        fn(_c_ptr(ab), n, kd, kd + 2, None, None, None)
        return (np.empty(0, dtype=np.int32), np.empty(0, dtype=np.float64),
                np.empty(0, dtype=ab.dtype))
    cap = rot_count(n, kd)
    planes = np.empty(cap, dtype=np.int32)
    cs = np.empty(cap, dtype=np.float64)
    ss = np.empty(cap, dtype=ab.dtype)
    nrot = fn(_c_ptr(ab), n, kd, kd + 2, _c_ptr(planes), _c_ptr(cs),
              _c_ptr(ss))
    assert nrot == cap, (nrot, cap)
    return planes, cs, ss


def hh_step_count(n: int, kd: int, j0: int = 0,
                  j1: int | None = None) -> int:
    """Reflector count of the Householder chase (one per window) over
    sweeps ``[j0, j1)``."""
    total = 0
    if j1 is None:
        j1 = max(n - 2, 0)
    for j in range(j0, min(j1, max(n - 2, 0))):
        L = min(kd, n - 1 - j)
        if L < 2:
            continue
        total += 1
        r0 = j + 1
        while True:
            r1 = r0 + L
            Lt = min(kd, n - r1)
            if Lt < 2:
                break
            total += 1
            r0, L = r1, Lt
    return total


def _hh_log(dtype, cap: int, kd: int):
    return (np.zeros((cap, kd), dtype=dtype), np.zeros(cap, dtype=dtype),
            np.zeros(cap, dtype=np.int32), np.zeros(cap, dtype=np.int32))


def hb2st_hh_banded(abw: np.ndarray, n: int, kd: int):
    """Householder band→tridiagonal chase (SLATE's hebr1/2/3 schedule) on
    WIDE lower-band storage ``abw[(n, 2·kd+2)]``, in place, real f64.
    Returns the reflector log ``(v, tau, row0, length)``, ``v[(nstep,
    kd)]`` with v[0] = 1 stored."""
    lib = _need()
    assert abw.shape == (n, 2 * kd + 2) and abw.flags.c_contiguous
    assert abw.dtype == np.float64
    v, tau, row0, length = _hh_log(np.float64, hh_step_count(n, kd), kd)
    nstep = lib.slate_hb2st_hh_f64(_c_ptr(abw), n, kd, 2 * kd + 2, _c_ptr(v),
                                   _c_ptr(tau), _c_ptr(row0), _c_ptr(length))
    assert nstep == len(tau), (nstep, len(tau))
    return v, tau, row0, length


def hb2st_hh_banded_range(abw: np.ndarray, n: int, kd: int, j0: int,
                          j1: int):
    """Sweeps ``[j0, j1)`` of :func:`hb2st_hh_banded` (f64 or c128): the
    band is the whole state between calls."""
    lib = _need()
    assert abw.shape == (n, 2 * kd + 2) and abw.flags.c_contiguous
    assert abw.dtype in (np.float64, np.complex128)
    v, tau, row0, length = _hh_log(abw.dtype, hh_step_count(n, kd, j0, j1),
                                   kd)
    fn = (lib.slate_hb2st_hh_range_c128 if abw.dtype == np.complex128
          else lib.slate_hb2st_hh_range_f64)
    nstep = fn(_c_ptr(abw), n, kd, 2 * kd + 2, _c_ptr(v), _c_ptr(tau),
               _c_ptr(row0), _c_ptr(length), j0, j1)
    assert nstep == len(tau), (nstep, len(tau))
    return v, tau, row0, length


def apply_rot_seq(z: np.ndarray, planes, cs, ss, mode: int,
                  kd: int = 0) -> np.ndarray:
    """Apply a logged rotation sequence in reverse to ``z`` (n×k): mode 0
    = [[c, −s], [s̄, c]] (the hb2st back-transform), mode 1 = [[c, −s̄],
    [s, c]].  With ``kd`` and a log of the direct chase schedule the
    skewed-wavefront applier runs, else the flat reverse sweep."""
    lib = _need()
    dt = _stage2_dtype(np.result_type(z.dtype, ss.dtype))
    z = np.ascontiguousarray(z, dtype=dt)
    ss = np.ascontiguousarray(ss, dtype=dt)
    planes = np.ascontiguousarray(planes, dtype=np.int32)
    cs = np.ascontiguousarray(cs, dtype=np.float64)
    n = z.shape[0]
    cplx = dt == np.complex128
    if kd and kd >= 2 and len(planes) == rot_count(n, kd):
        fn = (lib.slate_apply_rot_skewed_c128 if cplx
              else lib.slate_apply_rot_skewed_f64)
        fn(n, z.shape[1], _c_ptr(z), _c_ptr(planes), _c_ptr(cs),
           _c_ptr(ss), kd, mode)
    else:
        fn = (lib.slate_apply_rot_seq_c128 if cplx
              else lib.slate_apply_rot_seq_f64)
        fn(n, z.shape[1], _c_ptr(z), _c_ptr(planes), _c_ptr(cs),
           _c_ptr(ss), len(planes), mode)
    return z


def bd_step_count(n: int, kd: int, s0: int = 0, s1=None) -> int:
    """Reflector count of each log of the bidiagonal Householder chase
    over sweeps ``[s0, s1)``."""
    if s1 is None:
        s1 = max(n - 1, 0)
    total = 0
    for s in range(s0, min(s1, max(n - 1, 0))):
        hi = min(s + kd, n - 1)
        if hi <= s + 1:
            continue
        total += 1
        b = 1
        while b * kd + 1 + s <= n - 1:
            total += 1
            b += 1
    return total


def _tb2bd_hh(st: np.ndarray, n: int, kd: int, rng=None):
    lib = _need()
    assert st.shape == (n, 3 * kd + 2) and st.flags.c_contiguous
    assert st.dtype == np.float64
    cap = bd_step_count(n, kd, *(rng or ()))
    ulog, vlog = _hh_log(np.float64, cap, kd), _hh_log(np.float64, cap, kd)
    ptrs = [_c_ptr(a) for a in ulog + vlog]
    if rng is None:
        nstep = lib.slate_tb2bd_hh_f64(_c_ptr(st), n, kd, 3 * kd + 2, *ptrs)
    else:
        nstep = lib.slate_tb2bd_hh_range_f64(_c_ptr(st), n, kd, 3 * kd + 2,
                                             *ptrs, *rng)
    assert nstep == cap, (nstep, cap)
    return ulog, vlog


def tb2bd_hh_banded(st: np.ndarray, n: int, kd: int):
    """Householder band→bidiagonal chase (SLATE's gebr1/2/3 schedule) on
    row-major general-band storage ``st[(n, 3·kd+2)]`` (``st[r, c−r+kd]``
    = A[r, c]), in place, real f64.  Returns ``((uv, utau, urow0, ulen),
    (vv, vtau, vrow0, vlen))``: the left (U) and right (V) reflector
    logs, each with per-sweep disjoint kd-strided windows."""
    return _tb2bd_hh(st, n, kd)


def tb2bd_hh_banded_range(st: np.ndarray, n: int, kd: int, s0: int,
                          s1: int):
    """Sweeps ``[s0, s1)`` of :func:`tb2bd_hh_banded`: the band is the
    whole state between calls."""
    return _tb2bd_hh(st, n, kd, (s0, s1))


def tb2bd_banded(ab: np.ndarray, n: int, kd: int, want_rots: bool = True):
    """Givens upper-band→bidiagonal chase on storage ``ab[(n, kd+3)]``
    (``ab[c, (c−r)+1]`` = A[r, c]; column 0 holds the subdiagonal bulge),
    in place.  Returns the left and right rotation logs ``((planes, cs,
    ss), (planes, cs, ss))``; empty ones when ``want_rots`` is False."""
    lib = _need()
    assert ab.shape == (n, kd + 3) and ab.flags.c_contiguous
    fn = (lib.slate_tb2bd_c128 if ab.dtype == np.complex128
          else lib.slate_tb2bd_f64)
    if not want_rots:
        fn(_c_ptr(ab), n, kd, kd + 3, None, None, None, None, None, None)
        empty = (np.empty(0, dtype=np.int32), np.empty(0, dtype=np.float64),
                 np.empty(0, dtype=ab.dtype))
        return empty, empty
    cap = rot_count(n, kd)
    lrot = (np.empty(cap, dtype=np.int32), np.empty(cap, dtype=np.float64),
            np.empty(cap, dtype=ab.dtype))
    rrot = tuple(np.empty_like(x) for x in lrot)
    nrot = fn(_c_ptr(ab), n, kd, kd + 3, *map(_c_ptr, lrot),
              *map(_c_ptr, rrot))
    assert nrot == cap, (nrot, cap)
    return lrot, rrot


_dbdsdc = None


def _lapack_dbdsdc():
    """LAPACK ``dbdsdc`` from scipy's Cython C-API capsule."""
    global _dbdsdc
    if _dbdsdc is None:
        from scipy.linalg import cython_lapack

        get = ctypes.pythonapi.PyCapsule_GetPointer
        get.restype = ctypes.c_void_p
        get.argtypes = [ctypes.py_object, ctypes.c_char_p]
        cap = cython_lapack.__pyx_capi__["dbdsdc"]
        name = ctypes.pythonapi.PyCapsule_GetName
        name.restype = ctypes.c_char_p
        name.argtypes = [ctypes.py_object]
        ip, dp, cp = (ctypes.POINTER(ctypes.c_int),
                      ctypes.POINTER(ctypes.c_double), ctypes.c_char_p)
        proto = ctypes.CFUNCTYPE(None, cp, cp, ip, dp, dp, dp, ip, dp, ip,
                                 dp, ip, dp, ip, ip)
        _dbdsdc = proto(get(cap, name(cap)))
    return _dbdsdc


def bdsdc(d: np.ndarray, e: np.ndarray):
    """Bidiagonal divide-and-conquer SVD of the upper bidiagonal (d, e)
    (LAPACK ``dbdsdc``, COMPQ = 'I') — the stage-3 core (the reference
    calls ``lapack::bdsqr`` on rank 0, ``src/svd.cc:300+``).  Returns
    ``(u, s, vt)``, σ descending; raises ``LinAlgError`` when LAPACK
    reports ``info ≠ 0``."""
    d = np.ascontiguousarray(d, dtype=np.float64).copy()
    n = d.shape[0]
    ework = np.zeros(max(n - 1, 1), dtype=np.float64)
    if n > 1:
        ework[:n - 1] = np.asarray(e, dtype=np.float64)[:n - 1]
    # LAPACK writes U and VT column-major
    u = np.zeros((n, n), dtype=np.float64, order="F")
    vt = np.zeros((n, n), dtype=np.float64, order="F")
    work = np.zeros(3 * n * n + 4 * n + 16, dtype=np.float64)
    iwork = np.zeros(8 * n + 8, dtype=np.intc)
    qdum = np.zeros(1, dtype=np.float64)
    iqdum = np.zeros(1, dtype=np.intc)
    nn, info = ctypes.c_int(n), ctypes.c_int(0)
    dptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    iptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
    _lapack_dbdsdc()(b"U", b"I", ctypes.byref(nn), dptr(d), dptr(ework),
                     dptr(u), ctypes.byref(nn), dptr(vt), ctypes.byref(nn),
                     dptr(qdum), iptr(iqdum), dptr(work), iptr(iwork),
                     ctypes.byref(info))
    if info.value != 0:
        raise np.linalg.LinAlgError(
            "bdsdc failed to converge (%d)" % info.value)
    return u, d, vt
