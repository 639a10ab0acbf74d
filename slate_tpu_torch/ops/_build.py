"""Build the CUDA kernels of :mod:`slate_tpu_torch.ops.kernels` from the
sources in ``slate_tpu_torch/csrc`` and load them with ``ctypes``.

Each kernel source becomes its own shared library with a plain C
interface, compiled by ``nvcc -gencode arch=compute_90a,code=sm_90a`` at
first use into ``build/slate_tpu_torch/`` at the root of the checkout.
A library's file name carries a digest of its sources and flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.
:func:`build_all` starts one ``nvcc`` per missing library, all at once.

The compiler is ``$SLATE_TPU_TORCH_NVCC``, else ``nvcc`` on ``PATH``,
else ``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``).  Nothing here
runs at import: the CPU tests import this module on hosts with no CUDA
toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "slate_tpu_torch"

#: kernel name -> (its .cu source, headers it includes)
SOURCES = {
    "matmul": ("matmul.cu", ()),
    "chol_inv_panel": ("chol_inv_panel.cu", ("tri_grid.cuh",)),
    "trtri_panel": ("trtri_panel.cu", ("tri_grid.cuh",)),
    "lu_inv_panel": ("lu_inv_panel.cu", ("tri_grid.cuh",)),
    "getrf_panel_linv": ("getrf_panel_linv.cu", ("lu_panel.cuh", "grid_sync.cuh")),
    "getrf_panel_fused": ("getrf_panel_fused.cu", ("lu_panel.cuh", "grid_sync.cuh")),
    "potrf_batched": ("potrf_batched.cu", ("tri_grid.cuh", "tri_panel.cuh")),
    "getrf_batched": ("getrf_batched.cu", ("lu_panel.cuh", "grid_sync.cuh")),
    "potrf_step_fused": ("potrf_step_fused.cu",
                         ("potrf_grid.cuh", "tri_grid.cuh")),
    "potrf_full_fused": ("potrf_full_fused.cu",
                         ("potrf_grid.cuh", "tri_grid.cuh")),
    "getrf_step_fused": ("getrf_step_fused.cu",
                         ("lu_full.cuh", "lu_panel.cuh", "grid_sync.cuh",
                          "tri_grid.cuh")),
    "getrf_full_fused": ("getrf_full_fused.cu",
                         ("lu_full.cuh", "lu_panel.cuh", "grid_sync.cuh",
                          "tri_grid.cuh")),
    "hb2st_wavefront": ("hb2st_wavefront.cu", ("chase.cuh", "grid_sync.cuh")),
    "tb2bd_wavefront": ("tb2bd_wavefront.cu", ("chase.cuh", "grid_sync.cuh")),
    "chol_l21_panel": ("chol_l21_panel.cu",
                       ("potrf_grid.cuh", "tri_grid.cuh")),
    "lu_u12_panel": ("lu_u12_panel.cu", ("tri_grid.cuh",)),
    "tile_norms": ("tile_norms.cu", ()),
    "tz": ("tz.cu", ("tile2d.cuh",)),
    "geadd": ("geadd.cu", ("tile2d.cuh",)),
    "gescale_row_col": ("gescale_row_col.cu", ("tile2d.cuh",)),
    "split_matmul": ("split_matmul.cu", ()),
    "ozaki_matmul": ("ozaki_matmul.cu", ()),
}

FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_libs: dict = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    env = os.environ.get("SLATE_TPU_TORCH_NVCC")
    if env:
        return env
    found = shutil.which("nvcc")
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
               / "bin" / "nvcc")


def lib_path(name: str) -> Path:
    src, headers = SOURCES[name]
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in (src,) + headers:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / ("lib%s-%s.so" % (name, h.hexdigest()[:16]))


def build_all(names=None) -> dict:
    """Compile every library in ``names`` (default: all) that is not
    built yet, one ``nvcc`` process each, all started together.  Returns
    ``{name: seconds}`` for the ones compiled here; the compiler's output
    (``-Xptxas -v``: registers, shared memory, spills) is kept beside
    each library as ``<lib>.log``.  Raises if any compile fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(out.name + ".%d.tmp" % os.getpid())
        cmd = [nvcc, *FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / SOURCES[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    took, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        out.with_name(out.name + ".log").write_text(log)
        if proc.returncode != 0:
            failed.append("%s (nvcc exit %d):\n%s" % (name, proc.returncode, log))
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return took


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed.
    Safe to call from several threads: one lock covers build and load."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = lib_path(name)
            if not path.exists():
                build_all([name])
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib
