"""One process per grid position — the port's counterpart of building a
mesh over ``jax.devices()`` and running one program per device under
``shard_map``.

:func:`run_spmd` spawns p·q processes (``torch.multiprocessing``,
``spawn``).  Each initializes ``torch.distributed`` from a ``FileStore``
in a temporary directory (no port is needed), builds its
:class:`~.mesh.Mesh` and calls the function named ``"module:function"``
with the mesh and the given arguments; each rank's result comes back to
the caller.  A rank that raises fails the call, after every other rank
has been stopped.

The rank bodies the tests and ``chip_smoke.py`` share live here: a
spawned rank imports ``torch`` and this package only, never the caller's
module.

    from slate_tpu_torch.parallel.launch import run_spmd
    out = run_spmd("slate_tpu_torch.parallel.launch:rank_baseline", 2, 2,
                   (16384, 256, 128, 0), backend="gloo")
"""

from __future__ import annotations

import datetime
import importlib
import os
import queue as queue_mod
import tempfile
import time
import traceback

import numpy as np
import torch


def _resolve(fn_name: str):
    mod, _, name = fn_name.partition(":")
    if not name:
        raise ValueError("name a rank body as 'module:function', got %r"
                         % (fn_name,))
    return getattr(importlib.import_module(mod), name)


def _child(rank: int, world: int, store_path: str, backend: str, p: int,
           q: int, device, fn_name: str, args, env, timeout: float,
           results) -> None:
    try:
        import torch.distributed as dist

        from .mesh import make_grid_mesh

        os.environ.update(env or {})
        dev = torch.device(device) if device is not None else None
        if dev is not None and dev.type == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        elif torch.cuda.is_available():
            torch.cuda.set_device(rank % torch.cuda.device_count()
                                  if dev is None or dev.index is None
                                  else dev.index)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        try:
            mesh = make_grid_mesh(p, q, device=device)
            out = _resolve(fn_name)(mesh, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_spmd(fn_name: str, p: int, q: int, args=(), backend: str = "gloo",
             device=None, env=None, timeout: float = 900.0) -> list:
    """Run ``fn(mesh, *args)`` (``fn_name`` = ``"module:function"``) on a
    p×q grid of spawned processes and return each rank's result, in rank
    order, on a row-major grid.  ``backend`` is the ``torch.distributed``
    backend (``"gloo"`` takes CPU and CUDA tensors; NCCL refuses two
    ranks on one card);
    ``device`` each rank's device (default ``cuda:<rank % cards>``, which
    raises where there is no card; pass ``"cpu"`` on the host); ``env``
    variables set in each rank before ``fn`` runs (site pins such as
    ``SLATE_TPU_TORCH_AUTOTUNE_FORCE`` are read at each call).  Results
    must pickle.  Raises if any rank fails or the call takes longer than
    ``timeout`` seconds; no rank outlives the call."""
    import torch.multiprocessing as mp

    world = p * q
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="slate_spmd_") as tmp:
        procs = [ctx.Process(
            target=_child, daemon=True,
            args=(rank, world, os.path.join(tmp, "store"), backend, p, q,
                  None if device is None else str(device), fn_name,
                  tuple(args), dict(env or {}), timeout, results))
            for rank in range(world)]
        out, errors = {}, []
        deadline = time.monotonic() + timeout
        try:
            for proc in procs:
                proc.start()
            while len(out) < world and not errors:
                try:
                    rank, ok, payload = results.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [i for i, pr in enumerate(procs)
                            if i not in out and pr.exitcode not in (None, 0)]
                    if dead:
                        errors.append("rank %d exited with code %d and no "
                                      "result" % (dead[0],
                                                  procs[dead[0]].exitcode))
                    elif time.monotonic() > deadline:
                        errors.append("no result from ranks %s within %.0f s"
                                      % (sorted(set(range(world)) - set(out)),
                                         timeout))
                    continue
                if ok:
                    out[rank] = payload
                else:
                    errors.append("rank %d failed:\n%s" % (rank, payload))
        finally:
            procs = [proc for proc in procs if proc.pid is not None]
            for proc in procs:
                if proc.is_alive() and (errors or len(out) < world):
                    proc.terminate()
            for proc in procs:
                proc.join(timeout=60)
                if proc.is_alive():
                    proc.kill()
                    proc.join()
            results.close()
    if errors:
        raise RuntimeError("run_spmd(%s, %dx%d): %s"
                           % (fn_name, p, q, errors[0]))
    return [out[r] for r in range(world)]


# ---------------------------------------------------------------------------
# Rank bodies
# ---------------------------------------------------------------------------

def rank_jobs(mesh, jobs) -> list:
    """Several rank bodies in one spawn: ``jobs`` is a list of
    ``("module:function", args)``, each run as ``fn(mesh, *args)`` in
    turn; returns their results."""
    return [_resolve(name)(mesh, *args) for name, args in jobs]


def _np(t):
    return t.detach().cpu().numpy()


def rank_drivers(mesh, a_spd, a_gen, b, nb: int) -> dict:
    """``pgemm(a_gen, a_spd)``, ``pposv(a_spd, b)`` and ``pgesv(a_gen, b)``
    of replicated numpy inputs on this rank's mesh, at the inputs' dtype.
    Returns numpy: the product, the lower Cholesky factor, both
    solutions, the LU factor and its permutation (all replicated through
    :func:`~.dist.undistribute`), the ``dist_*`` site decisions, the
    backends the ``matmul`` site answered and the kernel launches of the
    run."""
    from ..ops import kernels
    from ..perf import autotune
    from . import pgemm_auto, pgesv, pposv, undistribute

    n = a_spd.shape[0]
    kernels.reset_launches()
    c = pgemm_auto(1.0, a_gen, a_spd, mesh, nb=nb)
    l, x = pposv(a_spd, b, mesh, nb=nb)
    lu, gperm, x2 = pgesv(a_gen, b, mesh, nb=nb)
    return {"c": _np(undistribute(c)),
            "l": np.tril(_np(undistribute(l))),
            "x_po": _np(undistribute(x)),
            "lu": _np(undistribute(lu)), "gperm": _np(gperm[:n]),
            "x_ge": _np(undistribute(x2)),
            "decisions": {k: v for k, v in autotune.decisions().items()
                          if k.startswith("dist_")},
            "matmul": sorted({v for k, v in autotune.decisions().items()
                              if k.startswith("matmul|")}),
            "launches": dict(kernels.launches)}


def rank_layout(mesh, cases) -> list:
    """For each case ``{"data", "m", "n", "nb", "mb", "row_map",
    "col_map"}`` (``data`` a JAX DistMatrix's padded, shuffled storage as
    numpy; the maps picklable callables or None): this rank's shard
    (:func:`~slate_tpu_torch.interop.dist_from_numpy`), the storage back
    (:func:`~slate_tpu_torch.interop.dist_to_numpy`), the replicated
    matrix (:func:`~.dist.undistribute`) and the canonical storage
    (:func:`~.dist.canonicalize`), as numpy."""
    from ..interop import dist_from_numpy, dist_to_numpy
    from .dist import canonicalize, undistribute

    out = []
    for case in cases:
        dm = dist_from_numpy(case["data"], case["m"], case["n"], case["nb"],
                             mesh, mb=case.get("mb"),
                             row_map=case.get("row_map"),
                             col_map=case.get("col_map"))
        out.append({"shard": _np(dm.data), "storage": dist_to_numpy(dm),
                    "natural": _np(undistribute(dm)),
                    "canonical": dist_to_numpy(canonicalize(dm))})
    return out


def _residual(a, x, b, eps: float) -> float:
    """The tester's ‖A·x − b‖/(‖A‖·‖x‖·ε·n), in float64."""
    ad, xd = a.double(), x.double()
    return float((ad @ xd - b.double()).norm()
                 / (ad.norm() * xd.norm() * eps * a.shape[0]))


def rank_baseline(mesh, n: int, nb: int, nrhs: int, seed: int,
                  drivers=("pposv", "pgesv")) -> dict:
    """BASELINE.md's ``tester gemm/posv/gesv`` on this rank's mesh, fp32,
    inputs made on the device from ``seed`` (every rank makes the same
    ones): ``pgemm`` of Gaussians, ``pposv`` of A = (R + Rᵀ)/2 + n·I and
    ``pgesv`` of a Gaussian A, each with ``nrhs`` Gaussian right-hand
    sides.  Per driver: the host wall (synchronized), the kernel launches
    and ``collective.*`` counters of its run, and the tester's scaled
    residuals (‖C − A·B‖/(‖A‖·‖B‖·ε·n); ‖A·x − b‖/(‖A‖·‖x‖·ε·n); for
    pgesv also max |L| over the grid and the pivot search taken).  Raises
    when a residual passes 3, a value is not finite, or |L| passes
    1 + 100ε under partial (``maxloc``) pivoting; the ``tournament``'s
    pivots do not bound |L| by 1, and its max |L| is reported only."""
    from ..ops import kernels
    from ..perf import autotune, metrics
    from . import pgemm_auto, pgesv, pposv, undistribute
    from .dist_util import dist_pivot_backend, local_grows

    dev = mesh.device
    eps = float(torch.finfo(torch.float32).eps)
    gen = torch.Generator(device=dev).manual_seed(seed)
    metrics.on()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out = {"rank": (mesh.r, mesh.c), "grid": (mesh.p, mesh.q),
           "device": str(dev)}

    def timed(name, fn):
        sync()
        before = metrics.snapshot()
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = fn()
        sync()
        wall = (time.perf_counter() - t0) * 1e3
        counters = metrics.snapshot_delta(before, metrics.snapshot())
        out[name] = {"wall_ms": wall,
                     "launches": {k: v for k, v in kernels.launches.items()
                                  if v},
                     "collectives": {k: v for k, v in counters.get(
                         "counters", {}).items()
                         if k.startswith("collective.")}}
        return res

    def gate(name, key, value, limit):
        out[name][key] = value
        if not value <= limit:
            raise RuntimeError("%s n=%d on %dx%d: %s %.4g (<= %g)"
                               % (name, n, mesh.p, mesh.q, key, value, limit))

    for name in drivers:
        b = torch.randn((n, nrhs), generator=gen, device=dev)
        if name == "pgemm":
            a = torch.randn((n, n), generator=gen, device=dev)
            bb = torch.randn((n, n), generator=gen, device=dev)
            c = undistribute(timed(name, lambda: pgemm_auto(
                1.0, a, bb, mesh, nb=nb)))
            ref = a.double() @ bb.double()
            gate(name, "residual", float(
                (c.double() - ref).norm()
                / (a.double().norm() * bb.double().norm() * eps * n)), 3)
            del a, bb, c, ref
            continue
        if name == "pposv":
            r = torch.randn((n, n), generator=gen, device=dev)
            a = (r + r.T) / 2 + n * torch.eye(n, device=dev)
            del r
            _, x = timed(name, lambda: pposv(a, b, mesh, nb=nb))
        else:
            a = torch.randn((n, n), generator=gen, device=dev)
            lu, _, x = timed(name, lambda: pgesv(a, b, mesh, nb=nb))
            # |L| ≤ 1 + 100ε over this rank's strictly lower entries
            gr = torch.as_tensor(local_grows(lu.data.shape[0] // nb, nb,
                                             mesh.p, mesh.r), device=dev)
            gc = torch.as_tensor(local_grows(lu.data.shape[1] // nb, nb,
                                             mesh.q, mesh.c), device=dev)
            low = (gr[:, None] > gc[None, :]) & (gc[None, :] < n)
            lmax = float(mesh.pmax(torch.where(low, lu.data.abs(), 0)
                                   .max().reshape(1)))
            # partial pivoting bounds |L| by 1; the tournament's pivots
            # (CALU) bound it more loosely, so there it is reported only
            out[name]["pivot"] = dist_pivot_backend(nb, mesh.p, a.dtype, dev)
            gate(name, "max_abs_L", lmax, 1 + 100 * eps
                 if out[name]["pivot"] == "maxloc" else float("inf"))
            del lu
        x = undistribute(x)
        if not bool(torch.isfinite(x).all()) or tuple(x.shape) != (n, nrhs):
            raise RuntimeError("%s: x has shape %s or non-finite values"
                               % (name, tuple(x.shape)))
        gate(name, "residual", _residual(a, x, b, eps), 3)
        del a, x
    out["decisions"] = {k: v for k, v in autotune.decisions().items()
                        if k.startswith("dist_")}
    return out
