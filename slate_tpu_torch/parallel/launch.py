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

import contextlib
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


# ---------------------------------------------------------------------------
# Rank bodies of the QR family, dist_aux and the layout moves
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def pinned(force):
    """The site pins ``force`` (a ``SLATE_TPU_TORCH_AUTOTUNE_FORCE`` value,
    read at each call) in this process for the block; None leaves the
    environment as it is."""
    from ..perf.autotune import FORCE_ENV

    if force is None:
        yield
        return
    saved = os.environ.get(FORCE_ENV)
    os.environ[FORCE_ENV] = force
    try:
        yield
    finally:
        if saved is None:
            del os.environ[FORCE_ENV]
        else:
            os.environ[FORCE_ENV] = saved


def _sites() -> dict:
    from ..perf import autotune

    return {k: v for k, v in autotune.decisions().items()
            if k.startswith("dist_")}


def rank_qr(mesh, a, b, wide, c, nb: int, force=None) -> dict:
    """The QR family on replicated numpy inputs under the pins ``force``:
    ``pgeqrf`` of the tall ``a`` (distributed with ``row_mult=q,
    col_mult=p``), ``punmqr_conj`` of ``b`` (``row_mult=q``),
    ``pgels(a, b)``, ``pgelqf`` of the wide ``wide`` and ``punmlq`` of
    ``c`` both ways.  Returns numpy, replicated through
    :func:`~.dist.undistribute`: the factors, T blocks and τ, Qᴴ·b, x,
    Q̃·c and Q̃ᴴ·c; the ``dist_*`` site decisions, the kernel launches
    and the CholQR² guard's reruns of the run."""
    from ..ops import kernels
    from ..perf import metrics
    from . import (distribute, pgelqf, pgels, pgeqrf, punmlq, punmqr_conj,
                   undistribute)

    p, q = mesh.p, mesh.q
    metrics.on()
    with pinned(force):
        before = metrics.snapshot()
        kernels.reset_launches()
        qr, tmats, taus = pgeqrf(distribute(a, mesh, nb, row_mult=q,
                                            col_mult=p))
        qtb = punmqr_conj(qr, tmats, distribute(b, mesh, nb, row_mult=q))
        _, _, x = pgels(a, b, mesh, nb=nb)
        lq, ltm, ltau = pgelqf(distribute(wide, mesh, nb, row_mult=q,
                                          col_mult=p))
        cd = distribute(c, mesh, nb, row_mult=q)
        qc = punmlq(lq, ltm, cd)
        qhc = punmlq(lq, ltm, cd, adjoint=True)
        counters = metrics.snapshot_delta(before, metrics.snapshot())
    return {"qr": _np(undistribute(qr)), "tmats": _np(tmats),
            "taus": _np(taus), "qtb": _np(undistribute(qtb)),
            "x": _np(undistribute(x)), "lq": _np(undistribute(lq)),
            "lq_tmats": _np(ltm), "lq_taus": _np(ltau),
            "qc": _np(undistribute(qc)), "qhc": _np(undistribute(qhc)),
            "decisions": _sites(), "launches": dict(kernels.launches),
            "reruns": counters.get("counters", {}).get(
                "pgeqrf.cholqr2.reruns", 0.0)}


def rank_aux(mesh, inp: dict, nb: int) -> dict:
    """dist_aux on replicated numpy inputs: ``inp`` holds ``"rect"`` (m×n,
    distributed with ``diag_pad=1``, its padding masked by the norms),
    ``"tall"`` and ``"tall2"`` (m×k, the rank-k updates' A and B),
    ``"sq"`` (n×n), ``"c"`` (m×m), ``"rhs"`` (n×r) and ``"rhs_right"``
    (r×n), ``"alpha"`` and ``"beta"``.  Returns numpy: ``pnorm`` at each
    of the four norms and ``pcolnorms`` of ``rect``; ``pherk``,
    ``psyrk``, ``pher2k`` and ``psyr2k`` without and with C;
    ``ptri_mask`` and ``ptrmm`` at each uplo and diag; ``phemm`` and
    ``psymm`` without and with C; ``ptrsm`` at all 16 side/uplo/op/diag
    combinations of the triangles of ``sq`` (keyed
    ``"trsm/<side>/<uplo>/<op>/<diag>"``); the ``dist_*`` site decisions
    and the kernel launches of the run."""
    from ..enums import Diag, Norm, Op, Side, Uplo
    from ..ops import kernels
    from . import (distribute, pcolnorms, phemm, pher2k, pherk, pnorm,
                   psymm, psyr2k, psyrk, ptri_mask, ptrmm, ptrsm,
                   undistribute)

    p, q = mesh.p, mesh.q
    alpha, beta = inp["alpha"], inp["beta"]
    sq = dict(row_mult=q, col_mult=p)
    out = {}
    kernels.reset_launches()
    rect = distribute(inp["rect"], mesh, nb, diag_pad=1.0, **sq)
    for norm in (Norm.Max, Norm.One, Norm.Inf, Norm.Fro):
        out["norm/" + norm.value] = float(pnorm(rect, norm))
    out["colnorms"] = _np(pcolnorms(rect))
    a = distribute(inp["tall"], mesh, nb, row_mult=q)
    b = distribute(inp["tall2"], mesh, nb, row_mult=q)
    c = distribute(inp["c"], mesh, nb, **sq)
    for name, fn, args in (("herk", pherk, (a,)), ("syrk", psyrk, (a,)),
                           ("her2k", pher2k, (a, b)),
                           ("syr2k", psyr2k, (a, b))):
        out[name] = _np(undistribute(fn(alpha, *args)))
        out[name + "/c"] = _np(undistribute(fn(alpha, *args, beta, c)))
    s = distribute(inp["sq"], mesh, nb, **sq)
    rhs = distribute(inp["rhs"], mesh, nb, row_mult=q)
    for uplo in (Uplo.Lower, Uplo.Upper):
        for diag in (Diag.NonUnit, Diag.Unit):
            key = "%s/%s" % (uplo.name, diag.name)
            out["tri_mask/" + key] = _np(undistribute(
                ptri_mask(s, uplo, diag)))
            out["trmm/" + key] = _np(undistribute(
                ptrmm(uplo, diag, s, rhs, alpha)))
    for name, fn in (("hemm", phemm), ("symm", psymm)):
        out[name] = _np(undistribute(fn(alpha, s, rhs)))
        out[name + "/c"] = _np(undistribute(fn(alpha, s, rhs, beta, rhs)))
    rhs_right = distribute(inp["rhs_right"], mesh, nb, col_mult=p)
    for side in (Side.Left, Side.Right):
        for uplo in (Uplo.Lower, Uplo.Upper):
            for op in (Op.NoTrans, Op.Trans, Op.ConjTrans):
                for diag in (Diag.NonUnit, Diag.Unit):
                    key = "trsm/%s/%s/%s/%s" % (side.name, uplo.name,
                                                op.name, diag.name)
                    out[key] = _np(undistribute(ptrsm(
                        side, uplo, op, diag, s,
                        rhs if side is Side.Left else rhs_right)))
    out["decisions"] = _sites()
    out["launches"] = dict(kernels.launches)
    return out


def rank_layout_moves(mesh, a, sq, nb: int, nb_new: int, regrid) -> dict:
    """This rank's shards (numpy) of the layout moves: ``ptranspose`` of
    the replicated numpy ``a`` (plain and conj), ``predistribute`` of it
    to tile ``nb_new`` and to a ``regrid`` = (p2, q2) grid over the same
    ranks, ``peye(n, nb)`` in ``a``'s dtype and ``phermitize`` of the
    square ``sq`` from each triangle; ``a`` and ``sq`` distributed with
    ``row_mult=q, col_mult=p``, ``sq`` with ``diag_pad=1``."""
    from ..enums import Uplo
    from . import (distribute, make_grid_mesh, peye, phermitize,
                   predistribute, ptranspose)

    p, q = mesh.p, mesh.q
    ad = distribute(a, mesh, nb, row_mult=q, col_mult=p)
    sd = distribute(sq, mesh, nb, diag_pad=1.0, row_mult=q, col_mult=p)
    mesh2 = make_grid_mesh(*regrid, device=mesh.device)
    moves = {"transpose": ptranspose(ad),
             "conj_transpose": ptranspose(ad, conj=True),
             "nb_new": predistribute(ad, nb_new),
             "regrid": predistribute(ad, mesh_new=mesh2),
             "eye": peye(sq.shape[0], nb, mesh,
                         dtype=torch.as_tensor(sq).dtype),
             "hermitize_lower": phermitize(sd, Uplo.Lower),
             "hermitize_upper": phermitize(sd, Uplo.Upper)}
    out = {k: _np(v.data) for k, v in moves.items()}
    out["dims"] = {k: (v.m, v.n, v.nb, v.mtp, v.ntp)
                   for k, v in moves.items()}
    out["regrid_rank"] = (mesh2.r, mesh2.c)
    return out


def rank_surface(mesh, a, nb: int, nb_new: int, regrid) -> dict:
    """The core surface on a grid: ``printing.redistribute`` of the
    replicated numpy ``a`` (distributed at ``nb``) to tile ``nb_new`` and
    to a ``regrid`` = (p2, q2) grid over the same ranks (this rank's
    shards, numpy), ``debug.check_dist_layout`` of each (None when it
    passes) and of a shard cut short (its message), and
    ``printing.sprint_matrix`` of the distributed ``a`` at verbose 4."""
    from ..debug import check_dist_layout
    from ..exceptions import SlateError
    from ..printing import redistribute, sprint_matrix
    from . import distribute, make_grid_mesh
    from .dist import DistMatrix

    ad = distribute(a, mesh, nb)
    mesh2 = make_grid_mesh(*regrid, device=mesh.device)
    moves = {"nb_new": redistribute(ad, nb=nb_new),
             "regrid": redistribute(ad, mesh=mesh2)}
    out = {k: _np(v.data) for k, v in moves.items()}
    out["dims"] = {k: (v.m, v.n, v.nb, v.mtp, v.ntp)
                   for k, v in moves.items()}
    out["regrid_rank"] = (mesh2.r, mesh2.c)
    out["layout"] = {}
    short = DistMatrix(ad.data[:-1], ad.m, ad.n, ad.nb, mesh)
    for k, v in (("a", ad), ("short", short), *moves.items()):
        try:
            check_dist_layout(v)
            out["layout"][k] = None
        except SlateError as e:
            out["layout"][k] = str(e)
    out["text"] = sprint_matrix("D", ad, verbose=4)
    return out



# ---------------------------------------------------------------------------
# Rank body of the two-stage eigensolver and SVD
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def snapshot_budget(mb):
    """The chase snapshots' device budget at ``mb`` megabytes in this
    process for the block (None leaves it): the distributed middle's
    spill branch at test sizes."""
    from ..linalg import _chase

    if mb is None:
        yield
        return
    saved = _chase._SNAP_BUDGET_BYTES
    _chase._SNAP_BUDGET_BYTES = float(mb) * 1e6
    try:
        yield
    finally:
        _chase._SNAP_BUDGET_BYTES = saved


def _gather_rows(mesh, x, rows, m: int):
    """The (m, ncols) matrix whose global ``rows`` this rank holds,
    replicated: a move whose destination is every row on every rank."""
    from .dist_util import _move

    cols = np.arange(x.shape[1])
    return _move(mesh, x, np.asarray(rows), cols,
                 lambda d: (np.arange(m), cols))


def rank_twostage(mesh, job: dict) -> dict:
    """One job of the two-stage family on replicated numpy inputs, under
    the job's pins ``job["force"]`` (a ``SLATE_TPU_TORCH_AUTOTUNE_FORCE``
    value) and snapshot budget ``job["budget_mb"]``; ``job["op"]`` is

    * ``"phe2hb"``: ``a`` (n×n Hermitian, distributed with ``row_mult=q,
      col_mult=p``) at tile ``nb``; the factor, T blocks, band tiles, the
      band through ``band_tiles_to_dense`` and ``band_tiles_to_banded``,
      and ``punmtr_he2hb`` of ``z`` both ways;
    * ``"pge2tb"``: ``a`` (m×n, m ≥ n); the factor, both T stacks, the
      tiles and bands, ``punmbr_ge2tb_q`` of ``zq`` (m rows) and
      ``punmbr_ge2tb_p`` of ``zp`` (n rows), both ways;
    * ``"pheev"``: ``w`` and Z of ``pheev(a, mesh, nb, jobz, opts)``;
    * ``"psvd"``: σ, U and V of ``psvd(a, mesh, nb, jobu, jobvt, opts)``;
    * ``"pstedc"``: ``w`` and the whole Q of ``pstedc(d, e, mesh,
      host_cutoff)``.

    Returns numpy (each distributed result replicated through
    :func:`~.dist.undistribute`), the ``chase`` site's decisions, the
    kernel launches and ``chase.host_bytes`` of the run, and this rank's
    coordinates."""
    from ..ops import kernels
    from ..perf import autotune, metrics
    from . import (band_tiles_to_banded, band_tiles_to_dense, distribute,
                   pge2tb, phe2hb, pheev, psvd, punmbr_ge2tb_p,
                   punmbr_ge2tb_q, punmtr_he2hb, undistribute)
    from .dist_stedc import pstedc, pstedc_rows

    op, nb = job["op"], job.get("nb", 256)
    p, q = mesh.p, mesh.q
    sq = dict(row_mult=q, col_mult=p)
    out = {"rank": (mesh.r, mesh.c)}
    metrics.on()

    def und(x):
        return None if x is None else _np(undistribute(x))

    with pinned(job.get("force")), snapshot_budget(job.get("budget_mb")):
        before = metrics.snapshot()
        kernels.reset_launches()
        if op == "phe2hb":
            a = job["a"]
            n = a.shape[0]
            fac, tmats, tiles = phe2hb(distribute(a, mesh, nb, **sq))
            zd = distribute(job["z"], mesh, nb, **sq)
            out.update(fac=und(fac), tmats=_np(tmats), tiles=_np(tiles),
                       dense=band_tiles_to_dense(tiles, n, nb),
                       banded=band_tiles_to_banded(tiles, n, nb),
                       qz=und(punmtr_he2hb(fac, tmats, zd)),
                       qhz=und(punmtr_he2hb(fac, tmats, zd, forward=False)))
        elif op == "pge2tb":
            a = job["a"]
            n = a.shape[1]
            fac, qt, pt, tiles = pge2tb(distribute(a, mesh, nb, **sq))
            zq = distribute(job["zq"], mesh, nb, **sq)
            zp = distribute(job["zp"], mesh, nb, **sq)
            out.update(fac=und(fac), qtmats=_np(qt), ptmats=_np(pt),
                       tiles=_np(tiles),
                       dense=band_tiles_to_dense(tiles, n, nb, lower=False),
                       banded=band_tiles_to_banded(tiles, n, nb,
                                                   lower=False),
                       qz=und(punmbr_ge2tb_q(fac, qt, zq)),
                       qhz=und(punmbr_ge2tb_q(fac, qt, zq, forward=False)),
                       pz=und(punmbr_ge2tb_p(fac, pt, zp)),
                       phz=und(punmbr_ge2tb_p(fac, pt, zp, forward=False)))
        elif op == "pheev":
            w, z = pheev(job["a"], mesh, nb, job.get("jobz", True),
                         job.get("opts"))
            out.update(w=_np(w), z=und(z))
        elif op == "psvd":
            s, u, v = psvd(job["a"], mesh, nb, job.get("jobu", True),
                           job.get("jobvt", True), job.get("opts"))
            out.update(s=_np(s), u=und(u), v=und(v))
        elif op == "pstedc":
            d = job["d"]
            w, qr = pstedc(d, job["e"], mesh, job.get("host_cutoff", 512))
            out.update(w=np.asarray(w), q=_np(_gather_rows(
                mesh, qr, pstedc_rows(d.size, mesh), d.size)))
        else:
            raise ValueError("rank_twostage: unknown op %r" % (op,))
        counters = metrics.snapshot_delta(before, metrics.snapshot())
    out["decisions"] = {k: v for k, v in autotune.decisions().items()
                        if k.startswith("chase|")}
    out["launches"] = {k: v for k, v in kernels.launches.items() if v}
    out["host_bytes"] = counters.get("counters", {}).get("chase.host_bytes",
                                                         0.0)
    out["stages_s"] = {k: t["total_s"] for k, t in counters.get(
        "timers", {}).items() if k.startswith("stage.")}
    return out


# ---------------------------------------------------------------------------
# Rank bodies of the band, Hermitian-indefinite and QDWH drivers
# ---------------------------------------------------------------------------

def _counted(run):
    """``run()`` with metrics on: its result, the kernel launches and the
    counters (``collective.*``, ``qdwh.*``) of the run."""
    from ..ops import kernels
    from ..perf import metrics

    metrics.on()
    before = metrics.snapshot()
    kernels.reset_launches()
    out = run()
    counters = metrics.snapshot_delta(before, metrics.snapshot()).get(
        "counters", {})
    return out, {k: v for k, v in kernels.launches.items() if v}, {
        k: v for k, v in counters.items()
        if k.startswith(("collective.", "qdwh."))}


def rank_band_hesv(mesh, job: dict) -> dict:
    """One job of the band and Hermitian-indefinite drivers on replicated
    numpy inputs (square operands distributed with ``row_mult=q,
    col_mult=p``, right-hand sides with ``row_mult=q``), under the job's
    pins ``job["force"]``; ``job["op"]`` is

    * ``"band"``: ``spd`` (Hermitian, bandwidth ``kd``), ``gen`` (bands
      ``kl``/``ku``), ``tri`` (lower triangular, bandwidth ``kd``,
      distributed with ``diag_pad=1``), ``b`` and ``c`` (n×k), scalars
      ``alpha``/``beta`` and a row order ``pivots``: ``ppbtrf`` both ways
      (its stacks), ``ppbsv``, ``pgbtrf`` (its stacks and row orders),
      ``pgbsv``, ``pgbmm`` with C, ``phbmm`` of ``spd``'s lower triangle,
      ``ptbsm`` without and with the pivots;
    * ``"hesv"``: ``a`` (Hermitian) and ``b``: ``phesv``'s factors (L, d,
      e, ipiv) and x, and ``phetrs`` of b with those factors.

    Returns numpy (distributed results replicated through
    :func:`~.dist.undistribute`), the kernel launches and the
    ``collective.*`` counters of the run."""
    from ..enums import Diag, Op, Side, Uplo
    from . import (distribute, pgbmm, pgbsv, phbmm, phesv, phetrs, ppbsv,
                   ptbsm, undistribute)
    from .dist_band import pgbtrf, ppbtrf

    nb, p, q = job["nb"], mesh.p, mesh.q
    sq = dict(row_mult=q, col_mult=p)

    def und(x):
        return _np(undistribute(x))

    def run():
        out = {}
        if job["op"] == "band":
            kd, kl, ku = job["kd"], job["kl"], job["ku"]
            spd = distribute(job["spd"], mesh, nb, **sq)
            gen = distribute(job["gen"], mesh, nb, **sq)
            b = distribute(job["b"], mesh, nb, row_mult=q)
            c = distribute(job["c"], mesh, nb, row_mult=q)
            for lower in (True, False):
                ld, ls = ppbtrf(spd, kd, lower)
                out["pbtrf_%s" % ("lower" if lower else "upper")] = (
                    _np(ld), _np(ls))
            out["pbsv"] = und(ppbsv(spd, kd, b))
            out["gbtrf"] = tuple(_np(t) for t in pgbtrf(gen, kl, ku))
            out["gbsv"] = und(pgbsv(gen, kl, ku, b))
            out["gbmm"] = und(pgbmm(job["alpha"], gen, kl, ku, b,
                                    job["beta"], c))
            low = distribute(np.tril(job["spd"]), mesh, nb, **sq)
            out["hbmm"] = und(phbmm(job["alpha"], low, kd, b))
            tri = distribute(job["tri"], mesh, nb, diag_pad=1.0, **sq)
            args = (Side.Left, Uplo.Lower, Op.NoTrans, Diag.NonUnit, tri, kd)
            out["tbsm"] = und(ptbsm(*args, b))
            out["tbsm_pivots"] = und(ptbsm(*args, b, pivots=job["pivots"]))
        elif job["op"] == "hesv":
            (l, d, e, ipiv), x = phesv(job["a"], job["b"], mesh, nb)
            out.update(l=und(l), d=_np(d), e=_np(e), ipiv=_np(ipiv),
                       x=_np(x), x_trs=_np(phetrs(l, d, e, ipiv, job["b"])))
        else:
            raise ValueError("rank_band_hesv: unknown op %r" % (job["op"],))
        return out

    with pinned(job.get("force")):
        out, launches, counters = _counted(run)
    out.update(rank=(mesh.r, mesh.c), launches=launches,
               collectives=counters)
    return out


def rank_qdwh(mesh, job: dict) -> dict:
    """One job of the QDWH tier on a replicated numpy input ``job["a"]``
    at tile ``job["nb"]`` and options ``job["opts"]``, under the job's
    pins ``job["force"]``; ``job["op"]`` is ``"ppolar"`` (U, H),
    ``"pheev_qdwh"`` (w, Z) or ``"psvd_qdwh"`` (σ, U, Vᴴ; a rectangular
    input takes the single-device fallback, whose warnings are
    returned).  Returns numpy (replicated), the ``qdwh.*`` counters (the
    step variants taken), the ``collective.*`` counters and the kernel
    launches of the run."""
    import warnings

    from . import pheev_qdwh, ppolar, psvd_qdwh, undistribute

    op, nb, opts = job["op"], job["nb"], job.get("opts")

    def und(x):
        return None if x is None else _np(undistribute(x))

    def run():
        if op == "ppolar":
            u, h = ppolar(job["a"], mesh, nb, opts)
            return {"u": _np(u), "h": _np(h)}
        if op == "pheev_qdwh":
            w, z = pheev_qdwh(job["a"], mesh, nb, job.get("jobz", True),
                              opts)
            return {"w": _np(w), "z": und(z)}
        if op == "psvd_qdwh":
            s, u, vh = psvd_qdwh(job["a"], mesh, nb, opts=opts)
            return {"s": _np(s), "u": und(u), "vh": und(vh)}
        raise ValueError("rank_qdwh: unknown op %r" % (op,))

    with pinned(job.get("force")), warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        out, launches, counters = _counted(run)
    out.update(rank=(mesh.r, mesh.c), launches=launches, counters=counters,
               warnings=[str(w.message) for w in ws
                         if issubclass(w.category, RuntimeWarning)])
    return out


# ---------------------------------------------------------------------------
# Rank body of the mixed drivers, pgetri, pgecondest and the resilience
# paths of pgetrf/ppotrf
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _env(**kw):
    """Environment variables set for the block (None unsets one)."""
    saved = {k: os.environ.get(k) for k in kw}
    try:
        for k, v in kw.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def rank_dist_mixed(mesh, job: dict) -> dict:
    """One job on replicated numpy inputs under the job's pins
    ``job["force"]``; ``job["op"]`` is

    * ``"mixed"``: ``spd``, ``gen`` (square) and ``b``: ``pposv_mixed``,
      ``pposv_mixed_gmres`` and ``pgesv_mixed`` of b (solutions and
      iteration counts), ``pgetri`` of gen and ``pgecondest`` of its LU
      with ‖gen‖₁ (``rcond``, ``est``);
    * ``"resilience"``: ``gen`` and ``spd``: pgetrf and ppotrf
      monolithic, under ``SLATE_TPU_TORCH_DIST_TIMELINE`` (window
      ``job["window"]``; the timeline's rows), pgetrf under
      ``SLATE_TPU_TORCH_CKPT_EVERY_STEPS=job["every"]`` with one injected
      ``step.boundary`` device loss (seed ``job["seed"]``), both under
      ``SLATE_TPU_TORCH_ABFT=correct`` (clean), and each ABFT envelope
      handed a factor with one exponent bit flipped on rank (0, 0)'s
      shard (it must detect and recompute).

    Returns numpy (this rank's shards for the bitwise comparisons,
    replicated results through :func:`~.dist.undistribute`), each
    path's ``abft.*`` / ``ckpt.*`` counters and the job's host wall
    (``wall_s``)."""
    from ..enums import Norm
    from ..perf import metrics
    from ..resilience import inject
    from . import (distribute, pgecondest, pgesv_mixed, pgetrf, pgetri,
                   pnorm, ppotrf, pposv_mixed, pposv_mixed_gmres,
                   undistribute)
    from .dist_factor import _ppotrf_abft_check
    from .dist_lu import _pgetrf_abft_check
    from .dist_util import timeline_steps

    nb, p, q = job["nb"], mesh.p, mesh.q
    sq = dict(diag_pad=1.0, row_mult=q, col_mult=p)
    out = {"rank": (mesh.r, mesh.c)}
    t0 = time.perf_counter()

    def counted(name, fn):
        metrics.on()
        before = metrics.snapshot()
        r = fn()
        c = metrics.snapshot_delta(before, metrics.snapshot())["counters"]
        out[name + "_counters"] = {k: v for k, v in c.items()
                                   if k.startswith(("abft.", "ckpt."))}
        return r

    with pinned(job.get("force")):
        if job["op"] == "mixed":
            spd, gen, b = job["spd"], job["gen"], job["b"]
            x, it = pposv_mixed(spd, b, mesh, nb)
            out["posv"] = (_np(undistribute(x)), it)
            x, it = pposv_mixed_gmres(spd, b, mesh, nb)
            out["posv_gmres"] = (_np(x), it)
            x, it = pgesv_mixed(gen, b, mesh, nb)
            out["gesv"] = (_np(undistribute(x)), it)
            gd = distribute(gen, mesh, nb, **sq)
            out["getri"] = _np(undistribute(pgetri(gd)))
            lu, gperm = pgetrf(gd)
            out["condest"] = pgecondest(lu, gperm,
                                        float(pnorm(gd, Norm.One)))
            out["wall_s"] = time.perf_counter() - t0
            return out
        if job["op"] != "resilience":
            raise ValueError("rank_dist_mixed: unknown op %r" % (job["op"],))
        gd = distribute(job["gen"], mesh, nb, **sq)
        sd = distribute(job["spd"], mesh, nb, **sq)

        def factors():
            lu, gperm = pgetrf(gd)
            return _np(lu.data), _np(gperm), _np(ppotrf(sd).data)

        out["mono"] = factors()
        with _env(SLATE_TPU_TORCH_DIST_TIMELINE=1,
                  SLATE_TPU_TORCH_DIST_TIMELINE_WINDOW=job["window"]):
            out["timeline"] = factors()
        out["timeline_rows"] = len(timeline_steps())
        with _env(SLATE_TPU_TORCH_CKPT_EVERY_STEPS=job["every"]):
            inject.install(inject.FaultPlan(seed=job["seed"]).add(
                "step.boundary", "device_loss", rate=0.5, count=1))
            try:
                lu, gperm = counted("ckpt", lambda: pgetrf(gd))
            finally:
                inject.clear_plan()
            out["ckpt"] = (_np(lu.data), _np(gperm))
        with _env(SLATE_TPU_TORCH_ABFT="correct"):
            out["abft"] = counted("abft", factors)
            lu, gperm, l = (torch.as_tensor(x, device=mesh.device)
                            for x in out["mono"])
            bad_lu, bad_l = lu.clone(), l.clone()
            if (mesh.r, mesh.c) == (0, 0):
                for t in (bad_lu, bad_l):
                    t[nb + 3, 1] *= 256.0      # in the lower triangle
            out["abft_lu_detect"] = counted("abft_lu_detect", lambda: _np(
                _pgetrf_abft_check(gd, bad_lu, gperm,
                                   lambda: (lu.clone(), gperm))[0]))
            out["abft_chol_detect"] = counted("abft_chol_detect", lambda: _np(
                _ppotrf_abft_check(sd, lambda: l.clone(), bad_l)))
    out["wall_s"] = time.perf_counter() - t0
    return out
