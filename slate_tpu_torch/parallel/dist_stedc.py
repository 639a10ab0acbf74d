"""Distributed divide-and-conquer tridiagonal eigensolver — the
counterpart of ``slate_tpu/parallel/dist_stedc.py`` (reference
``src/stedc.cc``, ``stedc_deflate.cc``, ``stedc_merge.cc``,
``stedc_secular.cc``, ``stedc_z_vector.cc``).

The JAX package's split, over one process per grid position:

* **host** (every rank, on replicated data): the O(n) control of each
  merge — the pole sort, the deflation scan and its Givens list, the
  waves they are grouped into (``linalg._stedc``'s ``dlaed2`` lineage);
  the leaves at or below ``host_cutoff`` are dealt round the ranks, each
  solved by one and its values and rows sent to all;
* **device**: the secular bisection (``dlaed4``), the Gu–Eisenstat ẑ
  (``dlaed3``), the secular vectors and the combine matrix R = P·G·M,
  all replicated on every rank, and the update ``[Q₁·R_top; Q₂·R_bot]``.

Q is never replicated.  Each rank holds a fixed set of Q's global rows
for the whole solve (:func:`pstedc_rows`: pairs of rows dealt round the
ranks), so the combine and the decoupled interleave are local row by
row and no merge moves Q.  The JAX package row-shards each sub-problem's
Q over every device and leaves the resharding to XLA.  What a merge
communicates is the coupling vector's two boundary rows, which live on
one rank each: one ``psum`` of a placed (n₁ + n₂) buffer, so every rank
builds z, and so every host decision, from the same bits.

The (k, k) secular temporaries are the largest arrays of the solve:
the bisection runs over column chunks of the roots (each root's
iteration is independent, so the chunking does not change a value) and
ẑ over row chunks.
"""

from __future__ import annotations

import numpy as np
import torch

from ..linalg._stedc import _steqr_base, stedc_deflate, stedc_z_vector
from .dist_util import _move, _stage
from .mesh import BOTH

__all__ = ["pstedc", "pstedc_rows"]

#: merges at or below this size stay on the host (cutoff² bounded)
_HOST_CUTOFF = 512
#: base sub-problems handed to the host QR/stevd solver
_BASE = 256
#: bytes of one (k, chunk) temporary of the secular stages
_CHUNK_BYTES = 256 << 20


def pstedc_rows(n: int, mesh) -> np.ndarray:
    """The global rows of Q (n×n) this rank holds, ascending: pairs of
    rows (2i, 2i + 1) dealt round the p·q ranks in row-major grid order,
    so a Golub–Kahan vector's u row and v row stay together."""
    return _dealt_rows(n, mesh.p * mesh.q, mesh.r * mesh.q + mesh.c)


def _dealt_rows(n: int, nranks: int, rank: int) -> np.ndarray:
    g = np.arange(n)
    return g[(g // 2) % nranks == rank]


def _chunk(k: int) -> int:
    return max(1, min(k, _CHUNK_BYTES // (8 * max(k, 1))))


def _secular_device(dk, zk, rho: float, device, iters: int = 110):
    """Vectorized secular bisection (``dlaed4``) on ``device``, replicated
    on every rank: ``f(λ) = 1 + ρ·Σⱼ zⱼ²/(dⱼ − λ)``, each root bisected
    110 times from the pole it is nearer to, over column chunks of the
    roots.  Mirrors :func:`slate_tpu_torch.linalg._stedc.stedc_secular`.
    Returns ``(lam (k,), dmat (k, k))`` with ``dmat[j, i] = dⱼ − λᵢ``
    free of cancellation."""
    dkd = torch.from_numpy(np.ascontiguousarray(dk)).to(device)
    z2 = torch.from_numpy(np.ascontiguousarray(zk)).to(device)
    z2 = z2 * z2
    k = dkd.shape[0]
    upper = torch.cat([dkd[1:], (dkd[-1] + rho * z2.sum()).reshape(1)])
    gap = upper - dkd
    lam = torch.empty(k, dtype=torch.float64, device=device)
    dmat = torch.empty((k, k), dtype=torch.float64, device=device)
    cw = _chunk(k)
    for c0 in range(0, k, cw):
        c1 = min(k, c0 + cw)
        mid = dkd[c0:c1] + 0.5 * gap[c0:c1]
        fmid = 1.0 + rho * (z2[None, :] / (dkd[None, :] - mid[:, None])).sum(1)
        from_lower = fmid >= 0.0
        sigma = torch.where(from_lower, dkd[c0:c1], upper[c0:c1])
        zero = torch.zeros_like(sigma)
        lo = torch.where(from_lower, zero, -0.5 * gap[c0:c1])
        hi = torch.where(from_lower, 0.5 * gap[c0:c1], zero)
        delta = dkd[:, None] - sigma[None, :]
        for _ in range(iters):
            mu = 0.5 * (lo + hi)
            f = 1.0 + rho * (z2[:, None] / (delta - mu[None, :])).sum(0)
            up = torch.where(torch.isnan(f), torch.zeros_like(from_lower),
                             f < 0.0)
            lo, hi = torch.where(up, mu, lo), torch.where(up, hi, mu)
        mu = 0.5 * (lo + hi)
        lam[c0:c1] = sigma + mu
        dmat[:, c0:c1] = delta - mu[None, :]
    return lam, dmat


def _zhat_device(dkd, dmat, zkd):
    """Gu–Eisenstat ẑ recomputation (``dlaed3``) on the device, over row
    chunks: ẑⱼ² = |∏ᵢ (dⱼ − λᵢ)/(dᵢ − dⱼ) · (dⱼ − λⱼ)|, the i = j factor
    left out of the product (:func:`slate_tpu_torch.linalg._stedc.
    _gu_eisenstat_z`)."""
    k = dkd.shape[0]
    zhat = torch.empty(k, dtype=torch.float64, device=dkd.device)
    rw = _chunk(k)
    for r0 in range(0, k, rw):
        r1 = min(k, r0 + rw)
        loc = torch.arange(r1 - r0, device=dkd.device)
        glob = loc + r0
        diff_d = dkd[None, :] - dkd[r0:r1, None]
        diff_d[loc, glob] = 1.0
        ratio = -dmat[r0:r1] / diff_d
        ratio[loc, glob] = 1.0
        zhat2 = (torch.prod(ratio, dim=1) * (-dmat[glob, glob])).abs()
        sign = torch.where(zkd[r0:r1] < 0, -1.0, 1.0).to(torch.float64)
        zhat[r0:r1] = sign * torch.sqrt(zhat2)
    return zhat


def _build_vs(zhat, dmat, dkd):
    """Secular eigenvector columns from ẑ and the pole differences, a
    collapsed interval (a root on its pole) giving that pole's unit
    vector (``dlaed3``)."""
    tiny = (torch.finfo(torch.float64).tiny ** 0.5
            * max(float(dkd.abs().max()), 1.0))
    gap, pole = dmat.abs().min(dim=0)
    small = dmat.abs() < tiny
    dmat_c = torch.where(small, torch.where(dmat < 0, -tiny, tiny), dmat)
    del small
    vs = zhat[:, None] / dmat_c
    del dmat_c
    vs = vs / vs.abs().amax(dim=0, keepdim=True)
    vs = vs / torch.linalg.vector_norm(vs, dim=0, keepdim=True)
    collapsed = gap < tiny
    if bool(collapsed.any()):
        onehot = (torch.arange(vs.shape[0], device=vs.device)[:, None]
                  == pole[None, :]).to(vs.dtype)
        vs = torch.where(collapsed[None, :], onehot, vs)
    return vs


def _build_r(vs, keep_idx, defl_idx, ga, gb, gc, gs, inv_order, order2,
             n: int):
    """Combine matrix R = P·G·M (see :func:`_merge_device`), replicated:
    M scatters the secular columns to the kept poles' rows and identity
    columns to the deflated ones; the deflation Givens act on M's rows
    in waves of disjoint pairs (row_a += (c − 1)·row_a + s·row_b, row_b
    += −s·row_a + (c − 1)·row_b, as the JAX package's delta form; the
    padding lanes a = b = 0, c = 1, s = 0 add exact zeros); P un-permutes
    the rows and ``order2`` sorts the columns by eigenvalue."""
    dev = vs.device
    k = vs.shape[1]
    m = torch.zeros((n, n), dtype=torch.float64, device=dev)
    if k:
        m[:, :k].index_copy_(0, keep_idx, vs)
    if defl_idx.shape[0]:
        m[defl_idx, torch.arange(k, n, device=dev)] = 1.0
    for i in range(ga.shape[0]):
        a, b = ga[i], gb[i]
        c, s_ = gc[i][:, None], gs[i][:, None]
        ra, rb = m[a], m[b]
        m.index_add_(0, a, (c - 1.0) * ra + s_ * rb)
        m.index_add_(0, b, -s_ * ra + (c - 1.0) * rb)
    return m.index_select(0, inv_order).index_select(1, order2)


def _combine(q1, q2, r):
    """This rank's rows of ``[Q₁·R_top; Q₂·R_bot]``."""
    n1 = q1.shape[1]
    return torch.cat([torch.matmul(q1, r[:n1]), torch.matmul(q2, r[n1:])])


def _decoupled_combine(q1, q2, order):
    """This rank's rows of ``diag(Q₁, Q₂)`` with its columns in ``order``
    (ρ = 0: the two halves' eigenpairs interleaved by value)."""
    n1 = q1.shape[1]
    n = n1 + q2.shape[1]
    out = torch.zeros((q1.shape[0] + q2.shape[0], n), dtype=q1.dtype,
                      device=q1.device)
    first = np.flatnonzero(order < n1)
    second = np.flatnonzero(order >= n1)
    dev = q1.device
    out[:q1.shape[0], torch.as_tensor(first, device=dev)] = q1[:, torch.as_tensor(
        order[first], device=dev)]
    out[q1.shape[0]:, torch.as_tensor(second, device=dev)] = q2[:, torch.as_tensor(
        order[second] - n1, device=dev)]
    return out


def _waves(givens):
    """Group the rotations into waves of pairwise-disjoint index pairs
    (a rotation lands one wave after the last one sharing an index),
    applied last-recorded-first, padded to power-of-two (nwaves,
    wave_len) with identity lanes: ``(ga, gb, gc, gs)``."""
    waves = []
    last_wave = {}
    for (a, b, c, s_) in reversed(givens):
        wv = max(last_wave.get(a, -1), last_wave.get(b, -1)) + 1
        if wv == len(waves):
            waves.append([])
        waves[wv].append((a, b, c, s_))
        last_wave[a] = wv
        last_wave[b] = wv
    nw_pad = 1
    while nw_pad < max(len(waves), 1):
        nw_pad *= 2
    lw_pad = 1
    while lw_pad < max((len(w) for w in waves), default=1):
        lw_pad *= 2
    ga = np.zeros((nw_pad, lw_pad), np.int64)
    gb = np.zeros((nw_pad, lw_pad), np.int64)
    gc = np.ones((nw_pad, lw_pad))
    gs = np.zeros((nw_pad, lw_pad))
    for wv, rots in enumerate(waves):
        for i, (a, b, c, s_) in enumerate(rots):
            ga[wv, i], gb[wv, i], gc[wv, i], gs[wv, i] = a, b, c, s_
    return ga, gb, gc, gs


def _merge_device(d1, q1, d2, q2, e_mid: float, mesh, last1: bool,
                  first2: bool):
    """One rank-one merge with Q's rows kept where they are: ``q1`` /
    ``q2`` are this rank's rows of the two sub-problems' eigenvectors,
    ``d1`` / ``d2`` their eigenvalues (host, replicated), ``last1`` /
    ``first2`` whether this rank holds sub-problem 1's last row and
    sub-problem 2's first.  Returns ``(w, q)``: the merged eigenvalues
    (host, ascending, replicated) and this rank's rows of the merged Q.

    The control flow (sort, deflate, Givens) is
    :func:`slate_tpu_torch.linalg._stedc.stedc_merge`'s; the eigenvector
    update is one combine matrix R, so the merge is two local products
    (the reference's distributed ``stedc_merge`` gemm)."""
    n1, n2 = d1.size, d2.size
    n = n1 + n2
    dev = mesh.device
    rho = 2.0 * abs(float(e_mid))
    if rho == 0.0:
        d = np.concatenate([d1, d2])
        order = np.argsort(d, kind="stable")
        return d[order], _decoupled_combine(q1, q2, order)

    # the boundary rows live on one rank each: one placed psum
    edge = torch.zeros(n, dtype=torch.float64, device=dev)
    if last1:
        edge[:n1] = q1[-1]
    if first2:
        edge[n1:] = q2[0]
    edge = mesh.psum(edge, BOTH).cpu().numpy()
    z = stedc_z_vector(edge[:n1], edge[n1:], sign=np.sign(float(e_mid)))
    d = np.concatenate([d1, d2])
    order = np.argsort(d, kind="stable")
    d_s, z_s = d[order], z[order]
    keep, d_u, z_u, givens = stedc_deflate(d_s, z_s, rho)
    dk, zk = d_u[keep], z_u[keep]
    k = int(keep.sum())

    w = np.empty(n)
    w[k:] = d_u[~keep]
    if k:
        lam, dmat = _secular_device(dk, zk, rho, dev)
        dkd = torch.from_numpy(dk).to(dev)
        zhat = _zhat_device(dkd, dmat, torch.from_numpy(zk).to(dev))
        w[:k] = lam.cpu().numpy()
        vs = _build_vs(zhat, dmat, dkd)
        del dmat
    else:
        vs = torch.zeros((n, 0), dtype=torch.float64, device=dev)

    order2 = np.argsort(w, kind="stable")
    ga, gb, gc, gs = _waves(givens)

    def t(x):
        return torch.as_tensor(x, device=dev)

    r = _build_r(vs, t(np.flatnonzero(keep)), t(np.flatnonzero(~keep)),
                 t(ga), t(gb), t(gc), t(gs),
                 t(np.argsort(order, kind="stable")), t(order2), n)
    del vs
    return w[order2], _combine(q1, q2, r)


def _host_solve(d, e):
    """Host D&C below the distribution cutoff (bounded memory)."""
    from ..linalg._stedc import stedc_solve

    if d.size <= _BASE:
        return _steqr_base(d, e)
    return stedc_solve(d, e)


def _solve_leaves(d, e, bounds, rows: np.ndarray, mesh) -> list:
    """The host leaves [lo, hi) of ``bounds`` dealt round the ranks, leaf
    i on rank i mod p·q: each rank solves its share, then one ``psum`` of
    the placed eigenvalues and one move of the leaves' eigenvector rows
    (:func:`~.dist_util._move`) give every rank each leaf's values and
    its own ``rows`` of each leaf's Q — the bits the leaf's owner
    computed.  Returns ``[(lo, hi, w, q_rows)]``."""
    nr, me = mesh.p * mesh.q, mesh.r * mesh.q + mesh.c
    dev = mesh.device
    leaves = list(zip(bounds[:-1], bounds[1:]))
    wid = max(hi - lo for lo, hi in leaves)
    w_all = torch.zeros(d.size, dtype=torch.float64, device=dev)
    held, blocks = [], []
    for lo, hi in leaves[me::nr]:
        w, q = _host_solve(d[lo:hi], e[lo:hi - 1])
        w_all[lo:hi] = torch.from_numpy(np.ascontiguousarray(w)).to(dev)
        blk = np.zeros((hi - lo, wid))
        blk[:, :hi - lo] = q
        held.append(np.arange(lo, hi))
        blocks.append(blk)
    mesh.psum(w_all, BOTH)
    x = torch.from_numpy(np.concatenate(blocks) if blocks
                         else np.zeros((0, wid))).to(dev)
    cols = np.arange(wid)
    qs = _move(mesh, x, np.concatenate(held) if held
               else np.zeros(0, dtype=np.int64), cols,
               lambda r: (_dealt_rows(d.size, nr, r), cols))
    w_all = w_all.cpu().numpy()
    out = []
    for lo, hi in leaves:
        sel = torch.as_tensor(np.flatnonzero((rows >= lo) & (rows < hi)),
                              device=dev)
        out.append((lo, hi, w_all[lo:hi].copy(),
                    qs.index_select(0, sel)[:, :hi - lo].contiguous()))
    return out


def pstedc(d, e, mesh, host_cutoff: int = _HOST_CUTOFF):
    """Distributed D&C tridiagonal eigensolver — reference
    ``slate::stedc`` (``src/stedc.cc``).  Returns ``(w, q)``: ``w`` the
    eigenvalues (host, ascending, the same on every rank) and ``q`` this
    rank's rows :func:`pstedc_rows` of the eigenvector matrix, an fp64
    tensor on the mesh's device.

    Every rank tears T into ~``host_cutoff`` leaves (Cuppen: |e| taken
    off both neighbours of a tear), solves its share of them on the host
    (:func:`_solve_leaves`) and merges them pairwise bottom up
    (:func:`_merge_device`).  With metrics on,
    the timers ``pstedc.leaves`` and ``pstedc.merges`` split its wall."""
    d = np.asarray(d, dtype=np.float64)
    e = np.asarray(e, dtype=np.float64)
    n = d.size
    rows = pstedc_rows(n, mesh)
    if n <= host_cutoff:
        _, _, w, q = _solve_leaves(d, e, [0, n], rows, mesh)[0]
        return w, q

    nsplit = int(np.ceil(n / host_cutoff))
    bounds = [round(i * n / nsplit) for i in range(nsplit + 1)]
    d_adj = d.copy()
    for b in bounds[1:-1]:
        em = e[b - 1]
        d_adj[b - 1] -= abs(em)
        d_adj[b] -= abs(em)

    with _stage("pstedc.leaves", mesh):
        probs = _solve_leaves(d_adj, e, bounds, rows, mesh)
    mine = set(rows.tolist())
    with _stage("pstedc.merges", mesh):
        while len(probs) > 1:
            nxt = []
            for i in range(0, len(probs) - 1, 2):
                lo1, hi1, w1, q1 = probs[i]
                lo2, hi2, w2, q2 = probs[i + 1]
                w, q = _merge_device(w1, q1, w2, q2, e[hi1 - 1], mesh,
                                     hi1 - 1 in mine, lo2 in mine)
                nxt.append((lo1, hi2, w, q))
            if len(probs) % 2:
                nxt.append(probs[-1])
            probs = nxt
    _, _, w, q = probs[0]
    return w, q
