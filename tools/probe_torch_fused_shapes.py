#!/usr/bin/env python3
"""Probe of the port's fused kernels on one CUDA card at shapes the main
path does not give them: tall, wide and ragged-lane LU carries (every
step against its plain version from the same state, the full kernel
bitwise against the step chain, factor residual ≤ 3) and Cholesky with
tc < nb.  Exits 1 if any check fails.

    python3 tools/probe_torch_fused_shapes.py
"""
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from slate_tpu_torch.ops import _build, kernels
_build.build_all(["getrf_step_fused", "getrf_full_fused", "potrf_step_fused", "potrf_full_fused"])
dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(11)
def rel(x, y): return float((x.double() - y.double()).norm() / y.double().norm())
ok = True
for (m, n, nb) in ((3072, 2048, 512), (2048, 3072, 512), (2568, 2048, 512), (1024, 768, 128), (640, 1024, 128)):
    # A is (m, n): carry (n, m) = (n_rows, lanes)
    A = torch.randn(m, n, device=dev, generator=g)
    at0 = A.T.contiguous(); one = torch.ones(1, m, device=dev)
    ktot = min(m, n)
    for update in (True, False):
        ck, act, pivs, worst = at0.clone(), one, [], 0.0
        for k0 in range(0, ktot, nb):
            before = ck.clone()
            _, p, a2, x = kernels.getrf_step_fused(ck, act, k0, nb=nb, update=update)
            cp = before.clone()
            _, rp, ra, rx = kernels.getrf_step_fused_plain(cp, act, k0, nb=nb, update=update)
            torch.cuda.synchronize()
            same = torch.equal(p, rp) and torch.equal(a2, ra)
            r = rel(ck, cp)
            worst = max(worst, r)
            if not same or r > 1e-4 or not torch.equal(ck[:k0], before[:k0]):
                ok = False
                print("FAIL step m=%d n=%d nb=%d upd=%s k0=%d piv eq %s rel %.3e" % (m, n, nb, update, k0, same, r), flush=True)
            act = a2; pivs.append(p)
        if update:
            cf = at0.clone(); _, pf, af = kernels.getrf_full_fused(cf, one, nb=nb)
            torch.cuda.synchronize()
            bw = torch.equal(cf, ck) and torch.equal(pf, torch.cat(pivs)) and torch.equal(af, act)
            lu = cf[:, pf].T.double() if m <= n else None
            perm = pf
            if m > n:
                rest = torch.argsort((af[0] < 0.5).to(torch.int8), stable=True)[: m - ktot]
                perm = torch.cat([pf, rest])
            lu = cf[:, perm].T.double()
            low = torch.tril(lu[:, :ktot], -1) + torch.eye(m, ktot, dtype=torch.float64, device=dev)
            res = float((low @ torch.triu(lu[:ktot]) - A.double()[perm]).norm() / (A.double().norm() * 1.19e-7 * max(m, n)))
            print("m=%d n=%d nb=%d: steps vs plain worst rel %.3e; full == chain %s; residual %.3g" % (m, n, nb, worst, bw, res), flush=True)
            ok = ok and bw and res <= 3
for n, nb, tc in ((1536, 512, 128), (1536, 512, 256), (1024, 256, 128)):
    r = torch.randn(n, n, device=dev, generator=g); spd = (r + r.T) / 2 + n * torch.eye(n, device=dev)
    ak, worst = spd.clone(), 0.0
    for k0 in range(0, n, nb):
        before = ak.clone()
        kernels.potrf_step_fused(ak, k0, nb=nb, tc=tc)
        ap = kernels.potrf_step_fused_plain(before.clone(), k0, nb=nb, tc=tc)
        torch.cuda.synchronize()
        worst = max(worst, rel(ak, ap))
        # the untouched upper tiles must stay bitwise
        if not torch.equal(torch.triu(ak, 1)[:k0], torch.triu(before, 1)[:k0]):
            ok = False; print("FAIL potrf upper rows", flush=True)
    af = spd.clone(); kernels.potrf_full_fused(af, nb=nb, tc=tc)
    torch.cuda.synchronize()
    L = torch.tril(af).double()
    res = float((L @ L.T - spd.double()).norm() / (spd.double().norm() * 1.19e-7 * n))
    print("potrf n=%d nb=%d tc=%d: steps vs plain worst rel %.3e; full == chain %s; residual %.3g" % (n, nb, tc, worst, torch.equal(af, ak), res), flush=True)
    ok = ok and worst <= 1e-4 and torch.equal(af, ak) and res <= 3
print("ALL OK" if ok else "SOME FAILED")
sys.exit(0 if ok else 1)
