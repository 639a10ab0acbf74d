#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``slate_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (``nvidia-smi``) and builds
   every kernel from ``slate_tpu_torch/csrc`` (``nvcc``, one process per
   source, into ``build/slate_tpu_torch/``).
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it, and times kernel, plain version and a
   library yardstick with CUDA events (the yardstick is timed here only;
   the port never calls it in place of a kernel).  ``matmul`` at the
   strip update (1e-5 of its plain version), then its relative error to
   the fp64 product of the same operands within 4× of ``torch.matmul``'s
   (fp32, TF32 off) at the strip update, 8192³ and geqrf's YᵀY and Yᵀ·C
   at K = 32768 (each printed with its parts of K), two pairs of views
   at storage offset 1 through the register-staged instantiation (A
   K-fast with B row-fast, A row-fast with B K-fast; 1e-5 of its plain
   version, 4× to fp64), and NaNs made on the card in a row of A and a
   column of B, through split-K, NaN in those of C and nowhere else; the
   QR shapes timed with their parts of K and with one.  ``chol_inv_panel`` on
   the 512² diagonal block of the (8192, 8192) carry and on the 256²
   diagonal block of pposv's (16384, 256) panel, both views with stale
   values above the diagonal: 1e-4 of its plain version, factor residual
   < 1e-5 and ‖L·L⁻¹ − I‖ < 1e-4; timed at both.  ``trtri_panel`` on a
   256² tile of that factor (row stride 512, potri's shape) and on the
   whole 512² factor (geqrf's T block): 1e-4 of its plain version and
   ‖L·L⁻¹ − I‖ < 1e-4 at both, timed at both beside
   ``solve_triangular``, with its launch route (one cluster or a
   cooperative grid) and blocks.
   The LU panel kernels are held to the same pivots as their plain
   versions (a near-tie, within 1e-5 relative, is printed and excepted),
   to a panel residual < 60 and to ‖L11·linv − I‖ < 1e-3, at the main
   paths' shapes (the leaf cluster's lanes in registers) and at the
   (256, 16384) slab and a (1024, 12144) carry (in shared memory);
   ``getrf_panel_linv``'s slab, pivots, mask and linv bitwise
   ``getrf_step_fused(update=False)``'s panel at nb = 256, ib = 32, with
   every lane active and with the lanes of two fused panels retired;
   each prints its grid, cluster, registers and shared memory and a
   "redesign" line beside its time before the redesign; the batched
   kernels (phase 2c) at (B, n) = (16, 32), (16, 64), (16, 128) and
   (64, 256), and both routes of each at their boundary (B = 4: the
   largest n of the on-chip route, the smallest of the L2 route), to the
   same pivots, per-problem factor residuals ≤ 3 and 1e-4 of their plain
   versions; each launch's plan (route, cluster, registers, spill,
   shared memory) printed, both timed at (64, 256) and at the served
   (16, 256) with a "redesign" line beside their times before the
   on-chip redesign.  The fused and full kernels of potrf and
   getrf (phase 2d) at n = 2048 and at the main path's n = 8192, nb =
   512: the Cholesky step at k0 = 0 (and 512 at n = 2048), every LU step
   with ``update`` on (and off at n = 2048; the first step off at 8192),
   each from the same state as its plain version, to the same pivots and
   1e-4 of it; the Cholesky step's L11 bitwise ``chol_inv_panel``'s L of
   the same block and every LU step's panel rows, pivots, mask and L11⁻¹
   bitwise ``getrf_panel_fused``'s from the same state (witnesses apart
   from the step kernels, which run the full kernels' own code); the full
   kernels bitwise equal to the chain of their step kernels and to factor
   residuals ≤ 3; whole factorizations against
   the plain ones within 1e-4 (Cholesky) or, for LU, whose factors drift
   apart over steps of different rounding, with pivots equal up to a
   near-tie (within 1e-5 relative in one of the two factors; at n = 8192
   the drift passes that width, and the first departure is printed) and
   the drift printed; then each timed at n = 8192, the LU step also
   without its update, the grid, registers and shared memory of
   ``getrf_full_fused`` and the two step kernels printed, and a
   "redesign" line for each step kernel beside its time before its
   redesign (``getrf_full_fused``'s launches on the ``lu_full`` path are
   printed after phase 3e).  ``lu_inv_panel``
   (phase 2e) at nb = 32, 64, 128, 256 and 512 on diagonally dominant
   blocks and at 512 on the B[:512] block of the first CholQR² panel of
   the QR path's input: each output within 1e-4 of its plain version,
   ‖L·U − A‖/(‖A‖·ε·nb) ≤ 3, ‖L·L⁻¹ − I‖ and ‖U·U⁻¹ − I‖ < 1e-3; timed
   at 512 on the B block and at 256 on the dominant block.  Phase 2f runs ``geqrf`` of the QR path's
   input and ``ungqr`` of its factor once with every call of
   ``matmul``, ``chol_inv_panel``, ``lu_inv_panel`` and ``trtri_panel``
   held to its plain version on the same arguments (``matmul`` ≤ 1e-5,
   the panel kernels ≤ 1e-4; ``trtri_panel`` also ‖L·L⁻¹ − I‖ < 1e-4):
   the transposed-A products with K up to 32768 and the panel kernels
   at 512 on each panel's own blocks.  ``hb2st_wavefront`` (phase 2g) at
   (n, kd) = (1024, 64) and (1024, 256) in fp32 and fp64 on bench.py-style
   random wide bands, and in three sweep-range chunks at (1024, 64) fp64:
   fp64 band, log and a back-transformed probe within 1e-9·max|band| of
   the plain version; fp32 within 5e-3·max|band| over the first 64
   sweeps (the chase's forward error is not stable past them: at
   kd = 256 the plain version in fp32 departs from itself in fp64 by
   O(1) band entries, printed); every
   whole chase, kernel and plain, to the backward gates
   ‖A·Q₂ − Q₂·T‖/(‖A‖·n·ε) ≤ 3 and ‖Q₂ᵀQ₂ − I‖/(n·ε) ≤ 3, and its
   eigenvalues within 1e-3 (fp32) / 1e-10 (fp64) of eigvalsh.  At the
   main paths' calls, (8192, 256) fp32 and (4096, 256) fp64, on their
   grid: 64 sweeps at the start, the middle and the end of the chase,
   kernel and plain version from the same band, within the same
   tolerances, and the kernel's whole chase to the backward gates; then
   timed there, with the barriers alone (every chunk's departure printed
   beside max|band|); each main call's plan (clusters x blocks of a
   cluster, the route, registers, shared memory) held to ops/smem.py's
   plan on the card's cluster occupancy, and a ``redesign`` line beside
   its time before the cluster redesign; the band (L2) route gated at the
   narrowest kd that takes it, n = 2·kd + 16, fp32 and fp64, with the
   same checks.  ``tb2bd_wavefront`` (phase 2h) likewise, its plain
   version on a host copy of the band, on ge2tb bands of Gaussians at
   (1024, 64) and (1024, 256) in fp32 and fp64 and in three range chunks
   at (1024, 64) fp64: fp64 band and both logs within 1e-9·max|band|,
   fp32 within 5e-3·max|band| over the first 64 sweeps, every whole chase
   to ‖B·V₂ − U₂·bidiag(d, e)‖/(‖B‖·n·ε), ‖U₂ᵀU₂ − I‖/(n·ε) and
   ‖V₂ᵀV₂ − I‖/(n·ε) ≤ 3 and σ of (d, e) within 1e-3 (fp32) / 1e-10
   (fp64) of torch.linalg.svdvals; a Gaussian triangular band printed,
   not gated (numerically singular); then at the svd paths' (8192, 256)
   fp32 and (4096, 256) fp64 calls the three 64-sweep windows and the
   whole chase, timed with the barriers alone.  The tile kernels
   (phase 2j): ``tile_norms`` on the (4096, 256, 256) tile batch of a
   16384² fp32 Gaussian and the (1024, 256, 256) batch of an 8192² fp64
   one (max bitwise, fro within 1e-5 / 1e-12 relative, a NaN tile NaN
   for both), ``tzset``/``tzscale`` (lower and upper; the strict
   triangle, the diagonal and the other triangle each bitwise and each
   what the op leaves there), ``geadd`` (bitwise; β = 0 keeps a NaN of
   B) and ``gescale_row_col`` (bitwise) on the 16384² fp32 and 8192²
   fp64 matrices and at (384, 640) and (640, 384) with 128-tiles; each
   timed at 16384² fp32 beside its bytes bound, its plain version and
   ``vector_norm(inf)`` (max) or a torch composition.  The two kernels
   of the split-precision products (phase 2k), which replace XLA dots of
   the JAX package, not Pallas kernels: ``split_matmul`` at split3 and
   split6 on (7680, 512)·(512, 2048) with B a transposed view (the fp32
   leg's trailing strip) and on a ragged (1000, 300)·(300, 777), the
   kernel and its plain version componentwise within the JAX tests'
   envelope to the fp64 product (4·(2⁷ + 3k)·ε₃₂·|A||B| for split3,
   4·3k·ε₃₂·|A||B| for split6), split6 also within 8·ε₃₂·|A||B|, which
   split3 must exceed, and the kernel within 4·√k·ε₃₂·|A||B| of its
   plain version, timed beside ``torch.matmul`` fp32 and the 3xTF32
   ``matmul``; ``ozaki_matmul`` on (7680, 512)·(512, 2048), 512³, 2048³
   and (64, 3·65536 + 17)·(3·65536 + 17, 64) (the whole chunked
   ``matmul_f64``), bitwise its plain version and within 1e-12 of
   |A||B| of the fp64 product, timed beside DGEMM, and at nine slices
   on 512³ bitwise its plain version within 1e-14.
3. Drives the main paths through the public entry points, with the
   reference tester's scaled-residual gates (≤ 3):
   * Cholesky: ``posv`` of an n = 8192 fp32 HermitianMatrix (nb = 256,
     so 512-wide panels) with 128 right-hand sides, ``potri`` of its
     factor and ``gemm`` at 8192, and a ``torch.profiler`` device split
     of one more ``posv``;
   * LU: ``gesv`` of an n = 8192 Gaussian Matrix (nb = 256) with 128
     right-hand sides through the scattered driver (the default sites),
     ``gesv`` again through the blocked recursion
     (``config.scattered_lu`` off) and ``getri`` of the first factor,
     plus |L| ≤ 1 + 100ε; the first column where the two drivers' pivots
     differ is printed with both candidates' magnitudes, and one more
     profiled ``gesv`` per driver prints its device time by kernel;
   * batched: ``posv_batched`` and ``gesv_batched`` of 64 problems of
     n = 256 on bench.py's inputs, each one launch of its kernel, every
     problem's residual ≤ 3 by bench.py's criterion;
   * serve: ``serve.warm_start`` for posv and gesv at n = 256 and batch
     16, then 192 posv and 192 gesv requests from 4 threads through a
     ``BatchQueue``: every answer's residual ≤ 3, no retry, singles
     fallback, short circuit, error or on-demand build, each kernel
     launched once per batched dispatch of its op; prints requests/s
     and the p50/p99 latency from submit to future resolution;
   * depths: ``posv`` at the ``fused`` and ``full`` depths and ``gesv`` at
     ``fused_trsm``, ``fused`` and ``full`` (n = 8192, 128 right-hand
     sides), each pinned through ``SLATE_TPU_TORCH_AUTOTUNE_FORCE``, which
     this script sets per path: residuals ≤ 3, |L| ≤ 1 + 100ε, exact
     launch counts (16 step launches or 1 full launch, and none of the
     composed depth's panel kernel), the first column where each LU
     depth's pivots depart from the composed depth's, the median wall of
     every depth, and a ``torch.profiler`` split of posv and gesv at full;
   * QR: ``geqrf`` of an m = 32768, n = 4096 Gaussian Matrix (nb = 256,
     so 512-wide CholQR² panels; bench.py's config 4): exactly 8
     ``lu_inv_panel``, 16 ``chol_inv_panel`` and 8 ``trtri_panel``
     launches, the conditioning guard not tripped (``devmax`` printed),
     bench.py's Gram identity, ``ungqr``'s orthogonality
     max|QᵀQ − I|/(ε·m) (tester.py) and ‖A − Q·R‖/(‖A‖·ε·m), each ≤ 3;
     the median wall of 3 calls beside ``torch.geqrf``'s, and a
     ``torch.profiler`` split; then ``gels`` with one right-hand side
     under Auto (CholQR, m ≥ 3n), with ``method_gels=QR`` and on the
     transposed (minimum-norm) shape, each gated by bench.py's
     normal-equations residual ≤ 3;
   * guard: ``geqrf`` of an (8192, 1024) input of condition 1e6 built
     on the host: the departure ``devmax`` ≥ 0.25, one Householder rerun,
     orthogonality and reconstruction ≤ 3;
   * eigensolver: ``heev`` of bench.py's heev_fp32 input (n = 8192,
     nb = 256, vectors): one ``hb2st_wavefront`` launch, no band or log
     byte between host and card (``chase.host_bytes`` 0), bench.py's
     residual ‖A·Z − Z·W‖/(‖A‖·n·10ε) and ‖ZᵀZ − I‖/(n·10ε) ≤ 3,
     eigenvalues within 1e-3 of eigvalsh; the wall of one more call with the
     stage timers beside ``torch.linalg.eigh``'s, a profiler split; one
     more heev with every ``matmul`` call held to its plain version, as
     phase 2f does (and one more hegv with its ``matmul`` and
     ``chol_inv_panel`` calls); heev
     fp64 at n = 4096 under the same gates; ``heev_vals`` at n = 2048
     through the host Givens chase and ``hegv`` itype 1 at n = 2048
     against ``scipy.linalg.eigh(a, b)``;
   * SVD: ``svd`` of bench.py's svd_fp32 input (a Gaussian n = 8192,
     nb = 256, U and Vᴴ): one ``tb2bd_wavefront`` launch, no band or
     log byte between host and card, bench.py's residual
     ‖A − U·Σ·Vᴴ‖/(‖A‖·n·10ε) and both orthogonalities ≤ 3, σ within
     1e-3·σ_max of svdvals; the first call's wall with the stage timers
     beside ``torch.linalg.svd``'s, a profiler split,
     one more ``ge2tb`` with every ``matmul`` call held to its plain
     version; svd fp64 at n = 4096, ``svd_vals`` at 2048 through the
     host Givens chase, and a tall (8192, 2048) svd and its transpose;
   * distributed (BASELINE.md's config 3, fp32, n = 16384, nb = 256, 128
     right-hand sides): phase 2i holds ``chol_l21_panel`` at the (16384,
     256) panel and ``lu_u12_panel`` at (256, 16384) and (256, 256) to
     their plain versions (1e-4 relative; the departure within 4× of its
     plain value with the guard's verdict; ‖X·Lᵀ − panel‖ and
     ‖L11·U − B‖ relative ≤ 1e-5; ``chol_l21_panel``'s L bitwise
     ``chol_inv_panel``'s L of the same block, also at nb = 128 and
     1024), the departure where the data set it
     (past the 1e-2 guard on an N(0, 1) unit-lower L11; 1e-4 relative
     with a strict upper part in L11), and times them beside their
     bounds (``lu_u12_panel`` also at (256, 4096), the widest solve of
     the checked 4096 runs); phase 3j runs
     ``pgemm``, ``pposv`` and ``pgesv`` of ``slate_tpu_torch.parallel``
     on a 1×1 grid of a ``torch.distributed`` world of one (NCCL), the
     sites at their card defaults: residuals ≤ 3, |L| ≤ 1 + 100ε, exactly
     64 ``chol_l21_panel`` launches per pposv and 127 ``lu_u12_panel``
     per pgesv; the wall and a profiler split of one more pposv, then
     one pposv and
     one pgesv at 4096 with every ``chol_l21_panel``, ``lu_u12_panel``
     and ``matmul`` call held to its plain version, and again with
     ``dist_panel=pallas_panel`` pinned (``chol_inv_panel``,
     ``trtri_panel``); phase 3k runs pposv and pgesv at 16384 on a 2×2
     grid of four processes sharing the card (gloo), every rank gated as
     in 3j (|L| under the tournament's pivots reported only) and
     launching both kernels, then in the same processes one pposv and
     one pgesv at 4096 with ``dist_chunk=2`` pinned and every
     ``chol_l21_panel``, ``lu_u12_panel`` and ``matmul`` call held to
     its plain version.
   * the ninth slice (phase 3l): tester.py's ``norm`` routine at
     16384² fp32 (Max exact, One/Inf/Fro within 1e-5 of fp64),
     ``col_norms``, a Symmetric, a unit Triangular and a HermitianBand
     (kd = 256) matrix at 8192 against masked fp64 references; the tile
     kernels through their public entries tied to the driver functions
     (``norm`` Max and Fro to the tile partials, ``util.add``,
     ``util.scale_row_col``, ``util.set``/``scale`` on a Lower
     TriangularMatrix bitwise), and no tile kernel launched on any
     driver path; ``gecondest`` (fp32 and fp64), ``pocondest`` and
     ``trcondest`` at n = 8192 under tester.py's gates; ``posv_mixed``
     and ``gesv_mixed`` at n = 8192 fp64 with 128 right-hand sides on
     the split leg, the card's default (residual ≤ 3 in ε₆₄ units, no
     fallback; the fp32 low leg's launches equal one direct fp32
     ``potrf_rec``/``getrf_rec``'s under ``split_factor_leg``, with
     ``split_matmul`` and no ``matmul``, and the κ·n·ε₃₂ probe not
     demoting it) beside cuSOLVER's fp64 solves and beside the stock
     fp32 leg (each leg's wall a median of 3, its low leg, its fp32
     factor and the κ probe timed alone, and a profiler split of each
     leg), both ``_gmres`` forms at 4 right-hand sides,
     ``gels_mixed`` on bench.py's (32768, 4096) Gaussian in fp64
     (normal-equations residual ≤ 3 in ε₆₄ units; its κ₁(R)²·n·ε₃₂
     printed with the demotion it decides, a demoted leg's launches
     those of the split factor and one stock factor), the
     fallback (``random_spd(2048, cond=1e10)``: iters < 0, residual
     ≤ 3), and ``pbsv``/``gbsv`` at n = 8192 (kd = 256; kl = ku = 256),
     residuals ≤ 3.
   * the fp64 main path (phase 3m): ``gemm`` fp64 at n = 2048
     (BASELINE.md config 1) under ``f64_mxu``: tester.py's residual ≤ 3,
     ``ozaki_matmul`` launched and ``matmul`` not, its wall beside
     ``torch.matmul`` fp64; ``posv`` fp64 at n = 8192, nb = 512, 128
     right-hand sides (config 2) three ways — stock (cuSOLVER), the
     Newton panels pinned (``potrf_panel_f64=ozaki_newton``, DGEMM
     products) and the Newton panels over ``ozaki_matmul``
     (``f64_mxu``): each residual ≤ 3 in ε₆₄ units, the pinned ways 16
     ``chol_inv_panel`` launches and no stock rerun (``potrf.f64_rerun``
     0), a median of 3 walls each and a profiler split of each pinned
     way.
   Every kernel's launch count is set to 0 just before each path (each
   LU driver, ``getri``, each batched driver, the served requests, each
   depth and each distributed driver a path of its own) and read just
   after it; a kernel of the path that was not launched fails the run.
4. Prints one JSON line of per-kernel numbers, then, as the last line,
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, on any failure, when no CUDA device
is present, or when run without the rest of the repository.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

N, NB, NRHS = 8192, 256, 128
PANEL_NB = 512                  # potrf's panel width for nb = 256
STRIP = 2048                    # the strip driver's trailing strip width
TRTRI_NB = 256                  # potri's diagonal tiles at nb = 256
PEAK_FP32_FLOPS = 67e12         # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12            # H100 SXM HBM3
PEAK_TF32_FLOPS = 495e12        # H100 SXM, dense TF32 on the tensor cores
REPO = {"matmul": ("slate_tpu_torch/csrc/matmul.cu",
                   "slate_tpu/ops/pallas_kernels.py:95"),
        "chol_inv_panel": ("slate_tpu_torch/csrc/chol_inv_panel.cu",
                           "slate_tpu/ops/pallas_kernels.py:395"),
        "trtri_panel": ("slate_tpu_torch/csrc/trtri_panel.cu",
                        "slate_tpu/ops/pallas_kernels.py:571"),
        "lu_inv_panel": ("slate_tpu_torch/csrc/lu_inv_panel.cu",
                         "slate_tpu/ops/pallas_kernels.py:537"),
        "getrf_panel_linv": ("slate_tpu_torch/csrc/getrf_panel_linv.cu",
                             "slate_tpu/ops/pallas_kernels.py:873"),
        "getrf_panel_fused": ("slate_tpu_torch/csrc/getrf_panel_fused.cu",
                              "slate_tpu/ops/pallas_kernels.py:1080"),
        "potrf_batched": ("slate_tpu_torch/csrc/potrf_batched.cu",
                          "slate_tpu/ops/pallas_kernels.py:2323"),
        "getrf_batched": ("slate_tpu_torch/csrc/getrf_batched.cu",
                          "slate_tpu/ops/pallas_kernels.py:2433"),
        "potrf_step_fused": ("slate_tpu_torch/csrc/potrf_step_fused.cu",
                             "slate_tpu/ops/pallas_kernels.py:1631"),
        "potrf_full_fused": ("slate_tpu_torch/csrc/potrf_full_fused.cu",
                             "slate_tpu/ops/pallas_kernels.py:1738"),
        "getrf_step_fused": ("slate_tpu_torch/csrc/getrf_step_fused.cu",
                             "slate_tpu/ops/pallas_kernels.py:1317"),
        "getrf_full_fused": ("slate_tpu_torch/csrc/getrf_full_fused.cu",
                             "slate_tpu/ops/pallas_kernels.py:1481"),
        "hb2st_wavefront": ("slate_tpu_torch/csrc/hb2st_wavefront.cu",
                            "slate_tpu/ops/pallas_kernels.py:2033"),
        "tb2bd_wavefront": ("slate_tpu_torch/csrc/tb2bd_wavefront.cu",
                            "slate_tpu/ops/pallas_kernels.py:2226"),
        "chol_l21_panel": ("slate_tpu_torch/csrc/chol_l21_panel.cu",
                           "slate_tpu/ops/pallas_kernels.py:602"),
        "lu_u12_panel": ("slate_tpu_torch/csrc/lu_u12_panel.cu",
                         "slate_tpu/ops/pallas_kernels.py:646"),
        "tile_norms": ("slate_tpu_torch/csrc/tile_norms.cu",
                       "slate_tpu/ops/pallas_kernels.py:148"),
        "tzset": ("slate_tpu_torch/csrc/tz.cu",
                  "slate_tpu/ops/pallas_kernels.py:193"),
        "tzscale": ("slate_tpu_torch/csrc/tz.cu",
                    "slate_tpu/ops/pallas_kernels.py:201"),
        "geadd": ("slate_tpu_torch/csrc/geadd.cu",
                  "slate_tpu/ops/pallas_kernels.py:232"),
        "gescale_row_col": ("slate_tpu_torch/csrc/gescale_row_col.cu",
                            "slate_tpu/ops/pallas_kernels.py:253"),
        # not TPU kernels: the XLA dots they replace
        "split_matmul": ("slate_tpu_torch/csrc/split_matmul.cu",
                         "slate_tpu/ops/split_gemm.py:105"),
        "ozaki_matmul": ("slate_tpu_torch/csrc/ozaki_matmul.cu",
                         "slate_tpu/ops/ozaki.py:131")}
LU_NB, LU_BB, LU_IB = 512, 128, 16   # the scattered driver's panel call
LEAF_W, LEAF_IB = 256, 32            # getrf_rec's kernel leaf at nb = 256
#: bench.py's batched configuration (B, n) and serve configuration
#: (max_batch, requests of each of posv and gesv, submitter threads)
BATCH, BATCH_N = 64, 256
SERVE_BATCH, SERVE_REQS, SERVE_THREADS = 16, 192, 4
#: kernels of each main path; the path must launch every one of them
PATHS = {"cholesky": ("matmul", "chol_inv_panel", "trtri_panel"),
         "lu_scattered": ("matmul", "getrf_panel_fused"),
         "lu_rec": ("matmul", "getrf_panel_linv"),
         "getri": ("matmul",),
         "batched_posv": ("potrf_batched",),
         "batched_gesv": ("getrf_batched",),
         "serve": ("potrf_batched", "getrf_batched"),
         "chol_fused": ("matmul", "potrf_step_fused"),
         "chol_full": ("matmul", "potrf_full_fused"),
         "lu_fused_trsm": ("matmul", "getrf_step_fused"),
         "lu_fused": ("matmul", "getrf_step_fused"),
         "lu_full": ("matmul", "getrf_full_fused"),
         "qr": ("matmul", "chol_inv_panel", "lu_inv_panel", "trtri_panel"),
         "ungqr": ("matmul",),
         "gels_cholqr": ("matmul",),
         "gels_qr": ("matmul",),
         "gels_min_norm": ("matmul",),
         "qr_guard": ("matmul", "chol_inv_panel", "lu_inv_panel",
                      "trtri_panel"),
         "heev": ("matmul", "hb2st_wavefront"),
         "heev_fp64": ("hb2st_wavefront",),
         "heev_vals": ("matmul",),
         "hegv": ("matmul", "chol_inv_panel", "hb2st_wavefront"),
         "svd": ("matmul", "tb2bd_wavefront"),
         "svd_fp64": ("tb2bd_wavefront",),
         "svd_vals": ("matmul",),
         "svd_tall": ("matmul", "tb2bd_wavefront"),
         "dist_pgemm": ("matmul",),
         "dist_pposv": ("matmul", "chol_l21_panel"),
         "dist_pgesv": ("matmul", "lu_u12_panel"),
         "tile_ties": ("tile_norms", "tzset", "tzscale", "geadd",
                       "gescale_row_col"),
         "posv_mixed": ("split_matmul",),
         "gesv_mixed": ("split_matmul", "getrf_panel_linv"),
         "posv_mixed_gmres": ("split_matmul",),
         "gesv_mixed_gmres": ("split_matmul", "getrf_panel_linv"),
         "gels_mixed": ("split_matmul",),
         "pbsv": ("matmul",),
         "gbsv": ("matmul", "getrf_panel_fused"),
         "gemm_fp64": ("ozaki_matmul",),
         "posv_fp64_stock": (),
         "posv_fp64_newton_dgemm": ("chol_inv_panel",),
         "posv_fp64_newton_ozaki": ("chol_inv_panel", "ozaki_matmul")}
#: the tile kernels, which no driver calls: their path is their own
#: public entry, tied to the driver function computing the same thing
TILE_KERNELS = PATHS["tile_ties"]
#: the depth paths' exact launch counts at n = 8192 (16 steps of 512), the
#: composed depth's panel kernels among them (never launched there)
EXACT = {"chol_fused": {"potrf_step_fused": 16, "potrf_full_fused": 0,
                        "chol_inv_panel": 0},
         "chol_full": {"potrf_full_fused": 1, "potrf_step_fused": 0,
                       "chol_inv_panel": 0},
         "lu_fused_trsm": {"getrf_step_fused": 16, "getrf_full_fused": 0,
                           "getrf_panel_fused": 0},
         "lu_fused": {"getrf_step_fused": 16, "getrf_full_fused": 0,
                      "getrf_panel_fused": 0},
         "lu_full": {"getrf_full_fused": 1, "getrf_step_fused": 0,
                     "getrf_panel_fused": 0}}
FUSED_N = 2048                  # phase 2d's check size (four 512 steps)
#: BASELINE.md's config 4 (bench.py:1429-1497), geqrf_panels' panel width
#: for nb = 256, the exact launches of one geqrf there (8 panels), and the
#: guard path's (m, n) and condition number
QR_M, QR_N, QR_PANEL = 32768, 4096, 512
QR_EXACT = {"lu_inv_panel": 8, "chol_inv_panel": 16, "trtri_panel": 8}
GUARD_M, GUARD_N, GUARD_COND = 8192, 1024, 1e6
#: the checked paths' tolerance (relative Frobenius) for each kernel
#: against its plain version, as in phases 2 and 2e
CHECK_TOL = {"matmul": 1e-5, "chol_inv_panel": 1e-4,
                "lu_inv_panel": 1e-4, "trtri_panel": 1e-4,
                "chol_l21_panel": 1e-4, "lu_u12_panel": 1e-4}
FORCE = "SLATE_TPU_TORCH_AUTOTUNE_FORCE"
PEAK_FP64_FLOPS = 34e12         # H100 SXM, fp64 FMA outside the tensor cores
#: phase 2g's chase checks (n, kd), its range chunks at (1024, 64) and the
#: sweeps of the fp32 forward check (and of each chunk compared at the main
#: paths' calls); the eigensolver paths' sizes
#: (bench.py's heev_fp32 at n = 8192 and heev_fp64's generator at one
#: card's 4096; the host routes at 2048)
CHASE_CHECKS = ((1024, 64), (1024, 256))
CHASE_CHUNKS = ((0, 300), (300, 700), (700, 1022))
CHASE_F32_SWEEPS = 64
#: each chase's time before its redesign onto thread-block clusters
#: (PERF.md §6 rows 18-19: the last run of the one-block-a-task kernels,
#: H100 80GB HBM3 at 700 W), fp32 at (EIG_N or SVD_N, NB), fp64 at
#: (EIG_N64 or SVD_N64, NB)
CHASE_BEFORE_MS = {"hb2st_wavefront": {"float32": 1409.945, "float64": 805.462},
                   "tb2bd_wavefront": {"float32": 1751.606, "float64": 1059.067}}
#: each batched kernel's time before its on-chip redesign, ms at (BATCH,
#: BATCH_N) and (SERVE_BATCH, BATCH_N): the one-block kernels built from
#: the parent tree and timed by CUDA events on an H100 80GB HBM3 at 700 W;
#: printed in the ``redesign`` lines only
BATCHED_BEFORE_MS = {"potrf_batched": (0.4149, 0.4039),
                     "getrf_batched": (0.6590, 0.6503)}
EIG_N, EIG_N64, EIG_HOST_N = 8192, 4096, 2048
#: the SVD paths' sizes (bench.py's svd_fp32 at n = 8192 and svd_fp64's
#: generator at one card's 4096; values only through the host chase at
#: 2048; one tall operand and its transpose); phase 2h checks the chase at
#: CHASE_CHECKS, in CHASE_CHUNKS and over CHASE_F32_SWEEPS as phase 2g
SVD_N, SVD_N64, SVD_HOST_N, SVD_TALL = 8192, 4096, 2048, (8192, 2048)
#: heev fp32's timed calls after its warm one (one: the svd path's host
#: time leaves no room for more in the command's time)
HEEV_REPS = 1
#: the distributed drivers' path (BASELINE.md config 3: gemm/posv/gesv,
#: fp32, n = 16384, nb = 256, 128 right-hand sides) on a 1×1 NCCL grid
#: (phase 3j) and on a 2×2 gloo grid of four processes sharing the card
#: (phase 3k, uncut); the size of phase 3j's checked and pallas_panel
#: runs; the exact launches of one pposv and one pgesv at DIST_N on the
#: 1×1 grid (64 steps; pgetrf at depth 2 solves the window and the ring
#: at every step but the last)
DIST_N, DIST_NRHS, DIST_CHECK_N = 16384, 128, 4096
DIST_EXACT = {"dist_pposv": {"chol_l21_panel": 64},
              "dist_pgesv": {"lu_u12_panel": 127}}
#: phase 2j's and 3l's sizes: the 16384² fp32 matrix and its 256² tiles,
#: fp64 at 8192²; the mixed drivers' and condition estimates' n (128
#: right-hand sides, 4 through GMRES), the forced fallback's n and the
#: band solvers' bandwidth
TILE_N, TILE_T, TILE_N64 = 16384, 256, 8192
MIXED_N, GMRES_NRHS, FALLBACK_N, BAND_KD = 8192, 4, 2048, 256
#: phase 2k's shapes (m, k, n): split_matmul at the fp32 leg's trailing
#: strip (B a transposed view) and a ragged one; ozaki_matmul at the fp64
#: trailing strip at n = 8192, nb = 512, a Newton product, BASELINE.md
#: config 1's 2048³ and a contraction past the int32 chunk; the peaks of
#: the two kernels' operations (H100 SXM, dense tensor cores)
SPLIT_SHAPES = ((7680, 512, 2048), (1000, 300, 777))
OZAKI_SHAPES = ((7680, 512, 2048), (512, 512, 512), (2048, 2048, 2048),
                (64, 3 * 65536 + 17, 64))
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
#: phase 3m's sizes: gemm fp64 at BASELINE.md config 1's n = 2048 (nb 256),
#: posv fp64 at config 2's n = 8192, nb = 512 (16 panels), 128 right-hand
#: sides, the walls a median of this many calls
GEMM64_N, POSV64_N, POSV64_NB, POSV64_REPS = 2048, 8192, 512, 3


def fail(msg: str):
    raise RuntimeError("chip_smoke: " + msg)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up,
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS):
    """Least time the card could take: the larger of operations over the
    peak of their type (fp32 FFMA unless ``peak`` says otherwise) and
    bytes over the memory rate, in ms, and which bounds."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def rel_err(x, ref) -> float:
    return float((x.double() - ref.double()).norm() / ref.double().norm())


def check_matmul(torch, kernels, dev, gen, carry) -> dict:
    """Phase 2's matmul accuracy and timing beyond the strip update: at
    the strip update, at 8192³ and at geqrf's two products under one
    wave at K = 32768 (YᵀY, (512, 32768)·(32768, 512), and Yᵀ·C,
    (512, 32768)·(32768, 3584), Yᵀ a transposed view), the kernel's
    relative Frobenius error to the fp64 product of the same operands
    beside ``torch.matmul``'s (fp32, TF32 off): the kernel's must be
    within 4x.  Then two pairs of views at storage offset 1, which the
    kernel stages through registers, against the plain version (1e-5) and
    fp64 (4x), and a NaN in a row of A and a column of B, which must come
    out NaN in that row and column of C and nowhere else.  The QR shapes
    are timed with the wrapper's parts of K and with one part."""
    if torch.backends.cuda.matmul.allow_tf32:
        fail("torch.matmul runs TF32: the fp32 yardstick is gone")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    l21 = carry[PANEL_NB:, :PANEL_NB]
    y = torch.randn((QR_M, QR_PANEL), generator=gen, device=dev)
    c = torch.randn((QR_M, QR_N - QR_PANEL), generator=gen, device=dev)
    cases = {"strip (7680,512)x(512,2048)": (l21, l21[:STRIP].mT),
             "%d^3" % N: (carry, carry),
             "Y^T Y (512,32768)x(32768,512)": (y.mT, y),
             "Y^T C (512,32768)x(32768,3584)": (y.mT, c)}
    errs, rows = {}, {}
    for label, (a, b) in cases.items():
        s, staging = kernels.matmul_plan(a, b, sms)
        ref = a.double() @ b.double()
        e_k = rel_err(kernels.matmul(a, b), ref)
        e_t = rel_err(torch.matmul(a, b), ref)
        del ref
        errs[label] = dict(kernel=e_k, torch_matmul=e_t, splits=s,
                           staging=staging)
        print("matmul %s (%d parts of K, %s staging): error to fp64 %.3e, "
              "torch.matmul's %.3e (%.2fx)" % (label, s, staging, e_k, e_t,
                                              e_k / e_t), flush=True)
        if not e_k <= 4.0 * e_t:
            fail("matmul %s: error to fp64 %.3e, more than 4x torch.matmul's "
                 "%.3e" % (label, e_k, e_t))
        if label.startswith("Y^T"):
            m, k = a.shape
            n = b.shape[1]
            rows[label] = dict(
                splits=s, ms=cuda_ms(torch, lambda: kernels.matmul(a, b), 5),
                one_part_ms=cuda_ms(torch, lambda: kernels._matmul_launch(
                    a, b, 1), 5),
                library_ms=cuda_ms(torch, lambda: torch.matmul(a, b), 5),
                bound_ms=bound(6.0 * m * n * k, 4.0 * (m * k + k * n + m * n),
                               PEAK_TF32_FLOPS)[0])
            print("matmul %s: kernel %.4f ms in %d parts, %.4f ms in one; "
                  "torch.matmul %.4f ms; bound %.4f ms" % (
                      label, rows[label]["ms"], s, rows[label]["one_part_ms"],
                      rows[label]["library_ms"], rows[label]["bound_ms"]),
                  flush=True)
    del y, c
    cube = dict(ms=cuda_ms(torch, lambda: kernels.matmul(carry, carry), 3),
                library_ms=cuda_ms(torch, lambda: torch.matmul(carry, carry), 3),
                bound_ms=bound(6.0 * N ** 3, 12.0 * N * N, PEAK_TF32_FLOPS)[0],
                bound_fp32_ffma_ms=bound(2.0 * N ** 3, 12.0 * N * N)[0])
    print("matmul at %d^3: kernel %.3f ms (%.1f TFLOP/s), torch.matmul %.3f ms, "
          "bound %.3f ms (fp32 FFMA %.3f ms)" % (
              N, cube["ms"], 2.0 * N ** 3 / cube["ms"] / 1e9,
              cube["library_ms"], cube["bound_ms"], cube["bound_fp32_ffma_ms"]),
          flush=True)
    # views whose base is 4 bytes off take the register route: A K-fast
    # with B row-fast, then A row-fast with B K-fast
    def offset1(rows, cols):
        buf = torch.randn(rows * cols + 1, generator=gen, device=dev)
        return buf[1:].view(rows, cols)
    for label, a, b in (
            ("A K-fast, B row-fast", offset1(QR_PANEL, 2048), l21[:2048]),
            ("A row-fast, B K-fast", offset1(2048, QR_PANEL).mT,
             offset1(QR_PANEL, 2048).mT)):
        s, staging = kernels.matmul_plan(a, b, sms)
        if staging != "registers":
            fail("matmul: views at storage offset 1 (%s) planned as %s"
                 % (label, staging))
        got = kernels.matmul(a, b)
        e_p = rel_err(got, kernels.matmul_plain(a, b))
        ref = a.double() @ b.double()
        e_k, e_t = rel_err(got, ref), rel_err(torch.matmul(a, b), ref)
        print("matmul unaligned (512,2048)x(2048,512), storage offset 1, %s "
              "(%s staging): rel %.3e to the plain version, error to fp64 "
              "%.3e, torch.matmul's %.3e" % (label, staging, e_p, e_k, e_t),
              flush=True)
        if not (e_p <= 1e-5 and e_k <= 4.0 * e_t):
            fail("matmul unaligned view (%s): rel %.3e to the plain version, "
                 "error to fp64 %.3e against torch.matmul's %.3e"
                 % (label, e_p, e_k, e_t))
        errs["unaligned (512,2048)x(2048,512), " + label] = dict(
            kernel=e_k, torch_matmul=e_t, plain=e_p, splits=s, staging=staging)
    # a NaN made on the card (sqrt(-1), 0x7fffffff) in A's row 5 and one
    # with the sign set (0xffffffff) in B's column 7, through split-K: that
    # row and column of C are NaN, the rest finite and within 1e-5 of the
    # plain version
    a = torch.randn((QR_PANEL, 4096), generator=gen, device=dev)
    b = torch.randn((4096, QR_PANEL), generator=gen, device=dev)
    a[5, 100] = torch.sqrt(-torch.ones((), device=dev))
    b[3000, 7] = torch.full((), -1, dtype=torch.int32, device=dev).view(
        torch.float32)
    s, staging = kernels.matmul_plan(a, b, sms)
    got = kernels.matmul(a, b)
    rest = torch.ones_like(got, dtype=torch.bool)
    rest[5, :] = False
    rest[:, 7] = False
    e_p = rel_err(got[rest], kernels.matmul_plain(a, b)[rest])
    bits = [int(x) & 0xffffffff for x in torch.stack(
        (a[5, 100], b[3000, 7])).view(torch.int32).tolist()]
    print("matmul with NaN (bits %s) in A's row 5 and B's column 7 (%d parts "
          "of K, %s staging): row %s NaN, column %s NaN, the rest finite %s, "
          "rel %.3e to the plain version" % (
              ", ".join("0x%08x" % x for x in bits), s, staging,
              bool(got[5].isnan().all()), bool(got[:, 7].isnan().all()),
              bool(got[rest].isfinite().all()), e_p), flush=True)
    if not (s > 1 and got[5].isnan().all() and got[:, 7].isnan().all()
            and got[rest].isfinite().all() and e_p <= 1e-5):
        fail("matmul lost a NaN of its operands or spread it")
    return dict(fp64_errors=errs, qr_one_wave=rows,
                **{"cube_" + key: v for key, v in cube.items()})


def check_kernels(torch, kernels, dev) -> dict:
    """Phase 2: each kernel against its plain version at main-path shapes."""
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}

    # matmul: the first strip update of potrf, L21[o:]·L21[o:o+2048]ᵀ with
    # L21 a (7680, 512) column panel of the (8192, 8192) carry
    carry = torch.randn((N, N), generator=gen, device=dev)
    l21 = carry[PANEL_NB:, :PANEL_NB]
    a, b = l21, l21[:STRIP].mT
    m, k = a.shape
    n = b.shape[1]
    got, ref = kernels.matmul(a, b), kernels.matmul_plain(a, b)
    torch.cuda.synchronize()
    err = rel_err(got, ref)
    if not err <= 1e-5:
        fail("matmul disagrees with its plain version: rel %.3e" % err)
    max_abs = float((got - ref).abs().max())
    del got, ref
    # 3xTF32: three tensor-core passes of 2mnk each
    b_ms, b_by = bound(6.0 * m * n * k, 4.0 * (m * k + k * n + m * n),
                       PEAK_TF32_FLOPS)
    out["matmul"] = dict(
        shape="(%d,%d)x(%d,%d) B transposed view" % (m, k, k, n),
        max_abs_err=max_abs, rel_err=err, tol="rel Frobenius <= 1e-5 of the plain version; error "
        "to fp64 <= 4x torch.matmul's at every shape of fp64_errors",
        ms=cuda_ms(torch, lambda: kernels.matmul(a, b), 20),
        plain_ms=cuda_ms(torch, lambda: kernels.matmul_plain(a, b), 20),
        library_ms=cuda_ms(torch, lambda: torch.matmul(a, b), 20),
        bound_ms=b_ms, bound_by=b_by,
        bound_fp32_ffma_ms=bound(2.0 * m * n * k,
                                 4.0 * (m * k + k * n + m * n))[0])
    out["matmul"].update(check_matmul(torch, kernels, dev, gen, carry))

    # chol_inv_panel: a 512² diagonal block read in place from the carry
    # (row stride 8192), stale values above its diagonal
    g = torch.randn((PANEL_NB, PANEL_NB), generator=gen, device=dev)
    spd = g @ g.T + PANEL_NB * torch.eye(PANEL_NB, device=dev)
    carry[:PANEL_NB, :PANEL_NB] = torch.tril(spd) + torch.triu(
        torch.full_like(spd, 1e3), 1)
    akk = carry[:PANEL_NB, :PANEL_NB]
    (l, li), (lp, lip) = kernels.chol_inv_panel(akk), \
        kernels.chol_inv_panel_plain(akk)
    torch.cuda.synchronize()
    err = max(rel_err(l, lp), rel_err(li, lip))
    eye = torch.eye(PANEL_NB, device=dev)
    fac = float((l.double() @ l.double().T - spd.double()).norm()
                / spd.double().norm())
    if not (err <= 1e-4 and fac < 1e-5 and float((l @ li - eye).norm()) < 1e-4):
        fail("chol_inv_panel disagrees: rel %.3e, factor %.3e" % (err, fac))
    nb = PANEL_NB
    b_ms, b_by = bound(2.0 * nb ** 3 / 3, 4.0 * (nb * (nb + 1) / 2 + 2 * nb * nb))

    def library_chol():
        lk = torch.linalg.cholesky(akk)
        return torch.linalg.solve_triangular(lk, eye, upper=False)

    out["chol_inv_panel"] = dict(
        shape="(%d,%d) view, row stride %d" % (nb, nb, N),
        max_abs_err=float(max((l - lp).abs().max(), (li - lip).abs().max())),
        rel_err=err, tol="rel Frobenius of L and L^-1 <= 1e-4",
        ms=cuda_ms(torch, lambda: kernels.chol_inv_panel(akk), 20),
        plain_ms=cuda_ms(torch, lambda: kernels.chol_inv_panel_plain(akk), 3),
        library_ms=cuda_ms(torch, library_chol, 20),
        bound_ms=b_ms, bound_by=b_by)
    # the same at nb = 256: the diagonal block of pposv's (16384, 256)
    # panel on the 1×1 grid, a view of row stride 256 with stale values
    # above its diagonal, under the same gates
    n2 = 256
    g2 = torch.randn((n2, n2), generator=gen, device=dev)
    spd2 = g2 @ g2.T + n2 * torch.eye(n2, device=dev)
    panel = torch.randn((64 * n2, n2), generator=gen, device=dev)
    panel[:n2] = torch.tril(spd2) + torch.triu(torch.full_like(spd2, 1e3), 1)
    d2 = panel[:n2]
    (l2, li2), (lp2, lip2) = kernels.chol_inv_panel(d2), \
        kernels.chol_inv_panel_plain(d2)
    torch.cuda.synchronize()
    err2 = max(rel_err(l2, lp2), rel_err(li2, lip2))
    eye256 = torch.eye(n2, device=dev)
    fac2 = float((l2.double() @ l2.double().T - spd2.double()).norm()
                 / spd2.double().norm())
    if not (err2 <= 1e-4 and fac2 < 1e-5
            and float((l2 @ li2 - eye256).norm()) < 1e-4):
        fail("chol_inv_panel nb=256 disagrees: rel %.3e, factor %.3e"
             % (err2, fac2))

    def library_chol256():
        lk = torch.linalg.cholesky(d2)
        return torch.linalg.solve_triangular(lk, eye256, upper=False)

    r = out["chol_inv_panel"]
    r.update(nb256_ms=cuda_ms(torch, lambda: kernels.chol_inv_panel(d2), 20),
             nb256_plain_ms=cuda_ms(
                 torch, lambda: kernels.chol_inv_panel_plain(d2), 3),
             nb256_library_ms=cuda_ms(torch, library_chol256, 20),
             nb256_bound_ms=bound(2.0 * n2 ** 3 / 3, 4.0 * (
                 n2 * (n2 + 1) / 2 + 2 * n2 * n2))[0])
    print("redesign chol_inv_panel (one cooperative grid): (512,512) view "
          "kernel %.4f ms against the library's %.4f ms (bound %.5f ms); "
          "(256,256) view of pposv's panel, rel %.3e, factor %.3e: kernel "
          "%.4f ms, plain %.4f ms, library %.4f ms, bound %.5f ms"
          % (r["ms"], r["library_ms"], r["bound_ms"], err2, fac2,
             r["nb256_ms"], r["nb256_plain_ms"], r["nb256_library_ms"],
             r["nb256_bound_ms"]), flush=True)
    del panel

    # trtri_panel: a 256² diagonal tile of a factor, in place (stride
    # 512), and the whole 512² factor, geqrf's T block shape
    def check_trtri(tl):
        got, ref = kernels.trtri_panel(tl), kernels.trtri_panel_plain(tl)
        torch.cuda.synchronize()
        err = rel_err(got, ref)
        eye2 = torch.eye(tl.shape[0], device=dev)
        ident = float((tl @ got - eye2).norm())
        if not (err <= 1e-4 and ident < 1e-4):
            fail("trtri_panel (%d,%d) disagrees with its plain version: rel "
                 "%.3e, ||L Linv - I|| %.3g" % (*tl.shape, err, ident))
        nb = tl.shape[0]
        return dict(
            max_abs_err=float((got - ref).abs().max()), rel_err=err,
            ms=cuda_ms(torch, lambda: kernels.trtri_panel(tl), 20),
            plain_ms=cuda_ms(torch, lambda: kernels.trtri_panel_plain(tl), 5),
            library_ms=cuda_ms(torch, lambda: torch.linalg.solve_triangular(
                tl, eye2, upper=False), 20),
            bound=bound(nb ** 3 / 3.0, 4.0 * (nb * (nb + 1) / 2 + nb * nb)))

    nb = TRTRI_NB
    r256, r512 = check_trtri(l[:nb, :nb]), check_trtri(l)
    out["trtri_panel"] = r = dict(
        shape="(%d,%d) view, row stride %d" % (nb, nb, PANEL_NB),
        tol="rel Frobenius <= 1e-4, ||L Linv - I|| < 1e-4",
        bound_ms=r256["bound"][0], bound_by=r256["bound"][1],
        **{k: r256[k] for k in ("max_abs_err", "rel_err", "ms", "plain_ms",
                                "library_ms")},
        **{"nb512_" + k: r512[k] for k in ("ms", "plain_ms", "library_ms",
                                           "max_abs_err")},
        nb512_bound_ms=r512["bound"][0])
    routes = ["%d: %s of %d blocks" % (
        n, "one cluster" if n <= kernels.TRTRI_CLUSTER_NB else "cooperative grid",
        kernels._plan("trtri_panel", dev, n, int(n <= kernels.TRTRI_CLUSTER_NB)))
        for n in (nb, PANEL_NB)]
    print("redesign trtri_panel (%s): (256,256) view kernel %.4f ms, plain %.4f "
          "ms, solve_triangular %.4f ms, bound %.5f ms; (512,512) rel %.3e: "
          "kernel %.4f ms, plain %.4f ms, solve_triangular %.4f ms, bound %.5f "
          "ms" % ("; ".join(routes), r["ms"], r["plain_ms"], r["library_ms"],
                  r["bound_ms"], r512["rel_err"], r["nb512_ms"],
                  r["nb512_plain_ms"], r["nb512_library_ms"],
                  r["nb512_bound_ms"]), flush=True)
    for name, r in out.items():
        print("kernel %s %s: max_abs_err %.3e rel %.3e (%s); kernel %.4f ms, "
              "plain %.4f ms, library %.4f ms, bound %.5f ms (%s)"
              % (name, r["shape"], r["max_abs_err"], r["rel_err"], r["tol"],
                 r["ms"], r["plain_ms"], r["library_ms"], r["bound_ms"],
                 r["bound_by"]), flush=True)
    return out


def main_path(torch, st, kernels, dev) -> dict:
    """Phase 3: posv, potri and gemm through the public entry points,
    with the reference tester's checks."""
    gen = torch.Generator(device=dev).manual_seed(2)
    eps = float(torch.finfo(torch.float32).eps)
    r = torch.randn((N, N), generator=gen, device=dev)
    a = (r + r.T) / 2 + N * torch.eye(N, device=dev)     # the tester's herm(n)
    b = torch.randn((N, NRHS), generator=gen, device=dev)
    c = torch.randn((N, N), generator=gen, device=dev)
    A = st.HermitianMatrix(a, uplo=st.Uplo.Lower, mb=NB, nb=NB)
    torch.cuda.synchronize()

    kernels.reset_launches()
    t0 = time.perf_counter()
    fac, x = st.posv(A, b)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    inv = st.potri(fac)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    prod = st.gemm(1.0, r, a, 1.0, c)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = dict(kernels.launches)

    for name, t in (("factor", fac.data), ("x", x), ("inverse", inv.data),
                    ("gemm", prod)):
        if not bool(torch.isfinite(t).all()):
            fail("%s has non-finite values" % name)
    if tuple(x.shape) != (N, NRHS) or tuple(prod.shape) != (N, N):
        fail("wrong output shapes %s, %s" % (tuple(x.shape), tuple(prod.shape)))
    ad = a.double()
    xd = x.double()
    posv_res = float((ad @ xd - b.double()).norm()
                     / (ad.norm() * xd.norm() * eps * N))
    ld = fac.data.double()
    potrf_res = float((ld @ ld.T - ad).norm() / (ad.norm() * eps * N))
    invd = inv.data.double()
    invd = torch.tril(invd) + torch.tril(invd, -1).T
    ainv_err = float((invd @ ad - torch.eye(N, device=dev,
                                            dtype=torch.float64)).norm())
    cond1 = float(torch.linalg.matrix_norm(ad, 1)
                  * torch.linalg.matrix_norm(invd, 1))
    potri_res = ainv_err / (eps * N * cond1)
    ref = r.double() @ ad + c.double()
    gemm_res = float((prod.double() - ref).norm()
                     / ((r.double().norm() * ad.norm() + c.double().norm())
                        * eps * N))
    res = dict(posv_residual=posv_res, potrf_residual=potrf_res,
               potri_residual=potri_res,
               potri_AinvA_minus_I_in_n_eps=ainv_err / (eps * N),
               gemm_residual=gemm_res, posv_ms=(t1 - t0) * 1e3,
               potri_ms=(t2 - t1) * 1e3, gemm_ms=(t3 - t2) * 1e3,
               launches=launches)
    print("main path n=%d nb=%d nrhs=%d: posv %.1f ms (residual %.3g, factor "
          "%.3g), potri %.1f ms (residual %.3g; ||A^-1 A - I|| = %.3g n*eps), "
          "gemm %.1f ms (residual %.3g); launches %s"
          % (N, NB, NRHS, res["posv_ms"], posv_res, potrf_res,
             res["potri_ms"], potri_res, res["potri_AinvA_minus_I_in_n_eps"],
             res["gemm_ms"], gemm_res, launches), flush=True)
    for name in ("posv", "potrf", "potri", "gemm"):
        if not res[name + "_residual"] <= 3:
            fail("%s residual %.3f > 3" % (name, res[name + "_residual"]))
    missing = [k for k in PATHS["cholesky"] if launches[k] <= 0]
    if missing:
        fail("the Cholesky path launched no %s kernel" % ", ".join(missing))
    res["posv_split"] = device_split(
        torch, "posv", lambda: st.posv(A, b),
        {"chol_inv_panel kernel": "chol_inv_panel_kernel",
         "trtri_panel kernel": "trtri_panel_kernel",
         "matmul kernel": "matmul_f32_kernel"})
    return res


def _lu_of_panel(torch, out, piv, act_out):
    """(L, U, perm) of a factored (w, m) lane-major panel, in float64:
    perm is the pivot lanes, then the lanes still active, in order (the
    lanes retired before the panel took no part in it)."""
    w = out.shape[0]
    perm = torch.cat([piv, (act_out[0] > 0.5).nonzero()[:, 0]])
    lu = out[:, perm].T.double()
    low = torch.tril(lu, -1) + torch.eye(perm.numel(), w,
                                         dtype=torch.float64, device=lu.device)
    return low, torch.triu(lu[:w]), perm


def _panel_gates(torch, name, a_rows, out, piv, act_out, linv, ref):
    """The gates of one panel-kernel call: pivots equal to the plain
    version's (a near-tie excepted and printed), slab and linv within
    1e-4, ‖L·U − A[perm]‖/(‖A‖·ε·m) < 60 and ‖L11·linv − I‖ < 1e-3.
    Returns the max abs difference from the plain version (over the
    panel rows before a near-tie, which both compute the same way)."""
    eps = float(torch.finfo(torch.float32).eps)
    w, m = out.shape
    rout, rpiv, ract, rlinv = ref
    diff = (piv != rpiv).nonzero()
    tie = None
    if diff.numel():
        j = int(diff[0, 0])
        pk, pp = int(piv[j]), int(rpiv[j])
        mk = abs(float(out[j, pk]))
        mp = abs(float(out[j, pp])) * mk    # |multiplier| · |pivot|
        if not abs(mk - mp) <= 1e-5 * mk:
            fail("%s: pivot %d is lane %d, the plain version's lane %d "
                 "(|x| %.9g vs %.9g): not a near-tie" % (name, j, pk, pp, mk, mp))
        tie = (j, pk, pp, mk, mp)
        print("%s: near-tie at column %d: lanes %d (kernel, |x| %.9g) and %d "
              "(plain, |x| %.9g); later columns not compared"
              % (name, j, pk, mk, pp, mp), flush=True)
    else:
        err = max(rel_err(out, rout), rel_err(linv, rlinv))
        if not err <= 1e-4 or not torch.equal(act_out, ract):
            fail("%s disagrees with its plain version: rel %.3e" % (name, err))
    low, up, perm = _lu_of_panel(torch, out, piv, act_out)
    ad = a_rows.double()[perm]
    res = float((low @ up - ad).norm() / (ad.norm() * eps * perm.numel()))
    l11 = low[:w]
    inv_err = float((l11 @ linv.double()
                     - torch.eye(w, dtype=torch.float64, device=out.device)).norm())
    if not (res < 60 and inv_err < 1e-3):
        fail("%s: panel residual %.3g (< 60), ||L11 linv - I|| %.3g (< 1e-3)"
             % (name, res, inv_err))
    if tie is not None:
        return float((out[:tie[0]] - rout[:tie[0]]).abs().max())
    return float(max((out - rout).abs().max(), (linv - rlinv).abs().max()))


def check_lu_kernels(torch, kernels, dev) -> dict:
    """Phase 2b: the two LU panel kernels against their plain versions at
    the main-path shapes (the leaf in registers) and past them (the leaf
    in shared memory), ``getrf_panel_linv`` bitwise the step kernel's
    panel, and each kernel's launch printed beside its time before its
    redesign."""
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    eye_nb = torch.eye(LU_NB, device=dev)

    # getrf_panel_fused: the (8192, 8192) transposed carry, panels at
    # k0 = 0 and then k0 = 512 on the kernel's own output
    carry0 = torch.randn((N, N), generator=gen, device=dev)
    ck, cp = carry0.clone(), carry0.clone()
    ak = ap = torch.ones((1, N), device=dev)
    errs = []
    for k0 in (0, LU_NB):
        before = ck.clone()
        a_rows = ck[k0:k0 + LU_NB].T.clone()          # the panel as A holds it
        _, piv, ak2, linv = kernels.getrf_panel_fused(ck, ak, k0, nb=LU_NB,
                                                      bb=LU_BB, ib=LU_IB)
        cp.copy_(before)
        _, rpiv, ap2, rlinv = kernels.getrf_panel_fused_plain(
            cp, ak, k0, nb=LU_NB, bb=LU_BB, ib=LU_IB)
        torch.cuda.synchronize()
        if not (torch.equal(ck[:k0], before[:k0])
                and torch.equal(ck[k0 + LU_NB:], before[k0 + LU_NB:])):
            fail("getrf_panel_fused wrote rows outside [%d, %d)"
                 % (k0, k0 + LU_NB))
        errs.append(_panel_gates(
            torch, "getrf_panel_fused k0=%d" % k0, a_rows,
            ck[k0:k0 + LU_NB], piv, ak2, linv,
            (cp[k0:k0 + LU_NB], rpiv, ap2, rlinv)))
        ak = ak2
    del cp, before

    # timing: each call factors a fresh panel of the same carry, as the
    # driver's 16 calls do
    work = carry0.clone()
    act1 = torch.ones((1, N), device=dev)
    k0s = iter(range(0, 10 ** 9, LU_NB))

    def fused_call(fn):
        def call():
            k0 = next(k0s) % N
            if k0 == 0:
                work.copy_(carry0)
            fn(work, act1, k0, nb=LU_NB, bb=LU_BB, ib=LU_IB)
        return call

    pan = carry0[:LU_NB].T.contiguous()            # (8192, 512) panel

    def library_lu(p=pan, w=LU_NB):
        # cuSOLVER's getrf (PyTorch's MAGMA route warns at this shape)
        saved = torch.backends.cuda.preferred_linalg_library()
        torch.backends.cuda.preferred_linalg_library("cusolver")
        try:
            lu, _ = torch.linalg.lu_factor(p)
            return torch.linalg.solve_triangular(
                lu[:w], torch.eye(w, device=dev), upper=False,
                unitriangular=True)
        finally:
            torch.backends.cuda.preferred_linalg_library(saved)

    flops = N * LU_NB ** 2 - LU_NB ** 3 / 3 + LU_NB ** 3 / 3
    b_ms, b_by = bound(flops, 2.0 * N * LU_NB * 4)
    out["getrf_panel_fused"] = dict(
        shape="(%d,%d) carry, k0=0 and 512, nb=%d bb=%d ib=%d"
              % (N, N, LU_NB, LU_BB, LU_IB),
        max_abs_err=max(errs), rel_err=None, tol="pivots exact (near-ties reported), rel 1e-4",
        ms=cuda_ms(torch, fused_call(kernels.getrf_panel_fused), 8),
        plain_ms=cuda_ms(torch, fused_call(kernels.getrf_panel_fused_plain), 1),
        library_ms=cuda_ms(torch, library_lu, 8),
        bound_ms=b_ms, bound_by=b_by)
    del work

    # getrf_panel_linv: a (256, 8192) slab, as getrf_rec's first leaf
    slab = carry0[2 * LU_NB:2 * LU_NB + LEAF_W].contiguous()
    act = torch.ones((1, N), device=dev)
    got = kernels.getrf_panel_linv(slab, act, ib=LEAF_IB)
    ref = kernels.getrf_panel_linv_plain(slab, act, ib=LEAF_IB)
    torch.cuda.synchronize()
    err = _panel_gates(torch, "getrf_panel_linv", slab.T, *got, ref)
    pan = slab.T.contiguous()
    flops = N * LEAF_W ** 2 - LEAF_W ** 3 / 3 + LEAF_W ** 3 / 3
    b_ms, b_by = bound(flops, 2.0 * N * LEAF_W * 4)
    out["getrf_panel_linv"] = dict(
        shape="(%d,%d) slab, ib=%d" % (LEAF_W, N, LEAF_IB),
        max_abs_err=err, rel_err=None,
        tol="pivots exact (near-ties reported), rel 1e-4",
        ms=cuda_ms(torch, lambda: kernels.getrf_panel_linv(slab, act,
                                                           ib=LEAF_IB), 10),
        plain_ms=cuda_ms(torch, lambda: kernels.getrf_panel_linv_plain(
            slab, act, ib=LEAF_IB), 1),
        library_ms=cuda_ms(torch, lambda: library_lu(pan, LEAF_W), 10),
        bound_ms=b_ms, bound_by=b_by)
    for name, r in out.items():
        print("kernel %s %s: max_abs_err %.3e (%s); kernel %.4f ms, plain "
              "%.4f ms, library %.4f ms, bound %.5f ms (%s)"
              % (name, r["shape"], r["max_abs_err"], r["tol"], r["ms"],
                 r["plain_ms"], r["library_ms"], r["bound_ms"],
                 r["bound_by"]), flush=True)

    # the witness of getrf_panel_linv: its slab, pivots, mask and linv
    # bitwise getrf_step_fused's panel (lu_full.cuh, an implementation of
    # its own) at nb = 256, ib = 32 from the same state, with every lane
    # active and with the lanes the first fused panel retired
    for act_w in (act, ak):
        tag = "%d lanes retired on entry" % int((act_w <= 0).sum())
        ck = carry0[:2 * LEAF_W].clone()
        _, spiv, sact, slinv = kernels.getrf_step_fused(
            ck, act_w, 0, nb=LEAF_W, bb=LEAF_W, ib=LEAF_IB, update=False)
        lout, lpiv, lact, llinv = kernels.getrf_panel_linv(
            carry0[:LEAF_W], act_w, ib=LEAF_IB)
        if not (torch.equal(ck[:LEAF_W], lout) and torch.equal(spiv, lpiv)
                and torch.equal(sact, lact) and torch.equal(slinv, llinv)):
            fail("getrf_panel_linv (%d,%d) ib=%d, %s: slab, pivots, mask or "
                 "linv not bitwise getrf_step_fused's panel from the same "
                 "state" % (LEAF_W, N, LEAF_IB, tag))
        print("getrf_panel_linv (%d,%d) ib=%d, %s: slab, pivots, mask and linv "
              "bitwise getrf_step_fused's panel (nb=%d, update=False)"
              % (LEAF_W, N, LEAF_IB, tag, LEAF_W), flush=True)
        del ck

    # the leaf's second route: more than 2 x 256 lanes a leaf block (of
    # the cluster of 16) keep their rows in shared memory: m = 16384 for
    # the recursion's leaf (1024 lanes a block), m = 12144, the largest
    # the gate admits at (512, 16), for the fused panel (759)
    big = torch.randn((LEAF_W, 2 * N), generator=gen, device=dev)
    bact = torch.ones((1, 2 * N), device=dev)
    got = kernels.getrf_panel_linv(big, bact, ib=LEAF_IB)
    ref = kernels.getrf_panel_linv_plain(big, bact, ib=LEAF_IB)
    torch.cuda.synchronize()
    second = {"getrf_panel_linv": _panel_gates(
        torch, "getrf_panel_linv (%d,%d) shared-memory leaf" % (LEAF_W, 2 * N),
        big.T, *got, ref)}
    del big, got, ref
    m2 = 12144
    c2 = torch.randn((2 * LU_NB, m2), generator=gen, device=dev)
    a2 = torch.ones((1, m2), device=dev)
    cp2 = c2.clone()
    rows2 = c2[LU_NB:].T.clone()
    _, piv2, act2, linv2 = kernels.getrf_panel_fused(c2, a2, LU_NB, nb=LU_NB,
                                                     bb=LU_BB, ib=LU_IB)
    _, rpiv2, ract2, rlinv2 = kernels.getrf_panel_fused_plain(
        cp2, a2, LU_NB, nb=LU_NB, bb=LU_BB, ib=LU_IB)
    torch.cuda.synchronize()
    if not torch.equal(c2[:LU_NB], cp2[:LU_NB]):
        fail("getrf_panel_fused wrote rows outside [%d, %d)" % (LU_NB, 2 * LU_NB))
    second["getrf_panel_fused"] = _panel_gates(
        torch, "getrf_panel_fused (%d,%d) carry, k0=%d, shared-memory leaf"
        % (2 * LU_NB, m2, LU_NB), rows2, c2[LU_NB:], piv2, act2, linv2,
        (cp2[LU_NB:], rpiv2, ract2, rlinv2))
    del c2, cp2, rows2

    # the redesigned launches: clusters, registers, shared memory, and the
    # time before the redesign (PERF.md §6 rows 13 and 12: H100 80GB HBM3,
    # 700 W)
    for name, (m, w, ib), before, second_shape in (
            ("getrf_panel_fused", (N, LU_NB, LU_IB), 2.4301,
             "(%d,%d) carry" % (2 * LU_NB, m2)),
            ("getrf_panel_linv", (N, LEAF_W, LEAF_IB), 1.2531,
             "(%d,%d) slab" % (LEAF_W, 2 * N))):
        plan = _panel_plan(kernels, dev, name, m, w, ib)
        r = out[name]
        r.update(grid=plan["grid"], cluster=plan["cluster"],
                 smem_bytes=plan["smem_bytes"],
                 second_route=dict(shape=second_shape, max_abs_err=second[name]))
        print("redesign %s (the leaf on a cluster of %d blocks, %d lanes a "
              "leaf block; %d blocks in all, one grid barrier an inner "
              "block): %s: kernel %.4f ms (%.4f ms before the redesign), "
              "lu_factor + solve_triangular %.4f ms, bound %.5f ms (%s); the "
              "shared-memory leaf at %s: max_abs_err %.3e" % (
                  name, plan["cluster"], -(-m // plan["cluster"]), plan["grid"],
                  r["shape"], r["ms"], before, r["library_ms"], r["bound_ms"],
                  r["bound_by"], second_shape, second[name]), flush=True)
    return out


def _panel_plan(kernels, dev, name: str, m: int, w: int, ib: int) -> dict:
    """An LU panel kernel's launch for a (w, m) panel: its grid and leaf
    cluster (``slate_<name>_plan``), one block's shared memory
    (``slate_<name>_smem_bytes``; the launch asks for at least half an
    SM's) and the ptxas lines of its two instantiations, printed and
    returned."""
    import ctypes
    from slate_tpu_torch.ops import _build

    grid, cluster = kernels.lu_panel_plan(name, dev, m, w, ib)
    c_bytes = getattr(_build.library(name), "slate_%s_smem_bytes" % name)
    c_bytes.argtypes, c_bytes.restype = [ctypes.c_int] * 3, ctypes.c_int64
    smem_bytes = int(c_bytes(m, w, ib))
    log = _build.lib_path(name)
    ptxas = [ln.split("info    :")[-1].strip() for ln in log.with_name(
        log.name + ".log").read_text().splitlines()
        if "registers" in ln or "spill" in ln]
    print("%s at (m, w, ib) = (%d, %d, %d): %d blocks of 256 threads in clusters "
          "of %d (cooperative), %d B dynamic shared memory a block by the "
          "formula; ptxas %s" % (
              name, m, w, ib, grid, cluster, smem_bytes, " | ".join(ptxas)),
          flush=True)
    return dict(grid=grid, cluster=cluster, smem_bytes=smem_bytes, ptxas=ptxas)


def device_split(torch, label: str, fn, kernels_by_key: dict) -> dict:
    """Where one call of ``fn`` spends device time, from a torch.profiler
    trace: each kernel of ``kernels_by_key`` (key -> symbol substring)
    and everything else (cuBLAS/cuSOLVER, copies, elementwise ops).
    Printed and returned; a trace with no device time prints 'not
    measured' and returns {}.  A failure of ``fn`` fails the run."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split = dict.fromkeys(list(kernels_by_key) + ["other"], 0.0)
    for ev in prof.key_averages():
        # kernel events only: a CPU op's self device time repeats the
        # kernels it launched
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if not us:
            continue
        key = next((k for k, sym in kernels_by_key.items() if sym in ev.key),
                   "other")
        split[key] += us / 1e3
    total = sum(split.values())
    if not total:
        print("%s split: not measured (no device time in the trace)" % label,
              flush=True)
        return {}
    print("%s split (device ms from torch.profiler): %s; total %.3f"
          % (label, ", ".join("%s %.3f" % kv for kv in split.items()), total),
          flush=True)
    return split


def lu_split(torch, st, A, b, label: str) -> None:
    """Device split of one more gesv; the caller picks the driver."""
    device_split(torch, "LU (%s gesv)" % label, lambda: st.gesv(A, b),
                 {"lu panel kernel": "lu_panel_cluster_kernel",
                  "matmul kernel": "matmul_f32_kernel"})


def run_path(torch, kernels, path: str, fn):
    """Run ``fn`` with every launch count set to 0 just before it and
    read just after it; fail unless each kernel of ``path`` launched.
    Returns ``(fn's result, host wall ms, launches)``."""
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(kernels.launches)
    missing = [k for k in PATHS[path] if launches[k] <= 0]
    if missing:
        fail("the %s path launched no %s kernel" % (path, ", ".join(missing)))
    return out, ms, launches


def first_pivot_difference(torch, lu_s, perm_s, lu_r, perm_r,
                           tags=("scattered", "rec")):
    """The first column where the two drivers chose different pivot rows,
    with both candidates' updated magnitudes in each driver's factor: a
    pivot's is |U[j, j]|, the other row's |L[i, j]|·|U[j, j]|.  None when
    the pivots agree."""
    diff = (perm_s != perm_r).nonzero()
    if not diff.numel():
        return None
    j = int(diff[0, 0])
    out = {"column": j, "rows": (int(perm_s[j]), int(perm_r[j]))}
    for tag, lu, perm, other in ((tags[0], lu_s, perm_s, perm_r[j]),
                                 (tags[1], lu_r, perm_r, perm_s[j])):
        pos = int((perm == other).nonzero()[0, 0])
        u = abs(float(lu[j, j]))
        out[tag] = (u, abs(float(lu[pos, j])) * u)
    return out


def main_path_lu(torch, st, kernels, dev) -> dict:
    """Phase 3b: gesv through the scattered driver (the default sites),
    gesv through the blocked recursion (``config.scattered_lu`` off) and
    getri of the first factor, each a path of its own for the launch
    gates, with the reference tester's checks."""
    from slate_tpu_torch import config

    gen = torch.Generator(device=dev).manual_seed(4)
    eps = float(torch.finfo(torch.float32).eps)
    a = torch.randn((N, N), generator=gen, device=dev)   # the tester's gesv A
    b = torch.randn((N, NRHS), generator=gen, device=dev)
    A = st.Matrix.from_array(a, nb=NB)
    torch.cuda.synchronize()

    (lu_s, perm_s, x_s), ms_s, l_s = run_path(
        torch, kernels, "lu_scattered", lambda: st.gesv(A, b))
    saved = config.scattered_lu
    config.scattered_lu = False
    try:
        (lu_r, perm_r, x_r), ms_r, l_r = run_path(
            torch, kernels, "lu_rec", lambda: st.gesv(A, b))
    finally:
        config.scattered_lu = saved
    inv, ms_i, l_i = run_path(torch, kernels, "getri",
                              lambda: st.getri(lu_s, perm_s))

    for name, t in (("scattered factor", lu_s.data), ("x", x_s),
                    ("rec factor", lu_r.data), ("rec x", x_r),
                    ("inverse", inv.data)):
        if not bool(torch.isfinite(t).all()):
            fail("%s has non-finite values" % name)
    ad = a.double()
    res = {}
    for tag, x in (("gesv_scattered", x_s), ("gesv_rec", x_r)):
        xd = x.double()
        res[tag + "_residual"] = float((ad @ xd - b.double()).norm()
                                       / (ad.norm() * xd.norm() * eps * N))
    invd = inv.data.double()
    cond1 = float(torch.linalg.matrix_norm(ad, 1)
                  * torch.linalg.matrix_norm(invd, 1))
    res["getri_residual"] = float(
        (invd @ ad - torch.eye(N, device=dev, dtype=torch.float64)).norm()
        / (eps * N * cond1))
    lmax = max(float(torch.tril(lu_s.data, -1).abs().max()),
               float(torch.tril(lu_r.data, -1).abs().max()))
    res.update(L_max=lmax, pivots_differing=int((perm_s != perm_r).sum()),
               gesv_scattered_ms=ms_s, gesv_rec_ms=ms_r, getri_ms=ms_i,
               launches={"lu_scattered": l_s, "lu_rec": l_r, "getri": l_i})
    print("LU path n=%d nb=%d nrhs=%d: gesv scattered %.1f ms (residual "
          "%.3g; launches %s), gesv rec %.1f ms (residual %.3g; launches "
          "%s), getri %.1f ms (residual %.3g; launches %s); max |L| %.7f; "
          "%d of %d pivots differ between the drivers"
          % (N, NB, NRHS, ms_s, res["gesv_scattered_residual"], l_s, ms_r,
             res["gesv_rec_residual"], l_r, ms_i, res["getri_residual"], l_i,
             lmax, res["pivots_differing"], N), flush=True)
    d = first_pivot_difference(torch, lu_s.data, perm_s, lu_r.data, perm_r)
    if d is not None:
        print("first pivot difference: column %d, rows %d (scattered) and %d "
              "(rec); in the scattered factor |pivot| %.9g vs the rec row "
              "%.9g; in the rec factor |pivot| %.9g vs the scattered row %.9g"
              % (d["column"], d["rows"][0], d["rows"][1], *d["scattered"],
                 *d["rec"]), flush=True)
    for label, on in (("scattered", True), ("rec", False)):
        config.scattered_lu = on
        try:
            lu_split(torch, st, A, b, label)
        finally:
            config.scattered_lu = saved
    print("context: torch.linalg.solve on the same A and B %.1f ms"
          % cuda_ms(torch, lambda: torch.linalg.solve(a, b), 3), flush=True)
    for name in ("gesv_scattered", "gesv_rec", "getri"):
        if not res[name + "_residual"] <= 3:
            fail("%s residual %.3f > 3" % (name, res[name + "_residual"]))
    if not lmax <= 1 + 100 * eps:
        fail("|L| = %.7f > 1 + 100 eps: not partial pivoting" % lmax)
    return res


def _batched_lu_gates(torch, label, a, out, piv, ref) -> float:
    """The gates of one getrf_batched call on the (B, n, n) batch ``a``
    (untransposed): pivots equal to the plain version's problem by
    problem — a differing column must be a near-tie (the two candidates
    within 1e-5 relative), printed with both magnitudes, and that
    problem's later columns are not compared — the factored batch within
    1e-4 (relative Frobenius) of the plain version's elsewhere, every
    problem's ‖L·U − A[perm]‖/(‖A‖·ε·n) ≤ 3 and |L| ≤ 1 + 100ε.  Returns
    the max abs difference over what was compared."""
    eps = float(torch.finfo(torch.float32).eps)
    rout, rpiv = ref
    bsz, n, _ = a.shape
    same = torch.ones(bsz, dtype=torch.bool, device=a.device)
    errs = []
    for b in (piv != rpiv).any(dim=1).nonzero()[:, 0].tolist():
        j = int((piv[b] != rpiv[b]).nonzero()[0, 0])
        pk, pp = int(piv[b, j]), int(rpiv[b, j])
        mk = abs(float(out[b, j, pk]))
        mp = abs(float(out[b, j, pp])) * mk     # |multiplier| · |pivot|
        print("%s problem %d: first differing pivot at column %d: lanes %d "
              "(kernel, |x| %.9g) and %d (plain, |x| %.9g)"
              % (label, b, j, pk, mk, pp, mp), flush=True)
        if not abs(mk - mp) <= 1e-5 * mk:
            fail("%s problem %d: pivot %d differs from the plain version's "
                 "and is not a near-tie" % (label, b, j))
        same[b] = False
        errs.append(float((out[b, :j] - rout[b, :j]).abs().max()) if j else 0.0)
    if bool(same.any()):
        err = rel_err(out[same], rout[same])
        if not err <= 1e-4:
            fail("%s disagrees with its plain version: rel %.3e" % (label, err))
        errs.append(float((out[same] - rout[same]).abs().max()))
    lu = out.gather(2, piv[:, None, :].expand_as(out)).mT.double()
    low = torch.tril(lu, -1) + torch.eye(n, dtype=torch.float64, device=a.device)
    ap = a.double().gather(1, piv[:, :, None].expand_as(a))
    res = ((low @ torch.triu(lu) - ap).norm(dim=(1, 2))
           / (a.double().norm(dim=(1, 2)) * eps * n))
    lmax = float(torch.tril(lu, -1).abs().max())
    if not (float(res.max()) <= 3 and lmax <= 1 + 100 * eps):
        fail("%s: factor residual %.3g (<= 3), max |L| %.7f"
             % (label, float(res.max()), lmax))
    return max(errs)


def _potrf_batched_gates(torch, kernels, spd, label: str):
    """The gates of one potrf_batched call on the SPD batch ``spd`` (stale
    values above each diagonal): 1e-4 (relative Frobenius) of the plain
    version, every problem's ‖L·Lᵀ − A‖/(‖A‖·ε·n) ≤ 3, zeros above the
    diagonal.  Returns ``(L, rel, residual)``."""
    eps = float(torch.finfo(torch.float32).eps)
    n = spd.shape[-1]
    l, lp = kernels.potrf_batched(spd), kernels.potrf_batched_plain(spd)
    torch.cuda.synchronize()
    err = rel_err(l, lp)
    ld, ad = l.double(), torch.tril(spd.double())
    ad = ad + torch.tril(ad, -1).mT
    res = float(((ld @ ld.mT - ad).norm(dim=(1, 2))
                 / (ad.norm(dim=(1, 2)) * eps * n)).max())
    if not (err <= 1e-4 and res <= 3 and bool((torch.triu(l, 1) == 0).all())):
        fail("%s: rel %.3e, residual %.3g" % (label, err, res))
    return l, lp, err, res


def _batched_spd(torch, gen, dev, bsz: int, n: int):
    g = torch.randn((bsz, n, n), generator=gen, device=dev)
    spd = g @ g.mT + n * torch.eye(n, device=dev)
    return g, torch.tril(spd) + torch.triu(torch.full_like(spd, 1e3), 1)


def batched_launch_plan(kernels, dev, name: str, n: int) -> dict:
    """A batched kernel's launch at n from its plan (the kernel's C entry,
    which ``ops/smem.py`` restates): the route, the cluster (getrf) and
    one block's shared memory, with the ptxas line (registers, spill) of
    the route's entry; printed and returned."""
    from slate_tpu_torch.ops import _build
    from slate_tpu_torch.perf.kernel_phases import ptxas_lines

    plan = kernels.batched_plan(name, dev, n)
    route, nbytes = plan[0], plan[-1]
    cluster = plan[1] if len(plan) == 3 else 1
    key = {("potrf_batched", "smem"): "potrf_batched_smem_kernel",
           ("potrf_batched", "l2"): "potrf_batched_kernelE",
           ("getrf_batched", "smem"): "cluster_kernelILi%dE" % -(-n // 256),
           ("getrf_batched", "l2"): "getrf_batched_kernelE"}[name, route]
    log = _build.lib_path(name)
    ptxas = ptxas_lines(log.with_name(log.name + ".log"), key)
    shape = {("potrf_batched", "smem"): "one block of 512 threads a problem",
             ("potrf_batched", "l2"): "one block of 1024 threads a problem",
             ("getrf_batched", "smem"): "a cluster of %d blocks of 256 threads "
                                        "a problem" % cluster,
             ("getrf_batched", "l2"): "one block of 256 threads a problem"}
    print("%s at n = %d: route %s, %s, %d B shared memory a block (plan); "
          "ptxas %s" % (name, n, route, shape[name, route], nbytes,
                        " | ".join(ptxas)), flush=True)
    return dict(route=route, cluster=cluster, smem_bytes=nbytes, ptxas=ptxas)


def batched_route_edges(smem) -> dict:
    """Each batched kernel's two routes at their boundary: the largest n
    of the on-chip route and the smallest of the l2 route, among the n
    the shape gate admits (to 1024)."""
    edges = {}
    for name in ("potrf_batched", "getrf_batched"):
        ns = [n for n in range(32, 1025, 32) if smem.batched_fits(name, n)]
        plan = getattr(smem, name + "_plan")
        edges[name] = (max(n for n in ns if plan(n)[0] == "smem"),
                       min(n for n in ns if plan(n)[0] == "l2"))
    return edges


def check_batched_kernels(torch, kernels, dev) -> dict:
    """Phase 2c: the batched kernels against their plain versions at the
    drivers' (B, n) = (64, 256), at n = 32, 64, 128 (B = 16, the served
    batch) and at each route's boundary (B = 4: the largest n of the
    on-chip route and the smallest of the l2 route), on plain Gaussian
    problems so that the argmax really chooses; each launch's plan
    (route, cluster, registers, spill, shared memory) printed; times at
    (64, 256) and at the served (16, 256), with a ``redesign`` line beside
    the time before the on-chip redesign."""
    from slate_tpu_torch.ops import smem

    gen = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for bsz, n in ((SERVE_BATCH, 32), (SERVE_BATCH, 64), (SERVE_BATCH, 128),
                   (BATCH, BATCH_N)):
        g, spd = _batched_spd(torch, gen, dev, bsz, n)
        l, lp, err, res = _potrf_batched_gates(
            torch, kernels, spd, "potrf_batched (%d, %d)" % (bsz, n))
        at = g.mT.contiguous()                    # plain Gaussian, transposed
        o, p = kernels.getrf_batched(at)
        ref = kernels.getrf_batched_plain(at)
        torch.cuda.synchronize()
        lu_err = _batched_lu_gates(torch, "getrf_batched (%d, %d)" % (bsz, n),
                                   g, o, p, ref)
        print("batched kernels at (%d, %d): potrf rel %.3e residual %.3g; "
              "getrf max abs diff %.3e, pivots equal to the plain version's"
              % (bsz, n, err, res, lu_err), flush=True)
    plans = {name: batched_launch_plan(kernels, dev, name, BATCH_N)
             for name in ("potrf_batched", "getrf_batched")}
    # each route at its boundary
    edges = batched_route_edges(smem)
    second = {name: {} for name in edges}
    for name, (n_on, n_off) in edges.items():
        for n in (n_on, n_off):
            plan = batched_launch_plan(kernels, dev, name, n)
            g4, spd4 = _batched_spd(torch, gen, dev, 4, n)
            label = "%s (4, %d), route %s" % (name, n, plan["route"])
            if name == "potrf_batched":
                l4, lp4, e4, _ = _potrf_batched_gates(torch, kernels, spd4, label)
                e4 = float((l4 - lp4).abs().max())
            else:
                at4 = g4.mT.contiguous()
                o4, p4 = kernels.getrf_batched(at4)
                e4 = _batched_lu_gates(torch, label, g4, o4, p4,
                                       kernels.getrf_batched_plain(at4))
            print("%s: max_abs_err %.3e, gates passed" % (label, e4), flush=True)
            second[name]["n%d_%s" % (n, plan["route"])] = dict(
                max_abs_err=e4, cluster=plan["cluster"], smem_bytes=plan["smem_bytes"])

    def flops(name, bsz):
        return bsz * BATCH_N ** 3 / 3.0 * (1 if name == "potrf_batched" else 2)

    def nbytes(name, bsz):
        # potrf_batched reads each problem's lower triangle and writes the
        # whole factor; getrf_batched reads and writes whole problems + pivots
        if name == "potrf_batched":
            return 4.0 * bsz * (BATCH_N * (BATCH_N + 1) / 2 + BATCH_N ** 2)
        return 2.0 * 4 * bsz * BATCH_N ** 2 + 8.0 * bsz * BATCH_N

    def cusolver(fn, arg):
        def call():
            saved = torch.backends.cuda.preferred_linalg_library()
            torch.backends.cuda.preferred_linalg_library("cusolver")
            try:
                return fn(arg)
            finally:
                torch.backends.cuda.preferred_linalg_library(saved)
        return call

    g16, spd16 = _batched_spd(torch, gen, dev, SERVE_BATCH, BATCH_N)
    at16 = g16.mT.contiguous()
    for name, arg, lib, lib_arg, err, arg16, lib_arg16 in (
            ("potrf_batched", spd, torch.linalg.cholesky, spd,
             float((l - lp).abs().max()), spd16, spd16),
            ("getrf_batched", at, torch.linalg.lu_factor, g, lu_err, at16, g16)):
        b_ms, b_by = bound(flops(name, BATCH), nbytes(name, BATCH))
        b16_ms, _ = bound(flops(name, SERVE_BATCH), nbytes(name, SERVE_BATCH))
        kern, plain = getattr(kernels, name), getattr(kernels, name + "_plain")
        plan = plans[name]
        out[name] = dict(
            shape="(%d,%d,%d)" % (BATCH, BATCH_N, BATCH_N), max_abs_err=err,
            tol="pivots exact (near-ties reported), rel 1e-4"
            if name == "getrf_batched" else "rel Frobenius <= 1e-4",
            ms=cuda_ms(torch, lambda: kern(arg), 20),
            plain_ms=cuda_ms(torch, lambda: plain(arg), 2),
            library_ms=cuda_ms(torch, cusolver(lib, lib_arg), 20),
            bound_ms=b_ms, bound_by=b_by,
            b16_ms=cuda_ms(torch, lambda: kern(arg16), 20),
            b16_library_ms=cuda_ms(torch, cusolver(lib, lib_arg16), 20),
            b16_bound_ms=b16_ms, batched_route=plan["route"],
            cluster=plan["cluster"], smem_bytes=plan["smem_bytes"],
            second_route=second[name])
        r = out[name]
        print("kernel %s %s: max_abs_err %.3e (%s); kernel %.4f ms, plain "
              "%.4f ms, library %.4f ms, bound %.5f ms (%s); at (%d,%d,%d) kernel "
              "%.4f ms, library %.4f ms, bound %.5f ms"
              % (name, r["shape"], r["max_abs_err"], r["tol"], r["ms"],
                 r["plain_ms"], r["library_ms"], r["bound_ms"], r["bound_by"],
                 SERVE_BATCH, BATCH_N, BATCH_N, r["b16_ms"], r["b16_library_ms"],
                 r["b16_bound_ms"]), flush=True)
        before = BATCHED_BEFORE_MS[name]
        print("redesign %s (%s on chip at n = %d, route %s, %s): (%d,%d) kernel "
              "%.4f ms (%.4f ms before the redesign), (%d,%d) kernel %.4f ms (%.4f "
              "ms before), %s %.4f / %.4f ms; the l2 route from n = %d"
              % (name, "each problem's lower triangle" if name == "potrf_batched"
                 else "each problem", edges[name][0], plan["route"],
                 "one block a problem" if name == "potrf_batched" else
                 "clusters of %d blocks" % plan["cluster"], BATCH, BATCH_N,
                 r["ms"], before[0], SERVE_BATCH, BATCH_N, r["b16_ms"], before[1],
                 "batched cholesky" if name == "potrf_batched" else
                 "batched lu_factor", r["library_ms"], r["b16_library_ms"],
                 edges[name][1]), flush=True)
    return out


def _bench_resid(torch, a, b, x) -> float:
    """bench.py:410-416's criterion, the max over the problems of
    ‖A·x − b‖/(‖A‖·‖b‖·ε·n)."""
    eps = float(torch.finfo(torch.float32).eps)
    a, b, x = a.double(), b.double(), x.double()
    r = ((a @ x[..., None])[..., 0] - b).norm(dim=-1)
    den = a.norm(dim=(1, 2)) * b.norm(dim=-1) * eps * a.shape[-1]
    return float((r / den).max())


def _wall_ms(torch, fn, reps: int = 5) -> float:
    """Median host wall time of ``fn`` ending in a synchronize."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[reps // 2]


def main_path_batched(torch, st, kernels, dev) -> dict:
    """Phase 3c: posv_batched and gesv_batched at (B, n) = (64, 256) on
    bench.py's inputs (bench.py:425-431, :447-452), each a path of its
    own with one launch of its kernel, every problem's residual <= 3."""
    import numpy as np

    n, bsz = BATCH_N, BATCH
    eye = np.eye(n, dtype=np.float32)
    rng = np.random.default_rng(11)
    g = rng.standard_normal((bsz, n, n)).astype(np.float32)
    spd = g @ g.transpose(0, 2, 1) + n * eye
    rhs_p = rng.standard_normal((bsz, n)).astype(np.float32)
    rng = np.random.default_rng(12)
    a = rng.standard_normal((bsz, n, n)).astype(np.float32) + n * eye
    rhs_g = rng.standard_normal((bsz, n)).astype(np.float32)
    tp, tbp, ta, tbg = (torch.from_numpy(v).to(dev)
                        for v in (spd, rhs_p, a, rhs_g))
    torch.cuda.synchronize()
    (_, xp), ms_p, l_p = run_path(torch, kernels, "batched_posv",
                                  lambda: st.posv_batched(tp, tbp))
    (_, _, xg), ms_g, l_g = run_path(torch, kernels, "batched_gesv",
                                     lambda: st.gesv_batched(ta, tbg))
    res = {"posv_batched_residual": _bench_resid(torch, tp, tbp, xp),
           "gesv_batched_residual": _bench_resid(torch, ta, tbg, xg),
           "posv_batched_first_ms": ms_p, "gesv_batched_first_ms": ms_g,
           "posv_batched_ms": _wall_ms(torch, lambda: st.posv_batched(tp, tbp)),
           "gesv_batched_ms": _wall_ms(torch, lambda: st.gesv_batched(ta, tbg)),
           "launches": {"batched_posv": l_p, "batched_gesv": l_g}}
    print("batched path (B=%d, n=%d): posv_batched %.2f ms (first call %.1f "
          "ms, residual %.3g; launches %s), gesv_batched %.2f ms (first call "
          "%.1f ms, residual %.3g; launches %s)"
          % (bsz, n, res["posv_batched_ms"], ms_p, res["posv_batched_residual"],
             l_p, res["gesv_batched_ms"], ms_g, res["gesv_batched_residual"],
             l_g), flush=True)
    for name in ("posv_batched", "gesv_batched"):
        if not res[name + "_residual"] <= 3:
            fail("%s residual %.3f > 3" % (name, res[name + "_residual"]))
    for path, launches, kernel in (("batched_posv", l_p, "potrf_batched"),
                                   ("batched_gesv", l_g, "getrf_batched")):
        if launches[kernel] != 1:
            fail("%s launched %s %d times, not once"
                 % (path, kernel, launches[kernel]))
    # each kernel's name matches both of its routes' __global__ functions
    res["posv_batched_split"] = device_split(
        torch, "posv_batched", lambda: st.posv_batched(tp, tbp),
        {"potrf_batched kernel": "potrf_batched"})
    res["gesv_batched_split"] = device_split(
        torch, "gesv_batched", lambda: st.gesv_batched(ta, tbg),
        {"getrf_batched kernel": "getrf_batched"})
    return res


def serve_path(torch, kernels) -> dict:
    """Phase 3d: the serving queue on the card — warm_start for posv and
    gesv at n = 256 and batch 16, then 192 posv and 192 gesv requests
    from 4 submitter threads (bench.py:462-530's configuration, gesv on
    plain Gaussian problems).  Gates every answer's residual, the
    degradation counters (retries, singles, short circuits, errors and
    on-demand builds all 0) and each kernel's launches against its op's
    batched dispatches.  Prints requests/s and the client-observed p50
    and p99 latency, submit to future resolution."""
    import threading

    import numpy as np
    from slate_tpu_torch import serve
    from slate_tpu_torch.perf import metrics

    n = BATCH_N
    rng = np.random.default_rng(21)
    mats = {"posv": [], "gesv": []}
    for _ in range(4):
        g = rng.standard_normal((n, n)).astype(np.float32)
        mats["posv"].append(g @ g.T + n * np.eye(n, dtype=np.float32))
        mats["gesv"].append(rng.standard_normal((n, n)).astype(np.float32))
    rhs = [rng.standard_normal(n).astype(np.float32) for _ in range(4)]
    reqs = [("posv" if i % 2 == 0 else "gesv", (i // 2) % 4, i % 4)
            for i in range(2 * SERVE_REQS)]

    metrics.on()
    srv = serve.BatchQueue(serve.ServeConfig(max_batch=SERVE_BATCH,
                                             max_wait_s=0.002))
    try:
        built = serve.warm_start(srv, specs=[
            {"op": op, "batch": SERVE_BATCH, "dims": (n,)}
            for op in ("posv", "gesv")])
        torch.cuda.synchronize()
        kernels.reset_launches()
        before = metrics.snapshot()
        futs = [None] * len(reqs)
        t_sub = [0.0] * len(reqs)
        t_done = [0.0] * len(reqs)

        def done_at(i):
            def cb(_):
                t_done[i] = time.perf_counter()
            return cb

        def worker(k):
            for i in range(k, len(reqs), SERVE_THREADS):
                op, m, r = reqs[i]
                t_sub[i] = time.perf_counter()
                futs[i] = srv.submit(op, mats[op][m], rhs[r])
                futs[i].add_done_callback(done_at(i))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(SERVE_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        xs = [f.result(timeout=300) for f in futs]
        wall = time.perf_counter() - t0
        launches = dict(kernels.launches)
        delta = metrics.snapshot_delta(before, metrics.snapshot())
    finally:
        srv.close()
    eps = float(np.finfo(np.float32).eps)
    worst = 0.0
    for (op, m, r), x in zip(reqs, xs):
        a, b = mats[op][m].astype(np.float64), rhs[r].astype(np.float64)
        worst = max(worst, float(np.linalg.norm(a @ x - b) / (
            np.linalg.norm(a) * np.linalg.norm(b) * eps * n)))
    lat = np.asarray([d - s for s, d in zip(t_sub, t_done)]) * 1e3
    c = delta["counters"]
    n_disp = c.get("serve.dispatches", 0.0)
    execute = delta["timers"].get("serve.dispatch", {"total_s": 0.0})
    wait = delta["timers"].get("serve.wait", {"total_s": 0.0})
    res = {"requests": len(reqs), "requests_per_s": len(reqs) / wall,
           "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)),
           "residual": worst, "warm_built": built,
           "dispatches": {op: c.get("serve.dispatches." + op, 0.0)
                          for op in ("posv", "gesv")},
           # host clock: wall per dispatch, of it the executable (copies
           # in, driver, copies out), and a request's mean queue wait
           "wall_ms_per_dispatch": wall * 1e3 / max(n_disp, 1.0),
           "execute_ms_per_dispatch": execute["total_s"] * 1e3
           / max(n_disp, 1.0),
           "wait_ms_per_request": wait["total_s"] * 1e3 / len(reqs),
           "launches": {"serve": launches}}
    print("serve path (n=%d, max_batch %d, %d requests from %d threads): "
          "%.1f requests/s, p50 %.2f ms, p99 %.2f ms (submit to resolution); "
          "dispatches %s, %.2f ms of wall each, of it %.2f ms executing "
          "(host clock); mean queue wait %.2f ms; launches %s; worst "
          "residual %.3g; %d executables built by warm_start"
          % (n, SERVE_BATCH, len(reqs), SERVE_THREADS, res["requests_per_s"],
             res["p50_ms"], res["p99_ms"], res["dispatches"],
             res["wall_ms_per_dispatch"], res["execute_ms_per_dispatch"],
             res["wait_ms_per_request"], launches, worst, built), flush=True)
    if not worst <= 3:
        fail("served residual %.3f > 3" % worst)
    bad = {k: c[k] for k in ("serve.retries", "serve.fallback.singles",
                             "serve.breaker.short_circuit", "serve.errors",
                             "serve.compile.on_demand") if c.get(k)}
    if bad:
        fail("the serve path degraded: %s" % bad)
    for op, kernel in (("posv", "potrf_batched"), ("gesv", "getrf_batched")):
        if not 0 < launches[kernel] == res["dispatches"][op]:
            fail("serve: %s launched %d times for %d %s dispatches"
                 % (kernel, launches[kernel], res["dispatches"][op], op))
    return res


def once_ms(torch, fn):
    """Device time of one call of ``fn`` from CUDA events, and its
    result."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def event_ms(torch, fn, setup=None, reps: int = 3) -> float:
    """Mean device time of ``fn`` alone over ``reps`` calls
    (:func:`once_ms`), after one untimed call; ``setup`` (not timed) runs
    before each."""
    total = 0.0
    for i in range(reps + 1):
        if setup:
            setup()
        ms, _ = once_ms(torch, fn)
        total += ms if i else 0.0
    return total / reps


def _cusolver(torch, fn):
    """``fn`` with cuSOLVER as PyTorch's linear-algebra library."""
    def call():
        saved = torch.backends.cuda.preferred_linalg_library()
        torch.backends.cuda.preferred_linalg_library("cusolver")
        try:
            return fn()
        finally:
            torch.backends.cuda.preferred_linalg_library(saved)
    return call


def _lu_factor_gates(torch, label, a, lu, perm):
    """‖L·U − A[perm]‖/(‖A‖·ε·n) ≤ 3 and |L| ≤ 1 + 100ε of a packed
    factor; returns the residual."""
    eps = float(torch.finfo(torch.float32).eps)
    n = a.shape[0]
    lu = lu.double()
    low = torch.tril(lu, -1) + torch.eye(n, dtype=torch.float64, device=a.device)
    ad = a.double()
    res = float((low @ torch.triu(lu) - ad[perm]).norm() / (ad.norm() * eps * n))
    lmax = float(torch.tril(lu, -1).abs().max())
    if not (res <= 3 and lmax <= 1 + 100 * eps):
        fail("%s: factor residual %.3g (<= 3), max |L| %.7f" % (label, res, lmax))
    return res


def _potrf_fused_gates(torch, kernels, spd, nb: int, k0s) -> dict:
    """potrf_step_fused at each k0 of ``k0s`` (0, nb, … in turn) on the
    kernel's own carry, against the plain step from the same carry (rel
    ≤ 1e-4, no row above k0 written), its L11 bitwise chol_inv_panel's L
    of the same diagonal block (both are tri_grid.cuh's chol_inv_grid: a
    witness independent of the chain); potrf_full_fused against its plain
    version (rel ≤ 1e-4), bitwise the chain of all its steps, factor
    residual ≤ 3.  Returns the max abs differences from the plain
    versions and the plain versions' ms (the step's at k0 = 0)."""
    eps = float(torch.finfo(torch.float32).eps)
    n = spd.shape[0]
    ak, errs, plain_ms = spd.clone(), [], []
    for k0 in k0s:
        before, ap = ak.clone(), ak.clone()
        kernels.potrf_step_fused(ak, k0, nb=nb)
        ms, _ = once_ms(torch, lambda: kernels.potrf_step_fused_plain(ap, k0, nb=nb))
        plain_ms.append(ms)
        err = rel_err(ak, ap)
        if not (err <= 1e-4 and torch.equal(ak[:k0], before[:k0])):
            fail("potrf_step_fused n=%d k0=%d: rel %.3e of its plain version, "
                 "or it wrote rows above k0" % (n, k0, err))
        blk = slice(k0, k0 + nb)
        l11, _ = kernels.chol_inv_panel(before[blk, blk])
        if not torch.equal(ak[blk, blk], l11):
            fail("potrf_step_fused n=%d k0=%d: L11 is not bitwise chol_inv_panel's"
                 % (n, k0))
        errs.append(float((ak - ap).abs().max()))
    del ak, before, ap
    chain = spd.clone()
    for k0 in range(0, n, nb):
        kernels.potrf_step_fused(chain, k0, nb=nb)
    af = kernels.potrf_full_fused(spd.clone(), nb=nb)
    afp = spd.clone()
    full_plain_ms, _ = once_ms(torch, lambda: kernels.potrf_full_fused_plain(afp, nb=nb))
    low = torch.tril(af).double()
    res = float((low @ low.T - spd.double()).norm() / (spd.double().norm() * eps * n))
    err = rel_err(af, afp)
    if not (err <= 1e-4 and res <= 3 and torch.equal(af, chain)):
        fail("potrf_full_fused n=%d: rel %.3e of its plain version, residual "
             "%.3g, bitwise equal to the step chain: %s"
             % (n, err, res, torch.equal(af, chain)))
    print("potrf fused kernels at n=%d nb=%d: step max abs diff %s (k0 = %s) "
          "from the plain step, L11 == chol_inv_panel's bitwise, full rel %.3e "
          "of the plain version, residual %.3g, full == step chain bitwise"
          % (n, nb, " / ".join("%.3e" % e for e in errs),
             ", ".join(map(str, k0s)), err, res), flush=True)
    return {"step_err": max(errs), "full_err": float((af - afp).abs().max()),
            "step_plain_ms": plain_ms[0], "full_plain_ms": full_plain_ms}


def _getrf_step_chain(torch, kernels, at0, nb: int, update: bool, steps: int):
    """getrf_step_fused for the first ``steps`` steps of the transposed
    carry ``at0`` (left as it is), each step held against the plain step
    from the same state: :func:`_panel_gates`, no row above k0 written,
    and the trailing rows within 1e-4 where the pivots agree; and its
    panel rows, pivots, mask and L11⁻¹ bitwise getrf_panel_fused's from
    the same state (lu_panel.cuh's panel phase, a witness independent of
    the chain).  Returns the kernel's carry, pivots and mask, the max abs
    difference from the plain steps, and the plain step's ms at k0 = 0."""
    n_rows, m = at0.shape
    ck, act = at0.clone(), torch.ones((1, m), device=at0.device)
    pivs, errs, plain_ms = [], [], []
    for k0 in range(0, nb * steps, nb):
        before, cp = ck.clone(), ck.clone()
        name = "getrf_step_fused (%d,%d) k0=%d update=%s" % (n_rows, m, k0, update)
        _, piv, act2, linv = kernels.getrf_step_fused(
            ck, act, k0, nb=nb, bb=LU_BB, ib=LU_IB, update=update)
        wp = before.clone()
        _, ppiv, pact, plinv = kernels.getrf_panel_fused(
            wp, act, k0, nb=nb, bb=LU_BB, ib=LU_IB)
        if not (torch.equal(ck[k0:k0 + nb], wp[k0:k0 + nb]) and torch.equal(piv, ppiv)
                and torch.equal(act2, pact) and torch.equal(linv, plinv)):
            fail("%s: panel rows, pivots, mask or linv not bitwise "
                 "getrf_panel_fused's from the same state" % name)
        del wp
        ms, (_, rpiv, ract, rlinv) = once_ms(
            torch, lambda: kernels.getrf_step_fused_plain(
                cp, act, k0, nb=nb, bb=LU_BB, ib=LU_IB, update=update))
        plain_ms.append(ms)
        if not torch.equal(ck[:k0], before[:k0]):
            fail("%s wrote rows above k0" % name)
        errs.append(_panel_gates(
            torch, name, before[k0:k0 + nb].T, ck[k0:k0 + nb], piv, act2,
            linv, (cp[k0:k0 + nb], rpiv, ract, rlinv)))
        if torch.equal(piv, rpiv) and k0 + nb < n_rows:
            err = rel_err(ck[k0 + nb:], cp[k0 + nb:])
            if not err <= 1e-4:
                fail("%s: trailing rows rel %.3e of the plain version's"
                     % (name, err))
            errs.append(float((ck - cp).abs().max()))
        act = act2
        pivs.append(piv)
    return ck, torch.cat(pivs), act, max(errs), plain_ms[0]


def _getrf_fused_gates(torch, kernels, a, nb: int, trsm_steps: int,
                       hold_whole: bool) -> dict:
    """getrf_step_fused over every step of A's transposed carry with its
    update on, and over the first ``trsm_steps`` with it off, each step
    against the plain step from the same state (:func:`_getrf_step_chain`);
    getrf_full_fused bitwise equal to the chain with the update on, factor
    residual ≤ 3 and |L| ≤ 1 + 100ε, and against its plain version: the
    two round differently step after step, so the factors drift apart
    (2.4e-4 relative at n = 2048 even on a κ₂ = 100 input, on an H100
    80GB HBM3).  With ``hold_whole`` the pivots must agree up to a
    near-tie (1e-5 relative in one of the factors); without it the first
    departure is only printed: over 16 steps the drift passes the tie
    width (at n = 8192 the factors' candidates at column 2825 were 1.6e-5
    and 9.8e-5 apart, on the same card), and every step was held from the
    same state.  Returns the max abs
    differences of the steps from the plain steps (the full kernel's are
    its chain's) and the plain versions' ms (the step's at k0 = 0)."""
    n = a.shape[0]
    at0 = a.T.contiguous()
    chain, cpiv, cact, err_on, step_plain_ms = _getrf_step_chain(
        torch, kernels, at0, nb, True, n // nb)
    err_off = _getrf_step_chain(torch, kernels, at0, nb, False, trsm_steps)[3]
    ck = at0.clone()
    _, piv, act_f = kernels.getrf_full_fused(
        ck, torch.ones((1, n), device=a.device), nb=nb, bb=LU_BB, ib=LU_IB)
    if not (torch.equal(ck, chain) and torch.equal(piv, cpiv)
            and torch.equal(act_f, cact)):
        fail("getrf_full_fused n=%d is not bitwise the chain of "
             "getrf_step_fused" % n)
    del chain
    res = _lu_factor_gates(torch, "getrf_full_fused", a, ck[:, piv].T, piv)
    cp = at0.clone()
    full_plain_ms, (_, rpiv, _) = once_ms(
        torch, lambda: kernels.getrf_full_fused_plain(
            cp, torch.ones((1, n), device=a.device), nb=nb, bb=LU_BB, ib=LU_IB))
    d = first_pivot_difference(torch, ck[:, piv].T, piv, cp[:, rpiv].T, rpiv,
                               tags=("kernel", "plain"))
    if d is None:
        tie = "pivots equal to the plain version's, rel %.3e" % rel_err(ck, cp)
    else:
        gaps = [abs(p - o) / p for p, o in (d["kernel"], d["plain"])]
        tie = ("near-tie at column %d: rows %d (kernel) and %d (plain); "
               "kernel factor %.9g vs %.9g, plain factor %.9g vs %.9g"
               % (d["column"], *d["rows"], *d["kernel"], *d["plain"]))
        if hold_whole and not min(gaps) <= 1e-5:
            fail("getrf_full_fused n=%d: pivots depart from the plain "
                 "version's, not at a near-tie: %s" % (n, tie))
    print("getrf fused kernels at n=%d nb=%d: every step max abs diff %.3e "
          "(update, %d steps) / %.3e (no update, %d steps) from the same "
          "state, pivots equal, panel == getrf_panel_fused's bitwise; full == "
          "step chain bitwise, residual %.3g; whole factorization vs plain: %s"
          % (n, nb, err_on, n // nb, err_off, trsm_steps, res, tie), flush=True)
    return {"step_err": max(err_on, err_off), "full_err": err_on,
            "step_plain_ms": step_plain_ms, "full_plain_ms": full_plain_ms}


def _launch_plan(kernels, dev, name: str, plan_args, smem_args) -> dict:
    """Kernel ``name``'s cooperative grid (``slate_<name>_plan(*plan_args)``),
    one block's shared memory (``slate_<name>_smem_bytes(*smem_args)``) and
    its ptxas lines (registers, spills), printed and returned."""
    import ctypes
    from slate_tpu_torch.ops import _build

    grid = kernels._plan(name, dev, *plan_args)
    c_bytes = getattr(_build.library(name), "slate_%s_smem_bytes" % name)
    # a dynamic share is a function of the grid too; a static one of nothing
    args = (*smem_args, grid) if smem_args else ()
    c_bytes.argtypes, c_bytes.restype = [ctypes.c_int] * len(args), ctypes.c_int64
    smem_bytes = int(c_bytes(*args))
    log = _build.lib_path(name)
    ptxas = [ln.split("info    :")[-1].strip() for ln in log.with_name(
        log.name + ".log").read_text().splitlines()
        if "registers" in ln or "spill" in ln]
    print("%s at %s: cooperative grid of %d x 256 threads, %d B %s shared memory "
          "a block; ptxas %s" % (name, plan_args, grid, smem_bytes,
                                 "dynamic" if smem_args else "static",
                                 " | ".join(ptxas)), flush=True)
    return dict(grid=grid, smem_bytes=smem_bytes, ptxas=ptxas)


def check_fused_kernels(torch, kernels, dev) -> dict:
    """Phase 2d: the fused and full kernels of potrf and getrf against
    their plain versions, at n = 2048 (nb = 512: the Cholesky step at
    k0 = 0 and 512, every LU step with the update on and off) and at the
    main path's n = 8192 (the Cholesky step at k0 = 0, every LU step with
    the update on and the first without it), with the gates of
    :func:`_potrf_fused_gates` and :func:`_getrf_fused_gates`; then each
    timed at n = 8192 (the step kernels at k0 = 0), its max abs error and
    plain time taken from the 8192 gates."""
    gen = torch.Generator(device=dev).manual_seed(6)
    n, t = FUSED_N, LU_NB

    def herm(k):        # the tester's herm(k)
        r = torch.randn((k, k), generator=gen, device=dev)
        return (r + r.T) / 2 + k * torch.eye(k, device=dev)

    _potrf_fused_gates(torch, kernels, herm(n), t, (0, t))
    _getrf_fused_gates(torch, kernels,
                       torch.randn((n, n), generator=gen, device=dev), t, n // t,
                       hold_whole=True)

    # the main path's n = 8192: gates, then CUDA events around the kernel
    # alone, each call starting from a fresh copy of the input
    N8 = N
    nt = N8 - t
    spd = herm(N8)
    pot = _potrf_fused_gates(torch, kernels, spd, t, (0,))
    w = torch.empty_like(spd)

    def reset_spd():
        w.copy_(spd)

    tiles = t * t * (nt // t) * (nt // t + 1) // 2     # the lower tile pairs
    step_flops = t ** 3 / 3.0 + nt * t * t + 2.0 * t * tiles
    step_bytes = 8.0 * (N8 * t + tiles)

    def library_potrf_step():
        l11 = torch.linalg.cholesky(w[:t, :t])
        l21 = torch.linalg.solve_triangular(l11.T, w[t:, :t], upper=True,
                                            left=False)
        w[t:, t:] -= l21 @ l21.T

    rows = []
    rows.append(("potrf_step_fused", dict(
        shape="(%d,%d) carry, k0=0, nb=%d tc=%d" % (N8, N8, t, t),
        max_abs_err=pot["step_err"], tol="rel Frobenius <= 1e-4",
        ms=event_ms(torch, lambda: kernels.potrf_step_fused(w, 0, nb=t),
                    reset_spd, 3),
        plain_ms=pot["step_plain_ms"],
        library_ms=event_ms(torch, _cusolver(torch, library_potrf_step),
                            reset_spd, 3),
        library="cholesky + solve_triangular + matmul (composition)",
        bound=bound(step_flops, step_bytes))))
    rows.append(("potrf_full_fused", dict(
        shape="(%d,%d), nb=%d tc=%d" % (N8, N8, t, t),
        max_abs_err=pot["full_err"],
        tol="rel Frobenius <= 1e-4, bitwise the step chain, residual <= 3",
        ms=event_ms(torch, lambda: kernels.potrf_full_fused(w, nb=t),
                    reset_spd, 2),
        plain_ms=pot["full_plain_ms"],
        library_ms=event_ms(torch, _cusolver(torch, lambda: torch.linalg.cholesky(
            spd)), None, 3),
        library="cholesky (cuSOLVER)",
        bound=bound(N8 ** 3 / 3.0, 8.0 * N8 * (N8 + 1) / 2))))
    del spd, w
    a8 = torch.randn((N8, N8), generator=gen, device=dev)
    lu = _getrf_fused_gates(torch, kernels, a8, t, 1, hold_whole=False)
    at8 = a8.T.contiguous()
    del a8
    w = torch.empty_like(at8)
    one8 = torch.ones((1, N8), device=dev)

    def reset_lu():
        w.copy_(at8)

    pan = at8[:t].T.contiguous()                     # A's first 512 columns

    def library_getrf_step():
        lu, _ = torch.linalg.lu_factor(pan)
        u12 = torch.linalg.solve_triangular(lu[:t], w[t:, :t].T, upper=False,
                                            unitriangular=True)
        w[t:, t:] -= (lu[t:] @ u12).T

    lu_step_flops = N8 * t * t - t ** 3 / 3.0 + nt * t * t + 2.0 * nt * t * nt
    rows.append(("getrf_step_fused", dict(
        shape="(%d,%d) carry, k0=0, nb=%d bb=%d ib=%d" % (N8, N8, t, LU_BB, LU_IB),
        max_abs_err=lu["step_err"],
        tol="every step vs plain from its state: pivots exact (near-ties "
            "reported), rel 1e-4",
        ms=event_ms(torch, lambda: kernels.getrf_step_fused(
            w, one8, 0, nb=t, bb=LU_BB, ib=LU_IB), reset_lu, 3),
        plain_ms=lu["step_plain_ms"],
        library_ms=event_ms(torch, _cusolver(torch, library_getrf_step),
                            reset_lu, 3),
        library="lu_factor + solve_triangular + matmul (composition, rows "
                "not gathered)",
        bound=bound(lu_step_flops, 8.0 * N8 * N8))))
    rows.append(("getrf_full_fused", dict(
        shape="(%d,%d) carry, nb=%d bb=%d ib=%d" % (N8, N8, t, LU_BB, LU_IB),
        max_abs_err=lu["full_err"],
        tol="bitwise the step chain, each step vs plain from its state: "
            "pivots exact (near-ties reported), rel 1e-4; residual <= 3",
        ms=event_ms(torch, lambda: kernels.getrf_full_fused(
            w, one8, nb=t, bb=LU_BB, ib=LU_IB), reset_lu, 2),
        plain_ms=lu["full_plain_ms"],
        library_ms=event_ms(torch, _cusolver(torch, lambda: torch.linalg.lu_factor(
            at8.T)), None, 3),
        library="lu_factor (cuSOLVER)",
        bound=bound(2.0 * N8 ** 3 / 3.0, 8.0 * N8 * N8))))
    # the redesigned kernels' launches: each cooperative grid, its
    # registers and spills (-Xptxas -v) and one block's shared memory
    # (dynamic for LU, static for the Cholesky step)
    plans = {name: _launch_plan(kernels, dev, name, args, smem_args)
             for name, args, smem_args in (
                 ("getrf_full_fused", (N8, t, LU_IB), (N8, t, LU_IB)),
                 ("getrf_step_fused", (N8, t, LU_IB), (N8, t, LU_IB)),
                 ("potrf_step_fused", (N8, t, t), ()))}
    # the LU step without its rank-nb update: the fused_trsm depth's
    # kernel, and the panel + X₂ + U + scatter share of the step
    no_update_ms = event_ms(torch, lambda: kernels.getrf_step_fused(
        w, one8, 0, nb=t, bb=LU_BB, ib=LU_IB, update=False), reset_lu, 3)
    print("kernel getrf_step_fused (%d,%d) carry, k0=0, update=False: "
          "%.4f ms" % (N8, N8, no_update_ms), flush=True)
    rd = dict(rows)
    rd["getrf_step_fused"]["no_update_ms"] = no_update_ms
    # each step kernel beside its time before its redesign (PERF.md §6,
    # rows 14 and 16: H100 80GB HBM3, 700 W)
    for name, before, tail in (
            ("getrf_step_fused", 8.2996, "; update=False %.4f ms" % no_update_ms),
            ("potrf_step_fused", 3.8383, "")):
        r = rd[name]
        print("redesign %s (one step of the full kernel's grid: %d x 256 threads, "
              "%d B shared memory a block): (%d,%d) carry, k0=0: kernel %.4f ms "
              "(%.4f ms before the redesign), %s %.4f ms, bound %.5f ms (%s)%s" % (
                  name, plans[name]["grid"], plans[name]["smem_bytes"], N8, N8,
                  r["ms"], before, r["library"], r["library_ms"], r["bound"][0],
                  r["bound"][1], tail), flush=True)
    out = {}
    for name, plan in plans.items():
        rd[name].update(grid=plan["grid"], smem_bytes=plan["smem_bytes"])
    for name, r in rows:
        r["bound_ms"], r["bound_by"] = r.pop("bound")
        out[name] = r
        print("kernel %s %s: max_abs_err %.3e (%s); kernel %.4f ms, plain "
              "%.4f ms, library %.4f ms (%s), bound %.5f ms (%s)"
              % (name, r["shape"], r["max_abs_err"], r["tol"], r["ms"],
                 r["plain_ms"], r["library_ms"], r.pop("library"),
                 r["bound_ms"], r["bound_by"]), flush=True)
    return out


def main_path_depths(torch, st, kernels, dev) -> dict:
    """Phase 3e: posv at the fused and full depths and gesv at fused_trsm,
    fused and full, through the public entry points with the depth pinned
    (SLATE_TPU_TORCH_AUTOTUNE_FORCE, set here per path), at n = 8192: the
    tester's residual gates, the exact launch counts of EXACT, the first
    column where each LU depth's pivots depart from the composed depth's,
    the median wall of every depth (the composed ones included), and a
    torch.profiler split of posv and gesv at full."""
    import os

    from slate_tpu_torch.perf import autotune

    gen = torch.Generator(device=dev).manual_seed(2)
    eps = float(torch.finfo(torch.float32).eps)
    r = torch.randn((N, N), generator=gen, device=dev)
    a = (r + r.T) / 2 + N * torch.eye(N, device=dev)     # the tester's herm(n)
    del r
    b = torch.randn((N, NRHS), generator=gen, device=dev)
    A = st.HermitianMatrix(a, uplo=st.Uplo.Lower, mb=NB, nb=NB)
    g = torch.randn((N, N), generator=gen, device=dev)   # the tester's gesv A
    G = st.Matrix.from_array(g, nb=NB)
    res, walls, launches = {}, {}, {}

    def pinned(pin, fn):
        os.environ[FORCE] = pin
        try:
            return fn()
        finally:
            del os.environ[FORCE]

    walls["posv composed"] = _wall_ms(torch, lambda: st.posv(A, b), 3)
    for depth in ("fused", "full"):
        path = "chol_" + depth
        (fac, x), ms, lc = pinned("potrf_step=" + depth, lambda: run_path(
            torch, kernels, path, lambda: st.posv(A, b)))
        if autotune.decisions()["potrf_step|%d,%d,float32,%s"
                                % (N, PANEL_NB, dev.type)] != depth:
            fail("posv did not take the %s depth" % depth)
        xd, ld = x.double(), fac.data.double()
        ad = a.double()
        res["posv_%s_residual" % depth] = float(
            (ad @ xd - b.double()).norm() / (ad.norm() * xd.norm() * eps * N))
        res["potrf_%s_residual" % depth] = float(
            (ld @ ld.T - ad).norm() / (ad.norm() * eps * N))
        walls["posv " + depth] = pinned("potrf_step=" + depth, lambda: _wall_ms(
            torch, lambda: st.posv(A, b), 3))
        launches[path] = lc
        del fac, x, xd, ld, ad
    (lu_c, perm_c, _), _, _ = run_path(torch, kernels, "lu_scattered",
                                       lambda: st.gesv(G, b))
    walls["gesv composed"] = _wall_ms(torch, lambda: st.gesv(G, b), 3)
    for depth in ("fused_trsm", "fused", "full"):
        path = "lu_" + depth
        (lu, perm, x), ms, lc = pinned("lu_step=" + depth, lambda: run_path(
            torch, kernels, path, lambda: st.gesv(G, b)))
        if autotune.decisions()["lu_step|%d,%d,%d,float32,%s"
                                % (N, N, LU_NB, dev.type)] != depth:
            fail("gesv did not take the %s depth" % depth)
        xd, gd = x.double(), g.double()
        res["gesv_%s_residual" % depth] = float(
            (gd @ xd - b.double()).norm() / (gd.norm() * xd.norm() * eps * N))
        lmax = float(torch.tril(lu.data, -1).abs().max())
        if not lmax <= 1 + 100 * eps:
            fail("gesv %s: |L| = %.7f > 1 + 100 eps" % (depth, lmax))
        d = first_pivot_difference(torch, lu_c.data, perm_c, lu.data, perm,
                                   tags=("composed", depth))
        if d is None:
            print("gesv %s: pivots equal to the composed depth's" % depth,
                  flush=True)
        else:
            print("gesv %s: pivots depart from the composed depth's at column "
                  "%d, rows %d (composed) and %d (%s); in the composed factor "
                  "|pivot| %.9g vs the other row %.9g; in the %s factor %.9g "
                  "vs %.9g" % (depth, d["column"], *d["rows"], depth,
                               *d["composed"], depth, *d[depth]), flush=True)
        walls["gesv " + depth] = pinned("lu_step=" + depth, lambda: _wall_ms(
            torch, lambda: st.gesv(G, b), 3))
        launches[path] = lc
        del lu, perm, x, xd, gd
    for path, want in EXACT.items():
        got = {k: launches[path][k] for k in want}
        if got != want:
            fail("%s launched %s, not %s" % (path, got, want))
    print("depth paths n=%d: residuals %s; launches %s; median wall ms %s"
          % (N, {k: round(v, 4) for k, v in res.items()},
             {p: {k: v for k, v in l.items() if v} for p, l in launches.items()},
             {k: round(v, 2) for k, v in walls.items()}), flush=True)
    for name, v in res.items():
        if not v <= 3:
            fail("%s %.3f > 3" % (name, v))
    res["posv_full_split"] = pinned("potrf_step=full", lambda: device_split(
        torch, "posv (full)", lambda: st.posv(A, b),
        {"potrf_full_fused kernel": "potrf_full_fused_kernel",
         "matmul kernel": "matmul_f32_kernel"}))
    res["gesv_full_split"] = pinned("lu_step=full", lambda: device_split(
        torch, "gesv (full)", lambda: st.gesv(G, b),
        {"getrf_full_fused kernel": "getrf_full_fused_kernel",
         "matmul kernel": "matmul_f32_kernel"}))
    res.update(walls=walls, launches=launches)
    return res


def check_lu_inv_kernel(torch, kernels, dev, a_qr) -> dict:
    """Phase 2e: lu_inv_panel against its plain version on diagonally
    dominant blocks at nb = 32 … 512 and on the B block of the first
    CholQR² panel of the QR path's input ``a_qr``: each output within
    1e-4 (relative Frobenius), ‖L·U − A‖/(‖A‖·ε·nb) ≤ 3, ‖L·L⁻¹ − I‖ and
    ‖U·U⁻¹ − I‖ < 1e-3.  Times kernel, plain version and a library
    composition at 512 on the B block."""
    from slate_tpu_torch.linalg import qr

    gen = torch.Generator(device=dev).manual_seed(7)
    eps = float(torch.finfo(torch.float32).eps)
    cases = []
    for nb in (32, 64, 128, 256, 512):
        g = torch.randn((nb, nb), generator=gen, device=dev)
        cases.append(("dominant", g + nb * torch.eye(nb, device=dev)))
    # the block the Householder reconstruction hands lu_inv_panel
    b = qr._householder_b(qr._cholqr2(a_qr[:, :QR_PANEL])[0])[1][:QR_PANEL]
    cases.append(("cholqr2 B", b))
    errs = []
    for label, a in cases:
        nb = a.shape[0]
        got = kernels.lu_inv_panel(a)
        ref = kernels.lu_inv_panel_plain(a)
        torch.cuda.synchronize()
        rel = max(rel_err(g, r) for g, r in zip(got, ref))
        lu, linv, uinv = (t.double() for t in got)
        eye = torch.eye(nb, dtype=torch.float64, device=dev)
        low, up = torch.tril(lu, -1) + eye, torch.triu(lu)
        ad = a.double()
        res = float((low @ up - ad).norm() / (ad.norm() * eps * nb))
        inv_l = float((low @ linv - eye).norm())
        inv_u = float((up @ uinv - eye).norm())
        print("lu_inv_panel %s nb=%d: rel %.3e of the plain version, factor "
              "residual %.3g, ||L Linv - I|| %.3g, ||U Uinv - I|| %.3g"
              % (label, nb, rel, res, inv_l, inv_u), flush=True)
        if not (rel <= 1e-4 and res <= 3 and inv_l < 1e-3 and inv_u < 1e-3):
            fail("lu_inv_panel %s nb=%d: rel %.3e (<= 1e-4), residual %.3g "
                 "(<= 3), inverses %.3g, %.3g (< 1e-3)"
                 % (label, nb, rel, res, inv_l, inv_u))
        if nb == QR_PANEL:
            errs.append(max(float((g - r).abs().max())
                            for g, r in zip(got, ref)))
    nb = QR_PANEL

    def library_lu_inv(x):
        eye = torch.eye(x.shape[0], device=dev)

        def call():
            lu, _ = torch.linalg.lu_factor(x, pivot=False)
            return (torch.linalg.solve_triangular(lu, eye, upper=False,
                                                  unitriangular=True),
                    torch.linalg.solve_triangular(lu, eye, upper=True))
        return call

    b_ms, b_by = bound(4.0 * nb ** 3 / 3, 4.0 * 4 * nb * nb)
    r = dict(shape="(%d,%d) CholQR2 B block of the first (%d,%d) panel"
                   % (nb, nb, QR_M, QR_PANEL),
             max_abs_err=max(errs),
             tol="rel Frobenius of LU, L^-1, U^-1 <= 1e-4; residual <= 3",
             ms=cuda_ms(torch, lambda: kernels.lu_inv_panel(b), 20),
             plain_ms=cuda_ms(torch, lambda: kernels.lu_inv_panel_plain(b), 2),
             library_ms=cuda_ms(torch, library_lu_inv(b), 20),
             bound_ms=b_ms, bound_by=b_by)
    print("kernel lu_inv_panel %s: max_abs_err %.3e (%s); kernel %.4f ms, "
          "plain %.4f ms, library %.4f ms (lu_factor(pivot=False) + two "
          "solve_triangular vs I, a composition), bound %.5f ms (%s)"
          % (r["shape"], r["max_abs_err"], r["tol"], r["ms"], r["plain_ms"],
             r["library_ms"], r["bound_ms"], r["bound_by"]), flush=True)
    # timed also at nb = 256 on the dominant block checked above
    a256 = cases[3][1]
    r.update(nb256_ms=cuda_ms(torch, lambda: kernels.lu_inv_panel(a256), 20),
             nb256_plain_ms=cuda_ms(
                 torch, lambda: kernels.lu_inv_panel_plain(a256), 2),
             nb256_library_ms=cuda_ms(torch, library_lu_inv(a256), 20),
             nb256_bound_ms=bound(4.0 * 256 ** 3 / 3, 4.0 * 4 * 256 * 256)[0])
    print("redesign lu_inv_panel (one cooperative grid): (512,512) B block "
          "kernel %.4f ms against the library's %.4f ms (bound %.5f ms); "
          "dominant (256,256) kernel %.4f ms, plain %.4f ms, library "
          "%.4f ms, bound %.5f ms"
          % (r["ms"], r["library_ms"], r["bound_ms"], r["nb256_ms"],
             r["nb256_plain_ms"], r["nb256_library_ms"], r["nb256_bound_ms"]),
          flush=True)
    return {"lu_inv_panel": r}


def same_departure(label: str, dev: float, ref: float) -> None:
    """``lu_u12_panel``'s departure dev = max|B − L11·L⁻¹B| / max|B| of a
    unit-lower L11 is the uncorrected solve's rounding amplified by
    cond(L11), so two summation orders give values apart by up to a
    factor of 2 (the JAX kernel and the plain version on the CPU:
    0.6040e-6 against 0.6595e-6 at nb = 128; 8.58e23 against 4.53e23 on
    an N(0, 1) triangle at nb = 256): it is held within a factor of 4 of
    its plain value and to the same side of the caller's 1e-2 guard, and
    it is zero exactly where the plain value is (B = 0 or L11 = I)."""
    if ref == 0.0:
        ok = dev == 0.0
    else:
        ok = 0.25 <= dev / ref <= 4.0 and (dev < 1e-2) == (ref < 1e-2)
    if not ok:
        fail("%s: lu_u12_panel's departure %.4g, its plain version's %.4g "
             "(within 4x, the same side of 1e-2)" % (label, dev, ref))


def check_path_calls(torch, kernels, label: str, run, tols: dict,
                     ident_tol: float = 1e-4) -> dict:
    """``run()`` once with every call of the kernels named in ``tols``
    held to its plain version on the same arguments at the moment of the
    call (the wrappers are swapped for checking ones for this run only):
    each output within ``tols[name]`` (relative Frobenius; an all-zero
    output exactly; ``lu_u12_panel``'s departure by :func:`same_departure`),
    and for ``trtri_panel`` ‖L·L⁻¹ − I‖_F < ``ident_tol`` (phase 2's gate,
    1e-4).  So the shapes and layouts a path gives the
    kernels are compared on the card, not only phase 2's.  Every kernel
    named must be called.  Returns per kernel the calls, distinct
    layouts and the largest errors."""
    real = {n: getattr(kernels, n) for n in tols}
    plain = {n: getattr(kernels, n + "_plain") for n in tols}
    out = {n: {"calls": 0, "layouts": set(), "max_rel_err": 0.0,
               "max_abs_err": 0.0, "worst": ""} for n in tols}

    def layout(args) -> str:
        return " x ".join("%s stride %s" % (tuple(t.shape), t.stride())
                          for t in args)

    def checked(name):
        def call(*args):
            got = real[name](*args)
            ref = plain[name](*args)
            gots = got if isinstance(got, tuple) else (got,)
            refs = ref if isinstance(ref, tuple) else (ref,)
            if name == "lu_u12_panel":
                # the departure is rounding amplified by cond(L11): held
                # to its plain value's magnitude and guard verdict
                same_departure(label, float(gots[1]), float(refs[1]))
                gots, refs = gots[:1], refs[:1]
            # an all-zero output is held exactly
            rel = max(rel_err(g, r) if bool(r.any()) else
                      float((g - r).abs().max()) for g, r in zip(gots, refs))
            err = max(float((g - r).abs().max()) for g, r in zip(gots, refs))
            where = layout(args)
            rec = out[name]
            rec["calls"] += 1
            rec["layouts"].add(where)
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            if rel >= rec["max_rel_err"]:
                rec["max_rel_err"], rec["worst"] = rel, where
            if not rel <= tols[name]:
                fail("%s: %s at %s is %.3e (relative) from its plain "
                     "version (<= %.0e)" % (label, name, where, rel,
                                            tols[name]))
            if name == "trtri_panel":
                low = torch.tril(args[0]).double()
                ident = float((low @ got.double() - torch.eye(
                    low.shape[0], dtype=torch.float64, device=low.device))
                    .norm())
                rec["identity"] = max(rec.get("identity", 0.0), ident)
                if not ident < ident_tol:
                    fail("%s: trtri_panel at %s: ||L Linv - I|| %.3g "
                         "(< %.0e)" % (label, where, ident, ident_tol))
            return got
        return call

    try:
        for n in tols:
            setattr(kernels, n, checked(n))
        run()
        torch.cuda.synchronize()
    finally:
        for n, fn in real.items():
            setattr(kernels, n, fn)
    for n, rec in out.items():
        if not rec["calls"]:
            fail("%s: %s was not called in the checked run" % (label, n))
        rec["layouts"] = len(rec["layouts"])
        print("%s check %s: %d calls at %d layouts, max rel %.3e "
              "(<= %.0e), max abs %.3e%s; worst at %s"
              % (label, n, rec["calls"], rec["layouts"], rec["max_rel_err"],
                 tols[n], rec["max_abs_err"],
                 ", max ||L Linv - I|| %.3g (< %.0e)" % (rec["identity"],
                                                         ident_tol)
                 if "identity" in rec else "", rec["worst"]), flush=True)
    return out


def _qr_factor_gates(torch, label, a, f, q) -> dict:
    """bench.py's Gram identity ‖Aᵀ(A·x) − Rᵀ(R·x)‖/(‖A‖²·‖x‖·ε·√m),
    tester.py's orthogonality max|QᵀQ − I|/(ε·m) and the reconstruction
    ‖A − Q·R‖/(‖A‖·ε·m), in float64, each ≤ 3."""
    eps = float(torch.finfo(torch.float32).eps)
    m, n = a.shape
    ad, qd = a.double(), q.double()
    r = torch.triu(f[:n].double())
    x = torch.randn(n, dtype=torch.float64, device=a.device,
                    generator=torch.Generator(device=a.device).manual_seed(8))
    out = {"gram": float((ad.T @ (ad @ x) - r.T @ (r @ x)).norm()
                         / (ad.norm() ** 2 * x.norm() * eps * m ** 0.5)),
           "orthogonality": float(
               (qd.T @ qd - torch.eye(n, dtype=torch.float64, device=a.device))
               .abs().max() / (eps * m)),
           "reconstruction": float((ad - qd @ r).norm()
                                   / (ad.norm() * eps * m))}
    print("%s gates: Gram identity %.3g, orthogonality %.3g, reconstruction "
          "%.3g (each <= 3)" % (label, out["gram"], out["orthogonality"],
                                out["reconstruction"]), flush=True)
    for k, v in out.items():
        if not v <= 3:
            fail("%s: %s %.3f > 3" % (label, k, v))
    return out


def qr_product_flops(m: int, n: int, w: int) -> float:
    """FLOP of geqrf_panels' products through the matmul site on an
    (m, n) input with w-wide CholQR² panels, counted from its shapes."""
    total = 0.0
    for k0 in range(0, n, w):
        mk, nt = m - k0, n - k0 - w
        # pan·L1⁻ᵀ, Q·L2⁻ᵀ, YᵀY, B[w:]·U⁻¹ and L1·L2
        total += 2.0 * w * w * (3 * mk + (mk - w) + w)
        # the trailing update: Yᵀ·C, Tᵀ·(…), Y·(…)
        total += 2.0 * w * nt * (2 * mk + w)
    return total


def _normal_eq_residual(torch, a, b, x) -> float:
    """bench.py:1491-1495's ‖Aᵀ(A·x − b)‖/(‖A‖²·‖x‖·ε·√m), float64."""
    eps = float(torch.finfo(torch.float32).eps)
    ad, bd, xd = a.double(), b.double(), x.double()
    return float((ad.T @ (ad @ xd - bd)).norm()
                 / (ad.norm() ** 2 * xd.norm() * eps * a.shape[0] ** 0.5))


def main_path_qr(torch, st, kernels, dev, a) -> dict:
    """Phase 3f: geqrf of the (32768, 4096) fp32 Gaussian ``a`` through
    the public entry (the CholQR² panels; exact launches, the guard not
    tripped, the factor gates of :func:`_qr_factor_gates` on ungqr's Q),
    its median wall beside torch.geqrf's and a profiler split; then gels
    with one right-hand side under Auto (CholQR), with method_gels=QR and
    on the transposed shape (minimum norm), each a path of its own gated
    by the normal-equations residual."""
    import numpy as np
    from slate_tpu_torch.perf import metrics

    m, n = a.shape
    A = st.Matrix.from_array(a, nb=NB)
    metrics.on()
    before = metrics.snapshot()
    (f, taus), ms_f, l_f = run_path(torch, kernels, "qr", lambda: st.geqrf(A))
    snap = metrics.snapshot()
    devmax = snap["gauges"]["qr.cholqr2.devmax"]
    reruns = metrics.snapshot_delta(before, snap)["counters"].get(
        "qr.cholqr2.reruns", 0.0)
    got = {k: l_f[k] for k in QR_EXACT}
    print("QR path (%d, %d) nb=%d: geqrf first call %.1f ms, devmax %.4g, "
          "reruns %d; launches %s" % (m, n, NB, ms_f, devmax, reruns,
                                      {k: v for k, v in l_f.items() if v}),
          flush=True)
    if got != QR_EXACT:
        fail("geqrf launched %s, not %s" % (got, QR_EXACT))
    if reruns or not devmax < 0.25:
        fail("the CholQR2 guard tripped on the main-path input (devmax %.4g)"
             % devmax)
    q, ms_q, l_q = run_path(torch, kernels, "ungqr", lambda: st.ungqr(f, taus))
    for name, t in (("factor", f.data), ("taus", taus), ("Q", q)):
        if not bool(torch.isfinite(t).all()):
            fail("geqrf %s has non-finite values" % name)
    if tuple(f.data.shape) != (m, n) or tuple(q.shape) != (m, n) \
            or tuple(taus.shape) != (n,):
        fail("geqrf/ungqr output shapes %s, %s, %s"
             % (tuple(f.data.shape), tuple(taus.shape), tuple(q.shape)))
    res = _qr_factor_gates(torch, "geqrf (%d, %d)" % (m, n), a, f.data, q)
    del q
    walls = {"geqrf": _wall_ms(torch, lambda: st.geqrf(A), 3),
             "torch.geqrf (library)": _wall_ms(torch, lambda: torch.geqrf(a), 3),
             "ungqr": ms_q}
    res["geqrf_split"] = device_split(
        torch, "geqrf", lambda: st.geqrf(A),
        {"chol_inv_panel kernel": "chol_inv_panel_kernel",
         "lu_inv_panel kernel": "lu_inv_panel_kernel",
         "trtri_panel kernel": "trtri_panel_kernel",
         "matmul kernel": "matmul_f32_kernel"})
    flops = qr_product_flops(m, n, QR_PANEL)
    if res["geqrf_split"].get("matmul kernel"):
        print("geqrf: %.4g FLOP of products through the matmul kernel, %.2f "
              "TFLOP/s in the split; bound of the whole factorization "
              "(2mn^2 - 2n^3/3 at the fp32 peak) %.3f ms"
              % (flops, flops / res["geqrf_split"]["matmul kernel"] / 1e9,
                 bound(2.0 * m * n * n - 2.0 * n ** 3 / 3, 0.0)[0]),
              flush=True)
    del f, taus

    b = torch.from_numpy(np.random.default_rng(4).standard_normal(m)
                         .astype(np.float32)).to(dev)
    at = a.T.contiguous()
    AT = st.Matrix.from_array(at, nb=NB)
    bt = b[:n].contiguous()
    if st.method.select_gels(st.MethodGels.Auto, m, n) is not st.MethodGels.CholQR:
        fail("gels Auto does not pick CholQR at (%d, %d)" % (m, n))
    launches = {"qr": l_f, "ungqr": l_q}
    for path, label, fn, aa, bb in (
            ("gels_cholqr", "gels Auto (CholQR)", lambda: st.gels(A, b), a, b),
            ("gels_qr", "gels method_gels=QR", lambda: st.gels(
                A, b, {"method_gels": st.MethodGels.QR}), a, b),
            ("gels_min_norm", "gels minimum norm (%d, %d)" % (n, m),
             lambda: st.gels(AT, bt), at, bt)):
        x, ms, lc = run_path(torch, kernels, path, fn)
        want = aa.shape[1]
        if tuple(x.shape) != (want,) or not bool(torch.isfinite(x).all()):
            fail("%s: x of shape %s, finite %s" % (label, tuple(x.shape),
                                                   bool(torch.isfinite(x).all())))
        r = _normal_eq_residual(torch, aa, bb, x)
        res[path + "_residual"] = r
        walls[path] = ms
        launches[path] = lc
        print("%s: %.1f ms (first call), normal-equations residual %.3g; "
              "launches %s" % (label, ms, r, {k: v for k, v in lc.items() if v}),
              flush=True)
        if not r <= 3:
            fail("%s: normal-equations residual %.3f > 3" % (label, r))
    walls["gels Auto (CholQR)"] = _wall_ms(torch, lambda: st.gels(A, b), 3)
    print("QR walls (ms; geqrf, torch.geqrf and gels Auto median of 3, the "
          "others one first call): %s"
          % {k: round(v, 2) for k, v in walls.items()}, flush=True)
    res.update(devmax=devmax, walls=walls, launches=launches)
    return res


def guard_path(torch, st, kernels, dev) -> dict:
    """Phase 3g: geqrf of an fp32 (8192, 1024) input U·diag(σ)·Vᵀ of
    condition 1e6, built on the host from numpy: the CholQR² departure
    passes 0.25, the Householder rerun runs once, and the factor passes
    the orthogonality and reconstruction gates."""
    import numpy as np
    from slate_tpu_torch.perf import metrics

    m, n = GUARD_M, GUARD_N
    rng = np.random.default_rng(31)
    u, _ = np.linalg.qr(rng.standard_normal((m, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = torch.from_numpy(((u * np.geomspace(1.0, 1.0 / GUARD_COND, n)) @ v.T)
                         .astype(np.float32)).to(dev)
    G = st.Matrix.from_array(a, nb=NB)
    metrics.on()
    before = metrics.snapshot()
    (f, taus), ms, lc = run_path(torch, kernels, "qr_guard", lambda: st.geqrf(G))
    snap = metrics.snapshot()
    devmax = snap["gauges"]["qr.cholqr2.devmax"]
    reruns = metrics.snapshot_delta(before, snap)["counters"].get(
        "qr.cholqr2.reruns", 0.0)
    print("guard path (%d, %d), condition %.0e: geqrf %.1f ms, devmax %.4g, "
          "reruns %d; launches %s" % (m, n, GUARD_COND, ms, devmax, reruns,
                                      {k: v for k, v in lc.items() if v}),
          flush=True)
    if not (devmax >= 0.25 and reruns == 1):
        fail("the guard did not rerun: devmax %.4g, reruns %d" % (devmax, reruns))
    q = st.ungqr(f, taus)
    res = _qr_factor_gates(torch, "guard geqrf", a, f.data, q)
    res.update(devmax=devmax, ms=ms, launches={"qr_guard": lc})
    return res


def _band_wide(n: int, kd: int, seed: int):
    """bench.py-style random wide band (tests/test_chase_wavefront.py:32),
    fp64 numpy: ``abw[c, d]`` = A[c+d, c] for d ≤ kd."""
    import numpy as np

    rng = np.random.default_rng(seed)
    abw = np.zeros((n, 2 * kd + 2))
    for d in range(kd + 1):
        abw[:n - d, d] = rng.standard_normal(n - d)
    return abw


def _dense_band(torch, abw, kd: int):
    """The dense symmetric band of wide band storage, in float64."""
    n = abw.shape[0]
    a = torch.zeros((n, n), dtype=torch.float64, device=abw.device)
    for d in range(kd + 1):
        a.diagonal(-d).copy_(abw[:n - d, d])
    return torch.tril(a) + torch.tril(a, -1).T


def chase_flops(n: int, kd: int) -> float:
    """FLOP of the chase's task bodies over all sweeps: window 0 of sweep
    j the two-sided apply on its L = min(kd, n−1−j) rows (S·v and the
    rank-2 update of the stored triangle, 4·L²); window w ≥ 1 the
    right-apply and left-apply of the (Lt, kd) bulge block (a dot and a
    rank-1 update each, 8·Lt·kd) and the two-sided apply (4·Lt²)."""
    total = 0.0
    for j in range(n - 2):
        total += 4.0 * min(kd, n - 1 - j) ** 2
        for w in range(1, (n - 3 - j) // kd + 1):
            lt = min(kd, n - (j + 1 + w * kd))
            total += 8.0 * lt * kd + 4.0 * lt * lt
    return total


def _chase_backward(torch, eig, label, a64, abw, vt, kd: int, eps: float):
    """Backward gates of one chase: Q₂ from the log (the back-transform of
    I), T from the band's (d, e); ‖A·Q₂ − Q₂·T‖_F/(‖A‖_F·n·ε) and
    ‖Q₂ᵀQ₂ − I‖_F/(n·ε), each ≤ 3.  Returns both."""
    n = abw.shape[0]
    eye = torch.eye(n, dtype=abw.dtype, device=abw.device)
    s0 = list(range(1, vt.shape[0] + 1))
    q = eig.unmtr_hb2st_hh(vt[:, :, 1:], vt[:, :, 0], s0, eye, kd).double()
    d, e = abw[:, 0].double(), abw[:n - 1, 1].double()
    t = torch.diag(d) + torch.diag(e, -1) + torch.diag(e, 1)
    res = float((a64 @ q - q @ t).norm() / (a64.norm() * n * eps))
    orth = float((q.T @ q - eye.double()).norm() / (n * eps))
    if not (res <= 3 and orth <= 3):
        fail("%s: backward residual %.3g, orthogonality %.3g (> 3)"
             % (label, res, orth))
    return res, orth


def _chase_main_checks(torch, kernels, eig, label, ab, kd: int, rel: float):
    """Phase 2g at a main path's (n, kd): the kernel and its plain version
    from the same band over CHASE_F32_SWEEPS sweeps at the start, the
    middle and the end of the chase (the band at each start is the
    kernel's own chase of the sweeps before it, one launch), band and
    log within ``rel``·max|band at the start|; then the kernel's whole
    chase in one launch, as the path calls it, to the backward gates.
    Returns the largest forward departure and the backward pair."""
    n = ab.shape[0]
    nsw, width = n - 2, CHASE_F32_SWEEPS
    state, done, worst, chunks = ab.clone(), 0, 0.0, []
    for j0 in (0, nsw // 2, nsw - width):
        if j0 > done:
            kernels.hb2st_wavefront(state, kd, done, j0)
        scale = float(state.abs().max())
        tol = rel * scale
        ak, vk = kernels.hb2st_wavefront(state.clone(), kd, j0, j0 + width)
        ap, vp = kernels.hb2st_wavefront_plain(state, kd, j0, j0 + width)
        err = max(float((ak - ap).abs().max()), float((vk - vp).abs().max()))
        chunks.append((err, scale))
        worst = max(worst, err)
        if not err <= tol:
            fail("%s: sweeps [%d, %d) disagree with the plain version: "
                 "%.3g > %.3g" % (label, j0, j0 + width, err, tol))
        state, done = ak, j0 + width
    ak, vk = kernels.hb2st_wavefront(ab.clone(), kd)
    back = _chase_backward(torch, eig, label + " whole chase",
                           _dense_band(torch, ab.double(), kd), ak, vk, kd,
                           float(torch.finfo(ab.dtype).eps))
    print("%s: sweeps [0, %d), [%d, %d) and [%d, %d) from the same band, "
          "departures from the plain version (max|band| at the start) %s "
          "(<= %.0e*max|band|); the whole chase's backward residual %.3g, "
          "orthogonality %.3g (<= 3)"
          % (label, width, nsw // 2, nsw // 2 + width, nsw - width, nsw,
             ", ".join("%.3g (%.4g)" % c for c in chunks), rel, back[0],
             back[1]), flush=True)
    return worst, back


def _chase_plan(torch, kernels, dev, name: str, n: int, kd: int, dt,
                j0: int = 0, j1=None) -> dict:
    """A chase launch's plan on the card: the kernel's own (``slate_<name>_
    plan``: clusters, blocks a cluster, route) held to ops/smem.py's
    chase_plan over the card's occupancy answers for each cluster size,
    one block's dynamic shared memory by the formula, and the ptxas line
    of the instantiation the route runs; printed and returned."""
    from slate_tpu_torch.ops import _build, smem
    from slate_tpu_torch.perf.kernel_phases import ptxas_lines

    kind = name.split("_")[0]
    meta = (kernels.hb_wave_meta if kind == "hb2st" else kernels.tb_wave_meta)(
        n, kd, j0, j1)
    clusters = kernels.chase_clusters(name, dev, kd, dt)
    want = smem.chase_plan(kind, kd, dt, meta[3], clusters)
    got = kernels.chase_plan(name, dev, n, kd, j0, n if j1 is None else j1, dt)
    if got != want:
        fail("%s at (%d, %d) %s: the kernel plans %s, ops/smem.py %s (clusters "
             "by size %s)" % (name, n, kd, dt, got, want, clusters))
    g, c, route = got
    nbytes = smem.chase_block_bytes(kind, kd, dt, c, route)
    key = "I%sLb%dELb1E" % ("f" if dt == torch.float32 else "d", route == "smem")
    log = _build.lib_path(name)
    ptxas = ptxas_lines(log.with_name(log.name + ".log"), key)
    print("%s plan at (n, kd) = (%d, %d) %s: %d live tasks a stagger on %d "
          "clusters x %d blocks of %d threads (cooperative), route %s (the "
          "task's window %s), %d B dynamic shared memory a block by the "
          "formula (ops/smem.py agrees with the kernel's plan); clusters the "
          "card holds by size %s; ptxas %s"
          % (name, n, kd, str(dt).split(".")[-1], meta[3], g, c,
             smem.CHASE_THREADS, route, "in the cluster's shared memory"
             if route == "smem" else "left in the band", nbytes, clusters,
             " | ".join(ptxas)), flush=True)
    return dict(clusters=g, cluster=c, route=route, smem_bytes=nbytes,
                ptxas=ptxas, live=meta[3])


def _second_route_kd(name: str, dt) -> int:
    """The narrowest band that takes a chase's band (L2) route."""
    from slate_tpu_torch.ops import smem

    kind = name.split("_")[0]
    return next(kd for kd in range(4, 8192) if smem.chase_route(kind, kd, dt) == "l2")


def _redesign_line(name: str, dt, ms: float, plan: dict) -> None:
    """Print the ``redesign`` line of a chase at its main shape: its time
    beside its time before the redesign (CHASE_BEFORE_MS, which stays out of
    the kernels line: it was not measured in this run)."""
    key = str(dt).split(".")[-1]
    before = CHASE_BEFORE_MS[name][key]
    print("redesign %s %s: %.3f ms on %d clusters x %d blocks (route %s), "
          "%.3f ms before the redesign (one block of 1024 threads a task), "
          "%.2fx" % (name, key, ms, plan["clusters"], plan["cluster"],
                     plan["route"], before, before / ms), flush=True)


def check_chase_kernel(torch, kernels, dev) -> dict:
    """Phase 2g: hb2st_wavefront against its plain version on the card at
    (n, kd) = (1024, 64) and (1024, 256) in fp32 and fp64, on
    bench.py-style random wide bands, and in the range chunks of
    CHASE_CHUNKS at (1024, 64) in fp64.

    fp64: band and log within 1e-9·max|band| of the plain version, and a
    probe Z back-transformed through both logs within the same.  fp32:
    the chase's forward error is not stable (two fp32 orderings of the
    same chase part by O(1) band entries past the first few hundred
    sweeps at n = 1024, their eigenvalues still close; at kd = 256 the
    plain version in fp32 parts from itself in fp64 as far, which is
    printed), so the
    forward gate, 5e-3·max|band| (tests/test_chase_wavefront.py:199),
    holds the first CHASE_F32_SWEEPS sweeps from the same band, and the
    whole chase of kernel and plain version each passes the backward
    gates of :func:`_chase_backward`, as the fp64 chases do too.  The
    eigenvalues of the kernel's (d, e) (scipy on the host) are held to
    torch.linalg.eigvalsh of the dense band, 1e-3 (fp32) and 1e-10
    (fp64) relative to max|λ|.

    At the main paths' calls, (8192, 256) fp32 and (4096, 256) fp64, on
    the plan those calls run (:func:`_chase_plan`: clusters x blocks, the
    route, held to ops/smem.py's plan): :func:`_chase_main_checks`.  Then
    times the kernel with CUDA events there, with the same launch with
    every task skipped (the barriers' share: the schedule's floor), prints
    the ``redesign`` line (its time before the cluster redesign,
    CHASE_BEFORE_MS), gates the band route (:func:`_hb2st_second_route`),
    and times the plain version at (1024, 256) only: ~135k tasks of ~25
    PyTorch ops each at n = 8192."""
    import numpy as np
    from scipy.linalg import eigvalsh_tridiagonal
    from slate_tpu_torch.linalg import eig

    f32, f64 = torch.float32, torch.float64
    worst = {f32: 0.0, f64: 0.0}
    for n, kd in CHASE_CHECKS:
        ab64 = torch.from_numpy(_band_wide(n, kd, 7)).to(dev)
        a64 = _dense_band(torch, ab64, kd)
        lam = torch.linalg.eigvalsh(a64).cpu().numpy()
        whole = {}
        for dt in (f32, f64):
            ab = ab64.to(dt)
            eps = float(torch.finfo(dt).eps)
            scale = float(ab.abs().max())
            ak, vk = kernels.hb2st_wavefront(ab.clone(), kd)
            ap, vp = kernels.hb2st_wavefront_plain(ab.clone(), kd)
            torch.cuda.synchronize()
            whole[dt] = (ak.double(), ap.double())
            full_dev = float((ak - ap).abs().max())
            label = "hb2st_wavefront (%d, %d) %s" % (n, kd, dt)
            if dt == f64:
                z = torch.from_numpy(np.random.default_rng(8).standard_normal(
                    (n, 4))).to(dev)
                s0 = list(range(1, vk.shape[0] + 1))
                zk = eig.unmtr_hb2st_hh(vk[:, :, 1:], vk[:, :, 0], s0, z, kd)
                zp = eig.unmtr_hb2st_hh(vp[:, :, 1:], vp[:, :, 0], s0, z, kd)
                errs = (full_dev, float((vk - vp).abs().max()),
                        float((zk - zp).abs().max()))
                tol = 1e-9 * scale
            else:
                hk, hvk = kernels.hb2st_wavefront(ab.clone(), kd, 0,
                                                  CHASE_F32_SWEEPS)
                hp, hvp = kernels.hb2st_wavefront_plain(ab.clone(), kd, 0,
                                                        CHASE_F32_SWEEPS)
                errs = (float((hk - hp).abs().max()),
                        float((hvk - hvp).abs().max()))
                tol = 5e-3 * scale
            worst[dt] = max(worst[dt], max(errs))
            if not max(errs) <= tol:
                fail("%s disagrees with its plain version: %s > %.3g"
                     % (label, ["%.3g" % x for x in errs], tol))
            bk = _chase_backward(torch, eig, label, a64, ak, vk, kd, eps)
            bp = _chase_backward(torch, eig, label + " (plain)", a64, ap, vp,
                                 kd, eps)
            w = eigvalsh_tridiagonal(ak[:, 0].double().cpu().numpy(),
                                     ak[:n - 1, 1].double().cpu().numpy())
            lam_err = float(np.abs(w - lam).max() / np.abs(lam).max())
            if not lam_err <= (1e-3 if dt == f32 else 1e-10):
                fail("%s: eigenvalues of (d, e) off by %.3g relative"
                     % (label, lam_err))
            print("%s: forward %s (tol %.3g%s), whole-chase band departure "
                  "%.3g; backward residual/orthogonality kernel %.3g/%.3g, "
                  "plain %.3g/%.3g; eigenvalues %.3g relative"
                  % (label, ["%.3g" % x for x in errs], tol,
                     "" if dt == f64 else ", first %d sweeps" % CHASE_F32_SWEEPS,
                     full_dev, bk[0], bk[1], bp[0], bp[1], lam_err), flush=True)
        # the fp32 departure without the kernel: plain fp32 against plain fp64
        (k32, p32), (k64, p64) = whole[f32], whole[f64]
        print("hb2st_wavefront (%d, %d) whole-chase band departures, "
              "max|band| %.3g: plain fp32 from plain fp64 %.3g, kernel fp32 "
              "from kernel fp64 %.3g, kernel fp32 from plain fp32 %.3g, "
              "kernel fp64 from plain fp64 %.3g"
              % (n, kd, float(ab64.abs().max()), float((p32 - p64).abs().max()),
                 float((k32 - k64).abs().max()), float((k32 - p32).abs().max()),
                 float((k64 - p64).abs().max())), flush=True)
        del whole, k32, p32, k64, p64
    # the sweep-range chunks: the band is the whole state between chunks
    n, kd = CHASE_CHECKS[0]
    ak = torch.from_numpy(_band_wide(n, kd, 9)).to(dev)
    ap = ak.clone()
    scale = float(ak.abs().max())
    for j0, j1 in CHASE_CHUNKS:
        ak, vk = kernels.hb2st_wavefront(ak, kd, j0, j1)
        ap, vp = kernels.hb2st_wavefront_plain(ap, kd, j0, j1)
        err = max(float((ak - ap).abs().max()), float((vk - vp).abs().max()))
        worst[f64] = max(worst[f64], err)
        if tuple(vk.shape[:1]) != (j1 - j0,) or not err <= 1e-9 * scale:
            fail("hb2st_wavefront chunk [%d, %d) disagrees: %.3g, log %s"
                 % (j0, j1, err, tuple(vk.shape)))
    print("hb2st_wavefront range chunks %s at (%d, %d) fp64: within %.3g"
          % (list(CHASE_CHUNKS), n, kd, worst[f64]), flush=True)

    # the main paths' calls: checks on their grid, then the timing, then
    # the barriers
    timed = {}
    for n, kd, dt, peak, rel in ((EIG_N, NB, f32, PEAK_FP32_FLOPS, 5e-3),
                                 (EIG_N64, NB, f64, PEAK_FP64_FLOPS, 1e-9)):
        ab = torch.from_numpy(_band_wide(n, kd, 7)).to(dev, dt)
        nsw, nwin_max, tmax, nl = kernels.hb_wave_meta(n, kd)
        plan = _chase_plan(torch, kernels, dev, "hb2st_wavefront", n, kd, dt)
        label = "hb2st_wavefront (%d, %d) %s, %d clusters x %d blocks" % (
            n, kd, str(dt).split(".")[-1], plan["clusters"], plan["cluster"])
        err, back = _chase_main_checks(torch, kernels, eig, label, ab, kd, rel)
        worst[dt] = max(worst[dt], err)
        work = ab.clone()
        ms = event_ms(torch, lambda: kernels.hb2st_wavefront(work, kd),
                      setup=lambda: work.copy_(ab), reps=2)
        sync_ms = event_ms(torch, lambda: kernels.hb2st_wavefront_barriers(
            work, kd), reps=2)
        size = ab.element_size()
        flops = chase_flops(n, kd)
        nbytes = 2.0 * ab.numel() * size + nsw * nwin_max * (kd + 1) * size
        t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
        timed[dt] = dict(
            ms=ms, barriers_ms=sync_ms, staggers=tmax + 1, grid_max=nl,
            flops=flops, bytes=nbytes, bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            max_abs_err=err, backward=back,
            shape="(%d, %d) %s band, one launch" % (n, 2 * kd + 2,
                                                   str(dt).split(".")[-1]))
        print("hb2st_wavefront %s: %.3f ms (CUDA events, mean of 2), the "
              "same grid with every task skipped %.3f ms over %d staggers "
              "(%.3f us a barrier: the schedule's floor); %.4g FLOP, %.4g "
              "bytes, bound %.4f ms (%s)"
              % (timed[dt]["shape"], ms, sync_ms, tmax + 1,
                 1e3 * sync_ms / (tmax + 1), flops, nbytes,
                 timed[dt]["bound_ms"], timed[dt]["bound_by"]), flush=True)
        timed[dt].update(plan=plan)
        _redesign_line("hb2st_wavefront", dt, ms, plan)
        del ab, work
    second = _hb2st_second_route(torch, kernels, eig, dev)
    n, kd = CHASE_CHECKS[1]
    ab = torch.from_numpy(_band_wide(n, kd, 7)).to(dev, f32)
    plain_ms, _ = once_ms(torch, lambda: kernels.hb2st_wavefront_plain(
        ab.clone(), kd))
    small_ms = event_ms(torch, lambda: kernels.hb2st_wavefront(ab.clone(), kd),
                        reps=2)
    print("hb2st_wavefront (%d, %d) fp32: kernel %.3f ms, plain version %.1f "
          "ms (one call; the plain version is timed only here: ~135k tasks "
          "of ~25 PyTorch ops each at n = %d); library: none, no library "
          "call reduces a band to tridiagonal" % (n, kd, small_ms, plain_ms,
                                                   EIG_N), flush=True)
    r = timed[f32]
    return {"hb2st_wavefront": dict(
        shape=r["shape"], max_abs_err=worst[f32], rel_err=None,
        tol="fp32 5e-3*max|band| over %d sweeps from the same band, fp64 "
            "1e-9*max|band|; whole chases backward <= 3" % CHASE_F32_SWEEPS,
        ms=r["ms"], plain_ms=plain_ms, library_ms=None,
        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
        plain_shape="(%d, %d) fp32" % (n, 2 * kd + 2), kernel_ms_at_plain_shape=small_ms,
        barriers_ms=r["barriers_ms"], fp64=dict(
            (k, timed[f64][k]) for k in ("shape", "ms", "barriers_ms",
                                         "bound_ms", "bound_by", "plan")),
        max_abs_err_fp64=worst[f64], grid="%d clusters x %d blocks" % (
            r["plan"]["clusters"], r["plan"]["cluster"]),
        cluster=r["plan"]["cluster"], chase_route=r["plan"]["route"],
        smem_bytes=r["plan"]["smem_bytes"], second_route=second)}


def _hb2st_second_route(torch, kernels, eig, dev) -> dict:
    """Phase 2g's gate of the band (L2) route: in fp32 and fp64 at the
    narrowest kd that takes it, n = 2·kd + 16 (sweeps of two windows and
    of one), on a bench.py-style band: the plan (route l2), fp64 band and
    log within 1e-9·max|band| of the plain version, fp32 within
    5e-3·max|band| over the first CHASE_F32_SWEEPS sweeps, the kernel's
    and the plain version's whole chases to the backward gates, the
    eigenvalues of the kernel's (d, e) within 1e-3 (fp32) / 1e-10 (fp64)
    of eigvalsh, relative to max|λ|."""
    import numpy as np
    from scipy.linalg import eigvalsh_tridiagonal

    out = {}
    for dt in (torch.float32, torch.float64):
        kd = _second_route_kd("hb2st_wavefront", dt)
        n = 2 * kd + 16
        plan = _chase_plan(torch, kernels, dev, "hb2st_wavefront", n, kd, dt)
        if plan["route"] != "l2":
            fail("hb2st_wavefront at (%d, %d) %s plans route %s, not l2"
                 % (n, kd, dt, plan["route"]))
        ab64 = torch.from_numpy(_band_wide(n, kd, 7)).to(dev)
        a64 = _dense_band(torch, ab64, kd)
        lam = torch.linalg.eigvalsh(a64).cpu().numpy()
        ab = ab64.to(dt)
        eps = float(torch.finfo(dt).eps)
        scale = float(ab.abs().max())
        label = "hb2st_wavefront (%d, %d) %s, route l2" % (n, kd, str(dt).split(".")[-1])
        ak, vk = kernels.hb2st_wavefront(ab.clone(), kd)
        ap, vp = kernels.hb2st_wavefront_plain(ab.clone(), kd)
        if dt == torch.float64:
            err, tol = max(float((ak - ap).abs().max()), float((vk - vp).abs().max())), 1e-9 * scale
        else:
            hk, hvk = kernels.hb2st_wavefront(ab.clone(), kd, 0, CHASE_F32_SWEEPS)
            hp, hvp = kernels.hb2st_wavefront_plain(ab.clone(), kd, 0, CHASE_F32_SWEEPS)
            err = max(float((hk - hp).abs().max()), float((hvk - hvp).abs().max()))
            tol = 5e-3 * scale
        if not err <= tol:
            fail("%s disagrees with its plain version: %.3g > %.3g" % (label, err, tol))
        bk = _chase_backward(torch, eig, label, a64, ak, vk, kd, eps)
        bp = _chase_backward(torch, eig, label + " (plain)", a64, ap, vp, kd, eps)
        w = eigvalsh_tridiagonal(ak[:, 0].double().cpu().numpy(),
                                 ak[:n - 1, 1].double().cpu().numpy())
        lam_err = float(np.abs(w - lam).max() / np.abs(lam).max())
        if not lam_err <= (1e-3 if dt == torch.float32 else 1e-10):
            fail("%s: eigenvalues of (d, e) off by %.3g relative" % (label, lam_err))
        print("%s: forward %.3g (tol %.3g%s); backward residual/orthogonality "
              "kernel %.3g/%.3g, plain %.3g/%.3g; eigenvalues %.3g relative"
              % (label, err, tol, "" if dt == torch.float64 else ", first %d sweeps"
                 % CHASE_F32_SWEEPS, bk[0], bk[1], bp[0], bp[1], lam_err), flush=True)
        out[str(dt).split(".")[-1]] = dict(n=n, kd=kd, max_abs_err=err, tol=tol,
                                           backward=bk, eig_rel_err=lam_err,
                                           clusters=plan["clusters"],
                                           cluster=plan["cluster"])
    return out


def _eig_gates(torch, label, a, w, z, lam, eps10):
    """bench.py's heev gates (bench.py:1509-1531): ‖A·Z − Z·W‖_F/(‖A‖_F·n·
    10ε) and ‖ZᵀZ − I‖_F/(n·10ε), each ≤ 3, and the eigenvalues within
    1e-3 relative (to max|λ|) of the reference ``lam``."""
    n = a.shape[0]
    for name, t in (("w", w), ("Z", z)):
        if not bool(torch.isfinite(t).all()):
            fail("%s: %s has non-finite values" % (label, name))
    if tuple(w.shape) != (n,) or tuple(z.shape) != (n, n):
        fail("%s: shapes %s, %s" % (label, tuple(w.shape), tuple(z.shape)))
    ad, wd, zd = a.double(), w.double(), z.double()
    resid = float((ad @ zd - zd * wd[None, :]).norm() / (ad.norm() * n * eps10))
    orth = float((zd.T @ zd - torch.eye(n, dtype=torch.float64,
                                        device=a.device)).norm() / (n * eps10))
    lam_err = float((torch.sort(wd).values - lam).abs().max() / lam.abs().max())
    print("%s: residual %.3g, orthogonality %.3g (n*10eps units), "
          "eigenvalues %.3g relative" % (label, resid, orth, lam_err),
          flush=True)
    if not (resid <= 3 and orth <= 3 and lam_err <= 1e-3):
        fail("%s: residual %.3g, orthogonality %.3g, eigenvalues %.3g"
             % (label, resid, orth, lam_err))
    return dict(residual=resid, orthogonality=orth, eig_rel_err=lam_err)


def main_path_heev(torch, st, kernels, dev) -> dict:
    """Phase 3h: heev of bench.py's heev_fp32 input (bench.py:1509-1531:
    rng 9, (G + Gᵀ)/2, n = 8192) as an fp32 HermitianMatrix, nb = 256,
    jobz: exactly one hb2st_wavefront launch, chase.host_bytes 0 and
    chase.dispatch.kernel ≥ 1, bench.py's residual and orthogonality
    gates, eigenvalues against torch.linalg.eigvalsh; one warm call, the
    median wall of HEEV_REPS with the stage timers, a profiler split, and
    torch.linalg.eigh's wall as a yardstick (timed only); one more heev
    with every matmul call held to its plain version
    (:func:`check_path_calls`).  Then heev in
    fp64 at n = 4096 (heev_fp64's generator, rng 7), one timed call; the
    host routes once each: heev_vals at n = 2048 through the native
    Givens chase, hegv itype 1 at n = 2048 (B = GᵀG + n·I) against
    scipy.linalg.eigh(a, b), and one more hegv with its matmul and
    chol_inv_panel calls held to their plain versions."""
    import numpy as np
    import scipy.linalg
    from slate_tpu_torch import native
    from slate_tpu_torch.perf import metrics

    metrics.on()
    rng = np.random.default_rng(9)
    g = rng.standard_normal((EIG_N, EIG_N)).astype(np.float32)
    a = torch.from_numpy(((g + g.T) / 2).astype(np.float32)).to(dev)
    del g
    A = st.HermitianMatrix(a, uplo=st.Uplo.Lower, nb=NB)
    eps32 = float(torch.finfo(torch.float32).eps)
    launches = {}
    before = metrics.snapshot()
    (w, z), ms0, launches["heev"] = run_path(torch, kernels, "heev",
                                             lambda: st.heev(A))
    after = metrics.snapshot()
    delta = metrics.snapshot_delta(before, after)["counters"]
    host = after["counters"].get("chase.host_bytes")
    print("heev fp32 n=%d nb=%d: first call %.1f ms; launches %s; chase "
          "counters host_bytes %s, dispatch %s"
          % (EIG_N, NB, ms0, {k: v for k, v in launches["heev"].items() if v},
             host, {k: v for k, v in delta.items() if "dispatch" in k}),
          flush=True)
    if launches["heev"]["hb2st_wavefront"] != 1:
        fail("heev launched hb2st_wavefront %d times, not once"
             % launches["heev"]["hb2st_wavefront"])
    if host is None or host - before["counters"].get("chase.host_bytes", 0.0) \
            or delta.get("chase.dispatch.kernel", 0) < 1:
        fail("heev: chase.host_bytes %s, chase.dispatch.kernel %s"
             % (host, delta.get("chase.dispatch.kernel")))
    lam = torch.linalg.eigvalsh(a.double())
    res = {"fp32": _eig_gates(torch, "heev fp32 n=%d" % EIG_N, a, w, z, lam,
                              10 * eps32)}
    del w, z
    before = metrics.snapshot()
    wall = _wall_ms(torch, lambda: st.heev(A), HEEV_REPS)
    timers = metrics.snapshot_delta(before, metrics.snapshot())["timers"]
    stages = {k: v["total_s"] * 1e3 / v["count"] for k, v in timers.items()
              if k.startswith(("stage.heev", "chase.hb2st"))}
    res["fp32"].update(wall_ms=wall, stages_ms=stages)
    torch.linalg.eigh(a)
    eigh_ms = _wall_ms(torch, lambda: torch.linalg.eigh(a), 1)
    print("heev fp32 n=%d: median wall of %d %.1f ms (host timers, mean ms a "
          "call: %s); torch.linalg.eigh (library yardstick) %.1f ms"
          % (EIG_N, HEEV_REPS, wall, {k: round(v, 2) for k, v in
                                     stages.items()}, eigh_ms), flush=True)
    res["fp32"]["eigh_ms"] = eigh_ms
    res["fp32"]["split"] = device_split(
        torch, "heev fp32", lambda: st.heev(A),
        {"hb2st_wavefront kernel": "hb2st_wavefront_kernel",
         "matmul kernel": "matmul_f32_kernel"})
    checks = {"heev": check_path_calls(
        torch, kernels, "heev path", lambda: st.heev(A),
        {"matmul": CHECK_TOL["matmul"]})}
    del A, a, lam

    rng = np.random.default_rng(7)
    g = rng.standard_normal((EIG_N64, EIG_N64))
    a = torch.from_numpy((g + g.T) / 2).to(dev)
    A = st.HermitianMatrix(a, uplo=st.Uplo.Lower, nb=NB)
    (w, z), ms, launches["heev_fp64"] = run_path(torch, kernels, "heev_fp64",
                                                 lambda: st.heev(A))
    if launches["heev_fp64"]["hb2st_wavefront"] != 1:
        fail("heev fp64 launched hb2st_wavefront %d times"
             % launches["heev_fp64"]["hb2st_wavefront"])
    res["fp64"] = _eig_gates(torch, "heev fp64 n=%d" % EIG_N64, a, w, z,
                             torch.linalg.eigvalsh(a),
                             10 * float(torch.finfo(torch.float64).eps))
    res["fp64"]["wall_ms"] = ms
    print("heev fp64 n=%d: one call %.1f ms; launches %s"
          % (EIG_N64, ms, {k: v for k, v in launches["heev_fp64"].items() if v}),
          flush=True)
    del A, a, w, z

    if not native.available():
        fail("the native chase did not build: %s" % native.build_error())
    n = EIG_HOST_N
    rng = np.random.default_rng(11)
    g = rng.standard_normal((n, n))
    a = torch.from_numpy(((g + g.T) / 2).astype(np.float32)).to(dev)
    before = metrics.snapshot()
    w, ms, launches["heev_vals"] = run_path(
        torch, kernels, "heev_vals",
        lambda: st.heev_vals(st.HermitianMatrix(a, uplo=st.Uplo.Lower, nb=NB)))
    chased = metrics.snapshot_delta(before, metrics.snapshot())["timers"].get(
        "chase.hb2st", {}).get("count", 0)
    lam = torch.linalg.eigvalsh(a.double())
    lam_err = float((w.double() - lam).abs().max() / lam.abs().max())
    print("heev_vals fp32 n=%d: %.1f ms, host chase calls %d, launches %s, "
          "eigenvalues %.3g relative" % (n, ms, chased, {
              k: v for k, v in launches["heev_vals"].items() if v}, lam_err),
          flush=True)
    if launches["heev_vals"]["hb2st_wavefront"] or chased != 1 \
            or not lam_err <= 1e-3:
        fail("heev_vals: %d kernel chases, %d host chases, eigenvalues %.3g"
             % (launches["heev_vals"]["hb2st_wavefront"], chased, lam_err))
    b = torch.from_numpy((g.T @ g + n * np.eye(n)).astype(np.float32)).to(dev)
    (w, z), ms, launches["hegv"] = run_path(
        torch, kernels, "hegv", lambda: st.hegv(a, b, 1, True, {"block_size": NB}))
    ref = scipy.linalg.eigh(a.double().cpu().numpy(), b.double().cpu().numpy(),
                            eigvals_only=True)
    w_err = float(np.abs(np.sort(w.double().cpu().numpy()) - ref).max()
                  / np.abs(ref).max())
    gen_res = float((a.double() @ z.double() - b.double() @ z.double()
                     * w.double()[None, :]).norm()
                    / (a.double().norm() * z.double().norm() * n * eps32))
    print("hegv fp32 itype 1 n=%d: %.1f ms, eigenvalues %.3g relative of "
          "scipy.linalg.eigh(a, b), ||A Z - B Z W||/(||A|| ||Z|| n eps) %.3g; "
          "launches %s" % (n, ms, w_err, gen_res, {
              k: v for k, v in launches["hegv"].items() if v}), flush=True)
    if not (w_err <= 1e-3 and bool(torch.isfinite(z).all())
            and tuple(z.shape) == (n, n)):
        fail("hegv: eigenvalues %.3g relative, Z finite %s"
             % (w_err, bool(torch.isfinite(z).all())))
    checks["hegv"] = check_path_calls(
        torch, kernels, "hegv path",
        lambda: st.hegv(a, b, 1, True, {"block_size": NB}),
        {k: CHECK_TOL[k] for k in ("matmul", "chol_inv_panel")})
    res.update(heev_vals_rel_err=lam_err, hegv_rel_err=w_err,
               launches=launches, path_checks=checks)
    return res


def _tb_dense(torch, st, kd: int):
    """The dense upper band of general band storage, in float64."""
    n = st.shape[0]
    b = torch.zeros((n, n), dtype=torch.float64, device=st.device)
    for d in range(kd + 1):
        b.diagonal(d).copy_(st[:n - d, kd + d])
    return b


def _ge2tb_band(torch, port, chase, n: int, kd: int, seed: int, dev, dt):
    """General band storage (fp64) of the band ge2tb makes, at nb = kd,
    of a Gaussian (n, n) from ``seed`` in ``dt``: the band the svd path
    hands the chase."""
    import numpy as np

    g = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, n))).to(dev, dt)
    band = port.ge2tb(g, {"block_size": kd}, device=dev).band[:n]
    return chase.tb2bd_st_from_dense(band, kd).double()


def tb2bd_flops(n: int, kd: int) -> float:
    """FLOP of the chase's task bodies over all sweeps, counted from the
    kernel: block 0 of sweep s the right apply on its lv = min(kd, n−1−s)
    rows (a dot and a rank-1 update over lv², 4·lv²) and the left apply on
    lv − 1 columns (4·lv·(lv−1)); block b ≥ 1 the left apply on the
    (kd, lj) off-diagonal block, the right apply on its other kd − 1 rows,
    the right apply on the (lj, lj) diagonal block and the left apply on
    its other lj − 1 columns, lj = min(kd, n − (s+1+b·kd))."""
    total = 0.0
    for s in range(n - 2):
        lv = min(kd, n - 1 - s)
        total += 4.0 * lv * lv + 4.0 * lv * (lv - 1)
        for b in range(1, (n - 2 - s) // kd + 1):
            lj = min(kd, n - (s + 1 + b * kd))
            total += 4.0 * kd * lj + 4.0 * lj * (kd - 1) + 4.0 * lj * lj \
                + 4.0 * lj * (lj - 1)
    return total


def _tb2bd_backward(torch, eig, label, b64, st, ut, vt, kd: int, eps: float,
                    sv=None):
    """Backward gates of one bidiagonal chase: U₂ and V₂ from the logs (the
    back-transforms of I), B₂ = bidiag(d, e) from the band;
    ‖B·V₂ − U₂·B₂‖_F/(‖B‖_F·n·ε), ‖U₂ᵀU₂ − I‖_F/(n·ε) and
    ‖V₂ᵀV₂ − I‖_F/(n·ε), each ≤ 3; with ``sv`` (torch.linalg.svdvals of
    B in fp64) B₂'s singular values within 1e-3 (fp32) / 1e-10 (fp64)
    of them, relative to σ_max.  Returns the gates."""
    n = st.shape[0]
    eye = torch.eye(n, dtype=st.dtype, device=st.device)
    s0 = list(range(1, ut.shape[0] + 1))
    u2, v2 = (eig.unmtr_hb2st_hh(lg[:, :, 1:], lg[:, :, 0], s0, eye,
                                 kd).double() for lg in (ut, vt))
    b2 = torch.diag(st[:, kd].double()) + torch.diag(st[:n - 1, kd + 1].double(), 1)
    eye = eye.double()
    out = dict(residual=float((b64 @ v2 - u2 @ b2).norm() / (b64.norm() * n * eps)),
               orth_u=float((u2.T @ u2 - eye).norm() / (n * eps)),
               orth_v=float((v2.T @ v2 - eye).norm() / (n * eps)))
    del u2, v2
    bad = max(out.values()) > 3
    if sv is not None:
        out["sv_rel_err"] = float((torch.linalg.svdvals(b2) - sv).abs().max()
                                  / sv.max())
        bad = bad or out["sv_rel_err"] > (1e-3 if st.dtype == torch.float32
                                          else 1e-10)
    if bad:
        fail("%s: backward gates %s" % (label, out))
    return out


def _tb2bd_departure(a, b):
    """Largest departure of band and both logs between two chases."""
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def _tb2bd_main_checks(torch, kernels, eig, label, st, b64, kd: int,
                       rel: float):
    """Phase 2h at a main path's (n, kd): the kernel (on the card) and its
    plain version (on a host copy) from the same band over
    CHASE_F32_SWEEPS sweeps at the start, the middle and the end of the
    chase (the band at each start is the kernel's own chase of the sweeps
    before it, one launch), band and logs within ``rel``·max|band at the
    start|, printed beside it; then the kernel's whole chase in one
    launch, as the path calls it, to the backward gates.  Returns the
    largest departure, the backward gates and the per-chunk pairs."""
    n = st.shape[0]
    nsw, width = n - 2, CHASE_F32_SWEEPS
    state, done, worst, chunks = st.clone(), 0, 0.0, []
    for s0 in (0, nsw // 2, nsw - width):
        if s0 > done:
            kernels.tb2bd_wavefront(state, kd, done, s0)
        scale = float(state.abs().max())
        got = kernels.tb2bd_wavefront(state.clone(), kd, s0, s0 + width)
        ref = kernels.tb2bd_wavefront_plain(state.to("cpu", copy=True), kd, s0,
                                                   s0 + width)
        err = _tb2bd_departure(got, [x.to(st.device) for x in ref])
        chunks.append((err, scale))
        worst = max(worst, err)
        if not err <= rel * scale:
            fail("%s: sweeps [%d, %d) disagree with the plain version: %.3g "
                 "> %.0e*max|band| = %.3g" % (label, s0, s0 + width, err, rel,
                                              rel * scale))
        state, done = got[0], s0 + width
    got = kernels.tb2bd_wavefront(st.clone(), kd)
    back = _tb2bd_backward(torch, eig, label + " whole chase", b64, *got, kd,
                           float(torch.finfo(st.dtype).eps))
    print("%s: sweeps [0, %d), [%d, %d) and [%d, %d) from the same band, "
          "departures from the plain version (max|band| at the start) %s "
          "(<= %.0e*max|band|); the whole chase's backward %s (<= 3)"
          % (label, width, nsw // 2, nsw // 2 + width, nsw - width, nsw,
             ", ".join("%.3g (%.4g)" % c for c in chunks), rel,
             {k: float("%.4g" % v) for k, v in back.items()}), flush=True)
    return worst, back, chunks


def check_tb2bd_kernel(torch, kernels, dev) -> dict:
    """Phase 2h: tb2bd_wavefront against its plain version.

    The bands are ge2tb's bands of Gaussians at nb = kd — the input the
    svd path hands the chase, random upper bands whose singular values
    are a Gaussian's.  The plain version runs on a host copy of the same
    band (the wrapper's own CPU route: ~45 PyTorch ops a task, ~16k tasks
    at (1024, 64)).

    At (n, kd) = (1024, 64) and (1024, 256) in fp32 and fp64, and in the
    range chunks of CHASE_CHUNKS at (1024, 64) in fp64: fp64 band and both
    logs within 1e-9·max|band| of the plain version; fp32 within
    5e-3·max|band| over the first CHASE_F32_SWEEPS sweeps (the chase's
    forward error is not stable along the sweeps, as phase 2g's); every
    whole chase, kernel and plain, to the backward gates of
    :func:`_tb2bd_backward` with σ against torch.linalg.svdvals of the
    band.  The fp32-vs-fp64 witness at (1024, 256): the plain version in
    fp32 against itself in fp64, and the kernel likewise.  One more
    witness: a Gaussian triangular band (the JAX test's generator) at
    (1024, 256) fp64 is numerically singular (σ_min printed); kernel and
    plain version are printed, not gated, on it, band and logs apart.

    At the main paths' calls, (8192, 256) fp32 and (4096, 256) fp64, on
    their plans (:func:`_chase_plan`): :func:`_tb2bd_main_checks`.  Then
    times the kernel with CUDA events there, beside the same launch with
    every task skipped (the barriers' share: the schedule's floor),
    prints the ``redesign`` line, gates the band route
    (:func:`_tb2bd_second_route`), and times the plain version on the
    card at (1024, 256) fp32."""
    import numpy as np
    import slate_tpu_torch as port
    from slate_tpu_torch.linalg import _chase, eig

    f32, f64 = torch.float32, torch.float64
    worst = {f32: 0.0, f64: 0.0}
    for n, kd in CHASE_CHECKS:
        st64 = _ge2tb_band(torch, port, _chase, n, kd, 7, dev, f64)
        b64 = _tb_dense(torch, st64, kd)
        sv = torch.linalg.svdvals(b64)
        scale = float(st64.abs().max())
        whole = {}
        for dt in (f32, f64):
            st = st64.to(dt)
            eps = float(torch.finfo(dt).eps)
            label = "tb2bd_wavefront (%d, %d) %s" % (n, kd, dt)
            got = kernels.tb2bd_wavefront(st.clone(), kd)
            if dt == f64 and kd == CHASE_CHECKS[0][1]:
                # the plain whole chase as the range chunks: the band is
                # the whole state between chunks
                ref, state, logs = None, st.to("cpu", copy=True), []
                for s0, s1 in CHASE_CHUNKS:
                    state, ut, vt = kernels.tb2bd_wavefront_plain(state, kd,
                                                                  s0, s1)
                    logs.append((ut, vt))
                w = max(lg[0].shape[1] for lg in logs)
                pad = torch.nn.functional.pad
                ref = (state,) + tuple(torch.cat([pad(lg[k], (0, 0, 0, w - lg[k].shape[1]))
                                                  for lg in logs]) for k in (0, 1))
                kst = st.clone()
                cerr = 0.0
                for (s0, s1), (ut_p, vt_p) in zip(CHASE_CHUNKS, logs):
                    kst, ut, vt = kernels.tb2bd_wavefront(kst, kd, s0, s1)
                    cerr = max(cerr, float((ut.cpu() - ut_p).abs().max()),
                               float((vt.cpu() - vt_p).abs().max()))
                cerr = max(cerr, float((kst.cpu() - state).abs().max()))
                worst[f64] = max(worst[f64], cerr)
                print("tb2bd_wavefront range chunks %s at (%d, %d) fp64: within "
                      "%.3g of the plain version's chunks, max|band| %.4g"
                      % (list(CHASE_CHUNKS), n, kd, cerr, scale), flush=True)
                if not cerr <= 1e-9 * scale:
                    fail("tb2bd_wavefront chunks at (%d, %d): %.3g > 1e-9*%.4g"
                         % (n, kd, cerr, scale))
            else:
                ref = kernels.tb2bd_wavefront_plain(st.to("cpu", copy=True), kd)
            ref = tuple(x.to(dev) for x in ref)
            torch.cuda.synchronize()
            whole[dt] = (got[0].double(), ref[0].double())
            full_dev = _tb2bd_departure(got, ref)
            if dt == f64:
                errs, tol = (full_dev,), 1e-9 * scale
            else:
                head = kernels.tb2bd_wavefront(st.clone(), kd, 0, CHASE_F32_SWEEPS)
                hp = kernels.tb2bd_wavefront_plain(st.to("cpu", copy=True), kd,
                                                   0, CHASE_F32_SWEEPS)
                errs = (_tb2bd_departure(head, [x.to(dev) for x in hp]),)
                tol = 5e-3 * scale
            worst[dt] = max(worst[dt], max(errs))
            if not max(errs) <= tol:
                fail("%s disagrees with its plain version: %.3g > %.3g"
                     % (label, max(errs), tol))
            bk = _tb2bd_backward(torch, eig, label, b64, *got, kd, eps, sv)
            bp = _tb2bd_backward(torch, eig, label + " (plain)", b64, *ref, kd,
                                 eps, sv)
            print("%s: forward %.3g (tol %.3g = %s*max|band| %.4g%s), whole-chase "
                  "departure %.3g; backward kernel %s, plain %s"
                  % (label, max(errs), tol, "1e-9" if dt == f64 else "5e-3",
                     scale, "" if dt == f64 else ", first %d sweeps"
                     % CHASE_F32_SWEEPS, full_dev,
                     {k: float("%.4g" % v) for k, v in bk.items()},
                     {k: float("%.4g" % v) for k, v in bp.items()}), flush=True)
        (k32, p32), (k64, p64) = whole[f32], whole[f64]
        print("tb2bd_wavefront (%d, %d) whole-chase band departures, max|band| "
              "%.4g: plain fp32 from plain fp64 %.3g, kernel fp32 from kernel "
              "fp64 %.3g, kernel fp32 from plain fp32 %.3g, kernel fp64 from "
              "plain fp64 %.3g"
              % (n, kd, scale, float((p32 - p64).abs().max()),
                 float((k32 - k64).abs().max()), float((k32 - p32).abs().max()),
                 float((k64 - p64).abs().max())), flush=True)
        del whole, k32, p32, k64, p64, b64
    # the witness on a Gaussian triangular band (printed, not gated)
    n, kd = CHASE_CHECKS[1]
    rng = np.random.default_rng(11)
    st = torch.zeros((n, 3 * kd + 2), dtype=f64)
    for d in range(kd + 1):
        st[:n - d, kd + d] = torch.from_numpy(rng.standard_normal(n - d))
    st = st.to(dev)
    sv = torch.linalg.svdvals(_tb_dense(torch, st, kd))
    got = kernels.tb2bd_wavefront(st.clone(), kd)
    ref = [x.to(dev) for x in kernels.tb2bd_wavefront_plain(
        st.to("cpu", copy=True), kd)]
    print("tb2bd_wavefront (%d, %d) fp64 on a Gaussian triangular band "
          "(sigma %.3g ... %.3g): band %.3g, U log %.3g, V log %.3g apart from "
          "the plain version (not gated: reflectors of the last sweeps chase "
          "entries at rounding level), max|band| %.4g"
          % (n, kd, float(sv.max()), float(sv.min()),
             float((got[0] - ref[0]).abs().max()),
             float((got[1] - ref[1]).abs().max()),
             float((got[2] - ref[2]).abs().max()), float(st.abs().max())),
          flush=True)
    del got, ref

    # the main paths' calls: checks on their grids, then the timing, then
    # the barriers
    timed = {}
    for n, kd, dt, seed, peak, rel in (
            (SVD_N, NB, f32, 10, PEAK_FP32_FLOPS, 5e-3),
            (SVD_N64, NB, f64, 8, PEAK_FP64_FLOPS, 1e-9)):
        st = _ge2tb_band(torch, port, _chase, n, kd, seed, dev, dt).to(dt)
        b64 = _tb_dense(torch, st, kd)
        nsw, nblk_max, tmax, nl = kernels.tb_wave_meta(n, kd)
        plan = _chase_plan(torch, kernels, dev, "tb2bd_wavefront", n, kd, dt)
        label = "tb2bd_wavefront (%d, %d) %s, %d clusters x %d blocks" % (
            n, kd, str(dt).split(".")[-1], plan["clusters"], plan["cluster"])
        err, back, chunks = _tb2bd_main_checks(torch, kernels, eig, label, st,
                                               b64, kd, rel)
        del b64
        worst[dt] = max(worst[dt], err)
        work = st.clone()
        ms = event_ms(torch, lambda: kernels.tb2bd_wavefront(work, kd),
                      setup=lambda: work.copy_(st), reps=2)
        sync_ms = event_ms(torch, lambda: kernels.tb2bd_wavefront_barriers(
            work, kd), reps=2)
        size = st.element_size()
        flops = tb2bd_flops(n, kd)
        nbytes = 2.0 * st.numel() * size + 2.0 * nsw * nblk_max * (kd + 1) * size
        t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
        timed[dt] = dict(
            ms=ms, barriers_ms=sync_ms, staggers=tmax + 1, grid_max=nl,
            flops=flops, bytes=nbytes, bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            max_abs_err=err, backward=back, chunks=chunks,
            shape="(%d, %d) %s band, one launch" % (n, 3 * kd + 2,
                                                   str(dt).split(".")[-1]))
        print("tb2bd_wavefront %s: %.3f ms (CUDA events, mean of 2), the "
              "same grid with every task skipped %.3f ms over %d staggers "
              "(%.3f us a barrier: the schedule's floor); %.4g FLOP, %.4g "
              "bytes, bound %.4f ms (%s)"
              % (timed[dt]["shape"], ms, sync_ms, tmax + 1,
                 1e3 * sync_ms / (tmax + 1), flops, nbytes,
                 timed[dt]["bound_ms"], timed[dt]["bound_by"]), flush=True)
        timed[dt].update(plan=plan)
        _redesign_line("tb2bd_wavefront", dt, ms, plan)
        del st, work
    second = _tb2bd_second_route(torch, kernels, eig, dev)
    n, kd = CHASE_CHECKS[1]
    st = _ge2tb_band(torch, port, _chase, n, kd, 7, dev, f32).to(f32)
    plain_ms, _ = once_ms(torch, lambda: kernels.tb2bd_wavefront_plain(
        st.clone(), kd))
    small_ms = event_ms(torch, lambda: kernels.tb2bd_wavefront(st.clone(), kd),
                        reps=2)
    print("tb2bd_wavefront (%d, %d) fp32: kernel %.3f ms, plain version on the "
          "card %.1f ms (one call; timed only here); library: none, no library "
          "call reduces a band to bidiagonal" % (n, kd, small_ms, plain_ms),
          flush=True)
    r = timed[f32]
    return {"tb2bd_wavefront": dict(
        shape=r["shape"], max_abs_err=worst[f32], rel_err=None,
        tol="fp32 5e-3*max|band| over %d sweeps from the same band, fp64 "
            "1e-9*max|band|; whole chases backward <= 3" % CHASE_F32_SWEEPS,
        ms=r["ms"], plain_ms=plain_ms, library_ms=None,
        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
        plain_shape="(%d, %d) fp32" % (n, 3 * kd + 2),
        kernel_ms_at_plain_shape=small_ms, barriers_ms=r["barriers_ms"],
        fp64=dict((k, timed[f64][k]) for k in ("shape", "ms", "barriers_ms",
                                               "bound_ms", "bound_by", "plan")),
        max_abs_err_fp64=worst[f64], grid="%d clusters x %d blocks" % (
            r["plan"]["clusters"], r["plan"]["cluster"]),
        cluster=r["plan"]["cluster"], chase_route=r["plan"]["route"],
        smem_bytes=r["plan"]["smem_bytes"], second_route=second)}


def _tb2bd_second_route(torch, kernels, eig, dev) -> dict:
    """Phase 2h's gate of the band (L2) route: in fp32 and fp64 at the
    narrowest kd that takes it, n = 2·kd + 16, on ge2tb's band of a
    Gaussian at nb = kd: the plan (route l2), fp64 band and logs within
    1e-9·max|band| of the plain version (on a host copy), fp32 within
    5e-3·max|band| over the first CHASE_F32_SWEEPS sweeps, the kernel's
    and the plain version's whole chases to the backward gates of
    :func:`_tb2bd_backward`, σ within 1e-3 / 1e-10 of svdvals."""
    import slate_tpu_torch as port
    from slate_tpu_torch.linalg import _chase

    out = {}
    for dt in (torch.float32, torch.float64):
        kd = _second_route_kd("tb2bd_wavefront", dt)
        n = 2 * kd + 16
        plan = _chase_plan(torch, kernels, dev, "tb2bd_wavefront", n, kd, dt)
        if plan["route"] != "l2":
            fail("tb2bd_wavefront at (%d, %d) %s plans route %s, not l2"
                 % (n, kd, dt, plan["route"]))
        st64 = _ge2tb_band(torch, port, _chase, n, kd, 7, dev, torch.float64)
        b64 = _tb_dense(torch, st64, kd)
        sv = torch.linalg.svdvals(b64)
        st = st64.to(dt)
        eps = float(torch.finfo(dt).eps)
        scale = float(st.abs().max())
        label = "tb2bd_wavefront (%d, %d) %s, route l2" % (n, kd, str(dt).split(".")[-1])
        got = kernels.tb2bd_wavefront(st.clone(), kd)
        ref = [x.to(dev) for x in kernels.tb2bd_wavefront_plain(st.to("cpu", copy=True), kd)]
        if dt == torch.float64:
            err, tol = _tb2bd_departure(got, ref), 1e-9 * scale
        else:
            head = kernels.tb2bd_wavefront(st.clone(), kd, 0, CHASE_F32_SWEEPS)
            hp = kernels.tb2bd_wavefront_plain(st.to("cpu", copy=True), kd, 0,
                                               CHASE_F32_SWEEPS)
            err, tol = _tb2bd_departure(head, [x.to(dev) for x in hp]), 5e-3 * scale
        if not err <= tol:
            fail("%s disagrees with its plain version: %.3g > %.3g" % (label, err, tol))
        bk = _tb2bd_backward(torch, eig, label, b64, *got, kd, eps, sv)
        bp = _tb2bd_backward(torch, eig, label + " (plain)", b64, *ref, kd, eps, sv)
        print("%s: forward %.3g (tol %.3g%s); backward kernel %s, plain %s"
              % (label, err, tol, "" if dt == torch.float64 else ", first %d sweeps"
                 % CHASE_F32_SWEEPS, {k: float("%.4g" % v) for k, v in bk.items()},
                 {k: float("%.4g" % v) for k, v in bp.items()}), flush=True)
        out[str(dt).split(".")[-1]] = dict(n=n, kd=kd, max_abs_err=err, tol=tol,
                                           backward=bk, clusters=plan["clusters"],
                                           cluster=plan["cluster"])
    return out


def _svd_gates(torch, label, a, s, u, vh, eps10, sref=None):
    """bench.py's svd residual ‖A − U·Σ·Vᴴ‖_F/(‖A‖_F·n·10ε)
    (bench.py:1534-1549), ‖UᵀU − I‖_F/(n·10ε) and ‖Vᴴ·V − I‖_F/(n·10ε),
    each ≤ 3, finite values of the economy shapes, σ descending; with
    ``sref`` (torch.linalg.svdvals in fp64) σ within 1e-3·σ_max."""
    m, n = a.shape
    k = min(m, n)
    for name, t in (("s", s), ("U", u), ("Vh", vh)):
        if not bool(torch.isfinite(t).all()):
            fail("%s: %s has non-finite values" % (label, name))
    if tuple(s.shape) != (k,) or tuple(u.shape) != (m, k) \
            or tuple(vh.shape) != (k, n):
        fail("%s: shapes %s %s %s" % (label, tuple(s.shape), tuple(u.shape),
                                      tuple(vh.shape)))
    ad, sd, ud, vd = a.double(), s.double(), u.double(), vh.double()
    eye = torch.eye(k, dtype=torch.float64, device=a.device)
    out = dict(residual=float((ad - (ud * sd[None, :]) @ vd).norm()
                              / (ad.norm() * max(m, n) * eps10)),
               orth_u=float((ud.T @ ud - eye).norm() / (max(m, n) * eps10)),
               orth_v=float((vd @ vd.T - eye).norm() / (max(m, n) * eps10)))
    bad = max(out.values()) > 3 or bool((sd[1:] > sd[:-1]).any())
    if sref is not None:
        out["sigma_rel_err"] = float((sd - sref).abs().max() / sref.max())
        bad = bad or out["sigma_rel_err"] > 1e-3
    print("%s: %s (residual and orthogonality in n*10eps units, <= 3)"
          % (label, {k2: float("%.4g" % v) for k2, v in out.items()}),
          flush=True)
    if bad:
        fail("%s: gates %s" % (label, out))
    return out


def _svd_route_counters(metrics, label, before, launches):
    """One tb2bd_wavefront launch, no band or log byte between host and
    card (``chase.host_bytes`` present and unchanged) and one
    kernel-route chase dispatch since the snapshot ``before``.  Returns
    the counters' delta."""
    after = metrics.snapshot()
    delta = metrics.snapshot_delta(before, after)["counters"]
    host = after["counters"].get("chase.host_bytes")
    if launches["tb2bd_wavefront"] != 1 or host is None \
            or host - before["counters"].get("chase.host_bytes", 0.0) \
            or delta.get("chase.dispatch.kernel", 0) != 1:
        fail("%s: tb2bd_wavefront launched %d times, chase.host_bytes %s, "
             "chase.dispatch.kernel %s" % (label, launches["tb2bd_wavefront"],
                                           host, delta.get("chase.dispatch.kernel")))
    return delta


def main_path_svd(torch, st, kernels, dev) -> dict:
    """Phase 3i: svd of bench.py's svd_fp32 input (bench.py:1534-1549: rng
    10, a Gaussian (8192, 8192), uncut) as an fp32 Matrix, nb = 256, U and
    Vᴴ: exactly one tb2bd_wavefront launch, chase.host_bytes 0 and one
    kernel-route dispatch, bench.py's residual and the orthogonality of U
    and Vᴴ (each ≤ 3 in n·10ε units), σ within 1e-3·σ_max of
    torch.linalg.svdvals in fp64; the first call's wall with the stage
    timers and chase.tb2bd (no timed repeats: each call is ~32 s, mostly
    host), torch.linalg.svd's wall as a
    yardstick (timed only), a profiler split; one more stage 1 (ge2tb,
    where every matmul launch of the path is) with every matmul call held
    to its plain version (:func:`check_path_calls`), as many calls as the
    path launched.
    Then svd in fp64 at n = 4096 (svd_fp64's generator, rng 8) under the
    same gates at 10ε of fp64; svd_vals at n = 2048 through the host
    Givens chase; one tall (8192, 2048) svd and its transpose (the m < n
    swap), gates only."""
    import numpy as np
    from slate_tpu_torch.perf import metrics

    metrics.on()
    a = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (SVD_N, SVD_N)).astype(np.float32)).to(dev)
    A = st.Matrix.from_array(a, nb=NB, device=dev)
    eps32 = float(torch.finfo(torch.float32).eps)
    launches = {}
    before = metrics.snapshot()
    (s, u, vh), ms0, launches["svd"] = run_path(torch, kernels, "svd",
                                                lambda: st.svd(A))
    timers = metrics.snapshot_delta(before, metrics.snapshot())["timers"]
    delta = _svd_route_counters(metrics, "svd fp32", before, launches["svd"])
    print("svd fp32 n=%d nb=%d: first call %.1f ms; launches %s; chase "
          "counters host_bytes %s, dispatch %s"
          % (SVD_N, NB, ms0, {k: v for k, v in launches["svd"].items() if v},
             metrics.snapshot()["counters"].get("chase.host_bytes"),
             {k: v for k, v in delta.items() if "dispatch" in k}), flush=True)
    sref = torch.linalg.svdvals(a.double())
    res = {"fp32": _svd_gates(torch, "svd fp32 n=%d" % SVD_N, a, s, u, vh,
                              10 * eps32, sref)}
    del s, u, vh, sref
    # the first call is the one timed (each call is ~32 s, mostly host)
    stages = {k: v["total_s"] * 1e3 / v["count"] for k, v in timers.items()
              if k.startswith(("stage.svd", "chase.tb2bd"))}
    lib_ms = _wall_ms(torch, lambda: torch.linalg.svd(a, full_matrices=False), 1)
    print("svd fp32 n=%d: first call %.1f ms (host timers, ms: %s); "
          "torch.linalg.svd(full_matrices=False) (library yardstick, one "
          "call) %.1f ms" % (SVD_N, ms0, {
              k: round(v, 2) for k, v in stages.items()}, lib_ms), flush=True)
    res["fp32"].update(wall_ms=ms0, first_ms=ms0, stages_ms=stages,
                       library_ms=lib_ms)
    res["fp32"]["split"] = device_split(
        torch, "svd fp32", lambda: st.svd(A),
        {"tb2bd_wavefront kernel": "tb2bd_wavefront_kernel",
         "matmul kernel": "matmul_f32_kernel"})
    # every matmul launch of the path is stage 1's (the back-transforms'
    # products go to torch.matmul): the check runs ge2tb alone and must
    # see as many calls as the path launched
    checks = {"svd": check_path_calls(torch, kernels, "svd path (ge2tb)",
                                      lambda: st.ge2tb(A),
                                      {"matmul": CHECK_TOL["matmul"]})}
    if checks["svd"]["matmul"]["calls"] != launches["svd"]["matmul"]:
        fail("svd path: ge2tb made %d matmul calls, the path launched %d"
             % (checks["svd"]["matmul"]["calls"], launches["svd"]["matmul"]))
    del A, a

    a = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (SVD_N64, SVD_N64))).to(dev)
    A = st.Matrix.from_array(a, nb=NB, device=dev)
    before = metrics.snapshot()
    (s, u, vh), ms, launches["svd_fp64"] = run_path(
        torch, kernels, "svd_fp64", lambda: st.svd(A))
    _svd_route_counters(metrics, "svd fp64", before, launches["svd_fp64"])
    res["fp64"] = _svd_gates(torch, "svd fp64 n=%d" % SVD_N64, a, s, u, vh,
                             10 * float(torch.finfo(torch.float64).eps),
                             torch.linalg.svdvals(a))
    res["fp64"]["wall_ms"] = ms
    print("svd fp64 n=%d: one call %.1f ms; launches %s"
          % (SVD_N64, ms, {k: v for k, v in launches["svd_fp64"].items() if v}),
          flush=True)
    del A, a, s, u, vh

    n = SVD_HOST_N
    a = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (n, n)).astype(np.float32)).to(dev)
    before = metrics.snapshot()
    s, ms, launches["svd_vals"] = run_path(
        torch, kernels, "svd_vals",
        lambda: st.svd_vals(st.Matrix.from_array(a, nb=NB, device=dev)))
    chased = metrics.snapshot_delta(before, metrics.snapshot())["timers"].get(
        "chase.tb2bd", {}).get("count", 0)
    sref = torch.linalg.svdvals(a.double())
    s_err = float((s.double() - sref).abs().max() / sref.max())
    print("svd_vals fp32 n=%d: %.1f ms, host chase calls %d, launches %s, "
          "sigma %.3g relative" % (n, ms, chased, {
              k: v for k, v in launches["svd_vals"].items() if v}, s_err),
          flush=True)
    if launches["svd_vals"]["tb2bd_wavefront"] or chased != 1 \
            or not s_err <= 1e-3 or tuple(s.shape) != (n,):
        fail("svd_vals: %d kernel chases, %d host chases, sigma %.3g"
             % (launches["svd_vals"]["tb2bd_wavefront"], chased, s_err))
    del a

    m, n = SVD_TALL
    a = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (m, n)).astype(np.float32)).to(dev)
    sref = torch.linalg.svdvals(a.double())
    res["tall"], launches["svd_tall"] = {}, dict.fromkeys(kernels.launches, 0)
    for label, x in (("tall", a), ("wide", a.T.contiguous())):
        before = metrics.snapshot()
        (s, u, vh), ms, lc = run_path(
            torch, kernels, "svd_tall",
            lambda: st.svd(x, opts={"block_size": NB}, device=dev))
        _svd_route_counters(metrics, "svd %s" % label, before, lc)
        for k, v in lc.items():
            launches["svd_tall"][k] += v
        res["tall"][label] = _svd_gates(
            torch, "svd fp32 %s %s, %.1f ms" % (label, tuple(x.shape), ms), x,
            s, u, vh, 10 * eps32, sref)
    res.update(launches=launches, path_checks=checks)
    return res


def _lu_l11(torch, nb: int, dev):
    """A unit-lower L11 as the distributed LU path makes them: the top
    block of a partial-pivot LU of a Gaussian (4·nb, nb) panel (|L| ≤ 1),
    unit diagonal and zeros above it stored."""
    gen = torch.Generator(device=dev).manual_seed(40)
    lu, _ = torch.linalg.lu_factor(torch.randn((4 * nb, nb), generator=gen,
                                               device=dev))
    return torch.tril(lu[:nb], -1) + torch.eye(nb, device=dev)


def _departure_checks(torch, kernels, dev) -> dict:
    """``lu_u12_panel``'s departure where the data set it, not rounding:
    (a) the N(0, 1) unit-lower L11 of the CPU test
    ``test_lu_u12_panel_departure_flags_a_wrong_inverse`` (seeds 12 and
    13, nb = 128, w = 256; condition ~2ⁿ), where the kernel's departure
    and its plain version's must both pass the caller's 1e-2 guard (and
    agree within 4x: both are rounding amplified by the condition);
    (b) a tame unit-lower triangle plus a strict upper part S at the
    path's nb = 256 and w = 16384, which the correction multiplies as
    given: r1 = B − L11·L⁻¹B ≈ −S·L⁻¹B is set by the data, so the
    departure is held within 1e-4 relative of the plain one (and of the
    fp64 value), and U within 1e-4 (CHECK_TOL)."""
    import numpy as np

    out = {}
    for seed in (12, 13):
        nb, w = 128, 256
        rng = np.random.default_rng(seed)
        l11 = torch.from_numpy((np.tril(rng.standard_normal((nb, nb)), -1)
                                + np.eye(nb)).astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.standard_normal((nb, w)).astype(
            np.float32)).to(dev)
        dv = float(kernels.lu_u12_panel(l11, b)[1])
        dvp = float(kernels.lu_u12_panel_plain(l11, b)[1])
        print("kernel lu_u12_panel N(0,1) L11 seed %d (%d,%d): departure "
              "%.4g, plain %.4g (both > 1e-2)" % (seed, nb, w, dv, dvp),
              flush=True)
        if not (dv > 1e-2 and dvp > 1e-2):
            fail("lu_u12_panel: the N(0,1) L11 (seed %d) departs by %.4g "
                 "(plain %.4g), not past the 1e-2 guard" % (seed, dv, dvp))
        same_departure("phase 2i N(0,1) L11 seed %d" % seed, dv, dvp)
        out["ill_seed%d" % seed] = (dv, dvp)
    nb, w = NB, DIST_N
    gen = torch.Generator(device=dev).manual_seed(42)
    l11 = (torch.tril(torch.randn((nb, nb), generator=gen, device=dev), -1)
           / nb ** 0.5 + torch.eye(nb, device=dev)
           + torch.triu(torch.randn((nb, nb), generator=gen, device=dev), 1)
           / nb ** 0.5)
    b = torch.randn((nb, w), generator=gen, device=dev)
    (u, dv), (up, dvp) = kernels.lu_u12_panel(l11, b), \
        kernels.lu_u12_panel_plain(l11, b)
    dv, dvp = float(dv), float(dvp)
    bd = b.double()
    u1 = torch.linalg.solve_triangular(torch.tril(l11).double(), bd,
                                       upper=False)
    d64 = float((bd - l11.double() @ u1).abs().max() / bd.abs().max())
    err = rel_err(u, up)
    print("kernel lu_u12_panel with a strict upper part (%d,%d): departure "
          "%.7g, plain %.7g, fp64 %.7g; U rel %.3e to the plain version"
          % (nb, w, dv, dvp, d64, err), flush=True)
    if not (abs(dv - dvp) <= 1e-4 * dvp and abs(dv - d64) <= 1e-4 * d64
            and err <= CHECK_TOL["lu_u12_panel"]):
        fail("lu_u12_panel with a strict upper part: departure %.7g, plain "
             "%.7g, fp64 %.7g (within 1e-4 relative); U rel %.3e"
             % (dv, dvp, d64, err))
    out["strict_upper"] = (dv, dvp, d64)
    return out


def check_dist_kernels(torch, kernels, dev) -> dict:
    """Phase 2i: the distributed path's two kernels against their plain
    versions at its shapes (n = 16384, nb = 256): ``chol_l21_panel`` on
    the (16384, 256) panel with its SPD diagonal block at rows
    [2048, 2304) read in place (a view of the panel); ``lu_u12_panel`` at
    the widest window solve (256, 16384) and at the depth-2 ring solve
    (256, 256), L11 from a pivoted LU.  Gates: each output within 1e-4
    relative of the plain version (CHECK_TOL), the departure within 4x of
    its plain value and on the same side of the 1e-2 guard
    (:func:`same_departure`), ‖X·Lᵀ − panel‖/‖panel‖ and ‖L11·U − B‖/‖B‖
    ≤ 1e-5; then the departure where the data set it
    (:func:`_departure_checks`).  Timed with CUDA events beside the plain
    versions and one library call each."""
    gen = torch.Generator(device=dev).manual_seed(41)
    out = {}
    m, nb = DIST_N, NB
    panel = torch.randn((m, nb), generator=gen, device=dev)
    g = torch.randn((nb, nb), generator=gen, device=dev)
    k0 = 8 * nb
    panel[k0:k0 + nb] = g @ g.T / nb + torch.eye(nb, device=dev)
    d = panel[k0:k0 + nb]
    (l, x), (lp, xp) = kernels.chol_l21_panel(d, panel), \
        kernels.chol_l21_panel_plain(d, panel)
    torch.cuda.synchronize()
    err = max(rel_err(l, lp), rel_err(x, xp))
    res = float((x.double() @ l.double().T - panel.double()).norm()
                / panel.double().norm())
    print("kernel chol_l21_panel (%d,%d): rel %.3e to the plain version, "
          "||X L^T - panel||/||panel|| %.3e" % (m, nb, err, res), flush=True)
    if not (err <= CHECK_TOL["chol_l21_panel"] and res <= 1e-5):
        fail("chol_l21_panel: rel %.3e, residual %.3e" % (err, res))

    def library_l21():
        lk = torch.linalg.cholesky(d)
        return torch.linalg.solve_triangular(lk.mT, panel, upper=True,
                                             left=False)

    # X = panel·L⁻ᵀ by a triangle, the Cholesky and the inverse, at their
    # useful FLOPs (M·nb², nb³/3 and nb³/3)
    b_ms, b_by = bound(1.0 * m * nb * nb + 2.0 * nb ** 3 / 3,
                       4.0 * (nb * (nb + 1) / 2 + 2 * m * nb + nb * nb))
    # the witness: L is chol_inv_grid's, bitwise chol_inv_panel's L of D
    same_l = bool(torch.equal(l, kernels.chol_inv_panel(d)[0]))
    if not same_l:
        fail("chol_l21_panel: L is not bitwise chol_inv_panel's L of the "
             "same block")
    out["chol_l21_panel"] = dict(
        shape="d (%d,%d) view of the (%d,%d) panel" % (nb, nb, m, nb),
        max_abs_err=float(max((l - lp).abs().max(), (x - xp).abs().max())),
        rel_err=err, residual=res, l_bitwise_chol_inv_panel=same_l,
        tol="rel Frobenius of L and X <= 1e-4; ||X L^T - panel|| <= 1e-5; "
            "L bitwise chol_inv_panel's",
        ms=cuda_ms(torch, lambda: kernels.chol_l21_panel(d, panel), 20),
        plain_ms=cuda_ms(torch, lambda: kernels.chol_l21_panel_plain(
            d, panel), 3),
        library_ms=cuda_ms(torch, library_l21, 20),
        bound_ms=b_ms, bound_by=b_by, grid=kernels._plan(
            "chol_l21_panel", dev, m, nb))
    r = out["chol_l21_panel"]
    print("redesign chol_l21_panel (chol_inv_grid + tile_gemm on a grid of %d "
          "blocks): kernel %.4f ms (0.6628 before the redesign), cholesky + "
          "solve_triangular %.4f ms, bound %.5f ms; L bitwise chol_inv_panel's"
          % (r["grid"], r["ms"], r["library_ms"], r["bound_ms"]), flush=True)
    del panel, x, xp
    # the other ends of the shape rule, once each: nb = 128 and 1024
    for nbx, mx in ((128, 2048), (1024, 4096)):
        px = torch.randn((mx, nbx), generator=gen, device=dev)
        gx = torch.randn((nbx, nbx), generator=gen, device=dev)
        px[:nbx] = gx @ gx.T / nbx + torch.eye(nbx, device=dev)
        dx = px[:nbx]
        (l, x), (lp, xp) = kernels.chol_l21_panel(dx, px), \
            kernels.chol_l21_panel_plain(dx, px)
        torch.cuda.synchronize()
        errx = max(rel_err(l, lp), rel_err(x, xp))
        resx = float((x.double() @ l.double().T - px.double()).norm()
                     / px.double().norm())
        samex = bool(torch.equal(l, kernels.chol_inv_panel(dx)[0]))
        print("kernel chol_l21_panel (%d,%d): rel %.3e to the plain version, "
              "||X L^T - panel||/||panel|| %.3e, L bitwise chol_inv_panel's %s"
              % (mx, nbx, errx, resx, samex), flush=True)
        if not (errx <= CHECK_TOL["chol_l21_panel"] and resx <= 1e-5
                and samex):
            fail("chol_l21_panel (%d,%d): rel %.3e, residual %.3e, L bitwise "
                 "%s" % (mx, nbx, errx, resx, samex))

    l11 = _lu_l11(torch, nb, dev)
    rows = {}
    for w in (m, nb):
        b = torch.randn((nb, w), generator=gen, device=dev)
        (u, dv), (up, dvp) = kernels.lu_u12_panel(l11, b), \
            kernels.lu_u12_panel_plain(l11, b)
        torch.cuda.synchronize()
        err = rel_err(u, up)
        res = float((l11.double() @ u.double() - b.double()).norm()
                    / b.double().norm())
        print("kernel lu_u12_panel (%d,%d): rel %.3e to the plain version, "
              "departure %.4g (plain %.4g), ||L11 U - B||/||B|| %.3e"
              % (nb, w, err, float(dv), float(dvp), res), flush=True)
        if not (err <= CHECK_TOL["lu_u12_panel"] and res <= 1e-5):
            fail("lu_u12_panel (%d,%d): rel %.3e, residual %.3e"
                 % (nb, w, err, res))
        same_departure("phase 2i (%d,%d)" % (nb, w), float(dv), float(dvp))
        # the three products by triangles (L⁻¹ twice, the unit-lower L11
        # the path stores) and the inverse, at their useful FLOPs
        b_ms, b_by = bound(3.0 * nb * nb * w + nb ** 3 / 3.0,
                           4.0 * (nb * nb + 2 * nb * w + 1))
        rows[w] = dict(
            shape="(%d,%d) L11 and (%d,%d) block row" % (nb, nb, nb, w),
            max_abs_err=float((u - up).abs().max()), rel_err=err,
            residual=res, departure=float(dv), plain_departure=float(dvp),
            ms=cuda_ms(torch, lambda: kernels.lu_u12_panel(l11, b), 20),
            plain_ms=cuda_ms(torch, lambda: kernels.lu_u12_panel_plain(
                l11, b), 3),
            library_ms=cuda_ms(torch, lambda: torch.linalg.solve_triangular(
                l11, b, upper=False, unitriangular=True), 20),
            bound_ms=b_ms, bound_by=b_by)
    # timed also at (256, 4096), the widest solve of the checked 4096
    # runs (phases 3j and 3k), on an input of its own generator
    g4 = torch.Generator(device=dev).manual_seed(43)
    b4 = torch.randn((nb, DIST_CHECK_N), generator=g4, device=dev)
    rows[m].update(
        w4096_ms=cuda_ms(torch, lambda: kernels.lu_u12_panel(l11, b4), 20),
        w4096_plain_ms=cuda_ms(torch, lambda: kernels.lu_u12_panel_plain(
            l11, b4), 3),
        w4096_library_ms=cuda_ms(torch, lambda: torch.linalg.solve_triangular(
            l11, b4, upper=False, unitriangular=True), 20),
        w4096_bound_ms=bound(3.0 * nb * nb * DIST_CHECK_N + nb ** 3 / 3.0,
                             4.0 * (nb * nb + 2 * nb * DIST_CHECK_N + 1))[0])
    r = rows[m]
    print("redesign lu_u12_panel (phases over the whole grid): block row "
          "(%d,%d) kernel %.4f ms against the library's %.4f ms (bound "
          "%.5f ms); ring (%d,%d) kernel %.4f ms against %.4f ms (bound "
          "%.6f ms); (%d,%d) kernel %.4f ms, plain %.4f ms, library %.4f ms, "
          "bound %.5f ms"
          % (nb, m, r["ms"], r["library_ms"], r["bound_ms"], nb, nb,
             rows[nb]["ms"], rows[nb]["library_ms"], rows[nb]["bound_ms"],
             nb, DIST_CHECK_N, r["w4096_ms"], r["w4096_plain_ms"],
             r["w4096_library_ms"], r["w4096_bound_ms"]), flush=True)
    r.update(tol="rel Frobenius of U <= 1e-4; ||L11 U - B|| <= 1e-5; "
                 "departure within 4x of the plain one, same guard verdict; "
                 "set by the data: past 1e-2, or within 1e-4 relative",
             departures=_departure_checks(torch, kernels, dev),
             ring_shape=rows[nb]["shape"], ring_ms=rows[nb]["ms"],
             ring_plain_ms=rows[nb]["plain_ms"],
             ring_library_ms=rows[nb]["library_ms"],
             ring_bound_ms=rows[nb]["bound_ms"],
             ring_max_abs_err=rows[nb]["max_abs_err"])
    out["lu_u12_panel"] = r
    for name, r in out.items():
        print("kernel %s %s: max_abs_err %.3e (%s); kernel %.4f ms, plain "
              "%.4f ms, library %.4f ms, bound %.5f ms (%s)%s"
              % (name, r["shape"], r["max_abs_err"], r["tol"], r["ms"],
                 r["plain_ms"], r["library_ms"], r["bound_ms"], r["bound_by"],
                 "; ring call %s: kernel %.4f ms, plain %.4f ms, library "
                 "%.4f ms, bound %.5f ms" % (
                     r["ring_shape"], r["ring_ms"], r["ring_plain_ms"],
                     r["ring_library_ms"], r["ring_bound_ms"])
                 if "ring_ms" in r else ""), flush=True)
    return out


def _dist_report(label: str, res: dict, drivers) -> None:
    for name in drivers:
        r = res[name]
        print("%s %s: wall %.1f ms; %s; launches %s; collectives %s"
              % (label, name, r["wall_ms"], ", ".join(
                  "%s %.4g" % (k, r[k]) for k in ("residual", "max_abs_L")
                  if k in r), r["launches"], {
                  k: round(v) for k, v in r["collectives"].items()}),
              flush=True)


def _dist_inputs(torch, n: int, dev):
    """Phase 3j's extra inputs at n: an SPD (R + Rᵀ)/2 + n·I, a Gaussian
    and DIST_NRHS Gaussian right-hand sides, from seed 51."""
    gen = torch.Generator(device=dev).manual_seed(51)
    r = torch.randn((n, n), generator=gen, device=dev)
    a_spd = (r + r.T) / 2 + n * torch.eye(n, device=dev)
    del r
    return (a_spd, torch.randn((n, n), generator=gen, device=dev),
            torch.randn((n, DIST_NRHS), generator=gen, device=dev))


def main_path_dist(torch, st, kernels, dev) -> dict:
    """Phase 3j: the distributed drivers on a 1×1 grid, a
    ``torch.distributed`` world of one with the NCCL backend (a FileStore
    in a temporary directory), so every collective is a real NCCL call:
    pgemm, pposv and pgesv at n = 16384, nb = 256, fp32, 128 right-hand
    sides, the sites at their card defaults (printed), through
    ``launch.rank_baseline`` (the tester's residuals ≤ 3, |L| ≤ 1 + 100ε),
    each driver a path of its own with exact kernel launches
    (DIST_EXACT); the wall and a profiler split of one more pposv; then
    at DIST_CHECK_N one pposv and one pgesv with every
    chol_l21_panel, lu_u12_panel and matmul call held to its plain
    version (:func:`check_path_calls`), and once more with
    ``dist_panel=pallas_panel`` pinned, its chol_inv_panel and
    trtri_panel calls held too."""
    import os
    import tempfile

    import torch.distributed as dist
    from slate_tpu_torch.parallel import launch
    from slate_tpu_torch.perf import autotune

    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        try:
            mesh = st.parallel.make_grid_mesh(1, 1)
            print("phase 3j: %r" % (mesh,), flush=True)
            drivers = ("pgemm", "pposv", "pgesv")
            res = launch.rank_baseline(mesh, DIST_N, NB, DIST_NRHS, 50,
                                       drivers)
            _dist_report("dist 1x1 n=%d nb=%d" % (DIST_N, NB), res, drivers)
            print("dist 1x1 site decisions: %s" % res["decisions"], flush=True)
            launches = {}
            for name in drivers:
                path = "dist_" + name
                got = dict.fromkeys(kernels.launches, 0)
                got.update(res[name]["launches"])
                launches[path] = got
                missing = [k for k in PATHS[path] if got[k] <= 0]
                if missing:
                    fail("the %s path launched no %s kernel"
                         % (path, ", ".join(missing)))
                for k, want in DIST_EXACT.get(path, {}).items():
                    if got[k] != want:
                        fail("%s: %d %s launches, want %d"
                             % (path, got[k], k, want))
            t_sub = {"baseline": time.perf_counter() - t_start}
            t0 = time.perf_counter()
            # where pposv's time goes: one more call's wall, then a
            # profiled call.  pgesv's maxloc panel is ~15 launches a
            # column: profiling it at 4096 took ~55 s of profiler time (my
            # chip run 1, PR 8), so it is not repeated here
            a_spd, _, b = _dist_inputs(torch, DIST_N, dev)

            def pposv_once():
                return st.parallel.pposv(a_spd, b, mesh, nb=NB)

            wall = _wall_ms(torch, pposv_once, 1)
            splits = {"pposv": dict(device_split(
                torch, "dist 1x1 pposv n=%d (wall %.1f ms)" % (DIST_N, wall),
                pposv_once, {"chol_l21_panel kernel": "chol_l21_panel_kernel",
                             "matmul kernel": "matmul_f32_kernel",
                             "nccl": "nccl"}), wall_ms=wall)}
            n = DIST_CHECK_N
            a_spd, a_gen, b = _dist_inputs(torch, n, dev)
            t_sub["splits"] = time.perf_counter() - t0
            t0 = time.perf_counter()

            def both():
                st.parallel.pposv(a_spd, b, mesh, nb=NB)
                st.parallel.pgesv(a_gen, b, mesh, nb=NB)

            tols = {k: CHECK_TOL[k] for k in ("matmul", "chol_l21_panel",
                                              "lu_u12_panel")}
            checks = {"dist": check_path_calls(
                torch, kernels, "dist 1x1 n=%d" % n, both, tols)}
            t_sub["checks"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            os.environ[FORCE] = "dist_panel=pallas_panel"
            try:
                tols = {k: CHECK_TOL[k] for k in ("matmul", "chol_inv_panel",
                                                  "trtri_panel")}
                # the unit-lower L11 of a pivoted LU of a Gaussian has a
                # condition of 230-350 at nb = 256 (potri's triangles, for
                # which phase 2 set 1e-4, far less): ‖L·L⁻¹ − I‖ of the
                # plain version is 3.4e-5-5.2e-5 there on the host
                checks["dist_pallas_panel"] = check_path_calls(
                    torch, kernels, "dist 1x1 n=%d dist_panel=pallas_panel"
                    % n, both, tols, ident_tol=1e-3)
            finally:
                del os.environ[FORCE]
            t_sub["pallas_panel"] = time.perf_counter() - t0
            print("dist pallas_panel decisions: %s; phase 3j's parts (s): %s"
                  % ({k: v for k, v in autotune.decisions().items()
                      if k.startswith("dist_panel")},
                     {k: round(v, 1) for k, v in t_sub.items()}), flush=True)
        finally:
            dist.destroy_process_group()
    res.update(launches=launches, path_checks=checks, splits=splits)
    return res


def rank_checked(mesh, n: int) -> dict:
    """Rank body of phase 3k's checked run: pposv and pgesv at ``n`` on
    this rank's mesh (``launch.rank_baseline``, its gates) with every
    ``chol_l21_panel``, ``lu_u12_panel`` and ``matmul`` call held to its
    plain version (:func:`check_path_calls`), so the 2×2 grid's own
    calls are compared: block rows with the grid's row stride and L11
    blocks from the tournament's pivots (|L| up to ~2).  ``dist_chunk=2``
    is pinned for this run, so the sliced broadcasts (two all-reduces a
    panel, the same bytes) run on the card too."""
    import os

    import torch
    from slate_tpu_torch.ops import kernels
    from slate_tpu_torch.parallel import launch

    tols = {k: CHECK_TOL[k] for k in ("matmul", "chol_l21_panel",
                                      "lu_u12_panel")}
    res = {}

    def run():
        res.update(launch.rank_baseline(mesh, n, NB, DIST_NRHS, 52,
                                        ("pposv", "pgesv")))

    os.environ[FORCE] = "dist_chunk=2"
    try:
        checks = check_path_calls(
            torch, kernels, "dist 2x2 rank %s n=%d dist_chunk=2"
            % ((mesh.r, mesh.c), n), run, tols)
    finally:
        del os.environ[FORCE]
    return {"rank": res["rank"], "checks": checks, "baseline": res}


def main_path_dist_shared(torch) -> dict:
    """Phase 3k: pposv and pgesv at n = 16384, nb = 256 (BASELINE.md
    config 3's size and 2×2 grid, uncut) on four processes that SHARE the
    one card, through ``launch.run_spmd`` with the gloo backend on CUDA
    tensors (NCCL refuses two ranks on one card), the sites at their
    card defaults (tournament pivots, depth 2): every rank's residuals
    ≤ 3 and |L| ≤ 1 + 100ε (``launch.rank_baseline``), every rank
    launching both kernels; then, in the same processes, one checked run
    at DIST_CHECK_N (:func:`rank_checked`).  A failing rank fails the
    phase.  The walls are those of four processes on one card, not a
    multi-GPU number."""
    from slate_tpu_torch.parallel import launch

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = launch.run_spmd(
        "slate_tpu_torch.parallel.launch:rank_jobs", 2, 2,
        ([("slate_tpu_torch.parallel.launch:rank_baseline",
           (DIST_N, NB, DIST_NRHS, 50, ("pposv", "pgesv"))),
          ("chip_smoke:rank_checked", (DIST_CHECK_N,))],),
        backend="gloo", device="cuda:0", timeout=600)
    wall = time.perf_counter() - t0
    ranks = [o[0] for o in out]
    for res in ranks:
        _dist_report("dist 2x2 (4 processes sharing one card) rank %s n=%d"
                     % (res["rank"], DIST_N), res, ("pposv", "pgesv"))
        for name in ("pposv", "pgesv"):
            missing = [k for k in PATHS["dist_" + name]
                       if res[name]["launches"].get(k, 0) <= 0]
            if missing:
                fail("dist 2x2 rank %s: %s launched no %s kernel"
                     % (res["rank"], name, ", ".join(missing)))
    for chk in (o[1] for o in out):
        _dist_report("dist 2x2 checked, dist_chunk=2, rank %s n=%d"
                     % (chk["rank"], DIST_CHECK_N), chk["baseline"],
                     ("pposv", "pgesv"))
    print("dist 2x2 site decisions (rank 0): %s; the spawn with its four "
          "processes took %.1f s" % (ranks[0]["decisions"], wall), flush=True)
    return {"ranks": ranks, "checks": [o[1]["checks"] for o in out],
            "wall_s": wall}


def _tiles(x, t: int):
    """The (nt, t, t) tile batch of a square matrix, tile-row-major (a
    contiguous copy)."""
    n = x.shape[0]
    return x.reshape(n // t, t, n // t, t).permute(0, 2, 1, 3).reshape(
        -1, t, t)


def _tz_regions(torch, m: int, n: int, lower: bool, dev):
    """Masks of the strict stored triangle, the diagonal and the other
    triangle of an (m, n) matrix."""
    i = torch.arange(m, device=dev)[:, None]
    j = torch.arange(n, device=dev)[None, :]
    strict = (i > j) if lower else (i < j)
    return {"strict triangle": strict, "diagonal": i == j,
            "other triangle": ~strict & (i != j)}


def _tz_checks(torch, kernels, label, a, lower, bm=256, bn=256):
    """tzset and tzscale of ``a`` against their plain versions, bitwise,
    region by region, and the regions against what each op must leave
    there.  Returns the max |kernel − plain| over both."""
    off, dg = -0.75, 2.5
    regions = _tz_regions(torch, a.shape[0], a.shape[1], lower, a.device)
    offv = torch.tensor(off, dtype=a.dtype, device=a.device)
    dgv = torch.tensor(dg, dtype=a.dtype, device=a.device)
    want = {"tzset": {"strict triangle": lambda: offv.expand_as(a),
                      "diagonal": lambda: dgv.expand_as(a),
                      "other triangle": lambda: a},
            "tzscale": {"strict triangle": lambda: a * offv,
                        "diagonal": lambda: a * dgv,
                        "other triangle": lambda: a}}
    err = 0.0
    for op in ("tzset", "tzscale"):
        got = getattr(kernels, op)(a, lower, off, dg, bm=bm, bn=bn)
        ref = getattr(kernels, op + "_plain")(a, lower, off, dg)
        torch.cuda.synchronize()
        for name, mask in regions.items():
            if not torch.equal(got[mask], ref[mask]):
                fail("%s %s %s: the %s differs from the plain version"
                     % (op, label, "lower" if lower else "upper", name))
            if not torch.equal(got[mask], want[op][name]()[mask]):
                fail("%s %s: the %s is not what %s leaves there"
                     % (op, label, name, op))
        err = max(err, float((got - ref).abs().max()))
        del got, ref
    return err


def _elementwise_checks(torch, kernels, label, a, b, r, c, bm=256,
                        bn=256) -> None:
    """geadd and gescale_row_col against their plain versions, bitwise."""
    got = kernels.geadd(1.5, a, -0.3, b, bm=bm, bn=bn)
    ref = kernels.geadd_plain(1.5, a, -0.3, b)
    got2 = kernels.gescale_row_col(r, c, a, bm=bm, bn=bn)
    ref2 = kernels.gescale_row_col_plain(r, c, a)
    torch.cuda.synchronize()
    for name, g, p in (("geadd", got, ref), ("gescale_row_col", got2, ref2)):
        if not torch.equal(g, p):
            fail("%s %s differs from its plain version: max %.3e"
                 % (name, label, float((g - p).abs().max())))


def check_tile_kernels(torch, kernels, dev) -> dict:
    """Phase 2j: tile_norms, tzset/tzscale, geadd and gescale_row_col
    against their plain versions: the (4096, 256, 256) tile batch of a
    16384² fp32 Gaussian and the matrix itself, fp64 at 8192², and the
    small shapes (384, 640) and (640, 384) at bm = bn = 128, lower and
    upper.  Bitwise but for the fro partials (1e-5 relative in fp32,
    1e-12 in fp64); a tile holding a NaN gives NaN for max and fro, and
    geadd with β = 0 keeps a NaN of B.  Then each timed (CUDA events)
    beside its bytes bound, its plain version and a library call or a
    torch composition."""
    gen = torch.Generator(device=dev).manual_seed(90)
    n, t = TILE_N, TILE_T
    out = {}

    def norm_checks(x, label, tol):
        tiles = _tiles(x, t)
        mx, mxp = kernels.tile_norms(tiles, "max"), \
            kernels.tile_norms_plain(tiles, "max")
        fr, frp = kernels.tile_norms(tiles, "fro"), \
            kernels.tile_norms_plain(tiles, "fro")
        torch.cuda.synchronize()
        if not torch.equal(mx, mxp):
            fail("tile_norms max %s differs from its plain version" % label)
        rel = float(((fr.double() - frp.double()).abs()
                     / frp.double()).max())
        if not rel <= tol:
            fail("tile_norms fro %s: rel %.3e > %g" % (label, rel, tol))
        return tiles, rel, float((fr - frp).abs().max())

    x = torch.randn((n, n), generator=gen, device=dev)
    tiles, fro_rel, fro_abs = norm_checks(x, "fp32 (4096, 256, 256)", 1e-5)
    x64 = torch.randn((TILE_N64, TILE_N64), generator=gen, device=dev,
                      dtype=torch.float64)
    tiles64, fro_rel64, _ = norm_checks(x64, "fp64 (1024, 256, 256)", 1e-12)
    del tiles64
    # one tile holding a NaN: NaN for both norms there, finite elsewhere
    nanb = tiles[:16].clone()
    nanb[5, 17, 200] = float("nan")
    for norm in ("max", "fro"):
        got = kernels.tile_norms(nanb, norm)
        nan = torch.isnan(got)
        if not (bool(nan[5]) and int(nan.sum()) == 1 and torch.equal(
                nan, torch.isnan(kernels.tile_norms_plain(nanb, norm)))):
            fail("tile_norms %s: the NaN tile gives %s" % (norm, got[:8]))
    del nanb

    tz_err = 0.0
    for lower in (True, False):
        tz_err = max(tz_err, _tz_checks(torch, kernels, "fp32 16384^2", x,
                                        lower),
                     _tz_checks(torch, kernels, "fp64 8192^2", x64, lower))
        for shape in ((384, 640), (640, 384)):
            for dt in (torch.float32, torch.float64):
                small = torch.randn(shape, generator=gen, device=dev,
                                    dtype=dt)
                tz_err = max(tz_err, _tz_checks(
                    torch, kernels, "%s %s" % (dt, shape), small, lower,
                    128, 128))
    y = torch.randn((n, n), generator=gen, device=dev)
    r = torch.randn(n, generator=gen, device=dev)
    c = torch.randn(n, generator=gen, device=dev)
    _elementwise_checks(torch, kernels, "fp32 16384^2", x, y, r, c)
    y64 = torch.randn((TILE_N64, TILE_N64), generator=gen, device=dev,
                      dtype=torch.float64)
    _elementwise_checks(torch, kernels, "fp64 8192^2", x64, y64, r[:TILE_N64]
                        .double(), c[:TILE_N64].double())
    for shape in ((384, 640), (640, 384)):
        for dt in (torch.float32, torch.float64):
            a_s, b_s = (torch.randn(shape, generator=gen, device=dev,
                                    dtype=dt) for _ in range(2))
            _elementwise_checks(torch, kernels, "%s %s" % (dt, shape), a_s,
                                b_s, a_s[:, 0].contiguous(),
                                b_s[0].contiguous(), 128, 128)
    # geadd with β = 0 reads B: a NaN there stays
    bn = y.clone()
    bn[7, 11] = float("nan")
    g0 = kernels.geadd(2.0, x, 0.0, bn)
    if not (bool(torch.isnan(g0[7, 11])) and int(torch.isnan(g0).sum()) == 1):
        fail("geadd with beta = 0 dropped the NaN of B")
    del bn, g0
    print("phase 2j: tile_norms fro rel %.3e (fp32), %.3e (fp64); tz, geadd, "
          "gescale_row_col and tile_norms max bitwise at 16384^2 fp32, "
          "8192^2 fp64, (384, 640) and (640, 384) at 128-tiles; the NaN "
          "tile and beta = 0 NaN kept" % (fro_rel, fro_rel64), flush=True)

    # ---- timing at 16384² fp32 (fp64 at 8192² as an extra) -------------
    s = 4
    inf = float("inf")
    mn = float(n) * n
    low = n * (n + 1) / 2.0               # a lower triangle with its diagonal

    def tzset_comp():
        o = torch.full_like(x, -0.75).tril_(-1)
        o += x.triu(1)
        o.diagonal().fill_(2.5)
        return o

    def tzscale_comp():
        o = x.tril(-1).mul_(-0.75)
        o += x.triu(1)
        o.diagonal().copy_(x.diagonal() * 2.5)
        return o

    rows = {
        "tile_norms": dict(
            shape="(4096,256,256) fp32 tiles of a 16384^2 Gaussian, max",
            kern=lambda: kernels.tile_norms(tiles, "max"),
            plain=lambda: kernels.tile_norms_plain(tiles, "max"),
            lib=lambda: torch.linalg.vector_norm(tiles, inf, dim=(1, 2)),
            library="torch.linalg.vector_norm(x, inf, dim=(1, 2))",
            flops=mn, nbytes=s * (mn + tiles.shape[0]),
            max_abs_err=0.0, rel_err=0.0,
            tol="max bitwise; fro rel <= 1e-5 (fp32), 1e-12 (fp64)"),
        "tzset": dict(
            shape="(16384,16384) fp32, lower",
            kern=lambda: kernels.tzset(x, True, -0.75, 2.5),
            plain=lambda: kernels.tzset_plain(x, True, -0.75, 2.5),
            lib=tzset_comp, library="composition (full, tril_, triu, +=, "
            "diagonal fill)",
            flops=0.0, nbytes=s * ((mn - low) + mn),
            max_abs_err=tz_err, rel_err=0.0, tol="bitwise, by region"),
        "tzscale": dict(
            shape="(16384,16384) fp32, lower",
            kern=lambda: kernels.tzscale(x, True, -0.75, 2.5),
            plain=lambda: kernels.tzscale_plain(x, True, -0.75, 2.5),
            lib=tzscale_comp, library="composition (tril, mul_, triu, +=, "
            "diagonal copy)",
            flops=mn, nbytes=s * 2 * mn,
            max_abs_err=tz_err, rel_err=0.0, tol="bitwise, by region"),
        "geadd": dict(
            shape="(16384,16384) fp32, alpha 1.5, beta -0.3",
            kern=lambda: kernels.geadd(1.5, x, -0.3, y),
            plain=lambda: kernels.geadd_plain(1.5, x, -0.3, y),
            lib=lambda: x.mul(1.5).add_(y, alpha=-0.3),
            library="composition (mul, add_ with alpha)",
            flops=3 * mn, nbytes=s * 3 * mn,
            max_abs_err=0.0, rel_err=0.0, tol="bitwise"),
        "gescale_row_col": dict(
            shape="(16384,16384) fp32, r and c of 16384",
            kern=lambda: kernels.gescale_row_col(r, c, x),
            plain=lambda: kernels.gescale_row_col_plain(r, c, x),
            lib=lambda: (x * r[:, None]).mul_(c),
            library="composition (mul, mul_)",
            flops=2 * mn, nbytes=s * (2 * mn + 2 * n),
            max_abs_err=0.0, rel_err=0.0, tol="bitwise"),
    }
    fp64 = {"tile_norms": lambda: kernels.tile_norms(_tiles(x64, t), "max"),
            "tzset": lambda: kernels.tzset(x64, True, -0.75, 2.5),
            "tzscale": lambda: kernels.tzscale(x64, True, -0.75, 2.5),
            "geadd": lambda: kernels.geadd(1.5, x64, -0.3, y64),
            "gescale_row_col": lambda: kernels.gescale_row_col(
                r[:TILE_N64].double(), c[:TILE_N64].double(), x64)}
    for name, row in rows.items():
        b_ms, b_by = bound(row.pop("flops"), row.pop("nbytes"))
        kern, plain, lib = row.pop("kern"), row.pop("plain"), row.pop("lib")
        row.update(ms=cuda_ms(torch, kern, 20), plain_ms=cuda_ms(torch, plain,
                                                                  5),
                   library_ms=cuda_ms(torch, lib, 20), bound_ms=b_ms,
                   bound_by=b_by, fp64_8192_ms=cuda_ms(torch, fp64[name], 10))
        out[name] = row
    fro_ms = cuda_ms(torch, lambda: kernels.tile_norms(tiles, "fro"), 20)
    out["tile_norms"]["fro_ms"] = fro_ms
    out["tile_norms"]["max_abs_err_fro"] = fro_abs
    for name, row in out.items():
        print("kernel %s %s: max_abs_err %.3e (%s); kernel %.4f ms, plain "
              "%.4f ms, %s %.4f ms, bound %.5f ms (%s); fp64 at 8192^2 %.4f ms"
              % (name, row["shape"], row["max_abs_err"], row["tol"],
                 row["ms"], row["plain_ms"], row["library"],
                 row["library_ms"], row["bound_ms"], row["bound_by"],
                 row["fp64_8192_ms"]), flush=True)
    print("kernel tile_norms fro at (4096,256,256): %.4f ms" % fro_ms,
          flush=True)
    del x, y, x64, y64, tiles
    torch.cuda.empty_cache()
    return out


def _masked_ref(torch, a64, kind: str, kd: int = 0):
    """The fp64 matrix a norm of ``kind`` reads: Symmetric (Lower) mirrors
    the lower triangle, Triangular (Lower, Unit) keeps it with ones on
    the diagonal, HermitianBand (Lower, kd) mirrors it inside |i − j| ≤ kd."""
    lo = torch.tril(a64)
    if kind == "Triangular":
        lo.diagonal().fill_(1.0)
        return lo
    full = lo + torch.tril(a64, -1).T
    if kind == "HermitianBand":
        full = torch.triu(torch.tril(full, kd), -kd)
    return full


def _norm_refs(torch, a64):
    return [float(a64.abs().max()), float(torch.linalg.matrix_norm(a64, 1)),
            float(torch.linalg.matrix_norm(a64, float("inf"))),
            float(torch.linalg.matrix_norm(a64, "fro"))]


def _norm_gates(torch, st, label, got, refs):
    """tester.py's norm routine: Max exact, One, Inf and Fro within 1e-5
    of the fp64 reference."""
    errs = [abs(float(g) - r) / r for g, r in zip(got, refs)]
    print("norm %s: Max %.9g One %.9g Inf %.9g Fro %.9g; rel to fp64 %s"
          % ((label,) + tuple(float(g) for g in got)
             + (", ".join("%.2e" % e for e in errs),)), flush=True)
    if float(got[0]) != refs[0] or not max(errs[1:]) <= 1e-5:
        fail("norm %s: %s against %s" % (label, [float(g) for g in got],
                                         refs))


def _scaled_resid(torch, a, x, b) -> float:
    """The tester's ‖A·x − b‖/(‖A‖·‖x‖·ε·n) in fp64, ε of x's dtype."""
    eps = float(torch.finfo(x.dtype).eps)
    ad, xd = a.double(), x.double()
    xd = xd[:, None] if xd.ndim == 1 else xd
    bd = b.double()
    bd = bd[:, None] if bd.ndim == 1 else bd
    return float((ad @ xd - bd).norm()
                 / (ad.norm() * xd.norm() * eps * a.shape[0]))


def _band(torch, gen, n: int, kl: int, ku: int, dev, spd: bool):
    """A random fp32 band (kl, ku), diagonally dominant; symmetric
    positive definite (kl = ku) when ``spd``."""
    g = torch.randn((n, n), generator=gen, device=dev)
    g = torch.triu(torch.tril(g, kl), -ku)
    if spd:
        g = (g + g.T) / 2
    return g + (2.0 * (kl + ku) + 2.0) * torch.eye(n, device=dev)


def _leg_launches(torch, kernels, name, leg, direct, stock) -> dict:
    """Launch counts of a mixed driver's fp32 low leg alone, with its
    split-leg record (metrics on): they must be those of one direct fp32
    factorization of the same input under ``split_factor_leg`` (plus one
    stock ``stock()`` factorization where the κ·ε probe demoted the leg),
    hold every kernel of the driver's path, and launch no ``matmul``
    unless demoted.  Returns ``{"launches", "kappa_eps", "demoted"}``."""
    from slate_tpu_torch.linalg._refine import split_factor_leg
    from slate_tpu_torch.perf import metrics

    was_on = metrics.enabled()
    metrics.on()
    before = metrics.snapshot()
    kernels.reset_launches()
    leg()
    torch.cuda.synchronize()
    got = dict(kernels.launches)
    after = metrics.snapshot()
    if not was_on:
        metrics.off()
    counts = metrics.snapshot_delta(before, after)["counters"]
    ke = after["gauges"].get("mixed.%s.kappa_eps" % name)
    demoted = bool(counts.get("mixed.%s.split_demoted" % name))
    if not counts.get("mixed.%s.split_leg" % name):
        fail("%s: the low leg did not take the split leg" % name)
    kernels.reset_launches()
    with split_factor_leg():
        direct()
    if demoted:
        stock()
    torch.cuda.synchronize()
    want = dict(kernels.launches)
    print("%s low leg launches %s; one direct fp32 factor under the split "
          "leg%s %s; kappa*n*eps32 %.4g (demotion past 0.25), demoted %s"
          % (name, {k: v for k, v in got.items() if v},
             " and one stock" if demoted else "",
             {k: v for k, v in want.items() if v}, ke, demoted), flush=True)
    if got != want or any(got[k] <= 0 for k in PATHS[name]) \
            or (got["matmul"] and not demoted):
        fail("%s: the fp32 low leg's launches %s are not the direct "
             "factor's %s" % (name, got, want))
    return {"launches": got, "kappa_eps": ke, "demoted": demoted}


@contextlib.contextmanager
def _stock_leg():
    """The mixed drivers' stock fp32 leg for the body
    (``SLATE_TPU_TORCH_SPLIT_GEMM=0``)."""
    from slate_tpu_torch import config

    saved = config.split_gemm
    config.split_gemm = False
    try:
        yield
    finally:
        config.split_gemm = saved


def _stock_leg_ms(torch, fn, reps: int = 3) -> float:
    """Median host wall of ``fn`` (ending in a sync) on the stock fp32
    leg."""
    with _stock_leg():
        return _wall_ms(torch, fn, reps)


#: the device split of a mixed driver on either leg: the two product
#: kernels, the LU panel kernel, cuBLAS's triangular solves (the κ·ε
#: probe's and the refinement's), cuSOLVER's Cholesky leaves, and the
#: elementwise passes (the bf16 split of each product's operands, the
#: casts and the residuals)
MIXED_SPLIT_KEYS = {"split_matmul kernel": "split_matmul",
                    "matmul kernel (3xTF32)": "matmul_f32_kernel",
                    "lu_panel kernel": "lu_panel",
                    "trsm (cuBLAS)": "trsm",
                    "potrf (cuSOLVER)": "potrf",
                    "elementwise": "elementwise"}


def _mixed_breakdown(torch, name, drive, leg, direct) -> dict:
    """Where a mixed driver's split leg spends its time beside the stock
    leg: each leg's wall (median of 3), its low leg alone (``leg``: the
    factor and, on the split leg, the κ·ε probe; median of 3), one fp32
    factor alone (``direct``; under ``split_factor_leg`` and stock, median
    of 3), the probe as the split leg's low leg less its factor, and a
    ``torch.profiler`` device split of one call of the driver on each
    leg."""
    from slate_tpu_torch.linalg._refine import split_factor_leg

    def split_direct():
        with split_factor_leg():
            return direct()

    out = {"split": {"wall_ms": _wall_ms(torch, drive, 3),
                     "low_leg_ms": _wall_ms(torch, leg, 3),
                     "factor_ms": _wall_ms(torch, split_direct, 3),
                     "device": device_split(torch, name + " split leg", drive,
                                            MIXED_SPLIT_KEYS)}}
    with _stock_leg():
        out["stock"] = {"wall_ms": _wall_ms(torch, drive, 3),
                        "low_leg_ms": _wall_ms(torch, leg, 3),
                        "factor_ms": _wall_ms(torch, direct, 3),
                        "device": device_split(torch, name + " stock leg",
                                               drive, MIXED_SPLIT_KEYS)}
    out["probe_ms"] = out["split"]["low_leg_ms"] - out["split"]["factor_ms"]
    print("%s breakdown (ms, medians of 3): split leg wall %.1f, low leg "
          "%.1f = fp32 factor %.1f + kappa probe %.1f; stock leg wall %.1f, "
          "low leg %.1f, fp32 factor %.1f"
          % (name, out["split"]["wall_ms"], out["split"]["low_leg_ms"],
             out["split"]["factor_ms"], out["probe_ms"],
             out["stock"]["wall_ms"], out["stock"]["low_leg_ms"],
             out["stock"]["factor_ms"]), flush=True)
    return out


def main_path_aux(torch, st, kernels, dev) -> dict:
    """Phase 3l: the slice's path — norms, the tile kernels tied to the
    driver functions, condition estimates, the mixed-precision solvers
    and the band solvers — each a path with the launch counts set to 0
    before it and read after it."""
    from slate_tpu_torch.linalg import cholesky as tchol, lu as tlu, \
        qr as tqr
    from slate_tpu_torch.ops import blocks
    from slate_tpu_torch.testing import random_spd

    gen = torch.Generator(device=dev).manual_seed(91)
    launches, walls, res = {}, {}, {}
    n = TILE_N
    one, inf_, fro, mx = st.Norm.One, st.Norm.Inf, st.Norm.Fro, st.Norm.Max

    def path(name, fn):
        """``fn`` as one path: counts zeroed before, read after; a kernel
        of PATHS[name] that did not launch fails the run."""
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0) * 1e3
        launches[name] = dict(kernels.launches)
        missing = [k for k in PATHS.get(name, ()) if launches[name][k] <= 0]
        if missing:
            fail("the %s path launched no %s kernel" % (name,
                                                        ", ".join(missing)))
        return out

    # ---- norms (tester.py's norm routine at 16384² fp32) -----------------
    a = torch.randn((n, n), generator=gen, device=dev)
    got = path("norm", lambda: [st.norm(w, a) for w in (mx, one, inf_, fro)])
    refs = _norm_refs(torch, a.double())
    _norm_gates(torch, st, "Matrix 16384^2 fp32", got, refs)
    cn = path("col_norms", lambda: st.col_norms(mx, a))
    if not torch.equal(cn, a.abs().amax(dim=0)):
        fail("col_norms differs from max|a| by column")
    m8 = TILE_N64
    s8 = a[:m8, :m8].contiguous()
    for label, obj, kind in (
            ("SymmetricMatrix Lower", st.SymmetricMatrix(
                s8, uplo=st.Uplo.Lower), "Symmetric"),
            ("TriangularMatrix Lower Unit", st.TriangularMatrix(
                s8, uplo=st.Uplo.Lower, diag=st.Diag.Unit), "Triangular"),
            ("HermitianBandMatrix Lower kd=256", st.HermitianBandMatrix(
                s8, kd=256, uplo=st.Uplo.Lower), "HermitianBand")):
        got = [st.norm(w, obj) for w in (mx, one, inf_, fro)]
        _norm_gates(torch, st, label + " 8192^2",
                    got, _norm_refs(torch, _masked_ref(torch, s8.double(),
                                                       kind, 256)))

    # ---- the tile kernels tied to the driver functions -----------------
    b = torch.randn((n, n), generator=gen, device=dev)
    r = torch.randn(n, generator=gen, device=dev)
    c = torch.randn(n, generator=gen, device=dev)
    A, B = st.Matrix.from_array(a), st.Matrix.from_array(b)
    L = st.TriangularMatrix(a, uplo=st.Uplo.Lower)
    lower = torch.ones((n, n), dtype=torch.bool, device=dev).tril_()
    drv = {"max": st.norm(mx, A), "fro": st.norm(fro, A),
           "add": st.add(1.5, A, -0.3, B).array,
           "scale_row_col": st.scale_row_col(r, c, A).array,
           "set": st.set(-0.75, 2.5, L).array,
           "scale": st.scale(-0.75, 1.0, L).array}
    torch.cuda.synchronize()
    if any(launches[p][k] for p in ("norm", "col_norms")
           for k in TILE_KERNELS):
        fail("a driver path launched a tile kernel: %s"
             % {p: launches[p] for p in ("norm", "col_norms")})

    def ties():
        tiles = _tiles(a, TILE_T)
        return {"max": kernels.tile_norms(tiles, "max").max(),
                "fro": kernels.tile_norms(tiles, "fro").double().sum().sqrt(),
                "add": kernels.geadd(1.5, a, -0.3, b),
                "scale_row_col": kernels.gescale_row_col(r, c, a),
                "set": kernels.tzset(a, True, -0.75, 2.5),
                "scale": kernels.tzscale(a, True, -0.75, -0.75)}
    ker = path("tile_ties", ties)
    fro_rel = abs(float(ker["fro"]) - float(drv["fro"])) / float(drv["fro"])
    checks = {"norm(Max) = max of tile_norms(max)":
              float(ker["max"]) == float(drv["max"]),
              "norm(Fro) = sqrt(sum tile_norms(fro)) within 1e-5":
              fro_rel <= 1e-5,
              "util.add = kernels.geadd": torch.equal(ker["add"], drv["add"]),
              "util.scale_row_col = kernels.gescale_row_col":
              torch.equal(ker["scale_row_col"], drv["scale_row_col"]),
              "util.set(Lower) = kernels.tzset on the lower triangle":
              torch.equal(ker["set"][lower], drv["set"][lower]),
              "util.scale(Lower) = kernels.tzscale on the lower triangle":
              torch.equal(ker["scale"][lower], drv["scale"][lower])}
    print("kernel ties (16384^2 fp32): %s; fro rel %.3e; launches %s"
          % (checks, fro_rel, {k: v for k, v in launches["tile_ties"].items()
                               if v}), flush=True)
    if not all(checks.values()):
        fail("a tile kernel departs from its driver function: %s" % checks)
    res["kernel_ties"] = checks
    del b, B, L, lower, drv, ker, s8
    torch.cuda.empty_cache()

    # ---- condition estimates (tester.py's inputs and gates) -------------
    m = MIXED_N
    for dt in (torch.float32, torch.float64):
        tag = str(dt).split(".")[-1]
        g = torch.randn((m, m), generator=gen, device=dev, dtype=dt) \
            + m * torch.eye(m, device=dev, dtype=dt)
        lu, perm = st.getrf(g)
        anorm = float(st.norm(one, g))
        rc = path("gecondest_" + tag, lambda: st.gecondest(one, lu, perm,
                                                         anorm))
        true_rc = 1.0 / (anorm * float(torch.linalg.matrix_norm(
            torch.linalg.inv(g.double()), 1)))
        print("gecondest %s n=%d: rcond %.6g, true %.6g (gate 0 < rcond <= "
              "30 true); %.1f ms" % (dt, m, rc, true_rc,
                                     walls["gecondest_" + tag]),
              flush=True)
        if not 0 < rc <= 30 * true_rc:
            fail("gecondest %s: rcond %.3g against true %.3g" % (dt, rc,
                                                                 true_rc))
        res["gecondest_" + tag] = (rc, true_rc)
        del g, lu, perm
    h = torch.randn((m, m), generator=gen, device=dev)
    h = (h + h.T) / 2 + m * torch.eye(m, device=dev)          # herm(n)
    fac = st.potrf(st.HermitianMatrix(h, uplo=st.Uplo.Lower, nb=NB))
    anorm = float(st.norm(one, h))
    rc = path("pocondest", lambda: st.pocondest(one, fac, anorm))
    true_rc = 1.0 / (anorm * float(torch.linalg.matrix_norm(
        torch.linalg.inv(h.double()), 1)))
    tr = torch.tril(torch.randn((m, m), generator=gen, device=dev)) \
        + 2 * m * torch.eye(m, device=dev)
    trc = path("trcondest", lambda: st.trcondest(one, tr, st.Uplo.Lower,
                                                 st.Diag.NonUnit))
    print("pocondest n=%d: rcond %.6g, true %.6g (gate 0 < rcond <= 30 "
          "true); trcondest: rcond %.6g (gate > 0)" % (m, rc, true_rc, trc),
          flush=True)
    if not (0 < rc <= 30 * true_rc and trc > 0):
        fail("pocondest %.3g (true %.3g) or trcondest %.3g" % (rc, true_rc,
                                                                trc))
    del h, fac, tr

    # ---- the mixed-precision solvers at n = 8192, fp64 ------------------
    f64 = torch.float64
    h = torch.randn((m, m), generator=gen, device=dev, dtype=f64)
    h = (h + h.T) / 2 + m * torch.eye(m, device=dev, dtype=f64)
    g = torch.randn((m, m), generator=gen, device=dev, dtype=f64) \
        + m * torch.eye(m, device=dev, dtype=f64)
    rhs = torch.randn((m, NRHS), generator=gen, device=dev, dtype=f64)
    H = st.HermitianMatrix(h, uplo=st.Uplo.Lower, nb=NB)
    G = st.Matrix.from_array(g, nb=NB)
    anorm_g = float(st.norm(inf_, g))

    def chol32():
        return blocks.potrf_rec(h.float(), NB, nan_on_fail=True)

    def lu32():
        return tlu.getrf_rec(g.float(), NB)
    legs = {
        "posv_mixed": (lambda: tchol._posv_mixed_setup(H, rhs, None, None),
                       chol32, chol32),
        "gesv_mixed": (lambda: tlu._getrf_lo(g, torch.float32, NB, anorm_g),
                       lu32, lu32)}
    split = {}
    for name, (leg, direct, stock) in legs.items():
        split[name] = _leg_launches(torch, kernels, name, leg, direct, stock)
        # the split leg is the card's default; on these inputs it stays
        if split[name]["demoted"]:
            fail("%s: the split leg was demoted (kappa*n*eps32 %.4g)"
                 % (name, split[name]["kappa_eps"]))
    for name, a_, ref_fn in (
            ("posv_mixed", H, lambda: torch.cholesky_solve(
                rhs, torch.linalg.cholesky(h))),
            ("gesv_mixed", G, lambda: torch.linalg.solve(g, rhs))):
        def drive():
            return getattr(st, name)(a_, rhs)
        x, iters = path(name, drive)
        dense = h if name == "posv_mixed" else g
        rres = _scaled_resid(torch, dense, x, rhs)
        lib_ms = _wall_ms(torch, ref_fn, 3)
        brk = _mixed_breakdown(torch, name, drive, legs[name][0],
                               legs[name][1])
        print("%s n=%d fp64, %d rhs, split leg: %d iterations, residual %.3g "
              "(gate 3, eps64), %.1f ms first call, %.1f ms median of 3 "
              "(stock fp32 leg %.1f ms median of 3); launches %s; %s fp64 "
              "%.1f ms"
              % (name, m, NRHS, iters, rres, walls[name],
                 brk["split"]["wall_ms"], brk["stock"]["wall_ms"],
                 {k: v for k, v in launches[name].items() if v},
                 "cholesky + cholesky_solve" if name == "posv_mixed"
                 else "torch.linalg.solve", lib_ms), flush=True)
        if not (iters >= 0 and rres <= 3):
            fail("%s: iters %d, residual %.3f" % (name, iters, rres))
        res[name] = dict(iters=iters, residual=rres, ms=walls[name],
                         median_ms=brk["split"]["wall_ms"],
                         stock_leg_ms=brk["stock"]["wall_ms"],
                         library_ms=lib_ms, breakdown=brk,
                         kappa_eps=split[name]["kappa_eps"],
                         demoted=split[name]["demoted"])
    for name, a_, dense in (("posv_mixed_gmres", H, h),
                            ("gesv_mixed_gmres", G, g)):
        b4 = rhs[:, :GMRES_NRHS].contiguous()
        x, iters = path(name, lambda: getattr(st, name)(a_, b4))
        rres = _scaled_resid(torch, dense, x, b4)
        med_ms = _wall_ms(torch, lambda: getattr(st, name)(a_, b4), 3)
        stock_ms = _stock_leg_ms(torch, lambda: getattr(st, name)(a_, b4))
        print("%s n=%d fp64, %d rhs, split leg: %d iterations, residual %.3g,"
              " %.1f ms first call, %.1f ms median of 3 (stock fp32 leg %.1f "
              "ms median of 3)"
              % (name, m, GMRES_NRHS, iters, rres, walls[name], med_ms,
                 stock_ms), flush=True)
        if not (iters >= 0 and rres <= 3):
            fail("%s: iters %d, residual %.3f" % (name, iters, rres))
        res[name] = dict(iters=iters, residual=rres, ms=walls[name],
                         median_ms=med_ms, stock_leg_ms=stock_ms)
    del h, g, rhs, H, G
    torch.cuda.empty_cache()

    # gels_mixed on bench.py's (32768, 4096) Gaussian, cast to fp64
    import numpy as np
    rng = np.random.default_rng(4)
    aq = torch.from_numpy(rng.standard_normal((QR_M, QR_N)).astype(
        np.float32)).to(dev).double()
    bq = torch.from_numpy(rng.standard_normal(QR_M).astype(np.float32)).to(
        dev).double()
    def qr32():
        return tqr.geqrf_rec(aq.float(), NB)
    # the semi-normal equations' probe is κ₁(R)²·n·ε₃₂: it is reported,
    # and a demotion (with its stock refactor) accounted for, not gated
    leg = _leg_launches(torch, kernels, "gels_mixed",
                        lambda: tqr._gels_lo_factor(aq, torch.float32, NB),
                        qr32, qr32)
    Aq = st.Matrix.from_array(aq, nb=NB)
    x, iters = path("gels_mixed", lambda: st.gels_mixed(Aq, bq))
    eps64 = float(torch.finfo(f64).eps)
    ne = float((aq.T @ (aq @ x - bq)).norm()
               / (aq.norm() ** 2 * x.norm() * eps64 * QR_M ** 0.5))
    med_ms = _wall_ms(torch, lambda: st.gels_mixed(Aq, bq), 3)
    stock_ms = _stock_leg_ms(torch, lambda: st.gels_mixed(Aq, bq))
    print("gels_mixed (%d, %d) fp64, split leg: %d iterations, "
          "normal-equations residual %.3g (gate 3, eps64), %.1f ms first "
          "call, %.1f ms median of 3 (stock fp32 leg %.1f ms median of 3); "
          "kappa^2*n*eps32 %.4g, demoted %s; low leg launches %s"
          % (QR_M, QR_N, iters, ne, walls["gels_mixed"], med_ms, stock_ms,
             leg["kappa_eps"], leg["demoted"],
             {k: v for k, v in leg["launches"].items() if v}), flush=True)
    if not (iters >= 0 and ne <= 3 and tuple(x.shape) == (QR_N,)):
        fail("gels_mixed: iters %d, residual %.3f" % (iters, ne))
    res["gels_mixed"] = dict(iters=iters, residual=ne, ms=walls["gels_mixed"],
                             median_ms=med_ms, stock_leg_ms=stock_ms,
                             kappa_eps=leg["kappa_eps"],
                             demoted=leg["demoted"])
    del Aq
    del aq, bq
    torch.cuda.empty_cache()

    # the fallback: condition 1e10, not positive definite in fp32
    spd = random_spd(FALLBACK_N, cond=1e10, dtype=f64, seed=92, device=dev)
    bf = torch.randn((FALLBACK_N, 4), generator=gen, device=dev, dtype=f64)
    for name, a_ in (("posv_mixed", st.HermitianMatrix(spd,
                                                       uplo=st.Uplo.Lower,
                                                       nb=NB)),
                     ("gesv_mixed", st.Matrix.from_array(spd, nb=NB))):
        x, iters = getattr(st, name)(a_, bf)
        rres = _scaled_resid(torch, spd, x, bf)
        print("%s fallback (random_spd n=%d cond 1e10): iters %d, residual "
              "%.3g" % (name, FALLBACK_N, iters, rres), flush=True)
        if not (iters < 0 and rres <= 3):
            fail("%s fallback: iters %d, residual %.3f" % (name, iters, rres))
        res[name + "_fallback"] = dict(iters=iters, residual=rres)
    del spd, bf

    # ---- band solvers at n = 8192, fp32 ---------------------------------
    kd = BAND_KD
    pb = _band(torch, gen, m, kd, kd, dev, spd=True)
    gb = _band(torch, gen, m, kd, kd, dev, spd=False)
    rb = torch.randn((m, NRHS), generator=gen, device=dev)
    f, x = path("pbsv", lambda: st.pbsv(st.HermitianBandMatrix(
        pb, kd=kd, uplo=st.Uplo.Lower, nb=NB), rb))
    pres = _scaled_resid(torch, pb, x, rb)
    f, piv, x = path("gbsv", lambda: st.gbsv(st.BandMatrix(
        gb, kl=kd, ku=kd, nb=NB), rb))
    gres = _scaled_resid(torch, gb, x, rb)
    print("band n=%d fp32, %d rhs: pbsv (kd %d) %.1f ms residual %.3g, "
          "launches %s; gbsv (kl = ku = %d) %.1f ms residual %.3g, launches %s"
          % (m, NRHS, kd, walls["pbsv"], pres,
             {k: v for k, v in launches["pbsv"].items() if v}, kd,
             walls["gbsv"], gres,
             {k: v for k, v in launches["gbsv"].items() if v}), flush=True)
    if not (pres <= 3 and gres <= 3):
        fail("band residuals %.3f (pbsv), %.3f (gbsv)" % (pres, gres))
    res.update(pbsv_residual=pres, gbsv_residual=gres)
    driver_tile = {p: {k: launches[p][k] for k in TILE_KERNELS
                       if launches[p][k]}
                   for p in launches if p != "tile_ties"}
    if any(driver_tile.values()):
        fail("a driver path launched a tile kernel: %s" % driver_tile)
    print("phase 3l walls (ms): %s" % {k: round(v, 1) for k, v in
                                       walls.items()}, flush=True)
    del pb, gb, rb, f, x, a
    torch.cuda.empty_cache()
    res.update(launches=launches, walls=walls)
    return res


def _split_envelope(grade: str, k: int) -> float:
    """The JAX tests' componentwise envelope of a split product, in units
    of |A||B| (``tests/test_split_gemm.py:44-49``)."""
    eps = 2.0 ** -23
    return 4 * ((2 ** 7 + 3 * k) if grade == "split3" else 3 * k) * eps


#: split6 keeps every bit of the fp32 operands: its error to the fp64
#: product stays within 8 eps32 of |A||B|, which split3's dropped pairs
#: pass at phase 2k's k (~16 eps32 on the card), so the gate tells the two
#: grades apart where the envelope (~6000 eps32) cannot
SPLIT6_TIGHT = 8 * 2.0 ** -23


def _split_accumulation(k: int) -> float:
    """|kernel - plain| of a split product in units of |A||B|: both sum the
    same exact bf16 slice products in fp32, in different orders."""
    return 4 * k ** 0.5 * 2.0 ** -23


def check_split_kernels(torch, kernels, dev) -> dict:
    """Phase 2k: ``split_matmul`` and ``ozaki_matmul`` alone, each shape
    gated and timed (CUDA events) beside its bound, its plain version and
    a library call.  ``split_matmul``: componentwise within the envelope
    to the fp64 product at split3 and split6, the plain version too.
    ``ozaki_matmul``: bitwise its plain version on the same planes (at the
    chunked shape the whole ``ozaki.matmul_f64`` with the kernel, bitwise
    the same with the plain version), within 1e-12 of |A||B| of the fp64
    product."""
    from slate_tpu_torch.ops import ozaki, split_gemm

    gen = torch.Generator(device=dev).manual_seed(101)
    rows = {}

    # ---- split_matmul -------------------------------------------------
    res = {}
    for m, k, n in SPLIT_SHAPES:
        main = (m, k, n) == SPLIT_SHAPES[0]
        a = torch.randn((m, k), generator=gen, device=dev)
        if main:      # the leg's strip: Bᵀ a view of the panel's rows
            b = torch.randn((n, k), generator=gen, device=dev).mT
        else:
            b = torch.randn((k, n), generator=gen, device=dev)
        sa, sb = split_gemm.split_slices(a), split_gemm.split_slices(b)
        exact = a.double() @ b.double()
        mag = a.double().abs() @ b.double().abs()
        tag = "(%d,%d)x(%d,%d)%s" % (m, k, k, n,
                                      " B transposed view" if main else "")
        for grade in ("split3", "split6"):
            got = kernels.split_matmul(sa, sb, grade)
            ref = kernels.split_matmul_plain(sa, sb, grade)
            torch.cuda.synchronize()
            env = _split_envelope(grade, k)
            err = float(((got.double() - exact).abs() / mag).max())
            perr = float(((ref.double() - exact).abs() / mag).max())
            max_abs = float((got - ref).abs().max())
            kp_err = float(((got.double() - ref.double()).abs() / mag).max())
            acc = _split_accumulation(k)
            staging = kernels.split_matmul_staging(sa, sb, grade)
            planes, passes = (2, 3) if grade == "split3" else (3, 6)
            b_ms, b_by = bound(passes * 2.0 * m * n * k,
                               2.0 * planes * (m * k + k * n) + 4.0 * m * n,
                               PEAK_BF16_FLOPS)
            r = dict(shape=tag, grade=grade, staging=staging,
                     max_abs_err=max_abs, err_in_abab=err,
                     plain_err_in_abab=perr, envelope=env,
                     kernel_plain_in_abab=kp_err, accumulation_gate=acc,
                     split6_gate=SPLIT6_TIGHT,
                     ms=cuda_ms(torch, lambda: kernels.split_matmul(
                         sa, sb, grade), 10 if main else 20),
                     plain_ms=cuda_ms(torch, lambda: kernels.split_matmul_plain(
                         sa, sb, grade), 3),
                     library_ms=cuda_ms(torch, lambda: torch.matmul(a, b), 10),
                     bound_ms=b_ms, bound_by=b_by)
            if main:
                r["matmul_3xtf32_ms"] = cuda_ms(
                    torch, lambda: kernels.matmul(a, b), 10)
            print("kernel split_matmul %s %s (%s): max|C - AB|/(|A||B|) %.3e, "
                  "plain %.3e (envelope %.3e; %s %.3e); max|kernel - plain|/"
                  "(|A||B|) %.3e (gate 4 sqrt(k) eps32 = %.3e), max abs "
                  "%.3e; kernel %.4f ms, plain %.4f ms, torch.matmul fp32 "
                  "%.4f ms%s, bound %.4f ms (%s)"
                  % (grade, tag, staging, err, perr, env,
                     "split6 gate" if grade == "split6"
                     else "must exceed the split6 gate", SPLIT6_TIGHT,
                     kp_err, acc, max_abs, r["ms"],
                     r["plain_ms"], r["library_ms"],
                     ", 3xTF32 matmul %.4f ms" % r["matmul_3xtf32_ms"]
                     if main else "", b_ms, b_by), flush=True)
            if not (err <= env and perr <= env
                    and bool(torch.isfinite(got).all())):
                fail("split_matmul %s %s: error %.3e (plain %.3e) past the "
                     "envelope %.3e" % (grade, tag, err, perr, env))
            if not kp_err <= acc:
                fail("split_matmul %s %s: |kernel - plain| %.3e of |A||B| "
                     "past 4 sqrt(k) eps32 = %.3e" % (grade, tag, kp_err,
                                                       acc))
            # split6 within the tight gate, split3 outside it: a split6
            # kernel that returned the split3 sum (or lost its d2) fails
            if grade == "split6" and not (err <= SPLIT6_TIGHT
                                          and perr <= SPLIT6_TIGHT):
                fail("split_matmul split6 %s: error %.3e (plain %.3e) past "
                     "8 eps32" % (tag, err, perr))
            if grade == "split3" and not err > SPLIT6_TIGHT:
                fail("split_matmul split3 %s: error %.3e inside the split6 "
                     "gate %.3e, which then cannot tell the grades apart"
                     % (tag, err, SPLIT6_TIGHT))
            res["%s %s" % (grade, tag)] = r
        del a, b, sa, sb, exact, mag
    main_row = res["split3 " + "(%d,%d)x(%d,%d) B transposed view"
                   % (SPLIT_SHAPES[0][0], SPLIT_SHAPES[0][1],
                      SPLIT_SHAPES[0][1], SPLIT_SHAPES[0][2])]
    rows["split_matmul"] = dict(
        main_row, library="torch.matmul fp32 (TF32 off)",
        tol="componentwise |C - AB| <= 4(2^7 + 3k) eps32 |A||B| (split3), "
        "4*3k eps32 |A||B| and 8 eps32 |A||B| (split6) against the fp64 "
        "product; |kernel - plain| <= 4 sqrt(k) eps32 |A||B|",
        shapes=res)

    # ---- ozaki_matmul ---------------------------------------------------
    res = {}
    f64 = torch.float64
    for m, k, n in OZAKI_SHAPES:
        a = torch.randn((m, k), generator=gen, device=dev, dtype=f64)
        b = torch.randn((k, n), generator=gen, device=dev, dtype=f64)
        tag = "(%d,%d)x(%d,%d)" % (m, k, k, n)
        exact = a @ b
        mag = a.abs() @ b.abs()
        if k <= ozaki._KMAX:
            ea = ozaki._pow2_scale(a.abs().amax(dim=1))
            eb = ozaki._pow2_scale(b.abs().amax(dim=0))
            kp = -(-k // ozaki.KPAD) * ozaki.KPAD
            ua = ozaki._planes(ozaki._split_int8(
                ozaki._mul_pow2(a, -ea[:, None])), kp)
            vb = ozaki._planes(ozaki._split_int8(
                ozaki._mul_pow2(b, -eb[None, :]).T), kp)
            got = kernels.ozaki_matmul(ua, vb, ea, eb)
            ref = kernels.ozaki_matmul_plain(ua, vb, ea, eb)

            def kern():
                return kernels.ozaki_matmul(ua, vb, ea, eb)

            def plain():
                return kernels.ozaki_matmul_plain(ua, vb, ea, eb)
            nbytes = ozaki._NSL * (m + n) * kp + 8.0 * (m + n + m * n)
        else:
            # chunked: the whole product with the kernel, then with the
            # plain version in its place (the same planes, chunk by chunk)
            got = ozaki.matmul_f64(a, b)
            saved = kernels.ozaki_matmul
            kernels.ozaki_matmul = kernels.ozaki_matmul_plain
            try:
                ref = ozaki.matmul_f64(a, b)
            finally:
                kernels.ozaki_matmul = saved

            def kern():
                return ozaki.matmul_f64(a, b)

            def plain():
                kernels.ozaki_matmul = kernels.ozaki_matmul_plain
                try:
                    return ozaki.matmul_f64(a, b)
                finally:
                    kernels.ozaki_matmul = saved
            nchunks = -(-k // ozaki._KMAX)
            nbytes = ozaki._NSL * (m + n) * k + 8.0 * nchunks * (
                m + n + 2 * m * n)
        torch.cuda.synchronize()
        same = bool(torch.equal(got, ref))
        err = float(((got - exact).abs() / mag.clamp_min(1e-300)).max())
        npairs = ozaki._NSL * (ozaki._NSL + 1) // 2
        b_ms, b_by = bound(npairs * 2.0 * m * n * k, nbytes, PEAK_INT8_OPS)
        r = dict(shape=tag, bitwise=same, max_abs_err=float(
                     (got - ref).abs().max()), err_in_abab=err,
                 ms=cuda_ms(torch, kern, 5), plain_ms=cuda_ms(torch, plain, 2),
                 library_ms=cuda_ms(torch, lambda: torch.matmul(a, b), 5),
                 matmul_f64_ms=cuda_ms(torch, lambda: ozaki.matmul_f64(a, b),
                                       3),
                 bound_ms=b_ms, bound_by=b_by)
        print("kernel ozaki_matmul %s: bitwise its plain version %s, "
              "max|C - AB|/(|A||B|) %.3e (gate 1e-12); kernel %.4f ms, plain "
              "%.4f ms, torch.matmul fp64 (DGEMM) %.4f ms, matmul_f64 with the "
              "split %.4f ms, bound %.4f ms (%s)"
              % (tag, same, err, r["ms"], r["plain_ms"], r["library_ms"],
                 r["matmul_f64_ms"], b_ms, b_by), flush=True)
        if not (same and err < 1e-12):
            fail("ozaki_matmul %s: bitwise %s, error %.3e" % (tag, same, err))
        res[tag] = r
        del a, b, exact, mag, got, ref
    nine = _ozaki_nine_slices(torch, kernels, ozaki, gen, dev)
    torch.cuda.empty_cache()
    main_row = res["(%d,%d)x(%d,%d)" % (OZAKI_SHAPES[0][0], OZAKI_SHAPES[0][1],
                                        OZAKI_SHAPES[0][1],
                                        OZAKI_SHAPES[0][2])]
    rows["ozaki_matmul"] = dict(
        main_row, library="torch.matmul fp64 (cuBLAS DGEMM)",
        tol="bitwise the plain version; componentwise 1e-12 of |A||B| to "
        "the fp64 product", shapes=res, slices=ozaki._NSL,
        nine_slices=nine)
    return rows


def _ozaki_nine_slices(torch, kernels, ozaki, gen, dev) -> dict:
    """``ozaki_matmul`` at nsl = 9 (``SLATE_TPU_TORCH_F64_SLICES=9``: 45
    pairs, the full 53-bit split) on (512, 512)·(512, 512): bitwise its
    plain version on the same nine planes, within 1e-14 of |A||B| of the
    fp64 product (the default eight slices give ~1e-13)."""
    m = k = n = 512
    f64 = torch.float64
    a = torch.randn((m, k), generator=gen, device=dev, dtype=f64)
    b = torch.randn((k, n), generator=gen, device=dev, dtype=f64)
    ea = ozaki._pow2_scale(a.abs().amax(dim=1))
    eb = ozaki._pow2_scale(b.abs().amax(dim=0))
    ua = ozaki._planes(ozaki._split_int8(ozaki._mul_pow2(a, -ea[:, None]), 9),
                       k)
    vb = ozaki._planes(ozaki._split_int8(
        ozaki._mul_pow2(b, -eb[None, :]).T, 9), k)
    got = kernels.ozaki_matmul(ua, vb, ea, eb)
    ref = kernels.ozaki_matmul_plain(ua, vb, ea, eb)
    torch.cuda.synchronize()
    same = bool(torch.equal(got, ref))
    err = float(((got - a @ b).abs() / (a.abs() @ b.abs())).max())
    ms = cuda_ms(torch, lambda: kernels.ozaki_matmul(ua, vb, ea, eb), 5)
    print("kernel ozaki_matmul nsl=9 (%d,%d)x(%d,%d): bitwise its plain "
          "version %s, max|C - AB|/(|A||B|) %.3e (gate 1e-14); kernel %.4f ms"
          % (m, k, k, n, same, err, ms), flush=True)
    if not (same and err < 1e-14):
        fail("ozaki_matmul nsl=9: bitwise %s, error %.3e" % (same, err))
    return dict(shape="(%d,%d)x(%d,%d)" % (m, k, k, n), bitwise=same,
                err_in_abab=err, ms=ms)


def _tester_gemm_residual(torch, prod, a, b, eps: float) -> float:
    """tester.py's gemm check with β = 0: ‖C − A·B‖/(‖A‖·‖B‖·ε·n) in
    fp64 (here the fp64 reference is DGEMM's)."""
    ref = a @ b
    return float((prod - ref).norm() / (a.norm() * b.norm() * eps
                                        * a.shape[0]))


def main_path_fp64(torch, st, kernels, dev) -> dict:
    """Phase 3m: the fp64 main path at full size.  ``gemm`` fp64 at
    n = 2048 under ``f64_mxu`` (the ``ozaki_matmul`` kernel, no ``matmul``
    launch), and ``posv`` fp64 at n = 8192, nb = 512, 128 right-hand sides
    three ways: stock (cuSOLVER), the Newton panels pinned with DGEMM
    products, and the Newton panels over ``ozaki_matmul``
    (``f64_mxu``); each way's residual ≤ 3, the pinned ways 16
    ``chol_inv_panel`` launches and no stock rerun, walls a median of 3,
    and a device split of each pinned way."""
    import os

    from slate_tpu_torch import config
    from slate_tpu_torch.perf import metrics

    f64 = torch.float64
    eps = float(torch.finfo(f64).eps)
    gen = torch.Generator(device=dev).manual_seed(111)
    res, launches = {}, {}
    saved_mxu = config.f64_mxu

    # ---- gemm fp64 (BASELINE.md config 1) ------------------------------
    n = GEMM64_N
    a = torch.randn((n, n), generator=gen, device=dev, dtype=f64)
    b = torch.randn((n, n), generator=gen, device=dev, dtype=f64)
    c = torch.zeros((n, n), device=dev, dtype=f64)
    A, B = st.Matrix.from_array(a, nb=NB), st.Matrix.from_array(b, nb=NB)
    config.f64_mxu = True
    try:
        st.gemm(1.0, A, B, 0.0, c)            # warm
        torch.cuda.synchronize()
        prod, ms, launches["gemm_fp64"] = run_path(
            torch, kernels, "gemm_fp64", lambda: st.gemm(1.0, A, B, 0.0, c))
        walls = sorted(once_ms(torch, lambda: st.gemm(1.0, A, B, 0.0, c))[0]
                       for _ in range(POSV64_REPS))
    finally:
        config.f64_mxu = saved_mxu
    pd = prod.array if hasattr(prod, "array") else prod
    gres = _tester_gemm_residual(torch, pd, a, b, eps)
    lib = sorted(once_ms(torch, lambda: torch.matmul(a, b))[0]
                 for _ in range(POSV64_REPS))
    print("gemm fp64 n=%d under f64_mxu: residual %.3g (gate 3, eps64), %.3f "
          "ms (median of %d, CUDA events; first call's wall %.1f ms), "
          "torch.matmul fp64 %.3f ms; launches %s"
          % (n, gres, walls[len(walls) // 2], POSV64_REPS, ms,
             lib[len(lib) // 2],
             {k: v for k, v in launches["gemm_fp64"].items() if v}),
          flush=True)
    if not (gres <= 3 and launches["gemm_fp64"]["matmul"] == 0):
        fail("gemm fp64: residual %.3f, matmul launches %d"
             % (gres, launches["gemm_fp64"]["matmul"]))
    res["gemm_fp64"] = dict(residual=gres, ms=walls[len(walls) // 2],
                            library_ms=lib[len(lib) // 2])
    del a, b, c, A, B, prod, pd

    # ---- posv fp64 three ways (BASELINE.md config 2) ---------------------
    n, nb = POSV64_N, POSV64_NB
    r = torch.randn((n, n), generator=gen, device=dev, dtype=f64)
    h = (r + r.T) / 2 + n * torch.eye(n, device=dev, dtype=f64)
    rhs = torch.randn((n, NRHS), generator=gen, device=dev, dtype=f64)
    del r
    H = st.HermitianMatrix(h, uplo=st.Uplo.Lower, nb=nb)
    ways = {"stock": ({}, False),
            "newton_dgemm": ({FORCE: "potrf_panel_f64=ozaki_newton"}, False),
            "newton_ozaki": ({}, True)}
    was_on = metrics.enabled()
    metrics.on()
    for way, (env, mxu) in ways.items():
        saved_env = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        config.f64_mxu = True if mxu else saved_mxu
        try:
            st.posv(H, rhs)                       # warm
            torch.cuda.synchronize()
            before = metrics.snapshot()
            path = "posv_fp64_" + way
            (fac, x), ms, launches[path] = run_path(
                torch, kernels, path, lambda: st.posv(H, rhs))
            rerun = metrics.snapshot_delta(before, metrics.snapshot())[
                "counters"].get("potrf.f64_rerun", 0)
            walls = sorted(once_ms(torch, lambda: st.posv(H, rhs))[0]
                           for _ in range(POSV64_REPS))
            split = {} if way == "stock" else device_split(
                torch, "posv fp64 " + way, lambda: st.posv(H, rhs),
                {"chol_inv_panel kernel": "chol_inv_panel_kernel",
                 "ozaki_matmul kernel": "ozaki_matmul_kernel"})
        finally:
            config.f64_mxu = saved_mxu
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        pres = _scaled_resid(torch, h, x, rhs)
        cip = launches[path]["chol_inv_panel"]
        print("posv fp64 n=%d nb=%d %d rhs, %s: residual %.3g (gate 3, eps64), "
              "%.1f ms (median of %d, CUDA events), chol_inv_panel %d, "
              "potrf.f64_rerun %d; launches %s"
              % (n, nb, NRHS, way, pres, walls[len(walls) // 2], POSV64_REPS,
                 cip, rerun,
                 {k: v for k, v in launches[path].items() if v}), flush=True)
        if not pres <= 3:
            fail("posv fp64 %s: residual %.3f" % (way, pres))
        if way != "stock" and not (cip == n // nb and rerun == 0):
            fail("posv fp64 %s: %d chol_inv_panel launches (want %d), %d "
                 "stock reruns" % (way, cip, n // nb, rerun))
        res["posv_fp64_" + way] = dict(residual=pres,
                                       ms=walls[len(walls) // 2],
                                       walls=walls, f64_rerun=rerun,
                                       device_split=split)
        del fac, x
    if not was_on:
        metrics.off()
    lib = sorted(once_ms(torch, lambda: torch.cholesky_solve(
        rhs, torch.linalg.cholesky(h)))[0] for _ in range(POSV64_REPS))
    print("posv fp64 n=%d walls (ms, median of %d): stock %.1f, Newton panels "
          "over DGEMM %.1f, Newton panels over ozaki_matmul %.1f; cholesky + "
          "cholesky_solve %.1f"
          % (n, POSV64_REPS, res["posv_fp64_stock"]["ms"],
             res["posv_fp64_newton_dgemm"]["ms"],
             res["posv_fp64_newton_ozaki"]["ms"], lib[len(lib) // 2]),
          flush=True)
    res["posv_fp64_library_ms"] = lib[len(lib) // 2]
    del h, rhs, H
    torch.cuda.empty_cache()
    res["launches"] = launches
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    try:
        import slate_tpu_torch as st
        from slate_tpu_torch.ops import _build, kernels
    except ImportError as e:
        print("chip_smoke: the slate_tpu_torch package is missing (%s)" % e,
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print("torch %s, CUDA %s, python %s" % (torch.__version__,
                                            torch.version.cuda,
                                            sys.version.split()[0]), flush=True)
    t0 = time.perf_counter()
    built = _build.build_all()
    print("build: %.1f s (%s)" % (time.perf_counter() - t0, ", ".join(
        "%s %.1f s" % kv for kv in built.items()) or "all cached"), flush=True)
    for name in _build.SOURCES:
        log = _build.lib_path(name).with_name(
            _build.lib_path(name).name + ".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print("ptxas %s: %s" % (name, line.strip()), flush=True)

    spent, stagings = {}, {}

    def phase(label, fn, *args):
        """``fn(*args)``, its host wall recorded under ``label``, and its
        matmul calls by the kernel's staging."""
        t = time.perf_counter()
        before = dict(kernels.matmul_stagings)
        out = fn(*args)
        spent[label] = time.perf_counter() - t
        stagings[label] = {k: v - before[k]
                           for k, v in kernels.matmul_stagings.items()}
        return out

    measured = phase("2", check_kernels, torch, kernels, dev)
    measured.update(phase("2b", check_lu_kernels, torch, kernels, dev))
    measured.update(phase("2c", check_batched_kernels, torch, kernels, dev))
    measured.update(phase("2d", check_fused_kernels, torch, kernels, dev))
    import numpy as np
    a_qr = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (QR_M, QR_N)).astype(np.float32)).to(dev)      # bench.py's geqrf input
    measured.update(phase("2e", check_lu_inv_kernel, torch, kernels, dev,
                          a_qr))

    def qr_once():                  # phase 2f: one geqrf + ungqr
        st.ungqr(*st.geqrf(st.Matrix.from_array(a_qr, nb=NB, device=dev)))
    path_checks = {"qr": phase("2f", check_path_calls, torch, kernels,
                               "QR path", qr_once, {
                                   k: CHECK_TOL[k] for k in (
                                       "matmul", "chol_inv_panel",
                                       "lu_inv_panel", "trtri_panel")})}
    paths = {"cholesky": phase("3", main_path, torch, st, kernels,
                               dev)["launches"]}
    paths.update(phase("3b", main_path_lu, torch, st, kernels, dev)["launches"])
    paths.update(phase("3c", main_path_batched, torch, st, kernels,
                       dev)["launches"])
    paths.update(phase("3d", serve_path, torch, kernels)["launches"])
    paths.update(phase("3e", main_path_depths, torch, st, kernels,
                       dev)["launches"])
    print("getrf_full_fused on the lu_full path: %d launch (grid %d, %d B "
          "dynamic shared memory a block)" % (
              paths["lu_full"]["getrf_full_fused"],
              measured["getrf_full_fused"]["grid"],
              measured["getrf_full_fused"]["smem_bytes"]), flush=True)
    paths.update(phase("3f", main_path_qr, torch, st, kernels, dev,
                       a_qr)["launches"])
    del a_qr
    paths.update(phase("3g", guard_path, torch, st, kernels, dev)["launches"])
    measured.update(phase("2g", check_chase_kernel, torch, kernels, dev))
    heev = phase("3h", main_path_heev, torch, st, kernels, dev)
    paths.update(heev["launches"])
    path_checks.update(heev["path_checks"])
    measured.update(phase("2h", check_tb2bd_kernel, torch, kernels, dev))
    svd = phase("3i", main_path_svd, torch, st, kernels, dev)
    paths.update(svd["launches"])
    path_checks.update(svd["path_checks"])
    measured.update(phase("2i", check_dist_kernels, torch, kernels, dev))
    dist1 = phase("3j", main_path_dist, torch, st, kernels, dev)
    paths.update(dist1["launches"])
    path_checks.update(dist1["path_checks"])
    shared = phase("3k", main_path_dist_shared, torch)
    # the four ranks' checked calls as one record per kernel
    path_checks["dist_2x2"] = {k: {
        "calls": sum(c[k]["calls"] for c in shared["checks"]),
        "layouts": sum(c[k]["layouts"] for c in shared["checks"]),
        "max_rel_err": max(c[k]["max_rel_err"] for c in shared["checks"]),
        "max_abs_err": max(c[k]["max_abs_err"] for c in shared["checks"])}
        for k in shared["checks"][0]}
    measured.update(phase("2j", check_tile_kernels, torch, kernels, dev))
    measured.update(phase("2k", check_split_kernels, torch, kernels, dev))
    paths.update(phase("3l", main_path_aux, torch, st, kernels,
                       dev)["launches"])
    paths.update(phase("3m", main_path_fp64, torch, st, kernels,
                       dev)["launches"])
    print("phase walls (s): %s; total %.1f s since the build began"
          % (", ".join("%s %.1f" % kv for kv in spent.items()),
             time.perf_counter() - t0), flush=True)
    print("matmul calls by staging (cp.async/registers; 3k's ranks are "
          "other processes): %s" % ", ".join(
              "%s %d/%d" % (label, c["async"], c["registers"])
              for label, c in stagings.items()), flush=True)

    rows = []
    for name, r in measured.items():
        src, replaces = REPO[name]
        # launches on the main paths that run this kernel (matmul: all)
        n_launch = sum(paths[p][name] for p, ks in PATHS.items() if name in ks)
        if name in TILE_KERNELS:      # gated 0 on every driver path (3l)
            r["driver_path_launches"] = 0
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": n_launch,
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
        for extra in ("plain_shape", "kernel_ms_at_plain_shape",
                      "barriers_ms", "fp64", "max_abs_err_fp64",
                      "ring_shape", "ring_ms", "ring_plain_ms",
                      "ring_library_ms", "ring_bound_ms",
                      "nb256_ms", "nb256_plain_ms", "nb256_library_ms",
                      "nb256_bound_ms", "nb512_ms", "nb512_plain_ms",
                      "nb512_library_ms", "nb512_bound_ms",
                      "nb512_max_abs_err", "grid", "smem_bytes",
                      "w4096_ms", "w4096_plain_ms",
                      "w4096_library_ms", "w4096_bound_ms",
                      "library", "fp64_8192_ms", "fro_ms",
                      "max_abs_err_fro", "driver_path_launches",
                      "bound_fp32_ffma_ms", "fp64_errors", "qr_one_wave",
                      "cube_ms", "cube_library_ms", "cube_bound_ms",
                      "cube_bound_fp32_ffma_ms", "l_bitwise_chol_inv_panel",
                      "cluster", "second_route", "chase_route",
                      "b16_ms", "b16_library_ms", "b16_bound_ms",
                      "batched_route", "shapes", "staging", "grade",
                      "err_in_abab", "plain_err_in_abab", "envelope",
                      "matmul_3xtf32_ms", "bitwise", "matmul_f64_ms",
                      "slices"):
            if extra in r:
                rows[-1][extra] = r[extra]
        for p, calls in path_checks.items():    # every call of one run
            if name in calls:
                rows[-1][p + "_path_check"] = {
                    k: calls[name][k] for k in ("calls", "layouts",
                                                "max_rel_err", "max_abs_err")}
    print(card, flush=True)        # again, beside the numbers below
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
