#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (daqp_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``daqp_tpu_torch/ops/csrc`` (one
nvcc per source, in parallel, into ``build/daqp_tpu_torch``), holds each
kernel against its plain PyTorch twin at the main paths' shapes, and
drives the port's paths once each, every launch count set to 0 just
before and read just after:

* ``slice``: BASELINE config 2 (B = 10240 dense strictly convex QPs,
  n = 50, m = 100 two-sided rows, ~40 active, kappa 1e2, generator seed
  2026, f32) through ``solve_batch_kernel_stream(chunk=256,
  sort_stream=True)``, checked against the constructed optimum (K1, K2);
* ``mpc``: BASELINE config 3 (512 scenarios, horizon 20, n = 50,
  m = 100, drift 0.02, seed 7; ``bench_extra.py:49-61``) through
  ``solve_mpc_scan_kernel_fused(seg=10)``, checked against the f64 NumPy
  oracle on 512 (scenario, step) pairs (K2, B3);
* ``prox``: BASELINE config 4 (B = 256 rank-30 semidefinite H, n = 50,
  m = 100, seed 11; ``bench_extra.py:101-113``) through
  ``solve_batch_prox_kernel``, checked by the f64 KKT certificate
  (K1 with its retries, K2, B4);
* ``soft``: config 2's data with general rows 0-19 of every lane SOFT
  through ``solve_batch_kernel_stream(has_soft=True, chunk=256,
  sort_stream=True)``, checked against the f64 NumPy oracle on 512 lanes
  (K1, B7);
* ``hiqp``: BASELINE config 4b (B = 256 hierarchical least-squares
  problems, n = 12, levels at (0, 8, 16, 24), seed 19;
  ``bench_extra.py:144-168``) through ``solve_batch_hiqp_kernel``,
  checked against the f64 hierarchical oracle on every lane (B7);
* ``sw``: config 2's data with rows 0-19 SOFT and SOFT_WEIGHTS slack
  bounds and per-side weights (seed 2027; even lanes mostly FREE slacks,
  odd lanes mostly FIXED) through ``solve_batch_kernel_stream(sw=...)``,
  checked against the lifted slack QP solved by the f64 NumPy oracle on
  256 lanes (K1, B7's SOFT_WEIGHTS variant);
* ``avi``: configAVI (``bench_extra.py:299-339``: B = 256 two-sided
  affine variational inequalities, n = 20, m = 50, seed 29) through
  ``solve_batch_avi_kernel``, checked against the constructed solutions
  (B5, K2);
* ``lp``: configLP (``bench_extra.py:245-296``: B = 256 LPs, n = 10,
  m = 50, seed 17, constructed vertex optimal) through
  ``solve_batch_lp_kernel`` on both paths, each its own count window:
  ``fused=False`` (K2) and ``fused=True`` (B6, and K2 for the retries),
  checked by ``bench_extra.py``'s objective-gap and feasibility gate
  against the JAX package's own census on the same lanes.

* ``backstop``: step 4 of the main path: config 2's first 256 lanes
  through the stream, every 12th lane then made loud and every 12th
  from the 6th silent, then ``backstop_resolve`` (the f64 re-solve of
  loud and KKT-failing lanes through the port's own ``quadprog``, on the
  card), checked against the constructed optimum; the 2-sw batch, then
  ``backstop_resolve(sw=...)`` of the sw phase's 256-lane sample and
  the first 24 loud lanes, the re-solved lanes checked against the
  lifted f64 QP; and ``deadline``: expired (every lane TIMELIMIT) and
  generous (the flags and host syncs of none) (K1, K2);
* ``single``: BASELINE config 1 (256 QPs of ``tests/gen.generate_test_qp
  (10, 30, 10, 8, 1e2)``, seed 2025) one at a time through
  ``dt.quadprog(device="cuda")`` in f64 and f32, then one ``Model`` per
  type (a host-driven loop over tensors on the card: no kernel);
* ``miqp``: BASELINE config 5 (B = 256 dense MIQPs, n = 20, m = 40, 6
  binary rows, seed 13, f32; ``bench_extra.py:196-216``) through
  ``solve_batch_miqp_kernel``: node waves of K2 with the per-lane
  dominance cut, after one K1 factorization, checked against the f64
  branch-and-bound oracle on every 4th lane and the JAX tier's optimal
  rate (K1, K2);
* ``meta``: the single-instance meta-solvers on the card (no kernel):
  16 configLP LPs through ``dt.linprog`` in f32 with the f64 backstop,
  8 configAVI AVIs through ``dt.avi``, 16 config-4b hierarchies through
  ``dt.quadprog(break_points=...)`` and 16 config-5 MIQPs through
  ``dt.quadprog`` in f64, each against its gate, and one ``Model`` of an
  LP, a hierarchy and a MIQP equal to the one-shot result;
* ``flat``: the flat tier (``ldp_flat``) and ``solve_batch``'s routing:
  config 2's first 2048 lanes through ``solve_batch_flat_jit`` at cell
  2's gate (K1), its first 256 through ``solve_batch`` in f32 (the
  kernel route: K1, K2) and in f64 (the flat tier), the reference grid
  (``scripts/grid_accuracy.py``'s sizes, n = 100, 200, 500) as batches
  through ``solve_batch`` (the flat route: K1, B10, B10), no lane flagged
  1 beyond 1e-4, then ``backstop_resolve``: every lane within 1e-4;
  config 3's scenario 0 through ``solve_mpc_scan`` against the f64
  oracle, and config 5's first 8 MIQPs in f64 through
  ``solve_batch_miqp_jit`` against the branch-and-bound oracle;
* ``scale``: scale-out (``daqp_tpu_torch.parallel``) and the deploy-time
  pieces: (a) an NCCL group of one in this process: config 2's first
  2048 lanes through ``solve_batch_sharded`` (``tier="pallas"``: K1,
  K2; ``"flat"``: K1) against the unsharded calls and cell 2's gate,
  ``"prox"`` on config 4 (B4) under the f64 KKT certificate,
  ``solve_batch_miqp_sharded`` on config 5 (K1, K2) under ``miqp``'s
  gate, and ``solve_miqp_sharded`` on config 5's first MIQP in f64
  against ``dt.quadprog``; (b) this script re-run as two ranks
  (``--scale-worker``) on the one card in a gloo group: each solves its
  half of config 2's first 512 lanes through ``tier="pallas"`` and its
  half of that MIQP's tree (rank 0 checks the stats and the tree
  against the unsharded calls; a worker failing or past 120 s fails the
  phase); (c) ``dt.warmup`` of every tier at config 2's widths, then the
  wall of the first config-2 stream call after it; (d) ``render_c`` of
  config 1's first QP compiled with ``cc`` and solved, against
  ``dt.quadprog`` in f64;
* ``deploy``: the deploy surface: (a) ``codegen.export_aot(50, 100,
  batch=2048)`` traced on the card, saved, and loaded and run on config
  2's first 2048 lanes by this script re-run as ``--aot-worker`` (a fresh
  process that only imports the package, which registers K1 and B10 as
  ops; 120 s), at cell 2's gate with K1 counted in that process, its
  flags, iterations and x held to this process's eager
  ``solve_batch_flat_jit`` lane for lane; (b) ``export_aot`` of config
  1's shape in f64 and (c) ``native.NativeModel`` (the C library), each
  on config 1's first 16 QPs against ``dt.quadprog`` in f64.

The ``hiqp``, ``avi`` and ``lp`` phases end with their tier's backstop
(``backstop_resolve_hiqp``, ``_avi``, ``_lp``): the batch's loud lanes
and every 16th lane forced loud, re-solved in f64 through the
single-instance API on the card and held to the phase's own gate.

* ``stages``: the factorization stage (``scripts/profile_stages.py``):
  per-stage ms on its four B = 1024 batches (K1, B8, B9, B10, the
  library, the regularized wrapper, the transform, the whole solve), then
  config 2 factored by each of K1, B8, B9 and B10 and solved on that
  factor through the slot tier, each in its own count window (K2 and
  the factor's kernel).

Phases ``k1``-``k10`` hold each kernel against its plain twin at the
paths' shapes (``k2`` also with a finite dominance bound on every other
lane of the 256-lane chunk, case b; ``k2`` and ``k7`` also at the
streams' 256-lane chunk
and at the largest m whose block fits, ``k2`` also from slots scattered
by a permutation, ``k8`` also at n = 10, 12, 20, 32, 64 and 100, so at
every lane tile, ``k10`` at n = 100-500, beside K1; ``k1`` at the same
widths and at n = 20, 80 and 240, where the other instances of its body
run, also at config 4's retry batch of 256, and both of its launch
shapes timed in turns at n = 50 (B = 264-2640), 100 and 200; ``k1`` and
``k9`` each with the library
timed in turns; ``k9`` at ``k1``'s widths against its twin and bit for
bit K1's output); ``limits`` runs
K1, B8, B9 and B10 at their largest n (B10 at n = 1000) and shows that
a shape beyond a block's shared memory or K1's and B9's columns raises
ValueError before launch.
``python3 chip_smoke.py --phases k8 k10`` runs the named phases alone (a
measurement: no kernels line, no ``ok`` line); copied into an unpacked
parent commit, it times the parent's kernels with these phases, in turns
with this tree.  Each phase prints one JSON line with its seconds; then
come the kernel table, the card's name and power limit, and as the last
line ``{"ok": true, "device": ...}``.  Any failed check or error exits
non-zero without that line; so does a machine without a CUDA device.
"""
import ctypes
import hashlib
import importlib
import importlib.util
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

import daqp_tpu_torch as dt
from daqp_tpu_torch import (batch as pbatch, codegen, ldp_flat, mpc as pmpc,
                            ops, transform)
from daqp_tpu_torch.ops import _build, chol, dense, slot, smem

ROOT = Path(__file__).resolve().parent
# config 2 (bench.py:63-79)
B, N, M_ROWS, N_ACT, KAPPA, SEED = 10240, 50, 100, 40, 1e2, 2026
B_K2 = 1024
B_CHUNK = 256         # the streams' chunk: K2's and B7's launch shape
B_EDGE = 64           # lanes of k2 and k7 case f, at the largest m that fits
W_STEPS = 30          # twin steps before k2 case w scatters the slots
STEPS = 192
# config 3 (bench_extra.py:49-61) and config 4 (bench_extra.py:101-113)
S3, T3, SEG3, SEED3, DRIFT3 = 512, 20, 10, 7, 0.02
MARGIN_LANES = 64     # mpc: every step of these scenarios against f64
# k3's edges of B3's horizon body, config 3's generator at (n, m, rows
# active): its ceilings (K = n + 1 = 64, m = 128) and a small horizon
K3_EDGES = ((63, 128, 40), (10, 20, 8))
B4, RANK4, SEED4 = 256, 30, 11
K1_RTOL = 1e-4        # max |dRinv| / max |Rinv|, kernel vs twin
B8_LIMIT = 333        # the largest n whose one-lane B8 block fits an H100
WARP_LIMIT = 256      # K1's and B9's column limit (chol.WARP_MAX_N)
B10_LIMIT = 1581      # the largest n whose B10 block fits an H100
# scripts/profile_stages.py's batches (the stages phase)
B_STAGE, STAGE_BATCHES = 1024, 4
K2_AGREE = 0.99       # lanes whose exit flag and working set agree
K2_DU = 1e-3          # ||du||_inf / (1 + ||u||_inf) on agreeing optimal lanes
ACC_TOL = 1e-4        # ||x - x_ref||_2 gate of bench.py
ACC_RATE = 0.999
MPC_TOL = 2e-3        # ||x - x_ref||_2 gate of tests/test_mpc.py
KKT_TOL = 1e-3        # f64 KKT stationarity / violation of an optimal lane
PROX_OPT = 0.99
SOFT_ROWS = 20        # general rows 0-19 of config 2 are SOFT (k7, soft)
SOFT_STRIDE = 20      # the soft phase's oracle sample: every 20th lane
# config 4b (bench_extra.py:144-168)
B4B, N4B, BP4B, SEED4B = 256, 12, (0, 8, 16, 24), 19
HIQP_RHO = pbatch.HIQP_RHO_FLOOR   # the tier's rho, also the oracle's
HIQP_TOL = 2e-3       # ||x - x_oracle||_inf, tests/test_batch_hiqp.py:138
# The JAX package's own result on the same 256 lanes against the same
# oracle (solve_batch_hiqp_pallas_jit, interpret mode on the CPU; held by
# tests/test_torch_hiqp.py::test_config4b_jax_reference_counts): lanes
# flagged 1 or 2 beyond HIQP_TOL, and lanes whose flag class (optimal /
# exit 3 / loud) differs from the oracle's.  The port may have HIQP_SLACK
# more mismatches.  Class differences are loud exit-3 lanes where the f64
# walk solves every level: the JAX tier has 12 (95.3% agreement, below a
# 99% gate), and the count moves with f32 rounding order (the port's twin
# on the CPU differs from the kernel on the card, both printed), so the
# limit is twice the JAX tier's count, the rule for a gate the reference
# itself cannot meet.
JAX_HIQP_MISMATCHES = 2
JAX_HIQP_CLASS_DIFFS = 12
HIQP_SLACK = 3
HIQP_CLASS_LIMIT = 2 * JAX_HIQP_CLASS_DIFFS
# SOFT_WEIGHTS data (tests/test_pallas_sw.py:40-43) on config 2's soft
# rows: even lanes d_scale 0.4 / rho_lo 0.5, odd lanes 1.5 / 2.0
SW_SEED = 2027
SW_KEYS = ("d_ls", "d_us", "rho_ls", "rho_us")
SW_STRIDE = 40        # the sw phase's oracle sample: every 40th lane,
                      # shifted by one on every other sample (both regimes)
SW_TOL = 5e-4         # ||x - x_ref||_inf, tests/test_pallas_sw.py:80
# The JAX package's own loud lanes on that 256-lane sample
# (solve_batch_pallas_jit(sw=...), interpret mode on the CPU; measured by
# `JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_sw.py`: these 3
# exit CYCLE, its other lanes are within 2.4e-4 of the lifted QP).  The
# SOFT_WEIGHTS state machine cycles on them in exact arithmetic too: the
# port's dense tier run in f64 ends CYCLE there as well.  So the 0.999
# optimal rate is beyond the reference itself: the limit is twice its
# loud share, and a lane loud on the card outside this list must be
# solved by the port's own path in f64 (its loudness is then the f32
# arithmetic's, not the path's).
JAX_SW_LOUD_LANES = (8041, 8281, 8761)
JAX_SW_LOUD = len(JAX_SW_LOUD_LANES)
SW_OPT = 1.0 - 2 * JAX_SW_LOUD / 256
# configAVI (bench_extra.py:306-307)
B_AVI, N_AVI, M_AVI, SEED_AVI = 256, 20, 50, 29
AVI_TOL = 1e-3        # ||x - x_ref||_inf, tests/test_batch_avi.py:37
# The JAX tier's own optimal rate on these 256 lanes
# (solve_batch_avi_pallas_jit, interpret mode on the CPU, iter_limit
# 1000; measured by `JAX_PLATFORMS=cpu PYTHONPATH=. python
# tests/test_torch_avi.py`: 250 lanes flag 1, all within AVI_TOL, 6 loud):
# the gate is 0.9 (tests/test_batch_avi.py:35) unless this is lower, then
# it less 0.03
JAX_AVI_OPT_RATE = 250 / 256
AVI_OPT = 0.9 if JAX_AVI_OPT_RATE >= 0.9 else JAX_AVI_OPT_RATE - 0.03
# B5's pass arithmetic in f32 against the same in f64: its bounds d =
# b_s + M Rinv'(G1 x + f) by ||.||_inf / (1 + ||d||_inf), its outer half
# (y and the DR step, four chained n x n products) by / (1 + ||x||_inf)
BOUNDS_TOL = 1e-5
OUTER_TOL = 1e-4
SEG_REPS = 20         # timed launches of B3-B6 (k3-k6): a 0.5-1.3 ms
                      # launch timed 5 times spread by 5-10% in one call
QUEUE_CYCLES = 100_000_000   # ~50 ms of spin at 1.98 GHz before every
                             # timing: 20 B3 / B4 calls enqueue in < 10 ms
# configLP (bench_extra.py:253-262) and bench_lp's accuracy gate (:279):
# flag 1, relative objective gap and feasibility violation below 1e-4
B_LP, N_LP, M_LP, SEED_LP = 256, 10, 50, 17
# B5's and B6's 128-thread bodies (K = n + 1 > smem.WARP_MAX_K) at a
# second width: one cold segment each at these widths from configAVI's
# and configLP's generators
B_WIDE, N_AVI_WIDE, M_AVI_WIDE, N_LP_WIDE, M_LP_WIDE = 64, 40, 90, 40, 100
LP_TOL = 1e-4
# The JAX tier's census on these 256 lanes (solve_batch_lp_pallas_jit,
# interpret mode on the CPU, x64 as the tests run it, iter_limit 3000;
# measured by `JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_lp.py`):
# its loud lanes and the lanes it flags 1 beyond the gate, per path.  The
# fused path's six pass the tier's own certificate, whose feasibility test
# is 10 primal_tol (1 + max|b|) ~ 3e-3 here (ROADMAP Queue C).  The port
# may flag 1 beyond the gate at most as many lanes as the JAX tier, each
# of them passing the tier's certificate re-checked in f64
# (``lp_recheck``).  Unlike the JAX tier, the port turns loud a flag-1
# lane its certificate cannot judge and whose own duals are not
# stationary (batch.LP_DUAL_TOL), so a lane the JAX tier flags 1 beyond
# the gate may be loud on the port: the optimal-rate gate is 0.9
# (tests/test_batch_lp.py:42) or 1 - twice the share of lanes the JAX tier
# does not solve within the gate (loud, or flagged 1 beyond it),
# whichever is higher.
JAX_LP_LOUD = {"per_pass": (234,), "fused": (57, 81, 156, 216, 234)}
JAX_LP_BEYOND = {"per_pass": (), "fused": (11, 118, 119, 202, 218, 231)}
LP_OPT = {k: max(0.9, 1.0 - 2.0 * (len(v) + len(JAX_LP_BEYOND[k])) / B_LP)
          for k, v in JAX_LP_LOUD.items()}
K6_AGREE = 0.97       # lanes whose failed, lane_run, lflag agree (segment)
LP_OUTER_AGREE = 0.999  # lane-passes whose outer half decides as the twin's
LP_E_TOL = 1e-2       # E after the bordered add, / (1 + ||E||_inf)
# BASELINE config 1 (BASELINE.md, configs to reproduce, item 1): one dense
# convex QP at a time, n = 10, 10 box bounds and 20 general rows, 8
# active, kappa 1e2 (KAPPA); 256 instances from one generator seed
B1, N1, M1, MS1, NACT1, SEED1 = 256, 10, 30, 10, 8, 2025
SINGLE_TOL64 = 1e-6   # ||x - x_ref||_2 in f64, tests/test_backstop.py:30
SINGLE_RATE32 = 0.99  # f32: flag 1 and ||x - x_ref||_2 <= ACC_TOL
# The JAX package's own f32 lanes flagged 1 beyond ACC_TOL on these 256
# (daqp_tpu.quadprog(dtype=float32) on the CPU; held by
# tests/test_torch_single.py::test_config1_f32_jax_reference_lanes): lane
# 129 misses a box bound whose multiplier is 0.31 because the bound is
# violated by 1.9e-5, below the f32 primal_tol 3e-5, and lands 5.9e-4 from
# x_ref, KKT-certified (stationarity 2.4e-8, violation 1.2e-5).
JAX_SINGLE_SILENT32 = (129,)
# Lanes where the JAX package lands the same way once H and A move by at
# most one f32 ulp (the move's seed beside each lane; held by
# tests/test_torch_single.py::test_config1_f32_edge_lanes): when lane 8
# would add box row 6 (multiplier 0.030 in f64), the row is violated by
# 2.98e-5, 2e-8 under primal_tol, so the rounding of the sums decides
# whether it enters; left out, x lands 1.71e-4 from x_ref with the row
# violated under primal_tol.  The card sums in another order than the
# CPU and leaves it out on the unmoved data.  A lane flagged 1 beyond
# ACC_TOL must be one of these, and pass the backstop's f64 KKT gate
# (1e-4), the test of an honest f32 exit (tests/test_f32_robustness.py:60)
JAX_SINGLE_EDGE32 = {8: 6}
MODEL_WARM_ITERS = 5  # a warm re-solve after an f / bound update,
                      # tests/test_model.py:58 (1 unchanged, :41)
# the backstop phase: config 2's first B_BACK lanes through the stream,
# then every BACK_STRIDE-th lane made loud (ITERLIMIT, x zero) and every
# BACK_STRIDE-th from BACK_STRIDE // 2 silent (flag 1, x moved by
# BACK_SHIFT), tests/test_backstop.py's forced and silent cases.  A low
# iter_limit cannot fail these lanes: the stream, as the JAX one, checks
# it between rounds of 192 steps, and they need 81-131 iterations.  The
# 2-sw backstop takes the sw phase's 256-lane sample and the batch's
# first SW_BACK_LOUD loud lanes
B_BACK, BACK_STRIDE, BACK_SHIFT = 256, 12, 0.05
SW_BACK_LOUD = 24
# one H100 SXM, published peaks: f32 outside the tensor cores,
# HBM bandwidth
# BASELINE config 5 (bench_extra.py:196-216): dense MIQPs with binaries on
# identity rows, f32, iter_limit 1000 (main's st)
B5, N5, M5, NB5, SEED5 = 256, 20, 40, 6, 13
MIQP_STRIDE = 4       # the oracle gates every 4th lane (64 lanes)
MIQP_TOL = 1e-3       # fval within 1e-3 (1 + |fval|), test_batch_miqp.py:76
# The JAX tier's own census on config 5 (solve_batch_miqp_pallas_jit,
# interpret mode, on the CPU; 256 lanes, mean 6.0 nodes): every lane
# flag 1, each of the 64 gated lanes the oracle's flag within 1.8e-6
JAX_MIQP_OPT_RATE = 256 / 256
# meta: the single-instance meta-solvers on the card
META_LP, META_AVI, META_HIQP, META_MIQP = 16, 8, 16, 16
META_MIQP_TOL = 1e-6  # f64 MIQP fval against bnb_numpy, / (1 + |fval|)
# flat: the flat tier (ldp_flat) and solve_batch's routing.  Case a runs
# config 2's first FLAT_LANES lanes (one chunk of batch.LANE_CHUNK), case
# b its first FLAT_ROUTE lanes in f32 and f64 (the f64 lanes held to
# F64_TOL of the f64 generator's x); case c the reference grid as
# batches: scripts/grid_accuracy.py:22-28's sizes (n, m, ms, active) and
# generator (generate_test_qp, kappa 1e2, rng 1000 + n), B lanes each;
# case d config 3's scenario 0, case e config 5's first FLAT_MIQP MIQPs
FLAT_LANES, FLAT_ROUTE, F64_TOL = 2048, 256, 1e-6
FLAT_GRID = ((100, 500, 50, 80, 64), (200, 1000, 100, 160, 16),
             (500, 2500, 250, 400, 8))
GRID_SEED = 1000
FLAT_MIQP = 8
# scale: (b) runs two ranks on the card over gloo, each on half of config
# 2's first SCALE_2PROC lanes, each allowed SCALE_WORKER_S seconds
SCALE_2PROC, SCALE_WORKER_S = 512, 120
# deploy: (a) config 2's first FLAT_LANES lanes through the program that
# codegen.export_aot traced, loaded and run in a fresh process
# (--aot-worker) allowed AOT_WORKER_S seconds, against the eager flat call
# (the same flags and iterations, ||dx||_inf <= AOT_DX (1 + ||x||_inf));
# (b) the exported single solve and (c) the native C library on config
# 1's first DEPLOY_QPS QPs in f64 against dt.quadprog (SINGLE_TOL64)
AOT_WORKER_S, AOT_DX, DEPLOY_QPS = 120, 1e-6, 16
# (d) B10 through its registered op in a loaded program
DEPLOY_B10_N, DEPLOY_B10_LANES = 300, 8

PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


def load(name, rel):
    # by path: an installed package named "tests" may shadow the
    # repository's test directory
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def oracle_module(name):
    """``oracle/<name>.py`` imported as a submodule of a package rooted at
    the repository's ``oracle/`` (its modules import each other
    relatively and the directory has no ``__init__.py``); by path, so an
    installed ``oracle`` cannot shadow it."""
    pkg = "daqp_chip_smoke_oracle"
    if pkg not in sys.modules:
        mod = types.ModuleType(pkg)
        mod.__path__ = [str(ROOT / "oracle")]
        sys.modules[pkg] = mod
    return importlib.import_module(f"{pkg}.{name}")


def emit(phase, t0, **fields):
    print(json.dumps({"phase": phase, **fields,
                      "seconds": time.perf_counter() - t0}), flush=True)


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` in ms over ``reps`` calls, after one
    warm-up call, bracketed by CUDA events behind a spin kernel of
    QUEUE_CYCLES, so that the host has enqueued the calls before the
    first one starts: a launch whose host side takes nearly as long as
    the kernel (B3, B4) is timed without the host's gaps."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def digest(*xs):
    """A hash of the tensors' bytes: two builds that give the same
    outputs bit for bit give the same digest."""
    h = hashlib.sha256()
    for x in xs:
        h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def best_window(fn, calls=3, windows=3):
    """Shortest host wall of ``calls`` back-to-back calls ending in a
    synchronize, over ``windows`` windows."""
    best = None
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        w = time.perf_counter() - t0
        best = w if best is None else min(best, w)
    return best


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def nbytes(*xs):
    return sum(x.numel() * x.element_size() for x in xs)


def bound(n_bytes, flops):
    """The least time the card could take: each input byte read once and
    each output byte written once at the HBM rate, or the operations at
    the f32 peak, whichever is longer."""
    t_b, t_f = n_bytes / PEAK_BYTES, flops / PEAK_F32
    return dict(bound_ms=1e3 * max(t_b, t_f),
                bound_by="bytes" if t_b >= t_f else "operations",
                bytes=n_bytes, flops=flops)


def step_flops(m, n, k):
    """Operations of one slot step (slot_step.cuh) over k slots: u = W'lam*
    and the Gram column W a (2 k n each), mu = M u (2 m n), the W update
    and the pending column W prow (2 k n each), a = E g (2 k^2), the E
    update (~4 k^2) and lam*, a_p = E (.) (4 k^2).  k = K counts every
    slot; the step needs only the used ones (E is zero off used x used, W
    on unused rows)."""
    return 2 * m * n + 8 * k * n + 10 * k * k


def prefix_flops(n, k):
    """The round prefix g_p = W prow, lam*, a_p = E (.) over k slots."""
    return 2 * k * n + 4 * k * k


def slot_round_flops(s0, sk, m, n):
    """Operations of one K2 round from ``s0`` to ``sk``: per lane its
    steps and, if it ran, the prefix, at k the mean of its used counts
    before and after the round."""
    k = 0.5 * (s0.used.sum(1) + sk.used.sum(1)).double()
    steps = (sk.iterations - s0.iterations).double()
    ran = (s0.status == dt.EXIT_RUNNING).double()
    return (steps * step_flops(m, n, k) + ran * prefix_flops(n, k)).sum() \
        .item()


def state_bytes(s, names):
    return nbytes(*(getattr(s, k) for k in names))


def dense_step_flops(k, m, n):
    """Operations one dense-mask step needs with k active rows (E is zero
    off the active block, dense_round.cu): lam* = -E d_W, a_p = E g_p
    and a = E g (6 k^2), the rank-one E update (deletion and add, 4 k^2),
    u = -M'(lam* o act) over the active rows (2 k n), mu = M u and the
    add's Gram column g = M m_j (4 m n).  The pending Gram column (2 m n,
    only while an entry is pending) is not counted."""
    return 10 * k * k + 2 * k * n + 4 * m * n


def sw_step_flops(k, m, n):
    """A dense-mask step of the SOFT_WEIGHTS variant: the blocker's Gram
    column g_bk = M m_rm (2 m n), its Schur column E g_bk (2 k^2) and its
    rank-one term in the E update (2 k^2) on top of a soft step."""
    return dense_step_flops(k, m, n) + 4 * k * k + 2 * m * n


def dense_round_flops(s0, sk, n):
    """Operations of one round from ``s0`` to ``sk``: per lane its steps
    at k the mean of its active counts before and after the round."""
    k = 0.5 * ((s0.act_up + s0.act_lo).sum(1) + (sk.act_up + sk.act_lo)
               .sum(1))
    steps = sk.iterations - s0.iterations
    step = sw_step_flops if s0.sw_dls is not None else dense_step_flops
    return (steps.double() * step(k.double(), s0.M.shape[1], n)).sum().item()


def off_block_lanes(s):
    """Lanes whose E is not exactly zero off the active block (the
    precondition of B7's active-row walk)."""
    act = s.act_up + s.act_lo
    off = (act[:, :, None] * act[:, None, :]) == 0
    return int(((s.E != 0) & off).any(2).any(1).sum())


def slot_off_block_lanes(s):
    """Lanes whose E is not exactly zero off used x used, or whose W is
    not zero on an unused row (the precondition of the slot step's
    used-slot list)."""
    off = (s.used[:, :, None] * s.used[:, None, :]) == 0
    e_bad = ((s.E != 0) & off).any(2).any(1)
    w_bad = ((s.W != 0) & (s.used == 0)[:, :, None]).any(2).any(1)
    return int((e_bad | w_bad).sum())


def slot_holes(s):
    """Lanes with a free slot below a used one."""
    k = s.used.sum(1)
    last = torch.where(s.used > 0, torch.arange(
        s.used.shape[1], device=s.used.device), -1).amax(1)
    return int((last + 1 > k).sum())


def reset_counts():
    chol.launches = slot.launches = dense.launches = 0
    chol.lanes_launches = chol.dense_launches = chol.blk_launches = 0
    slot.mpc_launches = slot.prox_launches = slot.avi_launches = 0
    slot.lp_launches = 0
    ops.host_syncs = pmpc.redone_segments = pbatch.prox_resumed_lanes = 0
    ldp_flat.rounds = 0
    pbatch.avi_kkt_services = pbatch.avi_resumed_lanes = 0
    pbatch.lp_resumed_lanes = pbatch.lp_certified_lanes = 0


def read_counts():
    return {"chol_rinv": chol.launches, "chol_lanes": chol.lanes_launches,
            "chol_dense": chol.dense_launches, "chol_blk": chol.blk_launches,
            "slot_round": slot.launches,
            "mpc_segment": slot.mpc_launches,
            "prox_segment": slot.prox_launches,
            "dense_round": dense.launches,
            "avi_segment": slot.avi_launches,
            "lp_segment": slot.lp_launches}


def exact_gap(M, sk, sp, lanes):
    """Per lane of ``lanes``, ||u - u_exact||_inf of kernel and twin, u_exact
    = W' (W W')^-1 d in f64 on each side's final slot table (W = the used
    slots' rows of M, d = their dsl); two arrays."""
    M = M.double().cpu().numpy()
    gaps = []
    for s in (sk, sp):
        used, sid = s.used.cpu().numpy(), s.sid.cpu().numpy()
        dsl, u = s.dsl.double().cpu().numpy(), s.u.double().cpu().numpy()
        g = []
        for b in np.nonzero(lanes.cpu().numpy())[0]:
            k = np.nonzero(used[b])[0]
            W = M[b][sid[b, k].astype(int)]
            ue = W.T @ np.linalg.solve(W @ W.T, dsl[b, k])
            g.append(float(np.abs(u[b] - ue).max()))
        gaps.append(np.asarray(g))
    return gaps


def gmax(g):
    return float(g.max()) if g.size else 0.0


def phase_env(card):
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout
    log = _build.BUILD_DIR / "nvcc.log"
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "Compiling entry" in ln
             or "spill" in ln] \
        if log.exists() else []
    emit("env", t0, torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=[ln for ln in nvcc.splitlines() if "release" in ln][0],
         card=card, build_s=build_s, ptxas=ptxas)


def library_rinv(H):
    """The library yardstick: Cholesky, then a triangular solve against
    I (Rinv = L'^{-1})."""
    eye = torch.eye(H.shape[1], device=H.device, dtype=H.dtype)
    L, _ = torch.linalg.cholesky_ex(H)
    return torch.linalg.solve_triangular(L.transpose(1, 2),
                                         eye.expand_as(H), upper=True)


def spd_batch(Bn, n, seed, dev):
    """A A' + n I with A (Bn, n, n) standard normal from ``seed`` by
    numpy, the product taken on the card; cond <= ~5 (A A' has its
    eigenvalues in [0, ~4n])."""
    A = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (Bn, n, n), dtype=np.float32), device=dev)
    return torch.matmul(A, A.transpose(1, 2)) \
        + n * torch.eye(n, device=dev)


def factor_case(kernel, twin, H, rtol=K1_RTOL, reps=20, twin_reps=3):
    """One factorization kernel against its twin on ``H``: (passes,
    fields): max |dRinv|, relative to max |Rinv_twin| against ``rtol``;
    the residual max ||Rinv' H Rinv - I||_inf of both; the distance to
    the library; kernel, twin and library ms; the bound (each matrix's
    lower triangle read once, the function depends on nothing else, and
    Rinv written once, or B 2n^3/3 operations)."""
    Rk = kernel(H)
    Rp = twin(H)
    Bk, n = H.shape[0], H.shape[1]
    eye = torch.eye(n, device=H.device)

    def resid(R):          # max over lanes of ||Rinv' H Rinv - I||_inf
        P = torch.matmul(R.transpose(1, 2), torch.matmul(H, R))
        return (P - eye).abs().sum(2).amax().item()

    err = (Rk - Rp).abs().max().item()
    rel = err / Rp.abs().max().item()
    fields = dict(B=Bk, n=n, max_abs_err=err, rel_err=rel, rel_tol=rtol,
                  digest=digest(Rk),
                  resid_kernel=resid(Rk), resid_twin=resid(Rp),
                  kernel_vs_library=(library_rinv(H) - Rk).abs().max().item(),
                  ms=cuda_ms(lambda: kernel(H), reps),
                  plain_ms=cuda_ms(lambda: twin(H), twin_reps),
                  library_ms=cuda_ms(lambda: library_rinv(H), reps),
                  **bound(H.element_size() * Bk * (n * (n + 1) // 2
                                                   + n * n),
                          Bk * 2 * n ** 3 / 3))
    return rel <= rtol, fields


def kernel_fields(f):
    """A factorization case's numbers for the kernels line."""
    return {k: f[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms",
                              "bound_ms", "bound_by")}


def slot_state(args, st):
    """The cold slot state of QP lanes ``args`` (H, f, A, bu, bl, sense)
    after the port's factorization and build_ldp."""
    Rinv, _, _, _ = chol.batched_rinv_regularized(args[0], st)
    ldpd = transform.build_ldp(*args[1:], 0, st, Rinv=Rinv)
    immut = ((ldpd.sense & dt.IMMUTABLE) > 0).float()
    return slot.slot_init(ldpd.M, ldpd.dupper, ldpd.dlower, ldpd.scaling,
                          immut, n_true=ldpd.M.shape[2])


def k2_case(s0, st, steps=STEPS):
    """One K2 round against its twin from ``s0``.

    Semantic agreement: exit flag and working set (the m-space active
    masks) on K2_AGREE of the lanes; the slot a row sits in may differ
    where the paths parted at an f32 tie and met again.  u is held
    relative to its scale: after ~100 f32 rank-one updates of E and
    before slot_solve's polish, each side is up to ~1e-3 off the exact
    f64 u on its own working set (measured on the H100: kernel 1.1e-3,
    twin 1.9e-3 at |u| ~ 6-12).  The kernel must leave E zero off
    used x used and W zero on unused rows on every lane, as the next
    round's list needs."""
    n = s0.M.shape[2]
    sk = slot.run_slot_round(s0, st, n, steps)
    sp = slot.run_slot_round_plain(s0, st, n, steps)
    agree = (sk.status == sp.status) & (sk.act_up == sp.act_up).all(1) \
        & (sk.act_lo == sp.act_lo).all(1)
    table = agree & (sk.used == sp.used).all(1) & (sk.sid == sp.sid).all(1)
    opt = agree & (sk.status == dt.EXIT_OPTIMAL)
    du = (sk.u - sp.u).abs().amax(1)[opt]
    du_rel = gmax((du / (1.0 + sp.u.abs().amax(1)[opt])).cpu().numpy())
    du = gmax(du.cpu().numpy())
    rate = agree.float().mean().item()
    ex_k, ex_p = map(gmax, exact_gap(s0.M, sk, sp, opt))
    ms = cuda_ms(lambda: slot.run_slot_round(s0, st, n, steps), 5)
    plain_ms = cuda_ms(lambda: slot.run_slot_round_plain(s0, st, n, steps),
                       2)
    Bk, m, _ = s0.M.shape
    K = s0.E.shape[1]
    steps_done = (sk.iterations - s0.iterations).sum().item()
    n_bytes = state_bytes(s0, slot.CONST + slot.STATE) \
        + state_bytes(sk, slot.STATE)
    bnd = bound(n_bytes, slot_round_flops(s0, sk, m, n))
    ran = int((s0.status == dt.EXIT_RUNNING).sum())
    old = bound(n_bytes, steps_done * step_flops(m, n, K)
                + ran * prefix_flops(n, K))
    off_block = slot_off_block_lanes(sk)
    flags = {int(k): int(v) for k, v in zip(
        *torch.unique(sk.status, return_counts=True))}
    out = dict(B=Bk, n=n, m=m, K=K, steps=steps, agree_rate=rate,
               slot_table_agree_rate=table.float().mean().item(),
               optimal_agreeing=int(opt.sum()), du_inf=du, du_rel=du_rel,
               du_rel_tol=K2_DU, kernel_vs_exact=ex_k, twin_vs_exact=ex_p,
               kernel_flags=flags, steps_done=steps_done,
               off_block_lanes=off_block, ms=ms, plain_ms=plain_ms,
               bound_ms_all_slots=old["bound_ms"], **bnd)
    return rate >= K2_AGREE and du_rel <= K2_DU and off_block == 0, out


def scattered(s, seed):
    """``s`` with each lane's K slots permuted by a generator from
    ``seed``: W's rows, E's rows and columns and every per-slot vector
    move together, an exact relabelling that leaves free slots between
    used ones."""
    Bk, K = s.used.shape
    perm = torch.as_tensor(np.argsort(np.random.default_rng(seed).random(
        (Bk, K)), axis=1), device=s.used.device)
    rows = perm[:, :, None]
    E = s.E.gather(1, rows.expand(-1, -1, K)).gather(
        2, perm[:, None, :].expand(-1, K, -1))
    vec = {k: getattr(s, k).gather(1, perm)
           for k in ("sid", "slo", "dsl", "used", "simm", "lam",
                     "lam_star")}
    return s._replace(W=s.W.gather(1, rows.expand(-1, -1, s.W.shape[2])),
                      E=E.contiguous(), **vec)


def k2_cut_case(s_e, st):
    """K2's per-lane dominance cut (``fbound``, slot_step.cuh:650) against
    its twin on case e's lanes: every other lane that the twin's unbounded
    round leaves OPTIMAL gets a bound of half its optimal LDP fval, the
    rest DAQP_INF.  Gates: kernel and twin flag every cut lane
    INFEASIBLE; on the other lanes the kernel's state is bit for bit its
    unbounded round's and the twin's its own, so kernel and twin agree
    there as in case e."""
    n = s_e.M.shape[2]
    sk_e = slot.run_slot_round(s_e, st, n, STEPS)
    sp_e = slot.run_slot_round_plain(s_e, st, n, STEPS)
    lanes = torch.arange(s_e.M.shape[0], device=s_e.M.device)
    cut = (lanes % 2 == 0) & (sp_e.status == dt.EXIT_OPTIMAL)
    fb = torch.where(cut, 0.5 * sp_e.fval, dt.DAQP_INF).contiguous()
    s_b = s_e._replace(fbound=fb)
    sk = slot.run_slot_round(s_b, st, n, STEPS)
    sp = slot.run_slot_round_plain(s_b, st, n, STEPS)
    rest = ~cut
    same_k = bool(all(torch.equal(getattr(sk, k)[rest], getattr(sk_e, k)[rest])
                      for k in slot.STATE))
    same_p = bool(torch.equal(sp.status[rest], sp_e.status[rest])
                  and torch.equal(sp.u[rest], sp_e.u[rest]))
    agree_b = (sk.status == sp.status)[rest]
    agree_e = (sk_e.status == sp_e.status)[rest]
    cut_k = bool((sk.status[cut] == dt.EXIT_INFEASIBLE).all())
    cut_p = bool((sp.status[cut] == dt.EXIT_INFEASIBLE).all())
    steps_cut = (sk.iterations - s_b.iterations)[cut].sum().item()
    steps_free = (sk_e.iterations - s_e.iterations)[cut].sum().item()
    ms = cuda_ms(lambda: slot.run_slot_round(s_b, st, n, STEPS), 5)
    plain_ms = cuda_ms(lambda: slot.run_slot_round_plain(s_b, st, n, STEPS),
                       2)
    out = dict(B=int(lanes.numel()), cut_lanes=int(cut.sum()),
               cut_kernel_infeasible=cut_k, cut_twin_infeasible=cut_p,
               flags_equal_on_cut=bool(torch.equal(sk.status[cut],
                                                   sp.status[cut])),
               rest_kernel_bitwise_as_unbounded=same_k,
               rest_twin_as_unbounded=same_p,
               rest_agree_as_case_e=bool(torch.equal(agree_b, agree_e)),
               rest_agree_rate=agree_b.float().mean().item(),
               steps_cut_lanes=steps_cut, steps_cut_lanes_unbounded=steps_free,
               ms=ms, plain_ms=plain_ms)
    ok = cut_k and cut_p and same_k and same_p \
        and bool(torch.equal(agree_b, agree_e)) and int(cut.sum()) > 0
    return ok, out


def phase_k2(args, chunk, st):
    """K2 against its twin: (a) one cold round on the first B_K2 config-2
    lanes; (e) the first 256-lane chunk of the sorted config-2 stream
    (``chunk``, its QP args), K2's launch shape on the main path; (b)
    case e with a finite dominance bound on every other lane
    (``k2_cut_case``); (f) B_EDGE random lanes at n = N and the largest m
    whose block fits; (w) case e's lanes after W_STEPS steps of the twin,
    each lane's slots permuted, the rest of the round from there."""
    t0 = time.perf_counter()
    dev = args[0].device
    ok_a, a = k2_case(slot_state(args, st), st)
    s_e = slot_state(chunk, st)
    ok_e, e = k2_case(s_e, st)
    ok_b, b = k2_cut_case(s_e, st)
    M, du, dl = edge_lanes(slot_edge_m(dev), dev)
    one = torch.ones_like(du)
    ok_f, f = k2_case(slot.slot_init(M, du, dl, one, 0.0 * one, n_true=N),
                      st)
    s_w = scattered(slot.run_slot_round_plain(s_e, st, N, W_STEPS), SEED)
    holes = slot_holes(s_w)
    ok_w, w = k2_case(s_w, st, STEPS - W_STEPS)
    emit("k2", t0, config2=a, chunk256=e, cut=b, edge=f,
         scattered=dict(lanes_with_holes=holes, **w))
    ok = ok_a and ok_e and ok_b and ok_f and ok_w and holes > 0
    return ok, dict(
        max_abs_err=max(a["du_inf"], e["du_inf"], f["du_inf"], w["du_inf"]),
        ms=a["ms"], plain_ms=a["plain_ms"], library_ms=None,
        bound_ms=a["bound_ms"], bound_by=a["bound_by"], ms_b256=e["ms"],
        plain_ms_b256=e["plain_ms"], bound_ms_b256=e["bound_ms"],
        ms_cut=b["ms"], plain_ms_cut=b["plain_ms"], m_edge=f["m"],
        ms_edge=f["ms"], ms_scattered=w["ms"])


def phase_slice(full, d, st, card):
    t0 = time.perf_counter()

    def solve():
        return dt.solve_batch_kernel_stream(*full, st=st, ms=0, chunk=256,
                                            has_soft=False,
                                            sort_stream=True)

    reset_counts()
    r = solve()
    torch.cuda.synchronize()
    launches = read_counts()
    syncs = ops.host_syncs
    x = r.x.cpu().numpy()
    flags = r.exitflag.cpu().numpy()
    err = np.linalg.norm(x.astype(np.float64) - d['x'], axis=1)
    shape_ok = x.shape == (B, N) and r.lam.shape == (B, M_ROWS) \
        and bool(np.isfinite(x).all())
    acc = float(np.mean((flags == 1) & (err <= ACC_TOL)))
    silent = int(np.sum((flags == 1) & (err > ACC_TOL)))
    best = best_window(solve)
    emit("slice", t0, B=B, n=N, m=M_ROWS, chunk=256, sort_stream=True,
         launches=launches, host_syncs=syncs, shape_finite_ok=shape_ok,
         accuracy_pass_rate=acc, optimal_rate=float(np.mean(flags == 1)),
         silent_wrong=silent, max_err_optimal=float(
             err[flags == 1].max()) if (flags == 1).any() else None,
         median_iters=float(np.median(r.iterations.cpu().numpy())),
         solves_per_s=3 * B / best, window_s=best, card=card)
    ok = shape_ok and acc >= ACC_RATE and silent == 0 \
        and launches["chol_rinv"] >= 1 and launches["slot_round"] >= 1
    return ok, launches


def width_cases(kernel, twin, widths, seed, dev, beside=True):
    """``kernel`` at each (B, n) of ``widths`` on A A' + n I against its
    twin at K1_RTOL, its ms and the library's; with ``beside``, K1 beside
    it the same way (K1 raises ValueError where its block exceeds shared
    memory; that is recorded, not a failure).  (passes, {"BxN": fields})."""
    ok, out = True, {}
    for Bn, n in widths:
        H = spd_batch(Bn, n, seed + n, dev)
        good, f = factor_case(kernel, twin, H, reps=5, twin_reps=1)
        ok = ok and good
        out[f"{Bn}x{n}"] = f
        if beside:
            try:
                good_k1, f1 = factor_case(chol.chol_rinv,
                                          chol.chol_rinv_plain, H, reps=5,
                                          twin_reps=1)
                f["k1"] = dict(ms=f1["ms"], rel_err=f1["rel_err"])
            except ValueError as e:
                good_k1, f["k1"] = True, dict(raised=str(e))
            ok = ok and good_k1
        del H
    return ok, out


def same_as_k1(widths, seed, dev):
    """B9 at each (B, n) of ``widths`` (k1's sweep, on the same data):
    within K1_RTOL of its own twin and bit for bit K1's output, since the
    two run one body under two names (k1 times each width and the
    library).  (passes, {"BxN": fields})."""
    ok, out = True, {}
    for Bn, n in widths:
        H = spd_batch(Bn, n, seed + n, dev)
        R9, Rp = chol.chol_rinv_dense(H), chol.chol_rinv_dense_plain(H)
        rel = (R9 - Rp).abs().max().item() / Rp.abs().max().item()
        same = torch.equal(R9, chol.chol_rinv(H))
        ok = ok and same and rel <= K1_RTOL
        out[f"{Bn}x{n}"] = dict(rel_err=rel, rel_tol=K1_RTOL,
                                equals_k1=same, digest=digest(R9))
        del H, R9, Rp
    return ok, out


def in_turns(first, second, reps, rounds=2):
    """Mean ms of ``reps`` calls of each function, timed in turns
    (first, second, second, first) ``rounds`` times: {"first": [...],
    "second": [...]}."""
    return turns({"first": first, "second": second}, reps, rounds)


def turns(fns, reps, rounds=2):
    """Mean ms of ``reps`` calls of each function of ``fns`` (name:
    function), timed in turns (the names in order, then reversed)
    ``rounds`` times: {name: [...]}."""
    out = {k: [] for k in fns}
    for _ in range(rounds):
        for key in [*fns, *reversed(fns)]:
            out[key].append(cuda_ms(fns[key], reps))
    return out


def warp_launch(H, per_block, P, out=None):
    """K1 through its C entry at (matrices a block, warps a matrix) on
    ``H``, counted nowhere (chol.warp_shape's choice is bypassed)."""
    out = torch.empty_like(H) if out is None else out
    _build.check(_build.library().chol_rinv_f32(
        H.data_ptr(), out.data_ptr(), H.shape[0], H.shape[1], per_block, P,
        chol.TINY, torch.cuda.current_stream().cuda_stream), "chol_rinv_f32")
    return out


def warp_shapes(H, cases, seed, reps=20):
    """K1 at each (B, n) of ``cases`` in the launch shapes chol.warp_shape
    chooses between: one warp a matrix (chol.warp_tile matrices a block)
    and each P of chol.WARP_P warps a matrix, a block each, all of them
    bit for bit equal, the first timed in turns with the shape
    warp_shape picks, through the C entry (these launches count
    nothing), on the first B of the config-2 Hessians ``H`` at their n,
    else on A A' + n I.  (passes, {"BxN": fields})."""
    limit, n_sm = smem.available(H.device), smem.sms(H.device)
    ok, out = True, {}
    for Bn, n in cases:
        Hb = H[:Bn].contiguous() if n == H.shape[1] \
            else spd_batch(Bn, n, seed + n, H.device)
        w = chol.warp_tile(Bn, n, limit, n_sm)
        pick = chol.warp_shape(Bn, n, limit, n_sm)
        R1, Rp = warp_launch(Hb, w, 1), torch.empty_like(Hb)
        same = all(torch.equal(R1, warp_launch(Hb, 1, P))
                   for P in chol.WARP_P)
        t = in_turns(lambda: warp_launch(Hb, w, 1, R1),
                     lambda: warp_launch(Hb, *pick, Rp), reps)
        ok = ok and same
        out[f"{Bn}x{n}"] = dict(per_block=w, warp_ms=t["first"],
                                pick_ms=t["second"], equal=same,
                                picks=pick)
        del Hb, R1, Rp
    return ok, out


def phase_factor(name, kernel, twin, H, sweep, turns=False, small=None):
    """K1, B8, B9 or B10 against its twin on the config-2 Hessians (the
    numbers of the kernels line), then ``sweep()``, (passes, fields) for
    the phase's line; with ``turns``, the kernel and the library timed in
    turns; with ``small``, the same on the first ``small`` Hessians."""
    t0 = time.perf_counter()
    cases = {"": H}
    if small is not None:
        cases[f"b{small}"] = H[:small].contiguous()
    ok, out = True, {}
    for key, Hc in cases.items():
        good, f = factor_case(kernel, twin, Hc)
        if turns:
            t = in_turns(lambda: library_rinv(Hc), lambda: kernel(Hc), 20)
            f["turns_ms"] = dict(library=t["first"], kernel=t["second"])
        ok = ok and good
        out[key] = f
    ok_s, swept = sweep()
    f = out.pop("")
    emit(name, t0, **f, **out, **swept)
    return ok and ok_s, kernel_fields(f)


def sweep(cases, *args):
    """A phase's sweep: ``cases(*args)``'s (passes, fields by width) as
    (passes, {"widths": ...})."""
    def run():
        ok, by_n = cases(*args)
        return ok, dict(widths=by_n)
    return run


def k1_sweep(H, dev, gen):
    """k1's sweep: FACTOR_WIDTHS against the twin, the launch shapes at
    SHAPE_CASES, then K1 on the Hessians of the flat grid's batches at n
    = 100 and 200 (FLAT_GRID, B = 64 and 16) against the twin, bit for
    bit the one-warp and the 4-warp shape, and timed in turns with the
    library and B10, beside the bound."""
    ok_w, by_n = width_cases(chol.chol_rinv, chol.chol_rinv_plain,
                             FACTOR_WIDTHS, SEED, dev, False)
    ok_s, shapes = warp_shapes(H, SHAPE_CASES, SEED)
    ok_g, grid = True, {}
    for n, m, ms, nact, Bn in FLAT_GRID[:2]:
        Hg = grid_batch(gen, n, m, ms, nact, Bn)[1][0]
        good, f = factor_case(chol.chol_rinv, chol.chol_rinv_plain, Hg,
                              twin_reps=1)
        Rk = chol.chol_rinv(Hg)
        w = chol.warp_tile(Bn, n, smem.available(Hg.device),
                           smem.sms(Hg.device))
        f["picks"] = chol.warp_shape(Bn, n, smem.available(Hg.device),
                                     smem.sms(Hg.device))
        f["equals_warp"] = torch.equal(Rk, warp_launch(Hg, w, 1))
        f["equals_4_warps"] = torch.equal(Rk, warp_launch(Hg, 1, 4))
        f["turns_ms"] = turns({"library": lambda: library_rinv(Hg),
                               "kernel": lambda: chol.chol_rinv(Hg),
                               "b10": lambda: chol.chol_rinv_blk(Hg)},
                              20, rounds=3)
        ok_g = ok_g and good and f["equals_warp"] and f["equals_4_warps"]
        grid[f"{Bn}x{n}"] = f
    return ok_w and ok_s and ok_g, dict(widths=by_n, shapes=shapes,
                                        grid=grid)


# B8 at the widths of configLP, 4b and AVI (32 lanes a block), at n = 32
# and 64 (16 and 4 lanes) and at n = 100 (B = 1024, 2 lanes), so that
# with config 2's n = 50 (8 lanes) and limits' n = 333 (1 lane) every
# tile the wrapper may pick runs; B10 at the BASELINE "large" widths,
# where K1 stops at n = 256 (the columns a warp's lanes hold).  K1_RTOL
# holds at every width: kernel and twin add the same f32 terms in the
# same order and part only where the kernel fuses a multiply-add, and with
# cond(A A' + n I) <= ~5 the rounding bound n eps is 3e-5 at n = 500
# (measured on the H100: 2e-7).
K8_WIDTHS = [(B, n) for n in (10, 12, 20, 32, 64)] + [(1024, 100)]
# K1 (and B9, bit for bit K1) at the same widths (n = 100: 4 column
# groups, 4 warps a matrix), at n = 240 (B = 256: 8 groups, 4 warps) and
# where the other instances of their body that warp_shape picks run: n =
# 80 at B = 2048 (4 groups, a warp a matrix), n = 20 at B = 128 (1
# group, 4 warps); k1's SHAPE_CASES run the one it never picks (8
# groups, a warp a matrix) at n = 200, bit for bit the 4-warp shape
FACTOR_WIDTHS = K8_WIDTHS + [(B4, 240), (2048, 80), (128, 20)]
# k1's (B, n) for both launch shapes: n = 50 around warp_shape's switch,
# and n = 100 and 200, where warp_tile puts one matrix in a block
SHAPE_CASES = [(b, 50) for b in (264, 528, 1024, 1320, 1584, 2112, 2640)] \
    + [(1024, 100), (2048, 100), (1024, 200), (2048, 200)]
K10_WIDTHS = [(1024, 100), (1024, 200), (256, 300), (256, 500)]


def limit_case(fn, counts):
    """Run ``fn`` expecting the wrapper's ValueError before launch:
    (passes, what happened).  Any other exception, a launch, or a CUDA
    error at the next synchronize fails."""
    before = read_counts()
    try:
        fn()
        out = dict(raised=None)
    except ValueError as e:
        out = dict(raised=str(e))
    except Exception as e:                       # noqa: BLE001
        out = dict(raised=None, other=f"{type(e).__name__}: {e}")
    torch.cuda.synchronize()
    launched = {k: read_counts()[k] - before[k] for k in counts}
    out["launched"] = launched
    return out["raised"] is not None and not any(launched.values()), out


def phase_limits(st, dev):
    """The shape checks: K1 and B9 at their column limit n = 256, B8 at
    its one-lane limit n = 333 and B10 at n = 1000 (twice BASELINE's
    largest n) run and agree with their twins; K1 and B9 at n = 257, B8 at
    n = 334, B10 at n = 1582, K2 at n = 100, m = 500 (BASELINE "medium")
    and at n = 50 one row past the largest m that fits (k2 case f runs
    that m), B7 at n = 50, m = 210 and B7-sw at m = 206 raise ValueError
    before any launch."""
    t0 = time.perf_counter()
    H256 = spd_batch(64, WARP_LIMIT, SEED, dev)
    ok1, f1 = factor_case(chol.chol_rinv, chol.chol_rinv_plain, H256,
                          reps=3, twin_reps=1)
    ok9, f9 = factor_case(chol.chol_rinv_dense, chol.chol_rinv_dense_plain,
                          H256, reps=3, twin_reps=1)
    del H256
    ok8, f8 = factor_case(chol.chol_rinv_lanes, chol.chol_rinv_lanes_plain,
                          spd_batch(64, B8_LIMIT, SEED, dev), reps=3,
                          twin_reps=1)
    # B10's twin at pb = 32 is bit for bit its twin at 8 (the JAX order;
    # tests/test_torch_chol_kernels.py), in a quarter of the steps
    ok10, f10 = factor_case(
        chol.chol_rinv_blk, lambda H: chol.chol_rinv_blk_plain(H, pb=32),
        spd_batch(8, 1000, SEED, dev), reps=3, twin_reps=1)

    def lane(m, n):
        g = np.random.default_rng(SEED + m)
        M = torch.as_tensor(g.standard_normal((1, m, n), dtype=np.float32),
                            device=dev)
        one = torch.ones((1, m), device=dev)
        return M, one, -one, one, 0.0 * one

    def k2(m, n):
        slot.run_slot_round(slot.slot_init(*lane(m, n), n_true=n), st, n,
                            STEPS)

    m_k2 = slot_edge_m(dev) + 1

    def b7(m, sw):
        M, du, dl, sc, imm = lane(m, N)
        w = dt.SoftWeights(*(0.5 * du for _ in SW_KEYS)) if sw else None
        dense.run_kernel_round(dense.dense_init(M, du, dl, sc, imm,
                                                soft=du, sw=w), st, N, STEPS)

    cases = {
        f"k1_n{WARP_LIMIT + 1}": (lambda: chol.chol_rinv(
            spd_batch(2, WARP_LIMIT + 1, SEED, dev)), ("chol_rinv",)),
        f"b9_n{WARP_LIMIT + 1}": (lambda: chol.chol_rinv_dense(
            spd_batch(2, WARP_LIMIT + 1, SEED, dev)), ("chol_dense",)),
        f"b8_n{B8_LIMIT + 1}": (lambda: chol.chol_rinv_lanes(
            spd_batch(2, B8_LIMIT + 1, SEED, dev)), ("chol_lanes",)),
        f"b10_n{B10_LIMIT + 1}": (lambda: chol.chol_rinv_blk(
            spd_batch(2, B10_LIMIT + 1, SEED, dev)), ("chol_blk",)),
        "k2_n100_m500": (lambda: k2(500, 100), ("slot_round",)),
        f"k2_n50_m{m_k2}": (lambda: k2(m_k2, N), ("slot_round",)),
        "b7_n50_m210": (lambda: b7(210, False), ("dense_round",)),
        "b7sw_n50_m206": (lambda: b7(206, True), ("dense_round",))}
    res = {k: limit_case(fn, c) for k, (fn, c) in cases.items()}
    emit("limits", t0, **{f"k1_n{WARP_LIMIT}": f1, f"b8_n{B8_LIMIT}": f8,
                          f"b9_n{WARP_LIMIT}": f9, "b10_n1000": f10},
         smem_optin=smem.available(dev),
         **{k: v[1] for k, v in res.items()})
    return ok1 and ok8 and ok9 and ok10 and all(v[0] for v in res.values()), \
        None


FACTORS = (("chol_rinv", chol.chol_rinv), ("chol_lanes", chol.chol_rinv_lanes),
           ("chol_dense", chol.chol_rinv_dense),
           ("chol_blk", chol.chol_rinv_blk))


def stage_batches(gen, dev):
    """scripts/profile_stages.py's data: 4 batches of B = 1024, n = 50,
    m = 100, ms = 0, 25 active, kappa 1e2 from one default_rng(0)."""
    rng = np.random.default_rng(0)
    keys = ('H', 'f', 'A', 'bupper', 'blower')
    out = []
    for _ in range(STAGE_BATCHES):
        d = gen.generate_test_qp_batch(B_STAGE, N, M_ROWS, 0, 25, KAPPA,
                                       rng=rng, dtype=np.float32)
        out.append([torch.as_tensor(d[k], device=dev) for k in keys]
                   + [torch.zeros((B_STAGE, M_ROWS), dtype=torch.int32,
                                  device=dev)])
    return out


def per_batch_ms(fn, batches, windows=3):
    """profile_stages' timing: ms per batch, best of ``windows`` windows
    over the batches, each ending in a synchronize, after a warm-up."""
    for b in batches:
        fn(*b)
    torch.cuda.synchronize()
    return 1e3 * best_window(lambda: [fn(*b) for b in batches], calls=1,
                             windows=windows) / len(batches)


def phase_stages(full, d, st, gen, card):
    """The factorization stage (scripts/profile_stages.py): per-stage ms
    on its 4 batches (K1, B8, B9, B10, the library, the regularized
    wrapper, the transform, the whole kernel solve); then config 2
    (B = 10240) factored by each of K1, B8, B9 and B10, each lane's ok by
    the pivot-ratio test, and solved on that factor through the slot
    tier (``_kernel_batch_core(fact=)``), each in its own count window:
    the gate of the slice phase, the factor's own kernel launched, and K1
    not launched unless it is the factor."""
    t0 = time.perf_counter()
    batches = stage_batches(gen, full[0].device)

    def transform_full(H, f, A, bu, bl, sense):
        Rinv = chol.batched_rinv_regularized(H, st)[0]
        return transform.build_ldp(f, A, bu, bl, sense, 0, st, Rinv=Rinv)

    stages = {name: per_batch_ms(lambda H, *_: fn(H), batches)
              for name, fn in FACTORS}
    stages["library"] = per_batch_ms(lambda H, *_: library_rinv(H), batches)
    stages["regularized"] = per_batch_ms(
        lambda H, *_: chol.batched_rinv_regularized(H, st), batches)
    stages["transform"] = per_batch_ms(transform_full, batches)
    stages["solve"] = per_batch_ms(
        lambda *b: dt.solve_batch_kernel(*b, st=st, has_soft=False), batches,
        windows=2)
    stages["active_set_and_host_loop"] = stages["solve"] - stages["transform"]
    del batches

    Hs = (0.5 * (full[0] + full[0].transpose(1, 2))).contiguous()
    sqrt_zt = torch.sqrt(torch.tensor(st.zero_tol, device=Hs.device))
    no = torch.zeros(B, dtype=torch.bool, device=Hs.device)
    zero = torch.zeros(B, device=Hs.device)
    ok, e2e, windows = True, {}, {}
    for name, fn in FACTORS:
        reset_counts()
        tw = time.perf_counter()
        R = fn(Hs)
        fact = (R, chol.pivot_ok(R, sqrt_zt), no, zero)
        r = pbatch._kernel_batch_core(*full, st, fact=fact)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tw
        launches = read_counts()
        x, flags = r.x.cpu().numpy(), r.exitflag.cpu().numpy()
        err = np.linalg.norm(x.astype(np.float64) - d['x'], axis=1)
        acc = float(np.mean((flags == 1) & (err <= ACC_TOL)))
        silent = int(np.sum((flags == 1) & (err > ACC_TOL)))
        good = x.shape == (B, N) and bool(np.isfinite(x).all()) \
            and acc >= ACC_RATE and silent == 0 and launches[name] >= 1 \
            and (name == "chol_rinv" or launches["chol_rinv"] == 0)
        ok = ok and good
        e2e[name] = dict(ok_lanes=int(fact[1].sum()), accuracy_pass_rate=acc,
                         silent_wrong=silent, optimal_rate=float(
                             np.mean(flags == 1)), max_err_optimal=float(
                             err[flags == 1].max()) if (flags == 1).any()
                         else None, launches=launches, wall_s=wall,
                         passes=good)
        windows[f"stages_{name}"] = launches
        del R, fact, r
    emit("stages", t0, B_stage=B_STAGE, batches=STAGE_BATCHES,
         ms_per_batch=stages, config2=e2e, card=card)
    return ok, windows


def config3(gen, S=S3, n=N, m=M_ROWS, nact=40, seed=SEED3):
    """bench_extra.py:53-61: one QP drifting over S scenarios x T3 (config
    3 at its defaults)."""
    rng = np.random.default_rng(seed)
    _, H, f, A, bu, bl, _ = gen.generate_test_qp(n, m, 0, nact, KAPPA, rng)
    H, f, A, bu, bl = (v.astype(np.float32) for v in (H, f, A, bu, bl))
    drift_f = DRIFT3 * rng.standard_normal((S, T3, n)).astype(np.float32)
    drift_b = DRIFT3 * rng.standard_normal((S, T3, m)).astype(np.float32)
    return dict(H=H, A=A, f_seq=np.cumsum(drift_f, axis=1) + f,
                bu_seq=np.cumsum(np.abs(drift_b), axis=1) + bu,
                bl_seq=bl - np.cumsum(np.abs(drift_b), axis=1))


def mpc_warm_segment(args, st):
    """The inputs of config 3's one B3 launch, its warm segment 1: the
    state after segment 0 on the per-step path and a Newton refresh, and
    the segment's bounds (duq, dlq)."""
    n = args[0].shape[-1]
    _, _, du, dl, s0 = pmpc._horizon(*args, st, 0, None)
    s1 = pmpc._steps_slot_solve(s0, du[:, :SEG3], dl[:, :SEG3], st, n,
                                STEPS)[0]
    return (slot.newton_refresh(s1), du[:, SEG3:2 * SEG3].contiguous(),
            dl[:, SEG3:2 * SEG3].contiguous())


def k3_edges(gen, st):
    """B3's horizon body against its 128-thread body, both from the one
    library, at each shape of K3_EDGES: config 3's generator at S3 lanes,
    its warm segment 1, bit for bit and timed in turns.  (ok, records)."""
    out = []
    for n, m, nact in K3_EDGES:
        d = config3(gen, n=n, m=m, nact=nact)
        a = [torch.as_tensor(d[k], device="cuda")
             for k in ('H', 'A', 'f_seq', 'bu_seq', 'bl_seq')]
        s1, duq, dlq = mpc_warm_segment(a, st)
        fns = {b: (lambda b=b: slot.run_mpc_segment(
            s1, duq, dlq, st, n, steps=STEPS, body=b))
            for b in ("horizon", "block")}
        dig = {}
        for b, fn in fns.items():
            o = fn()
            dig[b] = digest(*o[0], *o[1:])
        t = in_turns(fns["horizon"], fns["block"], SEG_REPS)
        out.append(dict(n=n, m=m, K=s1.E.shape[1], digest=dig["horizon"],
                        equals_block_body=dig["horizon"] == dig["block"],
                        ms_horizon=t["first"], ms_block=t["second"]))
        del a, s1, duq, dlq, fns
    return all(e["equals_block_body"] for e in out), out


def phase_k3(args, st, gen):
    """B3 against its twin over the second 10-step segment of all S3
    lanes, from the warm state after segment 0 of the config-3 run; the
    body config 3 takes (``smem.mpc_horizon``: the horizon body) bit for
    bit the 128-thread body on the same segment, both from the one
    library, and timed in turns with it; the same at K3_EDGES
    (``k3_edges``).

    Per-step flags and ``failed`` must agree on K2_AGREE of the lanes.
    u is held against the exact f64 u on each side's own working set: in
    a warm segment E takes ~36 f32 rank-one updates with no refresh (the
    reference refreshes once per segment), and both sides drift from the
    exact u well beyond one cold round's ~1e-3.  So per lane the kernel's
    distance to the exact u may be at most twice the twin's plus K2's
    gate; the kernel-twin gap and the working-set agreement are printed
    beside it."""
    t0 = time.perf_counter()
    s1, duq, dlq = mpc_warm_segment(args, st)

    def kernel():
        return slot.run_mpc_segment(s1, duq, dlq, st, N, steps=STEPS)

    def block():
        return slot.run_mpc_segment(s1, duq, dlq, st, N, steps=STEPS,
                                    body="block")

    def plain():
        return slot.run_mpc_segment_plain(s1, duq, dlq, st, N, steps=STEPS)

    sk, uk, fvk, itk, stk, fk = kernel()
    sb = block()
    out_digest = digest(*sk, uk, fvk, itk, stk, fk)
    block_digest = digest(*sb[0], *sb[1:])
    del sb
    sp, up, _, _, stp, fp = plain()
    flags_agree = (stk == stp).all(1) & (fk == fp)
    agree = flags_agree & (sk.act_up == sp.act_up).all(1) \
        & (sk.act_lo == sp.act_lo).all(1)
    opt = agree & (stk == dt.EXIT_OPTIMAL).all(1)
    uscale = 1.0 + up.abs().amax((1, 2))[opt]
    du_l = (uk - up).abs().amax((1, 2))[opt]
    du_rel = gmax((du_l / uscale).cpu().numpy())
    du_max = gmax(du_l.cpu().numpy())
    rate = flags_agree.float().mean().item()
    ex_k, ex_p = exact_gap(s1.M, sk, sp, opt)
    u_ok = bool((ex_k <= 2.0 * ex_p + K2_DU * uscale.cpu().numpy()).all())
    ms = cuda_ms(kernel, SEG_REPS)
    plain_ms = cuda_ms(plain, 1)
    vs_block = in_turns(kernel, block, SEG_REPS)
    edges_ok, edges = k3_edges(gen, st)
    # steps a lane ran: every horizon step up to and including the one it
    # froze in (a frozen lane repeats its last record)
    trouble = (stk == dt.EXIT_RUNNING) | (stk == dt.EXIT_CYCLE) \
        | (stk == dt.EXIT_REFACTOR)
    live = torch.cumsum(trouble.int(), 1) - trouble.int() == 0
    K = N + 1
    steps_done = (itk * live).sum().item()
    bnd = bound(state_bytes(s1, slot.SEG_CONST + slot.STATE)
                + nbytes(duq, dlq) + state_bytes(sk, slot.STATE)
                + nbytes(uk, fvk, itk, stk, fk),
                steps_done * step_flops(M_ROWS, N, K)
                + live.sum().item() * prefix_flops(N, K))
    body = HORIZON_BODY if smem.mpc_horizon(M_ROWS, N, K) else BLOCK_BODY
    emit("k3", t0, S=S3, P=SEG3, n=N, m=M_ROWS, K=K, body=body,
         steps=STEPS, block_digest=block_digest,
         equals_block_body=out_digest == block_digest,
         ms_in_turns_with_block={"body": vs_block["first"],
                                 "block": vs_block["second"]},
         edges=edges,
         flags_agree_rate=rate,
         working_set_agree_rate=agree.float().mean().item(),
         optimal_agreeing=int(opt.sum()), failed_kernel=int((fk > 0).sum()),
         du_inf=du_max, du_rel=du_rel, kernel_vs_exact=gmax(ex_k),
         twin_vs_exact=gmax(ex_p), kernel_within_twin_drift=u_ok,
         out_digest=out_digest,
         steps_done=steps_done, ms=ms, plain_ms=plain_ms, **bnd)
    ok = rate >= K2_AGREE and u_ok and out_digest == block_digest \
        and edges_ok
    return ok, dict(max_abs_err=du_max, ms=ms, plain_ms=plain_ms,
                    library_ms=None, bound_ms=bnd["bound_ms"],
                    bound_by=bnd["bound_by"])


def oracle_grid(oracle, d3, x, lanes, steps=None):
    """||x[s, t] - x_ref||_2 and the f64 oracle's exit flag at each step
    t of ``steps`` of each scenario s of ``lanes`` (arrays (lanes,
    steps)), or with no ``steps`` at t = s mod T3 alone (arrays
    (lanes,))."""
    lanes = list(lanes)
    ts = [[s % T3] for s in lanes] if steps is None \
        else [list(steps)] * len(lanes)
    err = np.zeros((len(lanes), len(ts[0]) if ts else 0))
    flags = np.zeros(err.shape, np.int64)
    for i, s in enumerate(lanes):
        for j, t in enumerate(ts[i]):
            ref = oracle.quadprog(*(v.astype(np.float64) for v in (
                d3['H'], d3['f_seq'][s, t], d3['A'], d3['bu_seq'][s, t],
                d3['bl_seq'][s, t])))
            flags[i, j] = ref['exitflag']
            err[i, j] = np.linalg.norm(x[s, t].astype(np.float64)
                                       - ref['x'])
    return (err, flags) if steps is not None else (err[:, 0], flags[:, 0])


def phase_mpc(args, d3, st, card):
    """Config 3 through the fused horizon, against the f64 oracle on the
    pairs (s, t = s mod T3)."""
    t0 = time.perf_counter()
    oracle = load("daqp_oracle", "oracle/daqp_numpy.py")

    def solve():
        return dt.solve_mpc_scan_kernel_fused(*args, st, seg=SEG3,
                                              steps=STEPS)

    reset_counts()
    out = solve()
    torch.cuda.synchronize()
    launches = read_counts()
    syncs, redone = ops.host_syncs, pmpc.redone_segments
    x = out.x.cpu().numpy()
    flags = out.exitflag.cpu().numpy()
    iters = out.iterations.cpu().numpy()
    t_or = time.perf_counter()
    # the margin: every step of the first MARGIN_LANES scenarios; the
    # gate's pairs (s, s mod T3) past them
    grid, grid_flags = oracle_grid(oracle, d3, x, range(MARGIN_LANES),
                                   range(T3))
    err, ref_flags = oracle_grid(oracle, d3, x, range(MARGIN_LANES, S3))
    lanes = np.arange(MARGIN_LANES)
    err = np.concatenate([grid[lanes, lanes % T3], err])
    ref_flags = np.concatenate([grid_flags[lanes, lanes % T3], ref_flags])
    one = flags[:MARGIN_LANES] == 1
    oracle_s = time.perf_counter() - t_or
    fl = flags[np.arange(S3), np.arange(S3) % T3]
    acc = float(np.mean((fl == 1) & (err <= MPC_TOL)))
    silent = int(np.sum((fl == 1) & (err > MPC_TOL)))
    best = best_window(solve)
    shape_ok = x.shape == (S3, T3, N) and bool(np.isfinite(x).all())
    emit("mpc", t0, S=S3, T=T3, n=N, m=M_ROWS, seg=SEG3, steps=STEPS,
         launches=launches, host_syncs=syncs, redone_segments=redone,
         shape_finite_ok=shape_ok, accuracy_pass_rate=acc,
         within_1e4=float(np.mean((fl == 1) & (err <= 1e-4))),
         silent_wrong=silent, max_err_optimal=float(err[fl == 1].max())
         if (fl == 1).any() else None,
         oracle_optimal=int(np.sum(np.asarray(ref_flags) == 1)),
         margin=dict(lanes=MARGIN_LANES, steps=T3,
                     max_err_flag1=float(grid[one].max()) if one.any()
                     else None, flag1_steps=int(one.sum()),
                     flag1_past_gate=int((one & (grid > MPC_TOL)).sum()),
                     flag1_past_1e3=int((one & (grid > 1e-3)).sum())),
         optimal_rate=float(np.mean(flags == 1)),
         mean_warm_iters=float(iters[:, 1:].mean()),
         qp_steps_per_s=3 * S3 * T3 / best, window_s=best,
         oracle_s=oracle_s, card=card)
    ok = shape_ok and acc >= ACC_RATE and silent == 0 \
        and launches["mpc_segment"] >= 1 and launches["slot_round"] >= 1
    return ok, launches


def config4():
    """bench_extra.py:105-113: rank-deficient semidefinite H."""
    rng = np.random.default_rng(SEED4)
    Q = rng.standard_normal((B4, N, RANK4)).astype(np.float32)
    H = np.einsum('bir,bjr->bij', Q, Q)
    f = rng.standard_normal((B4, N)).astype(np.float32)
    A = rng.standard_normal((B4, M_ROWS, N)).astype(np.float32)
    bu = (5 + 5 * rng.random((B4, M_ROWS))).astype(np.float32)
    bl = -(5 + 5 * rng.random((B4, M_ROWS))).astype(np.float32)
    return dict(H=H, f=f, A=A, bupper=bu, blower=bl,
                sense=np.zeros((B4, M_ROWS), np.int32))


def prox_cold_segment(args, st):
    """The inputs (state, carries, operands) of a B4 segment from the
    cold config-4 state, as ``solve_batch_prox_kernel`` starts it."""
    Rinv, okl, _, eps, tst, s0, bu_s, bl_s = pbatch.prox_init(*args[:6],
                                                              st)
    Bk, n = args[1].shape
    dev = Rinv.device
    carry = (torch.zeros((Bk, n), device=dev), okl.float(),
             torch.zeros(Bk, device=dev),
             torch.full((Bk,), float("inf"), device=dev),
             torch.where(okl, dt.EXIT_RUNNING, -5).to(torch.int32),
             torch.zeros(Bk, device=dev))
    return s0, carry, (Rinv, args[1], bu_s, bl_s, eps, tst)


def prox_main_path_segments(args, st):
    """The inputs (state, carries, operands) of every B4 launch of one
    ``solve_batch_prox_kernel`` call on ``args``."""
    seen = []
    launch = slot.run_prox_segment
    nl = len(slot.PROX_LANE)

    def spy(s, *a, **k):
        seen.append((s, tuple(a[:nl]), tuple(a[nl:nl + 6])))
        return launch(s, *a, **k)

    slot.run_prox_segment = spy
    try:
        dt.solve_batch_prox_kernel(*args, st)
    finally:
        slot.run_prox_segment = launch
    return seen


def prox_bound(s, carry, ops_, out, n):
    """The bound of one B4 launch from (s, carry) to ``out``: every lane's
    state and carries read once and its outputs written once, and a live
    lane's (lane_run > 0) constants and operands read once too (a stopped
    lane only copies its state and carries), or the slot steps the lanes
    ran (tot's increase) and, per live lane, one prefix, the three
    products and M v at the f32 peak."""
    K = n + 1
    steps = (out[6] - carry[5]).sum().item()
    live = carry[1] > 0
    return bound(state_bytes(s, slot.STATE) + nbytes(*carry)
                 + state_bytes(out[0], slot.STATE) + nbytes(*out[1:])
                 + live.float().mean().item()
                 * (state_bytes(s, slot.SEG_CONST) + nbytes(*ops_)),
                 steps * step_flops(M_ROWS, n, K)
                 + live.sum().item() * (4 * n * n + 2 * M_ROWS * n
                                        + prefix_flops(n, K)))


def phase_k4(args, st):
    """B4 against its twin over one PSEG-pass segment from the cold
    config-4 state: lflag, lane_run and failed agree on K2_AGREE of the
    lanes, ||dx||_inf <= 1e-3 (1 + ||x||_inf) on those.  x = Rinv (u - v)
    carries u's f32 drift times ||Rinv||_inf, printed beside it.  The
    main path's last B4 launch (its tail: the lanes still running after
    the others finished) is timed beside it, with its bound."""
    t0 = time.perf_counter()
    s0, carry, ops_ = prox_cold_segment(args, st)
    Rinv = ops_[0]
    Bk, n = args[1].shape

    def kernel():
        return slot.run_prox_segment(s0, *carry, *ops_, st, n,
                                     P=pbatch.PSEG, steps=pbatch.PROX_STEPS)

    def plain():
        return slot.run_prox_segment_plain(s0, *carry, *ops_, st, n,
                                           P=pbatch.PSEG,
                                           steps=pbatch.PROX_STEPS)

    ko, po = kernel(), plain()
    agree = (ko[5] == po[5]) & (ko[2] == po[2]) & (ko[7] == po[7])
    xk, xp = ko[1][agree], po[1][agree]
    dx = (xk - xp).abs().amax(1)
    du = (ko[0].u - po[0].u).abs().amax(1)[agree]
    uscale = 1.0 + po[0].u.abs().amax(1)[agree]
    rnorm = Rinv.abs().sum(2).amax(1)[agree]
    dx_rel_x = (dx / (1.0 + xp.abs().amax(1))).max().item()
    dx_rel = (dx / (uscale * rnorm)).max().item()
    du_rel = (du / uscale).max().item()
    rate = agree.float().mean().item()
    opt = agree & (ko[0].status == dt.EXIT_OPTIMAL) \
        & (po[0].status == dt.EXIT_OPTIMAL)
    ex_k, ex_p = map(gmax, exact_gap(s0.M, ko[0], po[0], opt))
    ms = cuda_ms(kernel, SEG_REPS)
    plain_ms = cuda_ms(plain, 1)
    K = n + 1
    steps_done = ko[6].sum().item()
    bnd = prox_bound(s0, carry, ops_, ko, n)
    s_t, c_t, o_t = prox_main_path_segments(args, st)[-1]

    def tail():
        return slot.run_prox_segment(s_t, *c_t, *o_t, st, n, P=pbatch.PSEG,
                                     steps=pbatch.PROX_STEPS)

    out_t = tail()
    tail_steps = out_t[6] - c_t[5]
    tail_bnd = prox_bound(s_t, c_t, o_t, out_t, n)
    tail_ms = cuda_ms(tail, SEG_REPS)
    emit("k4", t0, B=Bk, P=pbatch.PSEG, n=n, m=M_ROWS, K=K,
         steps=pbatch.PROX_STEPS,
         agree_rate=rate, lanes_done_kernel=int((ko[2] == 0).sum()),
         failed_kernel=int((ko[7] > 0).sum()), dx_inf=dx.max().item(),
         dx_rel_x=dx_rel_x, dx_rel_x_tol=K2_DU, dx_rel_rinv=dx_rel,
         du_rel=du_rel, kernel_vs_exact_u=ex_k, twin_vs_exact_u=ex_p,
         out_digest=digest(*ko[0], *ko[1:]),
         steps_done=steps_done, max_lane_steps=ko[6].max().item(), ms=ms,
         plain_ms=plain_ms, **bnd,
         tail=dict(live_lanes=int((c_t[1] > 0).sum()),
                   steps=tail_steps.sum().item(),
                   max_lane_steps=tail_steps.max().item(), ms=tail_ms,
                   out_digest=digest(*out_t[0], *out_t[1:]), **tail_bnd))
    ok = rate >= K2_AGREE and dx_rel_x <= K2_DU
    return ok, dict(max_abs_err=dx.max().item(), ms=ms, plain_ms=plain_ms,
                    library_ms=None, bound_ms=bnd["bound_ms"],
                    bound_by=bnd["bound_by"], tail_ms=tail_ms,
                    tail_bound_ms=tail_bnd["bound_ms"],
                    tail_bound_by=tail_bnd["bound_by"])


def phase_prox(args, st, card):
    """Config 4 through the fused proximal driver, held to the f64 KKT
    certificate of its own (x, lam); K1 timed at this shape with its
    retries."""
    t0 = time.perf_counter()

    def solve():
        return dt.solve_batch_prox_kernel(*args, st)

    reset_counts()
    r = solve()
    torch.cuda.synchronize()
    launches = read_counts()
    syncs, resumed = ops.host_syncs, pbatch.prox_resumed_lanes
    flags = r.exitflag.cpu().numpy()
    stat, viol = dt.kkt_residuals(*args, r.x, r.lam)
    opt = flags == 1
    silent = int(np.sum(opt & ((stat > KKT_TOL) | (viol > KKT_TOL))))
    best = best_window(solve)
    c0 = chol.launches
    chol.batched_rinv_regularized(args[0], st)
    k1_per_call = chol.launches - c0
    k1_ms = cuda_ms(lambda: chol.batched_rinv_regularized(args[0], st), 5)
    x = r.x.cpu().numpy()
    shape_ok = x.shape == (B4, N) and bool(np.isfinite(x).all())
    emit("prox", t0, B=B4, n=N, m=M_ROWS, rank=RANK4, launches=launches,
         host_syncs=syncs, resumed_lanes=resumed, shape_finite_ok=shape_ok,
         optimal_rate=float(opt.mean()),
         flags={int(k): int(v) for k, v in zip(*np.unique(
             flags, return_counts=True))},
         max_stationarity=float(stat[opt].max()) if opt.any() else None,
         max_violation=float(viol[opt].max()) if opt.any() else None,
         silent_wrong=silent, b4_segments=launches["prox_segment"],
         median_inner_iters=float(np.median(r.iterations.cpu().numpy())),
         k1_launches_per_factorization=k1_per_call,
         k1_regularized_ms=k1_ms, solves_per_s=3 * B4 / best,
         window_s=best, card=card)
    ok = shape_ok and opt.mean() >= PROX_OPT and silent == 0 \
        and all(launches[k] >= 1 for k in ("chol_rinv", "slot_round",
                                            "prox_segment"))
    return ok, launches, dict(ms_config4=k1_ms,
                              launches_per_config4_factorization=k1_per_call)


def config4b():
    """bench_extra.py:152-168: level 1 conflicts in every lane (row 1
    duplicates row 0 with a disjoint band); H = None, f = 0."""
    rng = np.random.default_rng(SEED4B)
    m = BP4B[-1]
    A = rng.standard_normal((B4B, m, N4B)).astype(np.float32)
    x0 = rng.standard_normal((B4B, N4B)).astype(np.float32)
    b0 = np.einsum('bmn,bn->bm', A, x0)
    bu = (b0 + 0.2 * rng.random((B4B, m))).astype(np.float32)
    bl = (b0 - 1.2 - 0.5 * rng.random((B4B, m))).astype(np.float32)
    A[:, 1] = A[:, 0]
    bu[:, 0] = b0[:, 0] - 1.0
    bl[:, 0] = b0[:, 0] - 2.0
    bl[:, 1] = b0[:, 1] + 1.0
    bu[:, 1] = b0[:, 1] + 2.0
    return dict(f=np.zeros((B4B, N4B), np.float32), A=A, bupper=bu,
                blower=bl, sense=np.zeros((B4B, m), np.int32))


def level1_state(args4b, st):
    """The dense state of config 4b's first level as the hierarchical walk
    starts it: rows of level 1 SOFT, later rows IMMUTABLE, rho floored."""
    f, A, bu, bl, sense = args4b
    Bk, m, n = A.shape
    st4 = pbatch.hiqp_settings(st)
    eye = torch.eye(n, device=A.device).expand(Bk, n, n)
    ldpd = transform.build_ldp(f, A, bu, bl, sense, 0, st4, H=eye)
    rows = torch.arange(m, device=A.device)
    immut = ((ldpd.sense & dt.IMMUTABLE) > 0).float()
    immut = torch.clamp(immut + (rows >= BP4B[1]).float(), max=1.0)
    soft = (rows < BP4B[1]).float().expand(Bk, m)
    return dense.dense_init(ldpd.M, ldpd.dupper, ldpd.dlower, ldpd.scaling,
                            immut, soft), st4


def dense_state(args, st, sw=None):
    """The cold dense state of config-2 lanes, soft where ``args``'s sense
    says SOFT, with SOFT_WEIGHTS data ``sw`` (raw units) if given."""
    Rinv, _, _, _ = chol.batched_rinv_regularized(args[0], st)
    ldpd = transform.build_ldp(*args[1:], 0, st, Rinv=Rinv)
    immut = ((ldpd.sense & dt.IMMUTABLE) > 0).float()
    soft = ((ldpd.sense & dt.SOFT) > 0).float()
    return dense.dense_init(ldpd.M, ldpd.dupper, ldpd.dlower, ldpd.scaling,
                            immut, soft, sw=None if sw is None
                            else transform.normalize_soft_weights(sw, ldpd))


def sw_weights(Bn, m):
    """SOFT_WEIGHTS data for config 2's soft rows 0-19, drawn as
    tests/test_pallas_sw.py:40-43 draws it (d = d_scale U, rho = rho_lo +
    U): even lanes d_scale 0.4, rho_lo 0.5 (slacks mostly FREE), odd lanes
    1.5 and 2.0 (mostly FIXED); hard rows d = 0, rho = 1.  f32 numpy."""
    rng = np.random.default_rng(SW_SEED)
    even = (np.arange(Bn) % 2 == 0)[:, None]
    d_scale = np.where(even, 0.4, 1.5)
    rho_lo = np.where(even, 0.5, 2.0)
    out = {}
    for key in SW_KEYS:
        full = np.zeros((Bn, m)) if key.startswith("d") else np.ones((Bn, m))
        u = rng.random((Bn, SOFT_ROWS))
        full[:, :SOFT_ROWS] = d_scale * u if key.startswith("d") \
            else rho_lo + u
        out[key] = full.astype(np.float32)
    return out


def sw_tensors(sw_np, dev, lanes=slice(None)):
    return dt.SoftWeights(*(torch.as_tensor(sw_np[k][lanes], device=dev)
                            for k in SW_KEYS))


def f64(x):
    return x.double() if torch.is_tensor(x) and x.is_floating_point() else x


def dense_agree(a, b):
    """Per lane: equal exit flags and working sets (act_up, act_lo, and
    sfix on SOFT_WEIGHTS states)."""
    agree = (a.status == b.status) & (a.act_up == b.act_up).all(1) \
        & (a.act_lo == b.act_lo).all(1)
    if a.sfix is not None:
        agree = agree & (a.sfix == b.sfix).all(1)
    return agree


def k7_case(s0, st, n, has_soft=True):
    """One B7 round against its twin from ``s0``: exit flags and working
    sets (act_up, act_lo, and on a SOFT_WEIGHTS state sfix) agree on
    K2_AGREE of the lanes, ||du||_inf <= K2_DU (1 + ||u||_inf) on agreeing
    optimal lanes (flag 1 or 2), and the kernel leaves E zero off the
    active block on every lane, as the next round's walk needs.

    On a SOFT_WEIGHTS state the f32 twin itself parts from the same twin
    in f64 on more lanes than K2_AGREE allows (slack transitions decided
    at f32 ties over ~115 steps), so there the agreement must reach
    1 - 2 (1 - the twin's own agreement with f64), if that is lower."""
    sk = dense.run_kernel_round(s0, st, n, STEPS, has_soft=has_soft)
    sp = dense.run_kernel_round_plain(s0, st, n, STEPS, has_soft=has_soft)
    agree = dense_agree(sk, sp)
    has_sw = s0.sw_dls is not None
    agree_gate, twin_f64, cyc = K2_AGREE, None, {}
    cyc_k, cyc_p = sk.status == dt.EXIT_CYCLE, sp.status == dt.EXIT_CYCLE
    if has_sw:
        s64 = dense.run_kernel_round_plain(dense.map_state(f64, s0), st, n,
                                           STEPS)
        twin_f64 = dense_agree(sp, s64).float().mean().item()
        agree_gate = min(K2_AGREE, 1.0 - 2.0 * (1.0 - twin_f64))
        cyc_64 = s64.status == dt.EXIT_CYCLE
        cyc = dict(cycle_twin_f64=int(cyc_64.sum()),
                   cycle_kernel_and_twin=int((cyc_k & cyc_p).sum()),
                   cycle_kernel_and_f64=int((cyc_k & cyc_64).sum()),
                   cycle_twin_and_f64=int((cyc_p & cyc_64).sum()))
    opt = agree & (sk.status > 0) & (sk.status <= dt.EXIT_SOFT_OPTIMAL)
    du = (sk.u - sp.u).abs().amax(1)[opt]
    du_rel = gmax((du / (1.0 + sp.u.abs().amax(1)[opt])).cpu().numpy())
    ms = cuda_ms(lambda: dense.run_kernel_round(s0, st, n, STEPS,
                                                has_soft=has_soft), 5)
    plain_ms = cuda_ms(lambda: dense.run_kernel_round_plain(
        s0, st, n, STEPS, has_soft=has_soft), 1)
    Bk, m, _ = s0.M.shape
    steps_done = (sk.iterations - s0.iterations).sum().item()
    sw_in = dense.SW_CONST + dense.SW_STATE if has_sw else ()
    sw_out = dense.SW_STATE if has_sw else ()
    bnd = bound(state_bytes(s0, dense.CONST + dense.STATE + sw_in)
                + state_bytes(sk, dense.STATE + sw_out),
                dense_round_flops(s0, sk, n))
    off_block = off_block_lanes(sk)
    flags = {int(k): int(v) for k, v in zip(
        *torch.unique(sk.status, return_counts=True))}
    rate = agree.float().mean().item()
    out = dict(B=Bk, m=m, n=n, steps=STEPS, has_soft=has_soft,
               has_sw=has_sw, agree_rate=rate,
               agree_gate=agree_gate, twin_agree_with_f64_twin=twin_f64,
               cycle_kernel=int(cyc_k.sum()), cycle_twin=int(cyc_p.sum()),
               **cyc,
               optimal_agreeing=int(opt.sum()),
               du_inf=gmax(du.cpu().numpy()), du_rel=du_rel,
               du_rel_tol=K2_DU, kernel_flags=flags, steps_done=steps_done,
               e_off_block_lanes=off_block, ms=ms, plain_ms=plain_ms, **bnd)
    return rate >= agree_gate and du_rel <= K2_DU and off_block == 0, out


def first_chunk(full, st):
    """The lanes of the first B_CHUNK-lane chunk of
    ``solve_batch_kernel_stream(sort_stream=True)`` on ``full``: the
    stream's difficulty order over the whole batch."""
    Rinv = chol.batched_rinv_regularized(full[0], st)[0]
    nv = pbatch._difficulty_nviol(*full[1:5], 0, Rinv)
    return torch.argsort(nv, stable=True)[:B_CHUNK]


def edge_m(floats, dev):
    """The largest m whose block, of ``floats(m)`` floats, fits the
    card's shared memory."""
    m = M_ROWS
    while smem.F32 * floats(m + 1) <= smem.available(dev):
        m += 1
    return m


def slot_edge_m(dev):
    """K2's edge at n = N (``smem.slot_floats``)."""
    return edge_m(lambda m: smem.slot_floats(m, N, N + 1), dev)


def dense_edge_m(sw, dev):
    """B7's edge at n = N, the plain/soft or the SOFT_WEIGHTS layout."""
    return edge_m(lambda m: smem.dense_floats(m, N, sw), dev)


def edge_lanes(m, dev):
    """B_EDGE random feasible LDP lanes at n = N with m rows (f32 on
    ``dev``): M standard normal / sqrt(n), the box [M x0 - 0.2 - 0.8 U,
    M x0 + 0.2 + 0.8 U] around a point x0 ~ N(0, 0.25 I), seed SEED + m;
    (M, du, dl)."""
    g = np.random.default_rng(SEED + m)
    M = g.standard_normal((B_EDGE, m, N)) / np.sqrt(N)
    b0 = np.einsum("bmn,bn->bm", M, 0.5 * g.standard_normal((B_EDGE, N)))
    du = b0 + 0.2 + 0.8 * g.random((B_EDGE, m))
    dl = b0 - 0.2 - 0.8 * g.random((B_EDGE, m))
    return tuple(torch.as_tensor(x, dtype=torch.float32, device=dev)
                 for x in (M, du, dl))


def edge_state(m, sw, dev):
    """B_EDGE random feasible LDP lanes at n = N with m rows: M standard
    normal / sqrt(n), the box [M x0 - 0.2 - 0.8 U, M x0 + 0.2 + 0.8 U]
    around a point x0 ~ N(0, 0.25 I) (seed SEED + m), rows 0-19 soft and,
    if ``sw``, sw_weights' SOFT_WEIGHTS data on them."""
    M, du, dl = edge_lanes(m, dev)
    one = torch.ones((B_EDGE, m), device=dev)
    soft = (torch.arange(m, device=dev) < SOFT_ROWS).float()
    w = sw_weights(B_EDGE, m) if sw else None
    return dense.dense_init(
        M, du, dl, one, 0.0 * one, soft.expand(B_EDGE, m)
        .contiguous(), sw=None if w is None else sw_tensors(w, dev))


def phase_k7(args_soft, args_hard, args4b, sw_k, chunk, st):
    """B7 against its twin: (a) one cold round on the first B_K2 config-2
    lanes with rows 0-19 SOFT; (b) config 4b's first level, rho 3e-2;
    (c) the kernel's plain variant (has_soft False) on the same config-2
    lanes with every row hard; (d) the SOFT_WEIGHTS variant on the lanes
    of (a) with the sw phase's weights ``sw_k``; (e) the first 256-lane
    chunk of the soft and sw streams, ``chunk`` = (its soft args, its sw
    weights), the kernel's launch shape there; (f) B_EDGE random lanes
    at the largest m whose block fits, in the soft and the SOFT_WEIGHTS
    variant."""
    t0 = time.perf_counter()
    dev = args_soft[0].device
    ok_a, a = k7_case(dense_state(args_soft, st), st, N)
    s4, st4 = level1_state(args4b, st)
    ok_b, b = k7_case(s4, st4, N4B)
    ok_c, c = k7_case(dense_state(args_hard, st), st, N, has_soft=False)
    ok_d, sw = k7_case(dense_state(args_soft, st, sw_k), st, N)
    ok_e, e = k7_case(dense_state(chunk[0], st), st, N)
    ok_esw, esw = k7_case(dense_state(chunk[0], st, chunk[1]), st, N)
    ok_f, f = k7_case(edge_state(dense_edge_m(False, dev), False, dev), st,
                      N)
    ok_fsw, fsw = k7_case(edge_state(dense_edge_m(True, dev), True, dev),
                          st, N)
    emit("k7", t0, config2_soft=a, config4b_level1=b, config2_hard=c,
         config2_sw=sw, chunk256_soft=e, chunk256_sw=esw, edge_soft=f,
         edge_sw=fsw)
    ok = ok_a and ok_b and ok_c and ok_d and ok_e and ok_esw and ok_f \
        and ok_fsw
    return ok, dict(
        max_abs_err=max(a["du_inf"], b["du_inf"], sw["du_inf"]), ms=a["ms"],
        plain_ms=a["plain_ms"], library_ms=None, bound_ms=a["bound_ms"],
        bound_by=a["bound_by"], ms_config4b=b["ms"],
        plain_ms_config4b=b["plain_ms"], bound_ms_config4b=b["bound_ms"],
        ms_sw=sw["ms"], plain_ms_sw=sw["plain_ms"],
        bound_ms_sw=sw["bound_ms"], bound_by_sw=sw["bound_by"],
        max_abs_err_sw=sw["du_inf"], ms_b256=e["ms"],
        plain_ms_b256=e["plain_ms"], bound_ms_b256=e["bound_ms"],
        ms_sw_b256=esw["ms"], plain_ms_sw_b256=esw["plain_ms"],
        bound_ms_sw_b256=esw["bound_ms"], m_edge=f["m"],
        m_edge_sw=fsw["m"])


def soft_sense(sense):
    out = sense.clone()
    out[:, :SOFT_ROWS] |= dt.SOFT
    return out


def phase_soft(full, d, st, card):
    """Config 2 with rows 0-19 SOFT through the dense stream, against the
    f64 oracle with the port's rho_soft and tolerances on every
    SOFT_STRIDE-th lane."""
    t0 = time.perf_counter()
    oracle = load("daqp_oracle", "oracle/daqp_numpy.py")
    args = full[:5] + [soft_sense(full[5])]

    def solve():
        return dt.solve_batch_kernel_stream(*args, st=st, ms=0, chunk=256,
                                            has_soft=True, sort_stream=True)

    reset_counts()
    r = solve()
    torch.cuda.synchronize()
    launches = read_counts()
    syncs = ops.host_syncs
    x = r.x.cpu().numpy()
    flags = r.exitflag.cpu().numpy()
    sense = args[5].cpu().numpy()
    keys = ('H', 'f', 'A', 'bupper', 'blower')
    idx = np.arange(0, B, SOFT_STRIDE)
    t_or = time.perf_counter()
    err, ref_flags = [], []
    for b in idx:
        ref = oracle.quadprog(*(d[k][b].astype(np.float64) for k in keys),
                              sense[b], 0,
                              {"rho_soft": float(st.rho_soft),
                               "primal_tol": float(st.primal_tol),
                               "dual_tol": float(st.dual_tol)})
        ref_flags.append(ref['exitflag'])
        err.append(np.linalg.norm(x[b].astype(np.float64) - ref['x']))
    oracle_s = time.perf_counter() - t_or
    err, ref_flags, fl = np.asarray(err), np.asarray(ref_flags), flags[idx]
    both = (fl > 0) & (ref_flags > 0)
    acc = float(np.mean(both & (err <= ACC_TOL)))
    silent = int(np.sum(((fl == 1) | (fl == 2)) & (err > ACC_TOL)))
    opt_rate = float(np.mean(flags > 0))
    best = best_window(solve)
    shape_ok = x.shape == (B, N) and r.lam.shape == (B, M_ROWS) \
        and bool(np.isfinite(x).all())
    emit("soft", t0, B=B, n=N, m=M_ROWS, soft_rows=SOFT_ROWS, chunk=256,
         sort_stream=True, launches=launches, host_syncs=syncs,
         shape_finite_ok=shape_ok, sample=len(idx),
         sample_both_positive=bool(both.all()), accuracy_pass_rate=acc,
         silent_wrong=silent, max_err_sample=float(err.max()),
         optimal_rate=opt_rate,
         soft_optimal=int(np.sum(flags == dt.EXIT_SOFT_OPTIMAL)),
         flags={int(k): int(v) for k, v in zip(*np.unique(
             flags, return_counts=True))},
         median_iters=float(np.median(r.iterations.cpu().numpy())),
         solves_per_s=3 * B / best, window_s=best, oracle_s=oracle_s,
         card=card)
    ok = shape_ok and bool(both.all()) and acc >= ACC_RATE and silent == 0 \
        and opt_rate >= ACC_RATE and launches["chol_rinv"] >= 1 \
        and launches["dense_round"] >= 1
    return ok, launches


def hiqp_reference(d4b, st):
    """The f64 hierarchical oracle on every lane of config 4b at the
    tier's rho (the matched-rho rule of tests/test_batch_hiqp.py:51-52):
    (flags, x)."""
    hq = oracle_module("hiqp_numpy")
    flags, xs = [], []
    for b in range(B4B):
        ref = hq.hiqp(None, d4b['f'][b].astype(np.float64),
                      d4b['A'][b].astype(np.float64),
                      d4b['bupper'][b].astype(np.float64),
                      d4b['blower'][b].astype(np.float64), d4b['sense'][b],
                      0, BP4B, {"rho_soft": HIQP_RHO,
                                "primal_tol": float(st.primal_tol),
                                "iter_limit": 3000})
        flags.append(ref['exitflag'])
        xs.append(ref['x'])
    return np.asarray(flags), np.stack(xs)


def hiqp_class(f):
    """A hierarchy's exit class: optimal (1, 2), no DOF left (3), loud."""
    return np.where((f == 1) | (f == 2), 0, np.where(f == 3, 1, 2))


def hiqp_counts(flags, x, ref_flags, ref_x):
    """(lanes whose flag class differs from the oracle's, lanes flagged 1
    or 2 beyond HIQP_TOL where the oracle is positive, flags legal)."""
    cls = hiqp_class
    err = np.abs(x.astype(np.float64) - ref_x).max(1)
    mism = ((flags == 1) | (flags == 2)) & (err > HIQP_TOL) & (ref_flags > 0)
    legal = np.isin(flags, (1, 2, 3)) | (flags < 0)
    return int(np.sum(cls(flags) != cls(ref_flags))), int(mism.sum()), \
        bool(legal.all()), err


# the tier backstops (lp, avi, hiqp): the batch's loud lanes plus every
# TIER_BACK_STRIDE-th lane forced loud as force_failures does
TIER_BACK_STRIDE = 16


def tier_backstop(res, resolve, gate_fn, *args, **kw):
    """``res`` with every TIER_BACK_STRIDE-th lane forced loud (ITERLIMIT,
    x zero), then ``resolve(res, *args, **kw)`` (a tier backstop):
    (ok, fields).  ``gate_fn(x, lanes)`` gives, per lane of ``lanes``,
    whether an x on the host lies within the phase's own gate.  Gates:
    every re-solved lane with a positive flag within the gate; the loud
    count after at most the count before; the flag-1 lanes beyond the
    gate after the backstop among those before it."""
    lanes = torch.arange(res.x.shape[0], device=res.x.device)
    forced = lanes % TIER_BACK_STRIDE == 0
    res = res._replace(
        x=torch.where(forced[:, None], 0.0, res.x).to(res.x.dtype),
        exitflag=torch.where(forced, dt.EXIT_ITERLIMIT, res.exitflag)
        .to(res.exitflag.dtype))
    flags0 = res.exitflag.cpu().numpy()
    x0 = res.x.cpu().numpy().astype(np.float64)
    all_lanes = np.arange(flags0.size)
    beyond0 = set(np.flatnonzero((flags0 == 1)
                                 & ~gate_fn(x0, all_lanes)).tolist())
    n0, s0 = pbatch.backstop_lanes, ops.host_syncs
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = resolve(res, *args, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    n_re = pbatch.backstop_lanes - n0
    flags1 = out.exitflag.cpu().numpy()
    x1 = out.x.cpu().numpy().astype(np.float64)
    moved = np.flatnonzero((flags1 != flags0) | (x1 != x0).any(1)
                           | np.isnan(x0).any(1))
    within = gate_fn(x1, all_lanes)
    bad = [int(b) for b in moved if flags1[b] > 0 and not within[b]]
    beyond1 = set(np.flatnonzero((flags1 == 1) & ~within).tolist())
    fields = dict(forced=int(forced.sum()), loud_before=loud(flags0),
                  loud_after=loud(flags1), resolved=n_re,
                  resolved_positive=int(np.sum(flags1[moved] > 0)),
                  resolved_beyond_gate=bad,
                  flag1_beyond_gate_before=sorted(beyond0),
                  flag1_beyond_gate_after=sorted(beyond1),
                  ms_per_resolved_lane=1e3 * secs / max(n_re, 1),
                  syncs_per_resolved_lane=(ops.host_syncs - s0)
                  / max(n_re, 1), on_card=out.x.is_cuda)
    ok = not bad and loud(flags1) <= loud(flags0) and beyond1 <= beyond0 \
        and n_re >= int(forced.sum()) and out.x.is_cuda
    return ok, fields


def phase_hiqp(args4b, d4b, st, card):
    """Config 4b through the hierarchical walk, against the f64 oracle on
    all lanes: no more class differences and mismatches than the JAX
    package's own plus HIQP_SLACK."""
    t0 = time.perf_counter()
    f, A, bu, bl, sense = args4b

    def solve():
        return dt.solve_batch_hiqp_kernel(None, f, A, bu, bl, sense, st,
                                          break_points=BP4B)

    reset_counts()
    r = solve()
    torch.cuda.synchronize()
    launches = read_counts()
    syncs = ops.host_syncs
    x = r.x.cpu().numpy()
    flags = r.exitflag.cpu().numpy()
    t_or = time.perf_counter()
    ref_flags, ref_x = hiqp_reference(d4b, st)
    oracle_s = time.perf_counter() - t_or
    diffs, mism, legal, err = hiqp_counts(flags, x, ref_flags, ref_x)
    best = best_window(solve, calls=4)
    # the same walk on the plain twins on the host: the spread of the
    # exit-3 count under another f32 rounding order
    rt = dt.solve_batch_hiqp_kernel(None, *(a.cpu() for a in args4b), st,
                                    break_points=BP4B)
    t_diffs, t_mism, _, _ = hiqp_counts(rt.exitflag.numpy(), rt.x.numpy(),
                                        ref_flags, ref_x)
    opt = (flags == 1) | (flags == 2)
    shape_ok = x.shape == (B4B, N4B) and bool(np.isfinite(x).all())
    # the tier's backstop: the f64 walk at the tier's rho, held to the
    # oracle at that rho where the oracle is optimal (hiqp_counts' rule)
    ok_back, back = tier_backstop(
        r, dt.backstop_resolve_hiqp, lambda xh, ls: (np.abs(
            xh[ls] - ref_x[ls]).max(1) <= HIQP_TOL)
        | ~np.isin(ref_flags[ls], (1, 2)),
        None, *args4b, break_points=BP4B,
        settings=pbatch.hiqp_settings(st))
    emit("hiqp", t0, B=B4B, n=N4B, break_points=BP4B, launches=launches,
         host_syncs=syncs, shape_finite_ok=shape_ok, flags_legal=legal,
         flags={int(k): int(v) for k, v in zip(*np.unique(
             flags, return_counts=True))},
         oracle_flags={int(k): int(v) for k, v in zip(*np.unique(
             ref_flags, return_counts=True))},
         exit3=int(np.sum(flags == dt.EXIT_NO_DOF)),
         class_diffs=diffs, class_agree_rate=1.0 - diffs / B4B,
         class_diffs_limit=HIQP_CLASS_LIMIT,
         mismatches=mism, mismatches_limit=JAX_HIQP_MISMATCHES + HIQP_SLACK,
         twin_on_host={"exit3": int(np.sum(rt.exitflag.numpy() == 3)),
                       "class_diffs": t_diffs, "mismatches": t_mism},
         max_err_optimal=float(err[opt].max()) if opt.any() else None,
         b7_launches_per_call=launches["dense_round"],
         solves_per_s=4 * B4B / best, window_s=best, oracle_s=oracle_s,
         backstop=back, card=card)
    ok = shape_ok and legal and diffs <= HIQP_CLASS_LIMIT \
        and mism <= JAX_HIQP_MISMATCHES + HIQP_SLACK \
        and launches["dense_round"] >= 1 and ok_back
    return ok, launches


def lifted_reference(oracle, d, sw_np, b):
    """Lane ``b`` of the sw phase as the lifted slack QP (the rewrite of
    tests/test_soft_weights.py:41 _lift_and_solve in NumPy): variables
    (x, t_u, t_l >= 0), a soft row's upper side a'x - sqrt(rho_us) t_u <=
    b_u with penalty 0.5 (t_u + d_us sqrt(rho_us))^2, its lower side
    likewise, solved in f64 by ``oracle/daqp_numpy.quadprog``: (x, flag)."""
    H, f, A = (d[k][b].astype(np.float64) for k in ('H', 'f', 'A'))
    bu, bl = d['bupper'][b].astype(np.float64), \
        d['blower'][b].astype(np.float64)
    d_ls, d_us, rho_ls, rho_us = (sw_np[k][b].astype(np.float64)
                                  for k in SW_KEYS)
    n, m, k = H.shape[0], A.shape[0], SOFT_ROWS
    nz = n + 2 * k
    Hz = np.eye(nz)
    Hz[:n, :n] = H
    su, sl = np.sqrt(rho_us[:k]), np.sqrt(rho_ls[:k])
    fz = np.concatenate([f, d_us[:k] * su, d_ls[:k] * sl])
    up = np.zeros((k, nz))
    up[:, :n] = A[:k]
    up[np.arange(k), n + np.arange(k)] = -su
    lo = np.zeros((k, nz))
    lo[:, :n] = A[:k]
    lo[np.arange(k), n + k + np.arange(k)] = sl
    hard = np.zeros((m - k, nz))
    hard[:, :n] = A[k:]
    slack = np.zeros((2 * k, nz))
    slack[:, n:] = np.eye(2 * k)
    inf = np.full(k, 1e30)
    rows = np.concatenate([up, lo, hard, slack])
    rub = np.concatenate([bu[:k], inf, bu[k:], np.full(2 * k, 1e30)])
    rlb = np.concatenate([-inf, bl[:k], bl[k:], np.zeros(2 * k)])
    ref = oracle.quadprog(Hz, fz, rows, rub, rlb, None, 0)
    return ref['x'][:n], ref['exitflag']


def slack_regimes(lam, sw_np):
    """Per lane, whether it ends with an active soft row whose slack is
    FIXED (its dual inside the slack bound) and one whose slack is FREE
    (beyond it): the state rule of auxiliary.c:30-36 on the returned
    duals, in raw units on both sides."""
    ls = lam[:, :SOFT_ROWS]
    d_us, d_ls = sw_np['d_us'][:, :SOFT_ROWS], sw_np['d_ls'][:, :SOFT_ROWS]
    up, lo = ls > 0, ls < 0
    fixed = (up & (ls < d_us)) | (lo & (-ls < d_ls))
    free = (up & (ls >= d_us)) | (lo & (-ls >= d_ls))
    return fixed.any(1), free.any(1)


def sw_f64(oracle, d, sw_np, lanes):
    """``lanes`` of the sw data through the port's dense tier in f64 on the
    CPU (the plain twins, f64 end to end): (flags, ||x - x_ref||_inf
    against the lifted slack QP)."""
    if not len(lanes):
        return np.zeros(0, np.int32), np.zeros(0)
    keys = ('H', 'f', 'A', 'bupper', 'blower')
    args = [torch.as_tensor(d[k][lanes]).double() for k in keys]
    sense = soft_sense(torch.as_tensor(d['sense'][lanes]))
    r = dt.solve_batch_kernel(*args, sense, dt.as_settings(
        {"iter_limit": 1000}, torch.float64), sw=dt.SoftWeights(
            *(torch.as_tensor(sw_np[k][lanes]).double() for k in SW_KEYS)),
        device="cpu")
    err = [np.abs(r.x[i].numpy() - lifted_reference(oracle, d, sw_np, b)[0])
           .max() for i, b in enumerate(lanes)]
    return r.exitflag.numpy(), np.asarray(err)


def phase_sw(full, d, sw_np, st, card):
    """Config 2 with rows 0-19 SOFT and SOFT_WEIGHTS data through the
    dense stream, against the lifted slack QP in f64 on every
    SW_STRIDE-th lane.  A sample lane loud on the card must be loud for
    the JAX package too (JAX_SW_LOUD_LANES), or be solved within SW_TOL by
    the port's dense tier in f64 (``sw_f64``), and there may be at most
    JAX_SW_LOUD such lanes."""
    t0 = time.perf_counter()
    oracle = oracle_module("daqp_numpy")
    args = full[:5] + [soft_sense(full[5])]
    sw = sw_tensors(sw_np, full[0].device)

    def solve():
        return dt.solve_batch_kernel_stream(*args, st=st, ms=0, chunk=256,
                                            has_soft=True, sort_stream=True,
                                            sw=sw)

    reset_counts()
    r = solve()
    torch.cuda.synchronize()
    launches = read_counts()
    syncs = ops.host_syncs
    x = r.x.cpu().numpy()
    flags = r.exitflag.cpu().numpy()
    idx = np.arange(0, B, SW_STRIDE) + np.arange(B // SW_STRIDE) % 2
    t_or = time.perf_counter()
    err, ref_flags = [], []
    for b in idx:
        xr, fr = lifted_reference(oracle, d, sw_np, b)
        ref_flags.append(fr)
        err.append(np.abs(x[b].astype(np.float64) - xr).max())
    err, ref_flags, fl = np.asarray(err), np.asarray(ref_flags), flags[idx]
    loud = idx[fl <= 0]
    w_flags, w_err = sw_f64(oracle, d, sw_np, loud)
    excess = ~np.isin(loud, JAX_SW_LOUD_LANES)
    witnessed = bool(((w_flags > 0) & (w_err <= SW_TOL))[excess].all())
    oracle_s = time.perf_counter() - t_or
    both = (fl > 0) & (ref_flags > 0)
    acc = float(np.mean(err[both] <= SW_TOL)) if both.any() else 0.0
    silent = int(np.sum((fl > 0) & (err > SW_TOL)))
    opt_rate = float(np.mean(flags > 0))
    fixed, free = slack_regimes(r.lam.cpu().numpy(), sw_np)
    best = best_window(solve)
    shape_ok = x.shape == (B, N) and r.lam.shape == (B, M_ROWS) \
        and bool(np.isfinite(x).all())
    emit("sw", t0, B=B, n=N, m=M_ROWS, soft_rows=SOFT_ROWS, chunk=256,
         sort_stream=True, launches=launches, host_syncs=syncs,
         shape_finite_ok=shape_ok, sample=len(idx),
         sample_oracle_positive=bool((ref_flags > 0).all()),
         sample_loud=int(np.sum(fl <= 0)), sample_loud_lanes={
             int(b): {"flag": int(flags[b]), "jax_loud": bool(not e),
                      "f64_flag": int(wf), "f64_err": float(we)}
             for b, e, wf, we in zip(loud, excess, w_flags, w_err)},
         excess_loud=int(excess.sum()), excess_limit=JAX_SW_LOUD,
         excess_solved_in_f64=witnessed, accuracy_pass_rate=acc,
         tol_inf=SW_TOL, silent_wrong=silent,
         max_err_sample_positive=float(err[both].max()) if both.any()
         else None, optimal_rate=opt_rate, optimal_gate=SW_OPT,
         lanes_with_fixed_slack=int(fixed.sum()),
         lanes_with_free_slack=int(free.sum()),
         flags={int(k): int(v) for k, v in zip(*np.unique(
             flags, return_counts=True))},
         median_iters=float(np.median(r.iterations.cpu().numpy())),
         solves_per_s=3 * B / best, window_s=best, oracle_s=oracle_s,
         card=card)
    ok = shape_ok and bool((ref_flags > 0).all()) and acc >= ACC_RATE \
        and silent == 0 and opt_rate >= SW_OPT and witnessed \
        and excess.sum() <= JAX_SW_LOUD and fixed.any() \
        and free.any() and launches["chol_rinv"] >= 1 \
        and launches["dense_round"] >= 1
    return ok, launches


def config_avi(gen):
    """bench_extra.py:306-314: two-sided reference-style AVIs."""
    rng = np.random.default_rng(SEED_AVI)
    probs = [gen.generate_test_avi_two_sided(N_AVI, M_AVI, rng)
             for _ in range(B_AVI)]
    out = {k: np.stack([p[i] for p in probs]).astype(np.float32)
           for i, k in enumerate(('x', 'H', 'f', 'A', 'bupper', 'blower'))}
    out['x'] = np.stack([p[0] for p in probs])
    out['sense'] = np.zeros((B_AVI, M_AVI), np.int32)
    return out


def count_passes(fn):
    """Call the AVI segment twin ``fn`` and count its (lane, pass) pairs:
    the lanes that run in each pass's inner solve."""
    seen = []
    inner = slot.solve_retry

    def spy(s, *a, **k):
        seen.append(int((s.status == dt.EXIT_RUNNING).sum()))
        return inner(s, *a, **k)

    slot.solve_retry = spy
    try:
        out = fn()
    finally:
        slot.solve_retry = inner
    return out, sum(seen)


def avi_flags(o):
    """(lflag, lane_run, failed, kkt_req) of a segment's outputs, (B, 4)."""
    return torch.stack([o[8].double(), o[7].double(), o[10].double(),
                        (o[11] > 0).double()], 1)


def avi_flags_agree(a, b):
    """Per lane: equal lflag, lane_run, failed and kkt_req."""
    return (avi_flags(a) == avi_flags(b).to(a[1].device)).all(1)


def main_path_segments(args, st):
    """The inputs (state, carries) of every B5 launch of one
    ``solve_batch_avi_kernel`` call on ``args``: the cold segment and the
    warm ones after the KKT services, resumes and Newton refreshes."""
    seen = []
    launch = slot.run_avi_segment

    def spy(s, *a, **k):
        seen.append((s, tuple(a[:len(slot.AVI_LANE)])))
        return launch(s, *a, **k)

    slot.run_avi_segment = spy
    try:
        dt.solve_batch_avi_kernel(*args, st, fused=True)
    finally:
        slot.run_avi_segment = launch
    return seen


def avi_segment_passes(s, carry, ops_, st, n):
    """One B5 segment from (s, carry) as PSEG one-pass launches, lanes
    that froze held out of the later ones, with every pass taken apart
    lane by lane, on every lane that ran:

    * bounds: the kernel's d = b_s + M Rinv'(G1 x + f), which it returns,
      within BOUNDS_TOL (1 + ||d||_inf) of the same in f64;
    * inner: K2 with the cold retry (``slot.pass_solve``) replays the
      pass's solve from the kernel's own bounds: the same bits (B5 runs
      K2's step, slot_step.cuh) on the same inputs, so the whole slot
      state must come out bit for bit as the kernel's;
    * outer: ``slot.avi_pass_outer`` in f64 from the kernel's own (u,
      status, iterations) and the pass's f64 inputs: x and y within
      OUTER_TOL (1 + ||x||_inf), the counters, flags and freezes equal.

    Returns (the outputs of the last pass, with the freezes of the whole
    segment, and a dict of counts)."""
    R64, G1_64, G2_64, G3_64, Hri64, fz64, bus64, bls64 = map(f64, ops_)
    B = carry[0].shape[0]
    frozen = torch.zeros(B, dtype=torch.bool, device=ops_[5].device)
    failed, kkt = frozen.clone(), frozen.clone()
    c, out = list(carry), None
    st_ = dict(passes=0, lane_passes=0, bounds_rel=0.0, inner_equal=True,
               inner_parted=0, inner_du=0.0, outer_dx_rel=0.0,
               outer_flags_ok=True,
               at_limit=0, reverted=0)
    for _ in range(pbatch.PSEG):
        run = (c[6] > 0) & ~frozen
        if not bool(run.any()):
            break
        cin, lr_keep = list(c), c[6]
        cin[6] = torch.where(frozen, 0.0, c[6])
        *out, du_k, dl_k = slot.run_avi_segment(
            s, *cin, *ops_, st, n, P=1, steps=pbatch.AVI_STEPS, bounds=True)
        sk = out[0]
        v64, du64, dl64 = slot.avi_pass_bounds(
            slot.SlotState(*map(f64, s)), f64(cin[0]), R64, G1_64, fz64,
            bus64, bls64)
        db = torch.maximum((f64(du_k) - du64).abs().amax(1),
                           (f64(dl_k) - dl64).abs().amax(1)) \
            / (1.0 + torch.maximum(du64.abs().amax(1), dl64.abs().amax(1)))
        s2 = slot.pass_solve(s, du_k, dl_k, run, st, n,
                                 pbatch.AVI_STEPS,
                                 round_fn=slot.run_slot_round)
        same = torch.ones_like(run)
        for name in slot.STATE:
            a_, b_ = getattr(sk, name), getattr(s2, name)
            same = same & (a_ == b_).reshape(B, -1).all(1)
        ref = slot.avi_pass_outer(tuple(map(f64, cin)), run, v64,
                                  f64(sk.u), sk.status, f64(sk.iterations),
                                  R64, G2_64, G3_64, Hri64)
        sc = 1.0 + ref[0].abs().amax(1)
        dx = torch.maximum((f64(out[1]) - ref[0]).abs().amax(1),
                           (f64(out[2]) - ref[1]).abs().amax(1)) / sc
        flags_eq = [torch.equal(f64(out[i + 1]), ref[i]) for i in (4, 5, 6)] \
            + [torch.equal(out[8], ref[7]), torch.equal(out[10] > 0, ref[9]),
               torch.equal(out[11] > 0, ref[10])]
        at_limit = run & (cin[4] == cin[5])
        st_["passes"] += 1
        st_["lane_passes"] += int(run.sum())
        st_["bounds_rel"] = max(st_["bounds_rel"], gmax(db[run].cpu().numpy()))
        st_["inner_parted"] += int((run & ~same).sum())
        st_["inner_du"] = max(st_["inner_du"], gmax(
            (sk.u - s2.u).abs().amax(1)[run].cpu().numpy()))
        st_["inner_equal"] = st_["inner_equal"] and bool(same[run].all())
        st_["outer_dx_rel"] = max(st_["outer_dx_rel"],
                                  gmax(dx[run].cpu().numpy()))
        st_["outer_flags_ok"] = st_["outer_flags_ok"] and all(flags_eq)
        st_["at_limit"] += int(at_limit.sum())
        st_["reverted"] += int((at_limit & (out[6] > cin[5])).sum())
        failed, kkt = failed | (out[10] > 0), kkt | (out[11] > 0)
        s, c = sk, list(out[1:10])
        c[6] = torch.where(frozen, lr_keep, c[6])
        frozen = frozen | failed | kkt
    if out is None:
        return None, st_
    return (s, *c, failed.to(carry[3].dtype), kkt.to(carry[3].dtype)), st_


def avi_bound(s, carry, ops_, out, steps, passes, n):
    """The bound of one B5 launch from (s, carry) to ``out``: every lane's
    state and carries read once and its outputs written once, and a live
    lane's (lane_run > 0) constants and operands read once too (a stopped
    lane needs none of them), or its ``steps`` slot steps and ``passes``
    lane-passes (six n x n products, M v and the step's prefix each) at
    the f32 peak."""
    m, K = s.M.shape[1], s.E.shape[1]
    live = (carry[6] > 0).float().mean().item()
    return bound(state_bytes(s, slot.STATE) + nbytes(*carry)
                 + state_bytes(out[0], slot.STATE) + nbytes(*out[1:])
                 + live * (state_bytes(s, slot.SEG_CONST) + nbytes(*ops_)),
                 steps * step_flops(m, n, K)
                 + passes * (12 * n * n + 2 * m * n + prefix_flops(n, K)))


BLOCK_BODY = "block (128 threads)"
HORIZON_BODY = "horizon (128 threads; K, n <= 64, m <= 128)"


def body(m, n, K, dev, own):
    """The body that the kernel whose own arrays ``own`` counts
    (``smem.avi_own``: B5, ``smem.lp_own``: B6) runs at m rows, n columns
    and K slots on ``dev`` (its C entry's choice, mirrored by
    ``smem.warp_body``)."""
    return "warp" if smem.warp_body(m, n, K, own, smem.available(dev)) \
        else BLOCK_BODY


def chain_equal(chain, whole):
    """Whether the one-pass launches of a segment ended where the one
    launch did, bit for bit (the state, then every carry)."""
    return chain is not None and all(
        torch.equal(x, y) for x, y in zip(chain[1:], whole[1:])) \
        and all(torch.equal(x, y) for x, y in zip(chain[0], whole[0]))


def stack_lanes(probs, idx, dev):
    """Batch-leading f32 tensors of the generator outputs ``idx`` of each
    problem in ``probs``, then an all-zero int32 sense."""
    out = [torch.as_tensor(np.stack([p[i] for p in probs]).astype(
        np.float32), device=dev) for i in idx]
    m = out[-1].shape[1]
    return out + [torch.zeros((len(probs), m), dtype=torch.int32,
                              device=dev)]


def avi_wide_case(gen, st, dev):
    """(a) at a second width: one cold segment of B_WIDE AVIs of
    configAVI's generator at n = N_AVI_WIDE, m = M_AVI_WIDE (K > 32),
    replayed pass by pass (``avi_segment_passes``), the one-pass launches
    equal to the one launch: (passes, fields)."""
    rng = np.random.default_rng(SEED_AVI)
    probs = [gen.generate_test_avi_two_sided(N_AVI_WIDE, M_AVI_WIDE, rng)
             for _ in range(B_WIDE)]
    a = pbatch.avi_init(*stack_lanes(probs, (1, 2, 3, 4, 5), dev), st)
    ops_ = pbatch.avi_segment_operands(a)
    carry = pbatch.avi_carries(a)
    whole = slot.run_avi_segment(a.s, *carry, *ops_, st, N_AVI_WIDE,
                                 P=pbatch.PSEG, steps=pbatch.AVI_STEPS)
    chain, c = avi_segment_passes(a.s, carry, ops_, st, N_AVI_WIDE)
    equal = chain_equal(chain, whole)
    K = a.s.E.shape[1]
    ok = equal and c["inner_equal"] and c["bounds_rel"] <= BOUNDS_TOL \
        and c["outer_flags_ok"] and c["outer_dx_rel"] <= OUTER_TOL
    return ok, dict(B=B_WIDE, n=N_AVI_WIDE, m=M_AVI_WIDE, K=K,
                    body=body(M_AVI_WIDE, N_AVI_WIDE, K, dev, smem.avi_own),
                    chain_equals_segment=equal, passes=c)


def phase_k5(args, st, gen):
    """B5 against its twin, pass by pass and lane by lane.

    (a) Every B5 launch of one ``solve_batch_avi_kernel`` call (the cold
    segment and the warm ones after the KKT services, including lanes at
    the Newton step's limit) is replayed as PSEG one-pass launches and
    each pass taken apart (``avi_segment_passes``): its bounds against
    f64, its inner solve bit for bit against K2 replaying it from those
    bounds, its outer half against the twin's outer half in f64; the
    chained one-pass launches must equal the one PSEG-pass launch bit for
    bit.  So B5 is K2's step (held by k2) and f32 arithmetic that matches
    f64, pass by pass and lane by lane.

    (b) One pass from the cold state, per lane where kernel, twin and the
    twin in f64 agree on the flags: ||x_k - x_p||_inf <= K2_DU (1 + ||x||)
    or ||x_k - x_64|| <= 2 ||x_p - x_64|| (twice the twin's own one-pass
    distance to f64).

    (c) The cold segment end to end: flags agree with the twin on
    ``agree_gate`` of the lanes, 1 - 2 (1 - the twin's agreement with its
    f64 run) if that is below K2_AGREE; the distances of kernel and twin
    to the f64 twin are printed, not gated.  Over eight passes a working
    set decided at a row whose margin is below the accumulated E drift
    (PERF.md, section 6) sends kernel and twin to different vertices, so
    no per-lane x tolerance holds there; (a) holds every pass of it.

    (t) The main path's last B5 launch, its tail (the lanes still running
    after the others finished; (a) holds it pass by pass), is timed beside
    the cold segment, with its live lanes and its bound.

    (w) (a) at n = 40 (``avi_wide_case``): K = 41 > smem.WARP_MAX_K, so
    B5's 128-thread body, where configAVI (K = 21) runs its warp body;
    both print ``body``."""
    t0 = time.perf_counter()
    a = pbatch.avi_init(*args, st)
    ops_ = pbatch.avi_segment_operands(a)
    carry = pbatch.avi_carries(a)
    n = N_AVI

    def kernel():
        return slot.run_avi_segment(a.s, *carry, *ops_, st, n, P=pbatch.PSEG,
                                    steps=pbatch.AVI_STEPS)

    def plain(P=pbatch.PSEG, dtype=None):
        cast = f64 if dtype is not None else (lambda x: x)
        return slot.run_avi_segment_plain(
            slot.SlotState(*map(cast, a.s)), *map(cast, carry),
            *map(cast, ops_), st, n, P=P, steps=pbatch.AVI_STEPS)

    # (a) every segment of the main path, pass by pass
    segs = main_path_segments(args, st)
    chains_equal, tot = True, dict(segments=len(segs), lane_passes=0,
                                  bounds_rel=0.0, inner_equal=True,
                                  inner_parted=0, inner_du=0.0,
                                  outer_dx_rel=0.0,
                                  outer_flags_ok=True, at_limit=0,
                                  reverted=0)
    for s_in, c_in in segs:
        whole = slot.run_avi_segment(s_in, *c_in, *ops_, st, n,
                                     P=pbatch.PSEG, steps=pbatch.AVI_STEPS)
        chain, c = avi_segment_passes(s_in, c_in, ops_, st, n)
        last = (s_in, c_in, whole, c["lane_passes"])
        if chain is not None:
            chains_equal = chains_equal and chain_equal(chain, whole)
        tot["lane_passes"] += c["lane_passes"]
        tot["bounds_rel"] = max(tot["bounds_rel"], c["bounds_rel"])
        tot["inner_equal"] = tot["inner_equal"] and c["inner_equal"]
        tot["inner_parted"] += c["inner_parted"]
        tot["inner_du"] = max(tot["inner_du"], c["inner_du"])
        tot["outer_dx_rel"] = max(tot["outer_dx_rel"], c["outer_dx_rel"])
        tot["outer_flags_ok"] = tot["outer_flags_ok"] and c["outer_flags_ok"]
        tot["at_limit"] += c["at_limit"]
        tot["reverted"] += c["reverted"]
    passes_ok = chains_equal and tot["inner_equal"] \
        and tot["bounds_rel"] <= BOUNDS_TOL and tot["outer_flags_ok"] \
        and tot["outer_dx_rel"] <= OUTER_TOL
    wide_ok, wide = avi_wide_case(gen, st, a.s.M.device)

    # (t) the main path's last launch, its tail: the lanes still running
    # after the others finished
    s_t, c_t, o_t, passes_t = last

    def tail():
        return slot.run_avi_segment(s_t, *c_t, *ops_, st, n, P=pbatch.PSEG,
                                    steps=pbatch.AVI_STEPS)

    tail_ms = cuda_ms(tail, SEG_REPS)
    tail_live = int((c_t[6] > 0).sum())
    tail_steps = o_t[9] - c_t[8]
    tail_bnd = avi_bound(s_t, c_t, ops_, o_t, tail_steps.sum().item(),
                         passes_t, n)

    # (b) one pass from the cold state against the twin and its f64 run
    k1 = slot.run_avi_segment(a.s, *carry, *ops_, st, n, P=1,
                              steps=pbatch.AVI_STEPS)
    p1, p1_64 = plain(1), plain(1, torch.float64)
    all3 = avi_flags_agree(k1, p1) & avi_flags_agree(p1, p1_64)
    sc1 = 1.0 + p1[1].abs().amax(1)
    gap1 = (k1[1] - p1[1]).abs().amax(1) / sc1
    exk1 = (f64(k1[1]) - p1_64[1]).abs().amax(1) / sc1
    exp1 = (f64(p1[1]) - p1_64[1]).abs().amax(1) / sc1
    one_ok = bool(((gap1 <= K2_DU) | (exk1 <= 2.0 * exp1))[all3].all())

    # (c) the cold segment end to end
    ko = kernel()
    po, passes = count_passes(plain)
    p64 = plain(dtype=torch.float64)
    agree = avi_flags_agree(ko, po)
    twin_f64 = avi_flags_agree(po, p64).float().mean().item()
    agree_gate = min(K2_AGREE, 1.0 - 2.0 * (1.0 - twin_f64))
    rate = agree.float().mean().item()
    all3 = agree & avi_flags_agree(po, p64)
    sc3 = 1.0 + po[1].abs().amax(1)[all3]
    ex_k = (f64(ko[1]) - p64[1]).abs().amax(1)[all3] / sc3
    ex_p = (f64(po[1]) - p64[1]).abs().amax(1)[all3] / sc3
    gap = (ko[1] - po[1]).abs().amax(1)[all3] / sc3
    k3_rule_out = torch.nonzero(all3)[:, 0][
        (gap > K2_DU) & (ex_k > 2.0 * ex_p + K2_DU)].tolist()

    def quant(v):
        v = v.cpu().numpy()
        return [float(np.quantile(v, q)) for q in (0.5, 0.9, 0.99, 1.0)] \
            if v.size else []

    ms = cuda_ms(kernel, SEG_REPS)
    plain_ms = cuda_ms(plain, 1)
    K = n + 1
    steps_done = ko[9].sum().item()
    bnd = avi_bound(a.s, carry, ops_, ko, steps_done, passes, n)
    err1 = (k1[1] - p1[1]).abs().amax(1)[avi_flags_agree(k1, p1)]
    emit("k5", t0, B=B_AVI, P=pbatch.PSEG, n=n, m=M_AVI, K=K,
         body=body(M_AVI, n, K, a.s.M.device, smem.avi_own),
         steps=pbatch.AVI_STEPS, main_path_passes=tot,
         chain_equals_segment=chains_equal, bounds_tol=BOUNDS_TOL,
         outer_tol=OUTER_TOL,
         one_pass_agree_rate=avi_flags_agree(k1, p1).float().mean().item(),
         one_pass_dx_rel_max=gmax(gap1[all3].cpu().numpy()),
         one_pass_kernel_vs_f64_quantiles=quant(exk1[all3]),
         one_pass_twin_vs_f64_quantiles=quant(exp1[all3]),
         one_pass_twin_agree_with_f64=avi_flags_agree(p1, p1_64).float()
         .mean().item(), one_pass_per_lane_ok=one_ok,
         segment_agree_rate=rate, agree_gate=agree_gate,
         twin_agree_with_f64_twin=twin_f64,
         lanes_done_kernel=int((ko[7] == 0).sum()),
         failed_kernel=int((ko[10] > 0).sum()),
         kkt_req_kernel=int((ko[11] > 0).sum()),
         segment_kernel_vs_f64_quantiles=quant(ex_k),
         segment_twin_vs_f64_quantiles=quant(ex_p),
         segment_lanes_beyond_twice_twin_drift=k3_rule_out,
         steps_done=steps_done, lane_passes=passes, ms=ms,
         plain_ms=plain_ms, **bnd,
         max_lane_steps=ko[9].max().item(),
         tail=dict(live_lanes=tail_live, lane_passes=passes_t,
                   steps=tail_steps.sum().item(),
                   max_lane_steps=tail_steps.max().item(), ms=tail_ms,
                   **tail_bnd), wide=wide)
    ok = passes_ok and wide_ok and one_ok and rate >= agree_gate
    return ok, dict(max_abs_err=gmax(err1.cpu().numpy()), ms=ms,
                    plain_ms=plain_ms, library_ms=None,
                    bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"],
                    tail_live_lanes=tail_live, tail_ms=tail_ms,
                    tail_bound_ms=tail_bnd["bound_ms"],
                    tail_bound_by=tail_bnd["bound_by"])


def phase_avi(args, d_avi, st, card):
    """ConfigAVI through the fused AVI tier: every lane flag 1 within
    AVI_TOL of the constructed solution, or loud; the loud lanes are
    solved by the f64 single-instance oracle."""
    t0 = time.perf_counter()
    avi_or = oracle_module("avi_numpy")
    H, f, A, bu, bl, sense = args

    def solve(fs=f):
        return dt.solve_batch_avi_kernel(H, fs, A, bu, bl, sense, st,
                                         fused=True)

    reset_counts()
    r = solve()
    torch.cuda.synchronize()
    launches = read_counts()
    syncs = ops.host_syncs
    services, resumed = pbatch.avi_kkt_services, pbatch.avi_resumed_lanes
    x = r.x.cpu().numpy()
    flags = r.exitflag.cpu().numpy()
    err = np.abs(x.astype(np.float64) - d_avi['x']).max(1)
    legal = (flags == 1) | (flags < 0)
    silent = int(np.sum((flags == 1) & (err >= AVI_TOL)))
    opt_rate = float(np.mean(flags == 1))
    loud = np.flatnonzero(flags != 1)
    t_or = time.perf_counter()
    loud_solved = 0
    for b in loud:
        ref = avi_or.solve_avi(*(d_avi[k][b].astype(np.float64) for k in (
            'H', 'f', 'A', 'bupper', 'blower')), ms=0)
        loud_solved += int(ref['exitflag'] == 1
                           and np.abs(ref['x'] - d_avi['x'][b]).max() < 1e-5)
    oracle_s = time.perf_counter() - t_or
    best = None
    for _ in range(3):
        torch.cuda.synchronize()
        tw = time.perf_counter()
        for i in range(4):
            solve(f * (1.0 + 1e-5 * i))
        torch.cuda.synchronize()
        w = time.perf_counter() - tw
        best = w if best is None else min(best, w)
    shape_ok = x.shape == (B_AVI, N_AVI) and r.lam.shape == (B_AVI, M_AVI) \
        and bool(np.isfinite(x[flags == 1]).all())
    ok_back, back = tier_backstop(
        r, dt.backstop_resolve_avi, lambda xh, ls: np.abs(
            xh[ls] - d_avi['x'][ls]).max(1) < AVI_TOL, *args, settings=st)
    emit("avi", t0, B=B_AVI, n=N_AVI, m=M_AVI, launches=launches,
         host_syncs=syncs, kkt_services=services, resumed_lanes=resumed,
         shape_finite_ok=shape_ok, flags_legal=bool(legal.all()),
         flags={int(k): int(v) for k, v in zip(*np.unique(
             flags, return_counts=True))},
         optimal_rate=opt_rate, optimal_gate=AVI_OPT,
         jax_optimal_rate=JAX_AVI_OPT_RATE, silent_wrong=silent,
         max_err_optimal=float(err[flags == 1].max())
         if (flags == 1).any() else None,
         loud_lanes=int(loud.size), loud_solved_by_f64_oracle=loud_solved,
         median_iters=float(np.median(r.iterations.cpu().numpy())),
         solves_per_s=4 * B_AVI / best, window_s=best, oracle_s=oracle_s,
         backstop=back, card=card)
    ok = shape_ok and bool(legal.all()) and silent == 0 \
        and opt_rate >= AVI_OPT and launches["avi_segment"] >= 1 and ok_back
    return ok, launches


def config_lp(gen):
    """bench_extra.py:253-262: LPs whose constructed vertex is optimal;
    ``x`` stays f64."""
    rng = np.random.default_rng(SEED_LP)
    probs = [gen.generate_test_lp(N_LP, M_LP, 0, rng) for _ in range(B_LP)]
    out = {k: np.stack([p[i] for p in probs])
           for i, k in enumerate(('x', 'f', 'A', 'bupper', 'blower'))}
    for k in ('f', 'A', 'bupper', 'blower'):
        out[k] = out[k].astype(np.float32)
    out['sense'] = np.zeros((B_LP, M_LP), np.int32)
    return out


def lp_gate(d, x):
    """bench_extra.py:273-279 per lane, in f64: (relative objective gap,
    feasibility violation)."""
    f, A = d['f'].astype(np.float64), d['A'].astype(np.float64)
    fv_ref = np.einsum('bn,bn->b', f, d['x'])
    gap = np.abs(np.einsum('bn,bn->b', f, x) - fv_ref) / (1.0 + np.abs(fv_ref))
    Ax = np.einsum('bmn,bn->bm', A, x)
    feas = np.maximum((Ax - d['bupper']).max(1), (d['blower'] - Ax).max(1))
    return gap, feas


def lp_recheck(d, b, x, st):
    """Lane ``b``'s x against the LP tier's own final certificate
    (``batch.py:1438-1575``), re-done in f64 with NumPy: feasibility within
    10 primal_tol (1 + max|bu|); on the rows tight within that tolerance,
    the least-squares duals (numpy.linalg.lstsq) meet stationarity
    ||f + A_T' lam||_inf <= 1e-5 (1 + ||f||_inf) and complementarity with
    the dual sign (lam >= -1e-6 on an upper-tight row, <= 1e-6 on a
    lower-tight one).  Returns a dict of the three checks and their
    numbers."""
    f, A = d['f'][b].astype(np.float64), d['A'][b].astype(np.float64)
    bu, bl = d['bupper'][b].astype(np.float64), d['blower'][b].astype(
        np.float64)
    vals = A @ x
    tol = 10.0 * float(st.primal_tol) * (1.0 + np.abs(bu).max())
    feas = float(max((vals - bu).max(), (bl - vals).max()))
    up = bu - vals < tol
    lo = (vals - bl < tol) & ~up
    rows = np.flatnonzero(up | lo)
    lam = np.linalg.lstsq(A[rows].T, -f, rcond=None)[0]
    stat = float(np.abs(f + A[rows].T @ lam).max())
    sign_ok = bool(((lam >= -1e-6) | ~up[rows]).all()
                   and ((lam <= 1e-6) | ~lo[rows]).all())
    return dict(feasibility=feas, feasibility_tol=tol, stationarity=stat,
                stationarity_tol=1e-5 * (1.0 + np.abs(f).max()),
                tight_rows=int(rows.size), sign_ok=sign_ok,
                passes=bool(feas <= tol
                            and stat <= 1e-5 * (1.0 + np.abs(f).max())
                            and sign_ok))


def lp_f64(d, lanes):
    """``lanes`` of configLP re-solved by the port's per-pass path
    (``fused=False``) on f64 CPU tensors: per lane its flag, bench_lp's
    gap and feasibility, and whether it is flag 1 within the gate (then
    its loudness on the card is the f32 arithmetic's, not the path's)."""
    if not lanes:
        return {}
    sub = {k: v[lanes] for k, v in d.items()}
    args = [torch.as_tensor(sub[k]).double()
            for k in ('f', 'A', 'bupper', 'blower')]
    r = dt.solve_batch_lp_kernel(*args, torch.as_tensor(sub['sense']),
                                 dt.as_settings({"iter_limit": 3000},
                                                torch.float64),
                                 fused=False, device="cpu")
    gap, feas = lp_gate(sub, r.x.numpy())
    flags = r.exitflag.numpy()
    return {b: dict(flag=int(flags[i]), gap=float(gap[i]),
                    feasibility=float(feas[i]), solved_within_gate=bool(
                        flags[i] == 1 and gap[i] < LP_TOL
                        and feas[i] < LP_TOL))
            for i, b in enumerate(lanes)}


def lp_flags(o):
    """(failed, lane_run, lflag) of a B6 segment's outputs, (B, 3)."""
    return torch.stack([o[9].double(), o[5].double(), o[6].double()], 1)


# the state fields a B6 pass's gradient step leaves alone (its bordered
# add writes E, W, used, sid, slo, dsl, lam, act_up, act_lo)
LP_INNER = ("lam_star", "pend", "prow", "plam", "plo", "pid", "pdd", "u",
            "fval", "best_fval", "cycle", "repaired", "iterations", "status")
LP_ADD_EXACT = ("W", "used", "sid", "slo", "dsl", "lam", "act_up", "act_lo")


def lp_segment_passes(s, carry, data, st, n, eta, steps):
    """One B6 segment from (s, carry) as LP_PSEG one-pass launches, lanes
    that froze held out of the later ones, every pass taken apart on
    every lane that ran (the rule of k5):

    * bounds: the kernel's d = b_s + M (f eps - x), which it returns,
      within BOUNDS_TOL (1 + ||d||_inf) of the same in f64;
    * inner: K2 with the cold retry (``slot.pass_solve``) replays the
      pass's solve from the kernel's own bounds: the same bits (the warp
      step of slot_warp.cuh sums in the order of slot_step.cuh's) on the
      same inputs, so the state fields the
      gradient step leaves alone (LP_INNER) must equal the kernel's bit
      for bit;
    * outer: the twin's second half (``slot.lp_pass_outer``, f32) from
      K2's replayed state: the discrete outputs (failed, lane_run, lflag,
      stall, passes and the bordered add's W, used, sid, slo, dsl, lam,
      act_up, act_lo) equal on at least LP_OUTER_AGREE of the lane-passes
      (a near-tie in the ray search or a convergence test at f32
      resolution may fall either way under another summation order), and
      on those x, eps and best within OUTER_TOL (1 + ||.||_inf), and E
      within LP_E_TOL (1 + ||E||_inf) (the Schur pivot of the add cancels
      down to 1e-4 of its row's norm at the gate, so one rounding of g'a
      moves 1/sval by up to ~1e-3).

    Returns (the outputs of the chain, with the freezes of the whole
    segment, and a dict of counts)."""
    B = carry[0].shape[0]
    frozen = torch.zeros(B, dtype=torch.bool, device=carry[0].device)
    c, out = list(carry), None
    cnt = dict(passes=0, lane_passes=0, bounds_rel=0.0, inner_equal=True,
               inner_parted=0, outer_agree=0, outer_parted=[], x_rel=0.0,
               E_rel=0.0, adds=0)
    for _ in range(pbatch.LP_PSEG):
        run = (c[4] > 0) & ~frozen
        if not bool(run.any()):
            break
        cin, lr_keep = list(c), c[4]
        cin[4] = torch.where(frozen, 0.0, c[4])
        *out, du_k, dl_k = slot.run_lp_segment(s, *cin, *data, st, n, eta,
                                               P=1, steps=steps, bounds=True)
        sk = out[0]
        _, du64, dl64 = slot.lp_pass_bounds(
            slot.SlotState(*map(f64, s)), f64(cin[0]), f64(cin[1]),
            *map(f64, data[:3]))
        db = torch.maximum((f64(du_k) - du64).abs().amax(1),
                           (f64(dl_k) - dl64).abs().amax(1)) \
            / (1.0 + torch.maximum(du64.abs().amax(1), dl64.abs().amax(1)))
        s2 = slot.pass_solve(s, du_k, dl_k, run, st, n, steps,
                             round_fn=slot.run_slot_round)
        same = torch.ones_like(run)
        for name in LP_INNER:
            a_, b_ = getattr(sk, name), getattr(s2, name)
            same = same & (a_ == b_).reshape(B, -1).all(1)
        v, _, _ = slot.lp_pass_bounds(s, cin[0], cin[1], *data[:3])
        so, co, bad = slot.lp_pass_outer(s2, tuple(cin), run, v, *data[3:],
                                         st, n, eta)
        agree = (bad == (out[9] > 0))
        for i in (2, 4, 5, 7):      # stall, lane_run, lflag, passes
            agree = agree & (out[i + 1] == co[i])
        for name in LP_ADD_EXACT:
            agree = agree & (getattr(sk, name) == getattr(so, name)) \
                .reshape(B, -1).all(1)
        ok = run & agree
        rel = torch.zeros(B, dtype=torch.float64, device=run.device)
        for i in (0, 1, 3):         # x, eps, best
            a_, b_ = f64(out[i + 1]).reshape(B, -1), f64(co[i]).reshape(B, -1)
            fin = torch.isfinite(b_)
            rel = torch.maximum(rel, torch.where(
                fin, (a_ - b_).abs(), 0.0).amax(1)
                / (1.0 + torch.where(fin, b_.abs(), 0.0).amax(1)))
        e_rel = (f64(sk.E) - f64(so.E)).abs().amax((1, 2)) \
            / (1.0 + f64(so.E).abs().amax((1, 2)))
        added = run & (sk.used.sum(1) > s2.used.sum(1))
        cnt["passes"] += 1
        cnt["lane_passes"] += int(run.sum())
        cnt["adds"] += int(added.sum())
        cnt["bounds_rel"] = max(cnt["bounds_rel"], gmax(db[run].cpu().numpy()))
        cnt["inner_parted"] += int((run & ~same).sum())
        cnt["inner_equal"] = cnt["inner_equal"] and bool(same[run].all())
        cnt["outer_agree"] += int(ok.sum())
        cnt["outer_parted"] += [(cnt["passes"] - 1, int(b))
                                for b in torch.nonzero(run & ~agree)[:, 0]]
        cnt["x_rel"] = max(cnt["x_rel"], gmax(rel[ok].cpu().numpy()))
        cnt["E_rel"] = max(cnt["E_rel"], gmax(e_rel[ok].cpu().numpy()))
        frozen = frozen | (out[9] > 0)
        s, c = sk, list(out[1:9])
        c[4] = torch.where(frozen & ~(out[9] > 0), lr_keep, c[4])
    if out is None:
        return None, cnt
    return (s, *c, frozen.to(carry[1].dtype)), cnt


def lp_wide_case(gen, st, dev):
    """(a) on B6's 128-thread body: one cold segment of B_WIDE LPs of
    configLP's generator at n = N_LP_WIDE, m = M_LP_WIDE (K > 32),
    replayed pass by pass (``lp_segment_passes``), the one-pass launches
    equal to the one launch: (passes, fields)."""
    rng = np.random.default_rng(SEED_LP)
    probs = [gen.generate_test_lp(N_LP_WIDE, M_LP_WIDE, 0, rng)
             for _ in range(B_WIDE)]
    p = pbatch.lp_init(*stack_lanes(probs, (1, 2, 3, 4), dev), st)
    carry = pbatch.lp_carries(p)
    s = p.s0._replace(status=torch.full_like(p.s0.status, dt.EXIT_OPTIMAL))
    data = (p.f, p.bu_s, p.bl_s, p.bu_r, p.bl_r)
    steps = pbatch.LP_SEG_STEPS
    whole = slot.run_lp_segment(s, *carry, *data, st, N_LP_WIDE, p.eta,
                                P=pbatch.LP_PSEG, steps=steps)
    chain, cnt = lp_segment_passes(s, carry, data, st, N_LP_WIDE, p.eta,
                                   steps)
    equal = chain_equal(chain, whole)
    rate = cnt["outer_agree"] / max(cnt["lane_passes"], 1)
    K = s.E.shape[1]
    ok = equal and cnt["inner_equal"] and cnt["bounds_rel"] <= BOUNDS_TOL \
        and rate >= LP_OUTER_AGREE and cnt["x_rel"] <= OUTER_TOL \
        and cnt["E_rel"] <= LP_E_TOL
    return ok, dict(B=B_WIDE, n=N_LP_WIDE, m=M_LP_WIDE, K=K,
                    body=body(M_LP_WIDE, N_LP_WIDE, K, dev, smem.lp_own),
                    chain_equals_segment=equal, outer_agree_rate=rate,
                    passes=cnt)


def phase_k6(args, st, gen):
    """B6 against its twin over one cold configLP segment (LP_PSEG passes
    of LP_SEG_STEPS steps) from the state and carries the tier builds.

    The segment's decisions sit at the f32 noise floor: the fixed-point
    test diff < eta eps (eta = 1e-7) is below f32 resolution, so lanes
    converge on the stagnation count, and a ray step extrapolates along
    x_new - x.  Over a segment the f32 twin parts from its own f64 run on
    about a fifth of the lanes (CPU, tests/test_torch_lp.py), and kernel
    and twin part likewise; and one cold solve of an ill-conditioned
    working set (cond(G) up to ~1e5) puts kernel and twin each up to ~1e-3
    from f64, so no per-lane x tolerance separates a fault from f32 there.
    So, as k5:

    (a) every pass of the segment taken apart (``lp_segment_passes``),
    and the LP_PSEG one-pass launches equal the one LP_PSEG-pass launch
    bit for bit;

    (b) the segment end to end: the flags agree with the twin on at least
    1 - 2 (1 - the twin's agreement with its f64 run) of the lanes (at
    most K6_AGREE); the distances of kernel and twin to the f64 twin are
    printed, not gated;

    (w) (a) on the 128-thread body (``lp_wide_case``): configLP's K = 11
    runs the warp body (``body``)."""
    t0 = time.perf_counter()
    p = pbatch.lp_init(*args, st)
    carry = pbatch.lp_carries(p)
    s = p.s0._replace(status=torch.full_like(p.s0.status, dt.EXIT_OPTIMAL))
    data = (p.f, p.bu_s, p.bl_s, p.bu_r, p.bl_r)
    n, P, steps = N_LP, pbatch.LP_PSEG, pbatch.LP_SEG_STEPS

    def kernel():
        return slot.run_lp_segment(s, *carry, *data, st, n, p.eta, P=P,
                                   steps=steps)

    def plain(cast=lambda x: x):
        return slot.run_lp_segment_plain(
            slot.SlotState(*map(cast, s)), *map(cast, carry),
            *map(cast, data), st, n, p.eta, P=P, steps=steps)

    # (a) pass by pass
    ko = kernel()
    chain, cnt = lp_segment_passes(s, carry, data, st, n, p.eta, steps)
    chains_equal = chain_equal(chain, ko)
    outer_rate = cnt["outer_agree"] / max(cnt["lane_passes"], 1)
    wide_ok, wide = lp_wide_case(gen, st, s.M.device)
    passes_ok = chains_equal and cnt["inner_equal"] \
        and cnt["bounds_rel"] <= BOUNDS_TOL and outer_rate >= LP_OUTER_AGREE \
        and cnt["x_rel"] <= OUTER_TOL and cnt["E_rel"] <= LP_E_TOL
    # (b) end to end
    po, p64 = plain(), plain(f64)
    fk, fp, f6 = lp_flags(ko), lp_flags(po), lp_flags(p64)
    agree = (fk == fp).all(1)
    twin_f64 = (fp == f6).all(1).float().mean().item()
    agree_gate = min(K6_AGREE, 1.0 - 2.0 * (1.0 - twin_f64))
    all3 = agree & (fp == f6).all(1)
    rate = agree.float().mean().item()
    sc = 1.0 + f64(p64[1]).abs().amax(1)
    ex_k = (f64(ko[1]) - p64[1]).abs().amax(1) / sc
    ex_p = (f64(po[1]) - p64[1]).abs().amax(1) / sc

    def quant(v):
        v = v.cpu().numpy()
        return [float(np.quantile(v, q)) for q in (0.5, 0.9, 0.99, 1.0)] \
            if v.size else []

    ms = cuda_ms(kernel, SEG_REPS)
    plain_ms = cuda_ms(plain, 1)
    K = n + 1
    steps_done = ko[7].sum().item()
    lane_passes = ko[8].sum().item()
    bnd = bound(state_bytes(s, slot.SEG_CONST + slot.STATE)
                + nbytes(*carry, *data) + state_bytes(ko[0], slot.STATE)
                + nbytes(*ko[1:]),
                steps_done * step_flops(M_LP, n, K)
                + lane_passes * (6 * M_LP * n + 2 * K * n + 2 * K * K))
    err = (ko[1] - po[1]).abs().amax(1)[agree]
    emit("k6", t0, B=B_LP, P=P, n=n, m=M_LP, K=K,
         body=body(M_LP, n, K, s.M.device, smem.lp_own),
         steps=steps, main_path_passes=cnt,
         chain_equals_segment=chains_equal,
         bounds_tol=BOUNDS_TOL, outer_agree_rate=outer_rate,
         outer_agree_gate=LP_OUTER_AGREE, outer_tol=OUTER_TOL,
         E_tol=LP_E_TOL, segment_agree_rate=rate, agree_gate=agree_gate,
         twin_agree_with_f64_twin=twin_f64,
         passes_agree_rate=(ko[8] == po[8]).float().mean().item(),
         parted_lanes={int(b): {"kernel": fk[b].tolist(),
                                "twin": fp[b].tolist(),
                                "twin_f64": f6[b].tolist()}
                       for b in torch.nonzero(~agree)[:, 0].tolist()},
         lanes_done_kernel=int((ko[5] == 0).sum()),
         failed_kernel=int((ko[9] > 0).sum()),
         kernel_flags={int(k): int(v) for k, v in zip(
             *torch.unique(ko[6], return_counts=True))},
         segment_kernel_vs_f64_quantiles=quant(ex_k[all3]),
         segment_twin_vs_f64_quantiles=quant(ex_p[all3]),
         steps_done=steps_done, max_lane_steps=ko[7].max().item(),
         lane_passes=lane_passes, ms=ms, plain_ms=plain_ms, **bnd,
         wide=wide)
    ok = passes_ok and wide_ok and rate >= agree_gate
    return ok, dict(max_abs_err=gmax(err.cpu().numpy()), ms=ms,
                    plain_ms=plain_ms, library_ms=None,
                    bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"])


def lp_path(args, d, st, fused, card):
    """ConfigLP through ``solve_batch_lp_kernel(fused=...)``, its launch
    counts set to 0 just before and read just after: (ok, launches, the
    fields it prints)."""
    path = "fused" if fused else "per_pass"
    f, A, bu, bl, sense = args

    def solve(fs=f):
        return dt.solve_batch_lp_kernel(fs, A, bu, bl, sense, st, fused=fused)

    reset_counts()
    r = solve()
    torch.cuda.synchronize()
    launches = read_counts()
    syncs = ops.host_syncs
    resumed, certified = pbatch.lp_resumed_lanes, pbatch.lp_certified_lanes
    x = r.x.cpu().numpy().astype(np.float64)
    flags = r.exitflag.cpu().numpy()
    gap, feas = lp_gate(d, x)
    opt = flags == 1
    acc = float(np.mean(opt & (gap < LP_TOL) & (feas < LP_TOL)))
    beyond = np.flatnonzero(opt & ((gap >= LP_TOL) | (feas >= LP_TOL)))
    checks = {int(b): dict(gap=float(gap[b]), feasibility=float(feas[b]),
                           jax_flags_same_lane=int(b) in JAX_LP_BEYOND[path],
                           **lp_recheck(d, b, x[b], st)) for b in beyond}
    legal = (flags == 1) | (flags < 0)
    excess = [int(b) for b in np.flatnonzero(flags != 1)
              if b not in JAX_LP_LOUD[path]]
    f64_lanes = lp_f64(d, excess) if not fused else None
    best = None
    for _ in range(3):
        torch.cuda.synchronize()
        tw = time.perf_counter()
        for i in range(4):
            solve(f * (1.0 + 1e-5 * i))
        torch.cuda.synchronize()
        w = time.perf_counter() - tw
        best = w if best is None else min(best, w)
    shape_ok = x.shape == (B_LP, N_LP) and r.lam.shape == (B_LP, M_LP) \
        and bool(np.isfinite(x[opt]).all())
    opt_rate = float(opt.mean())

    def within(xh, ls):
        g, fe = lp_gate({k: v[ls] for k, v in d.items()}, xh[ls])
        return (g < LP_TOL) & (fe < LP_TOL)

    ok_back, back = tier_backstop(r, dt.backstop_resolve_lp, within, *args,
                                  settings=st)
    fields = dict(
        launches=launches, host_syncs=syncs, resumed_lanes=resumed,
        certified_lanes=certified, shape_finite_ok=shape_ok,
        flags={int(k): int(v) for k, v in zip(*np.unique(
            flags, return_counts=True))},
        loud_lanes=np.flatnonzero(flags != 1).tolist(),
        jax_loud_lanes=list(JAX_LP_LOUD[path]), loud_lanes_f64=f64_lanes,
        optimal_rate=opt_rate,
        optimal_gate=LP_OPT[path], accuracy_pass_rate=acc,
        beyond_gate=checks, beyond_limit=len(JAX_LP_BEYOND[path]),
        max_gap_optimal=float(gap[opt].max()) if opt.any() else None,
        max_feas_optimal=float(feas[opt].max()) if opt.any() else None,
        median_iters=float(np.median(r.iterations.cpu().numpy())),
        lp_solves_per_s=4 * B_LP / best, window_s=best, backstop=back,
        card=card)
    ok = shape_ok and bool(legal.all()) and opt_rate >= LP_OPT[path] \
        and ok_back \
        and len(beyond) <= len(JAX_LP_BEYOND[path]) \
        and all(c["passes"] for c in checks.values()) \
        and (launches["lp_segment"] >= 1 if fused
             else launches["lp_segment"] == 0)
    return ok, launches, fields


def phase_lp(args, d, st, card):
    """ConfigLP on both paths, each against the JAX tier's census
    (JAX_LP_LOUD, JAX_LP_BEYOND): the optimal rate at least LP_OPT, lanes
    flagged 1 beyond bench_lp's gate at most the JAX tier's count on that
    path (0 per-pass), each of them passing the tier's certificate
    re-checked in f64; B6 launched on the fused path and not on the
    per-pass one."""
    t0 = time.perf_counter()
    ok_p, l_p, f_p = lp_path(args, d, st, False, card)
    ok_f, l_f, f_f = lp_path(args, d, st, True, card)
    emit("lp", t0, B=B_LP, n=N_LP, m=M_LP, per_pass=f_p, fused=f_f)
    return ok_p and ok_f, {"lp_per_pass": l_p, "lp_fused": l_f}


def config1(gen):
    """BASELINE config 1: B1 QPs of ``tests/gen.generate_test_qp`` from
    one seed, each (x_ref, H, f, A, bu, bl, sense), f64 numpy."""
    rng = np.random.default_rng(SEED1)
    return [gen.generate_test_qp(N1, M1, MS1, NACT1, KAPPA, rng)
            for _ in range(B1)]


def single_solves(probs, dtype, st):
    """Each QP through ``dt.quadprog(..., device="cuda")``, one at a time,
    numpy in and x back on the host: (flags, ||x - x_ref||_2, the f64 KKT
    residual max(stationarity, violation), ms a solve (host clock,
    synchronized), host syncs a solve, results on the card, iterations,
    x)."""
    flags, err, kkt, ms, iters, xs = [], [], [], [], [], []
    on_card = True
    s0 = ops.host_syncs
    for x, H, f, A, bu, bl, sense in probs:
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = dt.quadprog(H, f, A, bu, bl, sense, ms=MS1, dtype=dtype,
                        settings=st, device="cuda")
        xr = r.x.cpu().numpy()
        ms.append(1e3 * (time.perf_counter() - t))
        on_card &= r.x.is_cuda and r.lam.is_cuda and r.x.dtype == dtype
        flags.append(r.exitflag)
        iters.append(r.iterations)
        xs.append(xr)
        err.append(np.linalg.norm(xr.astype(np.float64) - x))
        stat, viol = dt.kkt_residuals(H[None], f[None], A[None], bu[None],
                                      bl[None], sense[None], xr[None],
                                      r.lam.cpu().numpy()[None], ms=MS1)
        kkt.append(max(stat[0], viol[0]))
    return (np.asarray(flags), np.asarray(err), np.asarray(kkt),
            np.asarray(ms), (ops.host_syncs - s0) / len(probs), on_card,
            np.asarray(iters), np.asarray(xs))


def model_case(prob, dtype, st):
    """``dt.Model`` on the card: set up, solve, solve again unchanged,
    update f and the bounds (tests/test_model.py:48-60), re-solve; the
    last against a cold ``quadprog`` of the updated QP."""
    x, H, f, A, bu, bl, sense = prob
    d = dt.Model(st).setup(H, f, A, bu, bl, sense, ms=MS1, dtype=dtype,
                           device="cuda")
    r1, r2 = d.solve(), d.solve()
    upd = dict(f=f * 1.001, bupper=bu + 1e-4, blower=bl - 1e-4)
    d.update(**upd)
    r3 = d.solve()
    ref = dt.quadprog(H, upd["f"], A, upd["bupper"], upd["blower"], sense,
                      ms=MS1, dtype=dtype, settings=st, device="cuda")
    gap = float((r3.x - ref.x).abs().max())
    ok = (r1.exitflag == r2.exitflag == r3.exitflag == 1
          and r2.iterations == 1 and r3.iterations <= MODEL_WARM_ITERS
          and r3.x.is_cuda and gap <= (1e-8 if dtype == torch.float64
                                       else ACC_TOL))
    return ok, dict(first_iters=r1.iterations, unchanged_iters=r2.iterations,
                    updated_iters=r3.iterations, cold_iters=ref.iterations,
                    x_gap_to_cold=gap)


def phase_single(gen, card):
    """BASELINE config 1 through the single-instance path on the card, in
    f64 (every QP flag 1 within SINGLE_TOL64) and in f32 with the f32
    settings (the accuracy rate within ACC_TOL >= SINGLE_RATE32; a lane
    flagged 1 beyond it only among JAX_SINGLE_SILENT32 and
    JAX_SINGLE_EDGE32, each KKT-certified within 1e-4), then one
    ``Model`` per type.  The path launches none of the
    port's kernels: the counts must stay 0."""
    t0 = time.perf_counter()
    probs = config1(gen)
    reset_counts()
    out, ok = {}, True
    for dtype, st in ((torch.float64, None),
                      (torch.float32, dt.default_settings_f32())):
        flags, err, kkt, ms, syncs, on_card, iters, xs = single_solves(
            probs, dtype, st)
        f64 = dtype == torch.float64
        good = (flags == 1) & (err <= (SINGLE_TOL64 if f64 else ACC_TOL))
        silent = (flags > 0) & ~good
        m_ok, m_fields = model_case(probs[0], dtype, st)
        name = str(dtype).split(".")[-1]
        out[name] = dict(
            optimal_rate=float(np.mean(flags == 1)),
            accuracy_pass_rate=float(np.mean(good)),
            max_err=float(err.max()), max_kkt=float(kkt.max()),
            silent_wrong={int(b): dict(err=float(err[b]),
                                       kkt=float(kkt[b]),
                                       iterations=int(iters[b]),
                                       x=xs[b].tolist())
                          for b in np.nonzero(silent)[0]},
            median_ms=float(np.median(ms)),
            p90_ms=float(np.percentile(ms, 90)),
            host_syncs_per_solve=syncs, on_card=on_card, model=m_fields)
        ok &= on_card and m_ok and (
            bool(good.all()) if f64
            else float(np.mean(good)) >= SINGLE_RATE32
            and set(np.flatnonzero(silent)) <= set(JAX_SINGLE_SILENT32)
            | set(JAX_SINGLE_EDGE32)
            and bool((kkt[silent] <= 1e-4).all()))
    launches = read_counts()
    emit("single", t0, B=B1, n=N1, m=M1, ms=MS1, n_active=NACT1,
         kappa=KAPPA, seed=SEED1, launches=launches, **out, card=card)
    return ok and not any(launches.values()), launches


def config5():
    """bench_extra.py:199-216: BASELINE config 5's MIQPs, f32."""
    rng = np.random.default_rng(SEED5)
    Q = rng.standard_normal((B5, N5, N5)).astype(np.float32)
    H = np.einsum('bij,bkj->bik', Q, Q) + 0.5 * np.eye(N5, dtype=np.float32)
    f = (10 * rng.standard_normal((B5, N5))).astype(np.float32)
    A = rng.standard_normal((B5, M5, N5)).astype(np.float32)
    bu = (20 * rng.random((B5, M5))).astype(np.float32)
    bl = (-20 * rng.random((B5, M5))).astype(np.float32)
    bu[:, :NB5] = 1.0
    bl[:, :NB5] = 0.0
    A[:, :NB5] = 0.0
    A[:, np.arange(NB5), np.arange(NB5)] = 1.0
    sense = np.zeros((B5, M5), np.int32)
    sense[:, :NB5] = dt.BINARY
    return dict(H=H, f=f, A=A, bupper=bu, blower=bl, sense=sense)


def miqp_oracle(d5, lanes):
    """``oracle/bnb_numpy.solve_miqp`` in f64 on ``lanes``: (flags,
    fval)."""
    bnb = oracle_module("bnb_numpy")
    out = [bnb.solve_miqp(*(d5[k][b].astype(np.float64) for k in (
        'H', 'f', 'A', 'bupper', 'blower')), d5['sense'][b], ms=0)
        for b in lanes]
    return (np.array([o['exitflag'] for o in out]),
            np.array([o['fval'] for o in out]))


def phase_miqp(d5, st, card):
    """BASELINE config 5 through ``solve_batch_miqp_kernel`` on the card
    (K1, K2 with the per-lane dominance cut in every node wave), against
    the f64 oracle on every MIQP_STRIDE-th lane: the same exit flag, fval
    within MIQP_TOL (1 + |fval|), no lane flagged 1 beyond it; the optimal
    rate over the batch at least the JAX tier's census; K1 and K2
    launched, B7 not."""
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    H, f, A, bu, bl, sense = (torch.as_tensor(d5[k], device=dev) for k in (
        'H', 'f', 'A', 'bupper', 'blower', 'sense'))

    def solve(i=0):
        return dt.solve_batch_miqp_kernel(H, f + 1e-4 * i, A, bu, bl, sense,
                                          st)

    reset_counts()
    torch.cuda.synchronize()
    tw = time.perf_counter()
    r = solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - tw
    launches = read_counts()
    syncs, waves = ops.host_syncs, pbatch.miqp_waves
    flags = r.exitflag.cpu().numpy()
    fval = r.fval.cpu().numpy().astype(np.float64)
    nodes = r.iterations.cpu().numpy()
    lanes = np.arange(0, B5, MIQP_STRIDE)
    t_or = time.perf_counter()
    ref_flags, ref_fval = miqp_oracle(d5, lanes)
    oracle_s = time.perf_counter() - t_or
    rel = np.abs(fval[lanes] - ref_fval) / (1.0 + np.abs(ref_fval))
    opt_ref = ref_flags == 1
    flag_diffs = [int(b) for b, a, o in zip(lanes, flags[lanes], ref_flags)
                  if a != o]
    beyond = [int(b) for b, e, o in zip(lanes, rel, opt_ref)
              if o and e > MIQP_TOL]
    silent = [int(b) for b, a, e, o in zip(lanes, flags[lanes], rel, opt_ref)
              if a == 1 and (not o or e > MIQP_TOL)]
    calls = 4
    best = None
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(calls):
            solve(i)
        torch.cuda.synchronize()
        w = time.perf_counter() - t
        best = w if best is None else min(best, w)
    opt_rate = float(np.mean(flags == 1))
    x = r.x.cpu().numpy()
    shape_ok = x.shape == (B5, N5) and r.lam.shape == (B5, M5) \
        and bool(np.isfinite(x[flags == 1]).all())
    emit("miqp", t0, B=B5, n=N5, m=M5, binaries=NB5, seed=SEED5,
         launches=launches, waves=waves, host_syncs_per_call=syncs,
         host_syncs_per_wave=syncs / max(waves, 1), wall_s=wall,
         mean_nodes=float(nodes.mean()), max_nodes=int(nodes.max()),
         flags={int(k): int(v) for k, v in zip(*np.unique(
             flags, return_counts=True))},
         optimal_rate=opt_rate, optimal_gate=JAX_MIQP_OPT_RATE,
         gated_lanes=int(lanes.size), flag_diffs=flag_diffs,
         fval_beyond=beyond, silent_wrong=len(silent),
         max_fval_rel_err=float(rel[opt_ref].max()) if opt_ref.any()
         else None, oracle_s=oracle_s, shape_finite_ok=shape_ok,
         miqp_per_s=calls * B5 / best, window_s=best, card=card)
    ok = shape_ok and not flag_diffs and not beyond and not silent \
        and opt_rate >= JAX_MIQP_OPT_RATE and launches["chol_rinv"] >= 1 \
        and launches["slot_round"] >= 1 and launches["dense_round"] == 0
    return ok, launches


def timed_solves(fn, items):
    """``fn(item)`` for each item, on the card: (results, the median ms a
    solve, host syncs a solve)."""
    s0 = ops.host_syncs
    out, ms = [], []
    for it in items:
        torch.cuda.synchronize()
        t = time.perf_counter()
        out.append(fn(it))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
    return out, float(np.median(ms)), (ops.host_syncs - s0) / len(items)


def phase_meta(d_lp, d_avi, d4b, d5, card):
    """The single-instance meta-solvers on the card, each class its own
    gate: META_LP configLP LPs through ``dt.linprog`` in f32 with the
    default f64 backstop at configLP's iteration limit (bench_lp's gate), META_AVI configAVI AVIs
    through ``dt.avi`` in f64 (AVI_TOL of the constructed solution),
    META_HIQP config-4b hierarchies through ``dt.quadprog(break_points=
    ...)`` in f64 at the tier's rho (HIQP_TOL of the f64 oracle at that
    rho), META_MIQP config-5 MIQPs through ``dt.quadprog`` in f64 (the
    oracle's flag, fval within META_MIQP_TOL); then one ``dt.Model`` each
    of an LP, a hierarchy and a MIQP, whose solve must equal the one-shot
    result.  No kernel is launched."""
    t0 = time.perf_counter()
    f64 = dict(dtype=torch.float64, device="cuda")
    reset_counts()
    out = {}

    # configLP's iteration limit (bench_lp's): an f32 LP can run to it at
    # its arithmetic floor before the f64 re-solve (PERF.md §6)
    lp_res, ms, syn = timed_solves(lambda b: dt.linprog(
        d_lp['f'][b], d_lp['A'][b], d_lp['bupper'][b], d_lp['blower'][b],
        d_lp['sense'][b], ms=0, settings={"iter_limit": 3000},
        dtype=torch.float32, device="cuda"), range(META_LP))
    sub = {k: v[:META_LP] for k, v in d_lp.items()}
    xs = np.stack([r.x.cpu().numpy().astype(np.float64) for r in lp_res])
    gap, feas = lp_gate(sub, xs)
    fl = np.array([r.exitflag for r in lp_res])
    ok_lp = bool(((fl == 1) & (gap < LP_TOL) & (feas < LP_TOL)).all())
    out["lp"] = dict(solves=META_LP, flags={int(k): int(v) for k, v in zip(
        *np.unique(fl, return_counts=True))},
        resolved_in_f64=int(sum(r.x.dtype == torch.float64 for r in lp_res)),
        max_gap=float(gap.max()), max_feas=float(feas.max()),
        median_ms=ms, host_syncs_per_solve=syn)

    avi_res, ms, syn = timed_solves(lambda b: dt.avi(
        *(d_avi[k][b] for k in ('H', 'f', 'A', 'bupper', 'blower',
                                'sense')), ms=0, **f64), range(META_AVI))
    err = np.array([np.abs(r.x.cpu().numpy() - d_avi['x'][b]).max()
                    for b, r in enumerate(avi_res)])
    fl = np.array([r.exitflag for r in avi_res])
    ok_avi = bool(((fl == 1) & (err < AVI_TOL)).all())
    out["avi"] = dict(solves=META_AVI, flags={int(k): int(v) for k, v in zip(
        *np.unique(fl, return_counts=True))}, max_err=float(err.max()),
        median_ms=ms, host_syncs_per_solve=syn)

    hq = oracle_module("hiqp_numpy")
    st4b = {"rho_soft": HIQP_RHO}
    hier_res, ms, syn = timed_solves(lambda b: dt.quadprog(
        None, d4b['f'][b], d4b['A'][b], d4b['bupper'][b], d4b['blower'][b],
        d4b['sense'][b], ms=0, break_points=BP4B, settings=st4b, **f64),
        range(META_HIQP))
    refs = [hq.hiqp(None, *(d4b[k][b].astype(np.float64) for k in (
        'f', 'A', 'bupper', 'blower')), d4b['sense'][b], 0, BP4B, st4b)
        for b in range(META_HIQP)]
    err = np.array([np.abs(r.x.cpu().numpy() - o['x']).max()
                    for r, o in zip(hier_res, refs)])
    fl = np.array([r.exitflag for r in hier_res])
    fo = np.array([o['exitflag'] for o in refs])
    # the classes of hiqp_counts: optimal (1, 2), no DOF (3), loud
    same = hiqp_class(fl) == hiqp_class(fo)
    ok_hier = bool(same.all() and (err[np.isin(fo, (1, 2))]
                                   <= HIQP_TOL).all())
    out["hierarchy"] = dict(solves=META_HIQP, flags={
        int(k): int(v) for k, v in zip(*np.unique(fl, return_counts=True))},
        oracle_classes_equal=bool(same.all()), max_err=float(err.max()),
        median_ms=ms, host_syncs_per_solve=syn)

    mi_res, ms, syn = timed_solves(lambda b: dt.quadprog(
        *(d5[k][b] for k in ('H', 'f', 'A', 'bupper', 'blower', 'sense')),
        ms=0, **f64), range(META_MIQP))
    ref_flags, ref_fval = miqp_oracle(d5, range(META_MIQP))
    fl = np.array([r.exitflag for r in mi_res])
    fv = np.array([float(r.fval) for r in mi_res])
    rel = np.abs(fv - ref_fval) / (1.0 + np.abs(ref_fval))
    ok_mi = bool((fl == ref_flags).all() and (rel[ref_flags == 1]
                                             <= META_MIQP_TOL).all())
    out["miqp"] = dict(solves=META_MIQP, flags={int(k): int(v) for k, v in
                                                zip(*np.unique(
                                                    fl, return_counts=True))},
                       oracle_flags_equal=bool((fl == ref_flags).all()),
                       max_fval_rel_err=float(rel.max()),
                       mean_nodes=float(np.mean([r.nodes for r in mi_res])),
                       median_ms=ms, host_syncs_per_solve=syn)

    models = {}
    for name, setup, one in (
            ("lp", lambda m_: m_.setup(None, d_lp['f'][0], d_lp['A'][0],
                                       d_lp['bupper'][0], d_lp['blower'][0],
                                       ms=0, **f64),
             lambda: dt.linprog(d_lp['f'][0], d_lp['A'][0],
                                d_lp['bupper'][0], d_lp['blower'][0], ms=0,
                                **f64)),
            ("hierarchy", lambda m_: m_.setup(
                None, d4b['f'][0], d4b['A'][0], d4b['bupper'][0],
                d4b['blower'][0], ms=0, break_points=BP4B, **f64),
             lambda: dt.quadprog(None, d4b['f'][0], d4b['A'][0],
                                 d4b['bupper'][0], d4b['blower'][0], ms=0,
                                 break_points=BP4B, settings=st4b, **f64)),
            ("miqp", lambda m_: m_.setup(*(d5[k][0] for k in (
                'H', 'f', 'A', 'bupper', 'blower', 'sense')), ms=0, **f64),
             lambda: dt.quadprog(*(d5[k][0] for k in (
                 'H', 'f', 'A', 'bupper', 'blower', 'sense')), ms=0,
                 **f64))):
        st_m = st4b if name == "hierarchy" else None
        r = setup(dt.Model(st_m)).solve()
        o = one()
        models[name] = dict(flag=r.exitflag, equal_to_one_shot=bool(
            torch.equal(r.x, o.x) and r.exitflag == o.exitflag),
            on_card=r.x.is_cuda)
    ok_models = all(v["equal_to_one_shot"] and v["on_card"]
                    for v in models.values())
    launches = read_counts()
    emit("meta", t0, launches=launches, models=models, **out, card=card)
    ok = ok_lp and ok_avi and ok_hier and ok_mi and ok_models \
        and not any(launches.values())
    return ok, launches


def flat_window(fn):
    """``fn()`` with every count set to 0 just before and read just after:
    (result, launches, host syncs, flat rounds, wall seconds)."""
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return r, read_counts(), ops.host_syncs, ldp_flat.rounds, wall


def flat_gate(r, x_ref, tol):
    """Cell 2's gate at ``tol``: (passes at ACC_RATE with no lane flagged
    1 beyond tol, fields)."""
    x = r.x.cpu().numpy().astype(np.float64)
    flags = r.exitflag.cpu().numpy()
    err = np.linalg.norm(x - x_ref, axis=1)
    acc = float(np.mean((flags == 1) & (err <= tol)))
    silent = int(np.sum((flags == 1) & (err > tol)))
    ok = acc >= ACC_RATE and silent == 0 and bool(np.isfinite(x).all())
    return ok, dict(accuracy_pass_rate=acc, silent_wrong=silent,
                    optimal_rate=float(np.mean(flags == 1)),
                    max_err_optimal=float(err[flags == 1].max())
                    if (flags == 1).any() else None,
                    median_iters=float(np.median(
                        r.iterations.cpu().numpy())))


def grid_batch(gen, n, m, ms, nact, Bn):
    """``Bn`` QPs of scripts/grid_accuracy.py's generator at one size, in
    its order (rng 1000 + n): (x_ref f64, the f32 tensors on the card)."""
    rng = np.random.default_rng(GRID_SEED + n)
    probs = [gen.generate_test_qp(n, m, ms, nact, KAPPA, rng)
             for _ in range(Bn)]
    x, H, f, A, bu, bl, sense = (np.stack(v) for v in zip(*probs))
    dev = torch.device("cuda")
    return x, [torch.as_tensor(v.astype(np.float32), device=dev)
               for v in (H, f, A, bu, bl)] + [torch.as_tensor(sense,
                                                              device=dev)]


def phase_flat(head, x_head, d64_head, gen, d3, d5, st, card):
    """The flat tier and ``solve_batch``'s routing, each case its own count
    window: (a) config 2's first FLAT_LANES lanes through
    ``solve_batch_flat_jit`` at cell 2's gate (K1 factors); (b) its first
    FLAT_ROUTE lanes through ``solve_batch`` in f32 (the kernel route: K2,
    no flat round) and in f64 (the flat tier: no kernel, within F64_TOL);
    (c) the reference grid's sizes through ``solve_batch`` (the flat route:
    K1 at n = 100, B10 at n = 200 and 500), no lane flagged 1 beyond
    ACC_TOL, then ``backstop_resolve``: every lane flag 1 within ACC_TOL;
    B10 and the library timed on the n = 500 batch; (d) config 3's
    scenario 0 through ``solve_mpc_scan`` against the f64 oracle per step
    (MPC_TOL); (e) config 5's first FLAT_MIQP MIQPs in f64 through
    ``solve_batch_miqp_jit`` against ``oracle/bnb_numpy.py`` (the flag,
    fval within META_MIQP_TOL)."""
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    limit = smem.available(dev)
    out, windows, ok = {}, {}, True

    # (a) the flat tier at config 2's widths, then the same lanes in
    # chunks of 512 (the JAX tier's chunk) for the wall beside
    r, cnt, syncs, rounds, wall = flat_window(
        lambda: pbatch.solve_batch_flat_jit(*head, st))
    good, fields = flat_gate(r, x_head, ACC_TOL)
    _, _, syncs2, rounds2, wall2 = flat_window(
        lambda: pbatch.solve_batch_flat_jit(*head, st))
    _, _, syncs512, rounds512, wall512 = flat_window(
        lambda: pbatch.solve_batch_flat_jit(*head, st, lane_chunk=512))
    out["a"] = dict(lanes=FLAT_LANES, lane_chunk=pbatch.LANE_CHUNK,
                    launches=cnt, rounds=rounds, host_syncs=syncs,
                    first_wall_s=wall, wall_s=wall2,
                    lanes_per_s=FLAT_LANES / wall2, rounds_again=rounds2,
                    host_syncs_again=syncs2, chunk512=dict(
                        wall_s=wall512, rounds=rounds512,
                        host_syncs=syncs512,
                        lanes_per_s=FLAT_LANES / wall512), **fields)
    windows["flat"] = cnt
    ok = ok and good and cnt["chol_rinv"] >= 1 and rounds >= 1

    # (b) solve_batch routes: f32 to the kernel stream, f64 to the flat
    a32 = [a[:FLAT_ROUTE] for a in head]
    r, c32, s32, n32, w32 = flat_window(lambda: dt.solve_batch(
        *a32, settings=st))
    g32, f32_ = flat_gate(r, x_head[:FLAT_ROUTE], ACC_TOL)
    a64 = [torch.as_tensor(d64_head[k], device=dev) for k in (
        'H', 'f', 'A', 'bupper', 'blower', 'sense')]
    r, c64, s64, n64, w64 = flat_window(lambda: dt.solve_batch(
        *a64, settings={"iter_limit": 1000}))
    g64, f64_ = flat_gate(r, d64_head['x'], F64_TOL)
    route32 = pbatch.batch_route(torch.float32, N, M_ROWS, False, False,
                                 limit)
    route64 = pbatch.batch_route(torch.float64, N, M_ROWS, False, False,
                                 limit)
    out["b"] = dict(f32=dict(route=route32, launches=c32, rounds=n32,
                             host_syncs=s32, wall_s=w32, **f32_),
                    f64=dict(route=route64, launches=c64, rounds=n64,
                             host_syncs=s64, wall_s=w64, tol=F64_TOL,
                             x_dtype=str(r.x.dtype), **f64_))
    windows["flat_route_f32"], windows["flat_route_f64"] = c32, c64
    ok = ok and g32 and g64 and route32 == "kernel" and route64 == "flat" \
        and c32["slot_round"] >= 1 and n32 == 0 \
        and sum(c64.values()) == 0 and n64 >= 1 \
        and r.x.dtype == torch.float64

    # (c) the reference grid as batches, past the kernels' blocks
    routes = {n: chol.factor_route(n, limit) for n in (
        chol.WARP_ROUTE_N, chol.WARP_ROUTE_N + 1, B10_LIMIT, B10_LIMIT + 1)}
    ok = ok and list(routes.values()) == ["k1", "b10", "b10", "library"]
    out["factor_routes"] = routes
    for n, m, ms, nact, Bn in FLAT_GRID:
        x_ref, args = grid_batch(gen, n, m, ms, nact, Bn)
        r, cnt, syncs, rounds, wall = flat_window(
            lambda: dt.solve_batch(*args, ms=ms))
        flags = r.exitflag.cpu().numpy()
        err = np.linalg.norm(r.x.cpu().numpy().astype(np.float64) - x_ref,
                             axis=1)
        silent = int(np.sum((flags == 1) & (err > ACC_TOL)))
        tb = time.perf_counter()
        before = pbatch.backstop_lanes
        rb = pbatch.backstop_resolve(r, *args, ms=ms)
        fb = rb.exitflag.cpu().numpy()
        eb = np.linalg.norm(rb.x.cpu().numpy().astype(np.float64) - x_ref,
                            axis=1)
        factor = chol.factor_route(n, limit)
        kernel = {"k1": "chol_rinv", "b10": "chol_blk"}[factor]
        rec = dict(B=Bn, m=m, ms=ms, active=nact,
                   route=pbatch.batch_route(torch.float32, n, m, False,
                                            False, limit),
                   factor=factor, launches=cnt, rounds=rounds,
                   host_syncs=syncs, wall_s=wall, lanes_per_s=Bn / wall,
                   flags={int(k): int(v) for k, v in zip(*np.unique(
                       flags, return_counts=True))},
                   loud=int(np.sum(flags != 1)), silent_wrong=silent,
                   max_err_optimal=float(err[flags == 1].max())
                   if (flags == 1).any() else None,
                   iterations=r.iterations.cpu().numpy().tolist(),
                   backstop_lanes=pbatch.backstop_lanes - before,
                   backstop_s=time.perf_counter() - tb,
                   after_backstop_ok=bool(np.all((fb == 1)
                                                 & (eb <= ACC_TOL))),
                   after_backstop_max_err=float(eb.max()))
        if n == 500:
            H = args[0]
            t = in_turns(lambda: library_rinv(H),
                         lambda: chol.chol_rinv_blk(H), 5, rounds=1)
            rec["b10_ms"], rec["library_ms"] = t["second"], t["first"]
            rec["b10_vs_library"] = (chol.chol_rinv_blk(H)
                                     - library_rinv(H)).abs().max().item()
            rec.update(bound(H.element_size() * Bn * (n * (n + 1) // 2
                                                      + n * n),
                             Bn * 2 * n ** 3 / 3))
        out[f"c_n{n}"] = rec
        windows[f"flat_grid_n{n}"] = cnt
        other = "chol_blk" if kernel == "chol_rinv" else "chol_rinv"
        ok = ok and rec["route"] == "flat" and cnt[kernel] >= 1 \
            and cnt[other] == 0 and silent == 0 and rec["after_backstop_ok"]
        del args, r, rb

    # (d) config 3's scenario 0 on the flat horizon, against the f64
    # oracle at every step
    oracle = load("daqp_oracle", "oracle/daqp_numpy.py")
    args3 = [torch.as_tensor(d3[k][0] if k.endswith("seq") else d3[k],
                             device=dev)
             for k in ('H', 'A', 'f_seq', 'bu_seq', 'bl_seq')]
    r, cnt, syncs, rounds, wall = flat_window(
        lambda: dt.solve_mpc_scan(*args3, st))
    flags = r.exitflag.cpu().numpy()
    x = r.x.cpu().numpy().astype(np.float64)
    err = np.array([np.linalg.norm(x[t] - oracle.quadprog(*(
        v.astype(np.float64) for v in (
            d3['H'], d3['f_seq'][0, t], d3['A'], d3['bu_seq'][0, t],
            d3['bl_seq'][0, t])))['x']) for t in range(T3)])
    out["d"] = dict(T=T3, launches=cnt, rounds=rounds, host_syncs=syncs,
                    wall_s=wall, flags=flags.tolist(),
                    iterations=r.iterations.cpu().numpy().tolist(),
                    max_err=float(err.max()), tol=MPC_TOL)
    windows["flat_mpc"] = cnt
    ok = ok and bool(np.all(flags == 1)) and err.max() <= MPC_TOL \
        and cnt["chol_rinv"] == 1

    # (e) config 5's first MIQPs in f64, one branch and bound a lane
    lanes = np.arange(FLAT_MIQP)
    a5 = [torch.as_tensor(d5[k][lanes].astype(np.float64)
                          if k != 'sense' else d5[k][lanes], device=dev)
          for k in ('H', 'f', 'A', 'bupper', 'blower', 'sense')]
    r, cnt, syncs, rounds, wall = flat_window(
        lambda: pbatch.solve_batch_miqp_jit(
            *a5, dt.as_settings(None, torch.float64),
            bin_ids=tuple(range(NB5))))
    ref_flags, ref_fval = miqp_oracle(d5, lanes)
    flags = r.exitflag.cpu().numpy()
    rel = np.abs(r.fval.cpu().numpy() - ref_fval) / (1.0 + np.abs(ref_fval))
    out["e"] = dict(lanes=FLAT_MIQP, launches=cnt, host_syncs=syncs,
                    wall_s=wall, flags=flags.tolist(),
                    oracle_flags=ref_flags.tolist(),
                    nodes=r.nodes.cpu().numpy().tolist(),
                    max_fval_rel_err=float(rel.max()), tol=META_MIQP_TOL)
    windows["flat_miqp"] = cnt
    ok = ok and bool(np.all(flags == ref_flags)) \
        and bool(np.all(rel[ref_flags == 1] <= META_MIQP_TOL))
    emit("flat", t0, **out, card=card)
    return ok, windows


def loud(flags):
    return int(np.sum(flags <= 0))


def force_failures(res):
    """``res`` with every BACK_STRIDE-th lane loud (ITERLIMIT and x zero,
    as a lane that ran out of iterations) and every BACK_STRIDE-th from
    BACK_STRIDE // 2 silent (its flag kept, x moved by BACK_SHIFT):
    (result, the lanes changed)."""
    lanes = torch.arange(res.x.shape[0], device=res.x.device)
    loud_ = (lanes % BACK_STRIDE == 0)[:, None]
    silent = (lanes % BACK_STRIDE == BACK_STRIDE // 2)[:, None]
    x = torch.where(loud_, 0.0, res.x) + BACK_SHIFT * silent
    flags = torch.where(loud_[:, 0], dt.EXIT_ITERLIMIT, res.exitflag)
    forced = res._replace(x=x.to(res.x.dtype), exitflag=flags.to(
        res.exitflag.dtype))
    return forced, (loud_ | silent)[:, 0].cpu().numpy()


def phase_backstop(full, d, sw_np, st, card):
    """Step 4 of the main path.  (a) Config 2's first B_BACK lanes through
    the stream, lanes made to fail (``force_failures``), then
    ``backstop_resolve``: every changed lane re-solved, every lane flag 1
    within ACC_TOL.  (b) The 2-sw batch through the stream, then
    ``backstop_resolve(sw=...)`` of the sw phase's sample and the first
    SW_BACK_LOUD loud lanes: no lane it re-solves to a flag > 0 lies
    beyond SW_TOL of the lifted f64 QP, and the loud count does not grow.
    (c) An expired deadline gives every lane of (a)'s batch TIMELIMIT, a
    generous one the flags of none."""
    t0 = time.perf_counter()
    args = [a[:B_BACK] for a in full]
    x_ref = d['x'][:B_BACK]

    reset_counts()
    res = dt.solve_batch_kernel_stream(*args, st=st, chunk=B_CHUNK)
    torch.cuda.synchronize()
    launches = read_counts()
    syncs0 = ops.host_syncs
    res, changed = force_failures(res)
    flags0 = res.exitflag.cpu().numpy()
    lanes0 = pbatch.backstop_lanes
    tb = time.perf_counter()
    fixed = dt.backstop_resolve(res, *args, ms=0)
    torch.cuda.synchronize()
    back_s = time.perf_counter() - tb
    n_back = pbatch.backstop_lanes - lanes0
    flags1 = fixed.exitflag.cpu().numpy()
    err = np.linalg.norm(fixed.x.cpu().numpy().astype(np.float64) - x_ref,
                         axis=1)
    forced = dict(lanes=B_BACK, stride=BACK_STRIDE, shift=BACK_SHIFT,
                  changed=int(changed.sum()), loud_before=loud(flags0),
                  loud_after=loud(flags1), resolved=n_back,
                  ms_per_resolved_lane=1e3 * back_s / max(n_back, 1),
                  syncs_stream=syncs0,
                  syncs_backstop=ops.host_syncs - syncs0,
                  max_err=float(err.max()),
                  max_err_changed=float(err[changed].max()),
                  on_card=fixed.x.is_cuda)
    ok = n_back >= int(changed.sum()) and bool((flags1 == 1).all()) \
        and float(err.max()) <= ACC_TOL and fixed.x.is_cuda

    # (b) the 2-sw batch
    oracle = oracle_module("daqp_numpy")
    sargs = full[:5] + [soft_sense(full[5])]
    sw = sw_tensors(sw_np, full[0].device)
    res_sw = dt.solve_batch_kernel_stream(*sargs, st=st, chunk=B_CHUNK,
                                          has_soft=True, sort_stream=True,
                                          sw=sw)
    fs_all = res_sw.exitflag.cpu().numpy()
    idx = np.arange(0, B, SW_STRIDE) + np.arange(B // SW_STRIDE) % 2
    idx = np.union1d(idx, np.flatnonzero(fs_all <= 0)[:SW_BACK_LOUD])
    it = torch.as_tensor(idx, device=full[0].device)
    res_s = res_sw._replace(**{k: v[it] for k, v in
                               res_sw._asdict().items()})
    fs0 = fs_all[idx]
    s1, l1 = ops.host_syncs, pbatch.backstop_lanes
    tb = time.perf_counter()
    fixed_sw = dt.backstop_resolve(res_s, *(a[it] for a in sargs), ms=0,
                                   settings=st,
                                   sw=sw_tensors(sw_np, full[0].device,
                                                 idx))
    torch.cuda.synchronize()
    sw_s = time.perf_counter() - tb
    n_sw = pbatch.backstop_lanes - l1
    fs1 = fixed_sw.exitflag.cpu().numpy()
    x_sw = fixed_sw.x.cpu().numpy().astype(np.float64)
    moved = np.nonzero((fs1 != fs0) | (fixed_sw.x != res_s.x).any(1)
                       .cpu().numpy())[0]
    beyond = [int(idx[i]) for i in moved if fs1[i] > 0
              and np.abs(x_sw[i] - lifted_reference(oracle, d, sw_np,
                                                    idx[i])[0]).max()
              > SW_TOL]
    sw_fields = dict(lanes=len(idx), of=B, loud_in_batch=loud(fs_all),
                     loud_before=loud(fs0), loud_after=loud(fs1),
                     resolved=n_sw, changed=len(moved),
                     ms_per_resolved_lane=1e3 * sw_s / max(n_sw, 1),
                     syncs_backstop=ops.host_syncs - s1,
                     beyond_gate=beyond)
    ok &= loud(fs1) <= loud(fs0) and not beyond

    # (c) the deadline
    plain = dt.solve_batch_kernel_stream(*args, st=st, chunk=B_CHUNK)
    ops.host_syncs = 0
    late = dt.solve_batch_kernel_stream(*args, st=st, chunk=B_CHUNK,
                                        deadline=time.perf_counter() - 1.0)
    syncs_late = ops.host_syncs
    ops.host_syncs = 0
    far = dt.solve_batch_kernel_stream(*args, st=st, chunk=B_CHUNK,
                                       deadline=time.perf_counter() + 1e6)
    syncs_far = ops.host_syncs
    ops.host_syncs = 0
    dt.solve_batch_kernel_stream(*args, st=st, chunk=B_CHUNK)
    syncs_none = ops.host_syncs
    all_late = bool((late.exitflag == dt.EXIT_TIMELIMIT).all())
    same = bool(torch.equal(far.exitflag, plain.exitflag))
    ok &= all_late and same and syncs_far == syncs_none
    emit("backstop", t0, launches=launches, forced=forced, sw=sw_fields,
         deadline=dict(expired_all_timelimit=all_late,
                       generous_same_flags=same, syncs_expired=syncs_late,
                       syncs_generous=syncs_far, syncs_none=syncs_none),
         card=card)
    return ok and launches["chol_rinv"] >= 1 \
        and launches["slot_round"] >= 1, launches


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def stats_of(r):
    """``ShardedStats`` as the unsharded result ``r`` gives them."""
    it = r.iterations.long()
    return (int(it.sum()), int((r.exitflag == 1).sum()), int(it.max()))


def against_unsharded(r, stats, u, tol=ACC_TOL):
    """A sharded result ``r`` (its ``stats``) against the unsharded ``u``:
    (the same flags, every lane within ``tol``, stats equal, fields)."""
    same = bool(torch.equal(r.exitflag, u.exitflag))
    dx = float((r.x - u.x).double().norm(dim=1).max())
    want = stats_of(u)
    return same and dx <= tol and tuple(stats) == want, dict(
        same_flags=same, max_dx_unsharded=dx, stats=list(stats),
        unsharded_stats=list(want))


def miqp5_f64(d5):
    """Config 5's first MIQP in f64 (sense as is)."""
    return [d5[k][0].astype(np.float64) if k != 'sense' else d5[k][0]
            for k in ('H', 'f', 'A', 'bupper', 'blower', 'sense')]


def tree_gate(out, one):
    """The tree-sharded MIQP's (x, fval, status, nodes) against the
    single solve ``one``: its flag, fval within META_MIQP_TOL (1 +
    |fval|)."""
    x, fval, status, nodes = out
    ref = float(one.fval)
    rel = abs(float(fval) - ref) / (1.0 + abs(ref))
    ok = status == one.exitflag and rel <= META_MIQP_TOL \
        and bool(torch.isfinite(x).all())
    return ok, dict(status=status, single_status=one.exitflag,
                    fval=float(fval), single_fval=ref, fval_rel_err=rel,
                    nodes=nodes, single_nodes=one.nodes)


def scale_worker(rank, port, path):
    """One rank of ``scale`` (b): two processes in a gloo group on the
    one card, each solving its half of the saved lanes through
    ``tier="pallas"`` and its half of config 5's first MIQP's tree (D =
    2); rank 0 holds the stats and the tree against the unsharded calls.
    Prints one JSON line; exits 1 when a check fails."""
    from daqp_tpu_torch.parallel import distributed, sharding
    rank = int(rank)
    data = np.load(path)
    keys = ('H', 'f', 'A', 'bupper', 'blower', 'sense')
    distributed.initialize("gloo", init_method=f"tcp://localhost:{port}",
                           world_size=2, rank=rank)
    try:
        world = distributed.global_mesh("cuda:0")
        st = dt.as_settings({"iter_limit": 1000}, torch.float32)
        args = distributed.distribute_batch(world,
                                            *(data[k] for k in keys))
        k = args[0].shape[0]
        t0 = time.perf_counter()
        (r, stats), cnt, _, _, wall = flat_window(
            lambda: sharding.solve_batch_sharded(*args, st, world,
                                                 tier="pallas"))
        ok, fields = flat_gate(r, data['x'][rank * k:(rank + 1) * k],
                               ACC_TOL)
        a5 = miqp5_f64(config5())
        st64 = dt.as_settings(None, torch.float64)
        tree = sharding.solve_miqp_sharded(*a5, 0, st64, world)
        out = dict(rank=rank, lanes=k, launches=cnt, wall_s=wall,
                   stats=list(stats), gate_ok=ok, **fields)
        if rank == 0:
            full = [torch.as_tensor(data[k], device=world.device)
                    for k in keys]
            u = pbatch.solve_batch_kernel_stream(*full, st)
            want = stats_of(u)
            one = dt.quadprog(*a5, ms=0, dtype=torch.float64,
                              device="cuda")
            tok, tfields = tree_gate(tree, one)
            out.update(unsharded_stats=list(want), tree=tfields)
            ok = ok and tuple(stats) == want and tok
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps({"scale_worker": out}), flush=True)
        return 0 if ok and cnt["chol_rinv"] >= 1 \
            and cnt["slot_round"] >= 1 else 1
    finally:
        torch.distributed.destroy_process_group()


def scale_two_processes(d, card):
    """``scale`` (b): this script re-run twice as ``--scale-worker``
    ranks on the one card over gloo; (passes, fields, windows)."""
    keys = ('H', 'f', 'A', 'bupper', 'blower', 'sense', 'x')
    outs, rcs, timed_out = [], [], False
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "scale.npz")
        np.savez(path, **{k: d[k][:SCALE_2PROC] for k in keys})
        port = free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--scale-worker",
             str(rank), str(port), path], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for rank in range(2)]
        try:
            for p in procs:
                left = SCALE_WORKER_S - (time.perf_counter() - t0)
                outs.append(p.communicate(timeout=max(left, 1.0))[0])
                rcs.append(p.returncode)
        except subprocess.TimeoutExpired:
            timed_out = True
        finally:
            for p in procs:
                p.kill()
                p.wait()
        wall = time.perf_counter() - t0
    found = [json.loads(line)["scale_worker"] for out in outs
             for line in out.splitlines()
             if line.startswith('{"scale_worker"')]
    ok = not timed_out and rcs == [0, 0] and len(found) == 2
    if not ok:
        print("\n".join(out[-3000:] for out in outs), file=sys.stderr)
    windows = {f"scale_gloo_rank{w['rank']}": w["launches"] for w in found}
    return ok, dict(ranks=found, return_codes=rcs, timed_out=timed_out,
                    wall_s=wall), windows


def render_case(gen, card):
    """``scale`` (d): config 1's first QP rendered as C, built with
    ``cc -O2 -shared`` and solved, against ``dt.quadprog`` on the card
    in f64."""
    x_ref, H, f, A, bu, bl, sense = config1(gen)[0]
    one = dt.quadprog(H, f, A, bu, bl, sense, ms=MS1, device="cuda",
                      dtype=torch.float64)
    with tempfile.TemporaryDirectory() as td:
        t = time.perf_counter()
        cpath = codegen.render_c(H, f, A, bu, bl, name="cfg1", dir=td,
                                 sense=sense, ms=MS1)
        so = os.path.join(td, "cfg1.so")
        subprocess.run(["cc", "-O2", "-fPIC", "-shared", "-o", so, cpath,
                        "-lm"], check=True)
        build_s = time.perf_counter() - t
        lib = ctypes.CDLL(so)
        lib.cfg1_init()
        xs = (ctypes.c_double * N1)()
        fval, iters = ctypes.c_double(), ctypes.c_int()
        flag = lib.cfg1_solve(xs, None, ctypes.byref(fval),
                              ctypes.byref(iters))
    x = np.array(xs[:])
    dx = float(np.linalg.norm(x - one.x.cpu().numpy()))
    df = abs(fval.value - float(one.fval))
    ok = flag == one.exitflag == 1 and dx <= SINGLE_TOL64 \
        and df <= SINGLE_TOL64
    return ok, dict(flag=flag, single_flag=one.exitflag, max_dx=dx,
                    fval_diff=df, c_iterations=iters.value,
                    single_iterations=one.iterations,
                    err_x_ref=float(np.linalg.norm(x - x_ref)),
                    render_and_cc_s=build_s)


def phase_scale(head, x_head, d, args4, d5, gen, st, card):
    """Scale-out (``parallel``) and the deploy-time pieces, each solve its
    own count window: (a) an NCCL group of one in this process: config
    2's first FLAT_LANES lanes through ``solve_batch_sharded`` with
    ``tier="pallas"`` (K1, K2) and ``"flat"`` (K1), each against the
    unsharded call (the same flags, every lane within ACC_TOL, the stats
    its sums and max) and cell 2's gate; ``"prox"`` on config 4 (B4) under
    the f64 KKT certificate; ``solve_batch_miqp_sharded`` on config 5 (K1,
    K2) under ``miqp``'s gate; ``solve_miqp_sharded`` on config 5's first
    MIQP in f64 against ``dt.quadprog``'s flag and fval; (b) two processes
    on the card in a gloo group (``scale_two_processes``); (c)
    ``dt.warmup`` of every tier at config 2's widths, then the wall of
    the first config-2 stream call after it; (d) ``render_c`` of config
    1's first QP, compiled and solved (``render_case``)."""
    from daqp_tpu_torch.parallel import distributed, sharding
    t0 = time.perf_counter()
    out, windows, ok = {}, {}, True

    # (a) NCCL at world size 1
    ta = time.perf_counter()
    distributed.initialize("nccl", init_method=f"tcp://localhost:"
                           f"{free_port()}", world_size=1, rank=0)
    try:
        world = distributed.global_mesh()
        out["world"] = dict(rank=world.rank, size=world.size,
                            backend=world.backend, device=str(world.device))
        for tier, needs in (("pallas", ("chol_rinv", "slot_round")),
                            ("flat", ("chol_rinv",))):
            (r, stats), cnt, _, _, wall = flat_window(
                lambda: sharding.solve_batch_sharded(*head, st, world,
                                                     tier=tier))
            u = pbatch.solve_batch_kernel_stream(*head, st) \
                if tier == "pallas" else pbatch.solve_batch_flat_jit(*head, st)
            good, fields = against_unsharded(r, stats, u)
            gate, gfields = flat_gate(r, x_head, ACC_TOL)
            out[f"a_{tier}"] = dict(lanes=FLAT_LANES, launches=cnt,
                                    wall_s=wall, **fields, **gfields)
            windows[f"scale_{tier}"] = cnt
            ok = ok and good and gate and all(cnt[k] >= 1 for k in needs)

        (r, stats), cnt, _, _, wall = flat_window(
            lambda: sharding.solve_batch_sharded(*args4, st, world,
                                                 tier="prox"))
        flags = r.exitflag.cpu().numpy()
        stat, viol = dt.kkt_residuals(*args4, r.x, r.lam)
        opt = flags == 1
        silent = int(np.sum(opt & ((stat > KKT_TOL) | (viol > KKT_TOL))))
        out["a_prox"] = dict(B=B4, launches=cnt, wall_s=wall,
                             stats=list(stats),
                             optimal_rate=float(opt.mean()),
                             silent_wrong=silent)
        windows["scale_prox"] = cnt
        ok = ok and opt.mean() >= PROX_OPT and silent == 0 \
            and tuple(stats) == stats_of(r) and cnt["prox_segment"] >= 1

        a5 = [torch.as_tensor(d5[k], device=world.device) for k in (
            'H', 'f', 'A', 'bupper', 'blower', 'sense')]
        (r, stats), cnt, _, _, wall = flat_window(
            lambda: sharding.solve_batch_miqp_sharded(*a5, st, world))
        flags = r.exitflag.cpu().numpy()
        lanes = np.arange(0, B5, MIQP_STRIDE)
        ref_flags, ref_fval = miqp_oracle(d5, lanes)
        rel = np.abs(r.fval.cpu().numpy()[lanes].astype(np.float64)
                     - ref_fval) / (1.0 + np.abs(ref_fval))
        opt_ref = ref_flags == 1
        flag_diffs = int(np.sum(flags[lanes] != ref_flags))
        beyond = int(np.sum(opt_ref & (rel > MIQP_TOL)))
        out["a_miqp"] = dict(B=B5, launches=cnt, wall_s=wall,
                             stats=list(stats),
                             optimal_rate=float(np.mean(flags == 1)),
                             gated_lanes=int(lanes.size),
                             flag_diffs=flag_diffs, fval_beyond=beyond,
                             max_fval_rel_err=float(rel[opt_ref].max())
                             if opt_ref.any() else None)
        windows["scale_miqp"] = cnt
        ok = ok and flag_diffs == 0 and beyond == 0 \
            and np.mean(flags == 1) >= JAX_MIQP_OPT_RATE \
            and tuple(stats) == stats_of(r) \
            and cnt["chol_rinv"] >= 1 and cnt["slot_round"] >= 1

        m5 = miqp5_f64(d5)
        st64 = dt.as_settings(None, torch.float64)
        tree, cnt, _, _, wall = flat_window(
            lambda: sharding.solve_miqp_sharded(*m5, 0, st64, world))
        one = dt.quadprog(*m5, ms=0, dtype=torch.float64, device="cuda")
        good, fields = tree_gate(tree, one)
        out["a_tree"] = dict(launches=cnt, wall_s=wall, **fields)
        windows["scale_tree"] = cnt
        ok = ok and good
    finally:
        torch.distributed.destroy_process_group()
    out["a_seconds"] = time.perf_counter() - ta

    # (b) two processes on the one card over gloo
    good, out["b"], wins = scale_two_processes(d, card)
    windows.update(wins)
    ok = ok and good

    # (c) the warm-up, then the first config-2 stream call after it
    tiers = ("hard", "soft", "sw", "flat")
    secs, cnt, _, _, wall = flat_window(
        lambda: dt.warmup(N, M_ROWS, B_CHUNK, tiers=tiers))
    a = [x[:B_CHUNK] for x in head]
    r, _, _, _, first = flat_window(
        lambda: dt.solve_batch_kernel_stream(*a, st))
    gate, gfields = flat_gate(r, x_head[:B_CHUNK], ACC_TOL)
    out["c"] = dict(warmup_s=wall, tiers_s=secs, launches=cnt,
                    first_stream_wall_s=first, **gfields)
    windows["scale_warmup"] = cnt
    ok = ok and list(secs) == list(tiers) and gate \
        and all(cnt[k] >= 1 for k in ("chol_rinv", "slot_round",
                                      "dense_round"))

    # (d) embedded C of config 1's first QP
    good, out["d"] = render_case(gen, card)
    ok = ok and good
    print("scale: one card cannot show NCCL across cards (only a group of "
          "one), cross-card timing, or the bound exchange's cost between "
          "cards; the two ranks of (b) share the card and meet over gloo "
          "on the host", flush=True)
    emit("scale", t0, **out, card=card)
    return ok, windows


def graph_nodes(gm):
    """Nodes of an exported graph module, its loops' graphs included."""
    return len(gm.graph.nodes) + sum(graph_nodes(sub)
                                     for sub in gm.children()
                                     if hasattr(sub, "graph"))


def counted_syncs(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: (result,
    the synchronizing CUDA calls it made, counted by their warnings)."""
    import warnings
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            r = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return r, sum("synchronizing" in str(w.message) for w in seen)


def aot_worker(path):
    """``deploy`` (a)'s fresh process: ``import daqp_tpu_torch`` (which
    registers K1 and B10 as ops), ``torch.export.load`` the program at
    ``path`` (nothing is traced again), run it on the lanes saved beside
    it, twice (the second wall is warm), and hold the first run to cell
    2's gate; K1 must launch, counted by the op.  Writes the outputs to
    ``path + ".out.npz"``, prints one JSON line, exits 1 when a check
    fails."""
    data = np.load(path + ".npz")
    keys = ('H', 'f', 'A', 'bupper', 'blower', 'sense')
    args = [torch.as_tensor(data[k], device="cuda") for k in keys]
    t = time.perf_counter()
    prog = torch.export.load(path).module()
    load_s = time.perf_counter() - t
    (out, syncs), cnt, _, _, wall = flat_window(
        lambda: counted_syncs(lambda: prog(*args)))
    _, _, _, _, warm = flat_window(lambda: prog(*args))
    r = types.SimpleNamespace(x=out["x"], exitflag=out["exitflag"],
                              iterations=out["iterations"])
    ok, fields = flat_gate(r, data['x'], ACC_TOL)
    np.savez(path + ".out.npz", **{k: v.cpu().numpy()
                                   for k, v in out.items()})
    print(json.dumps({"aot_worker": dict(
        load_s=load_s, solve_wall_s=wall, warm_wall_s=warm,
        rounds=int(out["rounds"]), syncs=syncs, launches=cnt, gate_ok=ok,
        **fields)}), flush=True)
    return 0 if ok and cnt["chol_rinv"] >= 1 else 1


def aot_batch(head, x_head, st):
    """``deploy`` (a): ``export_aot(N, M_ROWS, batch=FLAT_LANES)`` in f32
    on the card, saved and run by ``--aot-worker`` in a fresh process,
    its flags, iterations and x held to this process's eager
    ``solve_batch_flat_jit`` lane for lane; (passes, fields, windows)."""
    import io
    keys = ('H', 'f', 'A', 'bupper', 'blower', 'sense')
    blob, cnt_x, _, _, export_s = flat_window(
        lambda: codegen.export_aot(N, M_ROWS, batch=FLAT_LANES, settings=st))
    nodes = graph_nodes(torch.export.load(io.BytesIO(blob)).graph_module)
    (eager, syncs), cnt_e, host, rounds, eager_s = flat_window(
        lambda: counted_syncs(lambda: pbatch.solve_batch_flat_jit(*head,
                                                                  st)))
    found, rc, timed_out = None, None, False
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "flat.pt2")
        with open(path, "wb") as fh:
            fh.write(blob)
        np.savez(path + ".npz", x=x_head,
                 **{k: v.cpu().numpy() for k, v in zip(keys, head)})
        t = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--aot-worker",
             path], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        try:
            log = proc.communicate(timeout=AOT_WORKER_S)[0]
            rc = proc.returncode
        except subprocess.TimeoutExpired:
            timed_out = True
            proc.kill()
            log = proc.communicate()[0]
        worker_s = time.perf_counter() - t
        lines = [ln for ln in log.splitlines()
                 if ln.startswith('{"aot_worker"')]
        if lines and rc == 0:
            found = json.loads(lines[-1])["aot_worker"]
            got = dict(np.load(path + ".out.npz"))
    if found is None:
        print(log[-3000:], file=sys.stderr)
        return False, dict(return_code=rc, timed_out=timed_out), {}
    x = eager.x.cpu().numpy().astype(np.float64)
    gx = got["x"].astype(np.float64)
    dx = np.abs(gx - x).max(1) / (1.0 + np.abs(x).max(1))
    ef, gf = eager.exitflag.cpu().numpy(), got["exitflag"]
    ei, gi = eager.iterations.cpu().numpy(), got["iterations"]
    differ = []
    for b in np.flatnonzero((ef != gf) | (ei != gi) | ~(dx <= AOT_DX)):
        why = [w for w, bad in (("flag", ef[b] != gf[b]),
                                ("iterations", ei[b] != gi[b]),
                                ("x", not dx[b] <= AOT_DX)) if bad]
        differ.append(dict(lane=int(b), reason=why, flag=int(gf[b]),
                           eager_flag=int(ef[b]), iterations=int(gi[b]),
                           eager_iterations=int(ei[b]), dx=float(dx[b])))
    for d_ in differ:
        print(f"deploy (a) lane {d_['lane']} differs: {d_}", flush=True)
    ok = not differ and found["rounds"] == rounds \
        and all(v == 0 for v in cnt_x.values())
    return ok, dict(
        export_s=export_s, blob_bytes=len(blob), graph_nodes=nodes,
        eager=dict(wall_s=eager_s, rounds=rounds, host_syncs=host,
                   syncs=syncs, launches=cnt_e),
        worker=found, worker_wall_s=worker_s, lanes_differ=len(differ),
        max_dx_eager=float(dx.max())), dict(
            deploy_export=cnt_x, deploy_eager=cnt_e,
            deploy_aot_worker=found["launches"])


def deploy_single(gen):
    """``deploy`` (b) and (c) on config 1's first DEPLOY_QPS QPs in f64:
    the program ``export_aot(N1, M1, MS1, dtype="float64")`` traced on the
    card, loaded and run one QP a call, and ``native.NativeModel`` on
    tensors on the card, each against ``dt.quadprog`` on the card: the
    same flag, ||dx||_2 <= SINGLE_TOL64 (and |dfval| for the C library);
    (passes, fields, windows)."""
    import io
    from daqp_tpu_torch import native
    probs = config1(gen)[:DEPLOY_QPS]
    dev = torch.device("cuda")
    t = time.perf_counter()
    blob = codegen.export_aot(N1, M1, MS1, dtype="float64")
    export_s = time.perf_counter() - t
    prog = torch.export.load(io.BytesIO(blob)).module()
    ones = [dt.quadprog(H, f, A, bu, bl, se, ms=MS1, dtype=torch.float64,
                        device="cuda") for _, H, f, A, bu, bl, se in probs]
    cases = {"b": [], "c": []}

    def run_b():
        for _, H, f, A, bu, bl, se in probs:
            out = prog(*(torch.as_tensor(v, device=dev)
                         for v in (H, f, A, bu, bl)),
                       torch.as_tensor(se, dtype=torch.int32, device=dev))
            cases["b"].append((int(out["exitflag"]),
                               out["x"].cpu().numpy(), float(out["fval"])))

    def run_c():
        for _, H, f, A, bu, bl, se in probs:
            out = native.NativeModel(*(torch.as_tensor(v, device=dev)
                                       for v in (H, f, A, bu, bl)), se,
                                     ms=MS1).solve()
            cases["c"].append((out["exitflag"], out["x"], out["fval"]))

    _, cnt_b, _, _, wall_b = flat_window(run_b)
    _, cnt_c, _, _, wall_c = flat_window(run_c)
    out, ok = dict(b=dict(export_s=export_s, blob_bytes=len(blob),
                          wall_s=wall_b, launches=cnt_b),
                   c=dict(wall_s=wall_c, launches=cnt_c)), True
    for part, fval_gate in (("b", False), ("c", True)):
        flags = [c[0] for c in cases[part]]
        dx = [float(np.linalg.norm(c[1] - o.x.cpu().numpy()))
              for c, o in zip(cases[part], ones)]
        df = [abs(c[2] - float(o.fval)) for c, o in zip(cases[part], ones)]
        same = flags == [o.exitflag for o in ones]
        good = same and max(dx) <= SINGLE_TOL64 and \
            (not fval_gate or max(df) <= SINGLE_TOL64)
        out[part].update(flags_equal=same, optimal=sum(f == 1 for f in flags),
                         max_dx=max(dx), max_dfval=max(df))
        ok = ok and good
    return ok, out, dict(deploy_single=cnt_b, deploy_native=cnt_c)


class _Factor(torch.nn.Module):
    """The regularized factorization's graph form alone (``deploy``
    (d))."""

    def __init__(self, st):
        super().__init__()
        self.st = st

    def forward(self, H):
        return chol.batched_rinv_regularized(H, self.st, graph=True)


def deploy_b10(st):
    """``deploy`` (d): B10 in a loaded program: the factorization's graph
    form at n = DEPLOY_B10_N (past K1's columns) traced, saved, loaded
    and run on DEPLOY_B10_LANES matrices of spd_batch, one of them
    shifted to need retries, against the eager loop bit for bit; B10
    launched by the op, K1 not; (passes, fields, windows)."""
    import io
    dev = torch.device("cuda")
    H = spd_batch(DEPLOY_B10_LANES, DEPLOY_B10_N, SEED, dev)
    H[0] -= 1.5 * torch.linalg.eigvalsh(H[0].double())[0].float() \
        * torch.eye(DEPLOY_B10_N, device=H.device)
    ep = torch.export.export(_Factor(st), (H,), strict=False)
    ep.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    prog = torch.export.load(io.BytesIO(buf.getvalue())).module()
    got, cnt, _, _, wall = flat_window(lambda: prog(H))
    want, cnt_e, _, _, _ = flat_window(
        lambda: chol.batched_rinv_regularized(H, st))
    same = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
    ok = same and cnt["chol_blk"] >= 1 and cnt["chol_rinv"] == 0 \
        and bool(want[2][0])
    return ok, dict(n=DEPLOY_B10_N, lanes=DEPLOY_B10_LANES, equal=same,
                    retried_lanes=int(want[2].sum()), wall_s=wall,
                    launches=cnt, eager_launches=cnt_e), dict(
                        deploy_b10=cnt)


def phase_deploy(head, x_head, gen, st, card):
    """The deploy surface: (a) ``aot_batch``, (b) and (c)
    ``deploy_single``, (d) ``deploy_b10``; each part must pass."""
    t0 = time.perf_counter()
    ok_a, out_a, windows = aot_batch(head, x_head, st)
    ok_bc, out_bc, win_bc = deploy_single(gen)
    ok_d, out_d, win_d = deploy_b10(st)
    windows.update(win_bc)
    windows.update(win_d)
    emit("deploy", t0, a=out_a, **out_bc, d=out_d,
         passed=dict(a=ok_a, b_c=ok_bc, d=ok_d), card=card)
    return ok_a and ok_bc and ok_d, windows


PHASES = ("k1", "k2", "slice", "k8", "k9", "k10", "stages", "limits", "k7",
          "soft", "sw", "backstop", "single", "k3", "mpc", "k4", "prox",
          "hiqp", "k5", "avi", "k6", "lp", "miqp", "meta", "flat", "scale",
          "deploy")


def main():
    """Every phase; ``--phases p ...`` runs the env line and the named
    phases alone (a measurement, not the smoke test: it prints no kernels
    line and no ``ok`` line)."""
    only = sys.argv[sys.argv.index("--phases") + 1:] \
        if "--phases" in sys.argv else None
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if "--scale-worker" in sys.argv:   # a rank of scale (b), not a run
        i = sys.argv.index("--scale-worker")
        return scale_worker(*sys.argv[i + 1:i + 4])
    if "--aot-worker" in sys.argv:     # deploy (a)'s process, not a run
        return aot_worker(sys.argv[sys.argv.index("--aot-worker") + 1])
    dev = torch.device("cuda")
    card = card_line()
    phase_env(card)
    gen = load("daqp_test_gen", "tests/gen.py")
    # config 2 in f64, then as bench.py casts it (dtype=np.float32)
    d64 = gen.generate_test_qp_batch(B, N, M_ROWS, 0, N_ACT, KAPPA, rng=SEED)
    d = {k: v.astype(np.float32) if v.dtype == np.float64 else v
         for k, v in d64.items()}
    d64_head = {k: v[:FLAT_ROUTE] for k, v in d64.items()}
    del d64
    keys = ('H', 'f', 'A', 'bupper', 'blower', 'sense')
    full = [torch.as_tensor(d[k], device=dev) for k in keys]
    st = dt.as_settings({"iter_limit": 1000}, torch.float32)
    sw_np = sw_weights(B, M_ROWS)
    res = {}

    def run(name, fn, *a):
        if only is None or name in only:
            res[name] = fn(*a)

    run("k1", phase_factor, "k1", chol.chol_rinv, chol.chol_rinv_plain,
        full[0], lambda: k1_sweep(full[0], dev, gen), True, B4)
    lanes = first_chunk(full, st)
    run("k2", phase_k2, [a[:B_K2] for a in full], [a[lanes] for a in full],
        st)
    run("slice", phase_slice, full, d, st, card)
    run("k8", phase_factor, "k8", chol.chol_rinv_lanes,
        chol.chol_rinv_lanes_plain, full[0],
        sweep(width_cases, chol.chol_rinv_lanes, chol.chol_rinv_lanes_plain,
              K8_WIDTHS, SEED, dev))
    run("k9", phase_factor, "k9", chol.chol_rinv_dense,
        chol.chol_rinv_dense_plain, full[0],
        sweep(same_as_k1, FACTOR_WIDTHS, SEED, dev), True)
    run("k10", phase_factor, "k10", chol.chol_rinv_blk,
        chol.chol_rinv_blk_plain, full[0],
        sweep(width_cases, chol.chol_rinv_blk, chol.chol_rinv_blk_plain,
              K10_WIDTHS, SEED, dev))
    run("stages", phase_stages, full, d, st, gen, card)
    run("limits", phase_limits, st, dev)
    d4b = config4b()
    args4b = [torch.as_tensor(d4b[k], device=dev)
              for k in ('f', 'A', 'bupper', 'blower', 'sense')]
    args_k = [a[:B_K2] for a in full]
    args_c = [a[lanes] for a in full[:5]] + [soft_sense(full[5][lanes])]
    run("k7", phase_k7, args_k[:5] + [soft_sense(args_k[5])], args_k, args4b,
        sw_tensors(sw_np, dev, slice(0, B_K2)),
        (args_c, sw_tensors(sw_np, dev, lanes.cpu().numpy())), st)
    run("soft", phase_soft, full, d, st, card)
    run("sw", phase_sw, full, d, sw_np, st, card)
    run("backstop", phase_backstop, full, d, sw_np, st, card)
    head = [a[:FLAT_LANES].clone() for a in full]
    del full
    run("single", phase_single, gen, card)

    d3 = config3(gen)
    args3 = [torch.as_tensor(d3[k], device=dev)
             for k in ('H', 'A', 'f_seq', 'bu_seq', 'bl_seq')]
    run("k3", phase_k3, args3, st, gen)
    run("mpc", phase_mpc, args3, d3, st, card)

    d4 = config4()
    args4 = [torch.as_tensor(d4[k], device=dev) for k in keys]
    run("k4", phase_k4, args4, st)
    run("prox", phase_prox, args4, st, card)
    run("hiqp", phase_hiqp, args4b, d4b, st, card)

    d_avi = config_avi(gen)
    args_avi = [torch.as_tensor(d_avi[k], device=dev) for k in keys]
    run("k5", phase_k5, args_avi, st, gen)
    run("avi", phase_avi, args_avi, d_avi, st, card)

    d_lp = config_lp(gen)
    args_lp = [torch.as_tensor(d_lp[k], device=dev)
               for k in ('f', 'A', 'bupper', 'blower', 'sense')]
    st_lp = dt.as_settings({"iter_limit": 3000}, torch.float32)
    run("k6", phase_k6, args_lp, st_lp, gen)
    run("lp", phase_lp, args_lp, d_lp, st_lp, card)

    d5 = config5()
    run("miqp", phase_miqp, d5, st, card)
    run("meta", phase_meta, d_lp, d_avi, d4b, d5, card)
    run("flat", phase_flat, head, d['x'][:FLAT_LANES].astype(np.float64),
        d64_head, gen, d3, d5, st, card)
    run("scale", phase_scale, head, d['x'][:FLAT_LANES].astype(np.float64),
        d, args4, d5, gen, st, card)
    run("deploy", phase_deploy, head, d['x'][:FLAT_LANES].astype(np.float64),
        gen, st, card)

    failed = [name for name in PHASES if name in res and not res[name][0]]
    if only is not None:
        print(card, flush=True)
        if failed:
            print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1 if failed or set(only) - set(res) else 0
    paths = {p: res[p][1] for p in ("slice", "mpc", "prox", "soft", "sw",
                                    "hiqp", "avi", "backstop", "miqp")}
    paths.update(res["lp"][1])
    paths.update(res["stages"][1])
    paths.update(res["flat"][1])
    paths.update(res["scale"][1])
    paths.update(res["deploy"][1])

    def entry(name, source, replaces, fields):
        by_path = {p: v[name] for p, v in paths.items()}
        return dict(name=name, route="cuda",
                    source=f"daqp_tpu_torch/ops/csrc/{source}",
                    replaces=replaces, launches=sum(by_path.values()),
                    launches_by_path=by_path, **fields)

    print(json.dumps({"kernels": [
        entry("chol_rinv", "chol_rinv.cu", "daqp_tpu/ops/chol.py:607",
              {**res["k1"][1], **res["prox"][2]}),
        entry("chol_lanes", "chol_lanes.cu", "daqp_tpu/ops/chol.py:127",
              res["k8"][1]),
        entry("chol_dense", "chol_dense.cu", "daqp_tpu/ops/chol.py:563",
              res["k9"][1]),
        entry("chol_blk", "chol_blk.cu", "daqp_tpu/ops/chol.py:644",
              res["k10"][1]),
        entry("slot_round", "slot_round.cu",
              "daqp_tpu/ops/pallas_slot.py:663", res["k2"][1]),
        entry("mpc_segment", "mpc_segment.cu",
              "daqp_tpu/ops/pallas_slot.py:1866", res["k3"][1]),
        entry("prox_segment", "prox_segment.cu",
              "daqp_tpu/ops/pallas_slot.py:1110", res["k4"][1]),
        entry("avi_segment", "avi_segment.cu",
              "daqp_tpu/ops/pallas_slot.py:1783", res["k5"][1]),
        entry("lp_segment", "lp_segment.cu",
              "daqp_tpu/ops/pallas_slot.py:1468", res["k6"][1]),
        entry("dense_round", "dense_round.cu",
              "daqp_tpu/ops/pallas_batch.py:751", res["k7"][1])]}),
        flush=True)
    print(card, flush=True)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    # the run drives one card
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
