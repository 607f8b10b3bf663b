#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (daqp_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``daqp_tpu_torch/ops/csrc`` (one
nvcc per source, in parallel, into ``build/daqp_tpu_torch``), holds each
kernel against its plain PyTorch twin at the main paths' shapes, and
drives the port's three paths once each, every launch count set to 0
just before and read just after:

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
  (K1 with its retries, K2, B4).

Each phase prints one JSON line with its seconds; then come the kernel
table, the card's name and power limit, and as the last line
``{"ok": true, "device": ...}``.  Any failed check or error exits
non-zero without that line; so does a machine without a CUDA device.
"""
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import daqp_tpu_torch as dt
from daqp_tpu_torch import batch as pbatch, mpc as pmpc, ops, transform
from daqp_tpu_torch.ops import _build, chol, slot

ROOT = Path(__file__).resolve().parent
# config 2 (bench.py:63-79)
B, N, M_ROWS, N_ACT, KAPPA, SEED = 10240, 50, 100, 40, 1e2, 2026
B_K2 = 1024
STEPS = 192
# config 3 (bench_extra.py:49-61) and config 4 (bench_extra.py:101-113)
S3, T3, SEG3, SEED3, DRIFT3 = 512, 20, 10, 7, 0.02
B4, RANK4, SEED4 = 256, 30, 11
K1_RTOL = 1e-4        # max |dRinv| / max |Rinv|, kernel vs twin
K2_AGREE = 0.99       # lanes whose exit flag and working set agree
K2_DU = 1e-3          # ||du||_inf / (1 + ||u||_inf) on agreeing optimal lanes
ACC_TOL = 1e-4        # ||x - x_ref||_2 gate of bench.py
ACC_RATE = 0.999
MPC_TOL = 2e-3        # ||x - x_ref||_2 gate of tests/test_mpc.py
KKT_TOL = 1e-3        # f64 KKT stationarity / violation of an optimal lane
PROX_OPT = 0.99
# one H100 SXM, published peaks: f32 outside the tensor cores,
# HBM bandwidth
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


def load(name, rel):
    # by path: an installed package named "tests" may shadow the
    # repository's test directory
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def emit(phase, t0, **fields):
    print(json.dumps({"phase": phase, **fields,
                      "seconds": time.perf_counter() - t0}), flush=True)


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` in ms over ``reps`` calls, after one
    warm-up call, bracketed by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def step_flops(m, n, K):
    """Operations of one slot step (slot_step.cuh): u = W'lam* and the
    Gram column W a (2 K n each), mu = M u (2 m n), the W update and the
    pending column W prow (2 K n each), a = E g (2 K^2), the E update
    (~4 K^2) and lam*, a_p = E (.) (4 K^2)."""
    return 2 * m * n + 8 * K * n + 10 * K * K


def prefix_flops(n, K):
    """The round prefix g_p = W prow, lam*, a_p = E (.)."""
    return 2 * K * n + 4 * K * K


def state_bytes(s, names):
    return nbytes(*(getattr(s, k) for k in names))


def reset_counts():
    chol.launches = slot.launches = 0
    slot.mpc_launches = slot.prox_launches = 0
    ops.host_syncs = pmpc.redone_segments = pbatch.prox_resumed_lanes = 0


def read_counts():
    return {"chol_rinv": chol.launches, "slot_round": slot.launches,
            "mpc_segment": slot.mpc_launches,
            "prox_segment": slot.prox_launches}


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
             if "registers" in ln or "Compiling entry" in ln] \
        if log.exists() else []
    emit("env", t0, torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=[ln for ln in nvcc.splitlines() if "release" in ln][0],
         card=card, build_s=build_s, ptxas=ptxas)


def phase_k1(H):
    """K1 against its twin on the config-2 Hessians; the library call is
    Cholesky then a triangular solve against I."""
    t0 = time.perf_counter()
    Rk = chol.chol_rinv(H)
    Rp = chol.chol_rinv_plain(H)
    Bk, n = H.shape[0], H.shape[1]
    eye = torch.eye(n, device=H.device)

    def resid(R):          # max over lanes of ||Rinv' H Rinv - I||_inf
        P = torch.matmul(R.transpose(1, 2), torch.matmul(H, R))
        return (P - eye).abs().sum(2).amax().item()

    def library():
        L, _ = torch.linalg.cholesky_ex(H)
        return torch.linalg.solve_triangular(L.transpose(1, 2),
                                             eye.expand_as(H), upper=True)

    err = (Rk - Rp).abs().max().item()
    rel = err / Rp.abs().max().item()
    lib_err = (library() - Rk).abs().max().item()
    ms = cuda_ms(lambda: chol.chol_rinv(H), 20)
    plain_ms = cuda_ms(lambda: chol.chol_rinv_plain(H), 3)
    library_ms = cuda_ms(library, 20)
    bnd = bound(2 * nbytes(H), Bk * 2 * n ** 3 / 3)
    emit("k1", t0, B=Bk, n=n, max_abs_err=err, rel_err=rel,
         rel_tol=K1_RTOL, resid_kernel=resid(Rk), resid_twin=resid(Rp),
         kernel_vs_library=lib_err, ms=ms, plain_ms=plain_ms,
         library_ms=library_ms, **bnd)
    ok = rel <= K1_RTOL
    return ok, dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    library_ms=library_ms, bound_ms=bnd["bound_ms"],
                    bound_by=bnd["bound_by"])


def phase_k2(args, st):
    """One K2 round against its twin from the cold slot state of the
    first B_K2 config-2 lanes after the port's build_ldp."""
    t0 = time.perf_counter()
    Rinv, _, _, _ = chol.batched_rinv_regularized(args[0], st)
    ldpd = transform.build_ldp(*args[1:], 0, st, Rinv=Rinv)
    immut = ((ldpd.sense & dt.IMMUTABLE) > 0).float()
    s0 = slot.slot_init(ldpd.M, ldpd.dupper, ldpd.dlower, ldpd.scaling,
                        immut, n_true=N)
    sk = slot.run_slot_round(s0, st, N, STEPS)
    sp = slot.run_slot_round_plain(s0, st, N, STEPS)
    # semantic agreement: exit flag and working set (the m-space active
    # masks); the slot a row sits in may differ where the paths parted
    # at an f32 tie and met again.  u is held relative to its scale: after
    # ~100 f32 rank-one updates of E and before slot_solve's polish, each
    # side is up to ~1e-3 off the exact f64 u on its own working set
    # (measured on the H100: kernel 1.1e-3, twin 1.9e-3 at |u| ~ 6-12)
    agree = (sk.status == sp.status) & (sk.act_up == sp.act_up).all(1) \
        & (sk.act_lo == sp.act_lo).all(1)
    table = agree & (sk.used == sp.used).all(1) & (sk.sid == sp.sid).all(1)
    opt = agree & (sk.status == dt.EXIT_OPTIMAL)
    du = (sk.u - sp.u).abs().amax(1)[opt]
    du_rel = (du / (1.0 + sp.u.abs().amax(1)[opt])).max().item()
    du = du.max().item()
    rate = agree.float().mean().item()
    ex_k, ex_p = map(gmax, exact_gap(ldpd.M, sk, sp, opt))
    ms = cuda_ms(lambda: slot.run_slot_round(s0, st, N, STEPS), 5)
    plain_ms = cuda_ms(lambda: slot.run_slot_round_plain(s0, st, N, STEPS), 2)
    K = N + 1
    steps_done = (sk.iterations - s0.iterations).sum().item()
    bnd = bound(state_bytes(s0, slot.CONST + slot.STATE)
                + state_bytes(sk, slot.STATE),
                steps_done * step_flops(M_ROWS, N, K)
                + B_K2 * prefix_flops(N, K))
    flags = {int(k): int(v) for k, v in zip(
        *torch.unique(sk.status, return_counts=True))}
    emit("k2", t0, B=B_K2, n=N, m=M_ROWS, K=K, steps=STEPS,
         agree_rate=rate, slot_table_agree_rate=table.float().mean().item(),
         optimal_agreeing=int(opt.sum()), du_inf=du, du_rel=du_rel,
         du_rel_tol=K2_DU, kernel_vs_exact=ex_k, twin_vs_exact=ex_p,
         kernel_flags=flags, steps_done=steps_done, ms=ms,
         plain_ms=plain_ms, **bnd)
    ok = rate >= K2_AGREE and du_rel <= K2_DU
    return ok, dict(max_abs_err=du, ms=ms, plain_ms=plain_ms,
                    library_ms=None, bound_ms=bnd["bound_ms"],
                    bound_by=bnd["bound_by"])


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


def config3(gen):
    """bench_extra.py:53-61: one QP drifting over S3 scenarios x T3."""
    rng = np.random.default_rng(SEED3)
    _, H, f, A, bu, bl, _ = gen.generate_test_qp(N, M_ROWS, 0, 40, KAPPA,
                                                 rng)
    H, f, A, bu, bl = (v.astype(np.float32) for v in (H, f, A, bu, bl))
    drift_f = DRIFT3 * rng.standard_normal((S3, T3, N)).astype(np.float32)
    drift_b = DRIFT3 * rng.standard_normal((S3, T3, M_ROWS)).astype(
        np.float32)
    return dict(H=H, A=A, f_seq=np.cumsum(drift_f, axis=1) + f,
                bu_seq=np.cumsum(np.abs(drift_b), axis=1) + bu,
                bl_seq=bl - np.cumsum(np.abs(drift_b), axis=1))


def phase_k3(args, st):
    """B3 against its twin over the second 10-step segment of all S3
    lanes, from the warm state after segment 0 of the config-3 run.

    Per-step flags and ``failed`` must agree on K2_AGREE of the lanes.
    u is held against the exact f64 u on each side's own working set: in
    a warm segment E takes ~36 f32 rank-one updates with no refresh (the
    reference refreshes once per segment), and both sides drift from the
    exact u well beyond one cold round's ~1e-3.  So per lane the kernel's
    distance to the exact u may be at most twice the twin's plus K2's
    gate; the kernel-twin gap and the working-set agreement are printed
    beside it."""
    t0 = time.perf_counter()
    _, _, du, dl, s0 = pmpc._horizon(*args, st, 0, None)
    s1 = pmpc._steps_slot_solve(s0, du[:, :SEG3], dl[:, :SEG3], st, N,
                                STEPS)[0]
    s1 = slot.newton_refresh(s1)
    duq = du[:, SEG3:2 * SEG3].contiguous()
    dlq = dl[:, SEG3:2 * SEG3].contiguous()

    def kernel():
        return slot.run_mpc_segment(s1, duq, dlq, st, N, steps=STEPS)

    def plain():
        return slot.run_mpc_segment_plain(s1, duq, dlq, st, N, steps=STEPS)

    sk, uk, fvk, itk, stk, fk = kernel()
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
    ms = cuda_ms(kernel, 5)
    plain_ms = cuda_ms(plain, 1)
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
    emit("k3", t0, S=S3, P=SEG3, n=N, m=M_ROWS, K=K, steps=STEPS,
         flags_agree_rate=rate,
         working_set_agree_rate=agree.float().mean().item(),
         optimal_agreeing=int(opt.sum()), failed_kernel=int((fk > 0).sum()),
         du_inf=du_max, du_rel=du_rel, kernel_vs_exact=gmax(ex_k),
         twin_vs_exact=gmax(ex_p), kernel_within_twin_drift=u_ok,
         steps_done=steps_done, ms=ms, plain_ms=plain_ms, **bnd)
    ok = rate >= K2_AGREE and u_ok
    return ok, dict(max_abs_err=du_max, ms=ms, plain_ms=plain_ms,
                    library_ms=None, bound_ms=bnd["bound_ms"],
                    bound_by=bnd["bound_by"])


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
    err, ref_flags = [], []
    for s in range(S3):
        t = s % T3
        ref = oracle.quadprog(*(v.astype(np.float64) for v in (
            d3['H'], d3['f_seq'][s, t], d3['A'], d3['bu_seq'][s, t],
            d3['bl_seq'][s, t])))
        ref_flags.append(ref['exitflag'])
        err.append(np.linalg.norm(x[s, t].astype(np.float64) - ref['x']))
    oracle_s = time.perf_counter() - t_or
    err = np.asarray(err)
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


def phase_k4(args, st):
    """B4 against its twin over one PSEG-pass segment from the cold
    config-4 state: lflag, lane_run and failed agree on K2_AGREE of the
    lanes, ||dx||_inf <= 1e-3 (1 + ||x||_inf) on those.  x = Rinv (u - v)
    carries u's f32 drift times ||Rinv||_inf, printed beside it."""
    t0 = time.perf_counter()
    Rinv, okl, ldpd, eps, tst, s0, bu_s, bl_s = pbatch.prox_init(
        *args[:6], st)
    Bk, n = args[1].shape
    dev = Rinv.device
    carry = (torch.zeros((Bk, n), device=dev), okl.float(),
             torch.zeros(Bk, device=dev),
             torch.full((Bk,), float("inf"), device=dev),
             torch.where(okl, dt.EXIT_RUNNING, -5).to(torch.int32),
             torch.zeros(Bk, device=dev))
    ops_ = (Rinv, args[1], bu_s, bl_s, eps, tst)

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
    ms = cuda_ms(kernel, 5)
    plain_ms = cuda_ms(plain, 1)
    K = n + 1
    steps_done = ko[6].sum().item()
    bnd = bound(state_bytes(s0, slot.SEG_CONST + slot.STATE)
                + nbytes(*carry, *ops_) + state_bytes(ko[0], slot.STATE)
                + nbytes(*ko[1:]),
                steps_done * step_flops(M_ROWS, n, K)
                + okl.sum().item() * (4 * n * n + 2 * M_ROWS * n
                                      + prefix_flops(n, K)))
    emit("k4", t0, B=Bk, P=pbatch.PSEG, n=n, m=M_ROWS, K=K,
         steps=pbatch.PROX_STEPS,
         agree_rate=rate, lanes_done_kernel=int((ko[2] == 0).sum()),
         failed_kernel=int((ko[7] > 0).sum()), dx_inf=dx.max().item(),
         dx_rel_x=dx_rel_x, dx_rel_x_tol=K2_DU, dx_rel_rinv=dx_rel,
         du_rel=du_rel, kernel_vs_exact_u=ex_k, twin_vs_exact_u=ex_p,
         steps_done=steps_done, ms=ms, plain_ms=plain_ms, **bnd)
    ok = rate >= K2_AGREE and dx_rel_x <= K2_DU
    return ok, dict(max_abs_err=dx.max().item(), ms=ms, plain_ms=plain_ms,
                    library_ms=None, bound_ms=bnd["bound_ms"],
                    bound_by=bnd["bound_by"])


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    phase_env(card)
    gen = load("daqp_test_gen", "tests/gen.py")
    d = gen.generate_test_qp_batch(B, N, M_ROWS, 0, N_ACT, KAPPA, rng=SEED,
                                   dtype=np.float32)
    keys = ('H', 'f', 'A', 'bupper', 'blower', 'sense')
    full = [torch.as_tensor(d[k], device=dev) for k in keys]
    st = dt.as_settings({"iter_limit": 1000}, torch.float32)

    ok1, k1 = phase_k1(full[0])
    ok2, k2 = phase_k2([a[:B_K2] for a in full], st)
    ok_slice, l_slice = phase_slice(full, d, st, card)
    del full

    d3 = config3(gen)
    args3 = [torch.as_tensor(d3[k], device=dev)
             for k in ('H', 'A', 'f_seq', 'bu_seq', 'bl_seq')]
    ok3, k3 = phase_k3(args3, st)
    ok_mpc, l_mpc = phase_mpc(args3, d3, st, card)

    d4 = config4()
    args4 = [torch.as_tensor(d4[k], device=dev) for k in keys]
    ok4, k4 = phase_k4(args4, st)
    ok_prox, l_prox, k1_c4 = phase_prox(args4, st, card)

    paths = {"slice": l_slice, "mpc": l_mpc, "prox": l_prox}

    def entry(name, source, replaces, fields):
        by_path = {p: v[name] for p, v in paths.items()}
        return dict(name=name, route="cuda",
                    source=f"daqp_tpu_torch/ops/csrc/{source}",
                    replaces=replaces, launches=sum(by_path.values()),
                    launches_by_path=by_path, **fields)

    print(json.dumps({"kernels": [
        entry("chol_rinv", "chol_rinv.cu", "daqp_tpu/ops/chol.py:607",
              {**k1, **k1_c4}),
        entry("slot_round", "slot_round.cu",
              "daqp_tpu/ops/pallas_slot.py:663", k2),
        entry("mpc_segment", "mpc_segment.cu",
              "daqp_tpu/ops/pallas_slot.py:1866", k3),
        entry("prox_segment", "prox_segment.cu",
              "daqp_tpu/ops/pallas_slot.py:1110", k4)]}), flush=True)
    print(card, flush=True)
    failed = [name for name, ok in (("k1", ok1), ("k2", ok2),
                                    ("slice", ok_slice), ("k3", ok3),
                                    ("mpc", ok_mpc), ("k4", ok4),
                                    ("prox", ok_prox)) if not ok]
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
