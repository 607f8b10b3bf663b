#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (daqp_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``daqp_tpu_torch/ops/csrc`` (nvcc,
into ``build/daqp_tpu_torch``), holds each kernel against its plain
PyTorch twin at the main path's shapes, then drives the main path once:
BASELINE config 2 (B = 10240 dense strictly convex QPs, n = 50, m = 100
two-sided rows, ~40 active, kappa 1e2, generator seed 2026, f32) through
``solve_batch_kernel_stream(chunk=256, sort_stream=True)``, checked
against the constructed optimum.  Each phase prints one JSON line; then
come the kernel table, the card's name and power limit, and as the last
line ``{"ok": true, "device": ...}``.  Any failed check or error exits
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
from daqp_tpu_torch import ops, transform
from daqp_tpu_torch.ops import _build, chol, slot

ROOT = Path(__file__).resolve().parent
B, N, M_ROWS, N_ACT, KAPPA, SEED = 10240, 50, 100, 40, 1e2, 2026
B_K2 = 1024
STEPS = 192
K1_RTOL = 1e-4        # max |dRinv| / max |Rinv|, kernel vs twin
K2_AGREE = 0.99       # lanes whose exit flag and working set agree
K2_DU = 1e-3          # ||du||_inf / (1 + ||u||_inf) on agreeing optimal lanes
ACC_TOL = 1e-4        # ||x - x_ref||_2 gate of bench.py
ACC_RATE = 0.999


def load_gen():
    # tests/gen.py by path: an installed package named "tests" may shadow
    # the repository's test directory
    spec = importlib.util.spec_from_file_location(
        "daqp_test_gen", ROOT / "tests" / "gen.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


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


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def phase_env(card):
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout
    log = _build.BUILD_DIR / "nvcc.log"
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln] if log.exists() else []
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=[ln for ln in nvcc.splitlines() if "release" in ln][0],
         card=card, build_s=build_s, ptxas=ptxas)


def phase_k1(H):
    """K1 against its twin on the config-2 Hessians."""
    Rk = chol.chol_rinv(H)
    Rp = chol.chol_rinv_plain(H)
    eye = torch.eye(H.shape[1], device=H.device)

    def resid(R):          # max over lanes of ||Rinv' H Rinv - I||_inf
        P = torch.matmul(R.transpose(1, 2), torch.matmul(H, R))
        return (P - eye).abs().sum(2).amax().item()

    err = (Rk - Rp).abs().max().item()
    rel = err / Rp.abs().max().item()
    ms = cuda_ms(lambda: chol.chol_rinv(H), 20)
    plain_ms = cuda_ms(lambda: chol.chol_rinv_plain(H), 3)
    emit("k1", B=H.shape[0], n=H.shape[1], max_abs_err=err, rel_err=rel,
         rel_tol=K1_RTOL, resid_kernel=resid(Rk), resid_twin=resid(Rp),
         ms=ms, plain_ms=plain_ms)
    ok = rel <= K1_RTOL
    return ok, dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def exact_gap(ldpd, sk, sp, opt):
    """Max ||u - u_exact||_inf of kernel and twin over the optimal lanes,
    u_exact = -W' (W W')^-1 d in f64 on the lane's final working set."""
    M = ldpd.M.double().cpu().numpy()
    up, lo = sk.act_up.cpu().numpy(), sk.act_lo.cpu().numpy()
    d = np.where(up > 0, ldpd.dupper.double().cpu().numpy(),
                 ldpd.dlower.double().cpu().numpy())
    uk, ut = sk.u.double().cpu().numpy(), sp.u.double().cpu().numpy()
    gk = gt = 0.0
    for b in np.nonzero(opt.cpu().numpy())[0]:
        a = np.nonzero(up[b] + lo[b])[0]
        W = M[b][a]
        u = -W.T @ np.linalg.solve(W @ W.T, -d[b][a])
        gk = max(gk, float(np.abs(uk[b] - u).max()))
        gt = max(gt, float(np.abs(ut[b] - u).max()))
    return gk, gt


def phase_k2(args, st):
    """One K2 round against its twin from the cold slot state of the
    first B_K2 config-2 lanes after the port's build_ldp."""
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
    ex_k, ex_p = exact_gap(ldpd, sk, sp, opt)
    ms = cuda_ms(lambda: slot.run_slot_round(s0, st, N, STEPS), 5)
    plain_ms = cuda_ms(lambda: slot.run_slot_round_plain(s0, st, N, STEPS), 2)
    flags = {int(k): int(v) for k, v in zip(
        *torch.unique(sk.status, return_counts=True))}
    emit("k2", B=B_K2, n=N, m=M_ROWS, K=N + 1, steps=STEPS,
         agree_rate=rate, slot_table_agree_rate=table.float().mean().item(),
         optimal_agreeing=int(opt.sum()), du_inf=du, du_rel=du_rel,
         du_rel_tol=K2_DU, kernel_vs_exact=ex_k, twin_vs_exact=ex_p,
         kernel_flags=flags, ms=ms, plain_ms=plain_ms)
    ok = rate >= K2_AGREE and du_rel <= K2_DU
    return ok, dict(max_abs_err=du, ms=ms, plain_ms=plain_ms)


def phase_slice(full, d, st, card):
    def solve():
        return dt.solve_batch_kernel_stream(*full, st=st, ms=0, chunk=256,
                                            has_soft=False,
                                            sort_stream=True)

    chol.launches = slot.launches = ops.host_syncs = 0
    r = solve()
    torch.cuda.synchronize()
    launches = {"chol_rinv": chol.launches, "slot_round": slot.launches}
    syncs = ops.host_syncs
    x = r.x.cpu().numpy()
    flags = r.exitflag.cpu().numpy()
    err = np.linalg.norm(x.astype(np.float64) - d['x'], axis=1)
    shape_ok = x.shape == (B, N) and r.lam.shape == (B, M_ROWS) \
        and bool(np.isfinite(x).all())
    acc = float(np.mean((flags == 1) & (err <= ACC_TOL)))
    silent = int(np.sum((flags == 1) & (err > ACC_TOL)))
    best = None
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            solve()
        torch.cuda.synchronize()
        dt_w = time.perf_counter() - t0
        best = dt_w if best is None else min(best, dt_w)
    emit("slice", B=B, n=N, m=M_ROWS, chunk=256, sort_stream=True,
         launches=launches, host_syncs=syncs, shape_finite_ok=shape_ok,
         accuracy_pass_rate=acc, optimal_rate=float(np.mean(flags == 1)),
         silent_wrong=silent, max_err_optimal=float(
             err[flags == 1].max()) if (flags == 1).any() else None,
         median_iters=float(np.median(r.iterations.cpu().numpy())),
         solves_per_s=3 * B / best, window_s=best, card=card)
    ok = shape_ok and acc >= ACC_RATE and silent == 0 \
        and all(v >= 1 for v in launches.values())
    return ok, launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    phase_env(card)
    d = load_gen().generate_test_qp_batch(B, N, M_ROWS, 0, N_ACT, KAPPA,
                                          rng=SEED, dtype=np.float32)
    full = [torch.as_tensor(d[k], device=dev)
            for k in ('H', 'f', 'A', 'bupper', 'blower', 'sense')]
    st = dt.as_settings({"iter_limit": 1000}, torch.float32)

    ok1, k1 = phase_k1(full[0])
    ok2, k2 = phase_k2([a[:B_K2] for a in full], st)
    ok3, launches = phase_slice(full, d, st, card)

    print(json.dumps({"kernels": [
        dict(name="chol_rinv", route="cuda",
             source="daqp_tpu_torch/ops/csrc/chol_rinv.cu",
             replaces="daqp_tpu/ops/chol.py:607",
             launches=launches["chol_rinv"], **k1),
        dict(name="slot_round", route="cuda",
             source="daqp_tpu_torch/ops/csrc/slot_round.cu",
             replaces="daqp_tpu/ops/pallas_slot.py:663",
             launches=launches["slot_round"], **k2)]}), flush=True)
    print(card, flush=True)
    failed = [name for name, ok in (("k1", ok1), ("k2", ok2),
                                    ("slice", ok3)) if not ok]
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
