"""Warm MPC horizons over a scenario batch: solver state carried from step
to step.

Counterpart of ``daqp_tpu/mpc.py``: ``:29 MPCStep``, ``:38
solve_mpc_scan_pallas``, ``:138 solve_mpc_scan_pallas_fused`` and
``:291 solve_mpc_scan`` (the flat tier's horizon, in the caller's dtype).  S
scenario rollouts share (H, A); each is a horizon of T steps in which
only f and the bounds change (the UPDATE_v | UPDATE_d contract,
docs/docs/c.md:60-73).  The one shared H is factored once in plain torch
(``transform.build_ldp``), as the JAX package does in XLA; the working set
and inverse Gram ride warm from step to step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import ldp_flat, transform
from .batch import factor_batch, resolve_device
from .ops import host_any, slot
from .types import EXIT_RUNNING, IMMUTABLE, Settings

redone_segments = 0     # B3 segments redone on the per-step path


class MPCStep(NamedTuple):
    x: torch.Tensor           # (S, T, n)
    fval: torch.Tensor        # (S, T)
    exitflag: torch.Tensor    # (S, T) int32
    iterations: torch.Tensor  # (S, T) int32


def _horizon(H, A, f_seq, bupper_seq, blower_seq, st, ms, device):
    """The shared transform (factorization and M once) and the per-(s, t)
    v and bounds d in LDP space; returns (ldpd0, v_st, du_st, dl_st, s0)
    with s0 the cold S-lane slot state at step 0."""
    dev = resolve_device((H, A, f_seq, bupper_seq, blower_seq), device)
    f32 = torch.float32
    H, A, f_seq, bupper_seq, blower_seq = (
        torch.as_tensor(x, device=dev).to(f32)
        for x in (H, A, f_seq, bupper_seq, blower_seq))
    S, T, n = f_seq.shape
    m = bupper_seq.shape[-1]
    ldpd0 = transform.build_ldp(f_seq[:1, 0], A[None], bupper_seq[:1, 0],
                                blower_seq[:1, 0], None, ms, st, H=H[None])
    Rinv, M, scaling = ldpd0.Rinv[0], ldpd0.M[0], ldpd0.scaling[0]
    v_st = torch.einsum('ji,stj->sti', Rinv, f_seq)
    Mv = torch.einsum('mj,stj->stm', M, v_st)
    du_st = bupper_seq * scaling + Mv
    dl_st = blower_seq * scaling + Mv
    immut = ((ldpd0.sense[0] & IMMUTABLE) > 0).to(f32).expand(S, m)
    s0 = slot.slot_init(M.expand(S, m, n), du_st[:, 0], dl_st[:, 0],
                        scaling.expand(S, m), immut, n_true=n)
    return ldpd0, v_st, du_st, dl_st, s0


def _steps_slot_solve(s, duq, dlq, st, n, steps):
    """Per-step repair path over P steps (``duq``/``dlq`` (S, P, m)):
    refresh the bounds, reset the control state of every lane and run
    ``slot_solve``; returns (s, useq, fvseq, itseq, stseq)."""
    outs = []
    for p in range(duq.shape[1]):
        s = slot.reset_control(slot.slot_refresh_bounds(s, duq[:, p],
                                                        dlq[:, p]))
        s = slot.slot_solve(s, st, n_true=n, steps=steps)
        outs.append((s.u, s.fval, s.iterations, s.status))
    return (s,) + tuple(torch.stack(z, 1) for z in zip(*outs))


def _result(ldpd0, v_st, us, fvals, iters, flags) -> MPCStep:
    """x = Rinv (u - v) and the QP objective per (s, t)."""
    x = torch.einsum('ij,stj->sti', ldpd0.Rinv[0], us - v_st)
    fq = 0.5 * (fvals - (v_st * v_st).sum(-1))
    return MPCStep(x=x, fval=fq, exitflag=flags.to(torch.int32),
                   iterations=iters.to(torch.int32))


def solve_mpc_scan_kernel(H, A, f_seq, bupper_seq, blower_seq,
                          st: Settings, ms: int = 0, steps: int = 32,
                          device=None) -> MPCStep:
    """Scenario-batched warm MPC horizon, one ``slot_solve`` (K2 rounds
    with repair and polish) per horizon step.

    ``f_seq``: (S, T, n); ``bupper_seq``/``blower_seq``: (S, T, m).
    Returns per-(scenario, step) results with leading dims (S, T)."""
    ldpd0, v_st, du_st, dl_st, s0 = _horizon(H, A, f_seq, bupper_seq,
                                             blower_seq, st, ms, device)
    n = v_st.shape[-1]
    _, us, fvals, iters, flags = _steps_slot_solve(s0, du_st, dl_st, st, n,
                                                   steps)
    return _result(ldpd0, v_st, us, fvals, iters, flags)


def solve_mpc_scan_kernel_fused(H, A, f_seq, bupper_seq, blower_seq,
                                st: Settings, ms: int = 0, seg: int = 10,
                                steps: int = 192,
                                device=None) -> MPCStep:
    """Scenario-batched warm MPC horizon with ``seg`` steps per B3 launch
    (``ops.slot.run_mpc_segment``; its twin on the CPU).

    Segment 0 always takes the per-step repair path: its first step is
    the cold solve, where pivot-guard parks and repair rounds are
    routine.  If any lane fails inside a later segment, the whole segment
    is redone on the per-step path for the whole batch.  E gets one Newton
    refresh after every segment.  T is padded to a multiple of ``seg`` by
    repeating the last step; outputs are cut back to T.  Same signature
    and results as ``solve_mpc_scan_kernel`` plus ``seg``."""
    global redone_segments
    ldpd0, v_st, du_st, dl_st, s = _horizon(H, A, f_seq, bupper_seq,
                                            blower_seq, st, ms, device)
    S, T, n = v_st.shape
    Tp = -(-T // seg) * seg
    if Tp != T:
        du_st = torch.cat([du_st, du_st[:, -1:].expand(S, Tp - T, -1)], 1)
        dl_st = torch.cat([dl_st, dl_st[:, -1:].expand(S, Tp - T, -1)], 1)
    parts = []
    for t0 in range(0, Tp, seg):
        duq = du_st[:, t0:t0 + seg].contiguous()
        dlq = dl_st[:, t0:t0 + seg].contiguous()
        if t0 > 0:
            s_f, *seqs, failed = slot.run_mpc_segment(s, duq, dlq, st, n,
                                                      steps=steps)
        if t0 == 0 or host_any(failed > 0):
            redone_segments += t0 > 0
            s_f, *seqs = _steps_slot_solve(s, duq, dlq, st, n, steps)
        s = slot.newton_refresh(s_f)
        parts.append(seqs)
    us, fvals, iters, flags = (torch.cat(z, 1)[:, :T] for z in zip(*parts))
    return _result(ldpd0, v_st, us, fvals, iters, flags)


def solve_mpc_scan(H, A, f_seq, bupper_seq, blower_seq, st: Settings,
                   ms: int = 0, device=None) -> MPCStep:
    """A horizon of QPs sharing (H, A) on the flat tier (``ldp_flat``), in
    the inputs' dtype: one ``build_ldp`` at step 0 (H factored once, as
    the flat tier factors), then per step t only v and d
    (``transform.update_vd``, utils.c:14-135 with UPDATE_v | UPDATE_d),
    the control state reset, one Newton polish E <- E (2I - G E) of the
    warm inverse Gram kept where ||G E - I||_max < 1/2 (a 1-3 iteration
    warm re-solve exits before ``flat_solve``'s own refresh runs), and
    ``flat_solve`` from the previous step's slots.  Iterations are
    reported as max(it, 1).

    ``f_seq``: (T, n), ``bupper_seq`` / ``blower_seq``: (T, m), as the
    JAX function; or (S, T, n) / (S, T, m) for S scenarios solved as one
    batch (the JAX function vmapped), with results (S, T, ...)."""
    dev = resolve_device((H, A, f_seq, bupper_seq, blower_seq), device)
    H = torch.as_tensor(H, device=dev)
    A, f_seq, bupper_seq, blower_seq = (
        torch.as_tensor(x, device=dev).to(H.dtype)
        for x in (A, f_seq, bupper_seq, blower_seq))
    one = f_seq.dim() == 2
    if one:
        f_seq, bupper_seq, blower_seq = (x[None] for x in (f_seq, bupper_seq,
                                                         blower_seq))
    S, T, n = f_seq.shape
    fact = tuple(x.expand((S,) + x.shape[1:])
                 for x in factor_batch(H[None], st))
    ldpd0 = transform.build_ldp(f_seq[:, 0], A.expand((S,) + A.shape),
                                bupper_seq[:, 0], blower_seq[:, 0], None, ms,
                                st, fact=fact)
    s = ldp_flat.flat_init(ldpd0.M, ldpd0.dupper, ldpd0.dlower, ldpd0.sense,
                           ldpd0.scaling, K=n + 1)
    outs = []
    for t in range(T):
        ldpd = transform.update_vd(ldpd0, f_seq[:, t], bupper_seq[:, t],
                                   blower_seq[:, t])
        s = s._replace(dupper=ldpd.dupper, dlower=ldpd.dlower,
                       status=torch.full_like(s.status, EXIT_RUNNING),
                       iterations=torch.zeros_like(s.iterations),
                       repaired=torch.zeros_like(s.repaired),
                       cycle=torch.zeros_like(s.cycle),
                       best_fval=torch.full_like(s.best_fval, -1.0))
        G = ldp_flat.flat_gram(s, st)
        um = s.used[:, :, None] & s.used[:, None, :]
        Iu = torch.diag_embed(s.used.to(s.E.dtype))
        P = torch.matmul(G, s.E)
        E_new = torch.where(um, torch.matmul(s.E, 2 * Iu - P), 0.0)
        basin = (P - Iu).abs().amax((1, 2)) < 0.5
        s = ldp_flat.flat_solve(s._replace(E=torch.where(
            basin[:, None, None], E_new, s.E)), st)
        outs.append((transform.ldp_to_qp_solution(ldpd, s.u),
                     0.5 * (s.fval - (ldpd.v * ldpd.v).sum(1)), s.status,
                     torch.clamp(s.iterations, min=1)))
    x, fval, flags, iters = (torch.stack(z, 1) for z in zip(*outs))
    out = MPCStep(x=x, fval=fval, exitflag=flags.to(torch.int32),
                  iterations=iters.to(torch.int32))
    return MPCStep(*(v[0] for v in out)) if one else out
