"""Warm MPC horizons over a scenario batch: solver state carried from step
to step.

Counterpart of ``daqp_tpu/mpc.py``: ``:29 MPCStep``, ``:38
solve_mpc_scan_pallas`` and ``:138 solve_mpc_scan_pallas_fused``.  S
scenario rollouts share (H, A); each is a horizon of T steps in which
only f and the bounds change (the UPDATE_v | UPDATE_d contract,
docs/docs/c.md:60-73).  The one shared H is factored once in plain torch
(``transform.build_ldp``), as the JAX package does in XLA; the working set
and inverse Gram ride warm from step to step.  The flat-tier
``solve_mpc_scan`` (``mpc.py:291``) belongs to a later slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import transform
from .batch import resolve_device
from .ops import host_any, slot
from .types import IMMUTABLE, Settings

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
