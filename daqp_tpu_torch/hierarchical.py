"""The lexicographic (hierarchical least-squares) solve of one problem.

Counterpart of ``daqp_tpu/hierarchical.py`` (``:41
_freeze_level_slacks``, ``:63 _reactivate``, ``:125 hiqp_core``), the
reference's ``daqp_hiqp`` (src/hierarchical.c:5-108).  Rows before
``break_points[0]`` are hard from the start; level i covers rows
[break_points[i-1], break_points[i]).  Walking down the levels:

1. the level's rows turn SOFT (rho_soft on their Gram diagonal keeps
   conflicting rows factorizable), its warm-active rows are added, and
   the rows beyond it are flagged IMMUTABLE so that pricing skips them
   (the reference truncates ``work->m``);
2. the LDP is solved warm on the port's ``ldp.py``;
3. the optimal soft violations w = lam* rho_soft are frozen into d and
   reported as the output duals (hierarchical.c:51-65);
4. the level turns hard and the working set is rebuilt, dropping entries
   that became dependent, with the degrees of freedom counted down: none
   left stops the walk, and a failed level exits 3 (EXIT_NO_DOF).

The walk is a Python loop over the levels on the host.
"""
from __future__ import annotations

import torch

from . import core
from . import ldp as ldp_mod
from . import transform
from .ops import host_numpy, host_read
from .types import (ACTIVE, EXIT_ITERLIMIT, EXIT_NO_DOF, EXIT_OPTIMAL,
                    EXIT_RUNNING, IMMUTABLE, LOWER, SOFT, Settings)


def _freeze_level_slacks(state: ldp_mod.LDPState, lam_out, st: Settings):
    """d moved by the optimal soft violations, which become the output
    duals, nudged by 1e-14 to the active side so a zero slack still
    shows it (hierarchical.c:51-65)."""
    k = state.n_active
    ws = state.WS[:k]
    ws_sense = state.sense[ws]
    is_soft = (ws_sense & SOFT) > 0
    w = state.lam_star[:k] * st.rho_soft
    dlower = state.dlower.index_add(
        0, ws, torch.where(is_soft & (w < -st.primal_tol), w, 0.0))
    dupper = state.dupper.index_add(
        0, ws, torch.where(is_soft & (w > st.primal_tol), w, 0.0))
    lam_val = w + torch.where((ws_sense & LOWER) > 0, -1e-14, 1e-14)
    lam_out = lam_out.index_put((ws,), torch.where(is_soft, lam_val,
                                                   lam_out[ws]))
    return state._replace(dlower=dlower, dupper=dupper), lam_out


def _reactivate(state: ldp_mod.LDPState, st: Settings, start: int, n: int):
    """The working set rebuilt after a level hardened, entries that
    became dependent dropped from the level's first entry on
    (hierarchical.c:72-95).  The reference keeps its LDL prefix; an
    explicit inverse has no valid sub-prefix, so every entry is re-added.
    Returns (state, the immutable entries re-added from that first
    entry), for the degrees-of-freedom count."""
    k = state.n_active
    keep = min(k, n)
    ws_np, bits_np = host_numpy(state.WS[:k], state.sense)
    ws = ws_np.tolist()
    bits = bits_np.tolist()
    sense = state.sense.clone()
    for pos in range(keep, k):
        # overdetermined tail entries leave entirely (hierarchical.c:77-80)
        bits[ws[pos]] &= ~(ACTIVE | IMMUTABLE)
        sense[ws[pos]] = bits[ws[pos]]
    j0 = next((pos for pos in range(keep) if ws[pos] >= start), keep)
    lam_save = state.lam_star
    s = state._replace(sense=sense, n_active=0, ns_active=0,
                       E=torch.zeros_like(state.E), sing=False)
    n_imm = 0
    for i in range(keep):
        cid = ws[i]
        s = ldp_mod.add_constraint(s, cid, lam_save[i], st)
        dropped = s.sing and i >= j0
        if dropped:
            # a dependent entry leaves and is mutable again
            s = s._replace(
                n_active=s.n_active - 1,
                ns_active=s.ns_active - int((bits[cid] & SOFT) > 0),
                sense=ldp_mod._put(s.sense, cid,
                                   bits[cid] & ~(ACTIVE | IMMUTABLE)),
                sing=False)
        elif i >= j0 and bits[cid] & IMMUTABLE:
            n_imm += 1
    return s, n_imm


def hiqp_core(H, f, A, bupper, blower, sense, ms: int, break_points: tuple,
              st: Settings, deadline: float = None) -> core.SolveOut:
    """The lexicographic least-squares solve (``daqp_hiqp``).
    ``break_points``: strictly increasing, ending at m.  ``H=None`` is
    the identity metric (least squares on the rows, the reference's
    empty-H setup).  Working-set capacity K = n + the largest level + 1;
    the iteration limit counts every level's iterations together."""
    A = torch.atleast_2d(A)
    n = A.shape[1] if A.numel() else (H.shape[0] if H is not None else ms)
    m = ms + A.shape[0]
    bp = tuple(int(b) for b in break_points)
    assert len(bp) >= 2 and bp[-1] == m, (bp, m)
    K = n + max(b - a for a, b in zip(bp[:-1], bp[1:])) + 1
    dev = A.device
    if H is None:
        H = torch.eye(n, dtype=A.dtype if A.numel() else torch.float64,
                      device=dev)
        fval_lin = f is not None
    else:
        fval_lin = False
    ldpd = core.build_ldp(H, f, A, bupper, blower, sense, ms, st)
    dtype = ldpd.M.dtype
    state = ldp_mod.init_state(ldpd.M, ldpd.dupper, ldpd.dlower, ldpd.sense,
                               ldpd.scaling, K=K)
    # the hard rows before the hierarchy: warm / equality rows < bp[0]
    act_flag, state = ldp_mod.activate_constraints(state, st,
                                                   m_limit=bp[0])
    error = int(host_read(ldpd.error))
    lam_out = torch.zeros(m, dtype=dtype, device=dev)
    done = act_flag < 0 or error < 0
    status = error if error < 0 else act_flag if act_flag < 0 \
        else EXIT_RUNNING
    total_iter = 0
    u_best = state.u
    nfree = n
    rows = torch.arange(m, device=dev)
    for i in range(1, len(bp)):
        if done:
            break
        start, end = bp[i - 1], bp[i]
        beyond = rows >= end
        imm_snapshot = state.sense & IMMUTABLE
        lvl = (rows >= start) & ~beyond
        sense_l = torch.where(lvl, state.sense | SOFT, state.sense)
        sense_l = torch.where(beyond, sense_l | IMMUTABLE, sense_l)
        # the level's warm-started rows (hierarchical.c:28-35)
        act_flag, state = ldp_mod.activate_constraints(
            state._replace(sense=sense_l.to(torch.int32)), st,
            m_limit=end, m_start=start)
        u_prev = state.u
        s = state._replace(status=EXIT_RUNNING, iterations=0,
                           tried_repair=0, cycle_counter=0,
                           best_fval=torch.full_like(state.fval, -1.0))
        s = ldp_mod.ldp_solve(s, st, reset=False, deadline=deadline)
        total_iter += s.iterations
        failed = s.status < 0 or act_flag < 0
        iterlimited = not failed and total_iter >= st.iter_limit
        s, lam_out = _freeze_level_slacks(s, lam_out, st)
        # the level turns hard (hierarchical.c:68)
        s = s._replace(sense=torch.where(lvl, s.sense & ~SOFT, s.sense)
                       .to(torch.int32))
        if i < len(bp) - 1:
            s, n_imm = _reactivate(s, st, start, n)
            nfree -= n_imm
        # the rows beyond the level price again
        s = s._replace(sense=torch.where(
            beyond, (s.sense & ~IMMUTABLE) | imm_snapshot, s.sense)
            .to(torch.int32))
        status = EXIT_NO_DOF if failed \
            else EXIT_ITERLIMIT if iterlimited else s.status
        done = failed or iterlimited or nfree <= 0
        u_best = u_prev if failed else s.u
        state = s

    x = transform.ldp_to_qp_solution(core.batched(ldpd), u_best[None])[0]
    fval = f.to(dtype) @ x if fval_lin \
        else 0.5 * (state.fval - ldpd.v @ ldpd.v)
    return core.SolveOut(
        x=x, lam=lam_out, fval=fval,
        exitflag=EXIT_OPTIMAL if status == EXIT_RUNNING else status,
        iterations=max(total_iter, 1), soft_slack=state.soft_slack,
        state=state)
