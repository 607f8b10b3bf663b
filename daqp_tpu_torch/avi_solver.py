"""The affine variational inequality (AVI) solve of one problem.

Counterpart of ``daqp_tpu/avi_solver.py`` (``:58 _kkt_solve``, ``:91
_check_optimal``, ``:115 avi_core``), the reference's ``daqp_solve_avi``
(src/avi.c:6-101, with ``daqp_solve_avi_kkt`` :103-184 and
``daqp_check_optimal_avi`` :187-221) and its setup (src/utils.c:600-638).

Find x in P = {x : blower <= [x[:ms]; A x] <= bupper} with
(H x + f)'(y - x) >= 0 for every y in P, H possibly asymmetric, by
Douglas-Rachford splitting:

* the inner projection QP in the metric sym(H) + rho I, solved warm on
  the port's ``ldp.py`` (one factorization at setup);
* the outer step x <- (H + rho I)^-1 (rho y + H x + sym(H) (y - x) / 2);
* rho = sqrt(min diag sym(H) * max row sum |sym(H)|), or ||H||_F / 2
  (utils.c:624-627);
* after ``terminate_limit`` passes with a stable inner working set the
  exact KKT / Schur system A_W H^-1 A_W' lam = -(b_W + A_W H^-1 f) on the
  asymmetric H is solved and checked; a step whose natural residual
  grew is reverted and the limit raised by 5, to at most 30
  (avi.c:44-61).

H and H + rho I are LU-factored once (``torch.linalg.lu_factor``) and
reused in the loop.  SOFT rows regularize the Schur system by rho_soft /
scaling^2, as the JAX module does; the batched tier is hard-only.
"""
from __future__ import annotations

import torch

from . import core
from . import ldp as ldp_mod
from .ops import host_read, late
from .types import (ACTIVE, DAQP_INF, EXIT_ITERLIMIT, EXIT_OPTIMAL,
                    EXIT_RUNNING, EXIT_TIMELIMIT, IMMUTABLE, LOWER, SOFT,
                    Settings)


def _lu_solve(lu, b):
    return torch.linalg.lu_solve(*lu, b[:, None])[:, 0] if b.dim() == 1 \
        else torch.linalg.lu_solve(*lu, b)


def _kkt_solve(state: ldp_mod.LDPState, Aall, H_lu, f, bupper, blower,
               st: Settings):
    """The exact KKT / Schur solve on the asymmetric H for the working
    set: (x, lam over the (K,) working-set buffer)."""
    K = state.E.shape[0]
    mask = torch.arange(K, device=Aall.device) < state.n_active
    ws = state.WS
    Aw = torch.where(mask[:, None], Aall[ws], 0.0)
    ws_sense = state.sense[ws]
    S = Aw @ _lu_solve(H_lu, Aw.T)
    soft_reg = torch.where(
        mask & ((ws_sense & SOFT) > 0),
        st.rho_soft / torch.clamp(state.scaling[ws] ** 2, min=1e-30), 0.0)
    S = S + torch.diag(soft_reg)
    # the identity on the unused block keeps the solve well posed
    S = torch.where(mask[:, None] & mask[None, :], S, 0.0) \
        + torch.diag(torch.where(mask, 0.0, 1.0).to(S.dtype))
    b_w = torch.where((ws_sense & LOWER) > 0, blower[ws], bupper[ws])
    rhs = torch.where(mask, -(b_w + Aw @ _lu_solve(H_lu, f)), 0.0)
    lam = torch.where(mask, torch.linalg.solve(S, rhs), 0.0)
    return _lu_solve(H_lu, -f - Aw.T @ lam), lam


def _check_optimal(state: ldp_mod.LDPState, x, lam, Aall, bupper, blower,
                   st: Settings) -> torch.Tensor:
    """The KKT check: dual signs on the mutable working set, primal
    feasibility of the other rows (a 0-d bool tensor)."""
    K = state.E.shape[0]
    mask = torch.arange(K, device=Aall.device) < state.n_active
    ws_sense = state.sense[state.WS]
    immut = (ws_sense & IMMUTABLE) > 0
    dual_ok = torch.where(
        mask & ~immut,
        torch.where((ws_sense & LOWER) > 0, lam <= st.dual_tol,
                    lam >= -st.dual_tol), True).all()
    r = Aall @ x
    inactive = (state.sense & ACTIVE) == 0
    primal_ok = torch.where(
        inactive, (r <= bupper + st.primal_tol) & (r >= blower - st.primal_tol),
        True).all()
    return dual_ok & primal_ok


def avi_core(H, f, A, bupper, blower, sense, ms: int, st: Settings,
             K: int = None, x0=None, deadline: float = None
             ) -> core.SolveOut:
    """Solve the AVI (``daqp_solve_avi``).  Tensors of one problem on one
    device; ``deadline`` is checked by the inner loop every 32 iterations
    and once per outer pass (a stable pass runs one inner iteration)."""
    A = torch.atleast_2d(A)
    n = H.shape[0]
    m = ms + A.shape[0]
    dtype, dev = H.dtype, H.device
    K = n + 1 if K is None else K
    f, bupper, blower = f.to(dtype), bupper.to(dtype), blower.to(dtype)

    # the regularization heuristic (utils.c:607-631)
    Hsym = 0.5 * (H + H.T)
    min_diag = torch.diagonal(Hsym).min()
    max_row_sum = Hsym.abs().sum(1).max()
    rho = torch.where((min_diag > 0) & (max_row_sum > 0),
                      torch.sqrt(torch.clamp(min_diag * max_row_sum,
                                             min=1e-30)),
                      torch.sqrt((H * H).sum()) / 2)
    eye = torch.eye(n, dtype=dtype, device=dev)
    Hs_rho = Hsym + rho * eye
    H_lu = torch.linalg.lu_factor(H)
    H_rho_lu = torch.linalg.lu_factor(H + rho * eye)
    Aall = torch.cat([eye[:ms], A]) if ms > 0 else A

    ldpd = core.build_ldp(Hs_rho, None, A, bupper, blower, sense, ms, st)
    state = ldp_mod.init_state(ldpd.M, ldpd.dupper, ldpd.dlower, ldpd.sense,
                               ldpd.scaling, K=K)
    act_flag, state = ldp_mod.activate_constraints(state, st)

    # the unconstrained shortcut (utils.c:54-55, :547-551)
    x_unc = _lu_solve(H_lu, -f)
    r_unc = Aall @ x_unc
    unc = ((r_unc <= bupper + st.primal_tol)
           & (r_unc >= blower - st.primal_tol)).all() \
        & ((state.sense & (ACTIVE | IMMUTABLE)) == 0).all()
    error, unc_ok = host_read(ldpd.error, unc)
    status = int(error) if error < 0 else act_flag if act_flag < 0 \
        else EXIT_OPTIMAL if unc_ok else EXIT_RUNNING

    x = y = torch.zeros(n, dtype=dtype, device=dev) if x0 is None \
        else x0.to(dtype)
    xold = torch.zeros(n, dtype=dtype, device=dev)
    lam = torch.zeros(K, dtype=dtype, device=dev)
    min_res = torch.full((), DAQP_INF, dtype=dtype, device=dev)
    counter, tlim, tot, k = 0, 5, 0, 0
    while status == EXIT_RUNNING:
        Hx = H @ x
        v = ldpd.Rinv.T @ (Hx + f - Hs_rho @ x)
        Mv = ldpd.M @ v
        s = state._replace(dupper=bupper * ldpd.scaling + Mv,
                           dlower=blower * ldpd.scaling + Mv,
                           status=EXIT_RUNNING, iterations=0, tried_repair=0,
                           cycle_counter=0,
                           best_fval=torch.full_like(state.fval, -1.0))
        s = ldp_mod.ldp_solve(s, st, reset=False, deadline=deadline)
        y_inner = ldpd.Rinv @ (s.u - v)
        tot += s.iterations
        if counter == tlim:
            # the Newton step's progress: revert it if the natural
            # residual grew (avi.c:44-61)
            res2 = ((x - y_inner) ** 2).sum()
            if host_read(res2 > min_res):
                x = xold
                tlim = min(tlim + 5, 30)
            else:
                min_res, y = res2, y_inner
        else:
            y = y_inner
        # a stable working set: try the exact KKT point (avi.c:65-80)
        counter = counter + 1 if s.iterations == 1 else 0
        if s.iterations == 1 and counter == tlim:
            x_kkt, lam = _kkt_solve(s, Aall, H_lu, f, bupper, blower, st)
            if host_read(_check_optimal(s, x_kkt, lam, Aall, bupper, blower,
                                        st)):
                status = EXIT_OPTIMAL
            xold, x = x, x_kkt
        else:
            # avi.c:84-96
            x = _lu_solve(H_rho_lu,
                          rho * y + Hx + 0.5 * (Hsym @ (y - x)))
        k += 1
        if s.status < 0:
            status = s.status
        elif status == EXIT_RUNNING and k >= st.iter_limit:
            status = EXIT_ITERLIMIT
        if status == EXIT_RUNNING and late(deadline):
            status = EXIT_TIMELIMIT
        state = s

    if unc_ok:
        x = x_unc
    # the KKT duals lie in the original rows already
    nk = state.n_active
    lam_m = torch.zeros(m, dtype=dtype, device=dev)
    lam_m[state.WS[:nk]] = lam[:nk]
    return core.SolveOut(x=x, lam=lam_m, fval=f @ x, exitflag=status,
                         iterations=max(tot, 1),
                         soft_slack=state.soft_slack, state=state)
