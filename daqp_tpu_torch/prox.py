"""The proximal-point outer loop of one QP, and its constants.

The port's own copy of ``daqp_tpu/prox.py:32-52`` (``_auto_eta``,
``_auto_eta_static``): the fixed-point tolerance eta of the proximal
iteration (daqp_prox.c:43-48), which the batched semidefinite driver
``batch.solve_batch_prox_kernel`` also uses; and ``:55-222``
(``_Carry``, ``_outer_deadline``, ``_reset_for_resolve``,
``solve_convex_or_prox``), the QP dispatch of the single-instance path:
one LDP solve for a positive definite H, the proximal outer loop for a
semidefinite one (daqp_prox.c:21-189); and ``:224-497``
(``_gradient_step``, ``linprog_core``), the LP regime: adaptive-eps
smoothing with the shrink-at-a-stalled-vertex rule, the eps-normalized
stagnation acceptance, the three-stage vertex cleanup and the duals of
the final working set.  Each outer pass is one ``ldp.ldp_solve`` and a
few reads.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import core
from . import ldp as ldp_mod
from . import transform
from .ops import host_read, late
from .types import (ACTIVE, DAQP_INF, EXIT_ITERLIMIT, EXIT_OPTIMAL,
                    EXIT_RUNNING, EXIT_TIMELIMIT, EXIT_UNBOUNDED, IMMUTABLE,
                    LOWER, Settings, SoftWeights)

DEFAULT_DUAL_TOL = 1e-12
AUTO_ETA_CAP = 1e-6


def auto_eta(st: Settings) -> float:
    """eta_prox, or with eta_prox < 0 the automatic choice: 0.1 dual_tol
    when dual_tol is not the reference default, capped at 1e-6."""
    if float(st.eta_prox) >= 0:
        return float(st.eta_prox)
    if float(st.dual_tol) != DEFAULT_DUAL_TOL:
        return float(min(AUTO_ETA_CAP, 0.1 * float(st.dual_tol)))
    return float(AUTO_ETA_CAP)


class _Carry(NamedTuple):
    """The outer loop's state between passes."""
    state: ldp_mod.LDPState
    x: torch.Tensor           # (n,) the proximal centre
    center_relaxed: bool      # the last pass over-relaxed the centre
    total_iter: int
    status: int               # EXIT_RUNNING while iterating
    best_diff: torch.Tensor   # () smallest ||x - xold||_inf so far
    stall_ct: int             # consecutive passes without improvement


def _outer_deadline(status: int, deadline) -> int:
    """The outer loop's own wall-clock check, once a pass: a pass of one
    inner iteration never reaches the inner loop's check every 32."""
    return EXIT_TIMELIMIT if status == EXIT_RUNNING and late(deadline) \
        else status


def _reset_for_resolve(state: ldp_mod.LDPState, dupper, dlower
                       ) -> ldp_mod.LDPState:
    """New bounds and the per-solve control reset of a warm re-solve."""
    return state._replace(dupper=dupper, dlower=dlower, status=EXIT_RUNNING,
                          iterations=0, tried_repair=0, cycle_counter=0,
                          best_fval=torch.full_like(state.fval, -1.0))


def solve_convex_or_prox(H, f, A, bupper, blower, sense, ms: int,
                         st: Settings, K: int = None, x0=None,
                         deadline: float = None, Rinv=None,
                         soft_weights=None) -> core.SolveOut:
    """The QP dispatch (``daqp_solve``'s n_prox dispatch, api.c:16-31, and
    daqp_prox.c): one warm LDP solve when the factorization needed no
    shift; else the proximal outer loop x <- argmin of the shifted QP
    centred at x until ||x - xold||_inf < eta / eps (or 8 passes without
    improvement), over-relaxed by 1.5 when the active set froze.

    Tensors of one QP on one device.  ``soft_weights``: a ``SoftWeights``
    (raw units; the slack bounds and per-side weights), or a plain (m,)
    penalty per row (``transform.build_ldp``'s row rescaling).
    ``deadline``: absolute ``time.perf_counter()`` seconds, checked every
    32 inner iterations and once per outer pass."""
    n = A.shape[1] if A.numel() else H.shape[0]
    K = n + 1 if K is None else K
    dtype = H.dtype
    sw_struct = soft_weights if isinstance(soft_weights, SoftWeights) \
        else None
    ldpd = core.build_ldp(
        H, f, A, bupper, blower, sense, ms, st, Rinv=Rinv,
        soft_weights=None if sw_struct is not None else soft_weights)
    bu, bl = bupper.to(dtype), blower.to(dtype)
    f_ = torch.zeros(n, dtype=dtype, device=H.device) if f is None \
        else f.to(dtype)
    n_prox, eps_used = host_read(ldpd.n_prox, ldpd.eps_used)
    all_pd = n_prox == 0
    eps = torch.zeros_like(ldpd.eps_used) if all_pd else ldpd.eps_used
    tol_stat = auto_eta(st) / torch.clamp(eps, min=1e-30)
    mask = ldpd.prox_mask
    sw_n = None if sw_struct is None \
        else transform.normalize_soft_weights(sw_struct, ldpd)

    # the unconstrained shortcut, for a plain PD QP only (utils.c:533)
    _, state, unc_ok, x_unc = core.start(ldpd, st, K, sw=sw_n,
                                         shortcut=all_pd)
    eps_zero = all_pd or eps_used == 0.0

    x = torch.zeros(n, dtype=dtype, device=H.device) if x0 is None \
        else x0.to(dtype)
    c = _Carry(state=state, x=x, center_relaxed=False, total_iter=0,
               status=state.status, best_diff=torch.full_like(eps, float("inf")),
               stall_ct=0)
    while c.status == EXIT_RUNNING:
        v = ldpd.Rinv.T @ (f_ - eps * torch.where(mask, c.x, 0.0))
        Mv = ldpd.M @ v
        s = _reset_for_resolve(c.state, bu * ldpd.scaling + Mv,
                               bl * ldpd.scaling + Mv)
        s = ldp_mod.ldp_solve(s, st, deadline=deadline)
        x_new = ldpd.Rinv @ (s.u - v)
        total = c.total_iter + s.iterations
        inner_failed = s.status < 0
        if all_pd:
            # the LDP is the QP: its exit is the answer
            c = c._replace(state=s, x=x_new, total_iter=total,
                           status=s.status)
            continue
        max_diff = (x_new - c.x).abs().max()
        conv, improved = host_read(max_diff < tol_stat,
                                   max_diff < 0.9 * c.best_diff)
        stall = 0 if improved else c.stall_ct + 1
        # arithmetic-floor stagnation (daqp_tpu/prox.py:140-149)
        converged = bool(conv) or (not inner_failed and stall >= 8)
        relax = s.iterations == 1 and not converged
        x_next = c.x + 1.5 * (x_new - c.x) if relax else x_new
        if inner_failed or eps_zero:
            status = s.status
        else:
            status = EXIT_OPTIMAL if converged and not c.center_relaxed \
                else EXIT_RUNNING
        if status == EXIT_RUNNING and total >= st.iter_limit:
            status = EXIT_ITERLIMIT
        c = _Carry(state=s, x=x_next, center_relaxed=relax, total_iter=total,
                   status=_outer_deadline(status, deadline),
                   best_diff=torch.minimum(max_diff, c.best_diff),
                   stall_ct=stall)

    x = x_unc if unc_ok else c.x
    # the reference's fval: the objective + soft_slack / 2 (api.c:457-461)
    fval = 0.5 * x @ (H @ x) + f_ @ x + 0.5 * c.state.soft_slack
    return core.SolveOut(x=x, lam=core.extract_duals(c.state), fval=fval,
                         exitflag=c.status,
                         iterations=max(c.total_iter, 1),
                         soft_slack=c.state.soft_slack, state=c.state)


# ---------------------------------------------------------------------------
# LP path
# ---------------------------------------------------------------------------
def _gradient_step(state: ldp_mod.LDPState, x, xold, bu, bl, st: Settings):
    """Ray search x + alpha (x - xold) to the first blocking row, which is
    activated (gradient_step, daqp_prox.c:201-271).  Returns (found,
    state, x); found False means unbounded."""
    M, scaling = state.M, state.scaling
    delta = x - xold
    ax = (M @ x) / scaling          # the original rows' values (R = I)
    ds = (M @ delta) / scaling
    skip = (state.sense & (ACTIVE | IMMUTABLE)) > 0
    up_ok = ~skip & (ds > 0) & (bu < DAQP_INF)
    lo_ok = ~skip & (ds < 0) & (bl > -DAQP_INF)
    alpha_up = torch.where(up_ok, (bu - ax) / torch.where(up_ok, ds, 1.0),
                           DAQP_INF)
    alpha_lo = torch.where(lo_ok, (bl - ax) / torch.where(lo_ok, ds, 1.0),
                           DAQP_INF)
    cand = torch.minimum(alpha_up, alpha_lo)
    j = torch.argmin(cand)
    found, jj, is_lower = host_read(ldp_mod._at(cand, j) < DAQP_INF, j,
                                    ldp_mod._at(alpha_lo, j)
                                    < ldp_mod._at(alpha_up, j))
    if not found:
        return False, state, x
    j = int(jj)
    x = x + cand[j] * delta
    sj = state.sense[j] | LOWER if is_lower else state.sense[j] & ~LOWER
    state = state._replace(sense=ldp_mod._put(state.sense, j, sj))
    return True, ldp_mod.add_constraint(state, j, -1.0 if is_lower else 1.0,
                                        st), x


def _lp_step(state, x, eps, f_, ldpd, bu, bl, st, deadline=None):
    """One proximal LP pass from centre ``x`` at ``eps``: (state, the new
    x, v)."""
    v = f_ * eps - x
    Mv = ldpd.M @ v
    s = _reset_for_resolve(state, bu * ldpd.scaling + Mv,
                           bl * ldpd.scaling + Mv)
    s = ldp_mod.ldp_solve(s, st, deadline=deadline)
    return s, s.u - v                    # R = I for LPs (daqp.c:115-119)


def _crossover(s, x, f_, bu, bl, n: int, st: Settings, dtol_x: float):
    """Up to 3n simplex-like moves: off a vertex, projected steepest
    descent within the active face to the nearest blocker; at a vertex,
    the most wrong-signed dual's row leaves (``daqp_tpu/prox.py:
    407-458``)."""
    K = s.E.shape[0]
    for _ in range(3 * n):
        mask = torch.arange(K, device=s.E.device) < s.n_active
        nu = -(s.E @ torch.where(mask, s.Mw @ f_, 0.0))
        swb = s.sense[s.WS]
        is_lo = (swb & LOWER) > 0
        immut = (swb & IMMUTABLE) > 0
        sgn_tol = 1e-8 * (1.0 + torch.where(mask, nu, 0.0).abs().max())
        wrong = mask & ~immut & torch.where(is_lo, nu > sgn_tol,
                                            nu < -sgn_tol)
        coef = torch.where(mask, nu, 0.0)
        d = -(f_ + s.Mw.T @ coef)        # projected -f within the face
        if s.n_active >= n:
            rm = torch.argmax(torch.where(wrong, nu.abs(), -1.0))
            go, rm = host_read(wrong.any(), rm)
            if not go:
                return s, x
            s = ldp_mod.remove_constraint(s, int(rm), st)
            continue
        if not host_read(torch.linalg.norm(d) > dtol_x):
            return s, x
        found, s2, x2 = _gradient_step(s, x + d, x, bu, bl, st)
        if found:
            s, x = s2, x2
    return s, x


def linprog_core(f, A, bupper, blower, sense, ms: int, st: Settings,
                 K: int = None, x0=None, deadline: float = None
                 ) -> core.SolveOut:
    """An LP by adaptive proximal smoothing (the daqp_prox.c LP regime,
    chosen by n_prox = n at api.c:175-177): passes x <- the LDP solution
    centred at x - eps f, with eps kept at 1 in the first pass, then x10
    after a one-iteration pass off a vertex and x0.9 otherwise (cap 1e3);
    a one-iteration pass off a vertex takes the gradient step.  It stops
    when ||x - xold||_inf < eta eps, or after 3 stalled vertex passes
    without a 10% gain in ||x - xold||_inf / eps (in f32 the fixed point's
    residual floors in proportion to eps: growing eps there led to
    spurious infeasible exits, ``daqp_tpu/prox.py:264-330``).  An optimal
    exit is cleaned up in three stages (a warm re-solve at eps = 1e-3
    (1 + ||x||) / (1 + ||f||), the crossover to a vertex, the vertex
    system solved through E with one refinement), and its duals come from
    the final working set, nu = -E (M_W f).

    Tensors of one LP on one device; ``deadline`` as in
    ``solve_convex_or_prox``."""
    A = torch.atleast_2d(A)
    n = A.shape[1]
    dtype, dev = A.dtype, A.device
    K = n + 1 if K is None else K
    ldpd = core.build_ldp(None, None, A, bupper, blower, sense, ms, st)
    bu, bl = bupper.to(dtype), blower.to(dtype)
    f_ = f.to(dtype)
    eta = torch.tensor(auto_eta(st), dtype=dtype, device=dev)
    state = ldp_mod.init_state(ldpd.M, ldpd.dupper, ldpd.dlower, ldpd.sense,
                               ldpd.scaling, K=K)
    act_flag, state = ldp_mod.activate_constraints(state, st)
    error = int(host_read(ldpd.error))
    status = error if error < 0 else act_flag if act_flag < 0 \
        else EXIT_RUNNING

    x = torch.zeros(n, dtype=dtype, device=dev) if x0 is None \
        else x0.to(dtype)
    eps = torch.ones((), dtype=dtype, device=dev)
    best = torch.full((), float("inf"), dtype=dtype, device=dev)
    total, stall = 0, 0
    while status == EXIT_RUNNING:
        if total > 0:
            # x10 escapes slow interior progress; at a stalled vertex
            # only the f32 floor can fail the eta eps gate, and that
            # floor grows with eps, so eps shrinks there instead
            grow = state.iterations == 1 and state.n_active != n
            eps = torch.clamp(eps * (10.0 if grow else 0.9), max=1e3)
        s, x_new = _lp_step(state, x, eps, f_, ldpd, bu, bl, st, deadline)
        total += s.iterations
        inner_failed = s.status < 0
        max_diff = (x_new - x).abs().max()
        ndiff = max_diff / eps
        conv, improved = host_read(max_diff < eta * eps, ndiff < 0.9 * best)
        best = torch.minimum(ndiff, best)
        at_vertex_stall = s.iterations == 1 and s.n_active == n
        stall = stall + 1 if at_vertex_stall and not improved else 0
        converged = bool(conv) or (not inner_failed and stall >= 3)
        grad_status = EXIT_RUNNING
        if s.iterations == 1 and s.n_active != n and not converged:
            found, s, x_new = _gradient_step(s, x_new, x, bu, bl, st)
            grad_status = EXIT_RUNNING if found else EXIT_UNBOUNDED
        status = s.status if inner_failed \
            else EXIT_OPTIMAL if converged else grad_status
        if status == EXIT_RUNNING and total >= st.iter_limit:
            status = EXIT_ITERLIMIT
        status = _outer_deadline(status, deadline)
        state, x = s, x_new

    s, x_c = state, x
    if status == EXIT_OPTIMAL:
        # 1) a warm re-solve at small eps
        fscale = (1.0 + torch.linalg.norm(x)) / (1.0 + torch.linalg.norm(f_))
        s2, x2 = _lp_step(s, x, 1e-3 * fscale, f_, ldpd, bu, bl, st)
        if s2.status > 0:
            s, x_c = s2, x2
        # 2) the crossover to a vertex
        dtol_x = 1e-9 * (1.0 + torch.linalg.norm(f_))
        s, x_c = _crossover(s, x_c, f_, bu, bl, n, st, dtol_x)
        x = x_c
        if s.n_active == n:
            # 3) the vertex system through E, one refinement against drift
            mask = torch.arange(K, device=dev) < s.n_active
            swb = s.sense[s.WS]
            bW = torch.where((swb & LOWER) > 0, bl[s.WS], bu[s.WS]) \
                * ldpd.scaling[s.WS]
            bW = torch.where(mask, bW, 0.0)
            for _ in range(2):
                r = torch.where(mask, s.Mw @ x - bW, 0.0)
                x = x - s.Mw.T @ (s.E @ r)

    if status == EXIT_OPTIMAL:
        # the duals of the final working set: f + M_W' nu = 0 there, the
        # cleanup having changed the set without recomputing lam*
        k = s.n_active
        mask = torch.arange(K, device=dev) < k
        nu = -(s.E @ torch.where(mask, s.Mw @ f_, 0.0))
        lam = torch.zeros(ldpd.M.shape[0], dtype=dtype, device=dev)
        ws = s.WS[:k]
        lam[ws] = nu[:k] * s.scaling[ws]
    else:
        # the eps-rescaled inner duals (daqp_prox.c:171-173)
        lam = core.extract_duals(s) / torch.clamp(eps, min=1e-30)
    return core.SolveOut(x=x, lam=lam, fval=f_ @ x, exitflag=status,
                         iterations=max(total, 1), soft_slack=s.soft_slack,
                         state=s)
