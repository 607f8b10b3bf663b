"""The proximal-point outer loop of one QP, and its constants.

The port's own copy of ``daqp_tpu/prox.py:32-52`` (``_auto_eta``,
``_auto_eta_static``): the fixed-point tolerance eta of the proximal
iteration (daqp_prox.c:43-48), which the batched semidefinite driver
``batch.solve_batch_prox_kernel`` also uses; and ``:55-222``
(``_Carry``, ``_outer_deadline``, ``_reset_for_resolve``,
``solve_convex_or_prox``), the QP dispatch of the single-instance path:
one LDP solve for a positive definite H, the proximal outer loop for a
semidefinite one (daqp_prox.c:21-189).  ``linprog_core`` and
``_gradient_step`` (``:224-497``) are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import core
from . import ldp as ldp_mod
from . import transform
from .ops import host_read, late
from .types import (EXIT_ITERLIMIT, EXIT_OPTIMAL, EXIT_RUNNING,
                    EXIT_TIMELIMIT, Settings, SoftWeights)

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
