"""The single-instance QP solve: transform, activate, LDP, extract.

Counterpart of ``daqp_tpu/core.py`` (``:22 SolveOut``, ``:33
extract_duals``, ``:47 quadprog_core``, ``:77 _solve_from_ldp``):
``daqp_quadprog`` (src/api.c:56-71) -> ``setup_daqp_ldp`` ->
``daqp_solve`` -> extract.  The transform is the batched one of
``transform.py`` at B = 1 (``lane`` / ``batched`` convert between the
two forms), so the single-instance and batched paths share it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import ldp as ldp_mod
from . import transform
from .ops import host_read
from .types import EXIT_OPTIMAL, EXIT_RUNNING, Settings


class SolveOut(NamedTuple):
    x: torch.Tensor           # (n,)
    lam: torch.Tensor         # (m,) duals in the original rows
    fval: torch.Tensor        # ()
    exitflag: int
    iterations: int
    soft_slack: torch.Tensor  # ()
    state: ldp_mod.LDPState   # final workspace (warm restarts)


def lane(ldpd: transform.LDPData) -> transform.LDPData:
    """Lane 0 of a batched ``LDPData``."""
    return transform.LDPData(*(x[0] for x in ldpd))


def batched(ldpd: transform.LDPData) -> transform.LDPData:
    """A single lane's ``LDPData`` as a batch of one."""
    return transform.LDPData(*(x[None] for x in ldpd))


def build_ldp(H, f, A, bupper, blower, sense, ms: int, st: Settings,
              Rinv=None, soft_weights=None) -> transform.LDPData:
    """``transform.build_ldp`` of one QP ((n, n), (n,), (m - ms, n), (m,)
    tensors), factoring H unless its ``Rinv`` is given."""
    one = (lambda x: None if x is None else x[None])
    return lane(transform.build_ldp(
        one(f), A[None], bupper[None], blower[None], sense[None], ms, st,
        Rinv=one(Rinv), H=None if Rinv is not None else one(H),
        soft_weights=one(soft_weights)))


def check_unconstrained(ldpd: transform.LDPData, st: Settings):
    """``transform.check_unconstrained`` of one lane: (feasible, a 0-d
    bool tensor; x_unc (n,))."""
    ok, x = transform.check_unconstrained(batched(ldpd), st)
    return ok[0], x[0]


def extract_duals(state: ldp_mod.LDPState) -> torch.Tensor:
    """The working set's duals scattered to a dense (m,) vector, rescaled
    to the original rows (``ldp2qp_solution``'s scaling, daqp.c:135-138,
    and ``daqp_extract_result``, api.c:449-453)."""
    m = state.M.shape[0]
    k = state.n_active
    lam = torch.zeros(m, dtype=state.lam.dtype, device=state.lam.device)
    ws = state.WS[:k]
    lam[ws] = state.lam_star[:k] * state.scaling[ws]
    return lam


def start(ldpd: transform.LDPData, st: Settings, K: int, sw=None,
          shortcut: bool = True):
    """The cold start of a solve from a built LDP: the state (``sw``: the
    normalized SOFT_WEIGHTS data), the sense-ACTIVE rows activated, and
    the status the loop starts from.  A transform error, a failed
    activation or (with ``shortcut``) the unconstrained shortcut
    (``daqp_check_unconstrained``, utils.c:529-598) sets it, and the loop
    is then skipped, as the comment at ``daqp_tpu/core.py:87`` intends
    (the JAX ``_solve_from_ldp``'s ``ldp_solve`` resets the status it set
    and runs the loop all the same).  Returns (activation flag, state,
    whether the shortcut holds, the unconstrained x)."""
    state = ldp_mod.init_state(ldpd.M, ldpd.dupper, ldpd.dlower, ldpd.sense,
                               ldpd.scaling, K=K, sw=sw)
    act_flag, state = ldp_mod.activate_constraints(state, st)
    unc, x_unc = check_unconstrained(ldpd._replace(sense=state.sense), st)
    error, unc_ok = host_read(ldpd.error, unc)
    unc_ok = shortcut and bool(unc_ok)
    pre = EXIT_OPTIMAL if unc_ok else EXIT_RUNNING
    pre = act_flag if act_flag < 0 else pre
    pre = int(error) if error < 0 else pre
    return act_flag, state._replace(status=pre), unc_ok, x_unc


def _solve_from_ldp(ldpd: transform.LDPData, st: Settings, K: int):
    """``start`` and the LDP loop; (activation flag, state)."""
    act_flag, state, _, _ = start(ldpd, st, K)
    return act_flag, ldp_mod.ldp_solve(state, st, reset=False)


def extract(ldpd: transform.LDPData, state: ldp_mod.LDPState,
            min_iterations: int = 0) -> SolveOut:
    """x = Rinv (u - v), the duals and fval = (||u||^2 + penalty -
    ||v||^2) / 2 of a finished state."""
    x = transform.ldp_to_qp_solution(batched(ldpd), state.u[None])[0]
    return SolveOut(x=x, lam=extract_duals(state),
                    fval=0.5 * (state.fval - ldpd.v @ ldpd.v),
                    exitflag=state.status,
                    iterations=max(state.iterations, min_iterations),
                    soft_slack=state.soft_slack, state=state)


def quadprog_core(H, f, A, bupper, blower, sense, ms: int, st: Settings,
                  K: int = None, Rinv=None) -> SolveOut:
    """The dense convex QP one-shot (strictly convex H, or ``Rinv``)."""
    n = A.shape[1] if A.numel() else H.shape[0]
    ldpd = build_ldp(H, f, A, bupper, blower, sense, ms, st, Rinv=Rinv)
    _, state = _solve_from_ldp(ldpd, st, n + 1 if K is None else K)
    return extract(ldpd, state)
