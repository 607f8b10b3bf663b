"""The single-instance dual active-set LDP solver, driven from the host.

Counterpart of ``daqp_tpu/ldp.py``: ``:62 LDPState``, ``:102
init_state``, ``:160 add_constraint``, ``:241 remove_constraint``,
``:296 refactor``, ``:317-583`` (``compute_csp``, ``remove_blocking``,
``compute_primal_and_fval``, ``add_infeasible``, ``newton_refresh_E``,
``refine_active``), ``:596-748`` (``_optimal_path``, ``_cycle_guard``,
``_nonsingular_step``, ``_singular_step``, each with its ``batch_mode``
branch), ``:751 ldp_solve``, ``:803 batch_post_pass``, ``:842
ldp_solve_batched_lane`` and ``:853 activate_constraints``.

It solves min ||u||^2 s.t. dlower <= M u <= dupper by the dual
active-set method (reference ``src/daqp.c:6-108``) on the explicit
inverse E = (M_W M_W')^-1 of the working set's Gram, kept in a fixed
(K, K) buffer as the JAX module keeps it: a bordered rank-one update adds
a row, a deletion update removes one, and a refactorization rebuilds E.
The JAX module runs the loop inside ``lax.while_loop`` with ``lax.cond``
branches; here the loop and its branches are Python on the host, every
array stays on the tensors' device, and each decision reads the scalars
it needs from the device at once through ``ops.host_read`` (counted in
``ops.host_syncs``).  The control scalars (``n_active``, ``status``,
``iterations``, ...) are Python values: each changes only where such a
read decided it.  Every pricing rule and tie keeps the JAX module's
order (``torch.argmin`` returns the first minimum, as ``jnp.argmin``).

``batch_mode`` (the JAX module's vmapped ordered tier) declares a lane
optimal without the repair / refinement ladder and exits CYCLE where the
guard trips; ``batch_post_pass`` applies that ladder once between solve
rounds (``ldp_solve_batched_lane``).  ``batch.solve_batch_jit`` runs its
lanes one after another on this host-driven state, the port's form of a
vmap of a host-driven solver.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .ops import host_numpy, host_read, late
from .types import (ACTIVE, IMMUTABLE, LOWER, SOFT, SLACK_FIXED, DAQP_INF,
                    EXIT_CYCLE, EXIT_INFEASIBLE, EXIT_ITERLIMIT,
                    EXIT_OPTIMAL, EXIT_OVERDETERMINED_INITIAL, EXIT_RUNNING,
                    EXIT_SOFT_OPTIMAL, EXIT_TIMELIMIT, PRICING_BLAND,
                    Settings, SoftWeights)


class LDPState(NamedTuple):
    """The solver's workspace (reference ``DAQPWorkspace``,
    include/types.h:121-196).  Tensors on one device; the control scalars
    are Python values."""
    M: torch.Tensor          # (m, n) constraint rows in u-space
    dupper: torch.Tensor     # (m,)
    dlower: torch.Tensor     # (m,)
    scaling: torch.Tensor    # (m,)
    sense: torch.Tensor      # (m,) int32 bit flags
    WS: torch.Tensor         # (K,) int64 constraint ids, in order
    lam: torch.Tensor        # (K,) dual iterate
    lam_star: torch.Tensor   # (K,) constrained stationary point
    Mw: torch.Tensor         # (K, n) rows of M of the working set
    E: torch.Tensor          # (K, K) inverse Gram, zero off the block
    n_active: int
    ns_active: int           # active soft rows on the Gram diagonal
    sing: bool               # the last working-set entry is singular
    sing_dir: torch.Tensor   # (K,) null-space direction when singular
    u: torch.Tensor          # (n,)
    fval: torch.Tensor       # () ||u||^2 + the soft penalty
    soft_slack: torch.Tensor  # ()
    iterations: int
    cycle_counter: int
    tried_repair: int        # 0 none, 1 repaired, >= 2 Bland escalation
    best_fval: torch.Tensor  # ()
    status: int              # EXIT_RUNNING while iterating
    in_bnb: bool             # cycling exits instead of repairing
    # SOFT_WEIGHTS slack data ((m,) each, normalized by the row scaling,
    # utils.c:99); None for the plain soft rows of uniform rho_soft
    sw: Optional[SoftWeights] = None


def init_state(M, dupper, dlower, sense=None, scaling=None, K=None,
               sw: SoftWeights = None) -> LDPState:
    """A fresh workspace on M's device, in M's type, with capacity K =
    n + ns + 1 (reference allocation ``src/api.c:288-305``)."""
    M = torch.as_tensor(M)
    m, n = M.shape
    dtype, dev = M.dtype, M.device
    sense = torch.zeros(m, dtype=torch.int32, device=dev) if sense is None \
        else torch.as_tensor(sense, device=dev).to(torch.int32)
    if K is None:
        K = n + int(host_read(((sense & SOFT) > 0).sum())) + 1
    scaling = torch.ones(m, dtype=dtype, device=dev) if scaling is None \
        else torch.as_tensor(scaling, device=dev).to(dtype)

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return LDPState(
        M=M, dupper=torch.as_tensor(dupper, device=dev).to(dtype),
        dlower=torch.as_tensor(dlower, device=dev).to(dtype),
        scaling=scaling, sense=sense,
        WS=torch.zeros(K, dtype=torch.int64, device=dev), lam=z(K),
        lam_star=z(K), Mw=z(K, n), E=z(K, K), n_active=0, ns_active=0,
        sing=False, sing_dir=z(K), u=z(n), fval=z(), soft_slack=z(),
        iterations=0, cycle_counter=0, tried_repair=0, best_fval=z() - 1.0,
        status=EXIT_RUNNING, in_bnb=False, sw=sw)


# ---------------------------------------------------------------------------
# small utilities
# ---------------------------------------------------------------------------
def _mask1(state: LDPState, k: int = None) -> torch.Tensor:
    K = state.E.shape[0]
    k = state.n_active if k is None else k
    return torch.arange(K, device=state.E.device) < k


def _mask2(state: LDPState, k: int) -> torch.Tensor:
    r = _mask1(state, k)
    return r[:, None] & r[None, :]


def _delete_at(arr, pos: int, axis: int = 0):
    """Entries after ``pos`` shift down by one along ``axis``; the last
    one is repeated (the JAX module's compaction)."""
    a = arr.movedim(axis, 0)
    a = torch.cat([a[:pos], a[pos + 1:], a[-1:]])
    return a.movedim(0, axis)


def _put(arr, pos: int, val):
    """``arr`` with entry ``pos`` set to ``val`` (a number or a tensor
    on ``arr``'s device), as a new tensor."""
    out = arr.clone()
    out[pos] = val
    return out


def _side(sense_bits, lower, upper):
    return torch.where((sense_bits & LOWER) > 0, lower, upper)


def _at(arr, i):
    """``arr[i]`` for a 0-d index tensor ``i``, as a gather (indexing
    with a 0-d tensor would read it to the host)."""
    return arr.index_select(0, i.view(1)).squeeze(0)


def _read_entry(state: LDPState, pos: int) -> Tuple[int, int]:
    """(WS[pos], sense[WS[pos]]) on the host, one read."""
    idx = state.WS[pos]
    a, b = host_read(idx, _at(state.sense, idx))
    return int(a), int(b)


# ---------------------------------------------------------------------------
# working-set / inverse-Gram maintenance
# ---------------------------------------------------------------------------
def add_constraint(state: LDPState, idx: int, lam_val, st: Settings,
                   sw_free=None) -> LDPState:
    """Bordered-inverse addition of row ``idx`` (a host int) with dual
    ``lam_val`` (``daqp_add_constraint`` + ``daqp_update_LDL_add``,
    auxiliary.c:27-44, factorization.c:7-98): with g = M_W m_i, a = E g
    and the Schur complement s = m_i'm_i + rho - g'a, E += w w'/s for
    w = [a; -1].  Below ``sing_tol``, or past n + ns active rows, the row
    enters flagged singular with the null-space direction [-a; 1] (sign
    flipped for a lower bound) and E unchanged.  A full table makes the
    add a no-op.

    ``sw_free`` (SOFT_WEIGHTS only) overrides the slack state derived from
    ``lam_val``: the blocking re-add passes the flipped previous state
    (``daqp_tpu/ldp.py:168-176``)."""
    K, n = state.E.shape[0], state.M.shape[1]
    k = state.n_active
    if k >= K:
        return state
    mask = _mask1(state)
    mi = state.M[idx]
    sense_i = state.sense[idx]
    is_soft = (sense_i & SOFT) > 0
    if state.sw is not None:
        # the slack state machine (auxiliary.c:30-36): a slack at its
        # bound is FIXED (the row acts hard); past it FREE, with its
        # side's rho on the Gram diagonal (factorization.c:31-40)
        is_lo = (sense_i & LOWER) > 0
        free = torch.where(is_lo, lam_val <= -state.sw.d_ls[idx],
                           lam_val >= state.sw.d_us[idx]) \
            if sw_free is None else bool(sw_free)
        rho_side = torch.where(is_lo, state.sw.rho_ls[idx],
                               state.sw.rho_us[idx])
        contributes = is_soft & free
        dii = mi @ mi + torch.where(contributes, rho_side, 0.0)
        if sw_free is None:
            sense_idx = torch.where(free, sense_i & ~SLACK_FIXED,
                                    sense_i | SLACK_FIXED)
        else:
            sense_idx = sense_i & ~SLACK_FIXED if free \
                else sense_i | SLACK_FIXED
    else:
        contributes = is_soft
        dii = mi @ mi + is_soft.to(mi.dtype) * st.rho_soft
        sense_idx = sense_i
    g = torch.where(mask, state.Mw @ mi, 0.0)
    alpha = state.E @ g
    s_val = dii - g @ alpha
    contrib, small = host_read(contributes, s_val < st.sing_tol)
    ns_new = state.ns_active + int(contrib)
    singular = bool(small) or k >= n + ns_new

    sense = _put(state.sense, idx, sense_idx | ACTIVE)
    base = state._replace(
        WS=_put(state.WS, k, idx), lam=_put(state.lam, k, lam_val),
        Mw=_put(state.Mw, k, mi), sense=sense, n_active=k + 1,
        ns_active=ns_new)
    if singular:
        sdir = _put(torch.where(mask, -alpha, 0.0), k, 1.0)
        sdir = torch.where((sense[idx] & LOWER) > 0, -sdir, sdir)
        return base._replace(sing=True, sing_dir=sdir)
    w = _put(torch.where(mask, alpha, 0.0), k, -1.0)
    return base._replace(E=state.E + torch.outer(w, w) / s_val, sing=False)


def _soft_count(state: LDPState, sense_bits: int) -> int:
    """1 if a row of these sense bits sits on the Gram diagonal as soft
    (with SOFT_WEIGHTS data: only a FREE slack), else 0."""
    soft = (sense_bits & SOFT) > 0
    if state.sw is not None:
        soft = soft and (sense_bits & SLACK_FIXED) == 0
    return int(soft)


def remove_constraint(state: LDPState, rm_pos: int, st: Settings,
                      entry: Tuple[int, int] = None) -> LDPState:
    """Deletion-inverse removal of working-set position ``rm_pos``, then
    compaction (``daqp_remove_constraint`` + ``daqp_update_LDL_remove``,
    auxiliary.c:3-26, factorization.c:99-138): E -= e e'/E_rr.  Removing
    a position before a singular last entry re-adds that entry, whose
    Schur complement may have turned positive.  ``entry``: (row id, its
    sense bits), when the caller has read them already."""
    K = state.E.shape[0]
    k = state.n_active
    idx, bits = _read_entry(state, rm_pos) if entry is None else entry
    was_sing = state.sing
    rm_soft = _soft_count(state, bits)
    sense = _put(state.sense, idx, bits & ~ACTIVE)
    k_ns = k - int(was_sing)            # entries covered by E
    E = state.E
    if rm_pos < k_ns:
        e = E[:, rm_pos]
        # safe division: E_rr >= 1/G_rr, and G_rr ~ 1 for unit-norm rows
        E = E - torch.outer(e, e) / e[rm_pos]
        E = _delete_at(_delete_at(E, rm_pos, 0), rm_pos, 1)
    k2 = k - 1
    readd = was_sing and rm_pos < k2
    E = E * _mask2(state, k2 - int(readd))
    s = state._replace(
        E=E, sense=sense, WS=_delete_at(state.WS, rm_pos),
        lam=_delete_at(state.lam, rm_pos),
        Mw=_delete_at(state.Mw, rm_pos, 0), n_active=k2,
        ns_active=state.ns_active - rm_soft, sing=False)
    if not readd:
        return s
    pos = s.n_active - 1
    idx2, bits2 = _read_entry(s, pos)
    s = s._replace(n_active=pos, ns_active=s.ns_active
                   - _soft_count(s, bits2))
    return add_constraint(s, idx2, s.lam[pos], st)


def refactor(state: LDPState, st: Settings) -> LDPState:
    """E rebuilt from scratch for the working set, by re-adding its rows
    in order until one is singular (the repair path's fresh
    factorization, ``src/daqp.c:32-46`` / ``:66-85``)."""
    k = state.n_active
    ws = host_numpy(state.WS[:k])[0].tolist() if k else []
    lam = state.lam
    s = state._replace(n_active=0, ns_active=0, E=torch.zeros_like(state.E),
                       sing=False)
    for i in range(k):
        if s.sing:
            break
        s = add_constraint(s, ws[i], lam[i], st)
    return s


# ---------------------------------------------------------------------------
# iteration primitives
# ---------------------------------------------------------------------------
def compute_csp(state: LDPState) -> LDPState:
    """lam* = -E d_W, the constrained stationary point (replaces
    ``daqp_compute_CSP``, auxiliary.c:313-353)."""
    mask = _mask1(state)
    ws = state.WS
    swb = state.sense[ws]
    d = _side(swb, state.dlower[ws], state.dupper[ws])
    if state.sw is not None:
        # free soft slacks shift the right-hand side by their bound's
        # share (auxiliary.c:313-332, SOFT_WEIGHTS branch)
        free_soft = ((swb & SOFT) > 0) & ((swb & SLACK_FIXED) == 0)
        corr = _side(swb, state.sw.rho_ls[ws] * state.sw.d_ls[ws],
                     -state.sw.rho_us[ws] * state.sw.d_us[ws])
        d = d + torch.where(free_soft, corr, 0.0)
    d = torch.where(mask, d, 0.0)
    return state._replace(lam_star=-(state.E @ d))


def _blocking(state: LDPState, st: Settings):
    """The min-ratio search of ``remove_blocking`` on the device: (cand,
    DAQP_INF where a row is not eligible; the step direction delta)."""
    mask = _mask1(state)
    swb = state.sense[state.WS]
    immut = (swb & IMMUTABLE) > 0
    is_lower = (swb & LOWER) > 0
    if state.sing:
        direction = delta = state.sing_dir
    else:
        direction, delta = state.lam_star, state.lam_star - state.lam
    if state.sw is None:
        infeas = torch.where(is_lower, direction > st.dual_tol,
                             direction < -st.dual_tol)
        elig = mask & ~immut & infeas
        cand = -state.lam / delta
        # every eligible entry takes part; nonfinite or negative ratios
        # clamp to a zero step (auxiliary.c:283-287's exit gate)
        cand = torch.where(torch.isfinite(cand),
                           torch.clamp(cand, min=0.0), 0.0)
        return torch.where(elig, cand, DAQP_INF), delta
    # SOFT_WEIGHTS variant (auxiliary.c:199-274): the line search runs on
    # the slack dual lam + d per side, and a soft row whose dual sits at
    # its slack transition in the crossing direction is at its
    # coordinate optimum and left out (the kink guard,
    # daqp_tpu/ldp.py:391-400)
    ws = state.WS
    d_ls_w, d_us_w = state.sw.d_ls[ws], state.sw.d_us[ws]
    free = (swb & SLACK_FIXED) == 0
    p, ls_star = delta, direction
    dt_ = st.dual_tol
    skip_lo_free = (p < dt_) | (ls_star <= -d_ls_w + dt_)
    skip_lo_fix = (ls_star <= dt_) & (ls_star + dt_ >= -d_ls_w) \
        & (not state.sing)
    skip_up_free = (p > -dt_) | (ls_star >= d_us_w)
    skip_up_fix = (ls_star >= -dt_) & (ls_star <= dt_ + d_us_w) \
        & (not state.sing)
    eps_k = 64 * torch.finfo(state.lam.dtype).eps
    ktol_us = torch.clamp(eps_k * (1 + d_us_w.abs()), min=dt_)
    ktol_ls = torch.clamp(eps_k * (1 + d_ls_w.abs()), min=dt_)
    at_us = (state.lam - d_us_w).abs() <= ktol_us
    at_ls = (state.lam + d_ls_w).abs() <= ktol_ls
    is_soft_w = (swb & SOFT) > 0
    kink = is_soft_w & torch.where(is_lower, at_ls & (free | (p < 0)),
                                   at_us & (free | (p > 0)))
    skip = torch.where(is_lower, torch.where(free, skip_lo_free, skip_lo_fix),
                       torch.where(free, skip_up_free, skip_up_fix)) | kink
    zero = torch.zeros_like(p)
    lam_slack = state.lam + torch.where(
        is_lower, torch.where(free, d_ls_w, torch.where(p < 0, d_ls_w, zero)),
        -torch.where(free, d_us_w, torch.where(p > 0, d_us_w, zero)))
    elig = mask & ~immut & ~skip
    cand = torch.clamp(-lam_slack / p, min=0.0)
    cand = torch.where(torch.isfinite(cand), cand, 0.0)
    return torch.where(elig, cand, DAQP_INF), delta


def remove_blocking(state: LDPState, st: Settings
                    ) -> Tuple[bool, LDPState]:
    """Exact min-ratio line search over the dual-infeasible active rows;
    the blocker leaves (``daqp_remove_blocking``, auxiliary.c:276-311;
    its SOFT_WEIGHTS variant auxiliary.c:199-274, where the step
    overshoots the slack transition by 0.1% and a soft blocker whose dual
    has not crossed zero re-enters with the flipped slack state).
    Returns (found, state)."""
    cand, delta = _blocking(state, st)
    rm = torch.argmin(cand)
    idx = _at(state.WS, rm)
    found, rm_pos, rid, bits = host_read(_at(cand, rm) < DAQP_INF, rm, idx,
                                         _at(state.sense, idx))
    if not found:
        return False, state
    rm_pos, entry = int(rm_pos), (int(rid), int(bits))
    mask = _mask1(state)
    alpha = cand[rm_pos] if state.sw is None else cand[rm_pos] * 1.001
    lam_new = torch.where(mask, state.lam + alpha * delta, state.lam)
    s = remove_constraint(state._replace(lam=lam_new), rm_pos, st, entry)
    if state.sw is None:
        return True, s
    ls_rm = lam_new[rm_pos]
    was_lower = (entry[1] & LOWER) > 0
    was_soft = (entry[1] & SOFT) > 0
    was_fixed = (entry[1] & SLACK_FIXED) > 0
    if not was_soft or s.sing:
        return True, s
    crossed_out = host_read(ls_rm > 0 if was_lower else ls_rm < 0)
    if crossed_out:
        return True, s
    return True, add_constraint(s, entry[0], ls_rm, st, sw_free=was_fixed)


def compute_primal_and_fval(state: LDPState, st: Settings) -> LDPState:
    """u = -M_W' lam*, fval = ||u||^2 + the soft penalty
    (``daqp_compute_primal_and_fval``, auxiliary.c:46-87)."""
    mask = _mask1(state)
    ls = torch.where(mask, state.lam_star, 0.0)
    u = -(state.Mw.T @ ls)
    swb = state.sense[state.WS]
    soft = mask & ((swb & SOFT) > 0)
    if state.sw is not None:
        rho_w = _side(swb, state.sw.rho_ls[state.WS],
                      state.sw.rho_us[state.WS])
        soft_slack = torch.where(soft, rho_w * state.lam_star ** 2,
                                 0.0).sum()
    else:
        soft_slack = st.rho_soft * torch.where(
            soft, state.lam_star ** 2, 0.0).sum()
    return state._replace(u=u, fval=soft_slack + u @ u,
                          soft_slack=soft_slack)


def _price(state: LDPState, st: Settings):
    """The pricing sweep mu = M u on the device: (j, found, isupper) of
    the most violated row (Dantzig), or of the lowest violated index
    (Bland: ``pricing`` = 1, or after the second cycle repair)."""
    mu = state.M @ state.u
    bound = -st.primal_tol * state.scaling
    viol_up = state.dupper - mu
    viol_lo = mu - state.dlower
    blocked = (state.sense & (ACTIVE | IMMUTABLE)) > 0
    up_ok = (viol_up < bound) & ~blocked
    lo_ok = (viol_lo < bound) & ~blocked & ~up_ok
    viol_any = up_ok | lo_ok
    if int(st.pricing) == PRICING_BLAND or state.tried_repair >= 2:
        key = torch.where(viol_any, torch.arange(
            mu.shape[0], dtype=mu.dtype, device=mu.device), DAQP_INF)
    else:
        key = torch.where(up_ok, viol_up,
                          torch.where(lo_ok, viol_lo, DAQP_INF))
    j = torch.argmin(key)
    return j, _at(viol_any, j), _at(up_ok, j)


def _add_priced(state: LDPState, j: int, isupper: bool,
                st: Settings) -> LDPState:
    """Add priced row ``j`` at its violated side, the duals moved to lam*
    (``daqp_add_infeasible``, auxiliary.c:88-197)."""
    mask = _mask1(state)
    sj = state.sense[j]
    sj = sj & ~LOWER if isupper else sj | LOWER
    s = state._replace(sense=_put(state.sense, j, sj),
                       lam=torch.where(mask, state.lam_star, state.lam))
    return add_constraint(s, j, 1.0 if isupper else -1.0, st)


def add_infeasible(state: LDPState, st: Settings
                   ) -> Tuple[bool, LDPState]:
    """Price every row and add the chosen violated one; (added, state)."""
    j, found, isupper = _price(state, st)
    j, found, isupper = host_read(j, found, isupper)
    if not found:
        return False, state
    return True, _add_priced(state, int(j), bool(isupper), st)


def newton_refresh_E(state: LDPState, st: Settings) -> LDPState:
    """One Newton polish E <- E (2I - G E) against the working set's
    exactly rebuilt Gram G, kept only if ||G E - I||_max < 1/2, E_new is
    finite and no entry is singular (``daqp_tpu/ldp.py:511-547``)."""
    dtype = state.E.dtype
    mask = _mask1(state)
    mm = mask[:, None] & mask[None, :]
    Mw_m = torch.where(mask[:, None], state.Mw, 0.0)
    G = Mw_m @ Mw_m.T
    swb = state.sense[state.WS]
    soft = mask & ((swb & SOFT) > 0)
    if state.sw is not None:
        soft = soft & ((swb & SLACK_FIXED) == 0)
        rho_w = _side(swb, state.sw.rho_ls[state.WS],
                      state.sw.rho_us[state.WS])
        G = G + torch.diag(torch.where(soft, rho_w, 0.0))
    else:
        G = G + torch.diag(soft.to(dtype) * st.rho_soft)
    G = torch.where(mm, G, 0.0)
    G = G + torch.diag((~mask).to(dtype))
    Iu = torch.diag(mask.to(dtype))
    P = G @ state.E
    resid = (P - Iu).abs().max()
    E_new = torch.where(mm, state.E @ (2 * Iu - P), 0.0)
    ok = (resid < 0.5) & torch.isfinite(E_new).all() & (not state.sing)
    return state._replace(E=torch.where(ok, E_new, state.E))


def refine_active(state: LDPState, st: Settings) -> LDPState:
    """One step of iterative refinement of (lam*, u) through E
    (``daqp_refine_active``, auxiliary.c:497-588)."""
    mask = _mask1(state)
    ws = state.WS
    swb = state.sense[ws]
    d = _side(swb, state.dlower[ws], state.dupper[ws])
    r = state.Mw @ state.u - d
    soft = (swb & SOFT) > 0
    if state.sw is not None:
        # free soft slacks: the weight and the slack bound's term
        # (auxiliary.c:522-533)
        free_soft = soft & ((swb & SLACK_FIXED) == 0)
        rho_w = _side(swb, state.sw.rho_ls[ws], state.sw.rho_us[ws])
        d_slack = _side(swb, state.sw.d_ls[ws], -state.sw.d_us[ws])
        r = r - torch.where(free_soft, rho_w * (state.lam_star + d_slack),
                            0.0)
    else:
        r = r - torch.where(soft, st.rho_soft * state.lam_star, 0.0)
    r = torch.where(mask, r, 0.0)
    dlam = torch.where(mask, state.E @ r, 0.0)
    u = state.u - state.Mw.T @ dlam
    return state._replace(lam_star=state.lam_star + dlam, u=u,
                          fval=state.soft_slack + u @ u)


# ---------------------------------------------------------------------------
# main loop
# ---------------------------------------------------------------------------
def _max_diag_E(state: LDPState) -> torch.Tensor:
    return torch.where(_mask1(state), torch.diagonal(state.E), 0.0).max()


def _optimal_flag(soft_hi: float) -> int:
    return EXIT_SOFT_OPTIMAL if soft_hi else EXIT_OPTIMAL


def _dual_bad(state: LDPState, st: Settings) -> torch.Tensor:
    """A refined lam* that is dual-infeasible on a mutable row (not a
    SOFT_WEIGHTS soft row): the working set is wrong."""
    mask = _mask1(state)
    swb = state.sense[state.WS]
    bad = mask & ((swb & IMMUTABLE) == 0) & torch.where(
        (swb & LOWER) > 0, state.lam_star > st.dual_tol,
        state.lam_star < -st.dual_tol)
    if state.sw is not None:
        bad = bad & ((swb & SOFT) == 0)
    return bad.any()


def _optimal_path(state: LDPState, st: Settings, rep_big: bool,
                  ref_big: bool, soft_hi: bool,
                  batch_mode: bool = False) -> LDPState:
    """No violated row remains: repair, refine, or declare optimal
    (``src/daqp.c:28-63``).  ``rep_big`` / ``ref_big``: max diag(E)
    times refactor_tol / pivot_tol exceeds 1; ``soft_hi``: the soft
    slack exceeds primal_tol (read with the pricing).  ``batch_mode``
    declares optimal at once: ``batch_post_pass`` repairs and refines."""
    if batch_mode:
        return state._replace(status=_optimal_flag(soft_hi))
    k = state.n_active
    if k > 2 and state.tried_repair == 0 and rep_big:
        # LOWER / UPPER from the sign of lam (daqp.c:37-42), refactor
        swb = state.sense[state.WS]
        sw_new = torch.where(state.lam >= 0, swb & ~LOWER, swb | LOWER)
        sense = state.sense.clone()
        sense[state.WS[:k]] = sw_new[:k].to(torch.int32)
        s = refactor(state._replace(sense=sense), st)
        return s._replace(tried_repair=max(s.tried_repair, 1))
    # every optimal candidate is refreshed and refined in f32, where E's
    # drift misprices weakly active rows (daqp_tpu/ldp.py:629-637); in
    # f64 only under the reference's ill-conditioning gate (daqp.c:52)
    always = state.E.dtype == torch.float32
    if not (k > 0 and (always or ref_big)):
        return state._replace(status=_optimal_flag(soft_hi))
    s = newton_refresh_E(state, st)
    s = compute_csp(s)
    s = compute_primal_and_fval(s, st)
    s = refine_active(s, st)
    j, found, isupper = _price(s, st)
    j, found, isupper, bad, soft_hi = host_read(
        j, found, isupper, _dual_bad(s, st), s.soft_slack > st.primal_tol)
    if found:
        return _add_priced(s, int(j), bool(isupper), st)
    if bad:
        # stay RUNNING: the next blocking search removes the offender
        return s
    return s._replace(status=_optimal_flag(soft_hi))


def _cycle_guard(state: LDPState, st: Settings, no_progress: bool,
                 batch_mode: bool = False) -> LDPState:
    """Progress tracking with the one-shot refactorization repair
    (``src/daqp.c:66-85``); ``no_progress`` was read with the pricing.
    In ``batch_mode`` a tripped guard exits CYCLE and ``batch_post_pass``
    repairs."""
    cc = state.cycle_counter + 1 if no_progress else 0
    trip = no_progress and cc > st.cycle_tol
    if trip and (batch_mode or state.tried_repair >= 2 or state.in_bnb):
        return state._replace(status=EXIT_CYCLE)
    if trip:
        s = refactor(state, st)
        return s._replace(tried_repair=s.tried_repair + 1, cycle_counter=0,
                          best_fval=torch.full_like(s.fval, -1.0))
    return state._replace(cycle_counter=cc, best_fval=state.best_fval
                          if no_progress else state.fval)


def _nonsingular_step(state: LDPState, st: Settings,
                      batch_mode: bool = False) -> LDPState:
    state = compute_csp(state)
    removed, state = remove_blocking(state, st)
    if removed:
        return state
    s = compute_primal_and_fval(state, st)
    # one read decides the rest of the step: the dual objective cut,
    # the pricing, the progress test and the optimal path's gates
    j, found, isupper = _price(s, st)
    max_diag = _max_diag_E(s)
    infeas, j, found, isupper, no_prog, rep_big, ref_big, soft_hi = \
        host_read(s.fval > 2.0 * st.fval_bound, j, found, isupper,
                  s.fval - s.best_fval
                  < st.progress_tol * (1.0 + s.fval.abs()),
                  max_diag * st.refactor_tol > 1.0,
                  max_diag * st.pivot_tol > 1.0,
                  s.soft_slack > st.primal_tol)
    if infeas:
        return s._replace(status=EXIT_INFEASIBLE)
    if found:
        s = _add_priced(s, int(j), bool(isupper), st)
        return _cycle_guard(s, st, bool(no_prog), batch_mode)
    return _optimal_path(s, st, bool(rep_big), bool(ref_big), bool(soft_hi),
                         batch_mode)


def _singular_step(state: LDPState, st: Settings) -> LDPState:
    removed, state = remove_blocking(state, st)
    if removed:
        return state
    # a singular direction with no blocker is infeasible (daqp.c:88-94);
    # in f32 a spuriously singular add can land here on a feasible
    # problem, so the first time the parked entry is dropped and E
    # refactored (daqp_tpu/ldp.py:726-746)
    if state.tried_repair >= 1:
        return state._replace(status=EXIT_INFEASIBLE)
    q = remove_constraint(state, state.n_active - 1, st)
    q = refactor(q, st)
    return q._replace(tried_repair=max(q.tried_repair, 1), cycle_counter=0,
                      best_fval=torch.full_like(q.fval, -1.0))


def ldp_solve(state: LDPState, st: Settings, reset: bool = True,
              deadline: float = None, batch_mode: bool = False) -> LDPState:
    """The active-set loop to termination (``daqp_ldp``, daqp.c:6-108).
    ``reset=False`` resumes with the iteration count and status as they
    are (warm restarts and the batched rounds).  ``deadline`` (absolute
    ``time.perf_counter()`` seconds): the reference's wall-clock check
    every 32 iterations (daqp.c:95-103); a lane still running past it
    exits TIMELIMIT.  ``batch_mode`` leaves the repair and refinement to
    ``batch_post_pass``."""
    iter_limit = int(st.iter_limit)
    if reset:
        state = state._replace(status=EXIT_RUNNING, iterations=0)
    while state.status == EXIT_RUNNING and state.iterations < iter_limit:
        if state.sing:
            state = _singular_step(state, st)
        else:
            state = _nonsingular_step(state, st, batch_mode)
        if state.iterations % 32 == 31 and state.status == EXIT_RUNNING \
                and late(deadline):
            state = state._replace(status=EXIT_TIMELIMIT)
        state = state._replace(iterations=state.iterations + 1)
    if state.status == EXIT_RUNNING and state.iterations >= iter_limit:
        state = state._replace(status=EXIT_ITERLIMIT)
    return state


def batch_post_pass(state: LDPState, st: Settings) -> LDPState:
    """One repair round of the batched ordered tier, the numerics the
    single-instance loop applies inline (``src/daqp.c:28-85``): an optimal
    lane with active rows gets E refreshed, one refinement step and a
    re-price, re-opened if a row is still violated; a CYCLE lane not yet
    repaired twice (and not in branch and bound) is refactored and
    re-opened.  Followed by ``ldp_solve(..., reset=False)``."""
    if state.status in (EXIT_OPTIMAL, EXIT_SOFT_OPTIMAL) \
            and state.n_active > 0:
        # E refreshed before refining (see _optimal_path)
        s = newton_refresh_E(state, st)
        s = compute_csp(s)
        s = compute_primal_and_fval(s, st)
        s = refine_active(s, st)
        added, state = add_infeasible(s, st)
        if added:
            state = state._replace(status=EXIT_RUNNING)
    if state.status == EXIT_CYCLE and state.tried_repair < 2 \
            and not state.in_bnb:
        state = refactor(state, st)
        state = state._replace(status=EXIT_RUNNING,
                               tried_repair=state.tried_repair + 1,
                               cycle_counter=0,
                               best_fval=torch.full_like(state.fval, -1.0))
    return state


def ldp_solve_batched_lane(state: LDPState, st: Settings,
                           rounds: int = 2) -> LDPState:
    """One lane of the batched ordered tier: the loop in ``batch_mode``,
    then ``rounds`` times ``batch_post_pass`` and the loop again."""
    state = ldp_solve(state, st, reset=False, batch_mode=True)
    for _ in range(rounds):
        state = batch_post_pass(state, st)
        state = ldp_solve(state, st, reset=False, batch_mode=True)
    return state


def activate_constraints(state: LDPState, st: Settings, m_limit=None,
                         m_start: int = 0) -> Tuple[int, LDPState]:
    """Activate every sense-ACTIVE row in [m_start, m_limit) in order (the
    warm / equality start, ``daqp_activate_constraints``,
    auxiliary.c:398-478).  A row whose add is singular is dropped: a
    dependent equality whose right-hand side is consistent with the rows
    before it is ignored, an inconsistent one gives the flag
    EXIT_OVERDETERMINED_INITIAL, and the rows after it are not tried.
    Returns (flag, state), flag 1 or that exit."""
    m = state.M.shape[0]
    m_limit = m if m_limit is None else m_limit
    bits0 = host_numpy(state.sense)[0].tolist()
    flag = 1
    for i in range(m_start, m_limit):
        if not (bits0[i] & ACTIVE) or flag < 0:
            continue
        is_lower = (bits0[i] & LOWER) > 0
        if state.sw is not None:
            # a start dual that agrees with the preset slack state
            # (auxiliary.c:403-416): FREE past the bound, FIXED inside
            free0 = (bits0[i] & SLACK_FIXED) == 0
            if is_lower:
                lam0 = -(state.sw.d_ls[i] + 1.0) if free0 \
                    else -0.9 * state.sw.d_ls[i]
            else:
                lam0 = state.sw.d_us[i] + 1.0 if free0 \
                    else 0.9 * state.sw.d_us[i]
        else:
            lam0 = -1.0 if is_lower else 1.0
        state = add_constraint(state, i, lam0, st)
        if not state.sing:
            continue
        # the consistency residual of the dependent set
        last_pos = state.n_active - 1
        mask = _mask1(state)
        swb = state.sense[state.WS]
        bnd = _side(swb, state.dlower[state.WS], state.dupper[state.WS])
        terms = torch.where(mask, state.sing_dir * bnd, 0.0)
        consistent = host_read(terms.sum().abs() <= st.primal_tol
                               * (1.0 + terms.abs().sum()))
        state = state._replace(
            sense=_put(state.sense, i, state.sense[i] & ~ACTIVE),
            n_active=last_pos,
            ns_active=state.ns_active - int((bits0[i] & SOFT) > 0),
            sing=False)
        if (bits0[i] & IMMUTABLE) and not consistent:
            flag = EXIT_OVERDETERMINED_INITIAL
    return flag, state
