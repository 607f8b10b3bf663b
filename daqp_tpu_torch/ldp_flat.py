"""The flat tier: the slot-table dual active-set LDP solver, batched.

Counterpart of ``daqp_tpu/ldp_flat.py``: ``:72 FlatState``, ``:113
flat_init``, ``:145 _try_add``, ``:230 flat_step``, ``:583 flat_gram``,
``:605 flat_refresh``, ``:671 flat_polish``, ``:748 flat_activate``,
``:797 flat_solve`` and ``:844 flat_extract_duals``; ``EXIT_REFACTOR``
is the port's ``types.EXIT_REFACTOR``.

Same mathematics as ``ldp.py`` (reference ``src/daqp.c``), laid out for
lockstep batches: the active rows live in K fixed slots with a ``used``
mask (no ordered working set), the explicit inverse Gram E is kept on the
slot grid (a deletion zeroes the freed slot's row and column, a bordered
addition fills any free slot), and a singular addition waits out of the
table as the ``pend_*`` entry, its null direction recomputed from E each
step.  Every tensor is batch-leading ((B, m, n), (B, K, K), (B, K), (B,))
in the caller's dtype, f32 or f64, and every update is masked per lane,
so a lane's result depends on that lane alone.  The JAX module vmaps one
lane; here the batch is explicit.

``flat_solve``'s two nested ``lax.while_loop`` become a host loop: each
round runs ``INNER_STEPS`` masked steps without reading anything back
(a stopped lane is left as it is by the masks), then the refresh and the
polish, then one read of whether any lane still runs under its limits.
Left behind as TPU workarounds: the ``Precision.HIGHEST`` plumbing (TF32
is off package-wide), the f32 one-hot mask algebra (masked ``where``
here) and the 128-lane padding.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .ops import host_any, host_numpy
from .types import (ACTIVE, IMMUTABLE, LOWER, SOFT, SLACK_FIXED, DAQP_INF,
                    EXIT_CYCLE, EXIT_INFEASIBLE, EXIT_ITERLIMIT,
                    EXIT_OPTIMAL, EXIT_OVERDETERMINED_INITIAL, EXIT_REFACTOR,
                    EXIT_RUNNING, EXIT_SOFT_OPTIMAL, PRICING_BLAND, Settings,
                    SoftWeights)

INNER_STEPS = 32    # masked steps a round, between refresh and polish
MAX_ROUNDS = 64     # repair / polish rounds a lane (ldp_flat.py:805-808)
REFINE_STEPS = 2    # chained refinement steps of the polish
rounds = 0          # rounds run by flat_solve; the caller resets it


class FlatState(NamedTuple):
    """The slot-table workspace of a batch of B lanes."""
    # problem data
    M: torch.Tensor           # (B, m, n) unit-normalized rows
    dupper: torch.Tensor      # (B, m)
    dlower: torch.Tensor      # (B, m)
    scaling: torch.Tensor     # (B, m)
    sense: torch.Tensor       # (B, m) int32
    # slot table
    used: torch.Tensor        # (B, K) bool
    sid: torch.Tensor         # (B, K) int64 row id per slot
    lam: torch.Tensor         # (B, K) dual iterate per slot
    Mw: torch.Tensor          # (B, K, n) the slots' rows
    E: torch.Tensor           # (B, K, K) inverse Gram on used slots
    lam_star: torch.Tensor    # (B, K) last CSP solution
    # the pending singular addition
    pend: torch.Tensor        # (B,) bool
    pend_id: torch.Tensor     # (B,) int64
    pend_lam: torch.Tensor    # (B,)
    pend_row: torch.Tensor    # (B, n)
    pend_lower: torch.Tensor  # (B,) bool
    # iterates
    u: torch.Tensor           # (B, n)
    fval: torch.Tensor        # (B,)
    soft_slack: torch.Tensor  # (B,)
    # control
    iterations: torch.Tensor  # (B,) int32
    cycle: torch.Tensor       # (B,) int32
    best_fval: torch.Tensor   # (B,)
    repaired: torch.Tensor    # (B,) int32: 0 none, 1 repaired, >= 2 Bland
    status: torch.Tensor      # (B,) int32
    # SOFT_WEIGHTS slack data, scaling-normalized ((B, m) each); None for
    # plain soft rows of uniform rho_soft
    sw: Optional[SoftWeights] = None


def _ar(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[0], device=x.device)


def _row(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for every lane b."""
    return x[_ar(x), idx]


def _put(x: torch.Tensor, idx: torch.Tensor, val, mask) -> torch.Tensor:
    """x with x[b, idx[b]] = val[b] on the lanes of ``mask`` (the JAX
    module's ``.at[where(mask, idx, m)].set(val, mode='drop')``)."""
    hit = (torch.arange(x.shape[1], device=x.device) == idx[:, None]) \
        & mask[:, None]
    val = torch.as_tensor(val, dtype=x.dtype, device=x.device)
    if x.dim() == 3:
        return torch.where(hit[:, :, None], val[:, None, :]
                           if val.dim() == 2 else val, x)
    return torch.where(hit, val[:, None] if val.dim() == 1 else val, x)


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched A x: (B, r, c) x (B, c) -> (B, r)."""
    return torch.matmul(A, x[..., None])[..., 0]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _side(bits, lower, upper):
    return torch.where((bits & LOWER) > 0, lower, upper)


def _slot_sense(s: FlatState) -> torch.Tensor:
    return torch.gather(s.sense, 1, s.sid)


def _at_slot(x: torch.Tensor, s: FlatState) -> torch.Tensor:
    """(B, m) row data read at each slot's row: (B, K)."""
    return torch.gather(x, 1, s.sid)


def flat_init(M, dupper, dlower, sense=None, scaling=None, K=None,
              sw: SoftWeights = None) -> FlatState:
    """A fresh workspace of capacity K = n + ns + 1 (reference
    api.c:288-305; default n + 1) on M's device, in M's type."""
    M = torch.as_tensor(M)
    B, m, n = M.shape
    dtype, dev = M.dtype, M.device
    K = n + 1 if K is None else K

    def z(*shape, t=dtype):
        return torch.zeros(shape, dtype=t, device=dev)

    i32 = torch.int32
    return FlatState(
        M=M, dupper=dupper.to(dtype), dlower=dlower.to(dtype),
        scaling=torch.ones((B, m), dtype=dtype, device=dev)
        if scaling is None else scaling.to(dtype),
        sense=z(B, m, t=i32) if sense is None else sense.to(i32),
        used=z(B, K, t=torch.bool), sid=z(B, K, t=torch.int64),
        lam=z(B, K), Mw=z(B, K, n), E=z(B, K, K), lam_star=z(B, K),
        pend=z(B, t=torch.bool), pend_id=z(B, t=torch.int64),
        pend_lam=z(B), pend_row=z(B, n), pend_lower=z(B, t=torch.bool),
        u=z(B, n), fval=z(B), soft_slack=z(B), iterations=z(B, t=i32),
        cycle=z(B, t=i32), best_fval=z(B) - 1.0, repaired=z(B, t=i32),
        status=torch.full((B,), EXIT_RUNNING, dtype=i32, device=dev), sw=sw)


def _try_add(s: FlatState, st: Settings, do_add, add_id, add_lam, add_row,
             add_lower, sw_free=None) -> FlatState:
    """Masked bordered addition of row ``add_id`` into the first free slot
    of each lane of ``do_add`` (``daqp_update_LDL_add``,
    factorization.c:7-98: the Schur complement ``sval`` is the new
    pivot).  A singular addition, or one into a full table or past n +
    ns_act active rows, becomes the lane's pending entry.

    ``sw_free`` (SOFT_WEIGHTS only): ``(override, value)`` bool tensors;
    where ``override`` the slack FREE / FIXED state is ``value`` instead
    of derived from the dual (the blocking re-add passes the flipped
    previous state)."""
    K, n = s.used.shape[1], s.M.shape[2]
    dtype = s.E.dtype
    sense_a = _row(s.sense, add_id)
    is_soft = (sense_a & SOFT) > 0
    if s.sw is not None:
        # the slack state machine (auxiliary.c:30-36): a slack at its
        # bound is FIXED (the row acts hard); past it FREE, with its
        # side's rho on the Gram diagonal (factorization.c:31-40)
        slack_free = torch.where(add_lower,
                                 add_lam <= -_row(s.sw.d_ls, add_id),
                                 add_lam >= _row(s.sw.d_us, add_id))
        if sw_free is not None:
            slack_free = torch.where(sw_free[0], sw_free[1], slack_free)
        rho_side = torch.where(add_lower, _row(s.sw.rho_ls, add_id),
                               _row(s.sw.rho_us, add_id))
        contributes = is_soft & slack_free
        dii = _dot(add_row, add_row) + torch.where(contributes, rho_side,
                                                   0.0)
        fix_bits = torch.where(slack_free, sense_a & ~SLACK_FIXED,
                               sense_a | SLACK_FIXED)
    else:
        contributes = is_soft
        dii = _dot(add_row, add_row) + is_soft.to(dtype) * st.rho_soft
        fix_bits = sense_a
    g = torch.where(s.used, _mv(s.Mw, add_row), 0.0)
    a = _mv(s.E, g)
    sval = dii - _dot(g, a)
    k = s.used.sum(1)
    bits = _slot_sense(s)
    softmask = s.used & ((bits & SOFT) > 0)
    if s.sw is not None:
        softmask = softmask & ((bits & SLACK_FIXED) == 0)
    ns_act = softmask.sum(1) + contributes.to(k.dtype)
    # a full table, or more rows than the rank n + ns_act allows, is a
    # singular add (pending, then the repair ladder), never an overwrite
    singular = (sval < st.sing_tol) | (k >= n + ns_act) | (k >= K)
    slot = torch.argmin(s.used.to(torch.int8), dim=1)   # first free slot
    oh = torch.arange(K, device=s.E.device) == slot[:, None]
    w = torch.where(oh, -1.0, torch.where(s.used, a, 0.0))
    ok = do_add & ~singular
    make_pend = do_add & singular
    sense_bits = torch.where(add_lower, fix_bits | LOWER,
                             fix_bits & ~LOWER) | ACTIVE
    sval_safe = torch.where(sval != 0, sval, 1.0)
    E_add = s.E + (1.0 / sval_safe)[:, None, None] * (w[:, :, None]
                                                     * w[:, None, :])
    return s._replace(
        E=torch.where(ok[:, None, None], E_add, s.E),
        used=s.used | (oh & ok[:, None]),
        sid=_put(s.sid, slot, add_id, ok),
        lam=_put(s.lam, slot, add_lam, ok),
        Mw=_put(s.Mw, slot, add_row, ok),
        sense=_put(s.sense, add_id, sense_bits, do_add),
        pend=torch.where(do_add, make_pend, s.pend),
        pend_id=torch.where(make_pend, add_id, s.pend_id),
        pend_lam=torch.where(make_pend, add_lam, s.pend_lam),
        pend_row=torch.where(make_pend[:, None], add_row, s.pend_row),
        pend_lower=torch.where(make_pend, add_lower, s.pend_lower))


def _sw_candidates(s: FlatState, st: Settings, bits, is_lower, delta, signv,
                   pend_sign, BIG):
    """The SOFT_WEIGHTS min-ratio candidates (auxiliary.c:199-274): the
    line search runs on the slack dual lam + d per side, a soft row whose
    dual sits at its slack transition in the crossing direction is left
    out (the kink guard), and the pending entry is searched as a virtual
    K-th candidate at its own slack transition.  Returns (cand (B, K + 1),
    p_was_fixed, pid)."""
    m = s.M.shape[1]
    dt_ = st.dual_tol
    immut = (bits & IMMUTABLE) > 0
    d_ls_w, d_us_w = _at_slot(s.sw.d_ls, s), _at_slot(s.sw.d_us, s)
    free_w = (bits & SLACK_FIXED) == 0
    p, ls_star = delta, signv
    npend = ~s.pend[:, None]
    skip_lo_free = (p < dt_) | (ls_star <= -d_ls_w + dt_)
    skip_lo_fix = (ls_star <= dt_) & (ls_star + dt_ >= -d_ls_w) & npend
    skip_up_free = (p > -dt_) | (ls_star >= d_us_w)
    skip_up_fix = (ls_star >= -dt_) & (ls_star <= dt_ + d_us_w) & npend
    eps_k = 64 * torch.finfo(s.lam.dtype).eps
    ktol_us = torch.clamp(eps_k * (1 + d_us_w.abs()), min=dt_)
    ktol_ls = torch.clamp(eps_k * (1 + d_ls_w.abs()), min=dt_)
    at_us = (s.lam - d_us_w).abs() <= ktol_us
    at_ls = (s.lam + d_ls_w).abs() <= ktol_ls
    is_soft_w = (bits & SOFT) > 0
    kink = is_soft_w & torch.where(is_lower, at_ls & (free_w | (p < 0)),
                                   at_us & (free_w | (p > 0)))
    skip = torch.where(is_lower,
                       torch.where(free_w, skip_lo_free, skip_lo_fix),
                       torch.where(free_w, skip_up_free, skip_up_fix)) | kink
    zero = torch.zeros_like(p)
    lam_slack = s.lam + torch.where(
        is_lower, torch.where(free_w, d_ls_w, torch.where(p < 0, d_ls_w,
                                                          zero)),
        -torch.where(free_w, d_us_w, torch.where(p > 0, d_us_w, zero)))
    elig = s.used & ~immut & ~skip
    ratio = torch.clamp(-lam_slack / p, min=0.0)
    ratio = torch.where(torch.isfinite(ratio), ratio, 0.0)
    cand = torch.where(elig, ratio, BIG)
    # the pending entry at its own slack transition (ldp_flat.py:320-361)
    pid = torch.clamp(s.pend_id, 0, m - 1)
    psw = _row(s.sense, pid)
    p_free = (psw & SLACK_FIXED) == 0
    p_dls, p_dus = _row(s.sw.d_ls, pid), _row(s.sw.d_us, pid)
    pp = pend_sign
    pskip = torch.where(
        s.pend_lower, p_free & ((pp < dt_) | (pp <= -p_dls + dt_)),
        p_free & ((pp > -dt_) | (pp >= p_dus)))
    pktol_us = torch.clamp(eps_k * (1 + p_dus.abs()), min=dt_)
    pktol_ls = torch.clamp(eps_k * (1 + p_dls.abs()), min=dt_)
    p_at_us = (s.pend_lam - p_dus).abs() <= pktol_us
    p_at_ls = (s.pend_lam + p_dls).abs() <= pktol_ls
    p_soft = (psw & SOFT) > 0
    pkink = p_soft & torch.where(s.pend_lower, p_at_ls & (p_free | (pp < 0)),
                                 p_at_us & (p_free | (pp > 0)))
    pz = torch.zeros_like(pp)
    p_lam_slack = s.pend_lam + torch.where(
        s.pend_lower, torch.where(p_free, p_dls, torch.where(pp < 0, p_dls,
                                                             pz)),
        -torch.where(p_free, p_dus, torch.where(pp > 0, p_dus, pz)))
    p_immut = (psw & IMMUTABLE) > 0
    p_elig = s.pend & ~p_immut & ~(pskip | pkink)
    p_cand = torch.clamp(-p_lam_slack / pp, min=0.0)
    p_cand = torch.where(torch.isfinite(p_cand), p_cand, 0.0)
    pend_cand = torch.where(p_elig, p_cand, BIG)
    return torch.cat([cand, pend_cand[:, None]], 1), ~p_free, pid


def flat_step(s: FlatState, st: Settings) -> FlatState:
    """One branch-free iteration of the dual active-set loop on every lane
    that is RUNNING below ``st.iter_limit`` (``daqp_ldp`` body,
    daqp.c:12-104): CSP, blocking min-ratio search, a masked deletion,
    then a masked addition of the pending entry or the pricing winner.
    Other lanes are left as they are."""
    K, m = s.used.shape[1], s.M.shape[1]
    dtype, dev = s.E.dtype, s.E.device
    BIG = DAQP_INF
    ar = _ar(s.E)
    running = (s.status == EXIT_RUNNING) & (s.iterations < st.iter_limit)

    used = s.used
    bits = _slot_sense(s)
    is_lower = (bits & LOWER) > 0
    immut = (bits & IMMUTABLE) > 0

    # CSP: lam* = -E d_W (daqp_compute_CSP, auxiliary.c:313-353)
    d_W = _side(bits, _at_slot(s.dlower, s), _at_slot(s.dupper, s))
    if s.sw is not None:
        # free soft slacks shift the right-hand side by their bound's share
        free_soft_w = ((bits & SOFT) > 0) & ((bits & SLACK_FIXED) == 0)
        corr = torch.where(is_lower,
                           _at_slot(s.sw.rho_ls, s) * _at_slot(s.sw.d_ls, s),
                           -_at_slot(s.sw.rho_us, s) * _at_slot(s.sw.d_us, s))
        d_W = d_W + torch.where(free_soft_w, corr, 0.0)
    d_W = torch.where(used, d_W, 0.0)
    lam_star = -_mv(s.E, d_W)

    # the pending entry's null direction (auxiliary.c:356-375)
    gp = torch.where(used, _mv(s.Mw, s.pend_row), 0.0)
    ap = _mv(s.E, gp)
    pend_sign = torch.where(s.pend_lower, -1.0, 1.0).to(dtype)
    sdir = -ap * pend_sign[:, None]

    # blocking min-ratio line search (auxiliary.c:276-311)
    pend2 = s.pend[:, None]
    delta = torch.where(pend2, sdir, lam_star - s.lam)
    signv = torch.where(pend2, sdir, lam_star)
    if s.sw is None:
        infeas = torch.where(is_lower, signv > st.dual_tol,
                             signv < -st.dual_tol)
        elig = used & ~immut & infeas
        ratio = -s.lam / delta
        # every eligible slot takes part; nonfinite or negative ratios
        # clamp to a zero step (auxiliary.c:283-287's exit gate)
        ratio = torch.where(torch.isfinite(ratio),
                            torch.clamp(ratio, min=0.0), 0.0)
        cand = torch.where(elig, ratio, BIG)
    else:
        cand, p_was_fixed, pid = _sw_candidates(s, st, bits, is_lower, delta,
                                                signv, pend_sign, BIG)
    # without sw, cand has K entries and rmx == K cannot happen
    rmx = torch.argmin(cand, dim=1)
    cmin = _row(cand, rmx)
    pend_block = running & (rmx == K) & (cmin < BIG)
    rm_slot = torch.where(rmx == K, 0, rmx)
    do_remove = running & ~pend_block & (cmin < BIG)

    # deletion-pivot guard: a small pivot e_rr amplifies E's drift by
    # ||e||^2 / e_rr, so the lane parks until the refresh rebuilds E
    e = s.E[ar, :, rm_slot]
    err = _row(e, rm_slot)
    bad_pivot = do_remove & (err < st.pivot_tol * e.abs().amax(1))
    do_remove = do_remove & ~bad_pivot

    # masked deletion (daqp_update_LDL_remove, factorization.c:99-138:
    # E -= e e' / e_rr zeroes the freed row and column)
    alpha = torch.where(do_remove | pend_block, cmin, 0.0)
    if s.sw is not None:
        # just past the slack transition, so that the blocker re-enters
        # with the flipped FIXED / FREE state (auxiliary.c:254)
        alpha = alpha * 1.001
    moved = (do_remove | pend_block)[:, None] & used
    lam1 = torch.where(moved, s.lam + alpha[:, None] * delta, s.lam)
    pend_lam1 = s.pend_lam + torch.where(s.pend & (do_remove | pend_block),
                                         alpha * pend_sign, 0.0)
    ls_rm = _row(lam1, rm_slot)
    rm_bits = _row(bits, rm_slot)
    rm_was_soft = (rm_bits & SOFT) > 0
    rm_was_lower = (rm_bits & LOWER) > 0
    rm_was_fixed = (rm_bits & SLACK_FIXED) > 0
    err_safe = torch.where(err != 0, err, 1.0)
    keep = torch.arange(K, device=dev) != rm_slot[:, None]
    E_rm = torch.where(keep[:, :, None] & keep[:, None, :],
                       s.E - e[:, :, None] * e[:, None, :]
                       / err_safe[:, None, None], 0.0)
    E1 = torch.where(do_remove[:, None, None], E_rm, s.E)
    used1 = used & ~(~keep & do_remove[:, None])
    lam1 = _put(lam1, rm_slot, torch.zeros_like(ls_rm), do_remove)
    rm_id = _row(s.sid, rm_slot)
    sense1 = _put(s.sense, rm_id, _row(s.sense, rm_id) & ~ACTIVE, do_remove)
    status = torch.where(bad_pivot, EXIT_REFACTOR, s.status).to(torch.int32)
    s = s._replace(E=E1, used=used1, lam=lam1, pend_lam=pend_lam1,
                   sense=sense1, status=status)
    running = running & ~bad_pivot

    # a pending entry with no blocker is infeasible (daqp.c:88-94); in f32
    # a spuriously singular add can land here, so the first time the lane
    # asks for the exact repair (CYCLE -> flat_refresh) and only a
    # repaired lane declares infeasibility
    stuck = running & s.pend & ~do_remove & ~pend_block
    status = torch.where(stuck, torch.where(s.repaired >= 1, EXIT_INFEASIBLE,
                                            EXIT_CYCLE), status)

    # primal and pricing on the path without removal or pending entry
    price_path = running & ~do_remove & ~s.pend
    bits = _slot_sense(s)
    lamm = torch.where(s.used, lam_star, 0.0)
    u = -_mv(s.Mw.transpose(1, 2), lamm)
    softm = s.used & ((bits & SOFT) > 0)
    if s.sw is not None:
        rho_w = _side(bits, _at_slot(s.sw.rho_ls, s), _at_slot(s.sw.rho_us, s))
        soft_slack = torch.where(softm, rho_w * lam_star ** 2, 0.0).sum(1)
    else:
        soft_slack = st.rho_soft * torch.where(softm, lam_star ** 2,
                                               0.0).sum(1)
    fval = soft_slack + _dot(u, u)
    # the dual objective bound cut (daqp.c:20-23)
    status = torch.where(price_path & (fval > 2.0 * st.fval_bound),
                         EXIT_INFEASIBLE, status)

    mu = _mv(s.M, u)
    bound = -st.primal_tol * s.scaling
    viol_up = s.dupper - mu
    viol_lo = mu - s.dlower
    blocked = (s.sense & (ACTIVE | IMMUTABLE)) > 0
    up_ok = (viol_up < bound) & ~blocked
    lo_ok = (viol_lo < bound) & ~blocked & ~up_ok
    candv = torch.where(up_ok, viol_up, torch.where(lo_ok, viol_lo, BIG))
    # Dantzig (most violated) or Bland (lowest violated index) pricing;
    # a lane repaired twice keeps Bland's rule (anti-cycling escalation)
    viol_any = up_ok | lo_ok
    bland_key = torch.where(viol_any, torch.arange(m, dtype=dtype,
                                                   device=dev), BIG)
    use_bland = (int(st.pricing) == PRICING_BLAND) | (s.repaired >= 2)
    j = torch.argmin(torch.where(use_bland[:, None], bland_key, candv), 1)
    found_viol = _row(viol_any, j)
    lo_j = _row(lo_ok, j)

    opt_flag = torch.where(soft_slack > st.primal_tol, EXIT_SOFT_OPTIMAL,
                           EXIT_OPTIMAL)
    status = torch.where(price_path & ~found_viol & (status == EXIT_RUNNING),
                         opt_flag, status)
    # the cycle guard (daqp.c:66-85; the repair is the refresh's)
    no_prog = fval - s.best_fval < st.progress_tol * (1.0 + fval.abs())
    cyc = torch.where(price_path, torch.where(no_prog, s.cycle + 1, 0),
                      s.cycle).to(torch.int32)
    best = torch.where(price_path & ~no_prog, fval, s.best_fval)
    status = torch.where(price_path & no_prog & (cyc > st.cycle_tol)
                         & (status == EXIT_RUNNING), EXIT_CYCLE, status)
    pp = price_path[:, None]
    s = s._replace(u=torch.where(pp, u, s.u),
                   fval=torch.where(price_path, fval, s.fval),
                   soft_slack=torch.where(price_path, soft_slack,
                                          s.soft_slack),
                   lam_star=torch.where(running[:, None], lam_star,
                                        s.lam_star),
                   cycle=cyc, best_fval=best)

    # one masked addition: the pending entry again after a removal, the
    # pricing winner (daqp_add_infeasible, auxiliary.c:88-166), or, with
    # SOFT_WEIGHTS, the removed soft blocker whose slack dual has not
    # crossed zero, with the flipped FIXED / FREE state
    # (auxiliary.c:264-273)
    retry_pend = s.pend & do_remove
    price_add = price_path & found_viol & (status == EXIT_RUNNING)
    M_j = _row(s.M, j)
    one = torch.ones_like(s.pend_lam)
    sw_free = None
    if s.sw is not None:
        crossed = torch.where(rm_was_lower, ls_rm > 0, ls_rm < 0)
        sw_readd = do_remove & ~s.pend & rm_was_soft & ~crossed
        rm_id_c = torch.clamp(rm_id, 0, m - 1)
        M_rm = _row(s.M, rm_id_c)
        # the pending entry blocked at its own slack transition re-enters
        # with the flipped state; one whose dual crossed zero is dropped
        pend_crossed = torch.where(s.pend_lower, s.pend_lam > 0,
                                   s.pend_lam < 0)
        pend_readd = pend_block & ~pend_crossed
        pend_drop = pend_block & pend_crossed
        pend_take = retry_pend | pend_readd
        # the reference's double add (ldp_flat.py:518-530): a pending
        # retry that coincides with a FIXED soft blocker's re-add performs
        # the FIXED -> FREE re-add first
        both = retry_pend & rm_was_soft & ~crossed & rm_was_fixed
        s = _try_add(s, st, both, rm_id_c, ls_rm, M_rm, rm_was_lower,
                     sw_free=(both, rm_was_fixed))
        use_sw_readd = sw_readd & ~pend_take & ~both
        do_add = pend_take | use_sw_readd | price_add
        add_id = torch.where(pend_take, s.pend_id,
                             torch.where(use_sw_readd, rm_id_c, j))
        add_row = torch.where(pend_take[:, None], s.pend_row,
                              torch.where(use_sw_readd[:, None], M_rm, M_j))
        add_lower = torch.where(pend_take, s.pend_lower,
                                torch.where(use_sw_readd, rm_was_lower, lo_j))
        add_lam = torch.where(
            pend_take, s.pend_lam,
            torch.where(use_sw_readd, ls_rm, torch.where(lo_j, -one, one)))
        s = s._replace(sense=_put(s.sense, pid, _row(s.sense, pid) & ~ACTIVE,
                                  pend_drop),
                       pend=s.pend & ~pend_drop)
        sw_free = (use_sw_readd | pend_readd,
                   torch.where(pend_readd, p_was_fixed, rm_was_fixed))
    else:
        do_add = retry_pend | price_add
        add_id = torch.where(retry_pend, s.pend_id, j)
        add_row = torch.where(retry_pend[:, None], s.pend_row, M_j)
        add_lower = torch.where(retry_pend, s.pend_lower, lo_j)
        add_lam = torch.where(retry_pend, s.pend_lam,
                              torch.where(lo_j, -one, one))
    # on the new-lam path lam <- lam* before the add (auxiliary.c:158-159)
    lam2 = torch.where(price_add[:, None],
                       torch.where(s.used, lam_star, 0.0), s.lam)
    s = s._replace(lam=lam2, pend=s.pend & ~retry_pend & ~pend_block)
    s = _try_add(s, st, do_add, add_id, add_lam, add_row, add_lower,
                 sw_free=sw_free)
    return s._replace(status=status.to(torch.int32),
                      iterations=s.iterations + running.to(torch.int32))


def flat_gram(s: FlatState, st: Settings) -> torch.Tensor:
    """The Gram of the slot rows, rebuilt: G = M_W M_W' + rho_soft I_soft
    on used slots (with SOFT_WEIGHTS only FREE slacks, at their side's
    rho), the identity on free slots; (B, K, K)."""
    dtype = s.E.dtype
    G = torch.matmul(s.Mw, s.Mw.transpose(1, 2))
    bits = _slot_sense(s)
    softm = s.used & ((bits & SOFT) > 0)
    if s.sw is not None:
        softm = softm & ((bits & SLACK_FIXED) == 0)
        rho_w = _side(bits, _at_slot(s.sw.rho_ls, s), _at_slot(s.sw.rho_us, s))
        G = G + torch.diag_embed(torch.where(softm, rho_w, 0.0))
    else:
        G = G + torch.diag_embed(softm.to(dtype) * st.rho_soft)
    um = s.used[:, :, None] & s.used[:, None, :]
    G = torch.where(um, G, 0.0)
    return G + torch.diag_embed((~s.used).to(dtype))


def _nan_cholesky(G: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors, NaN on a lane whose factorization fails (as
    ``jnp.linalg.cholesky``)."""
    L, info = torch.linalg.cholesky_ex(G)
    return torch.where((info == 0)[:, None, None], L, torch.nan)


def flat_refresh(s: FlatState, st: Settings) -> FlatState:
    """Scheduled numerical maintenance between rounds: one Newton polish
    E <- E (2I - G E) against the rebuilt Gram, kept where ||G E - I||_max
    < 1/2 (outside that basin the iteration diverges) on RUNNING and
    optimal lanes; an exact refactorization for CYCLE lanes not yet
    repaired twice (re-opened, the pending entry dropped) and for lanes
    parked on an unstable deletion pivot (daqp.c:32-46, :66-85)."""
    K = s.E.shape[1]
    dtype, dev = s.E.dtype, s.E.device
    G = flat_gram(s, st)
    eye = torch.eye(K, dtype=dtype, device=dev)
    um = s.used[:, :, None] & s.used[:, None, :]
    Iu = torch.diag_embed(s.used.to(dtype))
    is_opt = (s.status == EXIT_OPTIMAL) | (s.status == EXIT_SOFT_OPTIMAL)
    P = torch.matmul(G, s.E)
    resid = (P - Iu).abs().amax((1, 2))
    E_new = torch.where(um, torch.matmul(s.E, 2 * Iu - P), 0.0)
    newton_ok = ((s.status == EXIT_RUNNING) | is_opt) & (resid < 0.5)
    E1 = torch.where(newton_ok[:, None, None], E_new, s.E)

    cyc = (s.status == EXIT_CYCLE) & (s.repaired < 2)
    parked = s.status == EXIT_REFACTOR
    need_exact = cyc | parked
    cF = _nan_cholesky(G)
    cF = torch.where(torch.isfinite(cF), cF, eye)
    E_exact = torch.where(um, torch.cholesky_solve(eye.expand_as(G), cF), 0.0)
    exact_ok = torch.isfinite(E_exact).all(2).all(1)
    fix = need_exact & exact_ok
    E2 = torch.where(fix[:, None, None], E_exact, E1)
    status = torch.where(fix, EXIT_RUNNING, s.status)
    # a parked lane whose Gram is itself numerically singular gives up
    status = torch.where(parked & ~exact_ok, EXIT_CYCLE, status)
    cyc = cyc & exact_ok
    # a repaired lane's pending entry is dropped and priced again
    drop_pend = cyc & s.pend
    m = s.M.shape[1]
    pid = torch.clamp(s.pend_id, 0, m - 1)
    sense = _put(s.sense, pid, _row(s.sense, pid) & ~ACTIVE, drop_pend)
    return s._replace(
        E=E2, status=status.to(torch.int32), sense=sense,
        pend=s.pend & ~drop_pend,
        repaired=s.repaired + cyc.to(torch.int32),
        cycle=torch.where(cyc, 0, s.cycle).to(torch.int32),
        best_fval=torch.where(cyc, -1.0, s.best_fval).to(dtype))


def flat_polish(s: FlatState, st: Settings) -> FlatState:
    """Refinement of the optimal lanes: ``REFINE_STEPS`` chained residual
    corrections of (lam*, u) through E, then a re-price that re-opens a
    lane with a violated row or a dual-infeasible slot (daqp_refine_active
    and the optimal path's re-check, daqp.c:47-63).  Two steps: one
    through an f32 E left a soft-heavy lane 4e-4 off (ldp_flat.py:678)."""
    is_opt = (s.status == EXIT_OPTIMAL) | (s.status == EXIT_SOFT_OPTIMAL)
    used = s.used
    bits = _slot_sense(s)
    lower = (bits & LOWER) > 0
    d_W = torch.where(used, _side(bits, _at_slot(s.dlower, s),
                                  _at_slot(s.dupper, s)), 0.0)
    softm = used & ((bits & SOFT) > 0)
    if s.sw is not None:
        free_soft = softm & ((bits & SLACK_FIXED) == 0)
        rho_w = _side(bits, _at_slot(s.sw.rho_ls, s), _at_slot(s.sw.rho_us, s))
        d_slack = _side(bits, _at_slot(s.sw.d_ls, s), -_at_slot(s.sw.d_us, s))

    def residual(lam_star, u):
        r = _mv(s.Mw, u) - d_W
        if s.sw is not None:
            # free soft slacks: the side's weight and the slack bound's
            # term (auxiliary.c:522-533)
            r = r - torch.where(free_soft, rho_w * (lam_star + d_slack), 0.0)
        else:
            r = r - torch.where(softm, st.rho_soft * lam_star, 0.0)
        return torch.where(used, r, 0.0)

    lam_star, u, ok = s.lam_star, s.u, is_opt
    for _ in range(REFINE_STEPS):
        dlam = _mv(s.E, residual(lam_star, u))
        ok = ok & torch.isfinite(dlam).all(1)
        dlam = torch.where(ok[:, None] & used, dlam, 0.0)
        lam_star = lam_star + dlam
        u = u - _mv(s.Mw.transpose(1, 2), dlam)
    lam_star = torch.where(ok[:, None], lam_star, s.lam_star)
    u2 = torch.where(ok[:, None], u, s.u)
    if s.sw is not None:
        soft_slack = torch.where(softm, rho_w * lam_star ** 2, 0.0).sum(1)
    else:
        soft_slack = st.rho_soft * torch.where(softm, lam_star ** 2,
                                               0.0).sum(1)
    fval = soft_slack + _dot(u2, u2)

    # re-price: a violated row or a dual-infeasible slot re-opens the lane
    # (SOFT_WEIGHTS soft rows follow the slack-bound rules instead)
    mu = _mv(s.M, u2)
    blocked = (s.sense & (ACTIVE | IMMUTABLE)) > 0
    viol = (((s.dupper - mu) < -st.primal_tol * s.scaling)
            | ((mu - s.dlower) < -st.primal_tol * s.scaling)) & ~blocked
    dual_bad = used & ((bits & IMMUTABLE) == 0) & torch.where(
        lower, lam_star > st.dual_tol, lam_star < -st.dual_tol)
    if s.sw is not None:
        dual_bad = dual_bad & ((bits & SOFT) == 0)
    reopen = ok & (viol.any(1) | dual_bad.any(1))
    return s._replace(
        lam_star=lam_star, u=u2,
        status=torch.where(reopen, EXIT_RUNNING, s.status).to(torch.int32),
        soft_slack=torch.where(ok, soft_slack, s.soft_slack),
        fval=torch.where(ok, fval, s.fval))


# the fields a round changes: the carries of the graph forms'
# loops (flat_activate_graph, flat_solve_graph)
_CARRIED = ("sense", "used", "sid", "lam", "Mw", "E", "lam_star", "pend",
            "pend_id", "pend_lam", "pend_row", "pend_lower", "u", "fval",
            "soft_slack", "iterations", "cycle", "best_fval", "repaired",
            "status")


def _state_loop(s: FlatState, cond, body, counter: torch.Tensor):
    """A ``while_loop`` (the form ``torch.export`` traces) over the 0-d
    ``counter`` and the ``_CARRIED`` fields of ``s``: ``cond(k, s)`` a
    bool tensor, ``body(k, s)`` the next state; the counter steps by one.
    Returns ``(k, s)``.  A counter on the host makes the test read
    nothing from the card."""
    from torch._higher_order_ops.while_loop import while_loop
    fixed = {k: getattr(s, k) for k in FlatState._fields
             if k not in _CARRIED}

    def state(carry):
        return FlatState(**fixed, **dict(zip(_CARRIED, carry)))

    def step(k, *carry):
        s1 = body(k, state(carry))
        # a loop's outputs may not alias its inputs
        return (k + 1,) + tuple(getattr(s1, f).clone() for f in _CARRIED)

    k, *carry = while_loop(lambda k, *carry: cond(k, state(carry)), step,
                           (counter,) + tuple(getattr(s, f)
                                              for f in _CARRIED))
    return k, state(carry)


def _activate_row(s: FlatState, st: Settings, i) -> FlatState:
    """Row i's turn of the activation (i an int, or a 0-d int64 tensor in
    the graph form): the lanes that want it ACTIVE (and do not hold it)
    add it; every other lane is left as it is by the masks."""
    if isinstance(i, int):
        idx = torch.full_like(s.pend_id, i)

        def col(x):
            return x[:, i]
    else:
        idx = i.expand_as(s.pend_id).clone()

        def col(x):
            return x.index_select(1, i.reshape(1)).squeeze(1)
    sense_i = col(s.sense)
    want = ((sense_i & ACTIVE) > 0) & (s.status == EXIT_RUNNING) \
        & ~(s.used & (s.sid == i)).any(1)
    is_lower = (sense_i & LOWER) > 0
    one = torch.ones_like(s.pend_lam)
    M_i = col(s.M)
    s = _try_add(s, st, want, idx, torch.where(is_lower, -one, one), M_i,
                 is_lower)
    dep = s.pend          # parked: a linearly dependent row
    # the null vector's coefficients M_i = sum_j ap_j Mw_j on used
    # slots; consistency needs d_i = sum_j ap_j d_Wj
    gp = torch.where(s.used, _mv(s.Mw, M_i), 0.0)
    ap = _mv(s.E, gp)
    bits = _slot_sense(s)
    d_W = torch.where(s.used, _side(bits, _at_slot(s.dlower, s),
                                    _at_slot(s.dupper, s)), 0.0)
    d_i = torch.where(is_lower, col(s.dlower), col(s.dupper))
    term = ap * d_W
    resid = d_i - term.sum(1)
    scale = 1.0 + d_i.abs() + term.abs().sum(1)
    sense_now = col(s.sense)      # with the add's bits
    is_imm = (sense_now & IMMUTABLE) > 0
    incons = dep & is_imm & (resid.abs() > st.primal_tol * scale)
    return s._replace(
        pend=torch.zeros_like(s.pend),
        sense=_put(s.sense, idx, sense_now & ~ACTIVE, dep),
        status=torch.where(incons, EXIT_OVERDETERMINED_INITIAL,
                           s.status).to(torch.int32))


def flat_activate(s: FlatState, st: Settings) -> FlatState:
    """Activate the sense-ACTIVE rows in order (the warm / equality start,
    ``daqp_activate_constraints``, auxiliary.c:398-478).  A linearly
    dependent row is dropped with its ACTIVE bit cleared, so pricing can
    enforce it later; a dependent IMMUTABLE row (a redundant equality)
    whose right-hand side disagrees with the active rows' makes the lane
    EXIT_OVERDETERMINED_INITIAL (auxiliary.c:423-459).  Rows that no lane
    activates are skipped: one read finds them, and for them the JAX
    module's loop body changes nothing."""
    (want_rows,) = host_numpy(((s.sense & ACTIVE) > 0).any(0))
    for i in want_rows.nonzero()[0].tolist():
        s = _activate_row(s, st, i)
    return s


def flat_activate_graph(s: FlatState, st: Settings) -> FlatState:
    """``flat_activate`` without its host read, the form ``torch.export``
    traces: a ``while_loop`` in which every row takes its turn, in order,
    its counter on the host.  A row that no lane wants changes nothing
    (every update of ``_activate_row`` is masked, and ``pend`` is clear
    between rows), so a lane gets what the host loop gives it."""
    m, dev = s.M.shape[1], s.M.device
    return _state_loop(s, lambda i, _: i < m,
                       lambda i, s1: _activate_row(s1, st, i.to(dev)),
                       torch.zeros((), dtype=torch.int64))[1]


def select(mask: torch.Tensor, a: FlatState, b: FlatState) -> FlatState:
    """Per lane, ``a`` where ``mask`` else ``b``."""
    out = []
    for x, y in zip(a[:-1], b[:-1]):
        out.append(x if x is y else torch.where(
            mask.view((-1,) + (1,) * (x.dim() - 1)), x, y))
    return FlatState(*out, sw=a.sw)


def _flat_round(s: FlatState, st: Settings, live, steps=None) -> FlatState:
    """One round: ``INNER_STEPS`` masked steps (unrolled, or
    ``steps(s)``), then the refresh and the polish on the lanes of
    ``live``."""
    if steps is None:
        for _ in range(INNER_STEPS):
            s = flat_step(s, st)
    else:
        s = steps(s)
    s = select(live, flat_refresh(s, st), s)
    return select(live, flat_polish(s, st), s)


def _flat_exit(s: FlatState, limit: int) -> FlatState:
    """A lane still RUNNING exits ITERLIMIT past the limit, else CYCLE."""
    run = s.status == EXIT_RUNNING
    return s._replace(status=torch.where(
        run & (s.iterations >= limit), EXIT_ITERLIMIT,
        torch.where(run, EXIT_CYCLE, s.status)).to(torch.int32))


def flat_solve(s: FlatState, st: Settings) -> FlatState:
    """Rounds of ``INNER_STEPS`` masked steps, each followed by the
    refresh and the polish on the lanes that were running at its start;
    one host read a round (``ops.host_syncs``) decides whether any lane
    still runs below its iteration limit, and at most ``MAX_ROUNDS``
    rounds run (counted in ``rounds``).  Then a lane still RUNNING exits
    ITERLIMIT past the limit, else CYCLE."""
    global rounds
    limit = int(st.iter_limit)
    r = 0
    while r < MAX_ROUNDS:
        live = (s.status == EXIT_RUNNING) & (s.iterations < limit)
        if not host_any(live):
            break
        s = _flat_round(s, st, live)
        r += 1
    rounds += r
    return _flat_exit(s, limit)


def flat_solve_graph(s: FlatState, st: Settings):
    """``flat_solve`` as a ``while_loop`` of rounds, the form
    ``torch.export`` traces: it runs while ``r < MAX_ROUNDS`` and some
    lane is live, and a round's ``INNER_STEPS`` steps are a nested
    ``while_loop`` whose counter lives on the host, so the only reads are
    the rounds' tests and a lane gets what the host loop gives it.
    Returns ``(s, r)``, r the rounds run (a 0-d int64 tensor: a loaded
    program never runs the Python counter ``rounds``).  SOFT_WEIGHTS data
    (``s.sw``) is not carried."""
    if s.sw is not None:
        raise ValueError("flat_solve_graph: SOFT_WEIGHTS data is not "
                         "supported")
    limit = int(st.iter_limit)

    def live_of(s1):
        return (s1.status == EXIT_RUNNING) & (s1.iterations < limit)

    def steps(s1):
        return _state_loop(s1, lambda k, _: k < INNER_STEPS,
                           lambda k, s2: flat_step(s2, st),
                           torch.zeros((), dtype=torch.int64))[1]

    r, s = _state_loop(
        s, lambda r, s1: (r < MAX_ROUNDS) & live_of(s1).any(),
        lambda r, s1: _flat_round(s1, st, live_of(s1), steps),
        torch.zeros((), dtype=torch.int64, device=s.E.device))
    return _flat_exit(s, limit), r


def flat_extract_duals(s: FlatState) -> torch.Tensor:
    """The slots' duals scattered to dense (B, m), rescaled to the
    original rows (daqp.c:135-138, api.c:449-453)."""
    B, m = s.sense.shape
    vals = torch.where(s.used, s.lam_star * _at_slot(s.scaling, s), 0.0)
    idx = torch.where(s.used, s.sid, m)
    out = torch.zeros((B, m + 1), dtype=s.lam.dtype, device=s.lam.device)
    return out.scatter(1, idx, vals)[:, :m]
