"""B7: the dense-mask dual active-set round, and the host loop around it.

Counterpart of ``daqp_tpu/ops/pallas_batch.py``: ``:55 DenseState``,
``:751 run_kernel_round`` (the TPU kernel ``_kernel_body`` ->
``_solve_tile_live``, :105-748, its plain, soft and SOFT_WEIGHTS
variants), ``:821
dense_init``, ``:885 _gram``, ``:904 _batched_gram_inverse`` (its XLA
path), ``:945 dense_activate``, ``:977 dense_add_row``, ``:1016
dense_reactivate``, ``:1107 exact_repair``, ``:1140 repair_needed``,
``:1145 newton_refresh``, ``:1170 polish`` and ``:1239 dense_solve``.

The working set is keyed by constraint row: a row's own row and column
of the inverse Gram E (B, m, m) are its slot, and membership is the two
side masks act_up / act_lo.  Unlike the slot tier, the set is not capped
at n + 1 entries, so soft rows (whose Gram diagonal carries rho_soft) can
all be active at once.  The state is batch-leading; the pending singular
entry is a row index ``pid`` with ``pend`` / ``plam`` / ``plo``, as in
the slot state, instead of the TPU's (m, B) one-hot.  Left behind as TPU
workarounds: the padding of m and n to multiples of 8 and the 128-lane
tiles.

A state built with SOFT_WEIGHTS data (``dense_init(sw=...)``) carries
``sw_dls``, ``sw_dus``, ``sw_rls``, ``sw_rus``, ``sfix`` and ``pfix``
and runs the SOFT_WEIGHTS variant of the step (auxiliary.c:199-274): the
slack state machine with per-side weights, slack-dual blocking with the
FIXED/FREE skip rules and the kink guard, the pending entry's own
transition as one more blocking candidate, and the blocker re-adds.  On a
plain or soft state those fields are None.

``run_kernel_round`` launches the CUDA kernel (``csrc/dense_round.cu``)
on CUDA tensors and runs ``run_kernel_round_plain`` on CPU tensors.  The
rounds, repairs and polish cycles run on the host, each masked per lane.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import check_deadline, host_any, smem
from .slot import (MAX_ROUNDS, STEPS, _HELD, _check, _cuda_device,
                   _first_min, _launch)
from ..types import (Settings, DAQP_INF, EXIT_CYCLE, EXIT_INFEASIBLE,
                     EXIT_ITERLIMIT, EXIT_OPTIMAL, EXIT_REFACTOR,
                     EXIT_RUNNING, EXIT_SOFT_OPTIMAL, PRICING_BLAND)

# kernel launches of run_kernel_round (B7); the caller resets it
launches = 0


class DenseState(NamedTuple):
    """Dense-mask batched solver state, batch-leading, f32."""
    # problem data (const within a round)
    M: torch.Tensor          # (B, m, n)
    dupper: torch.Tensor     # (B, m)
    dlower: torch.Tensor     # (B, m)
    scaling: torch.Tensor    # (B, m)
    immut: torch.Tensor      # (B, m) 0/1
    soft: torch.Tensor       # (B, m) 0/1
    fbound: torch.Tensor     # (B,) LDP-space dual objective bound
    # working set by row
    act_up: torch.Tensor     # (B, m) 0/1
    act_lo: torch.Tensor     # (B, m) 0/1
    E: torch.Tensor          # (B, m, m) inverse Gram on the active block
    lam: torch.Tensor        # (B, m) dual iterate
    lam_star: torch.Tensor   # (B, m) last CSP solution
    # pending singular addition
    pend: torch.Tensor       # (B,) 0/1
    pid: torch.Tensor        # (B,) its row (-1 = none)
    plam: torch.Tensor       # (B,)
    plo: torch.Tensor        # (B,) side (1 = lower)
    # iterates / control
    u: torch.Tensor          # (B, n)
    fval: torch.Tensor       # (B,)
    best_fval: torch.Tensor  # (B,)
    cycle: torch.Tensor      # (B,)
    repaired: torch.Tensor   # (B,)
    iterations: torch.Tensor  # (B,)
    status: torch.Tensor     # (B,) int32
    # SOFT_WEIGHTS data (const within a round), scaling-normalized and zero
    # on hard rows, and the slack state; None on a plain or soft state
    sw_dls: Optional[torch.Tensor] = None   # (B, m) lower slack bounds
    sw_dus: Optional[torch.Tensor] = None   # (B, m) upper slack bounds
    sw_rls: Optional[torch.Tensor] = None   # (B, m) lower-side weights
    sw_rus: Optional[torch.Tensor] = None   # (B, m) upper-side weights
    sfix: Optional[torch.Tensor] = None     # (B, m) 0/1 slack FIXED
    pfix: Optional[torch.Tensor] = None     # (B,) pending entry's FIXED


# argument order of the CUDA entry (enum Ptr of dense_round.cu); the
# SOFT_WEIGHTS pointers follow the state outputs (null on other states)
CONST = ("M", "dupper", "dlower", "scaling", "immut", "soft", "fbound")
STATE = ("act_up", "act_lo", "E", "lam", "lam_star", "pend", "pid", "plam",
         "plo", "u", "fval", "best_fval", "cycle", "repaired", "iterations",
         "status")
SW_CONST = ("sw_dls", "sw_dus", "sw_rls", "sw_rus")
SW_STATE = ("sfix", "pfix")
# 64 f32 ulps: the kink guard's floor (pallas_batch.py:259)
_EPS_K = 64.0 * float(torch.finfo(torch.float32).eps)


def map_state(fn, *states: DenseState) -> DenseState:
    """``fn`` over the fields of ``states`` field by field; a field that is
    None on the first state stays None (the SOFT_WEIGHTS fields of a plain
    or soft state)."""
    return DenseState(*(None if xs[0] is None else fn(*xs)
                        for xs in zip(*states)))


def select_lanes(mask, a: DenseState, b: DenseState) -> DenseState:
    """Per lane: ``a`` where the (B,) bool ``mask`` holds, else ``b``."""
    return map_state(lambda x, y: torch.where(
        mask.view((-1,) + (1,) * (x.dim() - 1)), x, y), a, b)


def soft_rho(s: DenseState, st: Settings):
    """The lane's smallest legitimate soft Schur pivot scale: rho_soft, or
    under SOFT_WEIGHTS the smallest per-side weight over the lane's soft
    rows ((B, 1), DAQP_INF where it has none; pallas_batch.py:257)."""
    if s.sw_dls is None:
        return st.rho_soft
    w = torch.minimum(s.sw_rls, s.sw_rus)
    return torch.where(s.soft > 0, w, DAQP_INF).amin(1, keepdim=True)


def _gate(dii, st: Settings, has_soft: bool, rho=None):
    """The relative add-pivot gate (pallas_batch.py:653-676): max(sing_tol,
    1e-4 dii), clamped below 0.25 rho when soft rows are in play, where a
    conflicting soft add's legitimate Schur pivot is ~rho (rho_soft, or
    the lane's ``soft_rho`` under SOFT_WEIGHTS)."""
    rel = 1e-4 * dii
    if has_soft:
        rel = torch.minimum(rel, 0.25 * torch.as_tensor(
            st.rho_soft if rho is None else rho, dtype=rel.dtype,
            device=rel.device))
    return torch.clamp(rel, min=st.sing_tol)


def run_kernel_round_plain(s: DenseState, st: Settings, n_true: int,
                           steps: int = STEPS,
                           has_soft: bool = True) -> DenseState:
    """Up to ``steps`` masked iterations per lane in torch ops: the step of
    ``_solve_tile_live`` (pallas_batch.py:304-722) vectorized over the
    batch, with its SOFT_WEIGHTS branches on a state that carries
    SOFT_WEIGHTS data (which forces ``has_soft``).  A lane that is not
    RUNNING is left as it is; the loop stops once every lane is
    terminal."""
    f32 = s.M.dtype             # float32 (the kernel's); float64 runs too
    B, m, n = s.M.shape
    dev = s.M.device
    BIG = DAQP_INF
    dtol, ptol, pivtol = st.dual_tol, st.primal_tol, st.pivot_tol
    progtol, cyctol = st.progress_tol, st.cycle_tol
    rho = st.rho_soft
    iota_m = torch.arange(m, device=dev, dtype=f32)[None, :]
    has_sw = s.sw_dls is not None
    has_soft = has_soft or has_sw

    M, du, dl, sc, im = s.M, s.dupper, s.dlower, s.scaling, s.immut
    sf = s.soft
    fb = s.fbound[:, None]
    au, al, E, lam, ls, u = s.act_up, s.act_lo, s.E, s.lam, s.lam_star, s.u
    pd, pid, plm, plo, fv, bf, cy, rp, it = (
        x[:, None] for x in (s.pend, s.pid, s.plam, s.plo, s.fval,
                             s.best_fval, s.cycle, s.repaired, s.iterations))
    stt = s.status[:, None]
    if has_sw:
        dls, dus, rls, rus = s.sw_dls, s.sw_dus, s.sw_rls, s.sw_rus
        sfx, pfx = s.sfix, s.pfix[:, None]
        rho_min = soft_rho(s, st)
        ktol_us = torch.clamp(_EPS_K * (1.0 + dus.abs()), min=dtol)
        ktol_ls = torch.clamp(_EPS_K * (1.0 + dls.abs()), min=dtol)

    def mv(A, x):                 # out[b, i] = sum_j A[b, i, j] x[b, j]
        return torch.einsum('bij,bj->bi', A, x)

    def mtv(A, x):                # out[b, j] = sum_i A[b, i, j] x[b, i]
        return torch.einsum('bij,bi->bj', A, x)

    def at(x, idx):               # x[b, idx[b]] as (B, 1)
        return x.gather(1, idx)

    def f(mask):
        return mask.to(f32)

    for step in range(steps):
        if step % 8 == 0 and not bool((stt == EXIT_RUNNING).any()):
            break
        run = (stt == EXIT_RUNNING).to(f32)
        act = au + al
        d_W = au * du + al * dl
        if has_sw:
            # FREE soft slacks shift d_W by their bound (:315-319)
            free_w = 1.0 - sfx
            d_W = d_W + act * sf * free_w * (al * (rls * dls)
                                             - au * (rus * dus))
        po = pd * (iota_m == pid).to(f32)              # pending one-hot
        g_p = mv(M, mtv(M, po)) * act
        lam_star = -mv(E, d_W)
        a_p = mv(E, g_p)
        sgn_p = 1.0 - 2.0 * plo
        sdir = -a_p * sgn_p

        # blocking min-ratio line search (auxiliary.c:276-311; under
        # SOFT_WEIGHTS the slack dual per side, auxiliary.c:199-274)
        delta = pd * sdir + (1.0 - pd) * (lam_star - lam)
        signv = pd * sdir + (1.0 - pd) * lam_star
        if has_sw:
            neg, pos = f(delta < 0), f(delta > 0)
            sk_lo_f = f((delta < dtol) | (signv <= -dls + dtol))
            sk_lo_x = f((signv <= dtol) & (signv + dtol >= -dls)) * (1.0 - pd)
            sk_up_f = f((delta > -dtol) | (signv >= dus))
            sk_up_x = f((signv >= -dtol) & (signv <= dtol + dus)) * (1.0 - pd)
            # kink guard: a soft dual at its transition in the crossing
            # direction is at its coordinate optimum (:347-355)
            at_us = f((lam - dus).abs() <= ktol_us)
            at_ls = f((lam + dls).abs() <= ktol_ls)
            kink = sf * (al * at_ls * (free_w + sfx * neg)
                         + au * at_us * (free_w + sfx * pos))
            skip = al * (free_w * sk_lo_f + sfx * sk_lo_x) \
                + au * (free_w * sk_up_f + sfx * sk_up_x) + kink
            lam_slack = lam + al * dls * (free_w + sfx * neg) \
                - au * dus * (free_w + sfx * pos)
            elig = act * (1.0 - im) * f(skip < 0.5)
            ratio = -lam_slack / delta
        else:
            infeas = al * (signv > dtol).to(f32) \
                + (1.0 - al) * (signv < -dtol).to(f32)
            elig = infeas * act * (1.0 - im)
            ratio = -lam / delta
        ratio = torch.where(torch.isfinite(ratio),
                            torch.clamp(ratio, min=0.0), 0.0)
        cand = torch.where(elig > 0, ratio, BIG)
        rm, rmin = _first_min(cand)
        oh_rm = (iota_m == rm).to(f32)
        if has_sw:
            # the pending entry's own slack transition, searched like one
            # more candidate; ties go to the rows (:375-409)
            p_dls, p_dus = (po * dls).sum(1, keepdim=True), \
                (po * dus).sum(1, keepdim=True)
            p_free = 1.0 - pfx
            p_neg, p_pos = f(sgn_p < 0), f(sgn_p > 0)
            pskip = plo * p_free * f((sgn_p < dtol)
                                     | (sgn_p <= -p_dls + dtol)) \
                + (1.0 - plo) * p_free * f((sgn_p > -dtol)
                                           | (sgn_p >= p_dus))
            pkt_us = torch.clamp(_EPS_K * (1.0 + p_dus.abs()), min=dtol)
            pkt_ls = torch.clamp(_EPS_K * (1.0 + p_dls.abs()), min=dtol)
            p_at_us = f((plm - p_dus).abs() <= pkt_us)
            p_at_ls = f((plm + p_dls).abs() <= pkt_ls)
            p_soft = (po * sf).sum(1, keepdim=True)
            pkink = p_soft * (plo * p_at_ls * (p_free + pfx * p_neg)
                              + (1.0 - plo) * p_at_us
                              * (p_free + pfx * p_pos))
            p_lam_slack = plm + plo * p_dls * (p_free + pfx * p_neg) \
                - (1.0 - plo) * p_dus * (p_free + pfx * p_pos)
            p_imm = (po * im).sum(1, keepdim=True)
            p_ratio = torch.clamp(-p_lam_slack / sgn_p, min=0.0)
            p_elig = pd * (1.0 - p_imm) * f((pskip + pkink) < 0.5)
            pend_cand = torch.where(p_elig > 0, p_ratio, BIG)
            pend_block = run * f((pend_cand < rmin) & (pend_cand < BIG))
            do_rm0 = run * (1.0 - pend_block) * f(rmin < BIG)
            step0 = torch.where(pend_block > 0,
                                torch.where(pend_cand < BIG, pend_cand, 0.0),
                                torch.where(rmin < BIG, rmin, 0.0))
        else:
            pend_block = torch.zeros_like(run)
            do_rm0 = run * (rmin < BIG).to(f32)

        # primal + pricing
        u_new = -mtv(M, lam_star * act)
        if has_sw:
            rho_w = al * rls + au * rus           # per-side weights
            soft_slack = (sf * act * rho_w * lam_star * lam_star).sum(
                1, keepdim=True)
        elif has_soft:
            soft_slack = rho * (sf * act * lam_star * lam_star).sum(
                1, keepdim=True)
        else:
            soft_slack = torch.zeros_like(fv)
        fv_new = (u_new * u_new).sum(1, keepdim=True) + soft_slack
        mu = mv(M, u_new)
        bound = -ptol * sc
        v_up = du - mu
        v_lo = mu - dl
        blocked = (act > 0) | (im > 0) | (po > 0)
        up_ok = (v_up < bound) & ~blocked
        lo_ok = (v_lo < bound) & ~blocked & ~up_ok
        cand2 = torch.where(up_ok, v_up, torch.where(lo_ok, v_lo, BIG))
        if int(st.pricing) == PRICING_BLAND:
            cand2 = torch.where(up_ok | lo_ok, iota_m - BIG, BIG)
        jr, vmin = _first_min(cand2)
        oh_j = (iota_m == jr).to(f32)
        found = (vmin < 0).to(f32)
        j_lo = lo_ok.gather(1, jr).to(f32)

        # add candidate: pending retry after a removal, or pricing winner;
        # under SOFT_WEIGHTS also a removed soft blocker whose slack dual
        # has not crossed (re-added flipped) and a blocked pending entry
        # (:446-485)
        retry = pd * do_rm0
        price0 = run * (1.0 - do_rm0) * (1.0 - pd)
        padd0 = price0 * found
        if has_sw:
            # the step goes just past the transition (:458-461)
            alpha0 = (do_rm0 + pend_block) * step0 * 1.001
            ls_rm = at(lam + alpha0 * delta * act, rm)
            plm_new = plm + alpha0 * sgn_p * pd
            rm_soft, rm_lo, rm_fix = at(sf, rm), at(al, rm), at(sfx, rm)
            crossed = rm_lo * f(ls_rm > 0) + (1.0 - rm_lo) * f(ls_rm < 0)
            pend_crossed = plo * f(plm_new > 0) + (1.0 - plo) * f(plm_new < 0)
            pend_readd = pend_block * (1.0 - pend_crossed)
            sw_readd = do_rm0 * (1.0 - pd) * rm_soft * (1.0 - crossed)
            # a pending retry beside a FIXED soft blocker does both adds
            both0 = retry * rm_soft * (1.0 - crossed) * rm_fix
            pend_take = retry + pend_readd
            add_oh = pend_take * po + sw_readd * oh_rm + padd0 * oh_j
            add_lo = pend_take * plo + sw_readd * rm_lo + padd0 * j_lo
            add_lam = pend_take * plm_new + sw_readd * ls_rm \
                + padd0 * (1.0 - 2.0 * j_lo)
            add_id = pend_take * pid + sw_readd * rm.to(f32) \
                + padd0 * jr.to(f32)
        else:
            add_oh = retry * po + padd0 * oh_j
            add_lo = retry * plo + padd0 * j_lo
            add_lam = retry * plm + padd0 * (1.0 - 2.0 * j_lo)
            add_id = retry * pid + padd0 * jr.to(f32)
        mj = mtv(M, add_oh)
        g = mv(M, mj) * act
        keep0 = 1.0 - oh_rm * do_rm0
        g_k = g * keep0
        add_soft = (add_oh * sf).sum(1, keepdim=True) if has_soft else 0.0

        # removed column + Schur vector(s); deletion pivot guard
        e = E.gather(2, rm[:, :, None].expand(B, m, 1))[:, :, 0]
        a_pre = mv(E, g_k)
        if has_sw:
            mj_b = mtv(M, oh_rm)                 # the blocker's row
            g_bk = mv(M, mj_b) * act * keep0
            ab_pre = mv(E, g_bk)
        err = e.gather(1, rm)
        bad = (do_rm0 > 0) & (err < pivtol * e.abs().amax(1, keepdim=True))
        stt = torch.where(bad, EXIT_REFACTOR, stt)
        do_rm = do_rm0 * (1.0 - bad.to(f32))
        keep = 1.0 - oh_rm * do_rm
        err_s = torch.where(err != 0, err, 1.0)
        ec = (e * g_k).sum(1, keepdim=True) / err_s
        a_post = keep * (a_pre - do_rm * e * ec)
        if has_sw:
            ecb = (e * g_bk).sum(1, keepdim=True) / err_s
            ab_post = keep * (ab_pre - do_rm * e * ecb)

        # line-search dual update (masked removal; under SOFT_WEIGHTS also
        # a pending-transition block, which steps with no deletion)
        if has_sw:
            alpha = (do_rm + pend_block) * step0 * 1.001
        else:
            alpha = do_rm * torch.where(rmin < BIG, rmin, 0.0)
        lam = (lam + alpha * delta * act) * keep
        plm = plm + alpha * sgn_p * pd
        au = au * keep
        al = al * keep

        # exits: stuck pending, dominance cut, optimal, cycle guard
        stuck = (stt == EXIT_RUNNING) & (pd > 0) & (do_rm == 0) & (run > 0) \
            & (pend_block == 0)
        stt = torch.where(stuck, torch.where(rp > 0, EXIT_INFEASIBLE,
                                             EXIT_CYCLE), stt)
        cut = (price0 > 0) & (stt == EXIT_RUNNING) & (fv_new > fb)
        stt = torch.where(cut, EXIT_INFEASIBLE, stt)
        price = price0 * (stt == EXIT_RUNNING).to(f32)
        if has_soft:
            opt_flag = torch.where(soft_slack > ptol, EXIT_SOFT_OPTIMAL,
                                   EXIT_OPTIMAL)
        else:
            opt_flag = EXIT_OPTIMAL
        stt = torch.where((price > 0) & (found == 0), opt_flag, stt)
        no_prog = (fv_new - bf < progtol * (1.0 + fv_new.abs())).to(f32)
        cy = price * (no_prog * (cy + 1.0)) + (1.0 - price) * cy
        bf = torch.where((price > 0) & (no_prog == 0), fv_new, bf)
        stt = torch.where((price > 0) & (cy > cyctol)
                          & (stt == EXIT_RUNNING), EXIT_CYCLE, stt)

        u = torch.where(price > 0, u_new, u)
        fv = torch.where(price > 0, fv_new, fv)
        ls = torch.where(run > 0, lam_star, ls)
        padd = padd0 * (stt == EXIT_RUNNING).to(f32)
        lam = torch.where(padd > 0, lam_star * act, lam)

        # Schur complement and the relative singularity gate; the rank
        # cap counts after the removal (pallas_batch.py:596-599)
        if has_sw:
            # per-side weight on the diagonal when the entering slack is
            # FREE: derived from its dual against the slack bound, flipped
            # on the two re-add paths (:573-593)
            rho_side = add_lo * (add_oh * rls).sum(1, keepdim=True) \
                + (1.0 - add_lo) * (add_oh * rus).sum(1, keepdim=True)
            d_ls_add = (add_oh * dls).sum(1, keepdim=True)
            d_us_add = (add_oh * dus).sum(1, keepdim=True)
            free_der = add_lo * f(add_lam <= -d_ls_add) \
                + (1.0 - add_lo) * f(add_lam >= d_us_add)
            override = sw_readd + pend_readd
            free_val = pend_readd * pfx + sw_readd * rm_fix
            free_main = override * free_val + (1.0 - override) * free_der
            contributes = add_soft * free_main
            dii = (mj * mj).sum(1, keepdim=True) + rho_side * contributes
            # the double add's blocker re-enters FREE right after its own
            # deletion; the main add's Schur data chain through its
            # rank-one update algebraically (:600-641)
            rho_b = rm_lo * at(rls, rm) + (1.0 - rm_lo) * at(rus, rm)
            dii_b = (mj_b * mj_b).sum(1, keepdim=True) + rho_b
            sval_b = dii_b - (g_bk * ab_post).sum(1, keepdim=True)
            both = both0 * (1.0 - bad.to(f32))
            k_rm = act.sum(1, keepdim=True) - do_rm
            fs_cnt = (act * sf * (1.0 - sfx)).sum(1, keepdim=True)
            fs_rm = do_rm * rm_soft * (1.0 - rm_fix)
            gate_b = torch.clamp(torch.minimum(1e-4 * dii_b, 0.25 * rho_b),
                                 min=st.sing_tol)
            sing_b = f((sval_b < gate_b)
                       | (k_rm >= n_true + fs_cnt - fs_rm + 1.0))
            # a singular both-add is skipped, not parked (:624-627)
            ok_b = both * (1.0 - sing_b)
            w_b = torch.where(oh_rm > 0, -1.0, ab_post * act)
            c_b = ok_b / torch.where(sval_b != 0, sval_b, 1.0)
            g_rm = (oh_rm * g).sum(1, keepdim=True)
            cross = (w_b * g_k).sum(1, keepdim=True) - ok_b * g_rm
            a_main = a_post + c_b * w_b * cross
            a_main_rm = at(a_main, rm)
            sval = dii - ((g_k * a_main).sum(1, keepdim=True)
                          + ok_b * g_rm * a_main_rm)
            k = k_rm + ok_b
            # the rank cap counts FREE soft actives only
            ns_act = fs_cnt - fs_rm + ok_b + contributes
            gate = _gate(dii, st, True, rho_min)
        else:
            dii = (mj * mj).sum(1, keepdim=True) + rho * add_soft
            a_main = a_post
            sval = dii - (g_k * a_post).sum(1, keepdim=True)
            k = act.sum(1, keepdim=True) - do_rm
            if has_soft:
                rm_soft = do_rm * (oh_rm * sf).sum(1, keepdim=True)
                ns_act = (act * sf).sum(1, keepdim=True) - rm_soft + add_soft
            else:
                ns_act = 0.0
            gate = _gate(dii, st, has_soft)
        sing = ((sval < gate) | (k >= n_true + ns_act)).to(f32)
        if has_sw:
            do_add = (retry + pend_readd + sw_readd) * (1.0 - bad.to(f32)) \
                + padd
        else:
            do_add = retry * (1.0 - bad.to(f32)) + padd
        ok = do_add * (1.0 - sing)
        w = torch.where(add_oh > 0, -1.0, a_main * act)
        c_del = -do_rm / err_s
        c_add = ok / torch.where(sval != 0, sval, 1.0)
        # combined deletion + rescale [+ blocker re-add] + bordered
        # addition, in that order
        E = (E + c_del[:, :, None] * e[:, :, None] * e[:, None, :]) \
            * keep[:, :, None] * keep[:, None, :]
        if has_sw:
            E = E + c_b[:, :, None] * w_b[:, :, None] * w_b[:, None, :]
            au = torch.clamp(au + ok_b * oh_rm * (1.0 - rm_lo), max=1.0)
            al = torch.clamp(al + ok_b * oh_rm * rm_lo, max=1.0)
            lam = lam + ok_b * oh_rm * ls_rm
            sfx = sfx * (1.0 - ok_b * oh_rm)        # the blocker is FREE
        E = E + c_add[:, :, None] * w[:, :, None] * w[:, None, :]
        au = torch.clamp(au + ok * add_oh * (1.0 - add_lo), max=1.0)
        al = torch.clamp(al + ok * add_oh * add_lo, max=1.0)
        lam = lam + ok * add_oh * add_lam

        mk_pend = do_add * sing
        if has_sw:
            sfx = sfx * (1.0 - ok * add_oh) + ok * add_oh * (1.0 - free_main)
            pd = torch.clamp(pd * (1.0 - retry) * (1.0 - pend_block)
                             + mk_pend, max=1.0)
            pfx = torch.where(mk_pend > 0, 1.0 - free_main, pfx)
        else:
            pd = torch.clamp((1.0 - retry) * pd + mk_pend, max=1.0)
        pid = torch.where(mk_pend > 0, add_id, pid)
        plm = torch.where(mk_pend > 0, add_lam, plm)
        plo = torch.where(mk_pend > 0, add_lo, plo)
        it = it + run

    out = dict(
        act_up=au, act_lo=al, E=E, lam=lam, lam_star=ls, pend=pd[:, 0],
        pid=pid[:, 0], plam=plm[:, 0], plo=plo[:, 0], u=u, fval=fv[:, 0],
        best_fval=bf[:, 0], cycle=cy[:, 0], repaired=rp[:, 0],
        iterations=it[:, 0], status=stt[:, 0].to(torch.int32))
    if has_sw:
        out.update(sfix=sfx, pfix=pfx[:, 0])
    return s._replace(**out)


def _state_items(s: DenseState, names):
    B, m, n = s.M.shape
    shapes = dict(M=(B, m, n), E=(B, m, m), u=(B, n))
    shapes.update((k, (B, m)) for k in ("dupper", "dlower", "scaling",
                                        "immut", "soft", "act_up", "act_lo",
                                        "lam", "lam_star", "sfix")
                  + SW_CONST)
    return [(name, getattr(s, name), shapes.get(name, (B,)),
             torch.int32 if name == "status" else torch.float32)
            for name in names]


def run_kernel_round(s: DenseState, st: Settings, n_true: int,
                     steps: int = STEPS, has_soft: bool = True) -> DenseState:
    """B7 wrapper: one round of ``steps`` iterations per lane; the CUDA
    kernel for CUDA tensors (f32 state, int32 status, contiguous), the
    plain twin for CPU tensors.  ``has_soft`` selects the soft variant of
    the step (the TPU kernel's compile-time flag, a runtime flag here);
    the SOFT_WEIGHTS variant is selected by the state itself
    (``s.sw_dls is not None``, pallas_batch.py:765-767) and forces
    ``has_soft``."""
    global launches
    dev = s.M.device
    if dev.type == "cpu":
        return run_kernel_round_plain(s, st, n_true, steps, has_soft)
    _cuda_device("run_kernel_round", dev)
    B, m, n = s.M.shape
    has_sw = s.sw_dls is not None
    names = CONST + STATE + ((SW_CONST + SW_STATE) if has_sw else ())
    _check("run_kernel_round", dev, _state_items(s, names))
    smem.check("run_kernel_round (B7-sw)" if has_sw
               else "run_kernel_round (B7)", dict(m=m, n=n),
               smem.dense_floats(m, n, has_sw), dev)
    out_names = STATE + (SW_STATE if has_sw else ())
    outs = {name: torch.empty_like(getattr(s, name)) for name in out_names}
    if B == 0:
        return s
    sw_ptrs = [getattr(s, name) for name in SW_CONST + SW_STATE] \
        + [outs[name] for name in SW_STATE] if has_sw else [None] * 8
    _launch("dense_round_f32",
            [getattr(s, name) for name in CONST + STATE]
            + [outs[name] for name in STATE] + sw_ptrs,
            (B, m, n, n_true, steps), st, dev,
            tail=(float(st.rho_soft), int(bool(has_soft or has_sw)),
                  int(has_sw)))
    launches += 1
    return s._replace(**outs)


def dense_init(M, du, dl, sc, immut, soft=None, fbound=None,
               sw=None) -> DenseState:
    """Cold dense state from batch-leading LDP data, cast to f32 as the
    kernel takes it; f64 data stays f64 (the twin's f64 run on the CPU,
    which the kernel refuses).  No padding: m and n stay as given.
    ``sw``, a ``SoftWeights`` of scaling-normalized (B, m) fields zeroed on
    hard rows (``batch._kernel_batch_core`` normalizes), selects the
    SOFT_WEIGHTS variant; every slack starts FREE."""
    B, m, n = M.shape
    f32 = torch.float64 if M.dtype == torch.float64 else torch.float32
    dev = M.device

    def z(*shape, fill=0.0):
        return torch.full(shape, fill, dtype=f32, device=dev)

    def c(x):
        return x.to(f32).contiguous()

    sw_fields = {} if sw is None else dict(
        sw_dls=c(sw.d_ls), sw_dus=c(sw.d_us), sw_rls=c(sw.rho_ls),
        sw_rus=c(sw.rho_us), sfix=z(B, m), pfix=z(B))
    return DenseState(
        M=c(M), dupper=c(du), dlower=c(dl), scaling=c(sc), immut=c(immut),
        soft=z(B, m) if soft is None else c(soft),
        fbound=z(B, fill=DAQP_INF) if fbound is None else c(fbound),
        act_up=z(B, m), act_lo=z(B, m), E=z(B, m, m), lam=z(B, m),
        lam_star=z(B, m), pend=z(B), pid=z(B, fill=-1.0), plam=z(B),
        plo=z(B), u=z(B, n), fval=z(B), best_fval=z(B, fill=-1.0),
        cycle=z(B), repaired=z(B), iterations=z(B),
        status=torch.full((B,), EXIT_RUNNING, dtype=torch.int32,
                          device=dev), **sw_fields)


def _side_weights(s: DenseState):
    """The active side's weight per row, act_lo rho_ls + act_up rho_us
    (SOFT_WEIGHTS states)."""
    return s.act_lo * s.sw_rls + s.act_up * s.sw_rus


def _gram(s: DenseState, st: Settings):
    """G = (act M)(act M)' on the active block with rho_soft on the active
    soft diagonal (under SOFT_WEIGHTS the active side's weight, on FREE
    slacks only; pallas_batch.py:885-901), identity on inactive rows;
    (B, m, m)."""
    act = s.act_up + s.act_lo
    Ma = s.M * act[:, :, None]
    G = torch.matmul(Ma, Ma.transpose(1, 2)) \
        * (act[:, :, None] * act[:, None, :])
    if s.sw_dls is not None:
        diag = act * s.soft * (1.0 - s.sfix) * _side_weights(s)
    else:
        diag = act * s.soft * st.rho_soft
    return G + torch.diag_embed(1.0 - act + diag)


def _batched_gram_inverse(G, st: Settings, rho=None):
    """(B, m, m) SPD -> (inverse, ok_lane) by Cholesky; a failing lane gets
    ok_lane False and the identity in its place.  Never raises.

    As in ``slot._batched_gram_inverse``, a lane also fails when a pivot
    L_kk^2 (the Schur pivot of adding row k after the rows before it) is
    below the kernel's add gate, here the soft gate max(sing_tol,
    min(1e-4 G_kk, 0.25 rho)) with rho = ``rho`` (``soft_rho``; default
    rho_soft): a conflicting soft set's legitimate pivot is ~rho, which
    the plain 1e-4 G_kk gate would reject."""
    m = G.shape[-1]
    L, info = torch.linalg.cholesky_ex(G)
    piv = torch.diagonal(L, dim1=1, dim2=2) ** 2
    gate = _gate(torch.diagonal(G, dim1=1, dim2=2), st, True, rho)
    ok = (info == 0) & torch.isfinite(L).all(dim=2).all(dim=1) \
        & (piv >= gate).all(dim=1)
    eye = torch.eye(m, dtype=G.dtype, device=G.device)
    L = torch.where(ok[:, None, None], L, eye)
    E = torch.cholesky_solve(eye.expand_as(G), L)
    return E, ok & torch.isfinite(E).all(dim=2).all(dim=1)


def _actm(s: DenseState):
    act = s.act_up + s.act_lo
    return act[:, :, None] * act[:, None, :]


def dense_activate(s: DenseState, up_mask, lo_mask,
                   st: Settings) -> DenseState:
    """Bulk-activate a prescribed starting set (equalities, warm starts;
    auxiliary.c:398-478): set the side masks and build E with one batched
    Cholesky.  A lane whose set is numerically dependent is parked
    EXIT_REFACTOR for the host loop's exact repair.  Initial duals +-1.
    Under SOFT_WEIGHTS an activated slack starts FIXED where its seed dual
    +-1 is inside its slack bound (d > 1; pallas_batch.py:957-963); the
    masks, and so ``sfix``, are set on a lane whose factorization fails
    too, as in the JAX tier, and the exact repair settles it."""
    f32 = torch.float32
    s2 = s._replace(act_up=up_mask.to(f32).contiguous(),
                    act_lo=lo_mask.to(f32).contiguous())
    if s.sw_dls is not None:
        s2 = s2._replace(sfix=(s2.act_up * (s.sw_dus > 1.0).to(f32)
                               + s2.act_lo * (s.sw_dls > 1.0).to(f32))
                         .contiguous())
    E, ok = _batched_gram_inverse(_gram(s2, st), st, soft_rho(s2, st))
    status = torch.where(ok, s.status, EXIT_REFACTOR).to(torch.int32)
    return s2._replace(E=(E * _actm(s2)).contiguous(),
                       lam=s2.act_up - s2.act_lo, status=status)


def repair_needed(s: DenseState) -> torch.Tensor:
    return (s.status == EXIT_REFACTOR) \
        | ((s.status == EXIT_CYCLE) & (s.repaired == 0))


def exact_repair(s: DenseState, st: Settings) -> DenseState:
    """Exact refactorization of E for parked / cycling lanes (daqp.c:66-85),
    a (B', m, m) Cholesky on just the lanes that need it; a repaired
    cycling lane drops its pending entry."""
    idx = torch.nonzero(repair_needed(s)).squeeze(1)
    sub = map_state(lambda x: x[idx], s)
    E_exact, ok = _batched_gram_inverse(_gram(sub, st), st,
                                        soft_rho(sub, st))
    parked = sub.status == EXIT_REFACTOR
    cyc = ~parked
    E_i = torch.where(ok[:, None, None], E_exact, sub.E) * _actm(sub)
    status = torch.where(ok, EXIT_RUNNING, sub.status)
    status = torch.where(parked & ~ok, EXIT_CYCLE, status)
    okf = ok.to(torch.float32)
    drop = (cyc & ok).to(torch.float32)

    def put(x, vals):
        x = x.clone()
        x[idx] = vals.to(x.dtype)
        return x

    return s._replace(
        E=put(s.E, E_i), status=put(s.status, status),
        pend=put(s.pend, sub.pend * (1.0 - drop)),
        repaired=put(s.repaired, torch.clamp(sub.repaired + drop, max=1.0)),
        cycle=put(s.cycle, sub.cycle * (1.0 - okf)),
        best_fval=put(s.best_fval, torch.where(ok, -1.0, sub.best_fval)))


def newton_refresh(s: DenseState, st: Settings) -> DenseState:
    """One Newton step E <- E (2I - G E) against the exactly rebuilt Gram,
    on lanes inside the contraction basin ||G E - I|| < 1/2."""
    actm = _actm(s)
    Iu = torch.diag_embed(s.act_up + s.act_lo)
    P = torch.matmul(_gram(s, st), s.E) * actm
    resid = (P - Iu).abs().amax(dim=(1, 2))
    E_new = torch.matmul(s.E, 2.0 * Iu - P) * actm
    return s._replace(E=torch.where((resid < 0.5)[:, None, None], E_new,
                                    s.E).contiguous())


def polish(s: DenseState, st: Settings, refine_steps: int = 2) -> DenseState:
    """``refine_steps`` chained refinement steps of (lam*, u) on optimal
    lanes after a Newton refresh of E, then the primal re-price and the
    dual re-check, which re-open a lane whose refined point is not
    optimal (auxiliary.c:497-588, daqp.c:47-63)."""
    s = newton_refresh(s, st)
    act = s.act_up + s.act_lo
    is_opt = (s.status == EXIT_OPTIMAL) | (s.status == EXIT_SOFT_OPTIMAL)
    d_W = s.act_up * s.dupper + s.act_lo * s.dlower
    has_sw = s.sw_dls is not None
    if has_sw:
        # FREE soft slacks: per-side weight and the slack-bound term in the
        # residual (pallas_batch.py:1185-1197)
        free_soft = act * s.soft * (1.0 - s.sfix)
        rho_w = _side_weights(s)
        d_slack = s.act_lo * s.sw_dls - s.act_up * s.sw_dus
    lam_star, u2, okl = s.lam_star, s.u, is_opt
    for _ in range(refine_steps):
        r = torch.einsum('bij,bj->bi', s.M, u2) - d_W
        if has_sw:
            r = (r - free_soft * rho_w * (lam_star + d_slack)) * act
        else:
            r = (r - st.rho_soft * s.soft * lam_star) * act
        dlam = torch.einsum('bij,bj->bi', s.E, r)
        okl = okl & torch.isfinite(dlam).all(dim=1)
        dlam = torch.where(okl[:, None], dlam * act, 0.0)
        lam_star = lam_star + dlam
        u2 = u2 - torch.einsum('bij,bi->bj', s.M, dlam)
    lam_star = torch.where(okl[:, None], lam_star, s.lam_star)
    u2 = torch.where(okl[:, None], u2, s.u)
    if has_sw:
        slack2 = (s.soft * act * rho_w * lam_star * lam_star).sum(1)
    else:
        slack2 = st.rho_soft * (s.soft * act * lam_star * lam_star).sum(1)
    fv2 = (u2 * u2).sum(1) + slack2
    mu = torch.einsum('bij,bj->bi', s.M, u2)
    blocked = (act > 0) | (s.immut > 0)
    viol = (((s.dupper - mu) < -st.primal_tol * s.scaling)
            | ((mu - s.dlower) < -st.primal_tol * s.scaling)) & ~blocked
    up_bad = (lam_star < -st.dual_tol).to(act.dtype)
    lo_bad = (lam_star > st.dual_tol).to(act.dtype)
    bad_rows = (s.act_lo * lo_bad + s.act_up * up_bad) * (1.0 - s.immut)
    if has_sw:
        # soft rows follow the slack-bound rules, not the sign convention
        bad_rows = bad_rows * (1.0 - s.soft)
    dual_bad = (bad_rows > 0).any(dim=1)
    reopen = okl & (viol.any(dim=1) | dual_bad)
    return s._replace(
        lam_star=lam_star.contiguous(), u=u2.contiguous(),
        fval=torch.where(okl, fv2, s.fval),
        status=torch.where(reopen, EXIT_RUNNING, s.status).to(torch.int32))


def dense_solve(s: DenseState, st: Settings, n_true: int,
                steps: int = STEPS, max_rounds: int = MAX_ROUNDS,
                deadline=None) -> DenseState:
    """Kernel rounds until every lane is terminal, exact repair between
    rounds where a lane needs it, two polish / re-open cycles, one more
    polish whose re-opened lanes exit loud, then ITERLIMIT (iterations
    spent) or CYCLE for a lane still running.  The rounds take B7's soft
    variant, as every caller of the JAX ``dense_solve`` does.

    ``iter_limit`` (capped at ``steps * max_rounds``) and the round budget
    act per lane, as in ``slot.slot_solve``: a lane at either limit is
    held out of further rounds.  The last polish is the fix of the slot
    tier's ROADMAP Queue C fault, which the JAX ``dense_solve`` shares
    (pallas_batch.py:1300-1303): without it a lane re-opened by the
    second polish ends on unrefined kernel steps and may exit OPTIMAL with
    its active rows not met.  ``deadline`` is checked before the first
    round and after each one (``ops.check_deadline``,
    pallas_batch.py:1267-1295)."""
    iter_limit = float(torch.tensor(min(float(st.iter_limit),
                                        float(steps * max_rounds)),
                                    dtype=torch.float32))
    lane_rounds = torch.zeros_like(s.iterations)
    if host_any(repair_needed(s)):
        s = exact_repair(s, st)
    s = check_deadline(s, deadline)

    def rounds(s, lane_rounds):
        while True:
            running = s.status == EXIT_RUNNING
            live = running & (s.iterations < iter_limit) \
                & (lane_rounds < max_rounds)
            if not host_any(live):
                return s, lane_rounds
            held = running & ~live
            s = s._replace(status=torch.where(held, _HELD, s.status)
                           .to(torch.int32))
            s = run_kernel_round(s, st, n_true, steps, has_soft=True)
            s = s._replace(status=torch.where(held, EXIT_RUNNING, s.status)
                           .to(torch.int32))
            lane_rounds = lane_rounds + live.to(lane_rounds.dtype)
            if host_any(repair_needed(s)):
                s = exact_repair(s, st)
            s = check_deadline(s, deadline)

    s, lane_rounds = rounds(s, lane_rounds)
    for _ in range(2):
        s = polish(s, st)
        s, lane_rounds = rounds(s, lane_rounds)
    s = polish(s, st)

    done_running = (s.status == EXIT_RUNNING) | (s.status == EXIT_REFACTOR)
    status = torch.where(done_running & (s.iterations >= iter_limit),
                         EXIT_ITERLIMIT,
                         torch.where(done_running, EXIT_CYCLE, s.status))
    return s._replace(status=status.to(torch.int32))


def dense_add_row(s: DenseState, i: int, lo, lam_seed, mask,
                  st: Settings, n_true: int):
    """Bordered addition of row ``i`` into E on the lanes where ``mask``
    (B,) holds, outside the kernel: the hierarchical tier's reactivation
    step (hierarchical.c:86-95).  ``lo`` / ``lam_seed`` (B,) give the side
    and the seed dual.  Returns ``(state, ok)``, ``ok`` (B,) 0/1 flagging
    an applied add; a singular one is skipped."""
    act = s.act_up + s.act_lo
    mj = s.M[:, i, :]                                        # (B, n)
    g = torch.einsum('bij,bj->bi', s.M, mj) * act
    a = torch.einsum('bij,bj->bi', s.E, g)
    soft_r = s.soft[:, i]
    rho = st.rho_soft
    dii = (mj * mj).sum(1) + rho * soft_r
    sval = dii - (g * a).sum(1)
    gate = _gate(dii, st, True)
    ns_act = (act * s.soft).sum(1) + soft_r
    ok = mask * (sval >= gate).to(act.dtype) \
        * (act.sum(1) < n_true + ns_act).to(act.dtype)
    oh = torch.zeros_like(act)
    oh[:, i] = 1.0
    w = a * act - oh
    c = ok / torch.where(sval != 0, sval, 1.0)
    add = ok[:, None] * oh
    return s._replace(
        E=s.E + c[:, None, None] * w[:, :, None] * w[:, None, :],
        act_up=torch.clamp(s.act_up + add * (1.0 - lo[:, None]), max=1.0),
        act_lo=torch.clamp(s.act_lo + add * lo[:, None], max=1.0),
        lam=s.lam + add * lam_seed[:, None]), ok


def dense_reactivate(s: DenseState, st: Settings, n_true: int, start: int):
    """Rebuild E from the act masks by sequential masked re-adds in row
    order, dropping entries that became linearly dependent: the batched
    form of the post-hardening reactivation (hierarchical.c:72-95).

    Returns ``(state, n_imm)``, ``n_imm`` (B,) counting IMMUTABLE rows at
    or after ``start`` that were re-added (the degrees-of-freedom
    decrement, hierarchical.c:94)."""
    up0, lo0, lam0 = s.act_up, s.act_lo, s.lam_star
    m = s.M.shape[1]
    s = s._replace(E=torch.zeros_like(s.E), act_up=torch.zeros_like(up0),
                   act_lo=torch.zeros_like(lo0), lam=torch.zeros_like(s.lam))
    n_imm = torch.zeros_like(s.fval)
    for i in range(m):
        s, ok = dense_add_row(s, i, lo0[:, i], lam0[:, i],
                              up0[:, i] + lo0[:, i], st, n_true)
        if i >= start:
            n_imm = n_imm + ok * s.immut[:, i]
    return s._replace(E=s.E.contiguous()), n_imm
