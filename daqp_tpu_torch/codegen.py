"""Embedded code generation: one QP rendered into standalone C.

Counterpart of ``daqp_tpu/codegen.py``'s ``render_c`` (the reference's
``render_daqp_workspace``, codegen/codegen.c:11-82): a self-contained,
malloc-free C99 file and header holding the problem's LDP data (M, Rinv,
scaling, d, v, sense) as static arrays and the explicit-inverse dual
active-set solver, with ``<name>_solve_miqp`` when rows are BINARY and
``<name>_solve_hier`` when ``break_points`` are given.  The C templates
and the writing are the JAX module's, copied (they use numpy and text
only); the LDP data is built by the port's own transform, in f64 on the
CPU.

``export_aot`` is the counterpart of the JAX module's AOT export
(``daqp_tpu/codegen.py:857``, serialized StableHLO of a jitted solver):
the flat tier for fixed dimensions traced by ``torch.export`` into one
``ExportedProgram``, returned as the bytes of ``torch.export.save``.  The
host loops run in their graph forms (``batch.solve_flat_graph``: the
retries masked, the activation and the rounds as ``while_loop`` s), and
K1 and B10 are the registered ops
``daqp_tpu_torch::chol_rinv`` / ``::chol_rinv_blk``.  A program loads
without re-tracing any Python::

    import io, torch, daqp_tpu_torch          # registers the two ops
    prog = torch.export.load(io.BytesIO(blob)).module()
    out = prog(H, f, A, bupper, blower, sense)    # a dict of tensors

on the device it was exported on.
"""
from __future__ import annotations

import os
import textwrap

import numpy as np
import torch

from . import core
from .types import BINARY, as_settings


def _carr(name, arr, const=True, dtype="double"):
    arr = np.asarray(arr)
    flat = arr.reshape(-1)
    if dtype == "int":
        body = ",".join(str(int(v)) for v in flat)
    else:
        body = ",".join(f"{float(v):.17g}" for v in flat)
    qual = "static const" if const else "static"
    return f"{qual} {dtype} {name}[{max(flat.size, 1)}] = {{{body}}};"


_C_CORE = r"""
/* --- embedded dual active-set LDP solver (explicit inverse form) ---------
 * Solves  min 0.5 x'Hx + f'x  s.t. bl <= [x[:MS]; A x] <= bu  via the
 * least-distance transform prepared offline:  M u in [dl, du],
 * x = Rinv (u - v).  Working-set Gram inverse E is maintained by
 * bordered addition / deletion rank-one updates.  Malloc-free.
 */
#include <math.h>

#define PNAME_N     @n@
#define PNAME_M     @m@
#define PNAME_K     @K@
#define PNAME_NB    @nb@
#define PNAME_INF   1e30

@data_arrays@

static double PNAME_dupper[PNAME_M];
static double PNAME_dlower[PNAME_M];
static double PNAME_v[PNAME_N];
static int    PNAME_sense[PNAME_M];

/* workspace */
static double E[PNAME_K * PNAME_K];
static double Mw[PNAME_K * PNAME_N];
static double lam[PNAME_K];
static double lam_star[PNAME_K];
static int    WS[PNAME_K];
static double u_vec[PNAME_N];
static int    n_active = 0;
static int    ns_active = 0;        /* active soft count (api.c:288-305) */
static int    sing_flag = 0;
static double sing_dir[PNAME_K];
static double last_fv = 0.0;        /* LDP-space fval of the last point */
static double last_ss = 0.0;        /* soft_slack of the last point */
static int    m_price = PNAME_M;    /* pricing horizon (hierarchy levels) */

static double ptol       = @primal_tol@;
static double dtol       = @dual_tol@;
static double stol       = @sing_tol@;
static double rho_soft   = @rho_soft@;
static double prog_tol   = @progress_tol@;
static double pivot_tol  = @pivot_tol@;
static double rftol      = @refactor_tol@;
static double fval_bound = @fval_bound@;
static int    cyc_tol    = @cycle_tol@;
static int    iter_limit = @iter_limit@;

void PNAME_settings(double primal_tol_, double dual_tol_, int iter_limit_)
{
    ptol = primal_tol_; dual_tol_ = dual_tol_ > 0 ? dual_tol_ : dtol;
    dtol = dual_tol_; iter_limit = iter_limit_;
}

/* v/d-only re-update for MPC loops: f and bounds change, factorization,
 * working set and E persist (reference mask UPDATE_v|UPDATE_d). */
void PNAME_update(const double *f, const double *bupper,
                  const double *blower)
{
    int i, j;
    for (i = 0; i < PNAME_N; i++) {
        double s = 0.0;
        for (j = 0; j < PNAME_N; j++)
            s += PNAME_Rinv[j * PNAME_N + i] * f[j];  /* v = Rinv' f */
        PNAME_v[i] = s;
    }
    for (i = 0; i < PNAME_M; i++) {
        double mv = 0.0;
        for (j = 0; j < PNAME_N; j++)
            mv += PNAME_Mmat[i * PNAME_N + j] * PNAME_v[j];
        PNAME_dupper[i] = bupper[i] * PNAME_scaling[i] + mv;
        PNAME_dlower[i] = blower[i] * PNAME_scaling[i] + mv;
    }
}

static void reset_ws(void)
{
    int i;
    n_active = 0; ns_active = 0; sing_flag = 0;
    for (i = 0; i < PNAME_K * PNAME_K; i++) E[i] = 0.0;
    for (i = 0; i < PNAME_M; i++) PNAME_sense[i] &= ~1;
}

/* bordered-inverse addition; returns 0 ok, 1 singular (entry appended,
 * flagged — the 'parked' state of factorization.c:92-97) */
static int add_constraint(int id, double lam0)
{
    int i, j, k = n_active;
    int is_soft = (PNAME_sense[id] & 8) != 0;
    double g[PNAME_K], a[PNAME_K], dii = 0.0, sval;
    const double *mi = &PNAME_Mmat[id * PNAME_N];
    for (i = 0; i < PNAME_N; i++) dii += mi[i] * mi[i];
    if (is_soft) dii += rho_soft;   /* factorization.c:31-40 */
    for (i = 0; i < k; i++) {
        double s = 0.0;
        for (j = 0; j < PNAME_N; j++) s += Mw[i * PNAME_N + j] * mi[j];
        g[i] = s;
    }
    for (i = 0; i < k; i++) {
        double s = 0.0;
        for (j = 0; j < k; j++) s += E[i * PNAME_K + j] * g[j];
        a[i] = s;
    }
    sval = dii;
    for (i = 0; i < k; i++) sval -= g[i] * a[i];

    WS[k] = id; lam[k] = lam0;
    for (i = 0; i < PNAME_N; i++) Mw[k * PNAME_N + i] = mi[i];
    PNAME_sense[id] |= 1;
    n_active = k + 1;
    ns_active += is_soft;
    /* k >= PNAME_K - 1 is the defensive full-table backstop (soft adds
     * move the rank cap with ns_active, so the table itself must bound
     * the append; mirrors the JAX/flat capacity guard) */
    if (sval < stol || k >= PNAME_N + ns_active || k >= PNAME_K - 1) {
        for (i = 0; i < k; i++) sing_dir[i] = -a[i];
        sing_dir[k] = 1.0;
        if (PNAME_sense[id] & 2)
            for (i = 0; i <= k; i++) sing_dir[i] = -sing_dir[i];
        sing_flag = 1;
        return 1;
    }
    for (i = 0; i < k; i++) {      /* E += w w'/s, w = [a; -1] */
        for (j = 0; j < k; j++)
            E[i * PNAME_K + j] += a[i] * a[j] / sval;
        E[i * PNAME_K + k] = -a[i] / sval;
        E[k * PNAME_K + i] = -a[i] / sval;
    }
    E[k * PNAME_K + k] = 1.0 / sval;
    sing_flag = 0;
    return 0;
}

static void remove_constraint(int pos)
{
    int i, j, k = n_active;
    int was_sing = sing_flag;
    int k_ns = k - (was_sing ? 1 : 0);
    ns_active -= (PNAME_sense[WS[pos]] & 8) != 0;
    PNAME_sense[WS[pos]] &= ~1;
    if (pos < k_ns) {             /* deletion-inverse update */
        double e_[PNAME_K], err = E[pos * PNAME_K + pos];
        for (i = 0; i < k_ns; i++) e_[i] = E[i * PNAME_K + pos];
        for (i = 0; i < k_ns; i++)
            for (j = 0; j < k_ns; j++)
                E[i * PNAME_K + j] -= e_[i] * e_[j] / err;
        for (i = pos; i < k_ns - 1; i++)       /* compact rows/cols */
            for (j = 0; j < k_ns; j++)
                E[i * PNAME_K + j] = E[(i + 1) * PNAME_K + j];
        for (j = pos; j < k_ns - 1; j++)
            for (i = 0; i < k_ns; i++)
                E[i * PNAME_K + j] = E[i * PNAME_K + (j + 1)];
    }
    for (i = pos; i < k - 1; i++) {
        WS[i] = WS[i + 1]; lam[i] = lam[i + 1];
        for (j = 0; j < PNAME_N; j++)
            Mw[i * PNAME_N + j] = Mw[(i + 1) * PNAME_N + j];
    }
    n_active = k - 1;
    sing_flag = 0;
    if (was_sing && pos < k - 1) { /* re-add the parked singular entry */
        int last = n_active - 1;
        int id2 = WS[last]; double l2 = lam[last];
        n_active = last;
        ns_active -= (PNAME_sense[id2] & 8) != 0;
        PNAME_sense[id2] &= ~1;
        add_constraint(id2, l2);
    }
}

/* rebuild E from scratch for the current working set (the repair
 * refactorization, daqp.c:32-46 / :66-85) */
static void refactor_ws(void)
{
    int i, k = n_active;
    int ids[PNAME_K]; double lams[PNAME_K];
    for (i = 0; i < k; i++) { ids[i] = WS[i]; lams[i] = lam[i]; }
    n_active = 0; ns_active = 0; sing_flag = 0;
    for (i = 0; i < PNAME_K * PNAME_K; i++) E[i] = 0.0;
    for (i = 0; i < k; i++) PNAME_sense[ids[i]] &= ~1;
    for (i = 0; i < k && !sing_flag; i++) add_constraint(ids[i], lams[i]);
}

/* correct LOWER/UPPER from the sign of lam before a repair refactor
 * (daqp.c:37-42) */
static void fix_senses_from_lam(void)
{
    int i;
    for (i = 0; i < n_active; i++) {
        if (PNAME_sense[WS[i]] & 4) continue;
        if (lam[i] < 0) PNAME_sense[WS[i]] |= 2;
        else PNAME_sense[WS[i]] &= ~2;
    }
}

/* one iterative-refinement step of lam* against the true working-set
 * Gram (daqp_refine_active, auxiliary.c:497-588) */
static void refine_active(void)
{
    int i, j, l, k = n_active;
    double r[PNAME_K];
    for (i = 0; i < k; i++) {
        double acc = (PNAME_sense[WS[i]] & 2) ? PNAME_dlower[WS[i]]
                                              : PNAME_dupper[WS[i]];
        for (j = 0; j < k; j++) {
            double g = 0.0;
            for (l = 0; l < PNAME_N; l++)
                g += Mw[i * PNAME_N + l] * Mw[j * PNAME_N + l];
            if (i == j && (PNAME_sense[WS[i]] & 8)) g += rho_soft;
            acc += g * lam_star[j];
        }
        r[i] = -acc;               /* residual of  G lam* = -d_W */
    }
    for (i = 0; i < k; i++) {
        double corr = 0.0;
        for (j = 0; j < k; j++) corr += E[i * PNAME_K + j] * r[j];
        sing_dir[i] = corr;        /* scratch */
    }
    for (i = 0; i < k; i++) lam_star[i] += sing_dir[i];
}

/* u = -Mw' lam*; LDP fval = ||u||^2 + rho_soft sum lam*_soft^2
 * (daqp_compute_primal_and_fval, auxiliary.c:46-87) */
static void compute_u(void)
{
    int i, j, k = n_active;
    for (j = 0; j < PNAME_N; j++) u_vec[j] = 0.0;
    for (i = 0; i < k; i++)
        for (j = 0; j < PNAME_N; j++)
            u_vec[j] -= Mw[i * PNAME_N + j] * lam_star[i];
    last_ss = 0.0;
    for (i = 0; i < k; i++)
        if (PNAME_sense[WS[i]] & 8)
            last_ss += lam_star[i] * lam_star[i];
    last_ss *= rho_soft;
    last_fv = last_ss;
    for (j = 0; j < PNAME_N; j++) last_fv += u_vec[j] * u_vec[j];
}

static int in_ws(int id)
{
    int i;
    for (i = 0; i < n_active; i++) if (WS[i] == id) return 1;
    return 0;
}

/* Dantzig pricing over rows below the horizon: most-violated inactive
 * mutable row, or -1 when primal feasible (daqp_add_infeasible,
 * auxiliary.c:88-166) */
static int price_worst(int *blower)
{
    int i, j, jbest = -1;
    double worst = 0.0;
    for (i = 0; i < m_price; i++) {
        double mu = 0.0, vu, vl;
        if (PNAME_sense[i] & (1 | 4)) continue;
        for (j = 0; j < PNAME_N; j++)
            mu += PNAME_Mmat[i * PNAME_N + j] * u_vec[j];
        vu = PNAME_dupper[i] - mu;
        vl = mu - PNAME_dlower[i];
        if (vu < -ptol * PNAME_scaling[i] && vu < worst) {
            worst = vu; jbest = i; *blower = 0;
        } else if (vl < -ptol * PNAME_scaling[i] && vl < worst) {
            worst = vl; jbest = i; *blower = 1;
        }
    }
    return jbest;
}

/* activate rows in [start, end) flagged ACTIVE that are not yet in the
 * working set (warm starts and equalities; daqp_activate_constraints,
 * auxiliary.c:398-478).  Dependent mutable rows are dropped back to
 * inactive; dependent immutable rows must be rhs-consistent or the
 * working set is overdetermined (returns -6). */
static int activate_warm(int start, int end)
{
    int i, j;
    for (i = start; i < end; i++) {
        if (!(PNAME_sense[i] & 1) || in_ws(i)) continue;
        PNAME_sense[i] &= ~1;
        add_constraint(i, (PNAME_sense[i] & 2) ? -1.0 : 1.0);
        if (sing_flag) {
            if (PNAME_sense[i] & 4) {
                /* redundant equality: consistent iff the null combination
                 * also annihilates the rhs (auxiliary.c:446-469) */
                double viol = 0.0;
                for (j = 0; j < n_active; j++) {
                    int id2 = WS[j];
                    viol += sing_dir[j] * ((PNAME_sense[id2] & 2)
                            ? PNAME_dlower[id2] : PNAME_dupper[id2]);
                }
                if (fabs(viol) > ptol) return -6;
            }
            n_active--; sing_flag = 0;
            ns_active -= (PNAME_sense[i] & 8) != 0;
            PNAME_sense[i] &= ~1;   /* back into pricing */
        }
    }
    return 0;
}

/* the core LDP active-set loop on the current workspace (daqp_ldp,
 * daqp.c:6-108), with the dual objective bound cut, cycling guard with
 * one-shot repair, ill-conditioning refactorization and iterative
 * refinement.  Returns an exit flag; leaves u_vec/lam_star/last_fv set. */
static int solve_inner(int *iters)
{
    int it, i, j;
    double best_fv = -PNAME_INF;
    int cycle_ct = 0, tried_repair = 0;
    for (it = 0; it < iter_limit; it++) {
        int k = n_active, rm = -1;
        double amin = PNAME_INF;
        if (!sing_flag) {          /* CSP: lam* = -E d_W */
            for (i = 0; i < k; i++) {
                double d = (PNAME_sense[WS[i]] & 2) ?
                    PNAME_dlower[WS[i]] : PNAME_dupper[WS[i]];
                lam_star[i] = d;
            }
            for (i = 0; i < k; i++) {
                double s = 0.0;
                for (j = 0; j < k; j++)
                    s += E[i * PNAME_K + j] * lam_star[j];
                sing_dir[i] = -s;   /* scratch */
            }
            for (i = 0; i < k; i++) lam_star[i] = sing_dir[i];
        }
        /* blocking min-ratio over dual-infeasible entries
         * (daqp_remove_blocking, auxiliary.c:276-311) */
        for (i = 0; i < k; i++) {
            double dir = sing_flag ? sing_dir[i] : lam_star[i];
            double del = sing_flag ? sing_dir[i] : lam_star[i] - lam[i];
            int lower = PNAME_sense[WS[i]] & 2;
            if (PNAME_sense[WS[i]] & 4) continue;
            if ((lower && dir > dtol) || (!lower && dir < -dtol)) {
                /* an eligible (dual-infeasible) entry must always be a
                 * candidate; del ~ 0 / negative ratios clamp to a
                 * zero-step removal (auxiliary.c:283-287 exit gate) */
                double r = (del != 0.0) ? -lam[i] / del : 0.0;
                if (r < 0.0) r = 0.0;
                if (r < amin) { amin = r; rm = i; }
            }
        }
        if (rm >= 0) {
            for (i = 0; i < k; i++)
                lam[i] += amin * (sing_flag ? sing_dir[i]
                                            : lam_star[i] - lam[i]);
            remove_constraint(rm);
            continue;
        }
        if (sing_flag) { *iters = it + 1; return -1; }  /* infeasible */

        compute_u();
        if (last_fv > fval_bound) {    /* dominance cut, daqp.c:20-23 */
            *iters = it + 1; return -1;
        }

        /* cycling guard with one-shot reorder+refactor repair
         * (daqp.c:66-85) */
        if (last_fv - best_fv < prog_tol * (1.0 + fabs(last_fv))) {
            if (++cycle_ct > cyc_tol) {
                if (tried_repair) { *iters = it + 1; return -2; }
                tried_repair = 1; cycle_ct = 0;
                fix_senses_from_lam();
                refactor_ws();
                continue;
            }
        } else { cycle_ct = 0; best_fv = last_fv; }

        /* price all rows below the horizon */
        {
            int blower = 0, jbest = price_worst(&blower);
            if (jbest < 0) {       /* optimal path (daqp.c:28-63) */
                double max_diag = 0.0;
                for (i = 0; i < k; i++)
                    if (E[i * PNAME_K + i] > max_diag)
                        max_diag = E[i * PNAME_K + i];
                if (k > 0 && max_diag * rftol > 1.0 && !tried_repair) {
                    tried_repair = 1;        /* ill-conditioned: repair */
                    fix_senses_from_lam();
                    refactor_ws();
                    continue;
                }
                if (k > 0 && max_diag * pivot_tol > 1.0) {
                    refine_active();
                    compute_u();
                    /* re-price the refined iterate: the reference only
                     * declares optimality when NO violation remains after
                     * refinement (daqp.c:52-56 re-enters the loop) */
                    jbest = price_worst(&blower);
                }
                if (jbest < 0) {
                    for (i = 0; i < k; i++) lam[i] = lam_star[i];
                    *iters = it + 1;
                    return last_ss > ptol ? 2 : 1;   /* daqp.c:59-62 */
                }
            }
            for (i = 0; i < k; i++) lam[i] = lam_star[i];
            if (blower) PNAME_sense[jbest] |= 2;
            else PNAME_sense[jbest] &= ~2;
            add_constraint(jbest, blower ? -1.0 : 1.0);
        }
    }
    *iters = iter_limit;
    return -4;
}

/* x = Rinv (u - v); QP fval = 0.5 (fval_ldp - ||v||^2) (daqp.c:111-139,
 * api.c:457-461); duals rescaled by the row normalization */
static void extract_sol(double *x, double *lam_out, double *fval)
{
    int i, j;
    double fv = last_fv;
    for (j = 0; j < PNAME_N; j++) {
        double s = 0.0;
        for (i = 0; i < PNAME_N; i++)
            s += PNAME_Rinv[j * PNAME_N + i] * (u_vec[i] - PNAME_v[i]);
        x[j] = s;
        fv -= PNAME_v[j] * PNAME_v[j];
    }
    *fval = 0.5 * fv;
    if (lam_out) {
        for (i = 0; i < PNAME_M; i++) lam_out[i] = 0.0;
        for (i = 0; i < n_active; i++)
            lam_out[WS[i]] = lam_star[i] * PNAME_scaling[WS[i]];
    }
}

int PNAME_solve(double *x, double *lam_out, double *fval, int *iters)
{
    int flag = activate_warm(0, PNAME_M);
    if (flag < 0) { *iters = 0; return flag; }
    flag = solve_inner(iters);
    if (flag > 0) extract_sol(x, lam_out, fval);
    return flag;
}

void PNAME_reset(void) { reset_ws(); }

/* one-time static init of the mutable problem vectors */
void PNAME_init(void)
{
    int i;
    for (i = 0; i < PNAME_M; i++) {
        PNAME_dupper[i] = PNAME_dupper0[i];
        PNAME_dlower[i] = PNAME_dlower0[i];
        PNAME_sense[i] = PNAME_sense0[i];
    }
    for (i = 0; i < PNAME_N; i++) PNAME_v[i] = PNAME_v0[i];
    reset_ws();
    /* restore warm/equality ACTIVE bits cleared by the reset */
    for (i = 0; i < PNAME_M; i++)
        PNAME_sense[i] |= PNAME_sense0[i] & 1;
    m_price = PNAME_M;
    fval_bound = @fval_bound@;
}
"""

_C_BNB = r"""
/* --- embedded branch-and-bound MIQP over the baked BINARY rows ---------
 * DFS with midpoint branching, nearest endpoint explored first, and the
 * incumbent dominance bound threaded through the dual objective cut
 * (bnb.c:23-156 semantics; nodes are rebuilt cold — the embedded
 * analogue of tree_WS replay). */
int PNAME_solve_miqp(double *x, double *lam_out, double *fval,
                     int *iters, int *nodes)
{
    int stack_id[2 * PNAME_NB + 2], stack_side[2 * PNAME_NB + 2],
        stack_depth[2 * PNAME_NB + 2];
    int path_id[PNAME_NB + 1], path_side[PNAME_NB + 1];
    int n_nodes = 1, total_iters = 0, total_nodes = 0, have_inc = 0;
    int i, l, inc_k = 0;
    double inc_u[PNAME_N], inc_lam[PNAME_K], inc_ss = 0.0;
    int inc_ws[PNAME_K];
    double bound_save = fval_bound;
    stack_id[0] = -1; stack_side[0] = 0; stack_depth[0] = 0;
    while (n_nodes > 0) {
        int bid, side, d, ok = 1, flag, it2 = 0;
        n_nodes--;
        bid = stack_id[n_nodes]; side = stack_side[n_nodes];
        d = stack_depth[n_nodes];
        if (bid >= 0) { path_id[d - 1] = bid; path_side[d - 1] = side; }
        /* cold rebuild of the node workspace: fix the path binaries as
         * immutable equalities (daqp_process_node, bnb.c:92-128) */
        reset_ws();
        for (i = 0; i < PNAME_NB; i++)
            PNAME_sense[PNAME_bin_ids[i]] &= ~4;
        for (i = 0; i < d; i++) {
            int b = path_id[i];
            if (path_side[i]) PNAME_sense[b] |= 2;
            else PNAME_sense[b] &= ~2;
            add_constraint(b, path_side[i] ? -1.0 : 1.0);
            PNAME_sense[b] |= 4;
            if (sing_flag) { ok = 0; break; }
        }
        total_nodes++;
        if (!ok) continue;                  /* dependent fixing: prune */
        flag = solve_inner(&it2);
        total_iters += it2;
        if (flag < 0) continue;             /* infeasible/dominated */
        /* branch on the free binary closest to its bound midpoint,
         * nearest endpoint first (daqp_get_branch_id, bnb.c:130-156) */
        {
            int jb = -1, near_lower = 0, side_first;
            double bestdist = PNAME_INF;
            for (i = 0; i < PNAME_NB; i++) {
                int b = PNAME_bin_ids[i];
                double mu = 0.0, mid;
                if (PNAME_sense[b] & 4) continue;
                for (l = 0; l < PNAME_N; l++)
                    mu += PNAME_Mmat[b * PNAME_N + l] * u_vec[l];
                if (PNAME_dupper[b] - mu < ptol ||
                    mu - PNAME_dlower[b] < ptol)
                    continue;       /* already at an endpoint */
                mid = 0.5 * (PNAME_dupper[b] + PNAME_dlower[b]);
                if (fabs(mu - mid) < bestdist) {
                    bestdist = fabs(mu - mid);
                    jb = b; near_lower = (mu < mid);
                }
            }
            if (jb < 0) {           /* integer feasible: new incumbent */
                if (last_fv < fval_bound) {
                    fval_bound = last_fv; have_inc = 1; inc_ss = last_ss;
                    for (i = 0; i < PNAME_N; i++) inc_u[i] = u_vec[i];
                    inc_k = n_active;
                    for (i = 0; i < inc_k; i++) {
                        inc_ws[i] = WS[i]; inc_lam[i] = lam_star[i];
                    }
                }
                continue;
            }
            if (d >= PNAME_NB) continue;
            side_first = near_lower ? 1 : 0;
            stack_id[n_nodes] = jb; stack_side[n_nodes] = 1 - side_first;
            stack_depth[n_nodes] = d + 1; n_nodes++;    /* far endpoint */
            stack_id[n_nodes] = jb; stack_side[n_nodes] = side_first;
            stack_depth[n_nodes] = d + 1; n_nodes++;    /* near: pops 1st */
        }
    }
    /* clear the path IMMUTABLE bits so a later PNAME_solve /
     * PNAME_update without PNAME_init does not silently skip the last
     * explored node's binary rows in pricing (reset_ws only clears
     * ACTIVE) */
    for (i = 0; i < PNAME_NB; i++)
        PNAME_sense[PNAME_bin_ids[i]] &= ~4;
    *iters = total_iters;
    if (nodes) *nodes = total_nodes;
    if (!have_inc) { fval_bound = bound_save; reset_ws(); return -1; }
    /* restore the incumbent and extract */
    for (i = 0; i < PNAME_N; i++) u_vec[i] = inc_u[i];
    last_fv = inc_ss; last_ss = inc_ss;
    for (i = 0; i < PNAME_N; i++) last_fv += inc_u[i] * inc_u[i];
    n_active = inc_k;
    for (i = 0; i < inc_k; i++) { WS[i] = inc_ws[i]; lam_star[i] = inc_lam[i]; }
    fval_bound = bound_save;
    extract_sol(x, lam_out, fval);
    /* E/Mw still belong to the LAST EXPLORED node, not the restored
     * incumbent working set — leave the workspace reset with the
     * incumbent re-flagged as a warm start so subsequent entry points
     * rebuild a consistent factorization */
    reset_ws();
    for (i = 0; i < inc_k; i++) {
        PNAME_sense[inc_ws[i]] |= 1;
        if (inc_lam[i] < 0) PNAME_sense[inc_ws[i]] |= 2;
        else PNAME_sense[inc_ws[i]] &= ~2;
    }
    return 1;
}
"""

_C_HIER = r"""
#define PNAME_NH @nh@
@break_points_arr@

/* --- embedded hierarchical (lexicographic least-squares) solve ----------
 * Walks the priority levels: soften the level, solve, freeze the optimal
 * violations into d, harden, reactivate with dependent drops and the
 * degrees-of-freedom counter (daqp_hiqp, hierarchical.c:5-108).  Level
 * slack duals land in lam_out. */
int PNAME_solve_hier(double *x, double *lam_out, double *fval, int *iters)
{
    int lvl, i, j, total_iters = 0, nfree = PNAME_N, flag = 1;
    int start;
    double u_old[PNAME_N];
    if (lam_out) for (i = 0; i < PNAME_M; i++) lam_out[i] = 0.0;
    for (j = 0; j < PNAME_N; j++) u_old[j] = 0.0;
    start = PNAME_break_points[0];
    m_price = start;
    if (activate_warm(0, start) < 0) {
        m_price = PNAME_M; *iters = 0; return -6;
    }
    for (lvl = 1; lvl < PNAME_NH; lvl++) {
        int end = PNAME_break_points[lvl], it2 = 0;
        m_price = end;
        for (j = start; j < end; j++) PNAME_sense[j] |= 8;  /* soften */
        if (activate_warm(start, end) < 0) {
            m_price = PNAME_M; *iters = total_iters; return -6;
        }
        for (j = 0; j < PNAME_N; j++) u_old[j] = u_vec[j];
        flag = solve_inner(&it2);
        total_iters += it2;
        if (flag < 0) break;
        if (total_iters >= iter_limit) { flag = -4; break; }
        /* freeze the optimal level slacks into d (hierarchical.c:51-65) */
        for (j = 0; j < n_active; j++) {
            int id = WS[j];
            if (PNAME_sense[id] & 8) {
                double w = lam_star[j] * rho_soft;
                if (w < -ptol) PNAME_dlower[id] += w;
                else if (w > ptol) PNAME_dupper[id] += w;
                if (lam_out)
                    lam_out[id] = w +
                        ((PNAME_sense[id] & 2) ? -1e-14 : 1e-14);
            }
        }
        for (j = start; j < end; j++) PNAME_sense[j] &= ~8; /* harden */
        if (lvl == PNAME_NH - 1) break;
        /* reactivate: rebuild the working set now that the level is hard,
         * dropping dependents, counting immutable DOF (hierarchical.c:
         * 72-95; the explicit inverse has no reusable prefix, so the
         * rebuild is full — identical math) */
        {
            int n_old = n_active < PNAME_N ? n_active : PNAME_N;
            int j0, kk;
            int ids[PNAME_K]; double lams[PNAME_K];
            for (kk = n_old; kk < n_active; kk++)
                PNAME_sense[WS[kk]] &= ~(1 | 4);  /* overdetermined tail */
            for (j0 = 0; j0 < n_old; j0++) if (WS[j0] >= start) break;
            for (kk = 0; kk < n_old; kk++) {
                ids[kk] = WS[kk]; lams[kk] = lam_star[kk];
            }
            n_active = 0; ns_active = 0; sing_flag = 0;
            for (i = 0; i < PNAME_K * PNAME_K; i++) E[i] = 0.0;
            for (kk = 0; kk < n_old; kk++) PNAME_sense[ids[kk]] &= ~1;
            for (kk = 0; kk < n_old; kk++) {
                add_constraint(ids[kk], lams[kk]);
                if (sing_flag) {        /* dependent: drop, make mutable */
                    n_active--; sing_flag = 0;
                    ns_active -= (PNAME_sense[ids[kk]] & 8) != 0;
                    PNAME_sense[ids[kk]] &= ~(1 | 4);
                } else if (kk >= j0 && (PNAME_sense[ids[kk]] & 4))
                    nfree--;
            }
        }
        if (nfree <= 0) break;          /* no degrees of freedom left */
        start = end;
    }
    m_price = PNAME_M;
    *iters = total_iters > 0 ? total_iters : 1;
    if (flag < 0) {
        /* restore the last good point; 3 = no DOF (hierarchical.c:104) */
        for (j = 0; j < PNAME_N; j++) u_vec[j] = u_old[j];
        last_fv = 0.0; last_ss = 0.0;
        for (j = 0; j < PNAME_N; j++) last_fv += u_vec[j] * u_vec[j];
        extract_sol(x, (double *)0, fval);
        return 3;
    }
    extract_sol(x, (double *)0, fval);  /* duals are the level slacks */
    return flag;
}
"""



def _f64(x):
    return None if x is None \
        else torch.as_tensor(x).detach().cpu().to(torch.float64)


def render_c(H, f, A, bupper, blower, name="daqp_embedded", dir=".",
             sense=None, ms=0, settings=None, break_points=None):
    """Emit ``<dir>/<name>.c`` and ``<dir>/<name>.h``: a standalone
    malloc-free C solver with the QP -> LDP transform baked in as static
    data (reference ``render_daqp_workspace``, codegen/codegen.c:11-82),
    the LDP built by ``core.build_ldp`` in f64 on the CPU whatever the
    inputs' device and type.

    Rows flagged BINARY in ``sense`` are rendered into an embedded
    branch-and-bound ``<name>_solve_miqp``; a ``break_points`` tuple
    renders an embedded hierarchical ``<name>_solve_hier`` (the reference
    compiles bnb.c / hierarchical.c into the generated workspace,
    codegen/codegen.c:146-231).

    Returns the path of the generated .c file.
    """
    st = as_settings(settings, torch.float64)
    Ht, ft, At, bu, bl = (_f64(x) for x in (H, f, A, bupper, blower))
    se = torch.zeros(bu.shape, dtype=torch.int32) if sense is None \
        else torch.as_tensor(sense).cpu().to(torch.int32)
    ldpd = core.build_ldp(Ht, ft, At, bu, bl, se, ms, st)
    M = ldpd.M.numpy()
    m, n = M.shape
    sense_arr = ldpd.sense.numpy()
    bin_ids = np.flatnonzero(sense_arr & BINARY).astype(np.int32)
    nb = int(bin_ids.size)
    ns = int(np.count_nonzero(sense_arr & 8))
    # Soft slacks enlarge the working set (api.c:288-305).  A hierarchical
    # solve softens ENTIRE levels at runtime (_solve_hier), so the table
    # must also hold n + widest-softened-level active rows: static ns
    # alone under-sizes K and add_constraint would write out of bounds
    # (hierarchical.py sizes its table the same way).
    cap = ns
    if break_points is not None:
        bp_sizes = [int(break_points[i]) - int(break_points[i - 1])
                    for i in range(1, len(break_points))]
        cap = ns + max(bp_sizes) if bp_sizes else ns
    K = n + cap + 1

    data = "\n".join([
        _carr("PNAME_Mmat", M),
        _carr("PNAME_Rinv", ldpd.Rinv.numpy()),
        _carr("PNAME_scaling", ldpd.scaling.numpy()),
        _carr("PNAME_dupper0", ldpd.dupper.numpy()),
        _carr("PNAME_dlower0", ldpd.dlower.numpy()),
        _carr("PNAME_v0", ldpd.v.numpy()),
        _carr("PNAME_sense0", sense_arr, dtype="int"),
        _carr("PNAME_bin_ids", bin_ids if nb else np.zeros(1, np.int32),
              dtype="int"),
    ])

    subs = {
        "n": str(n), "m": str(m), "K": str(K), "nb": str(nb),
        "data_arrays": data,
        "primal_tol": f"{float(st.primal_tol):.17g}",
        "dual_tol": f"{float(st.dual_tol):.17g}",
        "sing_tol": f"{float(st.sing_tol):.17g}",
        "rho_soft": f"{float(st.rho_soft):.17g}",
        "progress_tol": f"{float(st.progress_tol):.17g}",
        "pivot_tol": f"{float(st.pivot_tol):.17g}",
        "refactor_tol": f"{float(st.refactor_tol):.17g}",
        "fval_bound": f"{float(st.fval_bound):.17g}",
        "cycle_tol": str(int(st.cycle_tol)),
        "iter_limit": str(int(st.iter_limit)),
    }

    src = _C_CORE
    if nb:
        src += _C_BNB
    if break_points is not None:
        bp = tuple(int(b) for b in break_points)
        if len(bp) < 2 or bp[-1] != m:
            raise ValueError(f"break_points {bp} must end at m = {m}")
        subs["nh"] = str(len(bp))
        subs["break_points_arr"] = _carr(
            "PNAME_break_points", np.asarray(bp, np.int32), dtype="int")
        src += _C_HIER
    for key, val in subs.items():
        src = src.replace(f"@{key}@", val)
    src = src.replace("PNAME", name)

    hdr_extra = ""
    if nb:
        hdr_extra += (f"int {name}_solve_miqp(double *x, double *lam,"
                      f" double *fval, int *iters, int *nodes);\n")
    if break_points is not None:
        hdr_extra += (f"int {name}_solve_hier(double *x, double *lam,"
                      f" double *fval, int *iters);\n")
    hdr = textwrap.dedent(f"""
    #ifndef {name.upper()}_H
    #define {name.upper()}_H
    /* generated by daqp_tpu_torch.codegen.render_c — self-contained embedded
     * QP solver; no dependencies beyond libm. */
    #define {name}_NX {n}
    #define {name}_NCONSTR {m}
    void {name}_init(void);
    void {name}_reset(void);
    void {name}_update(const double *f, const double *bupper,
                       const double *blower);
    void {name}_settings(double primal_tol, double dual_tol,
                         int iter_limit);
    int {name}_solve(double *x, double *lam, double *fval, int *iters);
    {hdr_extra}#endif
    """)

    os.makedirs(dir, exist_ok=True)
    cpath = os.path.join(dir, f"{name}.c")
    with open(cpath, "w") as fh:
        fh.write(src)
    with open(os.path.join(dir, f"{name}.h"), "w") as fh:
        fh.write(hdr)
    return cpath


class _FlatProgram(torch.nn.Module):
    """The graph ``export_aot`` traces: the flat tier on static chunks of
    ``batch.LANE_CHUNK`` lanes (``solve_batch_flat_jit``'s chunks), or on
    one lane unsqueezed in and squeezed out (``single``)."""

    def __init__(self, ms: int, st, K: int, single: bool):
        super().__init__()
        self.ms, self.st, self.K, self.single = ms, st, K, single

    def forward(self, H, f, A, bupper, blower, sense):
        from . import batch
        args = (H, f, A, bupper, blower, sense)
        if self.single:
            args = tuple(x[None] for x in args)
        parts, rounds = [], []
        for c0 in range(0, args[0].shape[0], batch.LANE_CHUNK):
            sl = slice(c0, c0 + batch.LANE_CHUNK)
            r, k = batch.solve_flat_graph(*(x[sl] for x in args), self.ms,
                                          self.st, self.K)
            parts.append(r)
            rounds.append(k)
        out = {k: torch.cat(p) for k, p in zip(
            batch.BatchResult._fields, zip(*parts))}
        out = {k: out[k] for k in ("x", "lam", "fval", "exitflag",
                                   "iterations")}
        if self.single:
            out = {k: v[0] for k, v in out.items()}
        out["rounds"] = torch.stack(rounds).sum()
        return out


def export_aot(n, m, ms=0, batch=None, dtype="float32", settings=None,
               path=None, device=None):
    """AOT-export the solver for fixed dimensions as an ``ExportedProgram``
    (``torch.export``): ``batch=B`` the flat tier of
    ``solve_batch_flat_jit`` on (B, ...) inputs, ``batch=None`` the same
    graph on one QP.  The inputs are (H, f, A, bupper, blower, sense) of
    shapes (n, n), (n,), (m - ms, n), (m,), (m,), (m,) (each with a
    leading B for a batch), in ``dtype`` ("float32" or "float64"), sense
    int32; the output a dict of ``x``, ``lam``, ``fval``, ``exitflag``,
    ``iterations`` and ``rounds`` (the flat rounds run, summed over
    chunks).  ``settings`` are baked in as constants.  The program runs
    on ``device`` (default the card), where it was exported.

    Returns the bytes of ``torch.export.save`` (and writes them to
    ``path`` if given)."""
    import io

    from .batch import resolve_device
    dev = resolve_device((), device)
    dt = torch.float32 if dtype in ("float32", torch.float32) \
        else torch.float64
    st = as_settings(settings, dt)
    lead = () if batch is None else (batch,)

    def z(*shape, t=dt):
        return torch.zeros(lead + shape, dtype=t, device=dev)

    args = (z(n, n), z(n), z(m - ms, n), z(m), z(m), z(m, t=torch.int32))
    program = torch.export.export(
        _FlatProgram(ms, st, n + 1, batch is None), args, strict=False)
    program.example_inputs = None      # not saved: zeros of the full size
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = buf.getvalue()
    if path:
        with open(path, "wb") as fh:
            fh.write(blob)
    return blob
