"""QP -> LDP transform, batched.

Counterpart of ``daqp_tpu/transform.py``: ``:42 LDPData``, ``:57
factorize_hessian``, ``:140 build_ldp`` (vmapped in ``batch.py:523``),
``:236 update_vd``, ``:248 update_sense``, ``:280 update_d_from_v``,
``:287 get_proximal_regularization``, ``:322 check_unconstrained`` and
``:340 ldp_to_qp_solution``.  Batch-leading: (B, m, n), (B, m), (B,);
the single-instance path runs them at B = 1.  The factorization and the products are plain
``torch.linalg`` / ``torch.matmul`` calls: the JAX package does this work
in XLA, outside any Pallas kernel.  TF32 is off package-wide.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .ops import host_any
from .types import (ACTIVE, IMMUTABLE, SOFT, EXIT_INFEASIBLE,
                    EXIT_NONCONVEX, Settings, SoftWeights)


class LDPData(NamedTuple):
    """Everything the QP -> LDP transform produces, per lane."""
    M: torch.Tensor          # (B, m, n) normalized constraint rows
    dupper: torch.Tensor     # (B, m)
    dlower: torch.Tensor     # (B, m)
    scaling: torch.Tensor    # (B, m)
    sense: torch.Tensor      # (B, m) int32, equalities auto-marked
    Rinv: torch.Tensor       # (B, n, n) upper inverse Cholesky factor
    v: torch.Tensor          # (B, n) v = Rinv' f
    prox_mask: torch.Tensor  # (B, n) bool
    n_prox: torch.Tensor     # (B,) int32
    eps_used: torch.Tensor   # (B,)
    error: torch.Tensor      # (B,) int32: 0 ok, else an EXIT_* code


def factorize_hessian(H: torch.Tensor, st: Settings, dense=None,
                      graph: bool = False):
    """(B, n, n) -> ``(Rinv, prox_mask, n_prox, eps_used, error)`` per
    lane with semi-proximal regularization (``daqp_update_Rinv``,
    utils.c:137-297):

    * diagonal H: only the (near-)singular directions are shifted by
      eps0, recorded in ``prox_mask``;
    * dense H: plain Cholesky; on failure or a pivot ratio below
      sqrt(zero_tol), H + eps I with eps = eps0, then doubled, at most 16
      attempts (full proximal shift).

    eps0 = max(eps_prox, sqrt(zero_tol) max|diag H|).  ``dense``: a
    function H -> ``(Rinv, ok, reg_mask, eps_used)`` with the same retry
    semantics (``ops.chol.batched_rinv_regularized``) that factors the
    dense lanes in place of the library's Cholesky.  ``graph``: the form
    ``torch.export`` traces, with no host read: the library's retries run
    all 16 tries, each kept only on the lanes still failing (the host
    loop stops once none fails, after which a try changes nothing)."""
    B, n, _ = H.shape
    dtype, dev = H.dtype, H.device
    zero_tol = torch.tensor(st.zero_tol, dtype=dtype, device=dev)
    sqrt_zt = torch.sqrt(zero_tol)
    eye = torch.eye(n, dtype=dtype, device=dev)
    diag = torch.diagonal(H, dim1=1, dim2=2)
    scale = diag.abs().amax(1)
    if st.eps_prox > 0:
        eps0 = torch.maximum(torch.tensor(st.eps_prox, dtype=dtype,
                                          device=dev), sqrt_zt * scale)
    else:
        eps0 = torch.full((B,), st.eps_prox, dtype=dtype, device=dev)
    is_diag = (H - torch.diag_embed(diag)).abs().amax((1, 2)) <= zero_tol

    # diagonal path (utils.c:179-207)
    dmask = diag <= (sqrt_zt * scale)[:, None]
    d_reg = torch.where(dmask, diag + eps0[:, None], diag)
    d_bad = (d_reg <= zero_tol).any(1)
    R_diag = torch.diag_embed(1.0 / torch.sqrt(torch.maximum(d_reg,
                                                             zero_tol)))
    eps_diag = torch.where(dmask.any(1), eps0, 0.0)

    if dense is not None:
        R_dense, ok, reg, eps_used = dense(H, st)
        return _merge_diag(is_diag, R_diag, dmask, eps_diag, d_bad,
                           R_dense, ok, reg, eps_used)
    # dense path (utils.c:253-283): attempts at 0, eps0, 2 eps0, ...
    Hs = 0.5 * (H + H.transpose(1, 2))

    def attempt(eps):
        L, info = torch.linalg.cholesky_ex(Hs + eps[:, None, None] * eye)
        L = torch.where((info == 0)[:, None, None], L, torch.nan)
        piv = torch.diagonal(L, dim1=1, dim2=2) ** 2
        ok = ~torch.isnan(L).any(dim=(1, 2)) \
            & (piv.amin(1) > sqrt_zt * piv.amax(1))
        return L, ok

    L, ok = attempt(torch.zeros_like(eps0))
    reg = ~ok
    eps_used = torch.zeros_like(eps0)
    eps = eps0.clone()
    todo = reg.clone()
    for _ in range(16):
        if not graph and not bool(todo.any()):
            break
        L1, ok1 = attempt(eps)
        L = torch.where(todo[:, None, None], L1, L)
        eps_used = torch.where(todo, eps, eps_used)
        ok = torch.where(todo, ok1, ok)
        todo = todo & ~ok1
        eps = eps * 2.0
    L_safe = torch.where(torch.isnan(L) | (L == 0), eye, L)
    R_dense = torch.linalg.solve_triangular(
        L_safe.transpose(1, 2), eye.expand(B, n, n), upper=True)
    return _merge_diag(is_diag, R_diag, dmask, eps_diag, d_bad, R_dense, ok,
                       reg, eps_used)


def _merge_diag(is_diag, R_diag, dmask, eps_diag, d_bad, R_dense, ok, reg,
                eps_used):
    """The diagonal lanes' factor beside the dense lanes' one, in
    ``factorize_hessian``'s output form."""
    B, n = dmask.shape
    Rinv = torch.where(is_diag[:, None, None], R_diag, R_dense)
    prox_mask = torch.where(is_diag[:, None], dmask, reg[:, None].expand(B, n))
    n_prox = torch.where(is_diag, dmask.sum(1),
                         torch.where(reg, n, 0)).to(torch.int32)
    eps_out = torch.where(is_diag, eps_diag, eps_used)
    error = torch.where(is_diag, d_bad, ~ok)
    error = torch.where(error, EXIT_NONCONVEX, 0).to(torch.int32)
    return Rinv, prox_mask, n_prox, eps_out, error


def build_ldp(f, A, bupper, blower, sense, ms: int, st: Settings,
              Rinv: torch.Tensor = None, H: torch.Tensor = None,
              soft_weights: torch.Tensor = None, fact=None) -> LDPData:
    """M = [Rinv[:ms]; A Rinv], v, the bounds check with auto-equality,
    row normalization with zero rows, and d = b * scaling + M v
    (``daqp_update_ldp``, utils.c:14-135).  Rinv is the given factor, or
    ``fact`` (``factorize_hessian``'s output, when the caller has it), or
    ``factorize_hessian(H)``.  With neither (LP mode,
    ``transform.py:162-166``) Rinv = I in A's type, every direction is
    proximal (``prox_mask`` all true, ``n_prox`` = n) and the proximal
    outer loop supplies v; ``f`` None gives v = 0.

    ``soft_weights`` ((B, m) per-row penalties): a SOFT row's penalty
    rho_i becomes the uniform rho_soft on the row scaled by
    sqrt(rho_soft / rho_i), kept in ``scaling`` (``transform.py:209-223``;
    slack bounds are ``SoftWeights``' business, not this one's)."""
    fact_err = None
    lp_mode = Rinv is None and H is None and fact is None
    if fact is not None:
        Rinv, prox_mask, n_prox, eps_used, fact_err = fact
    elif lp_mode:
        B, _, n = A.shape
        Rinv = torch.eye(n, dtype=A.dtype, device=A.device).expand(B, n, n)
    elif Rinv is None:
        Rinv, prox_mask, n_prox, eps_used, fact_err = factorize_hessian(
            H, st)
    B, n, _ = Rinv.shape
    dtype, dev = Rinv.dtype, Rinv.device
    mg = A.shape[1]
    m = ms + mg
    sense = (torch.zeros((B, m), dtype=torch.int32, device=dev)
             if sense is None else sense.to(torch.int32))
    if fact_err is None:
        prox_mask = torch.full((B, n), lp_mode, dtype=torch.bool, device=dev)
        n_prox = torch.full((B,), n if lp_mode else 0, dtype=torch.int32,
                            device=dev)
        eps_used = torch.zeros(B, dtype=dtype, device=dev)
        fact_err = torch.zeros(B, dtype=torch.int32, device=dev)

    v = torch.zeros((B, n), dtype=dtype, device=dev) if f is None else \
        torch.matmul(Rinv.transpose(1, 2), f.to(dtype)[..., None])[..., 0]
    M = torch.matmul(A.to(dtype), Rinv)
    if ms > 0:
        M = torch.cat([Rinv[:, :ms, :], M], dim=1)

    # bounds check (daqp_check_bounds, utils.c:457-478)
    bu = bupper.to(dtype)
    bl = blower.to(dtype)
    mutable = (sense & IMMUTABLE) == 0
    diff = bu - bl
    trivially_infeasible = (mutable & (diff < -st.primal_tol)).any(dim=1)
    is_eq = mutable & (diff < st.zero_tol) & ((sense & SOFT) == 0)
    sense = torch.where(is_eq, sense | (ACTIVE | IMMUTABLE), sense)

    # row normalization (utils.c:480-524); zero rows ignored or infeasible
    norms_sq = (M * M).sum(dim=2)
    zero_row = norms_sq < st.zero_tol
    scaling = torch.where(
        zero_row, torch.ones_like(norms_sq),
        1.0 / torch.sqrt(torch.clamp(norms_sq, min=st.zero_tol)))
    M = M * torch.where(zero_row, torch.zeros_like(scaling),
                        scaling)[..., None]
    zero_row_infeasible = (
        zero_row & ((bu < -st.zero_tol) | (bl > st.zero_tol))
        & ((sense & IMMUTABLE) == 0) & ((sense & SOFT) == 0)).any(dim=1)
    sense = torch.where(zero_row, (sense | IMMUTABLE) & ~ACTIVE, sense)

    if soft_weights is not None:
        w = soft_weights.to(dtype)
        c = torch.sqrt(torch.tensor(st.rho_soft, dtype=dtype, device=dev)
                       / torch.clamp(w, min=1e-30))
        c = torch.where((sense & SOFT) > 0, c, torch.ones_like(c))
        M = M * c[..., None]
        scaling = scaling * c

    # d = b * scaling + M v  (daqp_update_d, utils.c:410-455)
    Mv = torch.matmul(M, v[..., None])[..., 0]
    err = torch.where(fact_err != 0, fact_err,
                      torch.where(trivially_infeasible | zero_row_infeasible,
                                  EXIT_INFEASIBLE, 0)).to(torch.int32)
    return LDPData(M=M, dupper=bu * scaling + Mv, dlower=bl * scaling + Mv,
                   scaling=scaling, sense=sense, Rinv=Rinv, v=v,
                   prox_mask=prox_mask, n_prox=n_prox, eps_used=eps_used,
                   error=err)


def update_vd(ldp: LDPData, f, bupper, blower) -> LDPData:
    """The warm re-solve update: v and d only, M / Rinv / scaling kept
    (the MPC contract, mask UPDATE_v | UPDATE_d, docs/docs/c.md:60-73)."""
    v = torch.matmul(ldp.Rinv.transpose(1, 2), f[..., None])[..., 0]
    Mv = torch.matmul(ldp.M, v[..., None])[..., 0]
    return ldp._replace(v=v, dupper=bupper * ldp.scaling + Mv,
                        dlower=blower * ldp.scaling + Mv)


def ldp_to_qp_solution(ldp: LDPData, u: torch.Tensor) -> torch.Tensor:
    """x = Rinv (u - v)  (``ldp2qp_solution``, daqp.c:111-139)."""
    return torch.matmul(ldp.Rinv, (u - ldp.v)[..., None])[..., 0]


def update_sense(ldp: LDPData, sense, bupper, blower,
                 st: Settings) -> LDPData:
    """The sense-only update (mask UPDATE_sense, utils.c:31-39): the new
    user sense with the derived bits re-applied (auto-equality where
    bu - bl < zero_tol, IMMUTABLE on the zero rows, which the normalized
    M keeps at zero) and the bound error re-derived under it; a
    factorization error stays.  No refactorization, no M / v / d
    rebuild."""
    dtype = ldp.M.dtype
    sense = sense.to(torch.int32)
    bu, bl = bupper.to(dtype), blower.to(dtype)
    mutable = (sense & IMMUTABLE) == 0
    diff = bu - bl
    trivially_infeasible = (mutable & (diff < -st.primal_tol)).any(dim=1)
    is_eq = mutable & (diff < st.zero_tol) & ((sense & SOFT) == 0)
    sense = torch.where(is_eq, sense | (ACTIVE | IMMUTABLE), sense)
    zero_row = (ldp.M * ldp.M).sum(dim=2) < 0.5
    zero_row_infeasible = (
        zero_row & ((bu < -st.zero_tol) | (bl > st.zero_tol))
        & ((sense & IMMUTABLE) == 0) & ((sense & SOFT) == 0)).any(dim=1)
    sense = torch.where(zero_row, (sense | IMMUTABLE) & ~ACTIVE, sense)
    err = torch.where(ldp.error == EXIT_NONCONVEX, ldp.error,
                      torch.where(trivially_infeasible | zero_row_infeasible,
                                  EXIT_INFEASIBLE, 0))
    return ldp._replace(sense=sense.to(torch.int32),
                        error=err.to(torch.int32))


def update_d_from_v(ldp: LDPData, v, bupper, blower) -> LDPData:
    """A caller's v (the proximal outer loops) and d refreshed from it."""
    Mv = torch.matmul(ldp.M, v[..., None])[..., 0]
    return ldp._replace(v=v, dupper=bupper * ldp.scaling + Mv,
                        dlower=blower * ldp.scaling + Mv)


def get_proximal_regularization(ldp: LDPData, H=None,
                                st: Settings = None) -> torch.Tensor:
    """The applied proximal shift per lane
    (``daqp_get_proximal_regularization``, utils.c:299-343): the tracked
    ``eps_used`` (0 for a PD Hessian), or with ``H`` ((B, n, n)) the shift
    recovered from the factor, 1 / Rinv[0, 0]^2 - H[0, 0], rounded up to
    the retry level eps0 2^k (0 below eps0 / 2)."""
    if H is None:
        return ldp.eps_used
    zero_tol = st.zero_tol if st is not None else 1e-11
    eps_prox = st.eps_prox if st is not None else 1e-6
    rinv00 = ldp.Rinv[:, 0, 0]
    recovered = 1.0 / (rinv00 * rinv00) - H[:, 0, 0]
    scale = torch.diagonal(H, dim1=1, dim2=2).abs().amax(1)
    eps = torch.clamp(zero_tol ** 0.5 * scale, min=eps_prox)
    while host_any(1.5 * eps < recovered):
        eps = torch.where(1.5 * eps < recovered, eps * 2.0, eps)
    return torch.where(recovered < 0.5 * torch.clamp(
        zero_tol ** 0.5 * scale, min=eps_prox), torch.zeros_like(eps), eps)


def check_unconstrained(ldp: LDPData, st: Settings):
    """Per lane, whether the unconstrained optimum x = -Rinv v is feasible
    and no row is active or immutable (``daqp_check_unconstrained``,
    utils.c:529-598): u = 0 solves the LDP, so dlower <= 0 <= dupper on
    the rows that are not IMMUTABLE.  Returns ``(feasible (B,), x
    (B, n))``."""
    x = -torch.matmul(ldp.Rinv, ldp.v[..., None])[..., 0]
    up_ok = ldp.dupper >= -st.primal_tol * ldp.scaling
    lo_ok = ldp.dlower <= st.primal_tol * ldp.scaling
    ignored = (ldp.sense & IMMUTABLE) > 0
    feasible = (up_ok | ignored).all(dim=1) & (lo_ok | ignored).all(dim=1)
    no_active = ((ldp.sense & (ACTIVE | IMMUTABLE)) == 0).all(dim=1)
    return feasible & no_active, x


def normalize_soft_weights(sw: SoftWeights, ldpd: LDPData) -> SoftWeights:
    """SOFT_WEIGHTS data (raw units, the shape of ``ldpd.scaling``) in the
    row-scaled dual formulation, zero on hard rows (utils.c:99-110;
    ``daqp_tpu/batch.py:551-570``): d / scaling, rho scaling^2."""
    soft = (ldpd.sense & SOFT) > 0
    sc = ldpd.scaling

    def norm(x, p):
        return torch.where(soft, x.to(sc.dtype) * sc ** p, 0.0)

    return SoftWeights(d_ls=norm(sw.d_ls, -1), d_us=norm(sw.d_us, -1),
                       rho_ls=norm(sw.rho_ls, 2), rho_us=norm(sw.rho_us, 2))
