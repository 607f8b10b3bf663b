"""The plain reference: a batched primal-dual interior-point QP solver.

It solves, lane by lane and independently of the program under test,

    minimize    0.5 x'Hx + f'x + sum_{i soft} w_i^2 / (2 rho r_i^2)
    subject to  blower_i - w_i <= C_i x <= bupper_i + w_i   (soft rows)
                blower_i       <= C_i x <= bupper_i         (other rows)

with r_i = sqrt(C_i H^-1 C_i') the row's norm in the least-distance
space: DAQP's soft rows put rho_soft on the diagonal of the normalized
dual Gram matrix (``G = M_W M_W' + rho diag(soft)``, rows M_i = C_i R^-1
/ r_i), which is this quadratic penalty on the normalized violation
w_i / r_i.  Mehrotra's predictor-corrector on the two-sided rows, the
slack variables w eliminated in closed form, so each step factors one
(n, n) matrix per lane.  Plain ``torch`` operations and nothing else: no
kernel, no import of the program.

``precision``: "float64" is the reference.  "tf32" is the control: the
same algorithm in float32 with every product's operands rounded to TF32
(10 mantissa bits, round to nearest even) and summed in float32, as the
card's TF32 matrix units compute; the rounding is explicit, so the
control reads the same on any device.
"""
from __future__ import annotations

import torch

F32, F64 = torch.float32, torch.float64


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits, ties to even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -8192
    return i.view(F32)


class _Ops:
    """Products in the reference's precision."""

    def __init__(self, precision: str):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"precision {precision!r}")
        self.dtype = F64 if precision == "float64" else F32
        self.round = tf32 if precision == "tf32" else (lambda x: x)

    def ein(self, spec, *xs):
        return torch.einsum(spec, *(self.round(x) for x in xs))


def solve(H, f, C, bupper, blower, soft=None, rho: float = 0.0,
          precision: str = "float64", max_iter: int = 100,
          tol: float | None = None):
    """x (B, n) in the working precision and ``converged`` (B,) bool.

    H (B, n, n), f (B, n), C (B, m, n), bupper / blower (B, m) finite;
    ``soft`` (B, m) bool or None; ``rho`` the soft rows' rho_soft.  A lane
    stops once its scaled primal and dual residuals and its complementarity
    are under ``tol`` (default 1e-10 in float64, 1e-5 in TF32); a lane
    whose step matrix fails to factor stops where it is.  The interior
    point then hands its working set to ``_crossover``."""
    ops = _Ops(precision)
    dt = ops.dtype
    if tol is None:
        tol = 1e-10 if dt == F64 else 1e-5
    H, f, C, bu, bl = (torch.as_tensor(v).to(dt) for v in
                       (H, f, C, bupper, blower))
    B, m, n = C.shape
    dev = H.device
    S = torch.zeros((B, m), dtype=dt, device=dev) if soft is None \
        else torch.as_tensor(soft, device=dev).to(dt)
    L, info = torch.linalg.cholesky_ex(H)
    eye = torch.eye(n, dtype=dt, device=dev).expand(B, n, n)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    # r_i^2 = C_i H^-1 C_i' = ||L^-1 C_i'||^2
    r2 = ops.ein('bij,bmj->bmi', Linv, C).pow(2).sum(-1)
    cw = torch.where(S > 0, 1.0 / (rho * r2.clamp_min(1e-300)),
                     torch.ones_like(r2)) if soft is not None \
        else torch.ones_like(r2)
    # start: the unconstrained minimizer, unit duals, slacks >= 1
    x = -ops.ein('bji,bj->bi', Linv, ops.ein('bij,bj->bi', Linv, f))
    w = torch.zeros((B, m), dtype=dt, device=dev)
    Cx = ops.ein('bmj,bj->bm', C, x)
    su = (bu - Cx).clamp_min(1.0)
    sl = (Cx - bl).clamp_min(1.0)
    lu = torch.ones_like(su)
    ll = torch.ones_like(sl)
    scale_p = 1.0 + torch.maximum(bu.abs().amax(1), bl.abs().amax(1))
    scale_d = 1.0 + f.abs().amax(1)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    ok = info == 0
    for it in range(max_iter):
        Cx = ops.ein('bmj,bj->bm', C, x)
        rdx = ops.ein('bij,bj->bi', H, x) + f \
            + ops.ein('bmj,bm->bj', C, lu - ll)
        rdw = cw * w - S * (lu + ll)
        rpu = Cx - S * w + su - bu
        rpl = -Cx - S * w + sl + bl
        mu = ((lu * su).sum(1) + (ll * sl).sum(1)) / (2 * m)
        res = torch.maximum(
            torch.maximum(rpu.abs().amax(1), rpl.abs().amax(1)) / scale_p,
            torch.maximum(rdx.abs().amax(1), rdw.abs().amax(1)) / scale_d)
        done = done | (ok & (res < tol) & (mu < tol))
        if it % 8 == 7 and bool((done | ~ok).all()):
            break
        Du, Dl = lu / su, ll / sl
        Q = cw + S * (Du + Dl)
        e = (Dl - Du) * S
        K = ops.ein('bmi,bm,bmj->bij', C, Du + Dl - e * e / Q, C) + H
        Lk, kinfo = torch.linalg.cholesky_ex(K)
        ok = ok & (kinfo == 0)
        Lk = torch.where(ok[:, None, None], Lk, eye)

        def direction(rcu, rcl):
            gu = Du * rpu + rcu / su
            gl = Dl * rpl + rcl / sl
            tw = -rdw + S * (gu + gl)
            rhs = -rdx - ops.ein('bmj,bm->bj', C, gu - gl + e * tw / Q)
            dx = torch.cholesky_solve(rhs[:, :, None], Lk)[:, :, 0]
            Cdx = ops.ein('bmj,bj->bm', C, dx)
            dw = (tw - e * Cdx) / Q
            dlu = Du * (Cdx - S * dw) + gu
            dll = Dl * (-Cdx - S * dw) + gl
            dsu = (rcu - su * dlu) / lu
            dsl = (rcl - sl * dll) / ll
            return dx, dw, dlu, dll, dsu, dsl

        def step(d):
            a = torch.ones(B, dtype=dt, device=dev)
            for v, dv in ((su, d[4]), (sl, d[5]), (lu, d[2]), (ll, d[3])):
                neg = dv < 0
                ratio = torch.where(neg, -v / torch.where(neg, dv, -1.0),
                                    torch.full_like(v, float('inf')))
                a = torch.minimum(a, ratio.amin(1))
            return a

        aff = direction(-lu * su, -ll * sl)
        a_aff = step(aff)[:, None]
        mu_aff = (((lu + a_aff * aff[2]) * (su + a_aff * aff[4])).sum(1)
                  + ((ll + a_aff * aff[3]) * (sl + a_aff * aff[5])).sum(1)) \
            / (2 * m)
        sigma = (mu_aff / mu.clamp_min(1e-300)).clamp(0.0, 1.0) ** 3
        sm = (sigma * mu)[:, None]
        d = direction(-lu * su - aff[2] * aff[4] + sm,
                      -ll * sl - aff[3] * aff[5] + sm)
        a = (0.99 * step(d)).clamp(max=1.0)
        go = (~done & ok)[:, None]
        a = torch.where(go, a[:, None], 0.0)

        def upd(v, dv):
            return torch.where(go, v + a * dv, v)

        x, w = upd(x, d[0]), upd(w, d[1])
        lu, ll, su, sl = upd(lu, d[2]), upd(ll, d[3]), upd(su, d[4]), \
            upd(sl, d[5])
    return _crossover(ops, H, f, C, bu, bl, S, cw, x, lu > su, ll > sl,
                      lu + ll, tol)


def _independent(C, cand, prio, rtol=1e-9):
    """The rows of ``cand`` (B, m) to keep as equalities: in the order of
    ``prio``, each row whose part outside the rows kept before it is more
    than ``rtol`` of its norm (Gram-Schmidt, twice).  At a degenerate
    optimum more rows are tight than are independent; the rest hold with
    a zero multiplier."""
    B, m, n = C.shape
    order = torch.argsort(torch.where(cand, prio, -1.0), dim=1,
                          descending=True)
    Cs = torch.gather(C, 1, order[:, :, None].expand(B, m, n))
    cs = torch.gather(cand, 1, order)
    basis = torch.zeros((B, n, n), dtype=C.dtype, device=C.device)
    count = torch.zeros(B, dtype=torch.long, device=C.device)
    keep = torch.zeros_like(cand)
    rows = torch.arange(B, device=C.device)
    for j in range(m):
        if not bool(cs[:, j].any()):
            break
        r = Cs[:, j]
        res = r
        for _ in range(2):
            res = res - torch.einsum('bkn,bk->bn', basis, torch.einsum(
                'bkn,bn->bk', basis, res))
        nr = res.norm(dim=1)
        ok = cs[:, j] & (nr > rtol * r.norm(dim=1)) & (count < n)
        slot = count.clamp(max=n - 1)
        basis[rows[ok], slot[ok]] = res[ok] / nr[ok, None]
        count = count + ok
        keep[:, j] = ok
    out = torch.zeros_like(cand)
    return out.scatter(1, order, keep)


def _crossover(ops, H, f, C, bu, bl, S, cw, x_ipm, up, lo, prio, tol,
               passes: int = 12):
    """The exact optimum on the working set the interior point leaves:
    rows whose dual exceeds their slack start active on that side (hard
    rows as equalities, independent ones in the order of their duals
    ``prio``; soft rows as their quadratic penalty), and the
    equality-constrained QP on that set is solved directly.  A lane whose
    solution violates a row takes that row in on the violated side, and one
    whose multiplier has the wrong sign drops its worst such row, for at
    most ``passes`` passes; a lane's answer is kept once it is primal and
    dual feasible to ``tol`` (scaled), else the interior-point iterate is
    kept and the lane reads as not converged."""
    dt = ops.dtype
    B, m, n = C.shape
    up = up & ~lo
    soft = S > 0
    eye_n = torch.eye(n, dtype=dt, device=H.device).expand(B, n, n)
    scale = (1.0 + torch.maximum(bu.abs().amax(1), bl.abs().amax(1)))[:, None]
    t = tol * scale
    x_out, good = x_ipm.clone(), torch.zeros(B, dtype=torch.bool,
                                             device=H.device)
    for _ in range(passes):
        act = up | lo
        b = torch.where(up, bu, bl)
        ps = (act & soft).to(dt) * cw        # penalty weights of soft rows
        eq = _independent(C, act & ~soft, prio).to(dt)   # hard equalities
        Hs = H + ops.ein('bmi,bm,bmj->bij', C, ps, C)
        fs = f - ops.ein('bmj,bm->bj', C, ps * b)
        L, info = torch.linalg.cholesky_ex(Hs)
        L = torch.where((info == 0)[:, None, None], L, eye_n)
        Ce = C * eq[:, :, None]
        HiCe = torch.cholesky_solve(Ce.transpose(1, 2), L)       # (B, n, m)
        Hif = torch.cholesky_solve(fs[:, :, None], L)[:, :, 0]
        G = ops.ein('bmj,bjk->bmk', Ce, HiCe) + torch.diag_embed(1.0 - eq)
        rhs = -(eq * b + ops.ein('bmj,bj->bm', Ce, Hif))
        lam, ginfo = torch.linalg.solve_ex(G, rhs[:, :, None])
        lam = lam[:, :, 0] * eq
        x = -Hif - ops.ein('bjm,bm->bj', HiCe, lam)
        Cx = ops.ein('bmj,bj->bm', C, x)
        lam = lam + ps * (Cx - b)            # soft rows' multipliers
        over, under = Cx - bu, bl - Cx       # violation of each side
        held = (eq > 0) | (act & soft)
        v_up = torch.where(held, -1.0, over)
        v_lo = torch.where(held, -1.0, under)
        wrong = torch.where(up, -lam, torch.where(lo, lam, -1.0))
        solved = (info == 0) & (ginfo == 0) & (v_up <= t).all(1) \
            & (v_lo <= t).all(1) & (wrong <= t).all(1)
        new = solved & ~good
        x_out = torch.where(new[:, None], x, x_out)
        good = good | solved
        if bool(good.all()):
            break
        # repair the lanes still open: violated rows in, worst sign out
        add_up, add_lo = v_up > t, v_lo > t
        worst = torch.where(wrong > t, wrong, 0.0)
        drop = (worst == worst.amax(1, keepdim=True)) & (worst > 0) \
            & ~(add_up | add_lo).any(1, keepdim=True)
        up = torch.where(good[:, None], up, (up | add_up) & ~drop)
        lo = torch.where(good[:, None], lo, (lo | add_lo) & ~drop)
    return x_out, good
