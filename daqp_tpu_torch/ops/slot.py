"""K2: the slot-space dual active-set round, and the host loop around it.

Counterpart of ``daqp_tpu/ops/pallas_slot.py``: ``:63 SlotState``,
``:663 run_slot_round`` (the TPU kernel ``_kernel_body`` ->
``_solve_tile_live``, :102-661), ``:2004 slot_init``, ``:2044
_slot_gram``, ``:2054 slot_activate``, ``:2110 exact_repair``, ``:2137
repair_needed``, ``:2142 newton_refresh``, ``:2167 polish``, ``:2209
slot_solve``, ``:2333 slot_duals_dense``; and of
``daqp_tpu/ops/pallas_batch.py:904 _batched_gram_inverse`` (its XLA
path).

The state is batch-leading: (B, m, n), (B, K, K), (B, K), (B,).  The
TPU workarounds stay behind: no 8-aligned padding (K = n_true + 1
exactly; the ``kcnt >= n_true`` gate caps the table at n_true slots, so
one spare slot is enough), no 128-lane tiles, no one-hot mask algebra.
A state carried over from JAX (``convert.slot_state_from_jax``) may keep
its padded shapes: padded rows are immutable with +-INF bounds, and
``n_true`` is passed separately.

``run_slot_round`` launches the CUDA kernel (``csrc/slot_round.cu``) on
CUDA tensors and runs ``run_slot_round_plain`` on CPU tensors.  The
rounds, ``exact_repair`` and the polish cycles run on the host, each
masked per lane, so a lane's result depends on that lane alone.

The four segment kernels run K2's step (``csrc/slot_step.cuh``) inside
an outer loop: ``run_mpc_segment`` (B3, ``csrc/mpc_segment.cu``,
replacing ``pallas_slot.py:1866``) runs P warm MPC horizon steps,
``run_prox_segment`` (B4, ``csrc/prox_segment.cu``, replacing
``pallas_slot.py:1110``) runs P proximal passes, ``run_avi_segment``
(B5, ``csrc/avi_segment.cu``, replacing ``pallas_slot.py:1783``) runs P
Douglas-Rachford passes of the batched AVI and ``run_lp_segment`` (B6,
``csrc/lp_segment.cu``, replacing ``pallas_slot.py:1468``) runs P
adaptive-eps LP passes with the gradient step (``lp_grad_step``, its
bordered add ``slot_add_row``), each with a plain twin for CPU tensors.
In all four, a lane that stops (frozen, done) is left as it is for the
rest of the segment, in the kernel and the twin alike.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build, check_deadline, host_any, smem
from ..types import (Settings, DAQP_INF, EXIT_CYCLE, EXIT_INFEASIBLE,
                     EXIT_ITERLIMIT, EXIT_OPTIMAL, EXIT_REFACTOR,
                     EXIT_RUNNING, EXIT_UNBOUNDED, PRICING_BLAND)

# kernel launches of run_slot_round (K2), run_mpc_segment (B3),
# run_prox_segment (B4), run_avi_segment (B5) and run_lp_segment (B6); the
# caller resets them
launches = 0
mpc_launches = 0
prox_launches = 0
avi_launches = 0
lp_launches = 0
STEPS = 192         # iterations per kernel round
MAX_ROUNDS = 16     # live rounds per lane
# status of a RUNNING lane kept out of one round (iteration or round
# budget spent); restored to RUNNING right after the round
_HELD = 98


class SlotState(NamedTuple):
    """Slot-space batched solver state, batch-leading, f32."""
    # problem data (const)
    M: torch.Tensor          # (B, m, n)
    dupper: torch.Tensor     # (B, m)
    dlower: torch.Tensor     # (B, m)
    scaling: torch.Tensor    # (B, m)
    immut: torch.Tensor      # (B, m) 0/1
    fbound: torch.Tensor     # (B,) LDP-space dual objective bound
    # m-space activation masks
    act_up: torch.Tensor     # (B, m) 0/1
    act_lo: torch.Tensor     # (B, m) 0/1
    # slot table
    W: torch.Tensor          # (B, K, n) active rows by slot
    E: torch.Tensor          # (B, K, K) inverse Gram on used slots
    dsl: torch.Tensor        # (B, K) active-side bound value per slot
    used: torch.Tensor       # (B, K) 0/1
    sid: torch.Tensor        # (B, K) constraint id (-1 = free)
    slo: torch.Tensor        # (B, K) side (1 = lower)
    simm: torch.Tensor       # (B, K) immutable slot
    lam: torch.Tensor        # (B, K)
    lam_star: torch.Tensor   # (B, K)
    # pending singular addition (held out of the table)
    pend: torch.Tensor       # (B,) 0/1
    prow: torch.Tensor       # (B, n)
    plam: torch.Tensor       # (B,)
    plo: torch.Tensor        # (B,)
    pid: torch.Tensor        # (B,) constraint id
    pdd: torch.Tensor        # (B,) bound value
    # iterates / control
    u: torch.Tensor          # (B, n)
    fval: torch.Tensor       # (B,)
    best_fval: torch.Tensor  # (B,)
    cycle: torch.Tensor      # (B,)
    repaired: torch.Tensor   # (B,)
    iterations: torch.Tensor  # (B,)
    status: torch.Tensor     # (B,) int32


# argument order of the CUDA entries (enum Ptr of slot_round.cu,
# mpc_segment.cu and prox_segment.cu)
CONST = ("M", "dupper", "dlower", "scaling", "immut", "simm", "fbound")
STATE = ("act_up", "act_lo", "W", "E", "dsl", "used", "sid", "slo", "lam",
         "lam_star", "pend", "prow", "plam", "plo", "pid", "pdd", "u",
         "fval", "best_fval", "cycle", "repaired", "iterations", "status")
SEG_CONST = ("M", "scaling", "immut", "simm", "fbound")


def _first_min(cand: torch.Tensor):
    """Lowest-index argmin along dim 1 (``jnp.argmin``'s tie rule):
    (index (B, 1), value (B, 1))."""
    idx = torch.argmin(cand, dim=1, keepdim=True)
    return idx, cand.gather(1, idx)


def run_slot_round_plain(s: SlotState, st: Settings, n_true: int,
                         steps: int = STEPS) -> SlotState:
    """Up to ``steps`` masked iterations per lane in torch ops: the step
    of ``_solve_tile_live`` (pallas_slot.py:256-612) vectorized over the
    batch.  A masked step on a terminal lane is a no-op, so the loop
    stops once every lane is terminal."""
    f32 = torch.float32
    B, m, n = s.M.shape
    K = s.E.shape[1]
    dev = s.M.device
    BIG = DAQP_INF
    dtol, ptol, pivtol = st.dual_tol, st.primal_tol, st.pivot_tol
    singtol, progtol, cyctol = st.sing_tol, st.progress_tol, st.cycle_tol
    iota_m = torch.arange(m, device=dev, dtype=f32)[None, :]
    iota_K = torch.arange(K, device=dev, dtype=f32)[None, :]

    M, du, dl, sc, im, simm = (s.M, s.dupper, s.dlower, s.scaling, s.immut,
                               s.simm)
    fb = s.fbound[:, None]
    au, al, W, E = s.act_up, s.act_lo, s.W, s.E
    dsl, used, sid, slo, lam, ls = (s.dsl, s.used, s.sid, s.slo, s.lam,
                                    s.lam_star)
    prow, u = s.prow, s.u
    pd, plm, plo, pid, pdd, fv, bf, cy, rp, it = (
        x[:, None] for x in (s.pend, s.plam, s.plo, s.pid, s.pdd, s.fval,
                             s.best_fval, s.cycle, s.repaired,
                             s.iterations))
    stt = s.status[:, None]

    def mv(A, x):                 # out[b, i] = sum_j A[b, i, j] x[b, j]
        return torch.einsum('bij,bj->bi', A, x)

    def mtv(A, x):                # out[b, j] = sum_i A[b, i, j] x[b, i]
        return torch.einsum('bij,bi->bj', A, x)

    # round-start prefix from the stored E (pallas_slot.py:616-617)
    lam_star = -mv(E, dsl * used)
    a_p = mv(E, mv(W, prow) * used)

    for step in range(steps):
        if step % 8 == 0 and not bool((stt == EXIT_RUNNING).any()):
            break
        run = (stt == EXIT_RUNNING).to(f32)
        sgn_p = 1.0 - 2.0 * plo
        sdir = -a_p * sgn_p

        # blocking min-ratio line search (auxiliary.c:276-311)
        delta = pd * sdir + (1.0 - pd) * (lam_star - lam)
        signv = pd * sdir + (1.0 - pd) * lam_star
        infeas = slo * (signv > dtol).to(f32) \
            + (1.0 - slo) * (signv < -dtol).to(f32)
        elig = infeas * used * (1.0 - simm)
        ratio = -lam / delta
        ratio = torch.where(torch.isfinite(ratio),
                            torch.clamp(ratio, min=0.0), 0.0)
        cand = torch.where(elig > 0, ratio, BIG)
        rm, rmin = _first_min(cand)
        oh_rm = (iota_K == rm).to(f32)
        do_rm0 = run * (rmin < BIG).to(f32)
        rm_id = sid.gather(1, rm)
        rm_lo = slo.gather(1, rm)

        # primal + pricing
        u_new = -mtv(W, lam_star * used)
        fv_new = (u_new * u_new).sum(1, keepdim=True)
        mu = mv(M, u_new)
        bound = -ptol * sc
        v_up = du - mu
        v_lo = mu - dl
        pblock = pd * (iota_m == pid).to(f32)
        blocked = ((au + al) > 0) | (im > 0) | (pblock > 0)
        up_ok = (v_up < bound) & ~blocked
        lo_ok = (v_lo < bound) & ~blocked & ~up_ok
        cand2 = torch.where(up_ok, v_up, torch.where(lo_ok, v_lo, BIG))
        if int(st.pricing) == PRICING_BLAND:
            cand2 = torch.where(up_ok | lo_ok, iota_m - BIG, BIG)
        jr, vmin = _first_min(cand2)
        oh_j = (iota_m == jr).to(f32)
        found = (vmin < 0).to(f32)
        j_lo = lo_ok.gather(1, jr).to(f32)
        d_j = j_lo * dl.gather(1, jr) + (1.0 - j_lo) * du.gather(1, jr)

        # add candidate: pending retry after a removal, or pricing winner
        retry = pd * do_rm0
        price0 = run * (1.0 - do_rm0) * (1.0 - pd)
        padd0 = price0 * found
        mj = M.gather(1, jr[:, :, None].expand(B, 1, n))[:, 0]
        add_row = retry * prow + padd0 * mj
        add_lo = retry * plo + padd0 * j_lo
        add_lam = retry * plm + padd0 * (1.0 - 2.0 * j_lo)
        add_id = retry * pid + padd0 * jr.to(f32)
        add_d = retry * pdd + padd0 * d_j
        g = mv(W, add_row) * used
        g_k = g * (1.0 - oh_rm * do_rm0)

        # removed column + Schur vector; deletion pivot guard
        e = E.gather(2, rm[:, :, None].expand(B, K, 1))[:, :, 0]
        a_pre = mv(E, g_k)
        err = e.gather(1, rm)
        bad = (do_rm0 > 0) & (err < pivtol * e.abs().amax(1, keepdim=True))
        err_s = torch.where(err != 0, err, 1.0)
        ec = (e * g_k).sum(1, keepdim=True) / err_s
        stt = torch.where(bad, EXIT_REFACTOR, stt)
        do_rm = do_rm0 * (1.0 - bad.to(f32))
        keep = 1.0 - oh_rm * do_rm
        a_post = keep * (a_pre - do_rm * e * ec)

        # line-search dual update + masked removal bookkeeping
        alpha = do_rm * torch.where(rmin < BIG, rmin, 0.0)
        lam = (lam + alpha * delta * used) * keep
        plm = plm + alpha * sgn_p * pd
        used = used * keep
        dsl = dsl * keep
        slo = slo * keep
        sid = sid * keep - (1.0 - keep)
        oh_rm_m = (iota_m == rm_id).to(f32) * do_rm
        au = au * (1.0 - oh_rm_m * (1.0 - rm_lo))
        al = al * (1.0 - oh_rm_m * rm_lo)

        # exits: stuck pending, dominance cut, optimal, cycle guard
        stuck = (stt == EXIT_RUNNING) & (pd > 0) & (do_rm == 0) & (run > 0)
        stt = torch.where(stuck, torch.where(rp > 0, EXIT_INFEASIBLE,
                                             EXIT_CYCLE), stt)
        cut = (price0 > 0) & (stt == EXIT_RUNNING) & (fv_new > fb)
        stt = torch.where(cut, EXIT_INFEASIBLE, stt)
        price = price0 * (stt == EXIT_RUNNING).to(f32)
        stt = torch.where((price > 0) & (found == 0), EXIT_OPTIMAL, stt)
        no_prog = (fv_new - bf < progtol * (1.0 + fv_new.abs())).to(f32)
        cy = price * (no_prog * (cy + 1.0)) + (1.0 - price) * cy
        bf = torch.where((price > 0) & (no_prog == 0), fv_new, bf)
        stt = torch.where((price > 0) & (cy > cyctol)
                          & (stt == EXIT_RUNNING), EXIT_CYCLE, stt)

        u = torch.where(price > 0, u_new, u)
        fv = torch.where(price > 0, fv_new, fv)
        ls = torch.where(run > 0, lam_star, ls)
        padd = padd0 * (stt == EXIT_RUNNING).to(f32)
        lam = torch.where(padd > 0, lam_star * used, lam)

        # Schur complement and the relative singularity gate
        dii = (add_row * add_row).sum(1, keepdim=True)
        sval = dii - (g_k * a_post).sum(1, keepdim=True)
        kcnt = used.sum(1, keepdim=True)
        gate = torch.clamp(1e-4 * dii, min=singtol)
        sing = ((sval < gate) | (kcnt >= n_true)).to(f32)
        do_add = retry * (1.0 - bad.to(f32)) + padd
        ok = do_add * (1.0 - sing)

        free, _ = _first_min(iota_K + used * BIG)
        oh_free = (iota_K == free).to(f32)
        w = a_post * used - oh_free
        c_del = -do_rm / err_s
        c_add = ok / torch.where(sval != 0, sval, 1.0)

        W = W * keep[:, :, None] + (ok * oh_free)[:, :, None] \
            * add_row[:, None, :]
        mk_pend = do_add * sing
        used = torch.clamp(used + ok * oh_free, max=1.0)
        sid = sid + ok * oh_free * (add_id + 1.0)
        slo = slo + ok * oh_free * add_lo
        dsl = dsl + ok * oh_free * add_d
        lam = lam + ok * oh_free * add_lam
        add_oh_m = retry * (iota_m == pid).to(f32) + padd * oh_j
        au = torch.clamp(au + ok * add_oh_m * (1.0 - add_lo), max=1.0)
        al = torch.clamp(al + ok * add_oh_m * add_lo, max=1.0)
        pd = torch.clamp((1.0 - retry) * pd + mk_pend, max=1.0)
        prow = torch.where(mk_pend > 0, add_row, prow)
        plm = torch.where(mk_pend > 0, add_lam, plm)
        plo = torch.where(mk_pend > 0, add_lo, plo)
        pid = torch.where(mk_pend > 0, add_id, pid)
        pdd = torch.where(mk_pend > 0, add_d, pdd)

        # E update and the next step's CSP / pending direction
        E = (E + c_del[:, :, None] * e[:, :, None] * e[:, None, :]) \
            * keep[:, :, None] * keep[:, None, :] \
            + c_add[:, :, None] * w[:, :, None] * w[:, None, :]
        lam_star = -mv(E, dsl * used)
        a_p = mv(E, mv(W, prow) * used)
        it = it + run

    return s._replace(
        act_up=au, act_lo=al, W=W, E=E, dsl=dsl, used=used, sid=sid,
        slo=slo, lam=lam, lam_star=ls, pend=pd[:, 0], prow=prow,
        plam=plm[:, 0], plo=plo[:, 0], pid=pid[:, 0], pdd=pdd[:, 0], u=u,
        fval=fv[:, 0], best_fval=bf[:, 0], cycle=cy[:, 0],
        repaired=rp[:, 0], iterations=it[:, 0],
        status=stt[:, 0].to(torch.int32))


def _state_shapes(B, m, n, K) -> dict:
    shapes = dict(M=(B, m, n), W=(B, K, n), E=(B, K, K), prow=(B, n),
                  u=(B, n))
    shapes.update((k, (B, m)) for k in ("dupper", "dlower", "scaling",
                                        "immut", "act_up", "act_lo"))
    shapes.update((k, (B, K)) for k in ("simm", "dsl", "used", "sid", "slo",
                                        "lam", "lam_star"))
    return shapes


def _cuda_device(fn: str, dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {dev}")


def _check(fn: str, dev, items) -> None:
    """Raise unless every (name, tensor, shape, dtype) of ``items`` is a
    contiguous tensor of that dtype and shape on ``dev``."""
    for name, x, want, dtype in items:
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != want \
                or not x.is_contiguous():
            raise ValueError(
                f"{fn}: {name} must be a contiguous {dtype} {want} on "
                f"{dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")


def _state_items(s: SlotState, names):
    B, m, n = s.M.shape
    shapes = _state_shapes(B, m, n, s.E.shape[1])
    return [(name, getattr(s, name), shapes.get(name, (B,)),
             torch.int32 if name == "status" else torch.float32)
            for name in names]


def _launch(entry: str, tensors, dims, st: Settings, dev,
            tail=()) -> None:
    """Call the C entry ``entry`` with a host table of the tensors'
    device pointers (null for None), the int ``dims``, the tolerances, the
    Bland flag, the entry's own ``tail`` arguments and the stream."""
    ptrs = [0 if x is None else x.data_ptr() for x in tensors]
    table = (ctypes.c_void_p * len(ptrs))(*ptrs)
    rc = getattr(_build.library(), entry)(
        ctypes.addressof(table), *map(int, dims),
        float(st.dual_tol), float(st.primal_tol), float(st.pivot_tol),
        float(st.sing_tol), float(st.progress_tol), float(st.cycle_tol),
        int(int(st.pricing) == PRICING_BLAND), *tail,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, entry)


def run_slot_round(s: SlotState, st: Settings, n_true: int,
                   steps: int = STEPS) -> SlotState:
    """K2 wrapper: one round of ``steps`` iterations per lane; the CUDA
    kernel for CUDA tensors (f32 state, int32 status, contiguous), the
    plain twin for CPU tensors."""
    global launches
    dev = s.M.device
    if dev.type == "cpu":
        return run_slot_round_plain(s, st, n_true, steps)
    _cuda_device("run_slot_round", dev)
    B, m, n = s.M.shape
    K = s.E.shape[1]
    _check("run_slot_round", dev, _state_items(s, CONST + STATE))
    smem.check("run_slot_round (K2)", dict(m=m, n=n, K=K),
               smem.slot_floats(m, n, K), dev)
    outs = {name: torch.empty_like(getattr(s, name)) for name in STATE}
    if B == 0:
        return s
    _launch("slot_round_f32",
            [getattr(s, name) for name in CONST + STATE]
            + [outs[name] for name in STATE],
            (B, m, n, K, n_true, steps), st, dev)
    launches += 1
    return s._replace(**outs)


def slot_init(M, du, dl, sc, immut, n_true: int, fbound=None) -> SlotState:
    """Cold slot state from batch-leading LDP data, cast to f32 as the
    kernels take it; K = n_true + 1 slots."""
    B, m, n = M.shape
    f32 = torch.float32
    dev = M.device
    K = n_true + 1
    if fbound is None:
        fbound = torch.full((B,), DAQP_INF, dtype=f32, device=dev)

    def z(*shape, fill=0.0):
        return torch.full(shape, fill, dtype=f32, device=dev)

    def c(x):
        return x.to(f32).contiguous()

    return SlotState(
        M=c(M), dupper=c(du), dlower=c(dl), scaling=c(sc), immut=c(immut),
        fbound=c(fbound), act_up=z(B, m), act_lo=z(B, m),
        W=z(B, K, n), E=z(B, K, K), dsl=z(B, K), used=z(B, K),
        sid=z(B, K, fill=-1.0), slo=z(B, K), simm=z(B, K), lam=z(B, K),
        lam_star=z(B, K), pend=z(B), prow=z(B, n), plam=z(B), plo=z(B),
        pid=z(B, fill=-1.0), pdd=z(B), u=z(B, n), fval=z(B),
        best_fval=z(B, fill=-1.0), cycle=z(B), repaired=z(B),
        iterations=z(B),
        status=torch.full((B,), EXIT_RUNNING, dtype=torch.int32,
                          device=dev))


def _gram(W, used):
    """G = W W' on used slots, identity on free slots; (B, K, K)."""
    um = used[:, :, None] * used[:, None, :]
    G = torch.matmul(W, W.transpose(1, 2)) * um
    return G + torch.diag_embed(1.0 - used)


def _batched_gram_inverse(G, st: Settings):
    """(B, K, K) SPD -> (inverse, ok_lane) by Cholesky; a lane whose
    factorization fails (or is nonfinite) gets ok_lane False and the
    identity in its place.  Never raises.

    Beyond the JAX XLA path, a lane also fails when a pivot L_kk^2 (the
    Schur pivot of adding slot k after slots < k) is below the kernel's
    own add gate max(sing_tol, 1e-4 G_kk): an f32 Cholesky of an exactly
    singular Gram (n + 1 rows in R^n, as an over-capacity warm start
    places them when K = n + 1) can succeed on a rounding-positive pivot,
    and the E it yields led to lanes exiting OPTIMAL off by 2e-2 (the JAX
    package shows the same at n = 7, where its padded K is n + 1)."""
    K = G.shape[-1]
    L, info = torch.linalg.cholesky_ex(G)
    piv = torch.diagonal(L, dim1=1, dim2=2) ** 2
    gate = torch.clamp(1e-4 * torch.diagonal(G, dim1=1, dim2=2),
                       min=st.sing_tol)
    ok = (info == 0) & torch.isfinite(L).all(dim=2).all(dim=1) \
        & (piv >= gate).all(dim=1)
    eye = torch.eye(K, dtype=G.dtype, device=G.device)
    L = torch.where(ok[:, None, None], L, eye)
    E = torch.cholesky_solve(eye.expand_as(G), L)
    return E, ok & torch.isfinite(E).all(dim=2).all(dim=1)


def slot_activate(s: SlotState, up_mask, lo_mask,
                  st: Settings) -> SlotState:
    """Bulk-activate a prescribed starting set (equalities, warm starts;
    auxiliary.c:398-478): pack the flagged rows into the first slots and
    build E with one batched (B, K, K) Cholesky.  Rows beyond the slot
    capacity leave the table and the act masks; a lane whose set is
    numerically dependent is parked EXIT_REFACTOR.  ``up_mask`` /
    ``lo_mask`` are (B, m) 0/1; the initial duals are +-1 by side."""
    f32 = torch.float32
    B, m, _ = s.M.shape
    K = s.E.shape[1]
    dev = s.M.device
    up = up_mask.to(f32)
    lo = lo_mask.to(f32)
    act = torch.clamp(up + lo, max=1.0)
    rank = torch.cumsum(act, dim=1) - act
    iota_K = torch.arange(K, dtype=f32, device=dev)
    S = act[:, :, None] * (rank[:, :, None] == iota_K).to(f32)   # (B,m,K)
    nact = act.sum(1)
    W = torch.einsum('bmk,bmj->bkj', S, s.M)
    d_m = up * s.dupper + lo * s.dlower

    def pack(x):
        return torch.einsum('bmk,bm->bk', S, x)

    iota_m = torch.arange(m, dtype=f32, device=dev).expand(B, m)
    used = (iota_K[None, :]
            < torch.clamp(nact, max=K)[:, None]).to(f32)
    sid = pack(iota_m) * used - (1.0 - used)
    placed = S.sum(2)
    up = up * placed
    lo = lo * placed
    s2 = s._replace(W=W, used=used, sid=sid, slo=pack(lo),
                    simm=pack(s.immut), dsl=pack(d_m), act_up=up,
                    act_lo=lo, lam=pack(up - lo))
    E, ok = _batched_gram_inverse(_gram(W, used), st)
    ok = ok & (nact <= K)
    E = E * (used[:, :, None] * used[:, None, :])
    status = torch.where(ok, s.status, EXIT_REFACTOR).to(torch.int32)
    return s2._replace(E=E.contiguous(), status=status)


def repair_needed(s: SlotState) -> torch.Tensor:
    return (s.status == EXIT_REFACTOR) \
        | ((s.status == EXIT_CYCLE) & (s.repaired == 0))


def exact_repair(s: SlotState, st: Settings) -> SlotState:
    """Exact refactorization of E for parked / cycling lanes (daqp.c:66-85),
    a (B', K, K) Cholesky on just the lanes that need it."""
    need = repair_needed(s)
    idx = torch.nonzero(need).squeeze(1)
    used = s.used[idx]
    E_exact, ok = _batched_gram_inverse(_gram(s.W[idx], used), st)
    parked = s.status[idx] == EXIT_REFACTOR
    cyc = ~parked
    E_i = torch.where(ok[:, None, None], E_exact, s.E[idx]) \
        * (used[:, :, None] * used[:, None, :])
    status = torch.where(ok, EXIT_RUNNING, s.status[idx])
    status = torch.where(parked & ~ok, EXIT_CYCLE, status)
    okf = ok.to(torch.float32)
    drop = (cyc & ok).to(torch.float32)

    def put(x, vals):
        x = x.clone()
        x[idx] = vals.to(x.dtype)
        return x

    return s._replace(
        E=put(s.E, E_i), status=put(s.status, status),
        pend=put(s.pend, s.pend[idx] * (1.0 - drop)),
        repaired=put(s.repaired, torch.clamp(s.repaired[idx] + drop,
                                             max=1.0)),
        cycle=put(s.cycle, s.cycle[idx] * (1.0 - okf)),
        best_fval=put(s.best_fval, torch.where(ok, -1.0,
                                               s.best_fval[idx])))


def newton_refresh(s: SlotState) -> SlotState:
    """One Newton step E <- E (2I - G E) against the exactly rebuilt slot
    Gram, on lanes inside the contraction basin ||G E - I|| < 1/2."""
    um = s.used[:, :, None] * s.used[:, None, :]
    Iu = torch.diag_embed(s.used)
    P = torch.matmul(_gram(s.W, s.used), s.E)
    resid = (P - Iu).abs().amax(dim=(1, 2))
    E_new = torch.matmul(s.E, 2.0 * Iu - P) * um
    return s._replace(E=torch.where((resid < 0.5)[:, None, None], E_new,
                                    s.E).contiguous())


def polish(s: SlotState, st: Settings) -> SlotState:
    """One iterative-refinement step of (lam*, u) on optimal lanes after a
    Newton refresh of E, and a primal / dual re-check that re-opens a
    lane whose refined point is not optimal (auxiliary.c:497-588,
    daqp.c:47-63)."""
    s = newton_refresh(s)
    is_opt = s.status == EXIT_OPTIMAL
    r = (torch.einsum('bkj,bj->bk', s.W, s.u) - s.dsl) * s.used
    dlam = torch.einsum('bij,bj->bi', s.E, r)
    okl = is_opt & torch.isfinite(dlam).all(dim=1)
    step = torch.where(okl[:, None], dlam * s.used, 0.0)
    lam_star = s.lam_star + step
    u2 = s.u - torch.einsum('bkj,bk->bj', s.W, step)
    u2 = torch.where(okl[:, None], u2, s.u)
    mu = torch.einsum('bij,bj->bi', s.M, u2)
    blocked = ((s.act_up + s.act_lo) > 0) | (s.immut > 0)
    viol = (((s.dupper - mu) < -st.primal_tol * s.scaling)
            | ((mu - s.dlower) < -st.primal_tol * s.scaling)) & ~blocked
    up_bad = (lam_star < -st.dual_tol).to(s.slo.dtype)
    lo_bad = (lam_star > st.dual_tol).to(s.slo.dtype)
    dual_bad = (((s.slo * lo_bad + (1.0 - s.slo) * up_bad)
                 * s.used * (1.0 - s.simm)) > 0).any(dim=1)
    reopen = okl & (viol.any(dim=1) | dual_bad)
    return s._replace(
        lam_star=torch.where(okl[:, None], lam_star, s.lam_star),
        u=u2.contiguous(),
        fval=torch.where(okl, (u2 * u2).sum(1), s.fval),
        status=torch.where(reopen, EXIT_RUNNING, s.status).to(torch.int32))


def slot_solve(s: SlotState, st: Settings, n_true: int,
               steps: int = STEPS, max_rounds: int = MAX_ROUNDS,
               deadline=None) -> SlotState:
    """Kernel rounds of ``steps`` iterations until every lane is
    terminal, exact repair between rounds where a lane needs it, then two
    polish / re-open cycles; finally a still-running lane exits ITERLIMIT
    (iterations spent) or CYCLE.

    ``iter_limit`` (capped at ``steps * max_rounds``) acts at round
    granularity, as in the JAX ``slot_solve``, but per lane: a running
    lane whose iterations reached the limit, or which has had
    ``max_rounds`` live rounds, is held out of further rounds (the JAX
    loop counts rounds for the whole batch and keeps running every live
    lane while any lane is under the limit).

    ``deadline`` (``ops.check_deadline``) is checked before the first
    round and after each one, as in the JAX ``slot_solve``
    (pallas_slot.py:2230-2256): a lane running past it exits
    TIMELIMIT."""
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
            s = run_slot_round(s, st, n_true, steps)
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
    # A lane the second polish re-opened ended on kernel steps with no
    # refinement after them; f32 drift of E there left semidefinite prox
    # lanes OPTIMAL with their active rows not met (f64 KKT violation up
    # to 7.9e-3 on config 4).  One more polish refines every optimal
    # lane, and a lane it re-opens exits loud below instead of optimal.
    s = polish(s, st)

    done_running = (s.status == EXIT_RUNNING) | (s.status == EXIT_REFACTOR)
    status = torch.where(done_running & (s.iterations >= iter_limit),
                         EXIT_ITERLIMIT,
                         torch.where(done_running, EXIT_CYCLE, s.status))
    return s._replace(status=status.to(torch.int32))


def slot_refresh_bounds(s: SlotState, dupper, dlower) -> SlotState:
    """Replace the bounds ((B, m)) and re-derive the slot table's
    active-side bound values ``dsl`` from ``sid``/``slo``: the slot
    analogue of the reference's UPDATE_d re-update (utils.c:410-455), as
    ``pallas_slot.py:2317``; working set, rows and E persist."""
    m = dupper.shape[1]
    idx = s.sid.to(torch.int64)
    hit = (idx >= 0) & (idx < m) & (idx.to(s.sid.dtype) == s.sid)
    idx = idx.clamp(0, m - 1)
    du_sel = torch.where(hit, dupper.gather(1, idx), 0.0)
    dl_sel = torch.where(hit, dlower.gather(1, idx), 0.0)
    dsl = (s.slo * dl_sel + (1.0 - s.slo) * du_sel) * s.used
    return s._replace(dupper=dupper.contiguous(), dlower=dlower.contiguous(),
                      dsl=dsl.contiguous())


def reset_control(s: SlotState, run=None) -> SlotState:
    """The per-solve control reset of a warm re-solve (``mpc.py:105-111``
    with ``run`` None: every lane; ``batch.py:788-795`` with a (B,) bool
    ``run``): status RUNNING and the pending row dropped where ``run``,
    iterations, cycle and repaired zeroed and best_fval -1 on every
    lane."""
    if run is None:
        run = torch.ones_like(s.pend, dtype=torch.bool)
    return s._replace(
        status=torch.where(run, EXIT_RUNNING, s.status).to(torch.int32),
        iterations=torch.zeros_like(s.iterations),
        cycle=torch.zeros_like(s.cycle),
        repaired=torch.zeros_like(s.repaired),
        best_fval=torch.full_like(s.best_fval, -1.0),
        pend=torch.where(run, 0.0, s.pend))


def select_lanes(mask, a: SlotState, b: SlotState) -> SlotState:
    """Per lane: ``a`` where the (B,) bool ``mask`` holds, else ``b``."""
    def pick(x, y):
        return torch.where(mask.view((-1,) + (1,) * (x.dim() - 1)), x, y)
    return SlotState(*(pick(x, y) for x, y in zip(a, b)))


def _in_trouble(status) -> torch.Tensor:
    """A lane the between-round repair would have to fix: still RUNNING
    at the step cap, CYCLE or REFACTOR."""
    return (status == EXIT_RUNNING) | (status == EXIT_CYCLE) \
        | (status == EXIT_REFACTOR)


def solve_retry(s: SlotState, st: Settings, n_true: int, steps: int,
                round_fn=None) -> SlotState:
    """The segment kernels' warm solve: ``steps`` iterations of
    ``round_fn`` (default the twin ``run_slot_round_plain``; K2's
    ``run_slot_round`` replays a segment kernel's inner solve), then on
    CYCLE / REFACTOR the cold retry (``pallas_slot.py:834-870``): the
    lane's table, E, W, lam, u and fval are cleared and the step runs
    again, on those lanes alone.  ``iterations`` counts both attempts."""
    round_fn = round_fn or run_slot_round_plain
    s = round_fn(s, st, n_true, steps)
    cyc = (s.status == EXIT_CYCLE) | (s.status == EXIT_REFACTOR)
    if not host_any(cyc):
        return s
    c = cyc.to(s.E.dtype)
    keep = 1.0 - c
    cold = s._replace(
        used=s.used * keep[:, None], act_up=s.act_up * keep[:, None],
        act_lo=s.act_lo * keep[:, None], dsl=s.dsl * keep[:, None],
        slo=s.slo * keep[:, None], sid=s.sid * keep[:, None] - c[:, None],
        lam=s.lam * keep[:, None], lam_star=s.lam_star * keep[:, None],
        pend=s.pend * keep, u=s.u * keep[:, None], fval=s.fval * keep,
        best_fval=torch.where(cyc, -1.0, s.best_fval),
        cycle=s.cycle * keep, E=s.E * keep[:, None, None],
        W=s.W * keep[:, None, None],
        status=torch.where(cyc, EXIT_RUNNING, s.status).to(torch.int32))
    return select_lanes(cyc, round_fn(cold, st, n_true, steps), s)


def run_mpc_segment_plain(s: SlotState, duq, dlq, st: Settings,
                          n_true: int, steps: int = 64):
    """B3's twin in torch ops: P = duq.shape[1] warm horizon steps.  Per
    step each live lane refreshes dsl from the step's bounds, resets its
    control state, solves with the cold retry and records (u, fval,
    iterations, status); a lane that ends a step RUNNING, CYCLE or
    REFACTOR freezes: it raises ``failed`` and does no further step."""
    S, P, _ = duq.shape
    failed = torch.zeros(S, dtype=torch.bool, device=duq.device)
    useq, fvseq, itseq, stseq = [], [], [], []
    for p in range(P):
        live = ~failed
        s1 = reset_control(slot_refresh_bounds(s, duq[:, p], dlq[:, p]))
        s1 = solve_retry(s1, st, n_true, steps)
        failed = failed | (live & _in_trouble(s1.status))
        s = select_lanes(live, s1, s)
        useq.append(s.u)
        fvseq.append(s.fval)
        itseq.append(s.iterations)
        stseq.append(s.status)
    s = s._replace(dupper=duq[:, -1].contiguous(),
                   dlower=dlq[:, -1].contiguous())
    return (s, torch.stack(useq, 1), torch.stack(fvseq, 1),
            torch.stack(itseq, 1), torch.stack(stseq, 1),
            failed.to(duq.dtype))


# B3's bodies (mpc_segment.cu mpc_body): by shape (smem.mpc_horizon), the
# 128-thread step, the horizon step (K, n <= 64, m <= 128); the same bits
MPC_BODIES = {None: -1, "block": 0, "horizon": 1}


def run_mpc_segment(s: SlotState, duq, dlq, st: Settings, n_true: int,
                    steps: int = 64, body: str | None = None):
    """B3 wrapper: P = duq.shape[1] warm MPC horizon steps in one launch.

    ``duq``/``dlq`` (S, P, m) are the per-step bounds in LDP space.
    Returns ``(s', useq (S, P, n), fvseq (S, P), itseq (S, P),
    stseq (S, P) int32, failed (S,) f32)``, with the last step's bounds in
    ``s'.dupper``/``s'.dlower``.  A lane with ``failed > 0`` froze
    mid-segment; the driver redoes the segment on the per-step path.  The
    CUDA kernel runs on CUDA tensors, the plain twin on CPU tensors.
    ``body`` (a key of ``MPC_BODIES``) picks the kernel's body; by default
    the horizon body where ``smem.mpc_horizon`` holds, else the 128-thread
    one."""
    global mpc_launches
    dev = s.M.device
    if dev.type == "cpu":
        return run_mpc_segment_plain(s, duq, dlq, st, n_true, steps)
    _cuda_device("run_mpc_segment", dev)
    S, m, n = s.M.shape
    K = s.E.shape[1]
    P = duq.shape[1]
    f32 = torch.float32
    _check("run_mpc_segment", dev,
           _state_items(s, SEG_CONST + STATE)
           + [("duq", duq, (S, P, m), f32), ("dlq", dlq, (S, P, m), f32)])
    smem.check("run_mpc_segment (B3)", dict(m=m, n=n, K=K),
               smem.slot_floats(m, n, K), dev)
    if body == "horizon" and not smem.mpc_horizon(m, n, K):
        raise ValueError(f"run_mpc_segment (B3): the horizon body takes K, "
                         f"n <= {smem.HORIZON_K}, m <= {smem.HORIZON_M}; "
                         f"got m={m}, n={n}, K={K}")
    outs = {name: torch.empty_like(getattr(s, name)) for name in STATE}
    useq = torch.empty((S, P, n), dtype=f32, device=dev)
    fvseq = torch.empty((S, P), dtype=f32, device=dev)
    itseq = torch.empty((S, P), dtype=f32, device=dev)
    stseq = torch.empty((S, P), dtype=torch.int32, device=dev)
    failed = torch.empty((S,), dtype=f32, device=dev)
    if S:
        _launch("mpc_segment_f32",
                [getattr(s, name) for name in SEG_CONST] + [duq, dlq]
                + [getattr(s, name) for name in STATE]
                + [outs[name] for name in STATE]
                + [useq, fvseq, itseq, stseq, failed],
                (S, m, n, K, n_true, steps, P), st, dev,
                tail=(MPC_BODIES[body],))
        mpc_launches += 1
    s2 = s._replace(**outs, dupper=duq[:, -1].contiguous(),
                    dlower=dlq[:, -1].contiguous())
    return s2, useq, fvseq, itseq, stseq, failed


# per-lane carries of the proximal segment, in the order of the CUDA
# entry (prox_segment.cu, enum Ptr): x (B, n), lane_run, stall,
# best_diff (B,) f32, lflag (B,) int32, tot (B,) f32
PROX_LANE = ("x", "lane_run", "stall", "best_diff", "lflag", "tot")


def run_prox_segment_plain(s: SlotState, x, lane_run, stall, best_diff,
                           lflag, tot, Rinv, fz, bus, bls, eps, tst,
                           st: Settings, n_true: int, P: int = 8,
                           steps: int = 64):
    """B4's twin in torch ops: up to P proximal passes.  Per pass, on the
    lanes that run (``lane_run > 0`` and not failed): v = Rinv'(f - eps
    x), d = b_s + M v, dsl refresh, control reset, warm solve with the
    cold retry, x_new = Rinv (u - v), the fixed-point / stagnation /
    over-relaxation rules (``pallas_slot.py:1056-1084``) and
    ``tot += iterations``.  A lane whose solve stays in trouble raises
    ``failed`` and keeps ``lane_run``; a lane that stops running is left
    as it is."""
    B = x.shape[0]
    failed = torch.zeros(B, dtype=torch.bool, device=x.device)
    du0, dl0 = s.dupper, s.dlower
    for _ in range(P):
        run = (lane_run > 0) & ~failed
        if not host_any(run):
            break
        v = torch.einsum('bji,bj->bi', Rinv, fz - eps[:, None] * x)
        Mv = torch.einsum('bmj,bj->bm', s.M, v)
        s1 = reset_control(slot_refresh_bounds(s, bus + Mv, bls + Mv))
        s1 = solve_retry(s1, st, n_true, steps)
        bad = _in_trouble(s1.status)
        run2 = ~bad
        x_new = torch.einsum('bij,bj->bi', Rinv, s1.u - v)
        max_diff = (x_new - x).abs().amax(1)
        inner_ok = (s1.status > 0) & run2
        improved = max_diff < 0.9 * best_diff
        stall1 = torch.where(improved | ~run2, 0.0, stall + 1.0)
        converged = (eps == 0.0) | (max_diff < tst) | (stall1 >= 8.0)
        froze = (s1.iterations <= 1.0) & ~converged & inner_ok
        x1 = torch.where((run2 & froze)[:, None], x + 1.5 * (x_new - x),
                         torch.where(run2[:, None], x_new, x))
        done = run2 & (converged | ~(s1.status > 0))
        lflag1 = torch.where(done, torch.where(s1.status > 0, EXIT_OPTIMAL,
                                               s1.status), lflag)
        s = select_lanes(run, s1, s)
        x = torch.where(run[:, None], x1, x)
        stall = torch.where(run, stall1, stall)
        best_diff = torch.where(run, torch.minimum(max_diff, best_diff),
                                best_diff)
        lflag = torch.where(run, lflag1, lflag).to(torch.int32)
        lane_run = torch.where(run & done, 0.0, lane_run)
        tot = torch.where(run, tot + s1.iterations, tot)
        failed = failed | (run & bad)
    return (s._replace(dupper=du0, dlower=dl0), x, lane_run, stall,
            best_diff, lflag, tot, failed.to(x.dtype))


def run_prox_segment(s: SlotState, x, lane_run, stall, best_diff, lflag,
                     tot, Rinv, fz, bus, bls, eps, tst, st: Settings,
                     n_true: int, P: int = 8, steps: int = 64):
    """B4 wrapper: up to P proximal outer passes in one launch.

    Batch-leading operands: ``x`` (B, n) outer iterate, ``lane_run``/
    ``stall``/``best_diff``/``tot`` (B,) f32, ``lflag`` (B,) int32,
    ``Rinv`` (B, n, n), ``fz`` (B, n), ``bus``/``bls`` (B, m) scaled user
    bounds, ``eps``/``tst`` (B,).  Returns the updated ``(s, x, lane_run,
    stall, best_diff, lflag, tot, failed)``; lanes with ``failed > 0``
    froze mid-segment and continue on the driver's per-pass path.  The
    CUDA kernel runs on CUDA tensors, the plain twin on CPU tensors."""
    global prox_launches
    dev = s.M.device
    if dev.type == "cpu":
        return run_prox_segment_plain(s, x, lane_run, stall, best_diff,
                                      lflag, tot, Rinv, fz, bus, bls, eps,
                                      tst, st, n_true, P, steps)
    _cuda_device("run_prox_segment", dev)
    B, m, n = s.M.shape
    K = s.E.shape[1]
    f32 = torch.float32
    lane = dict(x=x, lane_run=lane_run, stall=stall, best_diff=best_diff,
                lflag=lflag, tot=tot)
    _check("run_prox_segment", dev,
           _state_items(s, SEG_CONST + STATE)
           + [("Rinv", Rinv, (B, n, n), f32), ("fz", fz, (B, n), f32),
              ("bus", bus, (B, m), f32), ("bls", bls, (B, m), f32),
              ("eps", eps, (B,), f32), ("tst", tst, (B,), f32)]
           + [(k, v, (B, n) if k == "x" else (B,),
               torch.int32 if k == "lflag" else f32)
              for k, v in lane.items()])
    smem.check("run_prox_segment (B4)", dict(m=m, n=n, K=K),
               smem.prox_floats(m, n, K), dev)
    outs = {name: torch.empty_like(getattr(s, name)) for name in STATE}
    lane_out = {k: torch.empty_like(v) for k, v in lane.items()}
    failed = torch.empty((B,), dtype=f32, device=dev)
    if B:
        _launch("prox_segment_f32",
                [getattr(s, name) for name in SEG_CONST]
                + [Rinv, fz, bus, bls, eps, tst]
                + [getattr(s, name) for name in STATE]
                + [lane[k] for k in PROX_LANE]
                + [outs[name] for name in STATE]
                + [lane_out[k] for k in PROX_LANE] + [failed],
                (B, m, n, K, n_true, steps, P), st, dev)
        prox_launches += 1
    else:
        lane_out = lane
    return (s._replace(**outs),) + tuple(lane_out[k] for k in PROX_LANE) \
        + (failed,)


# per-lane carries of the AVI segment, in the order of the CUDA entry
# (avi_segment.cu, enum Ptr): x, y, xold (B, n); minres, ctr, tlim,
# lane_run (B,) f32, lflag (B,) int32, tot (B,) f32
AVI_LANE = ("x", "y", "xold", "minres", "ctr", "tlim", "lane_run", "lflag",
            "tot")
# per-lane matrices of the AVI segment: Rinv, G1, G2, G3, Hri (B, n, n)
AVI_MATS = ("Rinv", "G1", "G2", "G3", "Hri")


def run_avi_segment_plain(s: SlotState, x, y, xold, minres, ctr, tlim,
                          lane_run, lflag, tot, Rinv, G1, G2, G3, Hri, fz,
                          bus, bls, st: Settings, n_true: int, P: int = 8,
                          steps: int = 64, bounds: bool = False):
    """B5's twin in torch ops: up to P Douglas-Rachford passes of the
    batched AVI (avi.c:6-101, ``pallas_slot.py:1654-1757``).  Per pass, on
    the lanes that run (``lane_run > 0``, not failed, no KKT request):
    v = Rinv'(G1 x + f), d = b_s + M v, dsl refresh, control reset, warm
    solve with the cold retry, y = Rinv (u - v), the Newton-step
    bookkeeping (a worse residual at the limit reverts x to xold and
    raises tlim by 5, at most 30), the stable-set counter, and for a lane
    that is neither stable for tlim passes (``kkt_req``, frozen) nor
    failed the DR update x = Hri (G2 y + G3 x); ``tot += iterations``.
    A lane whose solve stays in trouble raises ``failed`` and keeps
    ``lane_run``; one whose solve ends loud stops with its flag.  A lane
    that stops is left as it is.  With ``bounds`` the last pass's bounds
    (du, dl) follow, NaN on a lane that ran no pass."""
    B = x.shape[0]
    failed = torch.zeros(B, dtype=torch.bool, device=x.device)
    kkt = torch.zeros_like(failed)
    du0, dl0 = s.dupper, s.dlower
    du_o = torch.full_like(bus, float("nan"))
    dl_o = torch.full_like(bls, float("nan"))
    carry = (x, y, xold, minres, ctr, tlim, lane_run, lflag, tot)
    for _ in range(P):
        run = (carry[6] > 0) & ~failed & ~kkt
        if not host_any(run):
            break
        v, du, dl = avi_pass_bounds(s, carry[0], Rinv, G1, fz, bus, bls)
        s1 = pass_solve(s, du, dl, run, st, n_true, steps)
        *carry, bad, do_kkt = avi_pass_outer(carry, run, v, s1.u, s1.status,
                                             s1.iterations, Rinv, G2, G3,
                                             Hri)
        s = select_lanes(run, s1, s)
        du_o = torch.where(run[:, None], du, du_o)
        dl_o = torch.where(run[:, None], dl, dl_o)
        failed = failed | bad
        kkt = kkt | do_kkt
    out = (s._replace(dupper=du0, dlower=dl0), *carry,
           failed.to(x.dtype), kkt.to(x.dtype))
    return out + (du_o, dl_o) if bounds else out


def avi_pass_bounds(s: SlotState, x, Rinv, G1, fz, bus, bls):
    """One AVI pass's v = Rinv'(G1 x + f) and bounds d = b_s + M v
    (``pallas_slot.py:1658-1662``): (v, du, dl)."""
    v = torch.einsum('bji,bj->bi', Rinv,
                     torch.einsum('bij,bj->bi', G1, x) + fz)
    Mv = torch.einsum('bmj,bj->bm', s.M, v)
    return v, bus + Mv, bls + Mv


def pass_solve(s: SlotState, du, dl, run, st: Settings, n_true: int,
               steps: int = 64, round_fn=None) -> SlotState:
    """One segment pass's inner solve (AVI: ``pallas_slot.py:1663-1713``;
    LP: ``:1287-1338``) on the lanes where ``run`` holds, with the bounds
    (du, dl): dsl refresh, the control reset and the warm solve with the
    cold retry (``solve_retry`` with ``round_fn``; K2's ``run_slot_round``
    replays the kernel's).  Other lanes are held."""
    s1 = reset_control(slot_refresh_bounds(s, du, dl), run)
    s1 = s1._replace(status=torch.where(run, s1.status, _HELD)
                     .to(torch.int32))
    return solve_retry(s1, st, n_true, steps, round_fn)


def avi_pass_outer(carry, run, v, u, status, iterations, Rinv, G2, G3, Hri):
    """The second half of one AVI pass (avi.c:44-96, ``pallas_slot.py:
    1715-1754``) from the inner solve's (u, status, iterations): ``failed``
    where the solve stayed in trouble, y = Rinv (u - v), the Newton-step
    bookkeeping (a worse residual at the limit reverts x to xold and raises
    tlim by 5, at most 30), the stable-set counter, ``kkt_req`` for a lane
    stable for tlim passes, the DR update x = Hri (G2 y + G3 x) for the
    others, a loud solve's flag and ``tot += iterations``.  ``carry`` is
    the tuple of ``AVI_LANE``; returns it updated, then (failed, kkt_req)
    as (B,) bool."""
    x, y, xold, minres, ctr, tlim, lane_run, lflag, tot = carry

    def mv(A, w):
        return torch.einsum('bij,bj->bi', A, w)

    bad = run & _in_trouble(status)
    run2 = run & ~bad
    inner_ok = (status > 0) & run2
    y_in = mv(Rinv, u - v)
    at_limit = (ctr == tlim) & run2
    res2 = ((x - y_in) ** 2).sum(1)
    worse = at_limit & (res2 > minres)
    x1 = torch.where(worse[:, None], xold, x)
    tlim = torch.where(worse, torch.clamp(tlim + 5.0, max=30.0), tlim)
    minres = torch.where(at_limit & ~worse, res2, minres)
    y = torch.where((run2 & ~worse)[:, None], y_in, y)
    stable = (iterations <= 1.0) & run2
    ctr = torch.where(stable, ctr + 1.0, torch.where(run2, 0.0, ctr))
    do_kkt = stable & (ctr == tlim) & inner_ok
    move = run2 & ~do_kkt & inner_ok
    x_dr = mv(Hri, mv(G2, y) + mv(G3, x1))
    x = torch.where(move[:, None], x_dr, x1)
    done = run2 & ~(status > 0)
    lflag = torch.where(done, status, lflag).to(torch.int32)
    lane_run = torch.where(done, 0.0, lane_run)
    tot = torch.where(run, tot + iterations, tot)
    return x, y, xold, minres, ctr, tlim, lane_run, lflag, tot, bad, do_kkt


def run_avi_segment(s: SlotState, x, y, xold, minres, ctr, tlim, lane_run,
                    lflag, tot, Rinv, G1, G2, G3, Hri, fz, bus, bls,
                    st: Settings, n_true: int, P: int = 8, steps: int = 64,
                    bounds: bool = False):
    """B5 wrapper: up to P Douglas-Rachford AVI passes in one launch.

    Batch-leading operands: the carries of ``AVI_LANE`` (x, y, xold
    (B, n); minres, ctr, tlim, lane_run, tot (B,) f32; lflag (B,) int32),
    the per-lane matrices Rinv (the LDP factor of sym(H) + rho I), G1 =
    H - sym(H) - rho I, G2 = sym(H)/2 + rho I, G3 = H - sym(H)/2 and Hri =
    (H + rho I)^-1 (B, n, n), f as ``fz`` (B, n) and the scaled user bounds
    ``bus``/``bls`` (B, m).  Returns ``(s', x, y, xold, minres, ctr, tlim,
    lane_run, lflag, tot, failed, kkt_req)``, the last two (B,) f32 freeze
    channels: a lane with ``kkt_req`` waits for the driver's exact KKT
    step, one with ``failed`` for its per-pass resume.  With ``bounds``
    the last pass's bounds (du, dl) (B, m) follow, NaN on a lane that ran
    no pass.  The CUDA kernel runs on CUDA tensors, the plain twin on CPU
    tensors."""
    global avi_launches
    args = (x, y, xold, minres, ctr, tlim, lane_run, lflag, tot)
    mats = (Rinv, G1, G2, G3, Hri)
    dev = s.M.device
    if dev.type == "cpu":
        return run_avi_segment_plain(s, *args, *mats, fz, bus, bls, st,
                                     n_true, P, steps, bounds)
    _cuda_device("run_avi_segment", dev)
    B, m, n = s.M.shape
    K = s.E.shape[1]
    f32 = torch.float32
    lane = dict(zip(AVI_LANE, args))
    _check("run_avi_segment", dev,
           _state_items(s, SEG_CONST + STATE)
           + [(k, v, (B, n, n), f32) for k, v in zip(AVI_MATS, mats)]
           + [("fz", fz, (B, n), f32), ("bus", bus, (B, m), f32),
              ("bls", bls, (B, m), f32)]
           + [(k, v, (B, n) if k in ("x", "y", "xold") else (B,),
               torch.int32 if k == "lflag" else f32)
              for k, v in lane.items()])
    smem.check("run_avi_segment (B5)", dict(m=m, n=n, K=K),
               smem.avi_floats(m, n, K, smem.available(dev)), dev)
    outs = {name: torch.empty_like(getattr(s, name)) for name in STATE}
    lane_out = {k: torch.empty_like(v) for k, v in lane.items()}
    failed = torch.empty((B,), dtype=f32, device=dev)
    kkt = torch.empty((B,), dtype=f32, device=dev)
    d_out = [torch.full_like(bus, float("nan")),
             torch.full_like(bls, float("nan"))] if bounds else [None, None]
    if B:
        _launch("avi_segment_f32",
                [getattr(s, name) for name in SEG_CONST] + list(mats)
                + [fz, bus, bls]
                + [getattr(s, name) for name in STATE]
                + [lane[k] for k in AVI_LANE]
                + [outs[name] for name in STATE]
                + [lane_out[k] for k in AVI_LANE] + [failed, kkt] + d_out,
                (B, m, n, K, n_true, steps, P), st, dev)
        avi_launches += 1
    else:
        lane_out = lane
    out = (s._replace(**outs),) + tuple(lane_out[k] for k in AVI_LANE) \
        + (failed, kkt)
    return out + tuple(d_out) if bounds else out


def slot_add_row(s: SlotState, row, lo, dval, mask, st: Settings,
                 n_true: int) -> SlotState:
    """Bordered addition of one constraint per lane into the slot table,
    outside any kernel (``pallas_slot.py:2273``, XLA in the JAX package):
    row ``row`` (B,) int64 of M on side ``lo`` (B,) 0/1 with active-side
    bound ``dval`` (B,) in LDP units, where ``mask`` (B,) 0/1.  g = W m_j,
    a = E g, sval = m_j'm_j - g'a; the add goes into the first free slot
    when sval >= max(sing_tol, 1e-4 m_j'm_j) and fewer than ``n_true``
    slots are used, with E += (1/sval) w w', w = a o used - e_free.  A
    gated or masked lane is left as it is."""
    B, m, n = s.M.shape
    K = s.E.shape[1]
    dt = s.E.dtype
    iota_K = torch.arange(K, dtype=dt, device=s.E.device)[None, :]
    mj = s.M.gather(1, row.view(B, 1, 1).expand(B, 1, n))[:, 0]
    g = torch.einsum('bkj,bj->bk', s.W, mj) * s.used
    a = torch.einsum('bij,bj->bi', s.E, g)
    dii = (mj * mj).sum(1)
    sval = dii - (g * a).sum(1)
    gate = torch.clamp(1e-4 * dii, min=st.sing_tol)
    ok = mask.to(dt) * (sval >= gate).to(dt) \
        * (s.used.sum(1) < n_true).to(dt)
    free, _ = _first_min(iota_K + s.used * DAQP_INF)
    oh_free = (iota_K == free).to(dt) * ok[:, None]
    w = a * s.used - (iota_K == free).to(dt)
    c = ok / torch.where(sval != 0, sval, 1.0)
    oh_m = torch.nn.functional.one_hot(row, m).to(dt) * ok[:, None]
    lo = lo.to(dt)[:, None]
    return s._replace(
        E=(s.E + c[:, None, None] * w[:, :, None] * w[:, None, :])
        .contiguous(),
        W=(s.W + oh_free[:, :, None] * mj[:, None, :]).contiguous(),
        used=torch.clamp(s.used + oh_free, max=1.0),
        sid=s.sid + oh_free * (row.to(dt)[:, None] + 1.0),
        slo=s.slo + oh_free * lo,
        dsl=s.dsl + oh_free * dval.to(dt)[:, None],
        lam=s.lam + oh_free * (1.0 - 2.0 * lo),
        act_up=torch.clamp(s.act_up + oh_m * (1.0 - lo), max=1.0),
        act_lo=torch.clamp(s.act_lo + oh_m * lo, max=1.0))


def lp_grad_step(s: SlotState, x_new, x_old, need, bur, blr, st: Settings,
                 n_true: int):
    """The LP tier's gradient step (daqp_prox.c:201-271; ``batch.py:
    1106-1147`` and B6's ``pallas_slot.py:1363-1420``): along the ray
    x_new + alpha (x_new - x_old), the first blocking bound of an original
    row that is neither active nor immutable (A x = M x / scaling against
    the raw bounds ``bur``/``blr`` (B, m); the lowest row on ties, the
    lower side only where its step is strictly shorter) is activated by
    ``slot_add_row`` with its bound from the state's d, on the lanes where
    ``need`` holds and a row blocks.  Returns ``(s', x2, found)``: x2 is
    the point on the blocking bound where the step applied, else x_new."""
    BIG = DAQP_INF
    delta = x_new - x_old
    ax = torch.einsum('bmj,bj->bm', s.M, x_new) / s.scaling
    ds = torch.einsum('bmj,bj->bm', s.M, delta) / s.scaling
    skip = ((s.act_up + s.act_lo) > 0) | (s.immut > 0)
    up_ok = ~skip & (ds > 0) & (bur < BIG)
    lo_ok = ~skip & (ds < 0) & (blr > -BIG)
    a_up = torch.where(up_ok, (bur - ax) / torch.where(up_ok, ds, 1.0), BIG)
    a_lo = torch.where(lo_ok, (blr - ax) / torch.where(lo_ok, ds, 1.0), BIG)
    j, alpha = _first_min(torch.minimum(a_up, a_lo))
    found = alpha[:, 0] < BIG
    apply = need & found
    x2 = torch.where(apply[:, None], x_new + alpha * delta, x_new)
    is_lo = a_lo.gather(1, j) < a_up.gather(1, j)
    dval = torch.where(is_lo, s.dlower.gather(1, j), s.dupper.gather(1, j))
    s = slot_add_row(s, j[:, 0], is_lo[:, 0], dval[:, 0], apply, st, n_true)
    return s, x2, found


# per-lane carries of the LP segment, in the order of the CUDA entry
# (lp_segment.cu, enum Ptr): x (B, n); eps, stall, best, lane_run (B,)
# f32; lflag (B,) int32; tot, passes (B,) f32
LP_LANE = ("x", "eps", "stall", "best", "lane_run", "lflag", "tot", "passes")


def run_lp_segment_plain(s: SlotState, x, eps, stall, best, lane_run,
                         lflag, tot, passes, fz, bus, bls, bur, blr,
                         st: Settings, n_true: int, eta: float, P: int = 10,
                         steps: int = 192, bounds: bool = False):
    """B6's twin in torch ops: up to P adaptive-eps LP passes
    (``_lp_kernel_body``, ``pallas_slot.py:1280-1443``; Rinv = I).  Per
    pass, on the lanes that run (``lane_run > 0``, not failed): the bounds
    (``lp_pass_bounds``), the warm solve with the cold retry
    (``pass_solve``) and the outer half (``lp_pass_outer``).  A lane
    whose solve stays in trouble raises ``failed`` and keeps
    ``lane_run``; one whose solve ends loud stops with its flag and keeps
    its last x.  A lane that stops is left as it is.  With ``bounds`` the
    last pass's bounds (du, dl) follow, NaN on a lane that ran no pass."""
    B = x.shape[0]
    failed = torch.zeros(B, dtype=torch.bool, device=x.device)
    du0, dl0 = s.dupper, s.dlower
    du_o = torch.full_like(bus, float("nan"))
    dl_o = torch.full_like(bls, float("nan"))
    carry = (x, eps, stall, best, lane_run, lflag, tot, passes)
    for _ in range(P):
        run = (carry[4] > 0) & ~failed
        if not host_any(run):
            break
        v, du, dl = lp_pass_bounds(s, carry[0], carry[1], fz, bus, bls)
        s1 = pass_solve(s, du, dl, run, st, n_true, steps)
        s1, carry, bad = lp_pass_outer(s1, carry, run, v, bur, blr, st,
                                       n_true, eta)
        s = select_lanes(run, s1, s)
        du_o = torch.where(run[:, None], du, du_o)
        dl_o = torch.where(run[:, None], dl, dl_o)
        failed = failed | bad
    out = (s._replace(dupper=du0, dlower=dl0), *carry,
           failed.to(x.dtype))
    return out + (du_o, dl_o) if bounds else out


def lp_pass_bounds(s: SlotState, x, eps, fz, bus, bls):
    """One LP pass's v = f eps - x and bounds d = b_s + M v
    (``pallas_slot.py:1285-1288``): (v, du, dl)."""
    v = fz * eps[:, None] - x
    Mv = torch.einsum('bmj,bj->bm', s.M, v)
    return v, bus + Mv, bls + Mv


def lp_pass_outer(s1: SlotState, carry, run, v, bur, blr, st: Settings,
                  n_true: int, eta: float):
    """The second half of one LP pass (``pallas_slot.py:1340-1441``) from
    the inner solve's state ``s1`` on the lanes where ``run`` holds:
    ``failed`` where the solve stayed in trouble; x_new = u - v; the
    fixed-point test ||x_new - x||_inf < eta eps; the stagnation count on
    ||x_new - x||_inf / eps (three non-improving vertex passes of one
    iteration converge); the gradient step (``lp_grad_step``) on a lane
    whose one-iteration solve left it off a vertex, UNBOUNDED where no
    row blocks; eps x10 on such a lane and x0.9 otherwise (capped at 1e3,
    from the lane's second pass on); a lane exiting on an inner failure
    keeps its x; ``tot``/``passes``.  ``carry`` is the tuple of
    ``LP_LANE``; returns (s1 after the gradient step, the carries updated
    on the ``run`` lanes, failed (B,) bool)."""
    x, eps, stall, best, lane_run, lflag, tot, passes = carry
    stt, it = s1.status, s1.iterations
    bad = run & _in_trouble(stt)
    run2 = run & ~bad
    inner_ok = (stt > 0) & run2
    x_new = s1.u - v
    it1 = it <= 1.0
    at_vx = s1.used.sum(1) >= n_true
    diff = (x_new - x).abs().amax(1)
    ndiff = diff / eps
    improved = ndiff < 0.9 * best
    stall1 = torch.where(improved | ~it1 | ~at_vx | ~run2, 0.0, stall + 1.0)
    converged = (diff < eta * eps) | (inner_ok & (stall1 >= 3.0))
    need = it1 & ~at_vx & ~converged & inner_ok
    s1, x2, found = lp_grad_step(s1, x_new, x, need, bur, blr, st, n_true)
    unbounded = need & ~found
    grow = it1 & ~at_vx
    done = run2 & (converged | ~(stt > 0) | unbounded)
    lflag1 = torch.where(unbounded, EXIT_UNBOUNDED,
                         torch.where(stt > 0, EXIT_OPTIMAL, stt))
    carry = (
        torch.where((run2 & ~(done & ~(stt > 0)))[:, None], x2, x),
        torch.where((passes > 0) & run2, torch.clamp(
            torch.where(grow, eps * 10.0, eps * 0.9), max=1e3), eps),
        torch.where(run, stall1, stall),
        torch.where(run, torch.minimum(ndiff, best), best),
        torch.where(done, 0.0, lane_run),
        torch.where(done, lflag1, lflag).to(torch.int32),
        torch.where(run, tot + it, tot),
        passes + run.to(passes.dtype))
    return s1, carry, bad


def run_lp_segment(s: SlotState, x, eps, stall, best, lane_run, lflag, tot,
                   passes, fz, bus, bls, bur, blr, st: Settings, n_true: int,
                   eta: float, P: int = 10, steps: int = 192,
                   bounds: bool = False):
    """B6 wrapper: up to P adaptive-eps LP outer passes in one launch,
    the gradient step included.

    Batch-leading operands: the carries of ``LP_LANE`` (x (B, n); eps,
    stall, best, lane_run, tot, passes (B,) f32; lflag (B,) int32), f as
    ``fz`` (B, n), the scaled bounds ``bus``/``bls`` and the raw bounds
    ``bur``/``blr`` (B, m), and the fixed-point tolerance ``eta``.
    Returns ``(s', x, eps, stall, best, lane_run, lflag, tot, passes,
    failed)``; a lane with ``failed > 0`` froze mid-segment and may
    resume in the next launch.  The state's ``dupper``/``dlower`` come
    back as they went in.  With ``bounds`` the last pass's bounds (du, dl)
    (B, m) follow, NaN on a lane that ran no pass.  The CUDA kernel runs
    on CUDA tensors, the plain twin on CPU tensors."""
    global lp_launches
    args = (x, eps, stall, best, lane_run, lflag, tot, passes)
    data = (fz, bus, bls, bur, blr)
    dev = s.M.device
    if dev.type == "cpu":
        return run_lp_segment_plain(s, *args, *data, st, n_true, eta, P,
                                    steps, bounds)
    _cuda_device("run_lp_segment", dev)
    B, m, n = s.M.shape
    K = s.E.shape[1]
    f32 = torch.float32
    lane = dict(zip(LP_LANE, args))
    _check("run_lp_segment", dev,
           _state_items(s, SEG_CONST + STATE)
           + [(k, v, (B, n) if k == "fz" else (B, m), f32)
              for k, v in zip(("fz", "bus", "bls", "bur", "blr"), data)]
           + [(k, v, (B, n) if k == "x" else (B,),
               torch.int32 if k == "lflag" else f32)
              for k, v in lane.items()])
    smem.check("run_lp_segment (B6)", dict(m=m, n=n, K=K),
               smem.lp_floats(m, n, K, smem.available(dev)), dev)
    outs = {name: torch.empty_like(getattr(s, name)) for name in STATE}
    lane_out = {k: torch.empty_like(v) for k, v in lane.items()}
    failed = torch.empty((B,), dtype=f32, device=dev)
    d_out = [torch.full_like(bus, float("nan")),
             torch.full_like(bls, float("nan"))] if bounds else [None, None]
    if B:
        _launch("lp_segment_f32",
                [getattr(s, name) for name in SEG_CONST] + list(data)
                + [getattr(s, name) for name in STATE]
                + [lane[k] for k in LP_LANE]
                + [outs[name] for name in STATE]
                + [lane_out[k] for k in LP_LANE] + [failed] + d_out,
                (B, m, n, K, n_true, steps, P), st, dev, tail=(float(eta),))
        lp_launches += 1
    else:
        lane_out = lane
    out = (s._replace(**outs),) + tuple(lane_out[k] for k in LP_LANE) \
        + (failed,)
    return out + tuple(d_out) if bounds else out


def slot_duals_dense(s: SlotState) -> torch.Tensor:
    """Slot duals scattered to a dense (B, m) dual, rescaled by the row
    normalization (daqp.c:135-138, api.c:449-453)."""
    m = s.M.shape[1]
    iota_m = torch.arange(m, dtype=s.sid.dtype, device=s.sid.device)
    oh = (s.sid[:, :, None] == iota_m).to(s.E.dtype)          # (B, K, m)
    lam_m = torch.einsum('bkm,bk->bm', oh, s.lam_star * s.used)
    return lam_m * s.scaling
