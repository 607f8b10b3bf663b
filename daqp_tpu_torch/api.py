"""The single-instance public API: one-shot solves.

Counterpart of ``daqp_tpu/api.py:24-235`` (``solve``, ``quadprog``,
``linprog``, ``avi``; its ``_as_settings`` is ``types.as_settings``), the
reference's ``daqp.solve`` (interfaces/daqp-python/daqp.pyx:66-219) and
its C dispatch (``daqp_solve``, src/api.c:8-53), in the JAX package's
order: an AVI (``avi_solver.avi_core``), BINARY sense bits (branch and
bound, ``bnb.bnb_core``), a hierarchy (``hierarchical.hiqp_core``), an LP
(``prox.linprog_core``), else a dense convex QP
(``prox.solve_convex_or_prox``: one LDP solve for a positive definite H,
the proximal outer loop for a semidefinite one).

A solve runs on the card unless the caller asks for the CPU (CPU tensors
or ``device="cpu"``), as the batched entries do
(``batch.resolve_device``); ``dtype=None`` takes
``torch.get_default_dtype()``.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .types import (BINARY, EXIT_TIMELIMIT, SOFT, Result, SoftWeights,
                    as_settings)


def _host(x, dtype=None):
    """``x`` (an array, list or tensor) as a numpy array of its own on the
    host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.array(x, dtype=dtype)


def _soft_weights(soft_weights, m: int, st, dtype, dev):
    """``soft_weights`` as tensors: a ``SoftWeights``, a dict of its
    fields (missing ones: d = 0, rho = rho_soft, api.c:355-360), or a
    plain (m,) penalty per row."""
    def t(x):
        return torch.as_tensor(x, device=dev).to(dtype)

    if soft_weights is None:
        return None
    if isinstance(soft_weights, SoftWeights):
        return SoftWeights(*map(t, soft_weights))
    if isinstance(soft_weights, dict):
        zm, rm = np.zeros(m), np.full(m, float(st.rho_soft))
        return SoftWeights(d_ls=t(soft_weights.get('d_ls', zm)),
                           d_us=t(soft_weights.get('d_us', zm)),
                           rho_ls=t(soft_weights.get('rho_ls', rm)),
                           rho_us=t(soft_weights.get('rho_us', rm)))
    return t(soft_weights)


def solve(H=None, f=None, A=None, bupper=None, blower=None, sense=None,
          ms: Optional[int] = None, break_points=None, settings=None,
          dtype=None, is_avi: bool = False, primal_start=None,
          dual_start=None, prefactored: bool = False, soft_weights=None,
          f64_backstop: Optional[bool] = None, device=None) -> Result:
    """One-shot solve of min 0.5 x'Hx + f'x s.t. blower <= [x[:ms]; A x]
    <= bupper; returns a ``Result``.

    ``bupper`` / ``blower`` have length ms + A.shape[0]; ``blower=None``
    is -inf.  ``primal_start`` / ``dual_start`` warm-start the working
    set (``warmstart``); ``prefactored=True`` takes H as the upper
    Cholesky factor R of H = R'R (problem_type 2, utils.c:167-176);
    ``soft_weights`` gives SOFT rows per-row penalties (a plain array) or
    slack bounds and per-side weights (a ``SoftWeights`` or a dict of
    its fields); ``settings.time_limit`` > 0 sets a wall-clock deadline.

    ``H=None`` solves an LP (with ``break_points``, a hierarchy in the
    identity metric); ``is_avi`` an affine variational inequality; BINARY
    sense bits branch and bound (``nodes`` counts the nodes);
    ``break_points`` with more than one level the lexicographic
    hierarchy.

    ``f64_backstop``: an f32 solve that exits with a negative flag other
    than the time limit is solved once more in f64, and so is an f32 LP
    (``H=None``) whose positive exit fails the f64 KKT gate of 1e-5
    (``batch.kkt_residuals``): at a nearly degenerate vertex an f32 exit
    can be a neighbouring vertex.  The default (None) turns it on for
    LPs only, as the JAX package does (``daqp_tpu/api.py:176-213``): the
    QP paths are f32-robust.  It costs one read of the flag and, for a
    positive LP exit, the KKT check on the host."""
    from .batch import resolve_device
    dev = resolve_device((H, f, A, bupper, blower, sense, primal_start,
                          dual_start), device)
    dtype = torch.get_default_dtype() if dtype is None else dtype
    st = as_settings(settings, dtype)

    def t(x):
        return torch.as_tensor(x, device=dev).to(dtype)

    is_lp = H is None
    bu = torch.atleast_1d(t(bupper))
    m = bu.shape[0]
    bl = torch.full_like(bu, -1e30) if blower is None \
        else torch.atleast_1d(t(blower))
    if A is None or np.size(A) == 0:
        n = np.shape(H)[0] if H is not None else m
        At = torch.zeros((0, n), dtype=dtype, device=dev)
    else:
        At = torch.atleast_2d(t(A))
        n = At.shape[1]
    Ht = None if is_lp else t(H)
    ms = m - At.shape[0] if ms is None else int(ms)
    sense_np = np.zeros(m, np.int32) if sense is None \
        else _host(sense, np.int32)
    if primal_start is not None or dual_start is not None:
        # on the host in f64, from the caller's arrays (daqp_tpu/api.py:
        # 125-134)
        from . import warmstart

        def h64(x):
            return torch.as_tensor(_host(x, np.float64))

        s64 = torch.as_tensor(sense_np)
        if primal_start is not None:
            A64 = h64(At.cpu()) if A is None or np.size(A) == 0 \
                else torch.atleast_2d(h64(A))
            bl64 = torch.full((m,), -1e30, dtype=torch.float64) \
                if blower is None else torch.atleast_1d(h64(blower))
            s64 = warmstart.primal_init_active(
                h64(primal_start), A64, torch.atleast_1d(h64(bupper)), bl64,
                s64, ms)
        if dual_start is not None:
            s64 = warmstart.dual_init_active(h64(dual_start), s64)
        sense_np = s64.numpy()
    Rinv = None
    if prefactored and not is_lp:
        eye = torch.eye(n, dtype=dtype, device=dev)
        Rinv = torch.linalg.solve_triangular(Ht, eye, upper=True)
        Ht = Ht.T @ Ht
    ft = torch.zeros(n, dtype=dtype, device=dev) if f is None else t(f)
    x0 = torch.zeros(n, dtype=dtype, device=dev) if primal_start is None \
        else t(primal_start)
    sw = _soft_weights(soft_weights, m, st, dtype, dev)
    t0 = time.perf_counter()
    # a positive time limit: the reference's wall-clock check
    # (daqp.c:95-103) against this deadline
    deadline = t0 + float(st.time_limit) if float(st.time_limit) > 0 \
        else None
    # working-set capacity n + ns + 1 (api.c:288-305)
    K = n + int(np.sum((sense_np & SOFT) > 0)) + 1
    sense_t = torch.as_tensor(sense_np, device=dev)
    bin_ids = tuple(int(i) for i in np.flatnonzero(sense_np & BINARY))
    nodes = 1
    if is_avi:
        from .avi_solver import avi_core
        out = avi_core(Ht, ft, At, bu, bl, sense_t, ms, st, K=K, x0=x0,
                       deadline=deadline)
    elif bin_ids:
        from .bnb import bnb_core
        out = bnb_core(Ht, ft, At, bu, bl, sense_t, ms, st, bin_ids=bin_ids,
                       deadline=deadline, K=K)
        nodes = out.nodes
    elif break_points is not None and len(break_points) > 1:
        from .hierarchical import hiqp_core
        out = hiqp_core(Ht, ft, At, bu, bl, sense_t, ms,
                        tuple(break_points), st, deadline=deadline)
    elif is_lp:
        from .prox import linprog_core
        out = linprog_core(ft, At, bu, bl, sense_t, ms, st, K=K, x0=x0,
                           deadline=deadline)
    else:
        from .prox import solve_convex_or_prox
        out = solve_convex_or_prox(Ht, ft, At, bu, bl, sense_t, ms, st, K=K,
                                   x0=x0, deadline=deadline, Rinv=Rinv,
                                   soft_weights=sw)
    res = Result(x=out.x, lam=out.lam, fval=out.fval,
                 exitflag=out.exitflag, iterations=out.iterations,
                 soft_slack=out.soft_slack, nodes=nodes,
                 solve_time=time.perf_counter() - t0, setup_time=0.0)
    if f64_backstop is None:
        f64_backstop = is_lp
    if f64_backstop and dtype == torch.float32 \
            and _dubious(res, is_lp, f, At, bupper, blower, sense_np, ms):
        return solve(H=H, f=f, A=A, bupper=bupper, blower=blower,
                     sense=sense_np, ms=ms, break_points=break_points,
                     settings=settings, dtype=torch.float64, is_avi=is_avi,
                     prefactored=prefactored, soft_weights=soft_weights,
                     f64_backstop=False, device=dev)
    return res


# the f64 KKT gate of a positive f32 LP exit (daqp_tpu/api.py:208-212):
# tighter than the batch backstop's 1e-4, since a nearly degenerate f32
# vertex 5.6e-3 off in x passed 3e-5 while honest exits sit near 1e-6
LP_KKT_TOL = 1e-5


def _dubious(res: Result, is_lp: bool, f, At, bupper, blower, sense_np,
             ms: int) -> bool:
    """Whether an f32 result goes to the f64 re-solve: a negative flag
    other than the time limit, or (an LP) a positive flag whose f64 KKT
    residual (``batch.kkt_residuals`` with H = 0) exceeds LP_KKT_TOL."""
    if res.exitflag < 0:
        return res.exitflag != EXIT_TIMELIMIT
    if not is_lp:
        return False
    from .batch import kkt_residuals
    n = At.shape[1]
    m = len(sense_np)
    f64 = np.zeros(n) if f is None else _host(f, np.float64)
    bl = np.full(m, -1e30) if blower is None \
        else np.atleast_1d(_host(blower, np.float64))
    stat, viol = kkt_residuals(
        np.zeros((1, n, n)), f64[None], _host(At, np.float64)[None],
        np.atleast_1d(_host(bupper, np.float64))[None], bl[None],
        sense_np[None], _host(res.x, np.float64)[None],
        _host(res.lam, np.float64)[None], ms=ms)
    return bool(max(stat[0], viol[0]) > LP_KKT_TOL)


def quadprog(H, f, A, bupper, blower=None, sense=None, ms=None, **kw):
    """The convex QP one-shot (reference ``daqp_quadprog``,
    api.c:56-71)."""
    return solve(H=H, f=f, A=A, bupper=bupper, blower=blower, sense=sense,
                 ms=ms, **kw)


def linprog(f, A, bupper, blower=None, sense=None, ms=None, **kw):
    """The LP one-shot by adaptive proximal smoothing (the reference's
    ``quadprog`` with H = NULL, api.c:175-177)."""
    return solve(H=None, f=f, A=A, bupper=bupper, blower=blower, sense=sense,
                 ms=ms, **kw)


def avi(H, f, A, bupper, blower=None, sense=None, ms=None, **kw):
    """The affine variational inequality one-shot (reference
    ``daqp_avi``, api.c:73-77)."""
    return solve(H=H, f=f, A=A, bupper=bupper, blower=blower, sense=sense,
                 ms=ms, is_avi=True, **kw)
