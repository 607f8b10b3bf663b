"""The single-instance public API: one-shot solves.

Counterpart of ``daqp_tpu/api.py:24-220`` (``solve``, ``quadprog``; its
``_as_settings`` is ``types.as_settings``), the reference's
``daqp.solve`` (interfaces/daqp-python/daqp.pyx:66-219) and its C
dispatch (``daqp_solve``, src/api.c:8-53).
A dense convex QP goes to ``prox.solve_convex_or_prox``: one LDP solve
for a positive definite H, the proximal outer loop for a semidefinite
one.  The other branches of the dispatch (LPs, AVIs, branch and bound,
hierarchies) are not ported yet and raise NotImplementedError.

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


def _unported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is ported in a later slice (ROADMAP {item})")


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

    ``f64_backstop``: an f32 solve that exits with a negative flag other
    than the time limit is solved once more in f64.  The default (None)
    turns it on for LPs only, as the JAX package does; an LP is not
    ported yet, so it is off on every path here unless asked for."""
    if H is None:
        _unported("an LP (H=None, linprog)", "A6b")
    if is_avi:
        _unported("the single-instance AVI (is_avi)", "A6b")
    if break_points is not None and len(break_points) > 1:
        _unported("a hierarchy (break_points with more than one level)",
                  "A6b")
    from .batch import resolve_device
    dev = resolve_device((H, f, A, bupper, blower, sense, primal_start,
                          dual_start), device)
    dtype = torch.get_default_dtype() if dtype is None else dtype
    st = as_settings(settings, dtype)

    def t(x):
        return torch.as_tensor(x, device=dev).to(dtype)

    Ht = t(H)
    bu = torch.atleast_1d(t(bupper))
    m = bu.shape[0]
    bl = torch.full_like(bu, -1e30) if blower is None \
        else torch.atleast_1d(t(blower))
    n = Ht.shape[0]
    At = torch.zeros((0, n), dtype=dtype, device=dev) \
        if A is None or np.size(A) == 0 else torch.atleast_2d(t(A))
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
    if np.any(sense_np & BINARY):
        _unported("branch and bound (BINARY sense bits)", "A10")

    Rinv = None
    if prefactored:
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
    from .prox import solve_convex_or_prox
    out = solve_convex_or_prox(Ht, ft, At, bu, bl,
                               torch.as_tensor(sense_np, device=dev), ms,
                               st, K=K, x0=x0, deadline=deadline, Rinv=Rinv,
                               soft_weights=sw)
    res = Result(x=out.x, lam=out.lam, fval=out.fval,
                 exitflag=out.exitflag, iterations=out.iterations,
                 soft_slack=out.soft_slack, nodes=1,
                 solve_time=time.perf_counter() - t0, setup_time=0.0)
    if f64_backstop and dtype == torch.float32 and res.exitflag < 0 \
            and res.exitflag != EXIT_TIMELIMIT:
        return solve(H=H, f=f, A=A, bupper=bupper, blower=blower,
                     sense=sense_np, ms=ms, break_points=break_points,
                     settings=settings, dtype=torch.float64,
                     prefactored=prefactored, soft_weights=soft_weights,
                     f64_backstop=False, device=dev)
    return res


def quadprog(H, f, A, bupper, blower=None, sense=None, ms=None, **kw):
    """The convex QP one-shot (reference ``daqp_quadprog``,
    api.c:56-71)."""
    return solve(H=H, f=f, A=A, bupper=bupper, blower=blower, sense=sense,
                 ms=ms, **kw)
