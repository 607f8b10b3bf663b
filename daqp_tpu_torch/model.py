"""A reusable ``Model``: set up once, solve again after masked updates.

Counterpart of ``daqp_tpu/model.py:86-294`` (the reference's Python
``daqp.Model``, interfaces/daqp-python/daqp.pyx:220-631, and the C update
masks of ``daqp_update_ldp``, src/utils.c:14-135):

* ``update`` of f / bupper / blower recomputes v and d only, and keeps
  Rinv, M, the working set and E: the warm re-solve of an MPC loop
  (docs/docs/c.md:60-73);
* ``update`` of sense swaps the sense bits without a refactorization and
  starts the next solve cold; of A, rebuilds M on the cached Rinv; of H,
  sets everything up again.

The ``LDPState`` is carried across ``solve`` calls, so a re-solve at the
optimum takes one iteration (core_tests.jl:449-496).  A semidefinite H
and the special problems (an AVI, BINARY bits, a hierarchy, an LP) are
solved by ``api.solve`` afresh at each ``solve``, as the JAX package's
Model does: its result is the one-shot result.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from . import core
from . import ldp as ldp_mod
from . import transform
from .api import _host, solve as api_solve
from .codegen import render_c
from .ops import host_read
from .types import BINARY, EXIT_RUNNING, SOFT, Result, as_settings


def _cold_solve(ldpd: transform.LDPData, st, K: int) -> core.SolveOut:
    """The plain QP's cold solve from a built LDP (the state kept for the
    warm re-solves): activation, the unconstrained shortcut, the loop."""
    _, state = core._solve_from_ldp(ldpd, st, K)
    return core.extract(ldpd, state, min_iterations=1)


def _warm_resolve(ldpd: transform.LDPData, state: ldp_mod.LDPState,
                  st) -> core.SolveOut:
    """The warm re-solve after a v / d update: the working set, E and the
    sense persist, the bounds change (utils.c:410-455)."""
    state = state._replace(dupper=ldpd.dupper, dlower=ldpd.dlower,
                           status=EXIT_RUNNING, iterations=0,
                           tried_repair=0, cycle_counter=0,
                           best_fval=torch.full_like(state.fval, -1.0))
    state = ldp_mod.ldp_solve(state, st, reset=False)
    return core.extract(ldpd, state, min_iterations=1)


class Model:
    """A solver object with a warm-start state that persists."""

    def __init__(self, settings=None):
        self._settings = settings
        self._ldpd = None
        self._state = None
        self._special = False

    # -- setup ------------------------------------------------------------
    def setup(self, H, f, A, bupper, blower=None, sense=None, ms=None,
              break_points=None, is_avi=False, primal_start=None,
              dual_start=None, dtype=None, device=None):
        """Build the LDP of the problem (factor H, M, v, d) on ``device``
        (default the card, as ``api.solve``) in ``dtype`` (default
        ``torch.get_default_dtype()``)."""
        from .batch import resolve_device
        self._device = resolve_device((H, f, A, bupper, blower, sense),
                                      device)
        H = None if H is None or np.size(H) == 0 else _host(H, np.float64)
        f = None if f is None or np.size(f) == 0 else _host(f, np.float64)
        bupper = np.atleast_1d(_host(bupper, np.float64))
        blower = np.full_like(bupper, -1e30) if blower is None \
            else np.atleast_1d(_host(blower, np.float64))
        A = np.zeros((0, H.shape[0] if H is not None else len(bupper))) \
            if A is None or np.size(A) == 0 \
            else np.atleast_2d(_host(A, np.float64))
        m = len(bupper)
        ms = m - A.shape[0] if ms is None else ms
        sense = np.zeros(m, np.int32) if sense is None \
            else np.array(_host(sense), np.int32)
        if primal_start is not None or dual_start is not None:
            from . import warmstart
            s = torch.as_tensor(sense)
            if primal_start is not None:
                s = warmstart.primal_init_active(
                    torch.as_tensor(_host(primal_start, np.float64)),
                    torch.as_tensor(A), torch.as_tensor(bupper),
                    torch.as_tensor(blower), s, int(ms))
            if dual_start is not None:
                s = warmstart.dual_init_active(
                    torch.as_tensor(_host(dual_start, np.float64)), s)
            sense = s.numpy()
        self._dtype = torch.get_default_dtype() if dtype is None else dtype
        self._st = as_settings(self._settings, self._dtype)
        self._ms = int(ms)
        self._H, self._f, self._A = H, f, A
        self._bupper, self._blower, self._sense = bupper, blower, sense
        self._break_points = None if break_points is None \
            else tuple(int(b) for b in break_points)
        self._is_avi = bool(is_avi)
        self._x0 = None if primal_start is None \
            else _host(primal_start, np.float64)
        self._special = (self._is_avi or bool(np.any(sense & BINARY))
                         or (self._break_points is not None
                             and len(self._break_points) > 1)
                         or H is None)
        self._ldpd = None
        if not self._special:
            self._ldpd = core.build_ldp(
                self._t(H), None if f is None else self._t(f), self._t(A),
                self._t(bupper), self._t(blower), self._t(sense, torch.int32),
                self._ms, self._st)
            # a semidefinite H takes the proximal path of api.solve
            self._special = host_read(self._ldpd.n_prox) > 0
        self._state = None
        return self

    def _t(self, x, dtype=None):
        return torch.as_tensor(x, device=self._device).to(
            self._dtype if dtype is None else dtype)

    def proximal_regularization(self) -> float:
        """The applied proximal shift of the set-up problem
        (``daqp_get_proximal_regularization``, utils.c:299-343): 0 for a
        positive definite H."""
        if not hasattr(self, '_st'):
            raise RuntimeError("proximal_regularization() before setup()")
        if self._ldpd is None:
            return 0.0
        return host_read(transform.get_proximal_regularization(
            core.batched(self._ldpd))[0])

    # -- solve ------------------------------------------------------------
    def solve(self) -> Result:
        if not hasattr(self, '_st'):
            raise RuntimeError("Model.solve() before Model.setup()")
        t0 = time.perf_counter()
        if self._special:
            return api_solve(H=self._H, f=self._f, A=self._A,
                             bupper=self._bupper, blower=self._blower,
                             sense=self._sense, ms=self._ms,
                             break_points=self._break_points,
                             settings=self._st, dtype=self._dtype,
                             is_avi=self._is_avi, primal_start=self._x0,
                             device=self._device)
        if self._state is None:
            n = self._A.shape[1] if self._A.size else len(self._bupper)
            K = int(n + np.sum((self._sense & SOFT) > 0) + 1)
            out = _cold_solve(self._ldpd, self._st, K)
        else:
            out = _warm_resolve(self._ldpd, self._state, self._st)
        self._state = out.state
        return Result(x=out.x, lam=out.lam, fval=out.fval,
                      exitflag=out.exitflag, iterations=out.iterations,
                      soft_slack=out.soft_slack, nodes=1,
                      solve_time=time.perf_counter() - t0, setup_time=0.0)

    # -- update -----------------------------------------------------------
    def update(self, H=None, f=None, A=None, bupper=None, blower=None,
               sense=None, break_points=None):
        """The masked update (``daqp_update_ldp``, utils.c:14-135): pass
        only what changed.

        * f / bupper / blower: v and d only; the factor, M and the warm
          working set persist (UPDATE_v | UPDATE_d);
        * sense: the bits swapped (auto-equality and zero-row bits
          re-derived), no refactorization, the next solve cold
          (UPDATE_sense, utils.c:31-39);
        * A: M and d rebuilt on the cached Rinv (UPDATE_M, utils.c:72-76);
        * break_points: the levels swapped (UPDATE_hierarchy);
        * H: a new setup."""
        h_changed = H is not None and np.size(H) > 0
        a_changed = A is not None and np.size(A) > 0
        if f is not None:
            self._f = _host(f, np.float64)
        if bupper is not None:
            self._bupper = np.atleast_1d(_host(bupper, np.float64))
        if blower is not None:
            self._blower = np.atleast_1d(_host(blower, np.float64))
        if h_changed:
            self._H = _host(H, np.float64)
        if a_changed:
            self._A = np.atleast_2d(_host(A, np.float64))
        was_binary = bool(np.any(self._sense & BINARY))
        if sense is not None:
            self._sense = np.array(_host(sense), np.int32)
        is_binary = bool(np.any(self._sense & BINARY))
        bp_mode_change = False
        if break_points is not None:
            new_bp = tuple(int(b) for b in break_points)
            bp_mode_change = (len(new_bp) > 1) != (
                self._break_points is not None
                and len(self._break_points) > 1)
            self._break_points = new_bp

        if h_changed or self._special or bp_mode_change \
                or (sense is not None and (is_binary or was_binary)):
            return self.setup(self._H, self._f, self._A, self._bupper,
                              self._blower, self._sense, ms=self._ms,
                              break_points=self._break_points,
                              is_avi=self._is_avi, dtype=self._dtype,
                              device=self._device)
        t = self._t
        if a_changed:
            # UPDATE_M: M and d rebuilt against the cached factor
            rinv = self._ldpd.Rinv
            self._ldpd = core.build_ldp(
                t(self._H), None if self._f is None else t(self._f),
                t(self._A), t(self._bupper), t(self._blower),
                t(self._sense, torch.int32), self._ms, self._st,
                Rinv=rinv)._replace(Rinv=rinv)
            self._state = None
            return self
        if sense is not None:
            # UPDATE_sense: the bits swapped, the working set reset (the
            # reference's reset + re-activation, utils.c:119-133)
            new = transform.update_sense(
                core.batched(self._ldpd), t(self._sense, torch.int32)[None],
                t(self._bupper)[None], t(self._blower)[None], self._st)
            self._ldpd = self._ldpd._replace(sense=new.sense[0],
                                             error=new.error[0])
            self._state = None
            if f is None and bupper is None and blower is None:
                return self
        # v / d only (UPDATE_v | UPDATE_d)
        n = self._ldpd.v.shape[0]
        fz = torch.zeros(n, dtype=self._dtype, device=self._device) \
            if self._f is None else t(self._f)
        new = transform.update_vd(core.batched(self._ldpd), fz[None],
                                  t(self._bupper)[None],
                                  t(self._blower)[None])
        self._ldpd = self._ldpd._replace(v=new.v[0], dupper=new.dupper[0],
                                         dlower=new.dlower[0])
        return self

    # -- codegen ----------------------------------------------------------
    def codegen(self, name="daqp_embedded", dir="."):
        """Render the model's problem into standalone embedded C
        (reference ``DAQPBase.codegen``, api.jl:393-404 ->
        codegen/codegen.c) through ``codegen.render_c``.  Returns the
        generated .c path."""
        return render_c(self._H, self._f, self._A, self._bupper,
                        self._blower, name=name, dir=dir, sense=self._sense,
                        ms=self._ms, settings=self._settings)

    # -- settings ---------------------------------------------------------
    def settings(self, updates: Optional[dict] = None) -> dict:
        st = as_settings(self._settings,
                         getattr(self, '_dtype', torch.float64))
        if updates:
            st = st._replace(**updates)
            self._settings = st
            if hasattr(self, '_st'):
                self._st = st
        return st._asdict()
