"""ctypes binding of the native C library (``native/daqp_c.c``).

Counterpart of ``daqp_tpu/native.py``: the C-consumer surface with
runtime problem data (``native/daqp_c.h``), a host library with no CUDA
in it.  ``_build_lib`` compiles the source with ``$CC`` (default ``cc``)
at first use into ``<checkout>/build/daqp_tpu_torch/native/``, keyed by a
hash of ``daqp_c.c`` and ``daqp_c.h``; ``NativeModel`` wraps one
workspace's life cycle (setup, solve, update, free) and ``native_minrep``
the minimal representation.  Problem data may be numpy arrays or CPU or
CUDA tensors: they are copied to the host in f64, since the library runs
on the host.  Results are the JAX binding's dicts of numpy arrays
(``tests/test_torch_native.py`` holds them against the port's solvers).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .ops._build import BUILD_DIR

_NATIVE = Path(__file__).resolve().parents[1] / "native"
_SRC = _NATIVE / "daqp_c.c"
_lib = None


def _build_lib() -> Path:
    """Compile native/daqp_c.c into a shared library, once per source."""
    h = hashlib.sha256()
    for p in (_SRC, _NATIVE / "daqp_c.h"):
        h.update(p.read_bytes())
    tag = h.hexdigest()[:16]
    out = BUILD_DIR / "native"
    so = out / f"libdaqp_c_{tag}.so"
    if not so.exists():
        out.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([os.environ.get("CC", "cc"), "-O2", "-fPIC",
                        "-shared", "-o", str(tmp), str(_SRC), "-lm"],
                       check=True, cwd=_NATIVE.parent)
        os.replace(tmp, so)
    return so


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_build_lib()))
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.daqp_tpu_setup.restype = ctypes.c_void_p
    lib.daqp_tpu_setup.argtypes = [ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, dp, dp, dp, dp, dp, ip]
    lib.daqp_tpu_setup_avi.restype = ctypes.c_void_p
    lib.daqp_tpu_setup_avi.argtypes = [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, dp, dp, dp, dp, dp,
                                       ip]
    lib.daqp_tpu_solve.restype = ctypes.c_int
    lib.daqp_tpu_solve.argtypes = [ctypes.c_void_p, dp, dp, dp, ip]
    lib.daqp_tpu_solve_miqp.restype = ctypes.c_int
    lib.daqp_tpu_solve_miqp.argtypes = [ctypes.c_void_p, dp, dp, dp, ip,
                                        ip]
    lib.daqp_tpu_solve_hiqp.restype = ctypes.c_int
    lib.daqp_tpu_solve_hiqp.argtypes = [ctypes.c_void_p, ip, ctypes.c_int,
                                        dp, dp, dp, ip]
    lib.daqp_tpu_update.restype = None
    lib.daqp_tpu_update.argtypes = [ctypes.c_void_p, dp, dp, dp]
    lib.daqp_tpu_update_masked.restype = ctypes.c_int
    lib.daqp_tpu_update_masked.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           dp, dp, dp, dp, dp, ip]
    lib.daqp_tpu_soft_slack.restype = ctypes.c_double
    lib.daqp_tpu_soft_slack.argtypes = [ctypes.c_void_p]
    lib.daqp_tpu_primal_init_active.restype = None
    lib.daqp_tpu_primal_init_active.argtypes = [ctypes.c_void_p, dp]
    lib.daqp_tpu_dual_init_active.restype = None
    lib.daqp_tpu_dual_init_active.argtypes = [ctypes.c_void_p, dp]
    lib.daqp_tpu_set_primal_start.restype = None
    lib.daqp_tpu_set_primal_start.argtypes = [ctypes.c_void_p, dp]
    lib.daqp_tpu_minrep.restype = ctypes.c_int
    lib.daqp_tpu_minrep.argtypes = [ip, dp, dp, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int]
    lib.daqp_tpu_set.restype = ctypes.c_int
    lib.daqp_tpu_set.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_double]
    lib.daqp_tpu_reset.restype = None
    lib.daqp_tpu_reset.argtypes = [ctypes.c_void_p]
    lib.daqp_tpu_free.restype = None
    lib.daqp_tpu_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _host(x, dtype=np.float64, matrix=False):
    """``x`` (numpy, list or a tensor on any device) as a C-contiguous
    host array of ``dtype``; None stays None."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.atleast_2d(x) if matrix else x
    return np.ascontiguousarray(x, dtype)


def _dp(a):
    return ctypes.POINTER(ctypes.c_double)() if a is None else \
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ip(a):
    return ctypes.POINTER(ctypes.c_int)() if a is None else \
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


class NativeModel:
    """C-side QP / LP / AVI / MIQP model: set up once, solve and update
    repeatedly (the reference's C API life cycle, api.h setup / solve /
    update / free); ``settings`` takes the names of ``Settings``."""

    # update masks (native/daqp_c.h, reference constants.h:48-54)
    UPDATE_Rinv, UPDATE_M, UPDATE_v, UPDATE_d, UPDATE_sense = \
        1, 2, 4, 8, 16

    def __init__(self, H, f, A, bupper, blower, sense=None, ms: int = 0,
                 settings: Optional[dict] = None, avi: bool = False):
        """``H=None`` selects LP mode (min f'x): the C library runs the
        adaptive-eps proximal LP regime (api.c:175-177,
        daqp_prox.c:21-271); an unbounded LP returns exitflag -3.
        ``avi=True`` selects the affine variational inequality mode
        (``daqp_tpu_setup_avi``; H may be asymmetric, and ``solve``
        runs the Douglas-Rachford outer loop, reference api.c:73-77)."""
        lib = _load()
        f, bu, bl = _host(f), _host(bupper), _host(blower)
        A = _host(A, matrix=True)
        Hh = _host(H)
        n = f.shape[0] if Hh is None else Hh.shape[0]
        m = bu.shape[0]
        se = np.zeros(m, np.int32) if sense is None \
            else _host(sense, np.int32)
        if avi and Hh is None:
            raise ValueError("AVI mode requires H")
        setup = lib.daqp_tpu_setup_avi if avi else lib.daqp_tpu_setup
        self._lib = lib
        self.n, self.m = n, m
        # the last bounds the model was given: an update of f alone
        # passes them, so that the C call rebuilds d = b s + M v
        self._bu, self._bl = bu.copy(), bl.copy()
        self._w = setup(n, m, ms, _dp(Hh), _dp(f), _dp(A), _dp(bu), _dp(bl),
                        _ip(se))
        if not self._w:
            raise MemoryError("daqp_tpu_setup failed")
        for k, v in (settings or {}).items():
            if lib.daqp_tpu_set(self._w, k.encode(), float(v)) != 0:
                raise ValueError(f"unknown setting {k!r}")

    def _out(self):
        return np.empty(self.n), np.empty(self.m), ctypes.c_double(), \
            ctypes.c_int()

    def solve(self):
        x, lam, fval, iters = self._out()
        flag = self._lib.daqp_tpu_solve(self._w, _dp(x), _dp(lam),
                                        ctypes.byref(fval),
                                        ctypes.byref(iters))
        return dict(x=x, lam=lam, fval=fval.value, exitflag=int(flag),
                    iterations=int(iters.value))

    def solve_miqp(self):
        x, lam, fval, iters = self._out()
        nodes = ctypes.c_int()
        flag = self._lib.daqp_tpu_solve_miqp(
            self._w, _dp(x), _dp(lam), ctypes.byref(fval),
            ctypes.byref(iters), ctypes.byref(nodes))
        return dict(x=x, lam=lam, fval=fval.value, exitflag=int(flag),
                    iterations=int(iters.value), nodes=int(nodes.value))

    def solve_hiqp(self, break_points):
        """Lexicographic hierarchical solve (hierarchical.c:5-108):
        ``break_points[i]`` is the one-past-the-end row of level i
        (ascending, the last = m).  Exit 3: the degrees of freedom ran
        out before the last level."""
        bp = _host(break_points, np.int32)
        x, lam, fval, iters = self._out()
        flag = self._lib.daqp_tpu_solve_hiqp(
            self._w, _ip(bp), int(bp.shape[0]), _dp(x), _dp(lam),
            ctypes.byref(fval), ctypes.byref(iters))
        return dict(x=x, lam=lam, fval=fval.value, exitflag=int(flag),
                    iterations=int(iters.value))

    def update(self, f=None, bupper=None, blower=None):
        """The v / d-only MPC re-update (UPDATE_v | UPDATE_d).  A bound
        left out keeps its last value: the C call rebuilds d only from
        the bounds it is given, so a new f (a new v) with no bounds would
        leave d = b s + M v on the old v."""
        # the host arrays stay alive in locals across the C call
        fh = _host(f)
        self._keep(bupper, blower)
        self._lib.daqp_tpu_update(self._w, _dp(fh), _dp(self._bu),
                                  _dp(self._bl))

    def _keep(self, bupper, blower):
        """Keep a copy of each bound given (the C library's own copy)."""
        if bupper is not None:
            self._bu = _host(bupper).copy()
        if blower is not None:
            self._bl = _host(blower).copy()

    def update_masked(self, H=None, f=None, A=None, bupper=None,
                      blower=None, sense=None, mask=None):
        """Masked in-place re-setup (the reference's daqp_update_ldp,
        utils.c:14-135): pass only the changed fields; the mask defaults
        to the union the given arguments imply.  An M, Rinv or sense
        change resets the working set (utils.c:381); a v / d change
        keeps it (the MPC contract)."""
        if mask is None:
            mask = ((self.UPDATE_Rinv if H is not None else 0)
                    | (self.UPDATE_M if A is not None else 0)
                    | (self.UPDATE_v if f is not None else 0)
                    | (self.UPDATE_d if bupper is not None
                       or blower is not None else 0)
                    | (self.UPDATE_sense if sense is not None else 0))
        Hh, fh, Ah = _host(H), _host(f), _host(A, matrix=True)
        buh, blh = _host(bupper), _host(blower)
        seh = _host(sense, np.int32)
        rc = self._lib.daqp_tpu_update_masked(
            self._w, int(mask), _dp(Hh), _dp(fh), _dp(Ah), _dp(buh),
            _dp(blh), _ip(seh))
        if rc == -100:                       # DAQP_TPU_BADMASK
            raise ValueError("invalid update mask for this workspace")
        if mask & self.UPDATE_d:            # the C side keeps them too
            self._keep(buh, blh)
        return int(rc)

    def soft_slack(self):
        """rho_soft * sum lam_soft^2 of the last solve (the reference's
        DAQPResult.soft_slack, api.c:441-471)."""
        return float(self._lib.daqp_tpu_soft_slack(self._w))

    def primal_init_active(self, x):
        """Activate the rows near-tight at x (api.c:555-592)."""
        xh = _host(x)
        self._lib.daqp_tpu_primal_init_active(self._w, _dp(xh))

    def dual_init_active(self, lam):
        """Activate rows by the sign of their multiplier (api.c:596-609)."""
        lh = _host(lam)
        self._lib.daqp_tpu_dual_init_active(self._w, _dp(lh))

    def set_primal_start(self, x):
        """Seed the proximal / LP outer iterate (api.c:612-617)."""
        xh = _host(x)
        self._lib.daqp_tpu_set_primal_start(self._w, _dp(xh))

    def reset(self):
        self._lib.daqp_tpu_reset(self._w)

    def __del__(self):
        w = getattr(self, "_w", None)
        if w:
            self._lib.daqp_tpu_free(w)
            self._w = None


def native_minrep(A, b, ms: int = 0):
    """Minimal representation of {x : x[:ms] <= b[:ms], A x <= b[ms:]}
    through the C library (the reference's daqp_minrep, api.c:507-534):
    an (m,) int array, 1 = redundant."""
    lib = _load()
    A = _host(A, matrix=True)
    b = _host(b)
    m, n = b.shape[0], A.shape[1]
    red = np.empty(m, np.int32)
    rc = lib.daqp_tpu_minrep(_ip(red), _dp(A), _dp(b), n, m, int(ms))
    if rc != 0:
        raise RuntimeError(f"daqp_tpu_minrep failed (flag {rc})")
    return red
