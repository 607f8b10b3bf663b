"""Embedded C from the port (daqp_tpu_torch.codegen.render_c and
Model.codegen): tests/test_codegen.py's compile-and-solve cases, the C
compiled with cc and solved.  Every rendering is held against the JAX
package's render_c (its data arrays within 1e-12 relative, the rest of
its text equal) and every C solve against the port's quadprog in f64;
where tests/test_codegen.py holds a case against the JAX package's
solver, so does this file, and where it holds one against the
reference's known solutions (the hierarchies, the known MIQP), so does
this file."""
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import daqp_tpu
from daqp_tpu import codegen as jcodegen
import daqp_tpu_torch as dt
from daqp_tpu_torch import codegen
from tests.gen import generate_test_qp

requires_cc = pytest.mark.skipif(shutil.which("cc") is None,
                                 reason="cc not available")
F64 = dict(dtype=torch.float64, device="cpu")
_ARRAY = re.compile(r"static const (?:double|int) (\w+)\[\d+\] = \{([^}]*)\};")


def _arrays(src):
    return {m.group(1): np.array([float(v) for v in m.group(2).split(",")])
            for m in _ARRAY.finditer(src)}


def _render(tmp_path, name, *args, **kw):
    """The port's rendering of the problem, after holding it against the
    JAX package's: every data array within 1e-12 relative (entries at
    the 1e30 infinity by their own size, the rest by the array's largest
    finite entry), every other line equal.  Returns the port's .c path."""
    cp = codegen.render_c(*args, name=name, dir=str(tmp_path / "port"), **kw)
    cj = jcodegen.render_c(*args, name=name, dir=str(tmp_path / "jax"),
                           **kw)
    sp, sj = open(cp).read(), open(cj).read()
    ap, aj = _arrays(sp), _arrays(sj)
    assert ap.keys() == aj.keys() and len(ap) >= 8
    for key, j in aj.items():
        finite = np.abs(j) < 1e29
        scale = np.abs(j[finite]).max(initial=1.0)
        tol = 1e-12 * np.where(finite, scale, np.abs(j))
        assert np.all(np.abs(ap[key] - j) <= tol), key
    assert _ARRAY.sub("", sp) == _ARRAY.sub("", sj)
    assert open(cp[:-2] + ".h").read().replace("daqp_tpu_torch", "daqp_tpu") \
        == open(cj[:-2] + ".h").read()
    return cp


def _build_and_load(cpath):
    sopath = cpath[:-2] + ".so"
    subprocess.run(["cc", "-O2", "-fPIC", "-shared", "-o", sopath, cpath,
                    "-lm"], check=True)
    return ctypes.CDLL(sopath)


def _out(n, m=None):
    return ((ctypes.c_double * n)(), None if m is None
            else (ctypes.c_double * m)(), ctypes.c_double(), ctypes.c_int())


def _solve(lib, name, n, m=None, fn="solve"):
    xs, lam, fval, iters = _out(n, m)
    flag = getattr(lib, f"{name}_{fn}")(xs, lam, ctypes.byref(fval),
                                        ctypes.byref(iters))
    return flag, np.array(xs[:]), None if lam is None \
        else np.array(lam[:]), fval.value, iters.value


def _refs(*args, **kw):
    """(the port's quadprog in f64, the JAX package's) on one problem."""
    return dt.quadprog(*args, **kw, **F64), daqp_tpu.quadprog(*args, **kw)


def _agree(x, fval, refs, xtol=1e-6, ftol=1e-6):
    for r in refs:
        assert np.linalg.norm(x - np.asarray(r.x)) < xtol
        assert abs(fval - float(r.fval)) < ftol


@requires_cc
def test_codegen_compile_and_solve(tmp_path):
    rng = np.random.default_rng(101)
    x, H, f, A, bu, bl, sense = generate_test_qp(10, 30, 0, 6, 1e2, rng)
    lib = _build_and_load(_render(tmp_path, "emb", H, f, A, bu, bl))
    lib.emb_init()
    flag, xs, lam, fval, _ = _solve(lib, "emb", 10, 30)
    assert flag == 1, flag
    assert np.linalg.norm(xs - x) < 1e-6
    _agree(xs, fval, _refs(H, f, A, bu, bl, ms=0))
    # dual stationarity through the embedded duals
    assert np.linalg.norm(H @ xs + f + A.T @ lam) < 1e-6


@requires_cc
def test_codegen_mpc_update_resolve(tmp_path):
    # update f / bounds, then a warm re-solve in C (working set kept)
    rng = np.random.default_rng(103)
    x, H, f, A, bu, bl, sense = generate_test_qp(8, 20, 0, 5, 1e2, rng)
    lib = _build_and_load(_render(tmp_path, "mpc", H, f, A, bu, bl))
    lib.mpc_init()
    assert _solve(lib, "mpc", 8)[0] == 1
    f2 = f * 1.0001

    def arr(a):
        return (ctypes.c_double * len(a))(*a)

    lib.mpc_update(arr(f2), arr(bu), arr(bl))
    flag, xs, _, fval, iters = _solve(lib, "mpc", 8)
    assert flag == 1 and iters <= 3, (flag, iters)
    _agree(xs, fval, _refs(H, f2, A, bu, bl, ms=0))


@requires_cc
def test_codegen_infeasible(tmp_path):
    H, f = np.eye(2), np.zeros(2)
    A = np.array([[1.0, 0.0], [1.0, 0.0]])
    bu, bl = np.array([-1.0, 5.0]), np.array([-5.0, 1.0])
    lib = _build_and_load(_render(tmp_path, "inf", H, f, A, bu, bl))
    lib.inf_init()
    assert _solve(lib, "inf", 2)[0] == -1
    assert dt.quadprog(H, f, A, bu, bl, ms=0, **F64).exitflag \
        == dt.EXIT_INFEASIBLE


@requires_cc
def test_codegen_soft_constraints(tmp_path):
    # a binding soft row: SOFT_OPTIMAL (daqp.c:59-62) in C and in both
    # packages
    H, f = np.eye(2), np.array([-2.0, -2.0])
    A = np.array([[1.0, 1.0], [1.0, -1.0]])
    bu, bl = np.array([1.0, 5.0]), np.array([-5.0, -5.0])
    sense = np.array([dt.SOFT, 0], np.int32)
    refs = _refs(H, f, A, bu, bl, sense, ms=0)
    assert all(int(r.exitflag) == dt.EXIT_SOFT_OPTIMAL for r in refs)
    lib = _build_and_load(_render(tmp_path, "sft", H, f, A, bu, bl,
                                  sense=sense))
    lib.sft_init()
    flag, xs, _, fval, _ = _solve(lib, "sft", 2)
    assert flag == 2, flag
    _agree(xs, fval, refs)


def _miqp(lib, name, n):
    xs, _, fval, iters = _out(n)
    nodes = ctypes.c_int()
    flag = getattr(lib, f"{name}_solve_miqp")(
        xs, None, ctypes.byref(fval), ctypes.byref(iters),
        ctypes.byref(nodes))
    return flag, np.array(xs[:]), fval.value, nodes.value


def _random_miqp(seed):
    rng = np.random.default_rng(seed)
    n, m, nb = 6, 14, 4
    Mx = rng.standard_normal((n, n))
    H = Mx.T @ Mx + 0.1 * np.eye(n)
    f = 10 * rng.standard_normal(n)
    A = rng.standard_normal((m, n))
    bu = 15 * rng.random(m)
    bl = -15 * rng.random(m)
    A[:nb] = 0.0
    A[np.arange(nb), np.arange(nb)] = 1.0
    bu[:nb] = 1.0
    bl[:nb] = 0.0
    sense = np.zeros(m, np.int32)
    sense[:nb] = dt.BINARY
    return H, f, A, bu, bl, sense


@requires_cc
def test_codegen_miqp(tmp_path):
    # embedded branch and bound on the known-solution instance
    # (core_tests.jl:150-157), then random MIQPs
    H = np.array([[1, 0.5, 0], [0.5, 1, 0.5], [0, 0.5, 1]])
    f = np.array([1.0, 0, 0])
    A = np.array([[1.0, 2, 3], [1, 1, 0]])
    bu = np.array([1.0, 1, 1, 1e30, 1e30])
    bl = np.array([0.0, 0, 0, 4, 1])
    sense = np.array([dt.BINARY] * 3 + [0, 0], np.int32)
    lib = _build_and_load(_render(tmp_path / "k", "miqp", H, f, A, bu, bl,
                                  sense=sense, ms=3))
    lib.miqp_init()
    flag, xs, fval, nodes = _miqp(lib, "miqp", 3)
    assert flag == 1 and nodes >= 1, (flag, nodes)
    assert np.linalg.norm(xs - [0, 1, 1]) < 1e-5, xs
    _agree(xs, fval, [dt.quadprog(H, f, A, bu, bl, sense, ms=3, **F64)],
           xtol=1e-5)
    for seed in (0, 1):
        p = _random_miqp(200 + seed)
        refs = _refs(*p, ms=0)
        lib = _build_and_load(_render(tmp_path / str(seed), "rm", *p[:5],
                                      sense=p[5]))
        lib.rm_init()
        flag, xs, fval, _ = _miqp(lib, "rm", 6)
        assert all(flag == int(r.exitflag) for r in refs), flag
        if flag == 1:
            _agree(xs, fval, refs, xtol=1e-4, ftol=1e-5)


@requires_cc
def test_codegen_hierarchical(tmp_path):
    # the reference's known solutions (core_tests.jl:294-302, :348-356)
    A = np.array([[1.0, 1, 1], [1, -1, 0], [3, 1, -1]])
    bu = np.concatenate([np.ones(3), [1, 0.5, 20]])
    bl = np.concatenate([-np.ones(3), [-1e30, 0.5, 10]])
    bp = (3, 4, 5, 6)
    lib = _build_and_load(_render(tmp_path / "a", "hq", np.eye(3),
                                  np.zeros(3), A, bu, bl, ms=3,
                                  break_points=bp))
    lib.hq_init()
    flag, xs, _, _, _ = _solve(lib, "hq", 3, fn="solve_hier")
    assert flag > 0, flag
    assert np.linalg.norm(xs - [1.0, 0.5, -1.0]) < 1e-4, xs
    r = dt.quadprog(np.eye(3), np.zeros(3), A, bu, bl, ms=3,
                    break_points=bp, **F64)
    assert r.exitflag > 0 and np.linalg.norm(xs - r.x.numpy()) < 1e-4
    # conflicting equalities in the least-squares sense, the slack duals
    # frozen at w = lam* rho_soft (hierarchical.c:51-65)
    A = np.array([[1.0, 0], [1, 0], [0, 1]])
    b = np.array([4.0, 8.0, 1.0])
    lib = _build_and_load(_render(tmp_path / "b", "ce", np.eye(2),
                                  np.zeros(2), A, b, b, ms=0,
                                  break_points=(0, 2, 3)))
    lib.ce_init()
    flag, xs, lam, _, _ = _solve(lib, "ce", 2, 3, fn="solve_hier")
    assert flag > 0, flag
    assert np.linalg.norm(xs - [6.0, 1.0]) < 1e-4, xs
    assert abs(lam[0] - 2.0) < 1e-3 and abs(lam[1] + 2.0) < 1e-3, lam
    r = dt.quadprog(np.eye(2), np.zeros(2), A, b, b, ms=0,
                    break_points=(0, 2, 3), **F64)
    assert np.linalg.norm(xs - r.x.numpy()) < 1e-4


@requires_cc
def test_codegen_degenerate_repair(tmp_path):
    # duplicated rows: the embedded cycle guard / repair ladder (the
    # daqp.c:28-85 analogue) still exits optimally
    rng = np.random.default_rng(300)
    n, m = 8, 24
    x, H, f, A, bu, bl, sense = generate_test_qp(n, m // 2, 0, 5, 1e2, rng)
    A = np.vstack([A, A])
    bu = np.concatenate([bu, bu])
    bl = np.concatenate([bl, bl])
    lib = _build_and_load(_render(tmp_path, "dg", H, f, A, bu, bl))
    lib.dg_init()
    flag, xs, _, fval, _ = _solve(lib, "dg", n)
    assert flag == 1, flag
    _agree(xs, fval, _refs(H, f, A, bu, bl, ms=0), xtol=1e-5)


@requires_cc
def test_codegen_hier_wide_level(tmp_path):
    # a level wider than n + 1 softens more rows than a K sized by the
    # static soft rows holds: K = n + widest level + 1
    A = np.array([[1.0, 0], [1, 0], [1, 0], [1, 0], [0, 1]])
    b = np.array([1.0, 2.0, 3.0, 4.0, 1.0])
    bp = (0, 4, 5)
    cpath = _render(tmp_path, "wl", np.eye(2), np.zeros(2), A, b, b, ms=0,
                    break_points=bp)
    assert "#define wl_K     7" in open(cpath).read()
    lib = _build_and_load(cpath)
    lib.wl_init()
    flag, xs, _, _, _ = _solve(lib, "wl", 2, fn="solve_hier")
    assert flag > 0, flag
    refs = (dt.solve(H=None, f=None, A=A, bupper=b, blower=b, ms=0,
                     break_points=bp, **F64),
            daqp_tpu.solve(H=None, f=None, A=A, bupper=b, blower=b, ms=0,
                           break_points=bp))
    for r in refs:
        assert int(r.exitflag) > 0
        assert np.linalg.norm(xs - np.asarray(r.x)) < 1e-4
    # the least-squares mean of 1..4 up to the rho_soft bias (~1e-4)
    assert abs(xs[0] - 2.5) < 1e-3


@requires_cc
def test_codegen_miqp_then_solve(tmp_path):
    # after <name>_solve_miqp, <name>_solve without <name>_init solves the
    # relaxation, every binary row priced; through Model.codegen
    p = _random_miqp(207)
    relax = _refs(*p[:5], ms=0)
    d = dt.Model().setup(*p, ms=0, **F64)
    cpath = d.codegen(name="ms", dir=str(tmp_path / "model"))
    assert open(cpath).read() == open(_render(tmp_path, "ms", *p[:5],
                                              sense=p[5])).read()
    lib = _build_and_load(cpath)
    lib.ms_init()
    flag, xs, fval, _ = _miqp(lib, "ms", 6)
    assert flag == 1, flag
    _agree(xs, fval, (d.solve(), daqp_tpu.quadprog(*p, ms=0)), xtol=1e-4,
           ftol=1e-5)
    flag, xs, _, fval, _ = _solve(lib, "ms", 6)
    assert flag == 1, flag
    _agree(xs, fval, relax, xtol=1e-5)
