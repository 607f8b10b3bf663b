"""The native C library (``native/daqp_c.c``) through the port's binding
(``daqp_tpu_torch.native``), held against the port's own solvers in f64
on the CPU: ``tests/test_native_c.py``'s cases with ``dt.quadprog``,
``dt.linprog``, ``dt.avi``, the hierarchy, branch and bound,
``dt.minrep`` and ``Model`` in place of the JAX package's (the cases
gated by known solutions keep them), and the port's binding against the
JAX package's on the same inputs."""
import shutil

import numpy as np
import pytest
import torch

import daqp_tpu_torch as dt
from daqp_tpu import native as jnative
from daqp_tpu_torch.native import NativeModel, native_minrep
from tests.gen import (generate_test_avi, generate_test_lp,
                       generate_test_qp)

pytestmark = pytest.mark.skipif(shutil.which("cc") is None
                                and shutil.which("gcc") is None,
                                reason="no C compiler")
F64 = dict(dtype=torch.float64, device="cpu")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("trial", range(6))
def test_native_qp_differential(trial):
    rng = np.random.default_rng(11)
    for _ in range(trial + 1):
        x, H, f, A, bu, bl, sense = generate_test_qp(8, 20, 3, 6, 1e2, rng)
    out = NativeModel(H, f, A, bu, bl, sense, ms=3).solve()
    ref = dt.quadprog(H, f, A, bu, bl, sense, ms=3, **F64)
    assert out['exitflag'] == ref.exitflag
    assert np.linalg.norm(out['x'] - _np(ref.x)) < 1e-8
    assert abs(out['fval'] - float(ref.fval)) < 1e-8
    # dual stationarity through the C duals
    grad = H @ out['x'] + f
    grad[:3] += out['lam'][:3]
    grad += A.T @ out['lam'][3:]
    assert np.linalg.norm(grad) < 1e-7


def test_native_equalities_and_soft():
    rng = np.random.default_rng(13)
    x, H, f, A, bu, bl, sense = generate_test_qp(6, 14, 0, 4, 1e2, rng)
    bu, bl, sense = bu.copy(), bl.copy(), sense.copy()
    bu[0] = bl[0] = 0.5 * (bu[0] + bl[0])
    sense[5] |= dt.SOFT
    sense[6] |= dt.SOFT
    out = NativeModel(H, f, A, bu, bl, sense, ms=0).solve()
    ref = dt.quadprog(H, f, A, bu, bl, sense, ms=0, **F64)
    assert out['exitflag'] == ref.exitflag
    assert np.linalg.norm(out['x'] - _np(ref.x)) < 1e-7


def test_native_mpc_update_warm():
    rng = np.random.default_rng(17)
    x, H, f, A, bu, bl, sense = generate_test_qp(8, 20, 0, 5, 1e2, rng)
    mdl = NativeModel(H, f, A, bu, bl, ms=0)
    assert mdl.solve()['exitflag'] == 1
    f2 = f * 1.0001
    mdl.update(f=f2, bupper=bu, blower=bl)
    out2 = mdl.solve()
    assert out2['exitflag'] == 1
    assert out2['iterations'] <= 3, out2['iterations']
    ref = dt.quadprog(H, f2, A, bu, bl, ms=0, **F64)
    assert np.linalg.norm(out2['x'] - _np(ref.x)) < 1e-7



def test_update_f_alone_rebuilds_d():
    # scripts/fuzz_torch.py's native case at seed 100010 (n = 14, m = 47,
    # 9 equalities, SOFT rows), its warm step with the new f passed alone:
    # the binding passes the kept bounds, so the C call rebuilds d on the
    # new v and the warm solve is the cold one's
    rng = np.random.default_rng(100010)
    n = int(rng.integers(2, 16))
    m = int(rng.integers(n + 1, 3 * n + 6))
    ms = int(rng.integers(0, n + 1))
    kappa = float(10 ** rng.integers(1, 4))
    _, H, f, A, bu, bl, sense = generate_test_qp(
        n, m, ms, int(rng.integers(1, n + 1)), kappa, rng)
    sense = sense.copy()
    sense[rng.random(m) < 0.1] |= dt.SOFT
    mdl = NativeModel(H, f, A, bu, bl, sense, ms=ms)
    assert mdl.solve()['exitflag'] == 1
    f = f * (1.0 + 1e-3 * rng.standard_normal(n))
    mdl.update(f=f)
    warm = mdl.solve()
    cold = NativeModel(H, f, A, bu, bl, sense, ms=ms).solve()
    assert (n, m, ms) == (14, 47, 9)
    assert warm['exitflag'] == cold['exitflag'] == 1
    assert np.linalg.norm(warm['x'] - cold['x']) < 1e-6
    assert abs(warm['fval'] - cold['fval']) < 1e-6 * (1 + abs(cold['fval']))

def _miqp(rng, n=6, m=14, nb=4):
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


@pytest.mark.parametrize("trial", range(3))
def test_native_miqp(trial):
    rng = np.random.default_rng(19)
    for _ in range(trial + 1):
        H, f, A, bu, bl, sense = _miqp(rng)
    mdl = NativeModel(H, f, A, bu, bl, sense, ms=0)
    out = mdl.solve_miqp()
    ref = dt.quadprog(H, f, A, bu, bl, sense, ms=0, **F64)
    assert out['exitflag'] == ref.exitflag
    if out['exitflag'] == 1:
        assert abs(out['fval'] - float(ref.fval)) < 1e-6
        assert np.linalg.norm(out['x'] - _np(ref.x)) < 1e-5
    # a plain solve after the MIQP gives the clean relaxation
    out3 = mdl.solve()
    relax = dt.quadprog(H, f, A, bu, bl, ms=0, **F64)
    assert out3['exitflag'] == 1
    assert abs(out3['fval'] - float(relax.fval)) < 1e-7


def test_native_probes():
    H = np.eye(2)
    A = np.array([[1.0, 0.0], [1.0, 0.0]])
    bu = np.array([-1.0, 30.0])
    bl = np.array([-30.0, 1.0])
    assert NativeModel(H, np.zeros(2), A, bu, bl, ms=0).solve()[
        'exitflag'] == -1 == dt.quadprog(H, np.zeros(2), A, bu, bl, ms=0,
                                         **F64).exitflag
    one, neg = np.array([1.0, 1.0]), np.array([-1.0, -1.0])
    assert NativeModel(-np.eye(2), np.zeros(2), A, one, neg, ms=0).solve()[
        'exitflag'] == -5 == dt.quadprog(-np.eye(2), np.zeros(2), A, one,
                                         neg, ms=0, **F64).exitflag
    # the fval_bound cut below the port's optimum
    x, H3, f3, A3, bu3, bl3, _ = generate_test_qp(
        4, 10, 0, 3, 1e2, np.random.default_rng(3))
    ref = dt.quadprog(H3, f3, A3, bu3, bl3, ms=0, **F64)
    cut = {"fval_bound": float(ref.fval) - 1.0}
    assert NativeModel(H3, f3, A3, bu3, bl3, ms=0,
                       settings=cut).solve()['exitflag'] == -1
    assert dt.quadprog(H3, f3, A3, bu3, bl3, ms=0, settings=cut,
                       **F64).exitflag == -1
    with pytest.raises(ValueError):
        NativeModel(H3, f3, A3, bu3, bl3, ms=0, settings={"bogus": 1.0})


@pytest.mark.parametrize("trial", range(6))
def test_native_lp_differential(trial):
    rng = np.random.default_rng(91)
    n, ms = 10, 5
    for _ in range(trial + 1):
        x_ref, f, A, bu, bl, _ = generate_test_lp(n, 50, ms, rng)
    ref = dt.linprog(f, A, bu, bl, ms=ms, **F64)
    assert ref.exitflag == 1
    out = NativeModel(None, f, A, bu, bl, ms=ms).solve()
    assert out['exitflag'] == 1
    assert np.abs(out['x'] - x_ref).max() < 1e-6
    assert np.abs(out['x'] - _np(ref.x)).max() < 1e-6
    fv = float(f @ x_ref)
    assert abs(out['fval'] - fv) < 1e-6 * (1 + abs(fv))
    assert abs(out['fval'] - float(ref.fval)) < 1e-6 * (1 + abs(fv))
    G = np.vstack([np.eye(n)[:ms], A])
    assert np.abs(f + G.T @ out['lam']).max() < 1e-6


def test_native_lp_unbounded():
    f = np.array([-1.0, 0.0])
    A = np.array([[0.0, 1.0]])
    bu, bl = np.array([1.0]), np.array([-1.0])
    assert NativeModel(None, f, A, bu, bl, ms=0).solve()['exitflag'] == -3
    assert dt.linprog(f, A, bu, bl, ms=0, **F64).exitflag == -3


def test_native_time_limit():
    rng = np.random.default_rng(7)
    x, H, f, A, bu, bl, sense = generate_test_qp(30, 120, 0, 25, 1e2, rng)
    out = NativeModel(H, f, A, bu, bl, ms=0,
                      settings={"time_limit": 1e-9}).solve()
    assert out['exitflag'] == -7
    out2 = NativeModel(H, f, A, bu, bl, ms=0,
                       settings={"time_limit": 30.0}).solve()
    assert out2['exitflag'] == 1
    assert np.abs(out2['x'] - x).max() < 1e-6


def test_native_miqp_time_limit():
    # the tree's deadline (bnb.c:51-59) fires every 32 nodes: ties at the
    # midpoint defeat the dominance cut, so the tree is deep
    nb = 8
    mdl = NativeModel(np.eye(nb), np.full(nb, -0.5), np.eye(nb),
                      np.ones(nb), np.zeros(nb),
                      np.full(nb, dt.BINARY, np.int32), ms=0,
                      settings={"time_limit": 1e-9})
    assert mdl.solve_miqp()['exitflag'] == -7


@pytest.mark.parametrize("trial", range(6))
def test_native_avi_differential(trial):
    rng = np.random.default_rng(37)
    for t in range(trial + 1):
        n, m = (8, 30) if t < 4 else (20, 80)
        x_ref, H, f, A, b = generate_test_avi(n, m, rng)
    out = NativeModel(H, f, A, b, np.full(m, -1e30), ms=0, avi=True).solve()
    assert out['exitflag'] == 1
    assert np.linalg.norm(out['x'] - x_ref) < 1e-5
    assert np.abs(H @ out['x'] + f + A.T @ out['lam']).max() < 1e-6
    assert out['lam'].min() > -1e-8
    assert np.abs(out['lam'] * (b - A @ out['x'])).max() < 1e-5


def test_native_avi_vs_port():
    rng = np.random.default_rng(41)
    x_ref, H, f, A, b = generate_test_avi(10, 40, rng)
    res = dt.avi(H, f, A, b, ms=0, **F64)
    assert res.exitflag == 1
    out = NativeModel(H, f, A, b, np.full(40, -1e30), ms=0, avi=True).solve()
    assert out['exitflag'] == 1
    assert np.linalg.norm(out['x'] - _np(res.x)) < 1e-4


def test_native_avi_unconstrained_and_warm():
    rng = np.random.default_rng(31)
    Mm = rng.random((6, 6))
    H = Mm.T @ Mm + np.eye(6) + 0.1 * (rng.random((6, 6))
                                       - rng.random((6, 6)))
    f = rng.standard_normal(6)
    x_unc = np.linalg.solve(H, -f)
    A = rng.standard_normal((4, 6))
    b = A @ x_unc + 1.0
    out = NativeModel(H, f, A, b, np.full(4, -1e30), ms=0, avi=True).solve()
    assert out['exitflag'] == 1 and out['iterations'] == 1
    assert np.linalg.norm(out['x'] - x_unc) < 1e-8
    x_ref, H2, f2, A2, b2 = generate_test_avi(8, 30, rng)
    mdl2 = NativeModel(H2, f2, A2, b2, np.full(30, -1e30), ms=0, avi=True)
    out1, out2 = mdl2.solve(), mdl2.solve()
    assert out1['exitflag'] == 1 and out2['exitflag'] == 1
    assert out2['iterations'] <= out1['iterations']
    assert np.linalg.norm(out2['x'] - x_ref) < 1e-5


@pytest.mark.parametrize("case", ["basic", "conflicting_equalities"])
def test_native_hiqp_known(case):
    # core_tests.jl:294-302, and two inconsistent equalities resolved in
    # the least-squares sense (x1 = 6) with slack duals ~(+2, -2)
    if case == "basic":
        A = np.array([[1.0, 1, 1], [1, -1, 0], [3, 1, -1]])
        bu = np.concatenate([np.ones(3), [1, 0.5, 20]])
        bl = np.concatenate([-np.ones(3), [-1e30, 0.5, 10]])
        ms, bp, xref = 3, [3, 4, 5, 6], np.array([1.0, 0.5, -1.0])
    else:
        A = np.array([[1.0, 0], [1, 0], [0, 1]])
        bu = bl = np.array([4.0, 8.0, 1.0])
        ms, bp, xref = 0, [0, 2, 3], np.array([6.0, 1.0])
    n = A.shape[1]
    out = NativeModel(np.eye(n), np.zeros(n), A, bu, bl,
                      ms=ms).solve_hiqp(bp)
    assert out['exitflag'] > 0
    assert np.linalg.norm(out['x'] - xref) < 1e-4
    if case != "basic":
        assert abs(out['lam'][0] - 2.0) < 1e-3
        assert abs(out['lam'][1] + 2.0) < 1e-3
    ref = dt.solve(None, np.zeros(n), A, bu, bl, ms=ms, break_points=bp,
                   **F64)
    assert ref.exitflag > 0
    assert np.linalg.norm(_np(ref.x) - out['x']) < 1e-4


@pytest.mark.parametrize("trial", range(4))
def test_native_hiqp_differential(trial):
    # random three-level hierarchies of equalities against the port's
    # hierarchy in the identity metric
    rng = np.random.default_rng(29)
    for _ in range(trial + 1):
        A = rng.standard_normal((12, 6))
        b = rng.standard_normal(12)
    bp = (0, 4, 8, 12)
    out = NativeModel(np.eye(6), np.zeros(6), A, b, b, ms=0).solve_hiqp(bp)
    ref = dt.solve(None, np.zeros(6), A, b, b, ms=0, break_points=bp, **F64)
    assert out['exitflag'] > 0 and ref.exitflag > 0
    scale = 1.0 + np.linalg.norm(_np(ref.x))
    assert np.linalg.norm(out['x'] - _np(ref.x)) < 1e-4 * scale


@pytest.mark.parametrize("case", ["duplicates", "simple_bounds"])
def test_native_minrep(case):
    if case == "duplicates":
        rng = np.random.default_rng(23)
        m, ms = 14, 0
        A = rng.standard_normal((m, 4))
        b = 1.0 + rng.random(m)
        A[m - 1] = A[0]                    # dominated by row 0
        b[m - 1] = b[0] + 1.0
    else:
        rng = np.random.default_rng(29)
        ms = 3
        A = rng.standard_normal((8, 3))
        b = np.concatenate([10.0 + rng.random(ms),    # loose box
                            0.5 + 0.2 * rng.random(8)])
    red_c = native_minrep(A, b, ms=ms)
    red_p = _np(dt.minrep(A, b, ms=ms, **F64))
    assert np.array_equal(red_c, red_p.astype(red_c.dtype)), (red_c, red_p)
    if case == "duplicates":
        assert red_c[-1] == 1


def test_native_soft_slack():
    rng = np.random.default_rng(31)
    x, H, f, A, bu, bl, sense = generate_test_qp(5, 8, 0, 3, 1e2, rng)
    bu, bl, sense = bu.copy(), bl.copy(), sense.copy()
    sense[0] |= dt.SOFT
    bu[0] = bl[0] = (A[0] @ np.linalg.solve(H, -f)) - 5.0
    st = {"rho_soft": 1e-3}
    mdl = NativeModel(H, f, A, bu, bl, sense, ms=0, settings=st)
    assert mdl.solve()['exitflag'] in (1, 2)
    ss = mdl.soft_slack()
    ref = dt.quadprog(H, f, A, bu, bl, sense, ms=0, settings=st, **F64)
    assert abs(ss - float(ref.soft_slack)) < 1e-6 * (1.0 + abs(ss))


def test_native_primal_dual_init_active():
    # the true active set at the optimum re-solves in one iteration
    # (core_tests.jl:449-496), from x or from lam
    rng = np.random.default_rng(37)
    x, H, f, A, bu, bl, sense = generate_test_qp(8, 20, 0, 5, 1e2, rng)
    out = NativeModel(H, f, A, bu, bl, ms=0).solve()
    assert out['exitflag'] == 1
    ref = dt.quadprog(H, f, A, bu, bl, ms=0, primal_start=out['x'], **F64)
    assert np.linalg.norm(_np(ref.x) - out['x']) < 1e-7
    for warm in ("primal_init_active", "dual_init_active"):
        m2 = NativeModel(H, f, A, bu, bl, ms=0)
        getattr(m2, warm)(out['x'] if warm[0] == "p" else out['lam'])
        out2 = m2.solve()
        assert out2['exitflag'] == 1
        assert out2['iterations'] <= 2, (warm, out2['iterations'])
        assert np.linalg.norm(out2['x'] - out['x']) < 1e-7


def test_native_set_primal_start_lp():
    rng = np.random.default_rng(41)
    x, f, A, bu, bl, _ = generate_test_lp(6, 18, 0, rng)
    out = NativeModel(None, f, A, bu, bl, ms=0).solve()
    assert out['exitflag'] == 1
    m2 = NativeModel(None, f, A, bu, bl, ms=0)
    m2.set_primal_start(out['x'])
    m2.dual_init_active(out['lam'])
    out2 = m2.solve()
    assert out2['exitflag'] == 1
    assert np.linalg.norm(out2['x'] - out['x']) < 1e-6
    assert out2['iterations'] <= out['iterations']
    ref = dt.linprog(f, A, bu, bl, ms=0, **F64)
    assert np.linalg.norm(_np(ref.x) - out['x']) < 1e-6


def test_native_update_masked_against_model():
    # each masked update of the C workspace, and the same update of the
    # port's Model, against a fresh setup: the same flag, the same x
    # when optimal
    rng = np.random.default_rng(43)
    n, m, ms = 7, 16, 2
    x, H, f, A, bu, bl, sense = generate_test_qp(n, m, ms, 5, 1e2, rng)
    x2, H2, f2, A2, bu2, bl2, _ = generate_test_qp(n, m, ms, 5, 1e2, rng)
    mdl = NativeModel(H, f, A, bu, bl, sense, ms=ms)
    mdl.solve()
    port = dt.Model().setup(H, f, A, bu, bl, sense, ms=ms, **F64)
    port.solve()

    def check(upd, prob, want_optimal):
        assert mdl.update_masked(**upd) == 0
        port.update(**upd)
        got, mine = mdl.solve(), port.solve()
        fresh = NativeModel(*prob, ms=ms).solve()
        assert got['exitflag'] == fresh['exitflag'] == mine.exitflag
        if want_optimal:
            assert got['exitflag'] == 1
        if got['exitflag'] > 0:
            assert np.linalg.norm(got['x'] - fresh['x']) < 1e-7
            assert np.linalg.norm(got['x'] - _np(mine.x)) < 1e-7
        return got

    bu_w, bl_w = bu + 0.05, bl - 0.05
    check(dict(bupper=bu_w, blower=bl_w), (H, f, A, bu_w, bl_w, sense),
          True)
    f_s = 1.3 * f
    check(dict(f=f_s), (H, f_s, A, bu_w, bl_w, sense), True)
    check(dict(A=A2), (H, f_s, A2, bu_w, bl_w, sense), False)
    check(dict(H=H2, f=f2, A=A2, bupper=bu2, blower=bl2),
          (H2, f2, A2, bu2, bl2, sense), True)
    s2 = np.asarray(sense, np.int32).copy()
    s2[ms] |= dt.SOFT
    assert check(dict(sense=s2), (H2, f2, A2, bu2, bl2, s2),
                 False)['exitflag'] > 0


def test_native_update_masked_guards():
    rng = np.random.default_rng(47)
    x, H, f, A, bu, bl, sense = generate_test_qp(5, 10, 0, 3, 1e2, rng)
    with pytest.raises(ValueError):
        NativeModel(None, f, A, bu, bl, ms=0).update_masked(H=H)
    mdl = NativeModel(H, f, A, bu, bl, ms=0)
    bad_bu = bu.copy()
    bad_bu[0] = bl[0] - 1.0
    assert mdl.update_masked(bupper=bad_bu, blower=bl) < 0
    assert mdl.update_masked(bupper=bu, blower=bl) == 0
    assert mdl.solve()['exitflag'] == 1
    # the port's one-shot flags the same inverted bound infeasible
    assert dt.quadprog(H, f, A, bad_bu, bl, ms=0, **F64).exitflag == -1


def _same_dicts(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


@pytest.mark.parametrize("mode", ["qp", "lp", "avi", "miqp", "hiqp",
                                  "minrep"])
def test_binding_matches_jax_binding(mode):
    # the port's copy of the binding against daqp_tpu.native on the same
    # inputs (the port's from tensors): identical results
    rng = np.random.default_rng(53)
    if mode == "minrep":
        A = rng.standard_normal((10, 3))
        b = 1.0 + rng.random(10)
        assert np.array_equal(native_minrep(torch.as_tensor(A), b),
                              jnative.native_minrep(A, b))
        return
    if mode in ("qp", "hiqp"):
        x, H, f, A, bu, bl, se = generate_test_qp(6, 14, 2, 4, 1e2, rng)
        kw = dict(ms=2)
    elif mode == "lp":
        x, f, A, bu, bl, se = generate_test_lp(6, 18, 0, rng)
        H, kw = None, dict(ms=0)
    elif mode == "avi":
        x, H, f, A, bu = generate_test_avi(6, 20, rng)
        bl, se, kw = np.full(20, -1e30), None, dict(ms=0, avi=True)
    else:
        H, f, A, bu, bl, se = _miqp(rng)
        kw = dict(ms=0)
    port = NativeModel(None if H is None else torch.as_tensor(H), f,
                       torch.as_tensor(A), bu, bl, se, **kw)
    ref = jnative.NativeModel(H, f, A, bu, bl, se, **kw)
    if mode == "miqp":
        _same_dicts(port.solve_miqp(), ref.solve_miqp())
    elif mode == "hiqp":
        _same_dicts(port.solve_hiqp([2, 8, 14]), ref.solve_hiqp([2, 8, 14]))
    else:
        _same_dicts(port.solve(), ref.solve())
        port.update(f=1.01 * f, bupper=bu, blower=bl)
        ref.update(f=1.01 * f, bupper=bu, blower=bl)
        _same_dicts(port.solve(), ref.solve())
