"""The port's single-instance path (daqp_tpu_torch.api / ldp / core /
prox / warmstart / geometry) against the JAX package on the CPU in f64.

Counterparts of test_quadprog.py, test_warmstart.py, test_prefactored.py,
test_soft.py, test_soft_weights.py, test_semidefinite.py,
and the single-instance cases of test_timelimit.py.  The same inputs (tests/gen.py, numpy seeds) go
through ``daqp_tpu`` (x64, tests/conftest.py) and ``daqp_tpu_torch`` on
the CPU in f64: the same exit flag, x and lam within 1e-8 (1 +
||x_jax||_inf), and the same iteration counts."""
import numpy as np
import pytest
import torch

import daqp_tpu
import daqp_tpu_torch as dt
from daqp_tpu_torch import convert
from tests.gen import generate_test_qp
from tests.test_soft_weights import _lift_and_solve

F64 = dict(dtype=torch.float64, device="cpu")


def _agree(rj, rp, iterations=True, rtol=1e-8):
    j, p = convert.result_to_numpy(rj), convert.result_to_numpy(rp)
    assert p["exitflag"] == j["exitflag"], (p["exitflag"], j["exitflag"])
    tol = rtol * (1.0 + np.abs(j["x"]).max())
    assert np.abs(p["x"] - j["x"]).max() <= tol
    assert np.abs(p["lam"] - j["lam"]).max() <= tol
    assert abs(p["fval"] - j["fval"]) <= rtol * (1.0 + abs(j["fval"]))
    if iterations:
        assert p["iterations"] == j["iterations"], \
            (p["iterations"], j["iterations"])
    return p


def _both(H, f, A, bu, bl, sense=None, ms=0, **kw):
    rj = daqp_tpu.quadprog(H, f, A, bu, bl, sense, ms=ms, **kw)
    rp = dt.quadprog(H, f, A, bu, bl, sense, ms=ms, **F64, **kw)
    return rj, rp


@pytest.mark.parametrize("dims", [(10, 50, 5, 8), (50, 250, 25, 40),
                                  (10, 30, 10, 8)])
def test_quadprog_random_matches_jax(dims):
    # test_quadprog.py's families; (10, 30, 10, 8) is BASELINE config 1
    n, m, ms, nact = dims
    rng = np.random.default_rng(1234)
    for _ in range(20 if n <= 10 else 8):
        x, H, f, A, bu, bl, sense = generate_test_qp(n, m, ms, nact, 1e2, rng)
        p = _agree(*_both(H, f, A, bu, bl, sense, ms=ms))
        assert p["exitflag"] == dt.EXIT_OPTIMAL
        assert np.linalg.norm(p["x"] - x) < 1e-6


def test_quadprog_large_matches_jax():
    rng = np.random.default_rng(7)
    x, H, f, A, bu, bl, sense = generate_test_qp(100, 500, 50, 80, 1e2, rng)
    p = _agree(*_both(H, f, A, bu, bl, sense, ms=50))
    assert np.linalg.norm(p["x"] - x) < 1e-4


def test_one_sided_and_shortcut_match_jax():
    rng = np.random.default_rng(3)
    x, H, f, A, bu, bl, sense = generate_test_qp(20, 100, 0, 10, 1e2, rng)
    _agree(*_both(H, f, A, bu, None, sense))
    # the unconstrained shortcut: no iteration, x = -H^-1 f
    n = 8
    rng = np.random.default_rng(5)
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    H = Q @ np.diag(1.0 + rng.random(n)) @ Q.T
    f = rng.standard_normal(n)
    x_unc = -np.linalg.solve(H, f)
    A = rng.standard_normal((4, n))
    p = _agree(*_both(H, f, A, A @ x_unc + 1.0, A @ x_unc - 1.0))
    assert p["iterations"] <= 1
    assert np.linalg.norm(p["x"] - x_unc) < 1e-8


@pytest.mark.parametrize("case", ["bounds", "rows"])
def test_infeasible_matches_jax(case):
    H, f = np.eye(2), np.zeros(2)
    if case == "bounds":      # bl > bu
        A, bu, bl = np.array([[1.0, 1.0]]), np.array([-1.0]), np.array([1.0])
    else:                     # x1 <= -1 and x1 >= 1
        A = np.array([[1.0, 0.0], [1.0, 0.0]])
        bu, bl = np.array([-1.0, 5.0]), np.array([-5.0, 1.0])
    p = _agree(*_both(H, f, A, bu, bl))
    assert p["exitflag"] == dt.EXIT_INFEASIBLE


def test_equality_constraints_match_jax():
    rng = np.random.default_rng(11)
    x, H, f, A, bu, bl, sense = generate_test_qp(10, 30, 0, 5, 1e2, rng)
    Ax = A @ x
    bu2, bl2 = bu.copy(), bl.copy()
    bu2[:2] = bl2[:2] = Ax[:2]
    p = _agree(*_both(H, f, A, bu2, bl2, sense))
    assert np.abs(A[:2] @ p["x"] - Ax[:2]).max() < 1e-8


@pytest.mark.parametrize("pricing", [dt.PRICING_DANTZIG, dt.PRICING_BLAND])
def test_pricing_rules_match_jax(pricing):
    # index for index: the same iteration counts under both rules
    rng = np.random.default_rng(117)
    for _ in range(4):
        x, H, f, A, bu, bl, sense = generate_test_qp(10, 30, 0, 6, 1e2, rng)
        p = _agree(*_both(H, f, A, bu, bl, sense,
                          settings={"pricing": pricing}))
        assert np.linalg.norm(p["x"] - x) < 1e-6


@pytest.mark.parametrize("start", ["primal", "dual"])
def test_warm_start_one_iteration(start):
    rng = np.random.default_rng(41 if start == "primal" else 43)
    x, H, f, A, bu, bl, sense = generate_test_qp(50, 250, 25, 40, 1e2, rng)
    if start == "primal":
        kw = dict(primal_start=x)
    else:
        kw = dict(dual_start=np.asarray(daqp_tpu.quadprog(
            H, f, A, bu, bl, sense, ms=25).lam))
    p = _agree(*_both(H, f, A, bu, bl, sense, ms=25, **kw))
    assert p["exitflag"] == dt.EXIT_OPTIMAL and p["iterations"] == 1


def test_degenerate_primal_start_and_helpers():
    H, f, A = np.eye(2), np.zeros(2), np.ones((1, 2))
    bu = np.array([1.0, 1.0, 2.0])
    p = _agree(*_both(H, f, A, bu, None, ms=2,
                      primal_start=np.array([1.0, 1.0])))
    assert np.linalg.norm(p["x"]) < 1e-5
    # the three helpers against the JAX ones
    from daqp_tpu import warmstart as jws
    from daqp_tpu_torch import warmstart as pws
    rng = np.random.default_rng(9)
    x, H, f, A, bu, bl, sense = generate_test_qp(6, 14, 3, 4, 1e1, rng)
    lam = rng.standard_normal(14) * (rng.random(14) < 0.5)
    t = torch.as_tensor
    assert (np.asarray(jws.primal_init_active(x, A, bu, bl, sense, 3))
            == pws.primal_init_active(t(x), t(A), t(bu), t(bl), t(sense),
                                      3).numpy()).all()
    assert (np.asarray(jws.dual_init_active(lam, sense))
            == pws.dual_init_active(t(lam), t(sense)).numpy()).all()
    for z in (x, x + 1.0):
        assert int(jws.first_violating(z, A, bu, bl, 3)) == int(
            pws.first_violating(t(z), t(A), t(bu), t(bl), 3))


def test_prefactored_matches_jax():
    rng = np.random.default_rng(223)
    x, H, f, A, bu, bl, sense = generate_test_qp(20, 60, 0, 12, 1e2, rng)
    R = np.linalg.cholesky(H).T
    p = _agree(*_both(R, f, A, bu, bl, sense, prefactored=True))
    r_raw = dt.quadprog(H, f, A, bu, bl, sense, ms=0, **F64)
    assert np.allclose(p["x"], r_raw.x.numpy(), atol=1e-8)
    assert np.linalg.norm(p["x"] - x) < 1e-4


def test_soft_rows_match_jax():
    H, f = np.eye(1), np.zeros(1)
    A = np.array([[1.0], [1.0]])
    # hard x <= 0 against soft x >= 1
    p = _agree(*_both(H, f, A, np.array([0.0, 1e30]), np.array([-1e30, 1.0]),
                      np.array([0, dt.SOFT], np.int32)))
    assert p["exitflag"] == dt.EXIT_SOFT_OPTIMAL and p["soft_slack"] > 0
    # conflicting soft equalities: the least-squares compromise
    p = _agree(*_both(H, f, A, np.array([4.0, 8.0]), np.array([4.0, 8.0]),
                      np.array([dt.SOFT, dt.SOFT], np.int32)))
    assert abs(p["x"][0] - 6.0) < 0.01
    rng = np.random.default_rng(89)
    x, H, f, A, bu, bl, sense = generate_test_qp(10, 30, 0, 6, 1e2, rng)
    _agree(*_both(H, f, A, bu, bl, sense | dt.SOFT))
    # plain per-row penalties (the row-rescaling path)
    w = 1e-6 * (1.0 + rng.random(30))
    _agree(*_both(H, f, A, bu, bl, sense | dt.SOFT, soft_weights=w))


def _sw_problem(rng, n=6, m=14, soft_rows=(0, 3, 7, 11)):
    Q = rng.standard_normal((n, n))
    H = Q @ Q.T + 0.5 * np.eye(n)
    f = 3 * rng.standard_normal(n)
    A = rng.standard_normal((m, n))
    bu = 0.3 * rng.random(m)
    bl = bu - 0.3 - 0.5 * rng.random(m)
    rows = list(soft_rows)
    sense = np.zeros(m, np.int32)
    sense[rows] = dt.SOFT
    sw = dict(d_ls=np.zeros(m), d_us=np.zeros(m), rho_ls=np.ones(m),
              rho_us=np.ones(m))
    sw['d_ls'][rows] = 0.4 * rng.random(len(rows))
    sw['d_us'][rows] = 0.4 * rng.random(len(rows))
    sw['rho_ls'][rows] = 0.5 + rng.random(len(rows))
    sw['rho_us'][rows] = 0.5 + rng.random(len(rows))
    return H, f, A, bu, bl, sense, rows, sw


def test_soft_weights_match_jax_and_lifted_qp():
    rng = np.random.default_rng(21)
    for _ in range(6):
        H, f, A, bu, bl, sense, rows, sw = _sw_problem(rng)
        p = _agree(*_both(H, f, A, bu, bl, sense, soft_weights=sw))
        x_ref = _lift_and_solve(H, f, A, bu, bl, rows, sw['d_ls'],
                                sw['d_us'], sw['rho_ls'], sw['rho_us'])
        assert p["exitflag"] in (1, 2)
        assert np.abs(p["x"] - x_ref).max() < 1e-6
    # 1-d: FREE (strongly violated) and FIXED (mildly) slack
    for c, x_want in ((5.0, 2.75), (1.3, 1.0)):
        p = _agree(*_both(np.eye(1), np.array([-c]), np.array([[1.0]]),
                          np.array([1.0]), np.array([-1e30]),
                          np.array([dt.SOFT], np.int32),
                          soft_weights=dict(d_ls=np.zeros(1),
                                            d_us=np.array([0.5]),
                                            rho_ls=np.ones(1),
                                            rho_us=np.ones(1))))
        assert abs(p["x"][0] - x_want) < 1e-8


@pytest.mark.parametrize("case", ["diagonal", "dense", "objective"])
def test_semidefinite_matches_jax(case):
    # the proximal loop stops within eta / eps of its fixed point (eta
    # 1e-6), and the two packages factor the shifted H + eps I with
    # different LAPACK routines, whose results differ by ~cond * 1e-16
    # (8e-10 in Rinv for the dense case): x within 1e-6, not 1e-8
    if case == "diagonal":        # semi-proximal (utils.c:179-207)
        H = np.diag([2.0, 0.0, 1.0, 0.0])
        f = np.array([-1.0, 1.0, -1.0, -2.0])
        A, bu, bl = np.eye(4), np.ones(4), -np.ones(4)
    elif case == "dense":         # full shift with retry doubling
        rng = np.random.default_rng(311)
        V = rng.standard_normal((4, 2))
        H, f = V @ V.T, rng.standard_normal(4)
        A, bu, bl = np.eye(4), np.ones(4), -np.ones(4)
    else:
        H, f = np.diag([1.0, 0.0]), np.array([-0.5, -1.0])
        A, bu, bl = np.eye(2), np.array([2.0, 3.0]), np.array([-2.0, -3.0])
    p = _agree(*_both(H, f, A, bu, bl), rtol=1e-6)
    assert p["exitflag"] == dt.EXIT_OPTIMAL
    if case == "objective":
        assert np.allclose(p["x"], [0.5, 3.0], atol=1e-5)


@pytest.mark.parametrize("limit", [1e-9, 100.0])
def test_time_limit_matches_jax(limit):
    # test_time_limit_triggers / _generous: the 32-iteration check fires
    # in this 80-active-row solve as it does in the JAX package
    rng = np.random.default_rng(83)
    x, H, f, A, bu, bl, sense = generate_test_qp(100, 500, 50, 80, 1e2, rng)
    kw = dict(settings={"time_limit": limit})
    rj = daqp_tpu.quadprog(H, f, A, bu, bl, sense, ms=50, **kw)
    rp = dt.quadprog(H, f, A, bu, bl, sense, ms=50, **F64, **kw)
    assert rp.exitflag == int(rj.exitflag)
    if limit < 1:
        assert rp.exitflag == dt.EXIT_TIMELIMIT
    else:
        _agree(rj, rp)
        assert np.linalg.norm(rp.x.numpy() - x) < 1e-4


def test_time_limit_prox_outer():
    # a semidefinite H: the outer loop's own check fires
    rng = np.random.default_rng(6)
    n, m = 40, 80
    Q = rng.standard_normal((n, 20))
    A = rng.standard_normal((m, n))
    kw = dict(settings={"time_limit": 1e-9})
    args = (Q @ Q.T, rng.standard_normal(n), A, 5 + 5 * rng.random(m),
            -(5 + 5 * rng.random(m)))
    rj = daqp_tpu.quadprog(*args, None, ms=0, **kw)
    rp = dt.quadprog(*args, None, ms=0, **F64, **kw)
    assert rp.exitflag == int(rj.exitflag) == dt.EXIT_TIMELIMIT


def test_f32_config1_meets_the_gate():
    # config 1 in f32 with the f32 settings: x within 1e-4 of the
    # constructed optimum, as chip_smoke.py's single phase gates it
    rng = np.random.default_rng(2026)
    for _ in range(8):
        x, H, f, A, bu, bl, sense = generate_test_qp(10, 30, 10, 8, 1e2, rng)
        r = dt.quadprog(H, f, A, bu, bl, sense, ms=10, dtype=torch.float32,
                        device="cpu")
        assert r.exitflag == dt.EXIT_OPTIMAL and r.x.dtype == torch.float32
        assert np.linalg.norm(r.x.numpy() - x) <= 1e-4


def test_device_and_dispatch_rules():
    rng = np.random.default_rng(1)
    x, H, f, A, bu, bl, sense = generate_test_qp(4, 8, 0, 2, 1e1, rng)
    if not torch.cuda.is_available():
        # numpy inputs go to the card: no card raises, nothing falls back
        with pytest.raises(RuntimeError, match="CUDA"):
            dt.quadprog(H, f, A, bu, bl, sense)
    # CPU tensors stay on the CPU; dtype None is torch's default
    r = dt.quadprog(*map(torch.as_tensor, (H, f, A, bu, bl)), sense)
    assert r.x.device.type == "cpu"
    assert r.x.dtype == torch.get_default_dtype()
    # every branch of the dispatch is ported (an LP, an AVI, a
    # hierarchy, branch and bound): each runs on the CPU when asked, and
    # on numpy inputs without a device needs the card
    t = torch.as_tensor
    for kw in (dict(H=None), dict(H=t(H), is_avi=True),
               dict(H=t(H), break_points=(4, 8)),
               dict(H=t(H), sense=sense | dt.BINARY)):
        r = dt.solve(**{"f": t(f), "A": t(A), "bupper": t(bu),
                        "blower": t(bl), **kw})
        assert r.x.device.type == "cpu" and r.exitflag != 0
        if not torch.cuda.is_available():
            np_kw = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                     for k, v in kw.items()}
            with pytest.raises(RuntimeError, match="CUDA"):
                dt.solve(f=f, A=A, bupper=bu, blower=bl, **np_kw)


def _chip_smoke():
    import importlib.util
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke_single",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_config1_f32_jax_reference_lanes():
    # chip_smoke.py's single phase builds its f32 gate on the JAX
    # package's own lanes flagged 1 beyond 1e-4 on config 1's 256 QPs
    # (JAX_SINGLE_SILENT32), each KKT-certified; the port's twins on the
    # CPU flag the same lanes
    import jax.numpy as jnp
    cs = _chip_smoke()
    from tests import gen
    silent_j, silent_p = [], []
    st = dt.default_settings_f32()
    for b, (x, H, f, A, bu, bl, sense) in enumerate(cs.config1(gen)):
        rj = daqp_tpu.quadprog(H, f, A, bu, bl, sense, ms=cs.MS1,
                               dtype=jnp.float32)
        rp = dt.quadprog(H, f, A, bu, bl, sense, ms=cs.MS1,
                         dtype=torch.float32, settings=st, device="cpu")
        for r, out in ((rj, silent_j), (rp, silent_p)):
            p = convert.result_to_numpy(r)
            assert p["exitflag"] == 1
            if np.linalg.norm(p["x"] - x) > cs.ACC_TOL:
                stat, viol = dt.kkt_residuals(
                    H[None], f[None], A[None], bu[None], bl[None], None,
                    p["x"][None], p["lam"][None], ms=cs.MS1)
                assert max(stat[0], viol[0]) <= 1e-4
                out.append(b)
    assert tuple(silent_j) == tuple(silent_p) == cs.JAX_SINGLE_SILENT32


def _ulp_move(a, rng):
    """``a`` in f32 with each entry moved down, not at all or up by one
    ulp (``rng`` picks), back in f64."""
    a32 = a.astype(np.float32)
    step = rng.integers(-1, 2, size=a.shape)
    up = np.nextafter(a32, np.float32(np.inf))
    down = np.nextafter(a32, np.float32(-np.inf))
    return np.where(step > 0, up, np.where(step < 0, down, a32)
                    ).astype(np.float64)


def test_config1_f32_edge_lanes():
    # chip_smoke.py's single phase also admits JAX_SINGLE_EDGE32: lanes
    # within 1e-4 for the JAX package on config 1's data, which it flags
    # 1 beyond 1e-4 once H and A move by at most one f32 ulp (the seed
    # beside each lane), KKT-certified, with one row of the f64 active set
    # left out and violated under the f32 primal_tol
    import jax.numpy as jnp
    cs = _chip_smoke()
    from tests import gen
    probs = cs.config1(gen)
    tol = dt.default_settings_f32().primal_tol
    assert not set(cs.JAX_SINGLE_EDGE32) & set(cs.JAX_SINGLE_SILENT32)
    for b, seed in cs.JAX_SINGLE_EDGE32.items():
        x, H, f, A, bu, bl, sense = probs[b]
        rng = np.random.default_rng(seed)
        Hm = _ulp_move(H, rng)
        Hm = 0.5 * (Hm + Hm.T)
        Am = _ulp_move(A, rng)
        r64 = convert.result_to_numpy(daqp_tpu.quadprog(
            H, f, A, bu, bl, sense, ms=cs.MS1))
        err = []
        for Hb, Ab in ((H, A), (Hm, Am)):
            p = convert.result_to_numpy(daqp_tpu.quadprog(
                Hb, f, Ab, bu, bl, sense, ms=cs.MS1, dtype=jnp.float32))
            assert p["exitflag"] == 1
            err.append(np.linalg.norm(p["x"] - x))
        # unmoved within the gate, moved beyond it
        assert err[0] <= cs.ACC_TOL < err[1]
        left_out = set(np.flatnonzero(r64["lam"])) \
            - set(np.flatnonzero(p["lam"]))
        assert len(left_out) == 1
        (row,) = left_out
        Ax = np.concatenate([p["x"][:cs.MS1], A @ p["x"]])
        assert 0 < max(Ax[row] - bu[row], bl[row] - Ax[row]) <= tol
        stat, viol = dt.kkt_residuals(
            H[None], f[None], A[None], bu[None], bl[None], None,
            p["x"][None], p["lam"][None], ms=cs.MS1)
        assert max(stat[0], viol[0]) <= 1e-4
