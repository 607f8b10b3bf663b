"""The port's ``Model`` (daqp_tpu_torch.model) against the JAX package's
on the CPU in f64: the QP cases of test_model.py (set-up, warm re-solve,
the masked updates of f / bounds, sense and A, a new H, settings), each
with the same exit flags, x and lam within 1e-8 (1 + ||x_jax||_inf) and
the same iteration counts.  The special problems (an AVI, a hierarchy,
an LP, BINARY bits) go through ``api.solve`` and give its one-shot
result, as the JAX package's Model does."""
import numpy as np
import pytest
import torch

import daqp_tpu
import daqp_tpu_torch as dt
from tests.gen import generate_test_qp, generate_test_avi
from tests.test_torch_single import _agree

F64 = dict(dtype=torch.float64, device="cpu")


def _models(H, f, A, bu, bl, sense, ms=0, settings=None):
    dj = daqp_tpu.Model(settings)
    dj.setup(H, f, A, bu, bl, sense, ms=ms)
    dp = dt.Model(settings)
    dp.setup(H, f, A, bu, bl, sense, ms=ms, **F64)
    return dj, dp


def test_model_setup_solve_and_warm_resolve():
    rng = np.random.default_rng(61)
    x, H, f, A, bu, bl, sense = generate_test_qp(20, 100, 10, 15, 1e2, rng)
    dj, dp = _models(H, f, A, bu, bl, sense, ms=10)
    p = _agree(dj.solve(), dp.solve())
    assert p["exitflag"] == dt.EXIT_OPTIMAL
    assert np.linalg.norm(p["x"] - x) < 1e-4
    # warm: the working set is already optimal
    p2 = _agree(dj.solve(), dp.solve())
    assert p2["iterations"] == 1
    assert np.allclose(p2["x"], p["x"], atol=1e-10)


def test_model_update_fb_warm():
    rng = np.random.default_rng(71)
    x, H, f, A, bu, bl, sense = generate_test_qp(20, 100, 0, 15, 1e2, rng)
    dj, dp = _models(H, f, A, bu, bl, sense)
    _agree(dj.solve(), dp.solve())
    for d in (dj, dp):
        d.update(f=f * 1.001, bupper=bu + 1e-4, blower=bl - 1e-4)
    p = _agree(dj.solve(), dp.solve())
    assert p["exitflag"] == dt.EXIT_OPTIMAL and p["iterations"] <= 5
    ref = dt.quadprog(H, f * 1.001, A, bu + 1e-4, bl - 1e-4, sense, **F64)
    assert np.allclose(p["x"], ref.x.numpy(), atol=1e-8)


def test_model_update_structural():
    rng = np.random.default_rng(73)
    x1, H1, f1, A1, bu1, bl1, s1 = generate_test_qp(10, 30, 0, 6, 1e2, rng)
    x2, H2, f2, A2, bu2, bl2, s2 = generate_test_qp(10, 30, 0, 6, 1e2, rng)
    dj, dp = _models(H1, f1, A1, bu1, bl1, s1)
    _agree(dj.solve(), dp.solve())
    for d in (dj, dp):
        d.update(H=H2, f=f2, A=A2, bupper=bu2, blower=bl2)
    p = _agree(dj.solve(), dp.solve())
    assert np.linalg.norm(p["x"] - x2) < 1e-4


def test_model_update_sense_keeps_the_factor():
    rng = np.random.default_rng(101)
    x, H, f, A, bu, bl, sense = generate_test_qp(10, 30, 0, 6, 1e2, rng)
    dj, dp = _models(H, f, A, bu, bl, sense)
    _agree(dj.solve(), dp.solve())
    rinv, M = dp._ldpd.Rinv, dp._ldpd.M
    sense2 = np.array(sense, np.int32)
    sense2[0] |= dt.SOFT
    for d in (dj, dp):
        d.update(sense=sense2)
    assert dp._ldpd.Rinv is rinv and dp._ldpd.M is M
    p = _agree(dj.solve(), dp.solve())
    ref = dt.quadprog(H, f, A, bu, bl, sense2, **F64)
    assert p["exitflag"] == ref.exitflag
    assert np.linalg.norm(p["x"] - ref.x.numpy()) < 1e-8


def test_model_update_sense_warm_activation():
    rng = np.random.default_rng(103)
    x, H, f, A, bu, bl, sense = generate_test_qp(8, 20, 0, 5, 1e2, rng)
    dj, dp = _models(H, f, A, bu, bl, sense)
    p1 = _agree(dj.solve(), dp.solve())
    sense2 = np.array(sense, np.int32)
    for i in np.nonzero(np.abs(p1["lam"]) > 1e-9)[0]:
        sense2[i] |= dt.ACTIVE | (dt.LOWER if p1["lam"][i] < 0 else 0)
    for d in (dj, dp):
        d.update(sense=sense2)
    p2 = _agree(dj.solve(), dp.solve())
    assert p2["iterations"] == 1
    assert np.linalg.norm(p2["x"] - p1["x"]) < 1e-7


def test_model_update_A_reuses_factorization():
    rng = np.random.default_rng(105)
    x1, H, f, A1, bu, bl, sense = generate_test_qp(10, 30, 0, 6, 1e2, rng)
    A2 = A1 + 0.05 * rng.standard_normal(A1.shape)
    dj, dp = _models(H, f, A1, bu, bl, sense)
    _agree(dj.solve(), dp.solve())
    rinv = dp._ldpd.Rinv
    for d in (dj, dp):
        d.update(A=A2)
    assert dp._ldpd.Rinv is rinv
    p = _agree(dj.solve(), dp.solve())
    ref = dt.quadprog(H, f, A2, bu, bl, sense, **F64)
    assert np.linalg.norm(p["x"] - ref.x.numpy()) < 1e-8


def test_model_settings_and_regularization(tmp_path):
    d = dt.Model()
    assert d.settings({"iter_limit": 123})["iter_limit"] == 123
    assert d.settings() == daqp_tpu.Model().settings({"iter_limit": 123})
    rng = np.random.default_rng(5)
    x, H, f, A, bu, bl, sense = generate_test_qp(6, 12, 0, 3, 1e1, rng)
    d = dt.Model().setup(H, f, A, bu, bl, sense, **F64)
    assert d.proximal_regularization() == 0.0
    # ported: Model.codegen renders the model's problem as embedded C
    # (tests/test_torch_codegen.py compiles and solves it)
    cpath = d.codegen(name="reg", dir=str(tmp_path))
    assert open(cpath).read().startswith("\n/* --- embedded dual")
    assert "#define reg_N     6" in open(cpath).read()
    # a semidefinite H takes api.solve's proximal path, as in JAX: the
    # port's own one-shot to the bit, the JAX one's flag, and its
    # objective to the outer loop's accuracy (its minimizers need not be
    # unique, and each package stops within eta / eps of its own fixed
    # point: 1.2e-6 apart here)
    V = rng.standard_normal((6, 3))
    args = (V @ V.T, f, A, bu + 2.0, bl - 2.0, sense)
    dj, dp = _models(*args)
    assert dp.proximal_regularization() > 0
    rj, rp = dj.solve(), dp.solve()
    one = dt.quadprog(*args, **F64)
    assert torch.equal(rp.x, one.x) and rp.exitflag == one.exitflag
    assert rp.exitflag == int(rj.exitflag) == dt.EXIT_OPTIMAL
    assert abs(float(rp.fval) - float(rj.fval)) <= 1e-5 * (
        1.0 + abs(float(rj.fval)))


def test_model_special_problems_raise():
    # the AVI and break-point problems that raised before their paths
    # were ported now solve through api.solve: the one-shot result
    rng = np.random.default_rng(79)
    x, H, f, A, b = generate_test_avi(10, 50, rng)
    r = dt.Model().setup(H, f, A, b, is_avi=True, ms=0, **F64).solve()
    one = dt.avi(H, f, A, b, ms=0, **F64)
    assert torch.equal(r.x, one.x) and r.exitflag == one.exitflag == 1
    assert np.linalg.norm(r.x.numpy() - x) < 1e-4
    A = np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    args = (np.eye(2), np.zeros(2), A, np.array([1.0, 1, 5]),
            np.array([1.0, -1, -5]))
    r = dt.Model().setup(*args, break_points=(2, 3), **F64).solve()
    one = dt.quadprog(*args, break_points=(2, 3), **F64)
    assert torch.equal(r.x, one.x) and r.exitflag == one.exitflag > 0


@pytest.mark.parametrize("kind", ["lp", "binary", "hierarchy", "avi"])
def test_model_special_paths_match_one_shot_and_jax(kind):
    rng = np.random.default_rng(83)
    kw = {}
    if kind == "lp":
        from tests.gen import generate_test_lp
        x, f, A, bu, bl, sense = generate_test_lp(8, 30, 4, rng)
        args, kw = (None, f, A, bu, bl, sense), dict(ms=4)
    elif kind == "binary":
        from tests.test_bnb import _random_miqp
        H, f, A, bu, bl, sense = _random_miqp(8, 20, 4, 3, rng)
        args, kw = (H, f, A, bu, bl, sense), dict(ms=4)
    elif kind == "hierarchy":
        A = rng.standard_normal((9, 4))
        x0 = rng.standard_normal(4)
        b = A @ x0
        args = (None, np.zeros(4), A, b + 0.1, b - 0.1 - rng.random(9),
                None)
        kw = dict(ms=0, break_points=(0, 3, 6, 9))
    else:
        x, H, f, A, b = generate_test_avi(8, 20, rng)
        args, kw = (H, f, A, b, None, None), dict(ms=0, is_avi=True)
    dp = dt.Model().setup(*args, **kw, **F64)
    dj = daqp_tpu.Model().setup(*args, **kw)
    rp = dp.solve()
    is_avi = kw.pop("is_avi", False)
    one = dt.solve(H=args[0], f=args[1], A=args[2], bupper=args[3],
                   blower=args[4], sense=args[5], is_avi=is_avi, **kw,
                   **F64)
    assert torch.equal(rp.x, one.x) and rp.exitflag == one.exitflag > 0
    assert rp.nodes == one.nodes
    rj = dj.solve()
    assert rp.exitflag == int(rj.exitflag)
    assert np.abs(rp.x.numpy() - np.asarray(rj.x)).max() <= 1e-6
    # a re-solve after an update of f (a special problem is set up again)
    f2 = args[1] * 1.01
    dp.update(f=f2)
    dj.update(f=f2)
    rp2, rj2 = dp.solve(), dj.solve()
    assert rp2.exitflag == int(rj2.exitflag)
    assert np.abs(rp2.x.numpy() - np.asarray(rj2.x)).max() <= 1e-6
