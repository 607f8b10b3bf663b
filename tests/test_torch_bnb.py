"""The port's single-instance branch and bound (daqp_tpu_torch.bnb,
api.solve with BINARY sense bits) against the JAX package on the CPU in
f64: test_bnb.py's cases (random MIQPs, a known solution, binaries at a
zero-dual endpoint, an infeasible tree), with rel_subopt / abs_subopt
and a finite fval_bound: the same exit flag, node count and iteration
count, fval within 1e-8.

fval is the reference's 0.5 (||u||^2 - ||v||^2) (v = R^-T f), whose
cancellation loses |v|^2 / 2 = f'H^-1 f / 2 times the unit roundoff:
on these MIQPs (f ~ 100) the two packages' plain root relaxations
already differ by 3e-6 in fval with x 8e-9 apart, so fval is held to
1e-8 (1 + |fval| + f'H^-1 f)."""
import numpy as np
import pytest
import torch

import daqp_tpu
import daqp_tpu_torch as dt
from tests.test_bnb import _random_miqp

F64 = dict(dtype=torch.float64, device="cpu")


def _both(H, f, A, bu, bl, sense, ms, settings=None):
    rj = daqp_tpu.quadprog(H, f, A, bu, bl, sense, ms=ms, settings=settings)
    rp = dt.quadprog(H, f, A, bu, bl, sense, ms=ms, settings=settings,
                     **F64)
    assert rp.exitflag == int(rj.exitflag), (rp.exitflag, int(rj.exitflag))
    assert rp.nodes == int(rj.nodes), (rp.nodes, int(rj.nodes))
    assert rp.iterations == int(rj.iterations)
    if rp.exitflag == dt.EXIT_OPTIMAL:
        scale = 1.0 + abs(float(rj.fval)) + abs(f @ np.linalg.solve(H, f))
        assert abs(float(rp.fval) - float(rj.fval)) <= 1e-8 * scale
    return rj, rp


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bnb_random_miqp_matches_jax(seed):
    rng = np.random.default_rng(seed)
    H, f, A, bu, bl, sense = _random_miqp(20, 60, 10, 6, rng)
    _, rp = _both(H, f, A, bu, bl, sense, 10)
    assert rp.exitflag == dt.EXIT_OPTIMAL
    xb = rp.x.numpy()[:6]
    assert np.all((np.abs(xb - 1.0) < 1e-5) | (np.abs(xb) < 1e-5)), xb


@pytest.mark.parametrize("settings", [{"rel_subopt": 0.3},
                                      {"abs_subopt": 50.0},
                                      {"rel_subopt": 0.1,
                                       "abs_subopt": 10.0}])
def test_bnb_subopt_folding_matches_jax(settings):
    # a looser cut prunes more: never more nodes than the exact tree, and
    # an incumbent within the tolerance of the exact optimum
    rng = np.random.default_rng(1)
    H, f, A, bu, bl, sense = _random_miqp(20, 60, 10, 6, rng)
    _, exact = _both(H, f, A, bu, bl, sense, 10)
    _, rp = _both(H, f, A, bu, bl, sense, 10, settings=settings)
    assert rp.exitflag == dt.EXIT_OPTIMAL and rp.nodes <= exact.nodes
    f0 = float(exact.fval)
    slack = settings.get("rel_subopt", 0.0) * abs(f0) \
        + settings.get("abs_subopt", 0.0)
    assert f0 - 1e-6 <= float(rp.fval) <= f0 + slack + 1e-6


@pytest.mark.parametrize("side", ["above", "below"])
def test_bnb_finite_fval_bound_matches_jax(side):
    # the bound cuts the relaxations' dual objective 0.5 ||u||^2 =
    # fval + f'H^-1 f / 2 (daqp.c:20-23): one above the optimum's leaves
    # the tree's answer; one below it prunes every node: no incumbent,
    # INFEASIBLE
    rng = np.random.default_rng(2)
    H, f, A, bu, bl, sense = _random_miqp(20, 60, 10, 6, rng)
    _, exact = _both(H, f, A, bu, bl, sense, 10)
    fb = float(exact.fval) + 0.5 * f @ np.linalg.solve(H, f) \
        + (100.0 if side == "above" else -100.0)
    _, rp = _both(H, f, A, bu, bl, sense, 10, settings={"fval_bound": fb})
    if side == "above":
        assert rp.exitflag == dt.EXIT_OPTIMAL
        assert np.abs(rp.x.numpy() - exact.x.numpy()).max() < 1e-6
    else:
        assert rp.exitflag == dt.EXIT_INFEASIBLE


def test_bnb_known_solution_matches_jax():
    H = np.array([[1, 0.5, 0], [0.5, 1, 0.5], [0, 0.5, 1]])
    f = np.array([1.0, 0, 0])
    A = np.array([[1.0, 2, 3], [1, 1, 0]])
    bu = np.array([1.0, 1, 1, 1e30, 1e30])
    bl = np.array([0.0, 0, 0, 4, 1])
    sense = np.array([dt.BINARY] * 3 + [0, 0], np.int32)
    _, rp = _both(H, f, A, bu, bl, sense, 3)
    assert rp.exitflag == dt.EXIT_OPTIMAL
    assert np.linalg.norm(rp.x.numpy() - [0, 1, 1]) < 1e-5


@pytest.mark.parametrize("rows", ["bounds", "general"])
def test_bnb_zero_dual_endpoint_matches_jax(rows):
    # binaries already at a zero-dual endpoint are not branched: one node
    n = 8
    H, f = np.eye(n), np.zeros(n)
    sense = np.full(n, dt.BINARY, np.int32)
    A, ms = (np.zeros((0, n)), n) if rows == "bounds" else (H, 0)
    _, rp = _both(H, f, A, np.ones(n), np.zeros(n), sense, ms)
    assert rp.exitflag == dt.EXIT_OPTIMAL and rp.nodes == 1
    assert np.abs(rp.x.numpy()).max() < 1e-5


def test_bnb_infeasible_matches_jax():
    # x1 + x2 = 0.5 leaves no binary point; a fixing the equality makes
    # dependent is dropped, so both packages branch on until the
    # iteration limit (2 iterations a node: 5001 nodes at the default
    # 10000, 201 here) and exit INFEASIBLE without an incumbent
    H, f = np.eye(2), np.zeros(2)
    A = np.array([[1.0, 1.0]])
    sense = np.array([dt.BINARY, dt.BINARY, 0], np.int32)
    _, rp = _both(H, f, A, np.array([1.0, 1.0, 0.5]),
                  np.array([0.0, 0.0, 0.5]), sense, 2,
                  settings={"iter_limit": 400})
    assert rp.exitflag == dt.EXIT_INFEASIBLE and rp.nodes == 201
