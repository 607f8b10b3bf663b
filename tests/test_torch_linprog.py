"""The port's single-instance LP (daqp_tpu_torch.prox.linprog_core and
api.linprog) against the JAX package on the CPU.

test_linprog.py's four cases go through ``daqp_tpu.linprog`` (x64,
tests/conftest.py) and ``daqp_tpu_torch.linprog`` on the CPU: in f64 the
same exit flag, iteration count and x within 1e-8; in f32 with the
default ``f64_backstop`` the same flag and x within 1e-4.  An f32 LP
whose positive exit fails the f64 KKT gate of 1e-5 is solved again in
f64 by both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import daqp_tpu
import daqp_tpu_torch as dt
from daqp_tpu_torch import api as papi
from tests.gen import generate_test_lp


def _lp_random():
    rng = np.random.default_rng(21)
    return [generate_test_lp(20, 100, 10, rng) + (10,) for _ in range(10)]


def _lp_unbounded():
    # min -x1 with only a bound on x2
    return [(None, np.array([-1.0, 0.0]), np.array([[0.0, 1.0]]),
             np.array([1.0]), np.array([-1.0]), None, 0)]


def _lp_cycle():
    # many rows through the same vertex (core_tests.jl:62-95)
    n = 4
    A = np.vstack([np.eye(n)] + [np.ones(n) / np.sqrt(n)] * 3)
    bu = np.concatenate([np.ones(n), np.full(3, np.sqrt(n))])
    return [(np.ones(n), -np.ones(n), A, bu, np.full(len(bu), -100.0), None,
             0)]


def _lp_large():
    rng = np.random.default_rng(2500)
    return [generate_test_lp(200, 1000, 100, rng) + (100,)]


CASES = {"random": _lp_random, "unbounded": _lp_unbounded,
         "cycle": _lp_cycle, "large": _lp_large}


def _x(r):
    return np.asarray(r.x, np.float64) if not isinstance(r.x, torch.Tensor) \
        else r.x.numpy().astype(np.float64)


@pytest.mark.parametrize("case", list(CASES))
def test_linprog_f64_matches_jax(case):
    for x_ref, f, A, bu, bl, sense, ms in CASES[case]():
        rj = daqp_tpu.linprog(f, A, bu, bl, sense, ms=ms)
        rp = dt.linprog(f, A, bu, bl, sense, ms=ms, dtype=torch.float64,
                        device="cpu")
        assert rp.exitflag == int(rj.exitflag), (rp.exitflag,
                                                 int(rj.exitflag))
        assert rp.iterations == int(rj.iterations)
        assert np.abs(_x(rp) - _x(rj)).max() <= 1e-8
        if rp.exitflag == dt.EXIT_OPTIMAL and case != "large":
            # (at the large LP's vertex of 200 rows both packages' E are
            # off the exact inverse Gram by 4e-4 after 1368 iterations,
            # and the last two rows enter in the other order, so their
            # duals differ by ~1e-2 from each other and from the exact
            # ones; x agrees to 2e-13)
            lam_j = np.asarray(rj.lam)
            assert np.abs(rp.lam.numpy() - lam_j).max() \
                <= 1e-6 * (1.0 + np.abs(lam_j).max())
            assert abs(float(rp.fval) - float(rj.fval)) \
                <= 1e-8 * (1.0 + abs(float(rj.fval)))
        if x_ref is not None:
            assert np.linalg.norm(_x(rp) - x_ref) < 1e-4
    if case == "unbounded":
        assert rp.exitflag == dt.EXIT_UNBOUNDED


@pytest.mark.parametrize("case", ["random", "unbounded", "cycle"])
def test_linprog_f32_backstop_matches_jax(case):
    # the default f64_backstop: a loud f32 exit, or a positive one
    # beyond the 1e-5 KKT gate, is solved again in f64
    for x_ref, f, A, bu, bl, sense, ms in CASES[case]():
        rj = daqp_tpu.linprog(f, A, bu, bl, sense, ms=ms, dtype=jnp.float32)
        rp = dt.linprog(f, A, bu, bl, sense, ms=ms, dtype=torch.float32,
                        device="cpu")
        assert rp.exitflag == int(rj.exitflag)
        assert np.abs(_x(rp) - _x(rj)).max() <= 1e-4
        if x_ref is not None:
            assert np.linalg.norm(_x(rp) - x_ref) < 1e-4


def test_linprog_f32_kkt_gate_resolves_in_f64():
    # configLP's LPs (seed 17): lane 2's f32 exit is flag 1 beyond the
    # f64 KKT gate of 1e-5, so it is solved again in f64 (its result is
    # f64) by both packages; lane 0's f32 exit passes the gate and stands
    rng = np.random.default_rng(17)
    lps = [generate_test_lp(10, 50, 0, rng) for _ in range(3)]
    x_ref, f, A, bu, bl, sense = lps[2]
    raw = dt.linprog(f, A, bu, bl, sense, ms=0, dtype=torch.float32,
                     device="cpu", f64_backstop=False)
    assert raw.exitflag == dt.EXIT_OPTIMAL and raw.x.dtype == torch.float32
    assert papi._dubious(raw, True, f, torch.as_tensor(A), bu, bl,
                         np.zeros(50, np.int32), 0)
    fixed = dt.linprog(f, A, bu, bl, sense, ms=0, dtype=torch.float32,
                       device="cpu")
    rj = daqp_tpu.linprog(f, A, bu, bl, sense, ms=0, dtype=jnp.float32)
    assert fixed.x.dtype == torch.float64 and np.asarray(rj.x).dtype \
        == np.float64
    assert fixed.exitflag == int(rj.exitflag) == dt.EXIT_OPTIMAL
    assert np.abs(_x(fixed) - _x(rj)).max() <= 1e-8
    x_ref, f, A, bu, bl, sense = lps[0]
    r = dt.linprog(f, A, bu, bl, sense, ms=0, dtype=torch.float32,
                   device="cpu")
    assert r.exitflag == dt.EXIT_OPTIMAL and r.x.dtype == torch.float32
    assert np.abs(_x(r) - x_ref).max() < 1e-4
