"""The port's single-instance hierarchy (daqp_tpu_torch.hierarchical,
api.solve with ``break_points``) against the JAX package on the CPU in
f64: test_hierarchical.py's four cases and BASELINE config 4b's
hierarchies (``bench_extra.py:144-168``), the same exit flag (exit 3,
no degrees of freedom, included), x within 1e-6 and the frozen slack
duals within 1e-6.

4b's first 8 hierarchies are held at the hierarchical tier's rho_soft,
3e-2 (``batch.HIQP_RHO_FLOOR``, the rho its oracle runs at), where the
two packages agree to 1e-10.  At the reference default rho_soft = 1e-6
a level's conflicting duplicated rows enter the Gram with a Schur
complement ~1e-6, which amplifies the last-bit differences of the two
packages' sums (XLA's and torch's) about 1e6-fold: of 4b's first 40
hierarchies, 38 end in the same class, x 1.6e-5 apart at most, and
lanes 12 and 17 change class (one level's pricing decision falls the
other way after 18 steps, measured step by step from the same state).
Lanes 0, 1 and 7 exit 3 there in both packages with the same x."""
import numpy as np
import pytest
import torch

import daqp_tpu
import daqp_tpu_torch as dt
from daqp_tpu_torch import batch as pbatch

F64 = dict(dtype=torch.float64, device="cpu")
TOL = 1e-6


def _both(**kw):
    rj = daqp_tpu.solve(**kw)
    rp = dt.solve(**kw, **F64)
    assert rp.exitflag == int(rj.exitflag), (rp.exitflag, int(rj.exitflag))
    return rj, rp


def _close(rj, rp, lam=True):
    assert np.abs(rp.x.numpy() - np.asarray(rj.x)).max() <= TOL
    if lam:
        assert np.abs(rp.lam.numpy() - np.asarray(rj.lam)).max() <= TOL


def test_hierarchical_basic_matches_jax():
    A = np.array([[1.0, 1, 1], [1, -1, 0], [3, 1, -1]])
    bu = np.concatenate([np.ones(3), [1, 0.5, 20]])
    bl = np.concatenate([-np.ones(3), [-1e30, 0.5, 10]])
    rj, rp = _both(H=None, f=None, A=A, bupper=bu, blower=bl, ms=3,
                   break_points=(3, 4, 5, 6))
    _close(rj, rp)
    assert np.linalg.norm(rp.x.numpy() - [1.0, 0.5, -1.0]) < 1e-4


def test_hierarchical_degenerate_matches_jax():
    H = np.array([[10.5, 4.0, 2.0], [4.0, 5.5, 0.5], [2.0, 0.5, 2.0]])
    f = np.array([-53.0, -30.0, -11.5])
    A = np.array([[1.0, 0, 0], [1, 1, 0], [0, 0, 0], [1, 0, 0]])
    bu = np.concatenate([3 * np.ones(3), [7.5, 7.5, 5.0, 10.0]])
    bl = np.concatenate([-3 * np.ones(3), [4.5, 4.5, 2.0, 7.0]])
    sense = np.zeros(7, np.int32)
    sense[5] = dt.IMMUTABLE
    rj, rp = _both(H=H, f=f, A=A, bupper=bu, blower=bl, sense=sense, ms=3,
                   break_points=(3, 5, 7))
    assert rp.exitflag > 0
    _close(rj, rp)
    assert abs(float(rp.fval) - float(rj.fval)) <= TOL * (
        1 + abs(float(rj.fval)))


@pytest.mark.parametrize("what", ["x", "slack_duals"])
def test_hierarchical_conflicting_equalities_match_jax(what):
    # x1 = 4 and x1 = 8 meet at 6 in the least-squares sense, then x2 = 1;
    # the frozen slacks are ~(+2, -2)
    A = np.array([[1.0, 0], [1, 0], [0, 1]])
    b = np.array([4.0, 8.0, 1.0])
    rj, rp = _both(H=None, f=None, A=A, bupper=b, blower=b, ms=0,
                   break_points=(0, 2, 3))
    _close(rj, rp)
    if what == "x":
        assert np.linalg.norm(rp.x.numpy() - [6.0, 1.0]) < 1e-4
    else:
        lam = rp.lam.numpy()
        assert abs(lam[0] - 2.0) < 1e-3 and abs(lam[1] + 2.0) < 1e-3, lam


def _config4b(lanes):
    """bench_extra.py:153-166's hierarchies (seed 19), f64."""
    B, n, m = 256, 12, 24
    rng = np.random.default_rng(19)
    As = rng.standard_normal((B, m, n)).astype(np.float32)
    x0 = rng.standard_normal((B, n)).astype(np.float32)
    b0 = np.einsum('bmn,bn->bm', As, x0)
    bus = (b0 + 0.2 * rng.random((B, m))).astype(np.float32)
    bls = (b0 - 1.2 - 0.5 * rng.random((B, m))).astype(np.float32)
    As[:, 1] = As[:, 0]
    bus[:, 0] = b0[:, 0] - 1.0
    bls[:, 0] = b0[:, 0] - 2.0
    bls[:, 1] = b0[:, 1] + 1.0
    bus[:, 1] = b0[:, 1] + 2.0
    return [tuple(a[b].astype(np.float64) for a in (As, bus, bls))
            for b in lanes]


BP4B = (0, 8, 16, 24)


def test_config4b_hierarchies_match_jax():
    st = {"rho_soft": pbatch.HIQP_RHO_FLOOR}
    for A, bu, bl in _config4b(range(8)):
        rj, rp = _both(H=None, f=np.zeros(12), A=A, bupper=bu, blower=bl,
                       ms=0, break_points=BP4B, settings=st)
        assert rp.exitflag > 0
        _close(rj, rp)
        assert rp.iterations == int(rj.iterations)


def test_config4b_no_dof_exits_match_jax():
    # the reference default rho_soft: a level fails and the walk exits 3
    # with the previous level's point, in both packages (the slack duals
    # of a failed level are not compared: see the module docstring)
    flags = []
    for A, bu, bl in _config4b((0, 1, 7)):
        rj, rp = _both(H=None, f=np.zeros(12), A=A, bupper=bu, blower=bl,
                       ms=0, break_points=BP4B)
        assert np.abs(rp.x.numpy() - np.asarray(rj.x)).max() <= 1e-5
        flags.append(rp.exitflag)
    assert flags == [dt.EXIT_NO_DOF] * 3
