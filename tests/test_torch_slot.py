"""K2 (daqp_tpu_torch.ops.slot): the plain twin of the CUDA slot-round
kernel against the JAX kernel it replaces (``ops/pallas_slot.py
run_slot_round``, Pallas interpret mode) on one carried-over state, and
the port's slot tier on the cases of test_pallas_slot.py, gated against
the constructed optimum."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daqp_tpu import transform
from daqp_tpu.api import _as_settings
from daqp_tpu.ops import pallas_slot as ps
from daqp_tpu.types import IMMUTABLE
import daqp_tpu_torch as dt
from daqp_tpu_torch import convert
from daqp_tpu_torch.ops import slot as pslot
from tests.gen import generate_test_qp_batch

KEYS = ('H', 'f', 'A', 'bupper', 'blower', 'sense')


@pytest.mark.parametrize("steps", [8, 192])
def test_round_matches_jax_kernel(steps):
    B, n, m = 128, 10, 24
    d = generate_test_qp_batch(B, n, m, 0, 6, 1e2, rng=33,
                               dtype=np.float32)
    st = _as_settings({"iter_limit": 500}, jnp.float32)
    ldpd = jax.vmap(functools.partial(transform.build_ldp, ms=0, st=st))(
        *[jnp.asarray(d[k]) for k in KEYS])
    immut = ((ldpd.sense & IMMUTABLE) > 0).astype(jnp.float32)
    s = ps.slot_init(ldpd.M, ldpd.dupper, ldpd.dlower, ldpd.scaling, immut,
                     n_true=n)                   # JAX-padded: m 24, n/K 16
    sj = jax.tree_util.tree_map(
        np.asarray, ps.run_slot_round(s, st, n, steps=steps, interpret=True))
    sp = convert.slot_state_to_numpy(pslot.run_slot_round(
        convert.slot_state_from_jax(s), convert.settings_from_jax(st), n,
        steps=steps))
    # the active-set path: exit flags and slot tables agree lane by lane
    # (a lane may legally part at an f32 tie, so one of 128 is allowed)
    agree = (sp['status'][0] == sj.status[0]) \
        & (sp['used'] == sj.used).all(0) & (sp['sid'] == sj.sid).all(0)
    assert agree.sum() >= 127, agree.sum()
    assert (sp['iterations'][0] == sj.iterations[0])[agree].all()
    # the iterates: each rank-one update of the inverse Gram carries the
    # f32 rounding of its sums (taken in another order by XLA) scaled by
    # the conditioning of the working set of the moment (max|E| reaches
    # ~570 within 8 steps on this batch).  Measured over seeds 5-7 and 33,
    # the gap sits at up to 1.5x of 1e-4 (1 + max|.|) after 192 steps and
    # 1.7x for E after 8; the gate is 5e-4 (1 + max|.|).
    for name in ('u', 'lam_star', 'E'):
        ref = getattr(sj, name)
        gap = np.abs(sp[name] - ref)[..., agree].max()
        assert gap <= 5e-4 * (1.0 + np.abs(ref).max()), (name, gap)



def test_round_dominance_cut_matches_jax_kernel():
    # K2's per-lane fbound cut (slot_step.cuh:650, pallas_slot.py's
    # per-lane dominance exit): every other lane gets a bound below half
    # its optimal LDP fval from an unbounded run, the rest DAQP_INF.  The
    # cut lanes exit INFEASIBLE in both packages; the others run as
    # without a bound
    B, n, m = 128, 10, 24
    d = generate_test_qp_batch(B, n, m, 0, 6, 1e2, rng=33,
                               dtype=np.float32)
    st = _as_settings({"iter_limit": 500}, jnp.float32)
    ldpd = jax.vmap(functools.partial(transform.build_ldp, ms=0, st=st))(
        *[jnp.asarray(d[k]) for k in KEYS])
    immut = ((ldpd.sense & IMMUTABLE) > 0).astype(jnp.float32)

    def both(fb):
        s = ps.slot_init(ldpd.M, ldpd.dupper, ldpd.dlower, ldpd.scaling,
                         immut, n_true=n, fbound_b=fb)
        sj = jax.tree_util.tree_map(
            np.asarray, ps.run_slot_round(s, st, n, steps=192,
                                          interpret=True))
        sp = convert.slot_state_to_numpy(pslot.run_slot_round(
            convert.slot_state_from_jax(s), convert.settings_from_jax(st),
            n, steps=192))
        return sj, sp

    free_j, free_p = both(None)
    opt = free_j.status[0] == dt.EXIT_OPTIMAL
    cut = opt & (np.arange(B) % 2 == 0)
    assert cut.sum() >= 60
    fb = np.where(cut, 0.5 * free_j.fval[0], dt.DAQP_INF).astype(np.float32)
    sj, sp = both(jnp.asarray(fb))
    assert (sj.status[0][cut] == dt.EXIT_INFEASIBLE).all()
    assert (sp['status'][0][cut] == dt.EXIT_INFEASIBLE).all()
    rest = ~cut
    assert (sp['status'][0][rest] == free_p['status'][0][rest]).all()
    assert (sj.status[0][rest] == free_j.status[0][rest]).all()
    assert np.array_equal(sp['u'][..., rest], free_p['u'][..., rest])
    # a cut lane stops at the step whose dual objective first passes the
    # bound, no later than its unbounded run's optimal exit
    assert (sp['iterations'][0][cut] <= free_p['iterations'][0][cut]).all()
    assert (sj.iterations[0][cut] <= free_j.iterations[0][cut]).all()

def _solve(d, st):
    args = [torch.as_tensor(d[k]) for k in KEYS]
    return dt.solve_batch_kernel(*args, st=st, ms=0, has_soft=False)


def _err(r, d):
    return np.linalg.norm(r.x.numpy() - d['x'], axis=1)


def _kkt_viol(r, d):
    return dt.kkt_residuals(d['H'], d['f'], d['A'], d['bupper'],
                            d['blower'], d['sense'], r.x, r.lam, ms=0)[1]


# The cases below mirror test_pallas_slot.py on the port (its CPU twins),
# with that file's gates: ||x - x_ref|| < 2e-3, KKT violation < 1e-4.

def test_port_dense_active_sets():
    # nact close to n: the rank cap and the pending-singular path
    d = generate_test_qp_batch(128, 8, 40, 0, 7, 1e2, rng=21,
                               dtype=np.float32)
    r = _solve(d, dt.as_settings({"iter_limit": 500}, torch.float32))
    assert (r.exitflag.numpy() == 1).all(), np.unique(r.exitflag.numpy())
    assert _err(r, d).max() < 2e-3
    assert _kkt_viol(r, d).max() < 1e-4


def test_port_warm_start_iterations():
    # sense-ACTIVE warm rows go through slot_activate's (B, K, K) Cholesky;
    # a correct warm set converges in ~1 iteration
    d = generate_test_qp_batch(128, 10, 24, 0, 6, 1e2, rng=33,
                               dtype=np.float32)
    st = dt.as_settings({"iter_limit": 400}, torch.float32)
    cold = _solve(d, st)
    assert (cold.exitflag.numpy() == 1).all()
    lam = cold.lam.numpy()
    sense = d['sense'].copy()
    sense[lam > 1e-6] |= dt.ACTIVE
    sense[lam < -1e-6] |= dt.ACTIVE | dt.LOWER
    warm = _solve(dict(d, sense=sense), st)
    assert (warm.exitflag.numpy() == 1).all()
    assert _err(warm, d).max() < 2e-3
    assert np.median(warm.iterations.numpy()) <= 2


def test_port_bland_pricing():
    # Bland's rule; in f32 its slow degenerate pivots may trip the cycle
    # guard on a marginal lane (test_pallas_slot.py measured 1/128)
    d = generate_test_qp_batch(128, 10, 24, 0, 6, 1e2, rng=71,
                               dtype=np.float32)
    r = _solve(d, dt.as_settings({"iter_limit": 500, "pricing": 1},
                                 torch.float32))
    ok = r.exitflag.numpy() == 1
    assert ok.mean() >= 0.97, np.unique(r.exitflag.numpy(),
                                        return_counts=True)
    assert _err(r, d)[ok].max() < 2e-3
    assert _kkt_viol(r, d)[ok].max() < 1e-4


def test_port_overcapacity_warm_start():
    # more sense-ACTIVE rows than slots: rows beyond capacity leave the
    # act masks, so the lane solves after re-pricing or fails loudly
    d = generate_test_qp_batch(128, 4, 16, 0, 3, 1e2, rng=83,
                               dtype=np.float32)
    sense = d['sense'].copy()
    sense[:, :10] |= dt.ACTIVE                # 10 > K = n + 1 = 5
    r = _solve(dict(d, sense=sense),
               dt.as_settings({"iter_limit": 400}, torch.float32))
    ok = r.exitflag.numpy() == 1
    assert (_err(r, d)[ok] < 2e-3).all()
    assert (_kkt_viol(r, d)[ok] < 1e-4).all()
