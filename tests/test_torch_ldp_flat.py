"""The port's flat tier step by step (daqp_tpu_torch.ldp_flat) against the
JAX package's ``ldp_flat`` vmapped over the same lanes, on the CPU in
f64: ``flat_init`` / ``flat_activate`` from the port's own transform, k
steps of ``flat_step``, ``flat_refresh`` and ``flat_polish``, each fed
the JAX state of the stage before it so that each is held alone.

The batch (B = 8, n = 12, m = 40, 8 active rows) has SOFT rows 2-4 (the
rho_soft Gram diagonal, K = n + 3 + 1), an equality on row 0 of the even
lanes and on lanes 0 and 2 row 1 a copy of it, on lane 0 consistent (a
dependent equality, dropped with its ACTIVE bit cleared) and on lane 2
moved off (inconsistent: EXIT_OVERDETERMINED_INITIAL).  ``used``,
``sid``, ``lam`` and ``u`` within 1e-9, E on the used slots within 1e-8
of max(1, the lane's largest |E|), the integer state equal.  The even
lanes exit CYCLE within 60 steps on a Gram of condition up to 1.7e8
(the soft rows' 1e-6 diagonal), so the refresh's exact refactorization
runs there and E reaches 2.6e7: f64 rounding times the condition leaves
4e-9 of it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daqp_tpu import ldp_flat as jflat, transform as jtransform
from daqp_tpu.api import _as_settings
from daqp_tpu_torch import convert, ldp_flat, transform
from tests.gen import generate_test_qp_batch

B, N, M, N_ACT = 8, 12, 40, 8
SOFT_ROWS = (2, 3, 4)
K = N + len(SOFT_ROWS) + 1
K_STEPS = 6            # steps of the step case: lanes still mid-solve
LONG_STEPS = 60        # steps before the refresh / polish cases
ST = _as_settings(None, jnp.float64)
PST = convert.settings_from_jax(ST)
KEYS = ('H', 'f', 'A', 'bupper', 'blower', 'sense')


def _data():
    d = generate_test_qp_batch(B, N, M, 0, N_ACT, 1e2, rng=71)
    d['bupper'][0::2, 0] = d['blower'][0::2, 0] = 0.5
    d['A'][[0, 2], 1] = d['A'][[0, 2], 0]
    d['bupper'][[0, 2], 1] = d['blower'][[0, 2], 1] = [0.5, 0.9]
    d['sense'][:, list(SOFT_ROWS)] = 8
    return d


@pytest.fixture(scope="module")
def jax_stages():
    """One jitted JAX call: the activated state, k steps from it, the
    refresh after LONG_STEPS, and the polish after that refresh."""
    d = _data()

    def lane(H, f, A, bu, bl, sense):
        ldpd = jtransform.build_ldp(H, f, A, bu, bl, sense, 0, ST)
        s = jflat.flat_init(ldpd.M, ldpd.dupper, ldpd.dlower, ldpd.sense,
                            ldpd.scaling, K=K)
        s_act = jflat.flat_activate(s, ST)

        def steps(k, s):
            return jax.lax.fori_loop(0, k, lambda i, q: jflat.flat_step(q, ST),
                                     s)

        s_k = steps(K_STEPS, s_act)
        s_long = steps(LONG_STEPS, s_act)
        s_ref = jflat.flat_refresh(s_long, ST)
        s_pol = jflat.flat_polish(s_ref, ST)
        return s_act, s_k, s_long, s_ref, s_pol

    out = jax.jit(jax.vmap(lane))(*[jnp.asarray(d[k]) for k in KEYS])
    return d, [convert.flat_state_from_jax(s) for s in out]


def _assert_same(sp, sj):
    for name in ("used", "sid", "sense", "status", "iterations", "pend",
                 "repaired", "cycle"):
        a, b = getattr(sp, name), getattr(sj, name)
        if name == "sid":       # a free slot's id is stale on both sides
            a, b = torch.where(sj.used, a, 0), torch.where(sj.used, b, 0)
        assert torch.equal(a.to(b.dtype), b), name
    for name in ("lam", "u", "lam_star", "fval"):
        err = (getattr(sp, name) - getattr(sj, name)).abs().max().item()
        assert err <= 1e-9, (name, err)
    um = sj.used[:, :, None] & sj.used[:, None, :]
    scale = torch.clamp(sj.E.abs().amax((1, 2)), min=1.0)
    err = torch.where(um, sp.E - sj.E, 0.0).abs().amax((1, 2)) / scale
    assert err.max().item() <= 1e-8, err


def test_init_activate_matches_jax(jax_stages):
    d, (s_act, *_) = jax_stages
    args = [torch.as_tensor(d[k]) for k in KEYS]
    ldpd = transform.build_ldp(*args[1:], 0, PST, H=args[0])
    s = ldp_flat.flat_init(ldpd.M, ldpd.dupper, ldpd.dlower, ldpd.sense,
                           ldpd.scaling, K=K)
    sp = ldp_flat.flat_activate(s, PST)
    _assert_same(sp, s_act)
    # the equality of the even lanes is in; lanes 0 and 2 drop their copy
    # (ACTIVE cleared), lane 2 as overdetermined
    assert sp.used[0::2].any(1).all()
    assert int(sp.status[2]) == -6 and (sp.status[[0, 1, 3]] == 99).all()
    assert ((sp.sense[[0, 2], 1] & 1) == 0).all()


def test_steps_match_jax(jax_stages):
    _, (s_act, s_k, *_) = jax_stages
    sp = s_act
    for _ in range(K_STEPS):
        sp = ldp_flat.flat_step(sp, PST)
    _assert_same(sp, s_k)
    assert (sp.iterations[sp.status == 99] == K_STEPS).all()


def test_refresh_and_polish_match_jax(jax_stages):
    _, (_, _, s_long, s_ref, s_pol) = jax_stages
    # the stages the refresh and polish act on: optimal lanes and lanes
    # still running
    assert ((s_long.status == 1) | (s_long.status == 2)).any()
    _assert_same(ldp_flat.flat_refresh(s_long, PST), s_ref)
    _assert_same(ldp_flat.flat_polish(s_ref, PST), s_pol)


def test_extract_duals_scatter():
    # the slots' duals land on their rows, rescaled; free slots drop out
    s = ldp_flat.flat_init(torch.zeros(1, 4, 2), torch.zeros(1, 4),
                           torch.zeros(1, 4), K=3)
    s = s._replace(used=torch.tensor([[True, False, True]]),
                   sid=torch.tensor([[3, 0, 1]]),
                   lam_star=torch.tensor([[2.0, 7.0, -1.0]]),
                   scaling=torch.tensor([[1.0, 3.0, 1.0, 0.5]]))
    assert ldp_flat.flat_extract_duals(s).tolist() == [[0.0, -3.0, 0.0, 1.0]]
