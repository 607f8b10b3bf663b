"""The port's ldp.py steps against the JAX package's from one state.

A JAX ``LDPState`` stopped mid-solve is converted
(``convert.ldp_state_from_jax``), and each step (add, remove, a singular
add and the re-add after it, the blocking search, pricing, refinement,
refactorization, activation with a dependent equality, and the
SOFT_WEIGHTS slack state) runs on both; every field of the two results
agrees (``convert.ldp_state_to_numpy``), in f64 on the CPU."""
import numpy as np
import pytest

import daqp_tpu
from daqp_tpu import ldp as jldp, transform as jtransform
import daqp_tpu_torch as dt
from daqp_tpu_torch import convert, ldp as pldp
from daqp_tpu_torch.types import SLACK_FIXED
from tests.gen import generate_test_qp
from tests.test_torch_single import _agree, _both, _sw_problem


def _same_state(js, ps):
    a, b = convert.ldp_state_to_numpy(js), convert.ldp_state_to_numpy(ps)
    for name, va in a.items():
        vb = b[name]
        if name == "sw":
            assert (va is None) == (vb is None)
            continue
        if va.dtype.kind in "biu":
            assert np.array_equal(va, vb), name
        else:
            assert np.allclose(va, vb, rtol=1e-10, atol=1e-12), \
                (name, np.abs(va - vb).max())


def _mid_state(seed, iters, sense_fn=None):
    """A JAX state stopped after ``iters`` iterations of a generated QP,
    and its port copy."""
    rng = np.random.default_rng(seed)
    x, H, f, A, bu, bl, sense = generate_test_qp(8, 20, 0, 6, 1e2, rng)
    if sense_fn is not None:
        sense = sense_fn(sense)
    st = daqp_tpu.Settings(iter_limit=iters)
    ldpd = jtransform.build_ldp(H, f, A, bu, bl, sense, 0, st)
    K = 8 + int(np.sum(np.asarray(ldpd.sense) & dt.SOFT > 0)) + 1
    js = jldp.init_state(ldpd.M, ldpd.dupper, ldpd.dlower, ldpd.sense,
                         ldpd.scaling, K=K)
    _, js = jldp.activate_constraints(js, st)
    js = jldp.ldp_solve(js, st)
    return js, convert.ldp_state_from_jax(js), dt.Settings()


def test_ldp_add_remove_steps_match_jax():
    js, ps, st = _mid_state(5, 4)
    assert int(js.n_active) >= 2
    _same_state(js, ps)
    act = set(np.asarray(js.WS)[:int(js.n_active)].tolist())
    idx = next(i for i in range(20) if i not in act)
    ja = jldp.add_constraint(js, np.int32(idx), 1.0, st)
    pa = pldp.add_constraint(ps, idx, 1.0, st)
    _same_state(ja, pa)
    for pos in (0, int(ja.n_active) - 1):
        _same_state(jldp.remove_constraint(ja, np.int32(pos), st),
                    pldp.remove_constraint(pa, pos, st))
    # the iteration primitives on the same state
    jc, pc = jldp.compute_csp(ja), pldp.compute_csp(pa)
    _same_state(jc, pc)
    jf, pf = jldp.remove_blocking(jc, st), pldp.remove_blocking(pc, st)
    assert bool(jf[0]) == pf[0]
    _same_state(jf[1], pf[1])
    jp = jldp.compute_primal_and_fval(jc, st)
    pp = pldp.compute_primal_and_fval(pc, st)
    _same_state(jp, pp)
    _same_state(jldp.refine_active(jldp.newton_refresh_E(jp, st), st),
                pldp.refine_active(pldp.newton_refresh_E(pp, st), st))
    ja2, pa2 = jldp.add_infeasible(jp, st), pldp.add_infeasible(pp, st)
    assert bool(ja2[0]) == pa2[0]
    _same_state(ja2[1], pa2[1])
    _same_state(jldp.refactor(ja, st), pldp.refactor(pa, st))


def test_ldp_singular_add_and_readd_match_jax():
    # an active row added a second time has a zero Schur complement: it
    # enters flagged singular; removing a position before it re-adds it
    js, ps, st = _mid_state(7, 5)
    k = int(js.n_active)
    assert k >= 2
    idx = int(np.asarray(js.WS)[0])
    ja = jldp.add_constraint(js, np.int32(idx), -1.0, st)
    pa = pldp.add_constraint(ps, idx, -1.0, st)
    assert bool(ja.sing) and pa.sing
    _same_state(ja, pa)
    _same_state(jldp.remove_constraint(ja, np.int32(1), st),
                pldp.remove_constraint(pa, 1, st))
    _same_state(jldp.remove_constraint(ja, np.int32(k), st),
                pldp.remove_constraint(pa, k, st))
    jb, pb = jldp.remove_blocking(ja, st), pldp.remove_blocking(pa, st)
    assert bool(jb[0]) == pb[0]
    _same_state(jb[1], pb[1])


@pytest.mark.parametrize("consistent", [True, False])
def test_activation_with_dependent_equality_matches_jax(consistent):
    # rows 0 and 1 are equalities, row 2 = row 0 + row 1 an equality too:
    # consistent, it is dropped; inconsistent, the flag is -6
    rng = np.random.default_rng(13)
    n, m = 5, 9
    A = rng.standard_normal((m, n))
    A[2] = A[0] + A[1]
    x0 = rng.standard_normal(n)
    b = A @ x0
    bu, bl = b + 1.0, b - 1.0
    bu[:3] = bl[:3] = b[:3]
    if not consistent:
        bu[2] = bl[2] = b[2] + 0.5
    H = np.eye(n)
    f = rng.standard_normal(n)
    st = daqp_tpu.Settings()
    ldpd = jtransform.build_ldp(H, f, A, bu, bl, None, 0, st)
    js = jldp.init_state(ldpd.M, ldpd.dupper, ldpd.dlower, ldpd.sense,
                         ldpd.scaling, K=n + 1)
    ps = convert.ldp_state_from_jax(js)
    jf, js2 = jldp.activate_constraints(js, st)
    pf, ps2 = pldp.activate_constraints(ps, dt.Settings())
    assert int(jf) == pf == (1 if consistent else
                             dt.EXIT_OVERDETERMINED_INITIAL)
    _same_state(js2, ps2)
    _agree(*_both(H, f, A, bu, bl))


def test_ldp_soft_weights_steps_match_jax():
    # the SOFT_WEIGHTS slack state through a converted state: the adds
    # of a cold solve's first iterations and a blocking step
    from daqp_tpu import prox as jprox
    from daqp_tpu.types import SoftWeights as JSW
    import jax.numpy as jnp
    rng = np.random.default_rng(21)
    H, f, A, bu, bl, sense, rows, sw = _sw_problem(rng)
    st = daqp_tpu.Settings(iter_limit=3)
    out = jprox.solve_convex_or_prox(
        jnp.asarray(H), jnp.asarray(f), jnp.asarray(A), jnp.asarray(bu),
        jnp.asarray(bl), jnp.asarray(sense), 0, st, K=6 + 4 + 1,
        soft_weights=JSW(*(jnp.asarray(sw[k]) for k in
                           ('d_ls', 'd_us', 'rho_ls', 'rho_us'))))
    js = out.state
    ps = convert.ldp_state_from_jax(js)
    assert ps.sw is not None
    _same_state(js, ps)
    st = dt.Settings()
    jc, pc = jldp.compute_csp(js), pldp.compute_csp(ps)
    _same_state(jc, pc)
    jb, pb = jldp.remove_blocking(jc, st), pldp.remove_blocking(pc, st)
    assert bool(jb[0]) == pb[0]
    _same_state(jb[1], pb[1])
    jp = jldp.compute_primal_and_fval(jc, st)
    pp = pldp.compute_primal_and_fval(pc, st)
    ja, pa = jldp.add_infeasible(jp, st), pldp.add_infeasible(pp, st)
    assert bool(ja[0]) == pa[0]
    _same_state(ja[1], pa[1])
    bits = np.asarray(ja[1].sense)
    assert ((bits & SLACK_FIXED) == (pa[1].sense.numpy() & SLACK_FIXED)).all()


def test_transform_single_lane_functions_match_jax():
    # check_unconstrained, update_sense, update_d_from_v,
    # get_proximal_regularization and the plain soft_weights rescaling of
    # build_ldp, batched in the port, on one lane against JAX
    from daqp_tpu_torch import core, transform as ptransform
    import torch
    rng = np.random.default_rng(19)
    x, H, f, A, bu, bl, sense = generate_test_qp(6, 14, 2, 4, 1e1, rng)
    st = daqp_tpu.Settings()
    w = 1e-6 * (1.0 + rng.random(14))
    sense_s = sense | dt.SOFT * (np.arange(14) % 3 == 0)
    jl = jtransform.build_ldp(H, f, A, bu, bl, sense_s, 2, st,
                              soft_weights=w)
    t = torch.as_tensor
    pl = core.build_ldp(t(H), t(f), t(A), t(bu), t(bl), t(sense_s), 2,
                        dt.Settings(), soft_weights=t(w))
    for name in ("M", "dupper", "dlower", "scaling", "sense", "v"):
        assert np.allclose(np.asarray(getattr(jl, name)),
                           getattr(pl, name).numpy(), rtol=1e-12,
                           atol=1e-14), name
    ok_j, x_j = jtransform.check_unconstrained(jl, st)
    ok_p, x_p = core.check_unconstrained(pl, dt.Settings())
    assert bool(ok_j) == bool(ok_p)
    assert np.allclose(np.asarray(x_j), x_p.numpy(), rtol=1e-12)
    sense2 = sense.copy()
    sense2[[1, 5]] |= dt.SOFT
    bu2 = bu.copy()
    bu2[3] = bl[3]
    js = jtransform.update_sense(jl, sense2, bu2, bl, st)
    ps = ptransform.update_sense(core.batched(pl), t(sense2)[None],
                                 t(bu2)[None], t(bl)[None], dt.Settings())
    assert (np.asarray(js.sense) == ps.sense[0].numpy()).all()
    assert int(js.error) == int(ps.error[0])
    v = rng.standard_normal(6)
    jd = jtransform.update_d_from_v(jl, v, bu, bl)
    pd = ptransform.update_d_from_v(core.batched(pl), t(v)[None],
                                    t(bu)[None], t(bl)[None])
    assert np.allclose(np.asarray(jd.dupper), pd.dupper[0].numpy(),
                       rtol=1e-12, atol=1e-14)
    # a dense singular H: the shift tracked and the one recovered
    Q = rng.standard_normal((6, 3))
    Hs = Q @ Q.T
    jl = jtransform.build_ldp(Hs, f, A, bu, bl, None, 2, st)
    pl = core.build_ldp(t(Hs), t(f), t(A), t(bu), t(bl),
                        torch.zeros(14, dtype=torch.int32), 2, dt.Settings())
    eps_j = float(jtransform.get_proximal_regularization(jl, H=Hs, st=st))
    eps_p = float(ptransform.get_proximal_regularization(
        core.batched(pl), H=t(Hs)[None], st=dt.Settings())[0])
    assert eps_j > 0 and abs(eps_p - eps_j) <= 1e-9 * eps_j
    assert abs(float(ptransform.get_proximal_regularization(
        core.batched(pl))[0]) - float(jl.eps_used)) <= 1e-12


def test_quadprog_core_matches_jax():
    # the one-shot core below the API, on two config-1 instances
    from daqp_tpu import core as jcore
    from daqp_tpu_torch import core as pcore
    import jax.numpy as jnp
    import torch
    rng = np.random.default_rng(2025)
    for _ in range(2):
        x, H, f, A, bu, bl, sense = generate_test_qp(10, 30, 10, 8, 1e2, rng)
        oj = jcore.quadprog_core(*map(jnp.asarray, (H, f, A, bu, bl, sense)),
                                 10, daqp_tpu.Settings())
        op = pcore.quadprog_core(*map(torch.as_tensor,
                                      (H, f, A, bu, bl, sense)),
                                 10, dt.Settings())
        assert op.exitflag == int(oj.exitflag) == 1
        assert op.iterations == int(oj.iterations)
        assert np.abs(op.x.numpy() - np.asarray(oj.x)).max() < 1e-10
        assert np.abs(op.lam.numpy() - np.asarray(oj.lam)).max() < 1e-10
        _same_state(oj.state, op.state)
