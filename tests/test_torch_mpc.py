"""The port's warm MPC horizon (daqp_tpu_torch.mpc, kernel B3
``run_mpc_segment``) on its CPU twins, against the JAX package's Pallas
tier in interpret mode (``mpc.solve_mpc_scan_pallas`` / ``_fused``,
``ops/pallas_slot.py run_mpc_segment``) and the f64 single-instance
solver, at the sizes of test_mpc.py."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import daqp_tpu
from daqp_tpu import mpc as jmpc
from daqp_tpu import transform as jtransform
from daqp_tpu.api import _as_settings
from daqp_tpu.ops import pallas_slot as ps
from daqp_tpu.types import EXIT_RUNNING, IMMUTABLE
import daqp_tpu_torch as dt
from daqp_tpu_torch import convert
from daqp_tpu_torch.ops import slot as pslot
from tests.gen import generate_test_qp

S, T, N, M_ROWS = 128, 5, 10, 24
OVER = {"iter_limit": 400}


def _horizon():
    """test_mpc.py's scenario batch: S rollouts of a drifting horizon."""
    rng = np.random.default_rng(55)
    _, H, f, A, bu, bl, _ = generate_test_qp(N, M_ROWS, 0, 6, 1e2, rng)
    H, f, A, bu, bl = (v.astype(np.float32) for v in (H, f, A, bu, bl))
    drift_f = 0.03 * rng.standard_normal((S, T, N)).astype(np.float32)
    drift_b = 0.03 * rng.standard_normal((S, T, M_ROWS)).astype(np.float32)
    return (H, A, np.cumsum(drift_f, axis=1) + f,
            np.cumsum(np.abs(drift_b), axis=1) + bu,
            bl - np.cumsum(np.abs(drift_b), axis=1))


@functools.partial(jax.jit, static_argnames=("st",))
def _jax_warm_state(H, A, f_seq, bu_seq, bl_seq, st):
    """JAX's state after step 0 of the horizon (cold slot_solve and one
    Newton refresh, as solve_mpc_scan_pallas_fused's segment 0) and the
    lanes-last bounds of steps 1..2, (2, m, S)."""
    ldpd0 = jtransform.build_ldp(H, f_seq[0, 0], A, bu_seq[0, 0],
                                 bl_seq[0, 0], None, 0, st)
    v_st = jnp.einsum('ji,stj->sti', ldpd0.Rinv, f_seq)
    Mv = jnp.einsum('mj,stj->stm', ldpd0.M, v_st)
    du = bu_seq * ldpd0.scaling + Mv
    dl = bl_seq * ldpd0.scaling + Mv
    immut = jnp.broadcast_to(
        ((ldpd0.sense & IMMUTABLE) > 0).astype(jnp.float32), (S, M_ROWS))
    s = ps.slot_init(jnp.broadcast_to(ldpd0.M, (S, M_ROWS, N)), du[:, 0],
                     dl[:, 0], jnp.broadcast_to(ldpd0.scaling, (S, M_ROWS)),
                     immut, n_true=N)
    s = ps.slot_refresh_bounds(s, du[:, 0].T, dl[:, 0].T)
    s = s._replace(status=jnp.full_like(s.status, EXIT_RUNNING),
                   iterations=jnp.zeros_like(s.iterations),
                   cycle=jnp.zeros_like(s.cycle),
                   repaired=jnp.zeros_like(s.repaired),
                   best_fval=jnp.zeros_like(s.best_fval) - 1.0,
                   pend=jnp.zeros_like(s.pend))
    s = ps.newton_refresh(ps.slot_solve(s, st, n_true=N, interpret=True))
    return s, jnp.moveaxis(du[:, 1:3], 0, -1), jnp.moveaxis(dl[:, 1:3], 0, -1)


def test_segment_twin_matches_jax_kernel():
    H, A, f_seq, bu_seq, bl_seq = _horizon()
    st = _as_settings(OVER, jnp.float32)
    s, duq, dlq = _jax_warm_state(*map(jnp.asarray, (H, A, f_seq, bu_seq,
                                                     bl_seq)), st)
    sj, useq, fvseq, itseq, stseq, failed = jax.tree_util.tree_map(
        np.asarray, ps.run_mpc_segment(s, duq, dlq, st, N, steps=192,
                                       interpret=True))
    sp, *seqs = pslot.run_mpc_segment_plain(
        convert.slot_state_from_jax(s), convert.from_lanes_last(duq),
        convert.from_lanes_last(dlq), convert.settings_from_jax(st), N,
        steps=192)                         # JAX-padded state: n, K 16
    up, fvp, itp, stp, failp = (x.numpy() for x in seqs)
    spn = convert.slot_state_to_numpy(sp)
    # per-step flags, the final slot table and the failed flag agree lane
    # by lane (a lane may part at an f32 tie: one of 128 is allowed)
    agree = (stp == stseq.T).all(1) & (failp == failed) \
        & (spn['used'] == sj.used).all(0) & (spn['sid'] == sj.sid).all(0)
    assert agree.sum() >= 127, agree.sum()
    assert (itp == itseq.T)[agree].all()
    assert not failp.any()
    # the iterates, with test_torch_slot.py's gate
    for got, ref in ((up, np.moveaxis(useq, -1, 0)), (fvp, fvseq.T),
                     (np.moveaxis(spn['E'], -1, 0), np.moveaxis(sj.E, -1, 0))):
        gap = np.abs(got - ref)[agree].max()
        assert gap <= 5e-4 * (1.0 + np.abs(ref).max()), gap
    assert np.array_equal(sp.dupper.numpy(), np.asarray(duq[-1]).T)


def _check(out, jout, data, f64_ref):
    """Flags agree with JAX on >= 98% of (s, t); x within 2e-3 of JAX and
    of the f64 solver on the sampled (s, t); warm steps stay cheap."""
    H, A, f_seq, bu_seq, bl_seq = data
    flags = out.exitflag.numpy()
    assert out.x.shape == (S, T, N) and flags.shape == (S, T)
    assert (flags == np.asarray(jout.exitflag)).mean() >= 0.98
    assert (flags == 1).all(), np.unique(flags, return_counts=True)
    x = out.x.numpy()
    assert np.abs(x - np.asarray(jout.x)).max() < 2e-3
    assert out.iterations[:, 1:].float().mean() < 15
    for (s, t), ref in f64_ref.items():
        assert np.linalg.norm(x[s, t] - ref) < 2e-3, (s, t)


@pytest.fixture(scope="module")
def horizon():
    data = _horizon()
    H, A, f_seq, bu_seq, bl_seq = data
    ref = {}
    for s in range(0, S, 37):
        for t in range(T):
            r = daqp_tpu.quadprog(*(v.astype(np.float64) for v in (
                H, f_seq[s, t], A, bu_seq[s, t], bl_seq[s, t])), ms=0)
            assert int(r.exitflag) == 1
            ref[s, t] = np.asarray(r.x)
    return data, ref


@pytest.mark.parametrize("fused", [False, True])
def test_scan_matches_jax(horizon, fused):
    # seg = 2 over T = 5 takes the repeat-pad tail (Tp = 6)
    data, ref = horizon
    st = _as_settings(OVER, jnp.float32)
    jargs = [jnp.asarray(v) for v in data]
    if fused:
        jout = jmpc.solve_mpc_scan_pallas_fused(*jargs, st, ms=0, seg=2,
                                                interpret=True)
        out = dt.solve_mpc_scan_kernel_fused(
            *data, dt.as_settings(OVER, torch.float32), seg=2, device="cpu")
    else:
        jout = jmpc.solve_mpc_scan_pallas(*jargs, st, ms=0, interpret=True)
        out = dt.solve_mpc_scan_kernel(
            *data, dt.as_settings(OVER, torch.float32), device="cpu")
    _check(out, jout, data, ref)


def test_failed_segment_takes_batch_redo(monkeypatch):
    # steps = 2 is too few for some warm steps: lanes freeze inside B3's
    # twin, and each later segment is redone on the per-step path, which
    # then equals the per-step driver at the same steps
    data = _horizon()
    st = dt.as_settings(OVER, torch.float32)
    failed = []
    run = pslot.run_mpc_segment

    def spy(*args, **kw):
        out = run(*args, **kw)
        failed.append(int((out[-1] > 0).sum()))
        return out

    monkeypatch.setattr(pslot, "run_mpc_segment", spy)
    fused = dt.solve_mpc_scan_kernel_fused(*data, st, seg=2, steps=2,
                                           device="cpu")
    step = dt.solve_mpc_scan_kernel(*data, st, steps=2, device="cpu")
    assert len(failed) == 2 and min(failed) > 0, failed
    assert torch.equal(fused.exitflag, step.exitflag)
    assert torch.equal(fused.iterations, step.iterations)
    assert (fused.exitflag == 1).all()
    # the fused driver Newton-refreshes E between segments, the per-step
    # driver does not: f32 rounding apart, the iterates are the same
    assert (fused.x - step.x).abs().max() < 1e-5


def test_flat_scan_matches_jax():
    # solve_mpc_scan on the flat tier, test_mpc.py:24's drifting horizon
    # in f64: the JAX package's flags and iterations per step, x within
    # 1e-8; the warm steps cost 1-3 iterations
    from daqp_tpu_torch import mpc as pmpc
    rng = np.random.default_rng(307)
    _, H, f, A, bu, bl, _ = generate_test_qp(12, 40, 0, 8, 1e2, rng)
    T_h = 20
    drift = 0.002 * np.arange(T_h)[:, None]
    seq = (f[None, :] * (1.0 + drift[:, :1]),
           np.repeat(bu[None, :], T_h, axis=0) + drift,
           np.repeat(bl[None, :], T_h, axis=0) - drift)
    st = _as_settings(None, jnp.float64)
    oj = jmpc.solve_mpc_scan(jnp.asarray(H), jnp.asarray(A),
                             *(jnp.asarray(v) for v in seq), st, ms=0)
    op = pmpc.solve_mpc_scan(torch.as_tensor(H), torch.as_tensor(A),
                             *(torch.as_tensor(v) for v in seq),
                             convert.settings_from_jax(st), ms=0)
    np.testing.assert_array_equal(op.exitflag.numpy(),
                                  np.asarray(oj.exitflag))
    np.testing.assert_array_equal(op.iterations.numpy(),
                                  np.asarray(oj.iterations))
    assert np.abs(op.x.numpy() - np.asarray(oj.x)).max() <= 1e-8
    assert (op.exitflag == 1).all()
    assert np.median(op.iterations.numpy()[1:]) <= 3
    # scenarios as one batch: each scenario's horizon as alone
    two = pmpc.solve_mpc_scan(torch.as_tensor(H), torch.as_tensor(A),
                              *(torch.as_tensor(np.stack([v, v]))
                                for v in seq),
                              convert.settings_from_jax(st), ms=0)
    assert two.x.shape == (2, T_h, 12)
    assert (two.x[1] - op.x).abs().max().item() <= 1e-12
