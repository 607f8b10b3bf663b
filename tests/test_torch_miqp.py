"""The port's batched MIQP in node waves (daqp_tpu_torch.batch.
solve_batch_miqp_kernel, BASELINE config 5's path) on its CPU twins
(K1's and K2's plain versions), against the JAX package's single-lane
branch and bound (``daqp_tpu.quadprog`` in f64) lane by lane: the same
exit flag, fval within 1e-3 (1 + |fval|) (test_batch_miqp.py's gate for
the f32 wave tier), and the cases of test_batch_miqp.py: infeasible
lanes, the subopt folding, lanes without BINARY bits, more binaries than
one 31-bit word of the JAX tier, the wave cap and an expired
deadline."""
import numpy as np
import pytest
import torch

import daqp_tpu
import daqp_tpu_torch as dt
from daqp_tpu_torch import batch as pbatch

ST = dt.as_settings({"iter_limit": 1000}, torch.float32)


def _miqps(B, n, m, nb, seed):
    """test_batch_miqp.py's wave instances: binaries on identity rows."""
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((B, n, n)).astype(np.float32)
    H = np.einsum('bij,bkj->bik', Q, Q) + 0.5 * np.eye(n, dtype=np.float32)
    f = (8 * rng.standard_normal((B, n))).astype(np.float32)
    A = rng.standard_normal((B, m, n)).astype(np.float32)
    bu = (15 * rng.random((B, m))).astype(np.float32)
    bl = (-15 * rng.random((B, m))).astype(np.float32)
    A[:, :nb] = 0.0
    A[:, np.arange(nb), np.arange(nb)] = 1.0
    bu[:, :nb] = 1.0
    bl[:, :nb] = 0.0
    sense = np.zeros((B, m), np.int32)
    sense[:, :nb] = dt.BINARY
    return [H, f, A, bu, bl, sense]


def _solve(args, st=ST, **kw):
    return pbatch.solve_batch_miqp_kernel(*args, st=st, device="cpu", **kw)


def _single(args, b, settings=None):
    H, f, A, bu, bl, sense = (a[b] for a in args)
    return daqp_tpu.quadprog(*(x.astype(np.float64) for x in
                               (H, f, A, bu, bl)), sense, ms=0,
                             settings=settings)


def _gate(res, args, lanes, settings=None):
    flags, fv = res.exitflag.numpy(), res.fval.numpy()
    for b in lanes:
        ref = _single(args, b, settings)
        assert int(flags[b]) == int(ref.exitflag), (b, flags[b],
                                                    int(ref.exitflag))
        if int(ref.exitflag) == dt.EXIT_OPTIMAL:
            fr = float(ref.fval)
            assert abs(fv[b] - fr) <= 1e-3 * (1 + abs(fr)), (b, fv[b], fr)


@pytest.mark.parametrize("shape", [(8, 20, 3), (10, 24, 4)])
def test_waves_match_single_lane_bnb(shape):
    n, m, nb = shape
    args = _miqps(16, n, m, nb, seed=31 + n)
    res = _solve(args)
    assert res.x.shape == (16, n) and res.lam.shape == (16, m)
    assert (res.iterations.numpy() >= 1).all()     # nodes per lane
    _gate(res, args, range(16))


def test_infeasible_lanes():
    # odd lanes ask 0.3 <= x1 + x2 <= 0.4 of two binaries: no point
    B, n = 16, 2
    H = np.tile(np.eye(n, dtype=np.float32), (B, 1, 1))
    f = np.zeros((B, n), np.float32)
    A = np.tile(np.array([[1., 0], [0, 1], [1, 1]], np.float32), (B, 1, 1))
    bu = np.tile(np.array([1., 1., 0.4], np.float32), (B, 1))
    bl = np.tile(np.array([0., 0., 0.3], np.float32), (B, 1))
    bu[::2, 2], bl[::2, 2] = 2.5, 1.5
    sense = np.zeros((B, 3), np.int32)
    sense[:, :2] = dt.BINARY
    args = [H, f, A, bu, bl, sense]
    flags = _solve(args, dt.as_settings({"iter_limit": 400},
                                        torch.float32)).exitflag.numpy()
    assert (flags[::2] == 1).all() and (flags[1::2] == -1).all(), flags


def test_subopt_folding():
    # a loose rel_subopt returns an incumbent within the tolerance of the
    # exact optimum, as the single-lane tree under the same settings, and
    # explores no more nodes than the exact run
    args = _miqps(16, 10, 24, 4, seed=77)
    st = dt.as_settings({"iter_limit": 1000, "rel_subopt": 0.3},
                        torch.float32)
    res, exact = _solve(args, st), _solve(args)
    _gate(res, args, range(0, 16, 3), settings={"rel_subopt": 0.3})
    fv, f0 = res.fval.numpy(), exact.fval.numpy()
    ok = exact.exitflag.numpy() == 1
    assert (fv[ok] >= f0[ok] - 1e-3 * (1 + np.abs(f0[ok]))).all()
    assert (fv[ok] <= f0[ok] + 0.3 * np.abs(f0[ok]) + 1e-2).all()
    assert res.iterations.numpy().sum() <= exact.iterations.numpy().sum()


def test_lanes_without_binary_bits():
    # lanes 0-7 carry no BINARY bit on the shared rows: one node, the
    # plain QP's answer
    args = _miqps(16, 8, 20, 3, seed=5)
    args[5][:8] = 0
    res = _solve(args, bin_ids=(0, 1, 2))
    assert (res.iterations.numpy()[:8] == 1).all()
    _gate(res, args, range(16))


def test_more_binaries_than_one_word():
    # nb = 40 binaries (the JAX tier packs 31 to an int32 word); the
    # objective is separable with H = I, so the optimum is known:
    # min over {0, 1} of 0.5 x^2 + f x per coordinate
    B, nb, mg = 4, 40, 6
    n, m = nb, nb + mg
    rng = np.random.default_rng(61)
    H = np.tile(np.eye(n, dtype=np.float32), (B, 1, 1))
    f = np.full((B, n), -3.0, np.float32)
    f[:, [0, 15, 31, 32, 39]] = -0.5               # mid-interval: branch
    A = np.tile(np.vstack([np.eye(n), rng.standard_normal((mg, n))])
                .astype(np.float32), (B, 1, 1))
    bu = np.tile(np.concatenate([np.ones(nb), 50 * np.ones(mg)])
                 .astype(np.float32), (B, 1))
    bl = np.tile(np.concatenate([np.zeros(nb), -50 * np.ones(mg)])
                 .astype(np.float32), (B, 1))
    sense = np.zeros((B, m), np.int32)
    sense[:, :nb] = dt.BINARY
    res = _solve([H, f, A, bu, bl, sense],
                 dt.as_settings({"iter_limit": 2000}, torch.float32),
                 max_waves=64)
    assert (res.exitflag.numpy() == 1).all()
    xb = res.x.numpy()[:, :nb]
    assert (np.minimum(np.abs(xb), np.abs(xb - 1.0)) < 1e-4).all()
    best = np.minimum(0.0, 0.5 + f).sum(1)
    assert np.allclose(res.fval.numpy(), best, atol=1e-4)


def test_wave_cap_and_deadline():
    args = _miqps(16, 10, 24, 4, seed=31)
    full = _solve(args)
    many = full.iterations.numpy() > 2
    assert many.any()
    # two waves: a lane whose tree is not exhausted exits ITERLIMIT
    capped = _solve(args, max_waves=2)
    assert pbatch.miqp_waves == 2
    flags = capped.exitflag.numpy()
    assert (flags[many] == dt.EXIT_ITERLIMIT).all(), flags
    assert (flags[~many] == full.exitflag.numpy()[~many]).all()
    # an expired deadline: every lane's first relaxation exits TIMELIMIT
    late = _solve(args, deadline=1.0)
    assert (late.exitflag.numpy() == dt.EXIT_TIMELIMIT).all()


def test_miqp_jit_matches_jax():
    # solve_batch_miqp_jit (the single-instance branch and bound on each
    # instance) on test_batch_miqp.py:26's case in f64: the JAX package's
    # flags, nodes and iterations, fval within 1e-8.  JAX's side is the
    # lane body its solve_batch_miqp_jit vmaps (bnb.bnb_core), jitted once
    # and run lane by lane: the vmap changes no lane's arithmetic and
    # takes 19 s more to trace on this CPU.
    import jax
    import jax.numpy as jnp
    from daqp_tpu import bnb as jbnb
    from daqp_tpu.api import _as_settings
    from daqp_tpu_torch import convert
    rng = np.random.default_rng(41)
    B, n, m, ms, nb = 6, 8, 20, 4, 3
    H, f, A, bu, bl = [], [], [], [], []
    for _ in range(B):
        Q = rng.standard_normal((n, n))
        H.append(Q.T @ Q + 0.5 * np.eye(n))
        A.append(rng.standard_normal((m - ms, n)))
        u, lo = 15 * rng.random(m), -15 * rng.random(m)
        g = 5 * rng.standard_normal(n)
        g[:nb] = -np.abs(g[:nb])
        u[:nb], lo[:nb] = 1.0, 0.0
        f.append(g)
        bu.append(u)
        bl.append(lo)
    sense = np.zeros((B, m), np.int32)
    sense[:, :nb] = dt.BINARY
    args = [np.asarray(v) for v in (H, f, A, bu, bl)] + [sense]
    st = _as_settings(None, jnp.float64)
    lane = jax.jit(lambda *a: jbnb.bnb_core(*a, ms, st,
                                            bin_ids=tuple(range(nb))))
    rj = jbnb.BnBOut(*(np.stack(v) for v in zip(*(
        lane(*[jnp.asarray(a[b]) for a in args]) for b in range(B)))))
    rp = pbatch.solve_batch_miqp_jit(*[torch.as_tensor(a) for a in args],
                                     convert.settings_from_jax(st), ms=ms,
                                     bin_ids=tuple(range(nb)))
    for name in ("exitflag", "nodes", "iterations"):
        np.testing.assert_array_equal(getattr(rp, name).numpy(),
                                      np.asarray(getattr(rj, name)), name)
    assert (rp.exitflag == 1).all()
    assert np.abs(rp.fval.numpy() - np.asarray(rj.fval)).max() <= 1e-8
    assert np.abs(rp.x.numpy() - np.asarray(rj.x)).max() <= 1e-8
