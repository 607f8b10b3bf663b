"""The port's scale-out (daqp_tpu_torch.parallel) at world size 1 in an
in-process gloo group: tests/test_sharded.py's five cases, each held
against the port's unsharded call and the JAX package's unsharded result
at that test's tolerances; the tree-sharded MIQP's per-rank worker for
the four ranks of D = 4 with no exchange; and branch and bound resumed
in waves against one closed solve."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import daqp_tpu
from daqp_tpu import batch as jbatch
from daqp_tpu.api import _as_settings
import daqp_tpu_torch as dt
from daqp_tpu_torch import batch as pbatch, bnb, core
from daqp_tpu_torch.parallel import (distribute_batch, global_mesh,
                                     initialize, make_mesh,
                                     solve_batch_miqp_sharded,
                                     solve_batch_sharded, solve_miqp_sharded,
                                     sharding)
from tests.gen import generate_test_qp_batch

KEYS = ('H', 'f', 'A', 'bupper', 'blower', 'sense')
F64 = dict(dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    store = tmp_path_factory.mktemp("gloo") / "store"
    initialize("gloo", init_method=f"file://{store}", world_size=1, rank=0)
    try:
        w = make_mesh(1, device="cpu")
        assert w == global_mesh("cpu")
        assert (w.rank, w.size, w.backend) == (0, 1, "gloo")
        yield w
    finally:
        dist.destroy_process_group()


def _jax_flat(d):
    """The JAX package's unsharded flat batch in f64."""
    r = jbatch.solve_batch_flat_jit(*(jnp.asarray(d[k]) for k in KEYS),
                                    _as_settings(None, jnp.float64), ms=0)
    return np.asarray(r.x), np.asarray(r.exitflag)


def _same(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_solve_batch_sharded(world):
    B = 16
    d = generate_test_qp_batch(B, 10, 30, 0, 6, 1e2, rng=31)
    args = distribute_batch(world, *(d[k] for k in KEYS))
    st = dt.as_settings(None, torch.float64)
    res, stats = solve_batch_sharded(*args, st, world, ms=0)
    assert stats.n_optimal == B
    assert np.linalg.norm(res.x.numpy() - d['x'], axis=1).max() < 1e-6
    one = pbatch.solve_batch_flat_jit(*args, st)
    _same(res, one)
    assert stats == (int(one.iterations.sum()), B,
                     int(one.iterations.max()))
    xj, fj = _jax_flat(d)
    assert (res.exitflag.numpy() == fj).all()
    assert np.linalg.norm(res.x.numpy() - xj, axis=1).max() < 1e-6


def test_solve_batch_sharded_fast_tiers(world):
    # every tier behind the split: the constructed optima, each other,
    # the unsharded calls and the JAX package's flat batch
    B = 16
    d = generate_test_qp_batch(B, 10, 30, 0, 6, 1e2, rng=77)
    args = [torch.as_tensor(d[k]) for k in KEYS]
    st = dt.as_settings(None, torch.float64)
    res_f, stats_f = solve_batch_sharded(*args, st, world, ms=0,
                                         tier="flat", lane_chunk=2)
    assert stats_f.n_optimal == B
    assert np.linalg.norm(res_f.x.numpy() - d['x'], axis=1).max() < 1e-6
    _same(res_f, pbatch.solve_batch_flat_jit(*args, st, lane_chunk=2))
    xj, fj = _jax_flat(d)
    assert (res_f.exitflag.numpy() == fj).all()
    assert np.linalg.norm(res_f.x.numpy() - xj, axis=1).max() < 1e-6

    res_n, _ = solve_batch_sharded(*args, st, world, ms=0, tier="naive")
    _same(res_n, pbatch.solve_batch_jit(*args, st))
    assert np.allclose(res_f.x.numpy(), res_n.x.numpy(), atol=1e-8)

    # the kernel stream computes in f32: the f32 gate
    res_p, stats_p = solve_batch_sharded(*args, st, world, ms=0,
                                         tier="pallas")
    assert stats_p.n_optimal == B
    assert np.linalg.norm(res_p.x.numpy() - d['x'], axis=1).max() < 2e-3
    _same(res_p, pbatch.solve_batch_kernel_stream(*args, st))
    assert np.linalg.norm(res_p.x.numpy() - xj, axis=1).max() < 2e-3
    with pytest.raises(ValueError, match="tier"):
        solve_batch_sharded(*args, st, world, tier="nope")


def _miqp_problem():
    rng = np.random.default_rng(37)
    n, m, ms, nb = 12, 30, 6, 4
    M = rng.standard_normal((n, n))
    H = M.T @ M + 0.5 * np.eye(n)
    A = rng.standard_normal((m - ms, n))
    bu = 20 * rng.random(m)
    bl = -20 * rng.random(m)
    f = 10 * rng.standard_normal(n)
    f[:nb] = -np.abs(f[:nb])
    bu[:nb] = 1.0
    bl[:nb] = 0.0
    sense = np.zeros(m, np.int32)
    sense[:nb] = dt.BINARY
    return (H, f, A, bu, bl, sense), ms, nb


@pytest.fixture(scope="module")
def miqp():
    """The MIQP of test_sharded.py's tree case with the JAX package's
    single solve and the port's."""
    prob, ms, nb = _miqp_problem()
    ref = daqp_tpu.quadprog(*prob, ms=ms)
    assert int(ref.exitflag) == dt.EXIT_OPTIMAL
    one = dt.quadprog(*prob, ms=ms, **F64)
    assert one.exitflag == dt.EXIT_OPTIMAL
    assert abs(float(one.fval) - float(ref.fval)) < 1e-6
    return prob, ms, nb, float(ref.fval), one


def test_solve_miqp_sharded_matches_single(world, miqp):
    prob, ms, nb, fval_jax, one = miqp
    st = dt.as_settings(None, torch.float64)
    x, fval, status, nodes = solve_miqp_sharded(*prob, ms, st, world,
                                                rounds=4, node_budget=8)
    assert status == dt.EXIT_OPTIMAL
    assert abs(float(fval) - fval_jax) < 1e-6, (float(fval), fval_jax)
    assert abs(float(fval) - float(one.fval)) < 1e-6
    # one rank holds the whole tree: the single solve's nodes
    assert nodes == one.nodes
    xb = x.numpy()[:nb]
    assert np.all((np.abs(xb - 1) < 1e-5) | (np.abs(xb) < 1e-5))


def test_tree_worker_ranks_without_exchange(miqp):
    # D = 4 subtrees, the exchange a no-op (it only prunes): the least
    # local incumbent is the MIQP's optimum, each rank's fval is its own
    # x's objective, and the subtrees fix the first two binaries to the
    # bits of the rank
    prob, ms, nb, fval_jax, _ = miqp
    H, f, A, bu, bl, sense = (torch.as_tensor(a) for a in prob)
    st = dt.as_settings(None, torch.float64)
    outs = [sharding._tree_worker(H, f, A, bu, bl, sense, ms, st, 4, 8,
                                  rank, 4, lambda b: b)
            for rank in range(4)]
    fvals = [float(o[1]) for o in outs]
    assert abs(min(fvals) - fval_jax) < 1e-6, (fvals, fval_jax)
    for rank, (x, fval, nodes) in enumerate(outs):
        assert nodes >= 1
        if float(fval) < dt.DAQP_INF:
            obj = 0.5 * float(x @ H @ x) + float(f @ x)
            assert abs(obj - float(fval)) < 1e-8
            assert [round(float(v)) for v in x[:2]] == \
                [1 - ((rank >> i) & 1) for i in range(2)]


@pytest.mark.parametrize("budget", [1, 3, 8])
def test_bnb_run_in_waves(miqp, budget):
    # branch and bound resumed every `budget` nodes gives the closed
    # solve's flag, x, fval and node count
    prob, ms, nb, _, _ = miqp
    H, f, A, bu, bl, sense = (torch.as_tensor(a) for a in prob)
    st = dt.as_settings(None, torch.float64)
    ldpd = core.build_ldp(H, f, A, bu, bl, sense, ms, st)
    bins = tuple(range(nb))
    K = H.shape[0] + 1
    s_one, flag_one, it_one, nodes_one = bnb.bnb_solve(ldpd, bins, st, K)
    c = bnb.bnb_init(ldpd, bins, st, K)
    waves = 0
    while c.stack and c.status == dt.EXIT_RUNNING:
        before = c.nodecount
        c = bnb.bnb_run(c, bins, st, node_budget=budget)
        assert c.nodecount - before <= budget
        waves += 1
    c = bnb.bnb_finalize(c, st)
    assert waves >= -(-nodes_one // budget)
    assert (c.status, c.nodecount, c.itercount) == \
        (flag_one, nodes_one, it_one)
    assert torch.equal(c.state.u, s_one.u)
    assert torch.equal(c.state.fval, s_one.fval)


def test_solve_batch_sharded_prox_tier(world):
    # semidefinite-H lanes through the batched proximal driver
    B, n, m, rank = 16, 8, 20, 5
    rng = np.random.default_rng(91)
    Q = rng.standard_normal((B, n, rank))
    H = np.einsum('bir,bjr->bij', Q, Q)
    f = rng.standard_normal((B, n))
    A = rng.standard_normal((B, m, n))
    bu = 5 + 5 * rng.random((B, m))
    bl = -(5 + 5 * rng.random((B, m)))
    sense = np.zeros((B, m), np.int32)
    args = [torch.as_tensor(a, dtype=torch.float32) for a in (H, f, A, bu,
                                                              bl)]
    args.append(torch.as_tensor(sense))
    st = dt.as_settings({"iter_limit": 1000}, torch.float32)
    res, stats = solve_batch_sharded(*args, st, world, ms=0, tier="prox")
    assert stats.n_optimal == B, res.exitflag
    _same(res, pbatch.solve_batch_prox_kernel(*args, st))
    xs = res.x.numpy().astype(np.float64)
    for b in range(0, B, 5):
        ref = daqp_tpu.quadprog(H[b], f[b], A[b], bu[b], bl[b], ms=0)
        # a rank-deficient H may have several minimizers: the objective
        # and feasibility, not the point
        fval = 0.5 * xs[b] @ H[b] @ xs[b] + f[b] @ xs[b]
        assert abs(fval - float(ref.fval)) \
            < 2e-3 * (1 + abs(float(ref.fval))), b
        v = A[b] @ xs[b]
        assert np.all(v <= bu[b] + 1e-3) and np.all(v >= bl[b] - 1e-3), b


def test_solve_batch_miqp_sharded(world):
    # independent MIQPs, node waves on each rank's lanes
    B, n, m, nb = 16, 6, 14, 3
    rng = np.random.default_rng(93)
    Q = rng.standard_normal((B, n, n))
    H = np.einsum('bij,bkj->bik', Q, Q) + 0.5 * np.eye(n)
    f = 8 * rng.standard_normal((B, n))
    A = rng.standard_normal((B, m, n))
    bu = 15 * rng.random((B, m))
    bl = -15 * rng.random((B, m))
    A[:, :nb] = 0.0
    A[:, np.arange(nb), np.arange(nb)] = 1.0
    bu[:, :nb] = 1.0
    bl[:, :nb] = 0.0
    sense = np.zeros((B, m), np.int32)
    sense[:, :nb] = dt.BINARY
    args = [torch.as_tensor(a, dtype=torch.float32) for a in (H, f, A, bu,
                                                              bl)]
    args.append(torch.as_tensor(sense))
    st = dt.as_settings({"iter_limit": 1000}, torch.float32)
    res, stats = solve_batch_miqp_sharded(*args, st, world, ms=0,
                                          bin_ids=tuple(range(nb)))
    one = pbatch.solve_batch_miqp_kernel(*args, st, bin_ids=tuple(range(nb)))
    _same(res, one)
    assert stats.n_optimal == int((one.exitflag == 1).sum())
    flags, fv = res.exitflag.numpy(), res.fval.numpy()
    for b in range(B):
        ref = daqp_tpu.quadprog(H[b], f[b], A[b], bu[b], bl[b], sense[b],
                                ms=0)
        assert int(flags[b]) == int(ref.exitflag), b
        if int(ref.exitflag) == 1:
            assert abs(fv[b] - float(ref.fval)) \
                < 1e-3 * (1 + abs(float(ref.fval))), b


def test_world_without_group_and_distribute_batch(monkeypatch):
    # a world of one without a group; distribute_batch splits by rank
    # and rejects a batch the ranks cannot share
    monkeypatch.setattr(sharding.dist, "is_initialized", lambda: False)
    w = make_mesh(device="cpu")
    assert (w.rank, w.size, w.backend) == (0, 1, None)
    with pytest.raises(ValueError, match="n_devices"):
        make_mesh(2, device="cpu")
    a = np.arange(12.0).reshape(6, 2)
    half = sharding.World(1, 2, "gloo", torch.device("cpu"))
    (blk,) = distribute_batch(half, a)
    assert torch.equal(blk, torch.as_tensor(a[3:]))
    with pytest.raises(ValueError, match="divisible"):
        distribute_batch(sharding.World(0, 4, "gloo", torch.device("cpu")),
                         a)
