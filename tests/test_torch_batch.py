"""The port's slice (daqp_tpu_torch.batch) end to end on its CPU twins,
against the JAX package's kernel path (Pallas interpret mode) and the
constructed optimum."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from daqp_tpu import batch as batch_mod
from daqp_tpu.api import _as_settings
from daqp_tpu.ops import chol
import daqp_tpu_torch as dt
from tests.gen import generate_test_qp_batch

KEYS = ('H', 'f', 'A', 'bupper', 'blower', 'sense')


def _batch(B, seed):
    return generate_test_qp_batch(B, 12, 30, 0, 8, 1e2, rng=seed,
                                  dtype=np.float32)


def _port(d, st, **kw):
    args = [torch.as_tensor(d[k]) for k in KEYS]
    return dt.solve_batch_kernel_stream(*args, st=dt.as_settings(
        st, torch.float32), **kw)


def _check_against_jax(d, rj, rp):
    """Flags agree on >= 98% of lanes (f32 paths may part at a tie);
    where both are optimal, x agrees with JAX and with x_ref to 2e-3 (the
    slot-tier gate of test_pallas_slot.py) and the port's KKT violation
    is below 1e-4; median iterations within 10%."""
    fj, fp = np.asarray(rj.exitflag), rp.exitflag.numpy()
    assert (fj == fp).mean() >= 0.98, (np.unique(fj), np.unique(fp))
    both = (fj == 1) & (fp == 1)
    xp = rp.x.numpy()
    assert np.linalg.norm(xp - np.asarray(rj.x), axis=1)[both].max() < 2e-3
    assert np.linalg.norm(xp - d['x'], axis=1)[both].max() < 2e-3
    _, viol = dt.kkt_residuals(d['H'], d['f'], d['A'], d['bupper'],
                               d['blower'], d['sense'], rp.x, rp.lam)
    assert viol[fp == 1].max() < 1e-4
    mj = np.median(np.asarray(rj.iterations))
    mp = np.median(rp.iterations.numpy())
    assert abs(mp - mj) <= 0.1 * mj, (mp, mj)


def test_stream_matches_jax():
    d = _batch(256, seed=44)
    over = {"iter_limit": 500}
    rj = batch_mod.solve_batch_pallas_stream_jit(
        *[jnp.asarray(d[k]) for k in KEYS],
        st=_as_settings(over, jnp.float32), ms=0, chunk=128,
        has_soft=False, sort_stream=True, interpret=True)
    rp = _port(d, over, chunk=128, sort_stream=True)
    _check_against_jax(d, rj, rp)


def test_accelerator_branch_matches_jax():
    # JAX's TPU branch (factorization by the tile kernel, batch.py:515-531)
    # run on the CPU by handing _pallas_batch_core the factorization
    d = _batch(128, seed=45)
    over = {"iter_limit": 500}
    st = _as_settings(over, jnp.float32)
    args = [jnp.asarray(d[k]) for k in KEYS]
    fact = jax.jit(lambda h: chol.batched_rinv_regularized(
        h, st, interpret=True))(args[0])
    rj = jax.jit(lambda *a: batch_mod._pallas_batch_core(
        *a, st=st, ms=0, interpret=True, fact=fact))(*args)
    rp = dt.solve_batch_kernel(*[torch.as_tensor(d[k]) for k in KEYS],
                               st=dt.as_settings(over, torch.float32))
    _check_against_jax(d, rj, rp)


def test_sort_stream_keeps_per_lane_results():
    # rounds, repair and polish are masked per lane: the order of the
    # stream and the chunking change nothing in any lane
    d = _batch(256, seed=46)
    a = _port(d, {"iter_limit": 500}, chunk=128, sort_stream=True)
    b = _port(d, {"iter_limit": 500}, chunk=128, sort_stream=False)
    c = _port(d, {"iter_limit": 500}, chunk=96, sort_stream=False)
    for r in (b, c):
        for name in dt.BatchResult._fields:
            assert torch.equal(getattr(a, name), getattr(r, name)), name


def test_soft_rows_unsupported():
    d = _batch(128, seed=47)
    sense = d['sense'].copy()
    sense[::4, 3] |= dt.SOFT
    r = _port(dict(d, sense=sense), {"iter_limit": 500})
    flags = r.exitflag.numpy()
    assert (flags[::4] == dt.EXIT_UNSUPPORTED).all()
    hard = np.ones(128, bool)
    hard[::4] = False
    assert (flags[hard] == 1).all()
    assert np.linalg.norm(r.x.numpy() - d['x'], axis=1)[hard].max() < 2e-3


def test_build_ldp_matches_jax():
    # the transform on one factor: auto-equality (bu == bl), a zero row
    # (ignored, and infeasible where its bounds exclude 0), row scaling;
    # f64 so only sum order separates the two (gate 1e-12 relative)
    from daqp_tpu import transform
    from daqp_tpu_torch import convert, transform as ptransform
    import functools
    d = generate_test_qp_batch(8, 6, 12, 2, 4, 1e2, rng=48)
    A, bu, bl = d['A'].copy(), d['bupper'].copy(), d['blower'].copy()
    bl[:, 5] = bu[:, 5]                       # equality row
    A[:, 3] = 0.0                             # zero general row (m index 5)
    bu[1, 5], bl[1, 5] = -1.0, -2.0           # ... infeasible on lane 1
    st = _as_settings(None, jnp.float64)
    R = np.array(jax.vmap(lambda h: transform.factorize_hessian(
        h, st)[0])(jnp.asarray(d['H'])))
    lj = jax.vmap(functools.partial(transform.build_ldp, ms=2, st=st))(
        jnp.asarray(d['H']), jnp.asarray(d['f']), jnp.asarray(A),
        jnp.asarray(bu), jnp.asarray(bl), jnp.asarray(d['sense']),
        Rinv=jnp.asarray(R))
    lj = convert.ldp_from_jax(lj)
    lp = ptransform.build_ldp(
        *(torch.as_tensor(x) for x in (d['f'], A, bu, bl, d['sense'])),
        2, convert.settings_from_jax(st), Rinv=torch.as_tensor(R))
    for name in ('sense', 'error', 'n_prox', 'prox_mask'):
        assert torch.equal(getattr(lp, name), getattr(lj, name)), name
    assert (lp.error != 0).sum() == 1 and lp.error[1] != 0
    for name in ('M', 'dupper', 'dlower', 'scaling', 'v', 'Rinv',
                 'eps_used'):
        a, b = getattr(lp, name), getattr(lj, name)
        assert torch.allclose(a, b, rtol=1e-12, atol=1e-12), name


def test_ordered_tier_matches_jax():
    # solve_batch_jit, the ordered tier (batch-mode loop and two
    # batch_post_pass rounds per lane), on test_batch.py's case in f64:
    # the JAX package's flags and iterations, x and fval within 1e-8.
    # JAX's side is the lane body its solve_batch_jit vmaps (_solve_one),
    # jitted once and run lane by lane: the vmap changes no lane's
    # arithmetic and takes 12 s more to trace on this CPU.
    import functools
    from daqp_tpu_torch import batch as pbatch, convert
    B, ms = 16, 5
    d = generate_test_qp_batch(B, 20, 50, ms, 12, 1e2, rng=99)
    st = _as_settings(None, jnp.float64)
    lane = jax.jit(functools.partial(batch_mod._solve_one, ms=ms, st=st,
                                     K=21, repair_rounds=2))
    rj = batch_mod.BatchResult(*(np.stack(v) for v in zip(*(
        lane(*[jnp.asarray(d[k][b]) for k in KEYS]) for b in range(B)))))
    rp = pbatch.solve_batch_jit(*[torch.as_tensor(d[k]) for k in KEYS],
                                convert.settings_from_jax(st), ms=ms)
    np.testing.assert_array_equal(rp.exitflag.numpy(),
                                  np.asarray(rj.exitflag))
    np.testing.assert_array_equal(rp.iterations.numpy(),
                                  np.asarray(rj.iterations))
    assert np.abs(rp.x.numpy() - np.asarray(rj.x)).max() <= 1e-8
    assert np.abs(rp.fval.numpy() - np.asarray(rj.fval)).max() <= 1e-8
    assert (rp.exitflag == 1).all()
    assert np.linalg.norm(rp.x.numpy() - d['x'], axis=1).max() < 1e-6
