"""The PyTorch port's package surface (daqp_tpu_torch): no jax at import,
settings equal to the JAX package's, no silent fallback from the CUDA
path, and the options ported after the first slice (soft rows,
SOFT_WEIGHTS, deadline, guess_cap) work."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daqp_tpu import types as jtypes
from daqp_tpu.api import _as_settings
import daqp_tpu_torch as dt
from daqp_tpu_torch import convert
from daqp_tpu_torch.ops import _build, chol as pchol, dense as pdense, \
    slot as pslot
from tests.gen import generate_test_qp_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_leaves_jax_out():
    # every module of the package, and every kernel source has its C
    # entry bound (one extern "C" function per .cu file); an export
    # (torch.export) imports no jax either
    code = ("import sys, daqp_tpu_torch, daqp_tpu_torch.mpc, "
            "daqp_tpu_torch.prox, daqp_tpu_torch.ops.dense, "
            "daqp_tpu_torch.ops.slot, daqp_tpu_torch.convert, "
            "daqp_tpu_torch.api, daqp_tpu_torch.core, daqp_tpu_torch.ldp, "
            "daqp_tpu_torch.model, daqp_tpu_torch.warmstart, "
            "daqp_tpu_torch.geometry, daqp_tpu_torch.hierarchical, "
            "daqp_tpu_torch.avi_solver, daqp_tpu_torch.bnb, "
            "daqp_tpu_torch.ldp_flat, daqp_tpu_torch.parallel, "
            "daqp_tpu_torch.parallel.sharding, "
            "daqp_tpu_torch.parallel.distributed, daqp_tpu_torch.codegen, "
            "daqp_tpu_torch.precompile, daqp_tpu_torch.native; "
            "from daqp_tpu_torch.ops import _build; "
            "daqp_tpu_torch.codegen.export_aot(2, 3, dtype='float64', "
            "device='cpu'); "
            "srcs = sorted(p.stem for p in _build._CSRC.glob('*.cu')); "
            "assert srcs == sorted(k[:-4] for k in _build._SIGNATURES), srcs; "
            "assert {'avi_segment', 'lp_segment'} <= set(srcs); "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'daqp_tpu' not in sys.modules, 'daqp_tpu imported'; "
            "assert not any(k == 'oracle' or k.startswith('oracle.') "
            "for k in sys.modules), 'oracle imported'")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("which", ["reference", "f32", "overrides"])
def test_settings_equal_jax(which):
    if which == "reference":
        js, ps = jtypes.Settings(), dt.Settings()
    elif which == "f32":
        js, ps = jtypes.default_settings_f32(), dt.default_settings_f32()
    else:
        over = {"iter_limit": 1000, "pricing": 1, "primal_tol": 1e-5}
        js = _as_settings(over, jnp.float32)
        ps = dt.as_settings(over, torch.float32)
    assert len(dt.Settings._fields) == len(jtypes.Settings._fields) == 17
    assert convert.settings_from_jax(js) == ps
    assert dt.as_settings(None, torch.float64) == dt.Settings()


def test_cuda_path_raises_without_toolchain(monkeypatch, tmp_path):
    # with no nvcc the kernels' build raises: nothing falls back to the
    # plain twins, which only a CPU tensor reaches
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.library()
    meta = torch.empty((2, 3, 3), device="meta")
    with pytest.raises(ValueError, match="device"):
        pchol.chol_rinv(meta)
    st = dt.default_settings_f32()
    s = pslot.slot_init(torch.empty((2, 4, 3), device="meta"),
                        *(torch.empty((2, 4), device="meta"),) * 4,
                        n_true=3)
    with pytest.raises(ValueError, match="device"):
        pslot.run_slot_round(s, st, 3)


def _meta_state(B=2, m=4, n=3):
    return pslot.slot_init(torch.empty((B, m, n), device="meta"),
                           *(torch.empty((B, m), device="meta"),) * 4,
                           n_true=n)


def test_segment_kernels_raise_on_meta():
    st = dt.default_settings_f32()
    s = _meta_state()
    duq = torch.empty((2, 3, 4), device="meta")
    with pytest.raises(ValueError, match="device meta"):
        pslot.run_mpc_segment(s, duq, duq, st, 3)
    vec = torch.empty((2,), device="meta")
    with pytest.raises(ValueError, match="device meta"):
        pslot.run_prox_segment(
            s, torch.empty((2, 3), device="meta"), vec, vec, vec,
            torch.empty((2,), dtype=torch.int32, device="meta"), vec,
            torch.empty((2, 3, 3), device="meta"),
            torch.empty((2, 3), device="meta"),
            *(torch.empty((2, 4), device="meta"),) * 2, vec, vec, st, 3)
    with pytest.raises(ValueError, match="device meta"):
        pslot.run_avi_segment(
            s, *(torch.empty((2, 3), device="meta"),) * 3, vec, vec, vec,
            vec, torch.empty((2,), dtype=torch.int32, device="meta"), vec,
            *(torch.empty((2, 3, 3), device="meta"),) * 5,
            torch.empty((2, 3), device="meta"),
            *(torch.empty((2, 4), device="meta"),) * 2, st, 3)


def test_lp_entry_and_segment_device_rules():
    # numpy inputs go to the card and raise without one; CPU tensors run
    # the twins; B6's wrapper on a device that is neither raises
    from tests.gen import generate_test_lp
    rng = np.random.default_rng(4)
    probs = [generate_test_lp(3, 6, 0, rng) for _ in range(4)]
    x_ref, f, A, bu, bl = (np.stack([p[i] for p in probs]) for i in range(5))
    args = [a.astype(np.float32) for a in (f, A, bu, bl)]
    st = dt.default_settings_f32()
    with pytest.raises(RuntimeError, match="CUDA"):
        dt.solve_batch_lp_kernel(*args, None, st)
    for fused in (False, True):
        r = dt.solve_batch_lp_kernel(*map(torch.as_tensor, args), None, st,
                                     fused=fused)
        assert r.x.device.type == "cpu"
        assert (r.exitflag.numpy() == 1).all(), r.exitflag
        gap = np.abs(np.einsum('bn,bn->b', f, r.x.numpy() - x_ref))
        assert gap.max() < 1e-4 * (1 + np.abs(np.einsum('bn,bn->b', f,
                                                         x_ref)).max())
    # a deadline long past: every lane exits TIMELIMIT
    r = dt.solve_batch_lp_kernel(*args, None, st, deadline=1.0, device="cpu")
    assert (r.exitflag.numpy() == dt.EXIT_TIMELIMIT).all(), r.exitflag
    s = _meta_state()
    vec = torch.empty((2,), device="meta")
    rows = torch.empty((2, 4), device="meta")
    with pytest.raises(ValueError, match="device meta"):
        pslot.run_lp_segment(
            s, torch.empty((2, 3), device="meta"), vec, vec, vec, vec,
            torch.empty((2,), dtype=torch.int32, device="meta"), vec, vec,
            torch.empty((2, 3), device="meta"), rows, rows, rows, rows, st,
            3, 1e-7)


def test_dense_kernel_raises_on_meta():
    st = dt.default_settings_f32()
    s = pdense.dense_init(torch.empty((2, 4, 3), device="meta"),
                          *(torch.empty((2, 4), device="meta"),) * 4)
    with pytest.raises(ValueError, match="device meta"):
        pdense.run_kernel_round(s, st, 3)


def _numpy_batch():
    d = generate_test_qp_batch(4, 3, 5, 0, 2, 1e1, rng=2, dtype=np.float32)
    return d, [d[k] for k in ('H', 'f', 'A', 'bupper', 'blower', 'sense')]


def test_numpy_inputs_solve_on_the_cpu_when_asked():
    d, args = _numpy_batch()
    st = dt.default_settings_f32()
    for solve in (dt.solve_batch_kernel, dt.solve_batch_kernel_stream,
                  dt.solve_batch_prox_kernel):
        r = solve(*args, st=st, device="cpu")
        assert r.x.device.type == "cpu"
        assert (r.exitflag.numpy() == 1).all()
        assert np.abs(r.x.numpy() - d['x']).max() < 1e-3
    f_seq = np.repeat(d['f'][:1, None], 2, axis=1).repeat(2, axis=0)
    bu = np.repeat(d['bupper'][:1, None], 2, axis=1).repeat(2, axis=0)
    bl = np.repeat(d['blower'][:1, None], 2, axis=1).repeat(2, axis=0)
    for solve in (dt.solve_mpc_scan_kernel, dt.solve_mpc_scan_kernel_fused,
                  dt.solve_mpc_scan):
        r = solve(d['H'][0], d['A'][0], f_seq, bu, bl, st, device="cpu")
        assert (r.exitflag.numpy() == 1).all()
        assert np.abs(r.x.numpy() - d['x'][0]).max() < 1e-3
    # the flat and ordered tiers and solve_batch, which routes
    from daqp_tpu_torch import batch as pbatch
    for r in (dt.solve_batch(*args, device="cpu"),
              pbatch.solve_batch_flat_jit(*args, st, device="cpu"),
              pbatch.solve_batch_jit(*args, st, device="cpu")):
        assert r.x.device.type == "cpu"
        assert (r.exitflag.numpy() == 1).all()
        assert np.abs(r.x.numpy() - d['x']).max() < 1e-3


def test_numpy_inputs_without_device_need_a_card():
    # the default device is the card: on a machine without one, numpy
    # inputs with no device raise, and nothing falls back to the CPU
    d, args = _numpy_batch()
    st = dt.default_settings_f32()
    for solve in (dt.solve_batch_kernel, dt.solve_batch_kernel_stream,
                  dt.solve_batch_prox_kernel):
        with pytest.raises(RuntimeError, match="CUDA"):
            solve(*args, st=st)
    with pytest.raises(RuntimeError, match="CUDA"):
        dt.solve_batch_hiqp_kernel(None, *args[1:], st=st,
                                   break_points=(0, 5))
    with pytest.raises(RuntimeError, match="CUDA"):
        dt.solve_batch_avi_kernel(*args, st=st)
    with pytest.raises(RuntimeError, match="CUDA"):
        dt.solve_mpc_scan_kernel_fused(d['H'][0], d['A'][0],
                                       d['f'][:, None], d['bupper'][:, None],
                                       d['blower'][:, None], st)
    with pytest.raises(RuntimeError, match="CUDA"):
        dt.solve_mpc_scan(d['H'][0], d['A'][0], d['f'], d['bupper'],
                          d['blower'], st)
    from daqp_tpu_torch import batch as pbatch
    with pytest.raises(RuntimeError, match="CUDA"):
        dt.solve_batch(*args)
    for solve in (pbatch.solve_batch_flat_jit, pbatch.solve_batch_jit,
                  pbatch.solve_batch_miqp_jit):
        with pytest.raises(RuntimeError, match="CUDA"):
            solve(*args, st)


@pytest.mark.parametrize("bp", [(0,), (0, 4), (0, 3, 3, 5)])
def test_hiqp_bad_break_points_raise(bp):
    d, args = _numpy_batch()                  # m = 5
    with pytest.raises(ValueError, match="break_points"):
        dt.solve_batch_hiqp_kernel(None, *args[1:],
                                   st=dt.default_settings_f32(),
                                   break_points=bp, device="cpu")


def test_mixed_devices_raise():
    d, args = _numpy_batch()
    st = dt.default_settings_f32()
    args[0] = torch.as_tensor(args[0])
    args[1] = torch.as_tensor(args[1], device="meta")
    with pytest.raises(ValueError, match="mixed devices"):
        dt.solve_batch_kernel(*args, st=st)
    with pytest.raises(ValueError, match="device"):
        dt.solve_batch_kernel(torch.as_tensor(d['H']), *args[1:], st=st,
                              device="meta")


@pytest.mark.parametrize("kw", [dict(has_soft=True),
                                dict(sw=True),
                                dict(guess_cap=10),
                                dict(deadline=1.0)])
def test_unported_options_raise(kw):
    d = generate_test_qp_batch(4, 3, 5, 0, 2, 1e1, rng=1, dtype=np.float32)
    args = [torch.as_tensor(d[k]) for k in
            ('H', 'f', 'A', 'bupper', 'blower', 'sense')]
    st = dt.default_settings_f32()
    if kw.get("has_soft"):
        # ported: a soft batch solves on the dense-mask tier
        args[5] = args[5] | dt.SOFT
        for solve in (dt.solve_batch_kernel_stream, dt.solve_batch_kernel):
            r = solve(*args, st=st, **kw)
            assert (r.exitflag.numpy() > 0).all(), r.exitflag
            assert np.abs(r.x.numpy() - d['x']).max() < 1e-3
        return
    if kw.get("sw"):
        # ported: SOFT_WEIGHTS data solves on B7's SOFT_WEIGHTS variant,
        # here against the lifted slack QP in f64
        from tests.test_soft_weights import _lift_and_solve
        args[5] = args[5] | dt.SOFT
        z = np.zeros((4, 5), np.float32)
        sw = dt.SoftWeights(*map(torch.as_tensor, (z, z + 0.1, z + 1.0,
                                                   z + 2.0)))
        for solve in (dt.solve_batch_kernel_stream, dt.solve_batch_kernel):
            r = solve(*args, st=st, sw=sw)
            assert (r.exitflag.numpy() > 0).all(), r.exitflag
            for b in range(4):
                ref = _lift_and_solve(
                    *(d[k][b].astype(np.float64) for k in
                      ('H', 'f', 'A', 'bupper', 'blower')), range(5),
                    z[b] + 0.0, z[b] + 0.1, z[b] + 1.0, z[b] + 2.0)
                assert np.abs(r.x[b].numpy() - ref).max() < 5e-4
        return
    if "deadline" in kw:
        # ported: a deadline long past gives every lane TIMELIMIT
        for solve in (dt.solve_batch_kernel_stream, dt.solve_batch_kernel):
            r = solve(*args, st=st, **kw)
            assert (r.exitflag.numpy() == dt.EXIT_TIMELIMIT).all(), \
                r.exitflag
        return
    # ported: the primal-init guess (opt-in) against the JAX package's
    # stream with the same cap, in f64 data on a small hard batch
    _guess_cap_matches_jax(kw["guess_cap"])


def _guess_cap_matches_jax(cap):
    """The stream with ``guess_cap`` against JAX's
    ``solve_batch_pallas_stream_jit(guess_cap=cap, interpret=True)`` on
    the same f64 batch: the same flags; each package's x within 1e-6 of
    the f64 optimum (both solve in f32 and agree to 1.4e-6); iterations
    cut as JAX's, lane for lane within one step, except on a lane whose
    guessed set the port's activation rejects (its pivot gate is
    stricter than the JAX package's Cholesky, ``slot._batched_gram_
    inverse``): that lane keeps its cold start, its iterations the cold
    solve's."""
    from daqp_tpu import batch as jbatch
    d = generate_test_qp_batch(32, 10, 30, 0, 8, 1e2, rng=47)
    keys = ('H', 'f', 'A', 'bupper', 'blower', 'sense')
    jst = _as_settings(None, jnp.float32)
    rj = jbatch.solve_batch_pallas_stream_jit(
        *(jnp.asarray(d[k]) for k in keys), st=jst, ms=0, chunk=32,
        has_soft=False, interpret=True, guess_cap=cap)
    args = [torch.as_tensor(d[k]) for k in keys]
    st = dt.as_settings(None, torch.float32)
    cold = dt.solve_batch_kernel_stream(*args, st=st, chunk=32)
    rp = dt.solve_batch_kernel_stream(*args, st=st, chunk=32, guess_cap=cap)
    assert torch.equal(dt.solve_batch_kernel(*args, st=st, guess_cap=cap).x,
                       rp.x)
    fj, fp = np.asarray(rj.exitflag), rp.exitflag.numpy()
    assert (fj == fp).all() and (fp == 1).all(), (fj, fp)
    for x in (np.asarray(rj.x), rp.x.numpy()):
        assert np.abs(x - d['x']).max() < 1e-6
    ij, ip, ic = (np.asarray(r.iterations) for r in (rj, rp, cold))
    assert ip.sum() < ic.sum()
    same = np.abs(ip - ij) <= 1
    assert same.mean() >= 0.9, (ij, ip)
    assert (ip[~same] == ic[~same]).all(), (ij, ip, ic)


def test_flat_tier_miqp_names_its_item():
    # the flat tier's batched branch and bound (ROADMAP A13) is ported:
    # each lane as the single-instance MIQP solve of dt.quadprog
    from daqp_tpu_torch import batch as pbatch
    from tests.test_bnb import _random_miqp
    probs = [_random_miqp(6, 10, 0, 3, np.random.default_rng(s))
             for s in (0, 1)]
    args = [np.stack(v) for v in zip(*probs)]
    st = dt.as_settings(None, torch.float64)
    out = pbatch.solve_batch_miqp_jit(*args, st, bin_ids=(0, 1, 2),
                                      device="cpu")
    assert out.x.shape == (2, 6) and out.nodes.shape == (2,)
    for b, p in enumerate(probs):
        one = dt.quadprog(*p, dtype=torch.float64, device="cpu")
        assert int(out.exitflag[b]) == one.exitflag
        assert int(out.nodes[b]) == one.nodes
        assert abs(float(out.fval[b]) - float(one.fval)) <= 1e-12
