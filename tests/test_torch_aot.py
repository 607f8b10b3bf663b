"""``daqp_tpu_torch.codegen.export_aot`` and the graph forms under it,
on the CPU: the exported program against the JAX package's exported
program and against the eager flat tier, each graph form against its
eager host loop lane for lane, and K1 / B10 as registered ops."""
import io
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import export as jexport

import daqp_tpu
from daqp_tpu import codegen as jcodegen
import daqp_tpu_torch as dt
from daqp_tpu_torch import batch, codegen, ldp_flat, transform
from daqp_tpu_torch.ops import chol
from tests.gen import generate_test_qp, generate_test_qp_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N, M, MS = 16, 8, 20, 3
SQRT_ZT = 1e-11 ** 0.5      # sqrt(zero_tol) of the f64 settings


def _load(blob):
    return torch.export.load(io.BytesIO(blob)).module()


def _retry_hessians(n, shifts, rng):
    """SPD-but-for-one-eigenvalue Hessians: eigenvalues in [1, 2] and, for
    a shift c, one at -c sqrt(zero_tol) max|diag H|, so the factorization
    needs 0 (c None), 1 (c = 0) or 3 (c = 2.5) regularization tries."""
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    out = []
    for c in shifts:
        w = np.linspace(1.0, 2.0, n)
        if c is not None:
            w[0] = -c * SQRT_ZT * 2.0
        out.append((Q * w) @ Q.T)
    return np.stack(out)


def _batch(dtype):
    """B lanes at (N, M, MS): equality rows on every third lane, and lane
    5's H rank-deficient (one regularization retry)."""
    d = generate_test_qp_batch(B, N, M, MS, 5, 1e2, rng=5)
    bu, bl = d['bupper'].copy(), d['blower'].copy()
    for b in range(0, B, 3):
        r = MS + 2 + b % 7
        bu[b, r] = bl[b, r] = 0.5 * (bu[b, r] + bl[b, r])
    H = d['H'].copy()
    w, V = np.linalg.eigh(H[5])
    w[0] = 0.0
    H[5] = (V * w) @ V.T
    return [torch.as_tensor(v).to(dtype)
            for v in (H, d['f'], d['A'], bu, bl)] \
        + [torch.as_tensor(d['sense'], dtype=torch.int32)]


@pytest.fixture(scope="module")
def blob64():
    return codegen.export_aot(N, M, MS, batch=B, dtype="float64",
                              device="cpu")


def test_aot_export_roundtrip():
    # tests/test_codegen.py:98-110 on the port, and against the JAX
    # package's exported program on the same inputs
    blob = codegen.export_aot(6, 12, dtype="float64", device="cpu")
    prog = _load(blob)
    rng = np.random.default_rng(107)
    x, H, f, A, bu, bl, sense = generate_test_qp(6, 12, 0, 4, 1e2, rng)
    out = prog(*(torch.as_tensor(v) for v in (H, f, A, bu, bl)),
               torch.as_tensor(sense, dtype=torch.int32))
    assert int(out["exitflag"]) == dt.EXIT_OPTIMAL
    assert np.linalg.norm(out["x"].numpy() - x) < 1e-6
    jout = jexport.deserialize(jcodegen.export_aot(6, 12, dtype="float64")) \
        .call(*(jnp.asarray(v) for v in (H, f, A, bu, bl, sense)))
    assert int(jout["exitflag"]) == daqp_tpu.EXIT_OPTIMAL
    assert np.linalg.norm(out["x"].numpy() - np.asarray(jout["x"])) < 1e-6


def _same_as_eager(out, ref, tol):
    assert torch.equal(out["exitflag"], ref.exitflag)
    assert torch.equal(out["iterations"], ref.iterations)
    for k in ("x", "lam", "fval"):
        got, want = out[k].double(), getattr(ref, k).double()
        assert torch.all((got - want).abs() <= tol * (1 + want.abs())), k


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_aot_batch_matches_eager(dtype, blob64):
    tdt = getattr(torch, dtype)
    args = _batch(tdt)
    blob = blob64 if dtype == "float64" else codegen.export_aot(
        N, M, MS, batch=B, dtype=dtype, device="cpu")
    out = _load(blob)(*args)
    ldp_flat.rounds = 0
    ref = batch.solve_batch_flat_jit(*args, dt.as_settings(None, tdt), ms=MS)
    _same_as_eager(out, ref, 1e-12)
    assert int(out["rounds"]) == ldp_flat.rounds
    flags = ref.exitflag.tolist()
    assert flags.count(1) >= B - 3 and flags[5] == 1, flags


def test_aot_loads_in_fresh_process(blob64, tmp_path):
    # a fresh process imports daqp_tpu_torch (the two ops) and loads the
    # saved program: nothing is traced again
    path = tmp_path / "flat.pt2"
    path.write_bytes(blob64)
    args = _batch(torch.float64)
    torch.save(args, tmp_path / "args.pt")
    code = ("import sys, torch, daqp_tpu_torch; "
            "p = torch.export.load(sys.argv[1]).module(); "
            "out = p(*torch.load(sys.argv[2])); "
            "torch.save(out, sys.argv[3]); "
            "assert 'jax' not in sys.modules")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code, str(path),
                           str(tmp_path / "args.pt"),
                           str(tmp_path / "out.pt")], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = torch.load(tmp_path / "out.pt")
    ref = batch.solve_batch_flat_jit(*args, dt.as_settings(None,
                                                           torch.float64),
                                     ms=MS)
    _same_as_eager(out, ref, 1e-12)


def _flat_state(args, st):
    ldpd = transform.build_ldp(*args[1:], MS, st,
                               fact=batch.factor_batch(args[0], st))
    return ldp_flat.flat_init(ldpd.M, ldpd.dupper, ldpd.dlower, ldpd.sense,
                              ldpd.scaling, K=N + 1)


def _equal_states(a, b):
    return all(torch.equal(x, y) for x, y in zip(a[:-1], b[:-1]))


def test_activation_graph_matches_eager():
    st = dt.as_settings(None, torch.float64)
    s = _flat_state(_batch(torch.float64), st)
    assert bool(((s.sense & dt.ACTIVE) > 0).any())
    assert _equal_states(ldp_flat.flat_activate(s, st),
                         ldp_flat.flat_activate_graph(s, st))


def test_round_loop_graph_matches_eager():
    st = dt.as_settings(None, torch.float64)
    _, s = batch._flat_start(*_batch(torch.float64), None, MS, st, N + 1)
    ldp_flat.rounds = 0
    want = ldp_flat.flat_solve(s, st)
    got, r = ldp_flat.flat_solve_graph(s, st)
    assert _equal_states(want, got)
    assert int(r) == ldp_flat.rounds >= 2


@pytest.mark.parametrize("route", ["chol", "library"])
def test_retry_graphs_match_eager(route):
    # lanes needing 0, 1 and 3 regularization tries, factored by the
    # K1 route (its twin here) or the library's retry loop
    st = dt.as_settings(None, torch.float64)
    H = torch.as_tensor(_retry_hessians(6, (None, 0.0, 2.5, None, 2.5),
                                        np.random.default_rng(3)))
    if route == "chol":
        want = chol.batched_rinv_regularized(H, st)
        got = chol.batched_rinv_regularized(H, st, graph=True)
    else:
        want = transform.factorize_hessian(H, st)
        got = transform.factorize_hessian(H, st, graph=True)
    eps = want[3]
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    eps0 = SQRT_ZT * torch.diagonal(H, dim1=1, dim2=2).abs().amax(1)
    tries = torch.where(eps > 0, torch.log2(eps / eps0) + 1, 0)
    assert torch.round(tries).tolist() == [0, 1, 3, 0, 3]


@pytest.mark.parametrize("route,op", [
    ("k1", torch.ops.daqp_tpu_torch.chol_rinv.default),
    ("b10", torch.ops.daqp_tpu_torch.chol_rinv_blk.default)])
def test_retry_graph_in_loaded_program(monkeypatch, route, op):
    # the K1 or B10 op inside an exported graph (the twin on the CPU; B10
    # routed at a small n), all 16 masked tries, loaded and run: the
    # eager loop's result
    monkeypatch.setattr(chol, "factor_route", lambda n, limit: route)
    st = dt.as_settings(None, torch.float64)

    class Factor(torch.nn.Module):
        def forward(self, H):
            return chol.batched_rinv_regularized(H, st, graph=True)

    H = torch.as_tensor(_retry_hessians(5, (None, 0.0, 2.5),
                                        np.random.default_rng(4)))
    ep = torch.export.export(Factor(), (H,), strict=False)
    calls = [n for n in ep.graph.nodes if n.target is op]
    assert len(calls) == 17
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    got = _load(buf.getvalue())(H)
    want = chol.batched_rinv_regularized(H, st)
    assert all(torch.equal(a, b) for a, b in zip(want, got))


@pytest.mark.parametrize("op,twin", [
    (torch.ops.daqp_tpu_torch.chol_rinv.default, chol.chol_rinv_plain),
    (torch.ops.daqp_tpu_torch.chol_rinv_blk.default,
     chol.chol_rinv_blk_plain)])
def test_registered_ops(op, twin):
    rng = np.random.default_rng(8)
    X = rng.standard_normal((4, 9, 9))
    H = torch.as_tensor(X @ X.transpose(0, 2, 1) + 9 * np.eye(9))
    torch.library.opcheck(op, (H,))
    assert torch.equal(op(H), twin(H))
    assert torch.equal((chol.chol_rinv if twin is chol.chol_rinv_plain
                        else chol.chol_rinv_blk)(H), twin(H))
