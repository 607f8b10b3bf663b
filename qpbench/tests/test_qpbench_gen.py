"""The benchmark's generator and its plain reference on the CPU."""
import pytest
import torch

from harness import data, gen, manifest
from reference import ipm

SEED = 2 ** 31 + 4099          # past 32 signed bits, as the checks' seeds


def _qps(seed, B=48, n=12, m=30, ms=0, nact=8, kappa=1e2):
    return gen.qp_batch(gen.generator(seed, "cpu"), B, n, m, ms, nact, kappa)


@pytest.mark.parametrize("ms", [0, 4])
def test_known_x_is_the_optimum(ms):
    """KKT in float64 at the known x: feasible, tight exactly on the
    construction's active rows, and H x + f + C' lam = 0 with each
    multiplier of the side's sign."""
    d = _qps(SEED, ms=ms)
    B, n = d["x"].shape
    C = torch.cat([torch.eye(n, dtype=torch.float64)[:ms].expand(B, ms, n),
                   d["A"]], 1)
    Cx = torch.einsum("bmj,bj->bm", C, d["x"])
    assert (Cx <= d["bupper"] + 1e-10).all()
    assert (Cx >= d["blower"] - 1e-10).all()
    act, up = d["active"], d["upper"]
    tight = torch.where(up, (Cx - d["bupper"]).abs(),
                        (Cx - d["blower"]).abs())
    assert (tight[act] < 1e-10).all()
    assert ((d["bupper"] - Cx)[~act] >= 0.01 - 1e-10).all()
    assert ((Cx - d["blower"])[~act] >= 0.01 - 1e-10).all()
    g = torch.einsum("bij,bj->bi", d["H"], d["x"]) + d["f"]
    Ca = C * act[:, :, None]
    lam = torch.einsum("bmj,bj->bm", torch.linalg.pinv(Ca.transpose(1, 2)),
                       -g)
    resid = torch.einsum("bmj,bm->bj", Ca, lam) + g
    assert resid.abs().max() < 1e-9
    sign = torch.where(up, lam, -lam)[act]
    assert (sign > 0).all()
    eig = torch.linalg.eigvalsh(d["H"])
    assert torch.allclose(eig[:, -1] / eig[:, 0],
                          torch.full((B,), 1e2, dtype=torch.float64))


@pytest.mark.parametrize("cond", [1e2, 1e8, 1e10, 1e16])
def test_orthonormal_factor_of_an_ill_conditioned_draw(cond):
    """Half of the batch Gaussian, half with cond(G) = ``cond``, where
    G'G is not positive definite in float64 past ~1e9: Q is orthonormal
    on every matrix, G = QR with R upper triangular and its diagonal
    positive, and the well conditioned half is what CholeskyQR2 gives."""
    F, B, n = torch.float64, 16, 30
    g = torch.Generator().manual_seed(SEED)
    U, _ = torch.linalg.qr(torch.randn(B, n, n, generator=g, dtype=F))
    V, _ = torch.linalg.qr(torch.randn(B, n, n, generator=g, dtype=F))
    s = torch.logspace(0, -torch.log10(torch.tensor(cond)).item(), n,
                       dtype=F)
    G = U @ torch.diag_embed(s.expand(B, n)) @ V.transpose(1, 2)
    G[:B // 2] = torch.randn(B // 2, n, n, generator=g, dtype=F)
    Q = gen.orthonormal(G)
    eye = torch.eye(n, dtype=F)
    assert (Q.transpose(1, 2) @ Q - eye).abs().max() < 1e-12
    R = Q.transpose(1, 2) @ G
    assert (torch.tril(R, -1).abs().amax((1, 2))
            <= 1e-12 * R.abs().amax((1, 2))).all()
    assert (torch.diagonal(R, dim1=1, dim2=2) > 0).all()
    plain = G[:B // 2]
    for _ in range(2):
        Rc = torch.linalg.cholesky(plain.transpose(1, 2) @ plain, upper=True)
        plain = torch.linalg.solve_triangular(Rc, plain, upper=True,
                                              left=False)
    assert torch.equal(Q[:B // 2], plain)


def test_same_seed_same_data_other_seed_other_data():
    a, b, c = _qps(SEED), _qps(SEED), _qps(SEED + 1)
    for k in ("H", "f", "A", "bupper", "blower", "x"):
        assert torch.equal(a[k], b[k])
        assert not torch.equal(a[k], c[k])


@pytest.mark.parametrize("ms", [0, 5])
def test_reference_finds_the_known_x(ms):
    d = _qps(SEED + 7, B=64, n=20, m=40, ms=ms, nact=12)
    cfg = {"generator": "qp", "ms": ms}
    item = dict(d, soft=torch.zeros((64, 40), dtype=torch.bool))
    x, ok = ipm.solve(*data.reference_problem(cfg, item, slice(0, 64))[:5])
    assert ok.all()
    assert (x - d["x"]).norm(dim=1).max() < 1e-9


def test_reference_certifies_a_degenerate_optimum():
    """More rows tight than independent (an active row repeated, and one
    more made tight as the sum of two): the optimum is still found and
    certified."""
    d = _qps(SEED + 8, B=8, n=10, m=16, nact=10)
    A, bu, bl = d["A"], d["bupper"], d["blower"]
    act, up = d["active"], d["upper"]
    extra_A, extra_u, extra_l = [], [], []
    for b in range(8):
        i, j = torch.nonzero(act[b])[:2, 0].tolist()
        si = 1.0 if up[b, i] else -1.0
        sj = 1.0 if up[b, j] else -1.0
        row = si * A[b, i] + sj * A[b, j]           # tight on the same side
        val = float(row @ d["x"][b])
        extra_A.append(torch.stack([A[b, i], row]))
        extra_u.append(torch.tensor([bu[b, i], val]))
        extra_l.append(torch.tensor([bl[b, i], val - 1.0]))
    A = torch.cat([A, torch.stack(extra_A)], 1)
    bu = torch.cat([bu, torch.stack(extra_u).double()], 1)
    bl = torch.cat([bl, torch.stack(extra_l).double()], 1)
    x, ok = ipm.solve(d["H"], d["f"], A, bu, bl)
    assert ok.all()
    assert (x - d["x"]).norm(dim=1).max() < 1e-9


def test_reference_and_the_port_agree_on_soft_rows():
    """A second witness for the soft rows' semantics: the port's plain
    twins on the CPU land where the reference does."""
    import daqp_tpu_torch as dt
    d = _qps(SEED + 9, B=16, n=20, m=40, nact=12)
    d32 = {k: d[k].float() for k in ("H", "f", "A", "bupper", "blower")}
    soft = torch.zeros((16, 40), dtype=torch.bool)
    soft[:, :8] = True
    sense = torch.where(soft, dt.SOFT, 0).to(torch.int32)
    r = dt.solve_batch(*d32.values(), sense, settings={"rho_soft": 1e-4})
    x, ok = ipm.solve(*d32.values(), soft=soft, rho=1e-4)
    assert ok.all() and (r.exitflag > 0).all()
    assert (r.x.double() - x).norm(dim=1).max() < 1e-4
    assert (x - d["x"]).norm(dim=1).max() > 1e-4   # the soft rows matter


def test_pool_items_are_distinct_and_served_in_the_configs_type():
    cfg = manifest.load_json(manifest.BENCH / "configs" / "dense50.json")
    cfg = dict(cfg, n=10, m=20, n_active=5)
    pool = data.make_pool(cfg, {"batch": 6, "pool": 3, "soft_rows": 4},
                          SEED, "cpu")
    assert len(pool) == 3 and pool[0]["H"].dtype == torch.float32
    assert not torch.equal(pool[0]["f"], pool[1]["f"])
    assert pool[0]["soft"][:, :4].all() and not pool[0]["soft"][:, 4:].any()
