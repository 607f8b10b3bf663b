"""Randomized differential fuzzer of the PyTorch / CUDA port.

The port's counterpart of ``scripts/fuzz_differential.py`` (which fuzzes
the JAX package): its instance generators and conditioning-scaled gates
are copied here (kappa for QPs, 1/mu for AVIs, mu the least eigenvalue
of sym(H); ROUND5.md:147-158), and each family drives one tier of
``daqp_tpu_torch`` on random instances:

* ``flat``: ``solve_batch_flat_jit`` and ``solve_batch_kernel`` (K1, K2)
  in f32, with equality rows and Dantzig or Bland pricing, under the
  f64 KKT gate, a lane off it judged against the port's f64 single
  solve, and the tiers' optimal rates;
* ``routes``: ``solve_batch`` in f32 (the kernel route) and f64 (the flat
  route) against the constructed optimum;
* ``soft``: SOFT rows through ``solve_batch_kernel`` (B7) against the f64
  single solve;
* ``sw``: SOFT_WEIGHTS through the flat tier in f64 and the kernel tier
  (B7-sw) in f32 against the f64 single solve, disputes settled by the
  lifted slack QP's objective;
* ``prox``: ``solve_batch_prox_kernel`` (B4) against the constructed
  optimum;
* ``hiqp``: ``solve_batch_hiqp_kernel`` (B7) against the f64 single
  hierarchy at the tier's rho, and ``oracle/hiqp_numpy.py`` on a lane;
* ``avi``: ``solve_batch_avi_kernel`` (B5, K2) against the constructed
  solutions and the f64 single ``avi``;
* ``lp``: ``solve_batch_lp_kernel`` per pass (K2) and fused (B6) under
  the objective-gap and feasibility gate, the f64 single ``linprog``,
  the C library and ``oracle/prox_numpy.py`` on a few lanes;
* ``miqp``: ``solve_batch_miqp_kernel`` (K1, K2 node waves) against the
  f64 single branch and bound and ``oracle/bnb_numpy.py``;
* ``single``: ``quadprog`` in f64 against the constructed optimum and
  ``oracle/daqp_numpy.py``;
* ``native``: the C library (``daqp_tpu_torch.native``) against the f64
  single solve, QP and MIQP;
* ``export``: the program of ``codegen.export_aot`` (K1 as a registered
  op on the card) against the eager flat tier, lane for lane.

``--jax`` (CPU only; the JAX package is the reference, not the port)
runs the JAX package's same tier on each instance that shows a finding
and records whether it fails the same lane the same way: such a finding
is the reference's, the rest the port's.

    python scripts/fuzz_torch.py [seconds] [--device cpu|cuda] [--jax]
                                 [--seed S]

Exit 0: no finding; otherwise the findings are printed with their seeds
(``--seed S`` with the family's round reproduces one).
"""
import argparse
import importlib
import importlib.util
import io
import json
import os
import sys
import time
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import daqp_tpu_torch as dt  # noqa: E402
from daqp_tpu_torch import batch as pb, codegen  # noqa: E402
from daqp_tpu_torch.native import NativeModel  # noqa: E402
from daqp_tpu_torch.ops import smem  # noqa: E402

def _load_gen():
    """``tests/gen.py`` by path: an installed package named ``tests`` may
    shadow the repository's test directory."""
    spec = importlib.util.spec_from_file_location(
        "fuzz_torch_gen", os.path.join(ROOT, "tests", "gen.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_gen = _load_gen()
generate_test_avi_two_sided = _gen.generate_test_avi_two_sided
generate_test_lp = _gen.generate_test_lp
generate_test_qp = _gen.generate_test_qp
generate_test_qp_batch = _gen.generate_test_qp_batch

FAMILIES = ("flat", "routes", "soft", "sw", "prox", "hiqp", "avi", "lp",
            "miqp", "single", "native", "export")
KEYS = ('H', 'f', 'A', 'bupper', 'blower', 'sense')


def oracle(name):
    """``oracle/<name>.py`` as a submodule of a package rooted there (its
    modules import each other relatively; no ``__init__.py``)."""
    pkg = "fuzz_torch_oracle"
    if pkg not in sys.modules:
        mod = types.ModuleType(pkg)
        mod.__path__ = [os.path.join(ROOT, "oracle")]
        sys.modules[pkg] = mod
    return importlib.import_module(f"{pkg}.{name}")


def sw_objective(x, H, f, A, bu, bl, soft_rows, d_ls, d_us, rho_ls, rho_us):
    """The SOFT_WEIGHTS objective at x, slacks eliminated, and the largest
    hard-row violation (``tests/test_soft_weights.py:18``)."""
    su, sl = np.sqrt(rho_us), np.sqrt(rho_ls)
    obj = 0.5 * x @ H @ x + f @ x
    hard = 0.0
    for i in range(A.shape[0]):
        ai = A[i] @ x
        if i in soft_rows:
            t_up = max(0.0, (ai - bu[i]) / su[i]) + d_us[i] * su[i]
            t_lo = max(0.0, (bl[i] - ai) / sl[i]) + d_ls[i] * sl[i]
            obj += 0.5 * t_up ** 2 + 0.5 * t_lo ** 2
        else:
            hard = max(hard, ai - bu[i], bl[i] - ai)
    return obj, hard


def lifted_x(H, f, A, bu, bl, soft_rows, d_ls, d_us, rho_ls, rho_us):
    """x of the lifted slack QP (``tests/test_soft_weights.py:41``),
    solved by the port's f64 single solve on the CPU."""
    n, m, k = H.shape[0], A.shape[0], len(soft_rows)
    nz = n + 2 * k
    Hz = np.eye(nz)
    Hz[:n, :n] = H
    su, sl = np.sqrt(rho_us), np.sqrt(rho_ls)
    fz = np.concatenate([f, (d_us * su)[soft_rows], (d_ls * sl)[soft_rows]])
    rows, rub, rlb = [], [], []
    for i in range(m):
        r = np.zeros(nz)
        r[:n] = A[i]
        if i in soft_rows:
            j = soft_rows.index(i)
            up, lo = r.copy(), r.copy()
            up[n + j] = -su[i]
            lo[n + k + j] = sl[i]
            rows += [up, lo]
            rub += [bu[i], 1e30]
            rlb += [-1e30, bl[i]]
        else:
            rows.append(r)
            rub.append(bu[i])
            rlb.append(bl[i])
    for j in range(2 * k):
        r = np.zeros(nz)
        r[n + j] = 1.0
        rows.append(r)
        rub.append(1e30)
        rlb.append(0.0)
    res = dt.quadprog(Hz, fz, np.asarray(rows), np.asarray(rub),
                      np.asarray(rlb), ms=0, dtype=torch.float64,
                      device="cpu")
    return res.x.numpy()[:n] if res.exitflag in (1, 2) else None


def lp_certified(f, G, bu, bl, x, lam, primal_tol):
    """The LP tier's own final certificate (``batch.solve_batch_lp_kernel``,
    the JAX package's ``batch.py:1427-1578``) re-done in f64 on the tier's
    x and duals: feasibility within 10 primal_tol (1 + max|bu|),
    f + G' lam stationary within 1e-5 (1 + ||f||_inf) (G = [I_ms; A]), and
    a dual above 1e-6 only on an upper-tight row, below -1e-6 only on a
    lower-tight one.  (At a degenerate vertex, more than n tight rows,
    least-squares duals need not carry the sign a valid set of duals
    has.)"""
    f, G, bu, bl, x, lam = (np.asarray(v, np.float64)
                            for v in (f, G, bu, bl, x, lam))
    vals = G @ x
    tol = 10.0 * primal_tol * (1.0 + np.abs(bu).max())
    return bool(max((vals - bu).max(), (bl - vals).max()) <= tol
                and np.abs(f + G.T @ lam).max()
                <= 1e-5 * (1.0 + np.abs(f).max())
                and not (((lam > 1e-6) & (bu - vals > tol))
                         | ((lam < -1e-6) & (vals - bl > tol))).any())


def host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def mu_of(H):
    """The least eigenvalue of sym(H) per lane (the AVI gates' 1/mu)."""
    H = np.asarray(H, np.float64)
    return np.linalg.eigvalsh(0.5 * (H + np.swapaxes(H, -1, -2)))[..., 0]


# tier -> (the port's entry in ``batch``, the JAX package's counterpart in
# ``daqp_tpu.batch``, whether the JAX one takes ``interpret=True``)
TIERS = {
    "flat": ("solve_batch_flat_jit", "solve_batch_flat_jit", False),
    "kernel": ("solve_batch_kernel", "solve_batch_pallas_jit", True),
    "prox": ("solve_batch_prox_kernel", "solve_batch_prox_pallas_jit", True),
    "hiqp": ("solve_batch_hiqp_kernel", "solve_batch_hiqp_pallas_jit", True),
    "avi": ("solve_batch_avi_kernel", "solve_batch_avi_pallas_jit", True),
    "lp": ("solve_batch_lp_kernel", "solve_batch_lp_pallas_jit", True),
    "miqp": ("solve_batch_miqp_kernel", "solve_batch_miqp_pallas_jit", True),
}


class Fuzzer:
    """The families on one device; ``small`` cuts every batch to a few
    lanes (the CPU test).  ``findings`` collects (family, seed, what...);
    with ``jax``, each finding ends with the lanes on which the JAX
    package's same tier fails the same gate."""

    def __init__(self, device="cpu", small=False, jax=False):
        self.dev = torch.device(device)
        self.small = small
        self.jax = self._jax() if jax else None
        self.findings = []
        self.census = []       # with jax: (family, seed, tier, counts)
        self.instances = {f: 0 for f in FAMILIES}
        self._programs = {}

    @staticmethod
    def _jax():
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import jax.numpy as jnp
        import daqp_tpu
        from daqp_tpu import batch as jb
        from daqp_tpu.api import _as_settings
        from daqp_tpu.types import SoftWeights
        return types.SimpleNamespace(jnp=jnp, dq=daqp_tpu, jb=jb,
                                     st=_as_settings,
                                     SoftWeights=SoftWeights)

    def lanes(self, big):
        return 8 if self.small else big

    def t(self, x, dtype=torch.float32):
        x = torch.as_tensor(np.asarray(x))
        return (x if not x.is_floating_point() else x.to(dtype)).to(self.dev)

    def note(self, family, seed, *what):
        self.findings.append((family, seed) + what)

    def judge(self, family, seed, info, bad, jax_bad):
        """Record the port's ``bad`` lanes ({lane: detail}); with
        ``--jax``, also which of them ``jax_bad()`` (the JAX package's
        lanes under the same gate) holds."""
        if not bad:
            return
        ref = None
        if self.jax is not None:
            ref = {"jax_fails_too": sorted(set(bad) & set(jax_bad()),
                                           key=str)}
        self.note(family, seed, *info, bad, ref)

    def solve(self, tier, data, over, dtype, jax=False, **kw):
        """``tier`` on the numpy ``data`` (None passes through), in
        ``dtype`` with the settings ``over``: the port's entry, or with
        ``jax`` the JAX package's; (flags, x, lam, fval) on the host."""
        port_name, jax_name, interpret = TIERS[tier]
        if not jax:
            args = [None if v is None else self.t(v, dtype) for v in data]
            if kw.get("sw") is not None:
                kw["sw"] = dt.SoftWeights(*(self.t(v, dtype)
                                            for v in kw["sw"]))
            r = getattr(pb, port_name)(*args, dt.as_settings(over, dtype),
                                       **kw)
        else:
            j = self.jax
            npdt = np.float32 if dtype == torch.float32 else np.float64
            args = [None if v is None else j.jnp.asarray(
                v.astype(npdt) if v.dtype.kind == "f" else v) for v in data]
            if kw.get("sw") is not None:
                kw["sw"] = j.SoftWeights(*(j.jnp.asarray(v.astype(npdt))
                                           for v in kw["sw"]))
            if interpret:
                kw["interpret"] = True
            if tier in ("prox", "avi", "lp"):
                # in interpret mode the JAX package runs its fused
                # segments only when forced; the port's defaults: prox
                # and AVI fused, LP per pass
                kw["fused"] = "force" if kw.get("fused", tier != "lp") \
                    else False
            r = getattr(j.jb, jax_name)(*args, j.st(over, npdt), **kw)
        return (host(r.exitflag), host(r.x).astype(float), host(r.lam),
                host(r.fval).astype(float))

    def single64(self, H, f, A, bu, bl, sense=None, ms=0, **kw):
        return dt.quadprog(H, f, A, bu, bl, sense, ms=ms,
                           dtype=torch.float64, device="cpu", **kw)

    # -- families ----------------------------------------------------------
    def flat(self, seed):
        """``fuzz_differential.check_qp`` on the port's flat and kernel
        tiers (f32): an optimal lane off the f64 KKT gate (stationarity
        max(1e-4, 2e-5 sqrt(kappa)), violation 5e-3) is a finding when
        this tier is far off the f64 single solve and the other tier is
        not; the optimal-or-infeasible rate has a floor (Bland's lower)
        and the two tiers' rates may differ by 0.2."""
        rng = np.random.default_rng(seed)
        n = int(rng.integers(4, 28))
        m = int(rng.integers(n + 2, 3 * n + 8))
        nact = int(rng.integers(1, n))
        kappa = float(10 ** rng.integers(1, 5))
        B = self.lanes(128)
        d = generate_test_qp_batch(B, n, m, 0, nact, kappa, rng=seed,
                                   dtype=np.float32)
        bu, bl = d['bupper'].copy(), d['blower'].copy()
        for b in range(0, B, 9):
            r = int(rng.integers(0, m))
            bu[b][r] = bl[b][r] = 0.5 * (bu[b][r] + bl[b][r])
        pricing = int(rng.integers(0, 2))
        over = {"iter_limit": 1500, "pricing": pricing}
        data = (d['H'], d['f'], d['A'], bu, bl, d['sense'])
        tol_stat = max(1e-4, 2e-5 * np.sqrt(kappa))
        singles = {}

        def x64(b):
            if b not in singles:
                r = self.single64(*(v[b].astype(float) for v in data[:5]))
                singles[b] = host(r.x) if r.exitflag == 1 else None
            return singles[b]

        def gate(res):
            bad = {}
            for name, other in (("flat", "kernel"), ("kernel", "flat")):
                flags, x, lam, _ = res[name]
                ok, ok_o = flags == 1, res[other][0] == 1
                stat, viol = pb.kkt_residuals(*data, x, lam)
                for b in np.flatnonzero(ok & ((stat > tol_stat)
                                              | (viol > 5e-3)))[:5]:
                    xr = x64(b)
                    if xr is None or not ok_o[b]:
                        continue
                    e_this = np.linalg.norm(x[b] - xr)
                    e_oth = np.linalg.norm(res[other][1][b] - xr)
                    if e_this > 10 * e_oth + 1e-3:
                        bad[int(b)] = (name, float(e_this), float(e_oth))
            return bad

        def tiers(jax=False):
            return {name: self.solve(name, data, over, torch.float32, jax)
                    for name in ("flat", "kernel")}

        res = tiers()
        self.judge("flat", seed, (n, m, kappa, pricing, "kkt-vs-f64"),
                   gate(res), lambda: gate(tiers(True)))
        rates = {k: float(((v[0] == 1) | (v[0] == -1)).mean())
                 for k, v in res.items()}
        floor = 0.95 if pricing == 0 else (0.70 if kappa <= 100 else 0.40)
        for name, rate in rates.items():
            if rate < floor:
                self.note("flat", seed, name, n, m, kappa, pricing, "rate",
                          rate)
        if abs(rates["flat"] - rates["kernel"]) > 0.2 \
                and not (pricing == 1 and kappa > 100):
            self.note("flat", seed, "tier-split", n, m, kappa, pricing,
                      rates)

    def routes(self, seed):
        """``solve_batch`` on both routes against the constructed optimum:
        f32 (the kernel stream) and f64 (the flat tier), lanes flagged 1
        within 1e-4 and 1e-6 times max(1, sqrt(kappa / 100)), an optimal
        rate of 0.95."""
        rng = np.random.default_rng(seed)
        n = int(rng.integers(4, 30))
        m = int(rng.integers(n + 2, 3 * n + 8))
        ms = int(rng.integers(0, n + 1))
        kappa = float(10 ** rng.integers(1, 4))
        d = generate_test_qp_batch(self.lanes(64), n, m, ms,
                                   int(rng.integers(1, n)), kappa, rng=seed)
        scale = max(1.0, np.sqrt(kappa / 100))
        data = [d[k] for k in KEYS]
        for dtype, tol, want in ((torch.float32, 1e-4, "kernel"),
                                 (torch.float64, 1e-6, "flat")):
            route = pb.batch_route(dtype, n, m, False, False,
                                   smem.limit(self.dev))
            if route != want:
                self.note("routes", seed, "route", n, m, str(dtype), route)

            def gate(flags, x):
                err = np.linalg.norm(x - d['x'], axis=1)
                bad = {int(b): float(err[b]) for b in np.flatnonzero(
                    (flags == 1) & (err > tol * scale))[:5]}
                if np.mean(flags == 1) < 0.95:
                    bad[-1] = float(np.mean(flags == 1))
                return bad

            def jax_bad():
                j = self.jax
                npdt = np.float32 if dtype == torch.float32 else np.float64
                r = j.dq.solve_batch(*(j.jnp.asarray(
                    v.astype(npdt) if v.dtype.kind == "f" else v)
                    for v in data), ms=ms)
                return gate(host(r.exitflag), host(r.x).astype(float))

            r = dt.solve_batch(*(self.t(v, dtype) for v in data), ms=ms)
            self.judge("routes", seed, (route, n, m, ms, kappa),
                       gate(host(r.exitflag), host(r.x).astype(float)),
                       jax_bad)

    def soft(self, seed):
        """Rows SOFT on every lane through ``solve_batch_kernel`` (B7, f32)
        against the f64 single solve at the tier's rho_soft on a sample of
        lanes: both flags positive within 1e-4 max(1, sqrt(kappa / 100))
        (the soft phase's gate at kappa 1e2), or the same loud flag."""
        rng = np.random.default_rng(seed)
        n = int(rng.integers(4, 20))
        m = int(rng.integers(n + 4, 3 * n + 8))
        kappa = float(10 ** rng.integers(1, 4))
        B = self.lanes(64)
        d = generate_test_qp_batch(B, n, m, 0, int(rng.integers(1, n)),
                                   kappa, rng=seed)
        sense = d['sense'].copy()
        soft_rows = rng.choice(m, int(rng.integers(1, m // 3 + 1)),
                               replace=False)
        sense[:, soft_rows] |= dt.SOFT
        data = [d['H'], d['f'], d['A'], d['bupper'], d['blower'], sense]
        over = {"iter_limit": 2000}
        tol = 1e-4 * max(1.0, np.sqrt(kappa / 100))
        sample = range(0, B, max(1, B // 16))
        # at the tier's rho_soft (the f32 default's), the problem it solves
        rho = {"rho_soft": dt.default_settings_f32().rho_soft}
        ones = {b: self.single64(*(v[b] for v in data), settings=rho)
                for b in sample}

        def gate(res):
            flags, x = res[0], res[1]
            bad = {}
            for b, one in ones.items():
                if flags[b] > 0 and one.exitflag > 0:
                    e = float(np.linalg.norm(x[b] - host(one.x)))
                    if e > tol:
                        bad[b] = e
                elif flags[b] > 0 or one.exitflag == 1:
                    bad[b] = (int(flags[b]), one.exitflag)
            return bad

        self.judge("soft", seed, (n, m, kappa, soft_rows.tolist()),
                   gate(self.solve("kernel", data, over, torch.float32)),
                   lambda: gate(self.solve("kernel", data, over,
                                           torch.float32, True)))

    def sw(self, seed):
        """``fuzz_differential.check_sw`` on the port: the flat tier in f64
        and the kernel tier (B7-sw) in f32 against the f64 single solve
        (flat within 1e-5; kernel within 5e-4, or the lifted slack QP's
        objective within 1e-4 and hard rows within 1e-4); a flat lane
        may exit CYCLE, loud."""
        rng = np.random.default_rng(seed)
        n = int(rng.integers(3, 10))
        m = int(rng.integers(n + 3, 2 * n + 8))
        ns = int(rng.integers(1, max(2, m // 3)))
        B = self.lanes(16)
        soft_rows = sorted(rng.choice(m, ns, replace=False).tolist())
        H = np.empty((B, n, n))
        f = np.empty((B, n))
        A = np.empty((B, m, n))
        bu, bl = np.empty((B, m)), np.empty((B, m))
        d_ls, d_us = np.zeros((B, m)), np.zeros((B, m))
        rho_ls, rho_us = np.ones((B, m)), np.ones((B, m))
        for b in range(B):
            Q = rng.standard_normal((n, n))
            H[b] = Q @ Q.T + 0.5 * np.eye(n)
            f[b] = 3 * rng.standard_normal(n)
            A[b] = rng.standard_normal((m, n))
            bu[b] = 0.3 * rng.random(m)
            bl[b] = bu[b] - 0.3 - 0.5 * rng.random(m)
            d_ls[b, soft_rows] = 0.4 * rng.random(ns)
            d_us[b, soft_rows] = 0.4 * rng.random(ns)
            rho_ls[b, soft_rows] = 0.5 + rng.random(ns)
            rho_us[b, soft_rows] = 0.5 + rng.random(ns)
        sense = np.zeros((B, m), np.int32)
        sense[:, soft_rows] = dt.SOFT
        swd = (d_ls, d_us, rho_ls, rho_us)
        data = (H, f, A, bu, bl, sense)
        over = {"iter_limit": 2000}
        ones = [self.single64(*(v[b] for v in data),
                              soft_weights={k: v[b] for k, v in zip(
                                  ("d_ls", "d_us", "rho_ls", "rho_us"),
                                  swd)}, settings=over) for b in range(B)]

        def gap(b, x):
            w = [v[b] for v in swd]
            xl = lifted_x(H[b], f[b], A[b], bu[b], bl[b], soft_rows, *w)
            if xl is None:
                return 0.0, 0.0
            ox, hx = sw_objective(x, H[b], f[b], A[b], bu[b], bl[b],
                                  soft_rows, *w)
            ol, _ = sw_objective(xl, H[b], f[b], A[b], bu[b], bl[b],
                                 soft_rows, *w)
            return (ox - ol) / (1.0 + abs(ol)), hx

        def gate(res, kernel):
            flags, x = res[0], res[1]
            bad = {}
            for b, one in enumerate(ones):
                if kernel and flags[b] > 0 and (one.exitflag < 0 or np.abs(
                        x[b] - host(one.x)).max() > 5e-4):
                    g, hard = gap(b, x[b])
                    if g > 1e-4 or hard > 1e-4:
                        bad[b] = ("obj-gap", float(g), float(hard))
                elif not kernel and flags[b] > 0 and one.exitflag > 0:
                    e = float(np.abs(x[b] - host(one.x)).max())
                    if e > 1e-5:
                        bad[b] = ("x", e)
                elif flags[b] <= 0 and flags[b] != one.exitflag \
                        and flags[b] != dt.EXIT_CYCLE:
                    bad[b] = ("flag", int(flags[b]), one.exitflag)
            return bad

        for tier, dtype, kw in (("flat", torch.float64, dict(K=n + ns + 1)),
                                ("kernel", torch.float32, {})):
            def run(jax=False, tier=tier, dtype=dtype, kw=kw):
                return self.solve(tier, data, over, dtype, jax, sw=swd, **kw)
            self.judge("sw", seed, (tier, n, m, ns),
                       gate(run(), tier == "kernel"),
                       lambda run=run, tier=tier: gate(run(True),
                                                       tier == "kernel"))

    def prox(self, seed):
        """``fuzz_differential.check_prox_fused``: B4 against the
        constructed optimum (every flag positive, ||dx||_2 <= 1e-3)."""
        rng = np.random.default_rng(seed)
        n = int(rng.integers(4, 12))
        m = int(rng.integers(n + 4, 3 * n))
        d = generate_test_qp_batch(self.lanes(128), n, m, 0, max(1, n // 2),
                                   1e2, rng=seed, dtype=np.float32)
        data = [d[k] for k in KEYS]
        over = {"iter_limit": 1500}

        def gate(res):
            err = np.linalg.norm(res[1] - d['x'], axis=1)
            return {int(b): (int(res[0][b]), float(err[b]))
                    for b in np.flatnonzero((res[0] <= 0) | (err > 1e-3))}

        self.judge("prox", seed, (n, m),
                   gate(self.solve("prox", data, over, torch.float32)),
                   lambda: gate(self.solve("prox", data, over,
                                           torch.float32, True)))

    def hiqp(self, seed):
        """``fuzz_differential.check_hiqp``: the level walk (B7) against
        the f64 single hierarchy at the tier's rho (the same class; x
        within 2e-3, one tie-break lane allowed); the first lane's single
        hierarchy also against ``oracle/hiqp_numpy.py`` (1e-5)."""
        rng = np.random.default_rng(seed)
        n = int(rng.integers(5, 12))
        nl = int(rng.integers(2, 4))
        per = int(rng.integers(3, n))
        bp = tuple(per * i for i in range(nl + 1))
        m = bp[-1]
        B = self.lanes(32)
        A = rng.standard_normal((B, m, n)).astype(np.float32)
        x0 = rng.standard_normal((B, n)).astype(np.float32)
        b0 = np.einsum('bmn,bn->bm', A, x0)
        bu = (b0 + 0.3 * rng.random((B, m))).astype(np.float32)
        bl = (b0 - 0.3 - 0.6 * rng.random((B, m))).astype(np.float32)
        for b in range(0, B, 5):          # conflicting first-level rows
            A[b, 1] = A[b, 0]
            bu[b, 0], bl[b, 0] = b0[b, 0] - 1.0, b0[b, 0] - 2.0
            bl[b, 1], bu[b, 1] = b0[b, 1] + 1.0, b0[b, 1] + 2.0
        se = np.zeros((B, m), np.int32)
        f = np.zeros((B, n), np.float32)
        data = (None, f, A, bu, bl, se)
        over = {"iter_limit": 3000}
        match = {"rho_soft": pb.HIQP_RHO_FLOOR, "iter_limit": 3000,
                 "primal_tol": float(dt.default_settings_f32().primal_tol)}
        sample = range(0, B, max(1, B // 5))
        ones = {b: dt.solve(None, f[b], A[b], bu[b], bl[b], se[b], ms=0,
                            break_points=bp, settings=match,
                            dtype=torch.float64, device="cpu")
                for b in sample}
        ref = oracle("hiqp_numpy").hiqp(
            None, f[0].astype(float), A[0].astype(float),
            bu[0].astype(float), bl[0].astype(float), ms=0,
            break_points=bp, settings=match)
        if ref["exitflag"] > 0 and ones[0].exitflag > 0 and np.abs(
                ref["x"] - host(ones[0].x)).max() > 1e-5:
            self.note("hiqp", seed, n, bp, 0, "oracle", float(
                np.abs(ref["x"] - host(ones[0].x)).max()))

        def gate(res):
            flags, x = res[0], res[1]
            bad, xdiff = {}, []
            for b, one in ones.items():
                if flags[b] <= 0 or one.exitflag <= 0:
                    if flags[b] != one.exitflag:
                        bad[b] = ("flag", int(flags[b]), one.exitflag)
                elif np.abs(x[b] - host(one.x)).max() > 2e-3:
                    xdiff.append(b)
            if len(xdiff) > 1:
                bad.update({b: "x" for b in xdiff})
            return bad

        kw = dict(break_points=bp)
        self.judge("hiqp", seed, (n, bp),
                   gate(self.solve("hiqp", data, over, torch.float32, **kw)),
                   lambda: gate(self.solve("hiqp", data, over, torch.float32,
                                           True, **kw)))

    def avi(self, seed):
        """``fuzz_differential.check_avi``: the AVI tier (B5, K2) against
        the constructed solutions, a lane flagged 1 within max(5e-4, 3e-5
        / mu), the optimal rate 0.9; the f64 single ``avi`` on a few
        lanes within 1e-5."""
        rng = np.random.default_rng(seed)
        n = int(rng.integers(4, 14))
        m = int(rng.integers(n + 4, 3 * n))
        B = self.lanes(64)
        probs = [generate_test_avi_two_sided(n, m, rng) for _ in range(B)]
        xs = np.stack([p[0] for p in probs])
        H, f, A, bu, bl = (np.stack([p[i] for p in probs]).astype(np.float32)
                           for i in range(1, 6))
        data = (H, f, A, bu, bl, np.zeros((B, m), np.int32))
        over = {"iter_limit": 3000}
        mus = mu_of(H)

        def gate(res):
            flags, x = res[0], res[1]
            err = np.abs(x - xs).max(axis=1)
            bad = {int(b): (float(err[b]), float(mus[b]))
                   for b in np.flatnonzero(flags == 1)
                   if err[b] > max(5e-4, 3e-5 / max(mus[b], 1e-8))}
            if np.mean(flags == 1) < 0.9:
                bad[-1] = float(np.mean(flags == 1))
            return bad

        self.judge("avi", seed, (n, m),
                   gate(self.solve("avi", data, over, torch.float32)),
                   lambda: gate(self.solve("avi", data, over, torch.float32,
                                           True)))
        for b in range(0, B, max(1, B // 3)):
            one = dt.avi(*(v[b].astype(np.float64) for v in data[:5]),
                         ms=0, dtype=torch.float64, device="cpu")
            if one.exitflag != 1 or np.abs(host(one.x) - xs[b]).max() > 1e-5:
                self.note("avi", seed, n, m, b, "single", one.exitflag,
                          float(np.abs(host(one.x) - xs[b]).max()))

    def lp(self, seed):
        """``fuzz_differential.check_lp``: per-pass (K2) and fused (B6) LPs
        under the relative objective-gap and feasibility gate (2e-4) and
        an optimal rate of 0.9 (fused: a lane beyond the gate must pass the
        tier's certificate re-done in f64 on its x and duals, the rate
        floor is 0.75, and every lane must pass after
        ``backstop_resolve_lp``); the f64
        single ``linprog``,
        the C library and ``oracle/prox_numpy.py`` on the original f64
        data of a few lanes (fval within 1e-5 (1 + |fval|); a loud oracle
        is the reference's finding)."""
        rng = np.random.default_rng(seed)
        n = int(rng.integers(4, 16))
        m = int(rng.integers(2 * n, 5 * n))
        ms = int(rng.integers(0, max(1, n // 2)))
        B = self.lanes(64)
        probs = [generate_test_lp(n, m, ms, rng) for _ in range(B)]
        xs = np.stack([p[0] for p in probs])
        f64 = [np.stack([p[i] for p in probs]) for i in range(1, 5)]
        f, A, bu, bl = (v.astype(np.float32) for v in f64)
        data = (f, A, bu, bl, np.zeros((B, m), np.int32))
        over = {"iter_limit": 3000}
        fv_ref = np.einsum('bn,bn->b', f, xs)

        ptol = float(dt.default_settings_f32().primal_tol)

        def gate(res, floor, fused=False):
            flags, x = res[0], res[1].astype(np.float32)
            gap = np.abs(np.einsum('bn,bn->b', f, x) - fv_ref) \
                / (1.0 + np.abs(fv_ref))
            vals = np.concatenate([x[:, :ms], np.einsum('bmn,bn->bm', A, x)],
                                  axis=1)
            feas = np.maximum((vals - bu).max(1), (bl - vals).max(1))
            # the fused tier certifies its flag-1 lanes to its own
            # certificate, which a lane beyond bench_lp's gate may pass
            # (the JAX tier's beyond lanes, PERF.md §2's LP fused row)
            bad = {int(b): (float(gap[b]), float(feas[b]))
                   for b in np.flatnonzero(flags == 1)
                   if (gap[b] > 2e-4 or feas[b] > 2e-4) and not (
                       fused and lp_certified(
                           f[b], np.vstack([np.eye(n)[:ms], A[b]]), bu[b],
                           bl[b], res[1][b], res[2][b], ptol))}
            if np.mean(flags == 1) < floor:
                bad[-1] = float(np.mean(flags == 1))
            return bad

        # the fused tier turns loud every lane its segments freeze and
        # every flag-1 lane whose duals are not stationary (LP_DUAL_TOL),
        # where the JAX package's fused tier flags some of them 1 beyond
        # the gate (seeds 100019, 100043, 100079 at n = 14-15: the port
        # 52-56 of 64 flag 1, none beyond; JAX 57-62, 2-4 beyond): its
        # loud lanes must come out of backstop_resolve_lp within the gate
        # (what a user is handed), and its raw floor is 0.75
        for fused, floor in ((False, 0.9), (True, 0.75)):
            kw = dict(ms=ms, fused=fused)
            args = [self.t(v) for v in data]
            r = pb.solve_batch_lp_kernel(*args, dt.as_settings(
                over, torch.float32), **kw)
            res = (host(r.exitflag), host(r.x), host(r.lam))
            bad = gate(res, floor, fused)
            if self.jax is not None:
                # flag-1 lanes and those beyond the gate, port and JAX
                jres = self.solve("lp", data, over, torch.float32, True,
                                  **kw)
                self.census.append(("lp", seed, "fused" if fused
                                    else "per_pass", {
                    who: (int((v[0] == 1).sum()),
                          len([b for b in gate(v, 0.0) if b != -1]))
                    for who, v in (("port", res), ("jax", jres))}))
            if fused:
                rb = pb.backstop_resolve_lp(r, *args, ms=ms)
                bad.update({("backstop", b): v for b, v in gate(
                    (host(rb.exitflag), host(rb.x), host(rb.lam)), 1.0,
                    True).items()})
            self.judge("lp", seed, ("fused" if fused else "per_pass", n, m,
                                    ms), bad,
                       lambda kw=kw, floor=floor, fused=fused: gate(
                           self.solve("lp", data, over, torch.float32, True,
                                      **kw), floor, fused))
        for b in range(0, B, max(1, B // 3)):
            fb, Ab, bub, blb = (v[b] for v in f64)
            fv = float(fb @ xs[b])
            one = dt.linprog(fb, Ab, bub, blb, ms=ms, dtype=torch.float64,
                             device="cpu")
            natv = NativeModel(None, fb, Ab, bub, blb, ms=ms).solve()
            orc = oracle("prox_numpy").linprog(fb, Ab, bub, blb, ms=ms)
            for who, flag, val in (("single", one.exitflag, float(one.fval)),
                                   ("native", natv["exitflag"],
                                    natv["fval"]),
                                   ("oracle (reference)", orc["exitflag"],
                                    float(orc["fval"]))):
                if flag != 1 or abs(val - fv) > 1e-5 * (1 + abs(fv)):
                    self.note("lp", seed, who, n, m, ms, b, int(flag), val,
                              fv)

    def miqp(self, seed):
        """``fuzz_differential.check_miqp``: node waves (K1, K2) against
        the f64 single branch and bound on a sample of lanes (flag; fval
        within 2e-3 (1 + |fval|)), and the C library and
        ``oracle/bnb_numpy.py`` against it (1e-6)."""
        rng = np.random.default_rng(seed)
        n = int(rng.integers(4, 14))
        m = int(rng.integers(n + 4, 2 * n + 12))
        nb = int(rng.integers(1, min(6, n)))
        B = self.lanes(128)
        Q = rng.standard_normal((B, n, n)).astype(np.float32)
        H = np.einsum('bij,bkj->bik', Q, Q) + 0.5 * np.eye(n,
                                                           dtype=np.float32)
        f = (8 * rng.standard_normal((B, n))).astype(np.float32)
        A = rng.standard_normal((B, m, n)).astype(np.float32)
        bu = (15 * rng.random((B, m))).astype(np.float32)
        bl = (-15 * rng.random((B, m))).astype(np.float32)
        A[:, :nb] = 0.0
        A[:, np.arange(nb), np.arange(nb)] = 1.0
        bu[:, :nb], bl[:, :nb] = 1.0, 0.0
        sense = np.zeros((B, m), np.int32)
        sense[:, :nb] = dt.BINARY
        data = (H, f, A, bu, bl, sense)
        over = {"iter_limit": 2000}
        ones = {}
        for b in range(0, B, max(1, B // 8)):
            p = [v[b].astype(np.float64) for v in data[:5]]
            one = ones[b] = self.single64(*p, sense[b])
            natv = NativeModel(*p, sense[b], ms=0).solve_miqp()
            orc = oracle("bnb_numpy").solve_miqp(*p, sense[b], ms=0)
            ref = float(one.fval)
            for who, flag, val in (("native", natv["exitflag"],
                                    natv["fval"]),
                                   ("oracle", orc["exitflag"],
                                    float(orc["fval"]))):
                if flag != one.exitflag or (one.exitflag == 1 and abs(
                        val - ref) > 1e-6 * (1 + abs(ref))):
                    self.note("miqp", seed, who, n, m, nb, b, int(flag),
                              val, ref)

        def gate(res):
            flags, fv = res[0], res[3]
            bad = {}
            for b, one in ones.items():
                ref = float(one.fval)
                if flags[b] != one.exitflag:
                    bad[b] = ("flag", int(flags[b]), one.exitflag)
                elif one.exitflag == 1 and \
                        abs(fv[b] - ref) > 2e-3 * (1 + abs(ref)):
                    bad[b] = ("fval", float(fv[b]), ref)
            return bad

        kw = dict(bin_ids=tuple(range(nb)))
        self.judge("miqp", seed, ("waves", n, m, nb),
                   gate(self.solve("miqp", data, over, torch.float32, **kw)),
                   lambda: gate(self.solve("miqp", data, over, torch.float32,
                                           True, **kw)))

    def single(self, seed):
        """``quadprog`` in f64 against the constructed optimum (flag 1
        within 1e-6 max(1, sqrt(kappa / 100))) and
        ``oracle/daqp_numpy.py`` (its flag, x within the same)."""
        rng = np.random.default_rng(seed)
        for _ in range(2 if self.small else 8):
            n = int(rng.integers(2, 20))
            m = int(rng.integers(n + 1, 3 * n + 6))
            ms = int(rng.integers(0, n + 1))
            kappa = float(10 ** rng.integers(1, 5))
            x, H, f, A, bu, bl, sense = generate_test_qp(
                n, m, ms, int(rng.integers(1, n + 1)), kappa, rng)
            tol = 1e-6 * max(1.0, np.sqrt(kappa / 100))

            def gate(flag, xs):
                err = float(np.linalg.norm(xs - x))
                return {0: (flag, err)} if flag != 1 or err > tol else {}

            r = self.single64(H, f, A, bu, bl, sense, ms=ms)
            self.judge("single", seed, (n, m, ms, kappa),
                       gate(r.exitflag, host(r.x)),
                       lambda: gate(*(lambda j: (int(j.exitflag),
                                                 np.asarray(j.x)))(
                           self.jax.dq.quadprog(H, f, A, bu, bl, sense,
                                                ms=ms))))
            orc = oracle("daqp_numpy").quadprog(H, f, A, bu, bl, sense,
                                                ms=ms)
            if orc["exitflag"] != r.exitflag or np.linalg.norm(
                    np.asarray(orc["x"]) - host(r.x)) > tol:
                self.note("single", seed, "oracle", n, m, ms, kappa,
                          orc["exitflag"], r.exitflag)

    def native(self, seed):
        """The C library against the f64 single solve: a QP with equality
        and SOFT rows, cold and after a warm ``update(f=...)`` (flag,
        ||dx||_2 and |dfval| / (1 + |fval|) within 1e-8 max(1,
        sqrt(kappa / 100))), and a MIQP (flag, fval within 1e-6)."""
        rng = np.random.default_rng(seed)
        n = int(rng.integers(2, 16))
        m = int(rng.integers(n + 1, 3 * n + 6))
        ms = int(rng.integers(0, n + 1))
        kappa = float(10 ** rng.integers(1, 4))
        x, H, f, A, bu, bl, sense = generate_test_qp(
            n, m, ms, int(rng.integers(1, n + 1)), kappa, rng)
        sense = sense.copy()
        sense[rng.random(m) < 0.1] |= dt.SOFT
        tol = 1e-8 * max(1.0, np.sqrt(kappa / 100))
        mdl = NativeModel(H, f, A, bu, bl, sense, ms=ms)
        for step in ("cold", "warm"):
            out = mdl.solve()

            def gate(flag, xs, fval):
                if flag != out["exitflag"]:
                    return {0: ("flag", flag, out["exitflag"])}
                if flag > 0 and (np.linalg.norm(out["x"] - xs) > tol or abs(
                        out["fval"] - fval) > tol * (1 + abs(fval))):
                    return {0: ("x", float(np.linalg.norm(out["x"] - xs)))}
                return {}

            one = self.single64(H, f, A, bu, bl, sense, ms=ms)
            self.judge("native", seed, (step, n, m, ms, kappa),
                       gate(one.exitflag, host(one.x), float(one.fval)),
                       lambda: gate(*(lambda j: (int(j.exitflag),
                                                 np.asarray(j.x),
                                                 float(j.fval)))(
                           self.jax.dq.quadprog(H, f, A, bu, bl, sense,
                                                ms=ms))))
            f = f * (1.0 + 1e-3 * rng.standard_normal(n))
            mdl.update(f=f, bupper=bu, blower=bl)
        Mx = rng.standard_normal((6, 6))
        H, f, A, bu, bl, sense = Mx.T @ Mx + 0.1 * np.eye(6), \
            10 * rng.standard_normal(6), rng.standard_normal((14, 6)), \
            15 * rng.random(14), -15 * rng.random(14), np.zeros(14, np.int32)
        A[:4] = 0.0
        A[np.arange(4), np.arange(4)] = 1.0
        bu[:4], bl[:4], sense[:4] = 1.0, 0.0, dt.BINARY
        out = NativeModel(H, f, A, bu, bl, sense, ms=0).solve_miqp()
        one = self.single64(H, f, A, bu, bl, sense)
        if out["exitflag"] != one.exitflag or (one.exitflag == 1 and abs(
                out["fval"] - float(one.fval)) > 1e-6):
            self.note("native", seed, "miqp", out["exitflag"],
                      one.exitflag)

    def export(self, seed):
        """The program of ``export_aot`` (one a shape, traced once) against
        the eager flat tier on the same lanes, with equality rows: the
        same flags, iterations and x bit for bit (the same torch ops in
        the same order).  ``--jax`` does not trace the JAX package's
        program here."""
        rng = np.random.default_rng(seed)
        shapes = ((6, 14, 2), (12, 30, 0), (20, 50, 5))
        n, m, ms = shapes[int(rng.integers(0, 1 if self.small
                                           else len(shapes)))]
        B = self.lanes(256)
        d = generate_test_qp_batch(B, n, m, ms, int(rng.integers(1, n)),
                                   float(10 ** rng.integers(1, 4)),
                                   rng=seed, dtype=np.float32)
        bu, bl = d['bupper'].copy(), d['blower'].copy()
        for b in range(0, B, 7):
            r = ms + int(rng.integers(0, m - ms))
            bu[b, r] = bl[b, r] = 0.5 * (bu[b, r] + bl[b, r])
        args = [self.t(v) for v in (d['H'], d['f'], d['A'], bu, bl,
                                    d['sense'])]
        st = dt.as_settings({"iter_limit": 1000}, torch.float32)
        key = (n, m, ms, B)
        if key not in self._programs:
            blob = codegen.export_aot(n, m, ms, batch=B, settings=st,
                                      device=self.dev)
            self._programs[key] = torch.export.load(
                io.BytesIO(blob)).module()
        out = self._programs[key](*args)
        ref = pb.solve_batch_flat_jit(*args, st, ms=ms)
        differ = np.flatnonzero(
            (host(out["exitflag"]) != host(ref.exitflag))
            | (host(out["iterations"]) != host(ref.iterations))
            | (host(out["x"]) != host(ref.x)).any(1))
        if differ.size:
            self.note("export", seed, n, m, ms, differ.tolist()[:8])

    # -- running -------------------------------------------------------------
    def run(self, family, seed):
        """One instance of ``family``; an exception is a finding too."""
        try:
            getattr(self, family)(seed)
        except Exception as e:  # noqa: BLE001 - a crash is a finding
            self.note(family, seed, "exception", repr(e)[:300])
        self.instances[family] += 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("seconds", nargs="?", type=float, default=600.0)
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--jax", action="store_true")
    ap.add_argument("--seed", type=int, default=100000)
    ap.add_argument("--families", nargs="+", default=list(FAMILIES),
                    choices=FAMILIES)
    a = ap.parse_args(argv)
    if a.jax and a.device != "cpu":
        ap.error("--jax runs on the CPU only")
    fz = Fuzzer(a.device, jax=a.jax)
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < a.seconds:
        fam = a.families[i % len(a.families)]
        seed = a.seed + i
        fz.run(fam, seed)
        i += 1
        print(f"round {i} {fam} seed {seed}: {len(fz.findings)} findings, "
              f"{time.perf_counter() - t0:.0f} s", flush=True)
    summary = dict(device=a.device, seconds=time.perf_counter() - t0,
                   rounds=i, instances=fz.instances,
                   findings=len(fz.findings))
    if a.device == "cuda":
        summary["card"] = torch.cuda.get_device_name(0)
    for it in fz.findings:
        print(" -", it, flush=True)
    for it in fz.census:
        print(" census", it, flush=True)
    print(json.dumps({"fuzz_torch": summary}), flush=True)
    return 1 if fz.findings else 0


if __name__ == "__main__":
    sys.exit(main())
