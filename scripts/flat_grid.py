"""The reference benchmark grid as batches through the port's flat tier.

The sizes and generator of ``scripts/grid_accuracy.py`` (benchmark.jl's
suite: ``generate_test_qp(n, m, ms, active, 1e2)``, rng 1000 + n), B
QPs a size, solved as one batch by ``daqp_tpu_torch.solve_batch`` (which
sends these shapes to the flat tier) in f32 or f64.  Prints one JSON
line a size: exit flags, iterations, the flat tier's rounds and host
reads, ||x - x_ref||_2 per lane and the wall.  ``--single`` also solves
the first lane through the single-instance ``quadprog`` in f64 (the
backstop's path), ``--jax`` the same lanes through the JAX package's
``solve_batch_flat_jit`` on the CPU.  Runs on the CPU (the kernels'
plain twins) unless ``--device cuda``.

    python scripts/flat_grid.py --sizes 100 200 500 --dtype float32
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import daqp_tpu_torch as dt  # noqa: E402
from daqp_tpu_torch import ldp_flat, ops  # noqa: E402
from tests.gen import generate_test_qp  # noqa: E402

# scripts/grid_accuracy.py:22-23: (n, m, ms, active); B lanes a size
GRID = {10: (50, 5, 8, 64), 50: (250, 25, 40, 64), 100: (500, 50, 80, 64),
        200: (1000, 100, 160, 16), 500: (2500, 250, 400, 8)}


def grid_batch(n, lanes=None):
    m, ms, nact, B = GRID[n]
    rng = np.random.default_rng(1000 + n)
    probs = [generate_test_qp(n, m, ms, nact, 1e2, rng)
             for _ in range(lanes or B)]
    return ms, [np.stack(v) for v in zip(*probs)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=[100, 200, 500])
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--lanes", type=int, default=None)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--single", action="store_true")
    ap.add_argument("--jax", action="store_true")
    a = ap.parse_args()
    np_dt = np.dtype(a.dtype)
    for n in a.sizes:
        ms, (x, H, f, A, bu, bl, sense) = grid_batch(n, a.lanes)
        data = [v.astype(np_dt) for v in (H, f, A, bu, bl)]
        args = [torch.as_tensor(v, device=a.device) for v in data] \
            + [torch.as_tensor(sense, device=a.device)]
        ops.host_syncs = ldp_flat.rounds = 0
        t = time.perf_counter()
        r = dt.solve_batch(*args, ms=ms)
        wall = time.perf_counter() - t
        err = np.linalg.norm(r.x.cpu().numpy().astype(np.float64) - x,
                             axis=1)
        rec = dict(n=n, B=len(x), dtype=a.dtype, device=a.device,
                   flags=r.exitflag.cpu().tolist(),
                   iterations=r.iterations.cpu().tolist(),
                   rounds=ldp_flat.rounds, host_syncs=ops.host_syncs,
                   errs=[float(f"{e:.3e}") for e in err], wall_s=wall)
        if a.single:
            ops.host_syncs = 0
            t = time.perf_counter()
            one = dt.quadprog(*(v[0].astype(np.float64) for v in data),
                              sense[0], ms=ms, dtype=torch.float64,
                              device=a.device)
            rec["single_f64"] = dict(
                flag=one.exitflag, iterations=one.iterations,
                host_syncs=ops.host_syncs,
                err=float(np.linalg.norm(one.x.cpu().numpy() - x[0])),
                wall_s=time.perf_counter() - t)
        if a.jax:
            import jax
            import jax.numpy as jnp
            jax.config.update("jax_platforms", "cpu")
            jax.config.update("jax_enable_x64", True)
            from daqp_tpu import batch as jbatch
            from daqp_tpu.api import _as_settings
            jd = jnp.float32 if np_dt == np.float32 else jnp.float64
            rj = jbatch.solve_batch_flat_jit(
                *(jnp.asarray(v) for v in data), jnp.asarray(sense),
                _as_settings(None, jd), ms=ms)
            rec["jax_flat"] = dict(
                flags=np.asarray(rj.exitflag).tolist(),
                iterations=np.asarray(rj.iterations).tolist(),
                errs=[float(f"{e:.3e}") for e in np.linalg.norm(
                    np.asarray(rj.x, np.float64) - x, axis=1)])
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
