#!/usr/bin/env python3
"""Config 3's margin: how far from the f64 optimum its flag-1 steps sit.

Run from the repository root:

    python3 scripts/mpc_margin.py                    # the port on the card
    python3 scripts/mpc_margin.py --device cpu       # the port's twins
    JAX_PLATFORMS=cpu python3 scripts/mpc_margin.py --jax   # the JAX package

For each data seed (default 7, 11 and 13; 7 is config 3's), config 3's
generator (``chip_smoke.config3``: one QP at n = 50, m = 100, drifting
over 512 scenarios x 20 steps) gives the horizon; its first S = 128
scenarios run through the fused warm horizon (seg 10, 192-step rounds,
iteration limit 1000, f32): the port's
``solve_mpc_scan_kernel_fused`` (B3 and K2 on a card, their twins on
the CPU), or with ``--jax`` the JAX package's
``solve_mpc_scan_pallas_fused`` in interpret mode on the CPU (it takes
S in multiples of 128).  Every step of the first 64 scenarios (64 x 20)
is solved again by the f64 oracle (``oracle/daqp_numpy.py``), and the
script prints, per seed, the largest ||x - x_ref||_2 among the flag-1
steps, how many flag-1 steps lie past chip_smoke's mpc gate (2e-3) and
past 1e-3, the five largest with their (scenario, step), and the flags'
census.  The port's side imports nothing of JAX.  Each line is one JSON
object; the last names the device.
"""
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

S_RUN = 128             # scenarios solved (the JAX tier's lane tile)
S_HELD = cs.MARGIN_LANES  # scenarios held against the oracle, all T3 steps


def port_x(d3, dev):
    import torch
    import daqp_tpu_torch as dt
    st = dt.as_settings({"iter_limit": 1000}, torch.float32)
    args = [torch.as_tensor(d3[k][:S_RUN] if k.endswith("seq") else d3[k],
                            device=dev)
            for k in ('H', 'A', 'f_seq', 'bu_seq', 'bl_seq')]
    out = dt.solve_mpc_scan_kernel_fused(*args, st, seg=cs.SEG3,
                                         steps=cs.STEPS)
    return out.x.cpu().numpy(), out.exitflag.cpu().numpy()


def jax_x(d3):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from daqp_tpu import mpc
    from daqp_tpu.api import _as_settings
    st = _as_settings({"iter_limit": 1000}, jnp.float32)
    out = mpc.solve_mpc_scan_pallas_fused(
        *(jnp.asarray(d3[k][:S_RUN] if k.endswith("seq") else d3[k])
          for k in ('H', 'A', 'f_seq', 'bu_seq', 'bl_seq')),
        st, seg=cs.SEG3, steps=cs.STEPS, interpret=True)
    return np.asarray(out.x), np.asarray(out.exitflag)


def main():
    args = sys.argv[1:]
    use_jax = "--jax" in args
    seeds = [int(v) for v in args if v.isdigit()] or [7, 11, 13]
    dev = args[args.index("--device") + 1] if "--device" in args else "cuda"
    if not use_jax:
        import torch
        if dev == "cuda" and not torch.cuda.is_available():
            print("mpc_margin: no CUDA device", file=sys.stderr)
            return 2
    gen = cs.load("daqp_test_gen", "tests/gen.py")
    oracle = cs.load("daqp_oracle", "oracle/daqp_numpy.py")
    for seed in seeds:
        d3 = cs.config3(gen, seed=seed)
        t0 = time.perf_counter()
        x, flags = jax_x(d3) if use_jax else port_x(d3, dev)
        solve_s = time.perf_counter() - t0
        err, ref_flags = cs.oracle_grid(oracle, d3, x, range(S_HELD),
                                        range(cs.T3))
        fl = flags[:S_HELD]
        one = fl == 1
        e1 = np.where(one, err, -1.0)
        order = np.argsort(-e1, axis=None)[:5]
        print(json.dumps(dict(
            side="jax" if use_jax else f"port ({dev})", seed=seed,
            S_run=S_RUN, lanes=S_HELD, steps=cs.T3,
            max_err_flag1=float(err[one].max()) if one.any() else None,
            flag1_steps=int(one.sum()),
            flag1_past_gate=int((one & (err > cs.MPC_TOL)).sum()),
            flag1_past_1e3=int((one & (err > 1e-3)).sum()),
            largest=[dict(s=int(i // cs.T3), t=int(i % cs.T3),
                          err=float(err.flat[i]), flag=int(fl.flat[i]))
                     for i in order],
            flags={int(k): int(v) for k, v in
                   zip(*np.unique(fl, return_counts=True))},
            oracle_optimal=int((ref_flags == 1).sum()),
            solve_s=solve_s, seconds=time.perf_counter() - t0)),
            flush=True)
    if use_jax or dev == "cpu":
        print("device: cpu", flush=True)
    else:
        print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
