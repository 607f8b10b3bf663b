"""The two graph forms of the flat tier's round that ``torch.export`` can
trace, side by side: the inner ``INNER_STEPS`` steps as a nested
``while_loop`` (``ldp_flat.flat_solve_graph``, what ``export_aot``
ships) or unrolled into the round's body (defined here only).  For each
it prints the export wall, the saved program's bytes, its graph nodes
(loops' graphs included), and the loaded program's first and second
wall on a batch of config 2's generator (seed 2026, f32), whose result
must equal the eager ``solve_batch_flat_jit`` lane for lane.

    python scripts/export_forms.py [--device cuda|cpu] [--lanes B]
"""
import argparse
import importlib.util
import io
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import daqp_tpu_torch as dt  # noqa: E402
from daqp_tpu_torch import batch, codegen, ldp_flat  # noqa: E402


def _gen():
    """``tests/gen.py`` by path: an installed package named ``tests`` may
    shadow the repository's test directory."""
    spec = importlib.util.spec_from_file_location(
        "export_forms_gen", os.path.join(ROOT, "tests", "gen.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def unrolled_solve_graph(s, st):
    """``flat_solve_graph`` with each round's steps unrolled."""
    limit = int(st.iter_limit)

    def live_of(s1):
        return (s1.status == ldp_flat.EXIT_RUNNING) & (s1.iterations < limit)

    r, s = ldp_flat._state_loop(
        s, lambda r, s1: (r < ldp_flat.MAX_ROUNDS) & live_of(s1).any(),
        lambda r, s1: ldp_flat._flat_round(s1, st, live_of(s1)),
        torch.zeros((), dtype=torch.int64, device=s.E.device))
    return ldp_flat._flat_exit(s, limit), r


def nodes(gm):
    return len(gm.graph.nodes) + sum(nodes(c) for c in gm.children()
                                     if hasattr(c, "graph"))


def timed(fn, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    r = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return r, time.perf_counter() - t


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lanes", type=int, default=2048)
    a = ap.parse_args()
    dev = torch.device(a.device)
    n, m = 50, 100
    d = _gen().generate_test_qp_batch(a.lanes, n, m, 0, 40, 1e2,
                                      rng=2026, dtype=np.float32)
    args = [torch.as_tensor(d[k], device=dev) for k in
            ('H', 'f', 'A', 'bupper', 'blower', 'sense')]
    st = dt.as_settings({"iter_limit": 1000}, torch.float32)
    eager, eager_s = timed(lambda: batch.solve_batch_flat_jit(*args, st), dev)
    out = {"device": str(dev), "lanes": a.lanes, "eager_wall_s": eager_s}
    if dev.type == "cuda":
        out["card"] = torch.cuda.get_device_name(0)
    shipped = ldp_flat.flat_solve_graph
    for form, fn in (("nested", shipped), ("unrolled", unrolled_solve_graph)):
        ldp_flat.flat_solve_graph = fn
        try:
            blob, export_s = timed(lambda: codegen.export_aot(
                n, m, batch=a.lanes, settings=st, device=dev), dev)
        finally:
            ldp_flat.flat_solve_graph = shipped
        ep = torch.export.load(io.BytesIO(blob))
        prog = ep.module()
        r1, first_s = timed(lambda: prog(*args), dev)
        _, second_s = timed(lambda: prog(*args), dev)
        same = bool(torch.equal(r1["exitflag"], eager.exitflag)
                    and torch.equal(r1["iterations"], eager.iterations)
                    and torch.equal(r1["x"], eager.x))
        out[form] = dict(export_s=export_s, blob_bytes=len(blob),
                         graph_nodes=nodes(ep.graph_module),
                         first_wall_s=first_s, second_wall_s=second_s,
                         rounds=int(r1["rounds"]), equal_to_eager=same)
    print(json.dumps(out), flush=True)
    return 0 if out["nested"]["equal_to_eager"] \
        and out["unrolled"]["equal_to_eager"] else 1


if __name__ == "__main__":
    sys.exit(main())
