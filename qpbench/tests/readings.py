#!/usr/bin/env python3
"""Readings of the numbers that decide ``correct``, seed after seed in one
process, at a cell's own size: the port's (one call per pool item, as the
window makes them) and, with ``--control``, the control's: the reference
computed with TF32 products (``reference/ipm.py``, precision "tf32") put
in the port's place, its every answer flagged optimal.

    python3 qpbench/tests/readings.py --workload dense50.cold \
        --seeds 11 12 13 [--control] [--device cuda]

One JSON line a seed.  The limits in ``cells/<workload>.json`` are set
from these readings; the benchmark's own runs never run the control.
"""
import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH.parent), str(BENCH)]

import torch  # noqa: E402

from harness import data, judge, manifest  # noqa: E402


def readings(cell, seed, device, control, overrides=None):
    config, traffic = cell.config, dict(cell.traffic, **(overrides or {}))
    t0 = time.perf_counter()
    pool = data.make_pool(config, traffic, seed, device)
    prepared = [cell.entry.prepare(it, config, traffic) for it in pool]
    cell.entry.call(*prepared[0])                      # warm
    answers = [(p, cell.entry.call(*a)) for p, a in enumerate(prepared)]
    del prepared
    t1 = time.perf_counter()
    refs, unc = judge.reference_answers(config, traffic, pool)
    out = {"seed": seed, "port": judge.numbers(
        answers, refs, cell.entry.OPTIMAL, config["gate"], unc)}
    flags, counts = torch.unique(torch.cat([a[1][1] for a in answers]),
                                 return_counts=True)
    out["flags"] = dict(zip(map(int, flags), map(int, counts)))
    t2 = time.perf_counter()
    if control:
        xs, _ = judge.reference_answers(config, traffic, pool,
                                        precision="tf32")
        ctrl = [(p, (x.float().cpu(), torch.ones(x.shape[0],
                                                 dtype=torch.int32), None))
                for p, x in enumerate(xs)]
        out["control"] = judge.numbers(ctrl, refs, (1,), config["gate"], 0)
    out["seconds"] = {"port": t1 - t0, "reference": t2 - t1,
                      "control": time.perf_counter() - t2}
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    cell = manifest.Cell(manifest.load(), a.workload)
    for seed in a.seeds:
        print(json.dumps(readings(cell, seed, a.device, a.control)),
              flush=True)


if __name__ == "__main__":
    main()
