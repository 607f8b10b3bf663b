#!/usr/bin/env python3
"""The benchmark of daqp_tpu_torch, the PyTorch and CUDA port: one run of
one cell on one card.

    python3 qpbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with a CUDA card.  The cell is
an entry of ``BENCHMARK.json`` at the checkout's root; everything it names
is found by name under ``qpbench/`` (``harness/manifest.py``).  The run
makes its inputs on the card from ``--seed``, warms up, calls the port
back to back for ``--seconds`` (whole calls), then holds every answer of
the window against the plain reference (``reference/ipm.py``).

Its last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (with ``--trace 0`` the cell's
end-to-end metrics; with ``--trace 1`` its per-layer ones, read from an
untraced window of ``--seconds``, a shorter ``torch.profiler`` trace of
the card alone, and a short trace of the host beside the card for the
breakdown's labels: ``harness/runner.py``), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with its limit.  The same checks are the last lines on standard error;
before them, the host time of each stage and of each window's calls.

Exit codes other than 0, with no result: 2, no CUDA card or fewer than
the cell asks for; 3, JAX or the JAX package (``daqp_tpu``) loaded in
this process; 1, anything else that stops the run (the port absent from
the checkout among it).  Build and kernel caches stay inside the
checkout, under ``build/``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # every cache of a run at a fixed path inside the checkout (the port
    # builds its kernels into build/daqp_tpu_torch itself)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / "qpbench" / sub)
    # nvcc writes its intermediate files to TMPDIR and fails where that
    # directory does not exist
    if os.environ.get("TMPDIR"):
        os.makedirs(os.environ["TMPDIR"], exist_ok=True)
    for p in (str(ROOT), str(HERE)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    from harness import guard, manifest, runner

    bench = manifest.load(ROOT)
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(
        args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"qpbench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count = {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    cell = manifest.Cell(bench, args.workload)
    result = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                        T_START, log=lambda s: print(s, file=sys.stderr))
    banned = guard.banned_modules()
    if banned:
        print("qpbench: loaded in this process: " + ", ".join(banned),
              file=sys.stderr)
        return 3
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    for name, c in result["checks"].items():
        rule = f">= {c['min']}" if "min" in c else f"<= {c['max']}"
        print(f"check {name} {c['value']!r} {rule} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
