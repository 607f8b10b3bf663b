"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  Each lives in a file of its own under the benchmark's folder:

* ``configs/<config>.json``: the deployment (the generator's shape, the
  served type, the accuracy gate), the file that ``configs[].file`` names;
* ``traffic/<mix>.json``: what one call carries (QPs or scenarios, the
  pool of distinct inputs, soft rows, settings) and the entry it drives;
* ``entries/<entry>.py``: the adapter of one entry point of the port;
* ``cells/<workload>.json``: the limits of the numbers that decide
  ``correct`` in that cell, with the readings they were set from;
* ``metrics/<metric>.py``: the reader of one metric, end to end or per
  layer.

Adding any of them is adding a file and an entry of ``BENCHMARK.json``:
nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]       # the benchmark's folder
ROOT = BENCH.parent                                # the checkout

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(kind: str, name: str, folder: Path | None = None):
    """``<folder>/<kind>/<name>.py`` as a module of its own (by path: no
    package of that name is needed, and none can shadow it)."""
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r}")
    path = (folder or BENCH) / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"qpbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of the manifest with everything it names."""

    def __init__(self, manifest: dict, workload: str,
                 folder: Path | None = None):
        folder = folder or BENCH
        cells = {w["name"]: w for w in manifest["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.workload = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = load_json(folder.parent / self.config_entry["file"])
        self.traffic = load_json(folder / "traffic"
                                 / f"{self.workload['traffic']}.json")
        self.limits = load_json(folder / "cells" / f"{workload}.json")
        self.entry = load_module("entries", self.traffic["entry"], folder)
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in manifest["per_layer"]
                          if workload in m.get("workloads", [workload])]
        self.readers = {m["name"]: load_module("metrics", m["name"], folder)
                        for m in self.end_to_end + self.per_layer}


def load(root: Path | None = None) -> dict:
    return load_json((root or ROOT) / "BENCHMARK.json")
