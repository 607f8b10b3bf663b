"""``BENCHMARK.json`` against the benchmark's contract, and the harness
finding every piece by name."""
import json
import re
import shutil
from pathlib import Path

import pytest

from harness import manifest

ROOT = manifest.ROOT
BENCH = manifest.BENCH
M = manifest.load()
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert set(M) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert 1 <= len(M["command"]) <= 32
    assert all(_line(w) for w in M["command"])
    named = [w for w in M["command"] if "/" in w]
    assert named and all(any(w.startswith(p + "/") for p in M["paths"])
                         for w in named)


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in M[group]:
            assert manifest.NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
    metric_names = [n for is_m, n in names if is_m]
    assert len(set(metric_names)) == len(metric_names)
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in M[group]}) == len(M[group])
    for m in M["end_to_end"] + M["per_layer"]:
        assert manifest.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in M["configs"]:
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(manifest.NAME.match(k) for k in c["reduced"])
    for w in M["workloads"]:
        assert _line(w["why"])
        assert manifest.NAME.match(w["config"])
        assert manifest.NAME.match(w["traffic"])
    for m in M["per_layer"]:
        assert _line(m["layer"])


def test_entries_have_just_their_keys():
    allowed = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source",
                       "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"},
    }
    for group, keys in allowed.items():
        for e in M[group]:
            assert set(e) <= keys, (group, e["name"], set(e) - keys)


def test_cells_configs_and_metrics_fit_together():
    configs = {c["name"]: c for c in M["configs"]}
    cells = {w["name"] for w in M["workloads"]}
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert 1 <= len(configs) <= 24 and 1 <= len(cells) <= 24
    assert len({(w["config"], w["traffic"]) for w in M["workloads"]}) \
        == len(cells)
    used = {w["config"] for w in M["workloads"]}
    assert used == set(configs)
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= 1
    assert all(w["chips"] in (1, 4) for w in M["workloads"])
    files = [c["file"] for c in configs.values()]
    assert len(set(files)) == len(files)
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in M["workloads"]:
        reported = [m for m in M["end_to_end"]
                    if w["name"] in m.get("workloads", cells)]
        assert any(m["name"] == "setup_s" for m in reported)
        assert any(m["name"] != "setup_s" for m in reported)
        assert any(w["name"] in m.get("workloads", cells)
                   for m in M["per_layer"])


def test_run_seconds_fit_the_check_with_24_cells():
    r = M["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_config_files_hold_their_reductions():
    for c in M["configs"]:
        f = manifest.load_json(ROOT / c["file"])
        assert f["reduced"] == c["reduced"]
        assert (ROOT / c["file"]).resolve().is_relative_to(BENCH)


@pytest.mark.parametrize("workload", [w["name"] for w in M["workloads"]])
def test_every_piece_loads_by_name(workload):
    cell = manifest.Cell(M, workload)
    assert callable(cell.entry.call) and callable(cell.entry.prepare)
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.readers[m["name"]].read)
    for rule in cell.limits.values():
        if isinstance(rule, dict) and ("min" in rule or "max" in rule):
            assert ("min" in rule) != ("max" in rule)
    assert cell.config["gate"] > 0


NEW_ENTRY = '''
import torch
OPTIMAL = (1, 2)
def prepare(item, config, traffic):
    return (item,), {}
def call(args, kwargs):
    item = args[0]
    return item["H"][:, 0].cpu(), torch.ones(item["H"].shape[0]), \\
        torch.zeros(item["H"].shape[0])
'''
NEW_METRIC = '''
def read(ctx):
    return float(ctx.calls)
'''


def test_a_new_cell_is_files_and_entries_only(tmp_path):
    """A configuration, a traffic mix, an entry, a metric and a cell's
    limits added to a copy as files, with their entries in its manifest,
    are found with no edit of an existing file."""
    bench = tmp_path / "qpbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = dict(manifest.load_json(BENCH / "configs" / "dense50.json"),
               n=20, m=40, n_active=10)
    (bench / "configs" / "small20.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "tiny.json").write_text(json.dumps(
        {"entry": "echo", "batch": 4, "pool": 2, "settings": {}}))
    (bench / "entries" / "echo.py").write_text(NEW_ENTRY)
    (bench / "metrics" / "calls_seen.py").write_text(NEW_METRIC)
    (bench / "cells" / "small20.tiny.json").write_text(json.dumps(
        {"pass_share": {"min": 0.0}}))
    m["configs"].append({"name": "small20", "source": "a test",
                         "file": "qpbench/configs/small20.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "small20.tiny", "config": "small20",
                           "traffic": "tiny", "chips": 1, "why": "a test"})
    m["per_layer"].append({"name": "calls_seen", "unit": "calls",
                           "better": "higher", "source": "host_clock",
                           "layer": "entry", "moves": "qp_per_s",
                           "workloads": ["small20.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    cell = manifest.Cell(manifest.load(tmp_path), "small20.tiny", bench)
    assert cell.config["n"] == 20 and cell.traffic["entry"] == "echo"
    assert [p["name"] for p in cell.per_layer][-1] == "calls_seen"
    assert cell.readers["calls_seen"].read(type("C", (), {"calls": 3})) == 3
    for p, data in before.items():
        assert p.read_bytes() == data
