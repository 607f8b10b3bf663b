"""The run's output: its exit without a card, its last line's keys, and
the checks as the last lines on standard error."""
import json
import subprocess
import sys

import numpy as np
import pytest

from harness import manifest, runner
from harness import trace as tr

RUN = str(manifest.BENCH / "run.py")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_no_card_exits_nonzero_without_a_result(tmp_path):
    if __import__("torch").cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, RUN, "--workload", "dense50.cold",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=manifest.ROOT)
    assert out.returncode == 2 and out.stdout == ""


def test_a_missing_tmpdir_is_made_for_the_build(tmp_path):
    """nvcc fails where TMPDIR does not exist: the run makes it first."""
    import os
    tmp = tmp_path / "given" / "tmp"
    subprocess.run([sys.executable, RUN, "--workload", "dense50.cold",
                    "--seed", "1", "--seconds", "1", "--trace", "0"],
                   capture_output=True, text=True, timeout=300,
                   cwd=manifest.ROOT, env=dict(os.environ, TMPDIR=str(tmp),
                                               CUDA_VISIBLE_DEVICES=""))
    assert tmp.is_dir()


def test_no_port_exits_nonzero_without_a_result(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files
    the run stops before any result (the port is not there)."""
    import shutil
    shutil.copytree(manifest.BENCH, tmp_path / "qpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "qpbench/run.py", "--workload",
                          "dense50.cold", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def _cpu_run(workload, trace):
    cell = manifest.Cell(manifest.load(), workload)
    return runner.run(cell, 2 ** 31 + 11, 0.2, trace, 0.0, device="cpu",
                      overrides=dict(batch=16, pool=2))


@pytest.mark.parametrize("workload",
                         [w["name"] for w in manifest.load()["workloads"]])
def test_untraced_line(workload):
    r = _cpu_run(workload, False)
    assert list(r) == KEYS + ["checks"]
    assert set(r["metrics"]) == {"qp_per_s", "setup_s"}
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] % 16 == 0
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}


def _fake_trace(prof=None):
    ns = 10 ** 6
    dev = (["void slot_round_kernel(Ptrs, int)", "Memcpy DtoH (Device)"],
           [1 * ns, 5 * ns], [3 * ns, 6 * ns])
    host = (["qpbench:ops.slot.slot_solve", "aten::item"],
            [0, 3 * ns], [10 * ns, 4 * ns], [True, False])
    return tr.Trace(0, 10 * ns, dev, host)


class _FakeProfiler:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_traced_line(monkeypatch):
    """A traced run's line as the card gives it, its two profiles stood
    in for: three windows, the per-layer metrics, the breakdown."""
    monkeypatch.setattr(runner, "_profiler", lambda dev, with_host:
                        _FakeProfiler())
    monkeypatch.setattr(tr, "device_trace", lambda prof, s: _fake_trace())
    monkeypatch.setattr(tr, "from_profiler", _fake_trace)
    cell = manifest.Cell(manifest.load(), "dense50.cold")
    r = runner.run(cell, 5, 0.2, True, 0.0, device="cpu",
                   overrides=dict(batch=16, pool=2))
    line = json.loads(json.dumps(r))
    assert list(line) == KEYS + ["breakdown", "checks"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["busy_s"] == pytest.approx(3e-3)
    assert line["device"]["window_s"] == pytest.approx(1e-2)
    # call_p95_ms needs two calls in the first window, which a slow CPU
    # may not make in 0.2 s
    assert set(line["metrics"]) - {"call_p95_ms"} == {
        "host_syncs_per_call", "own_launches_per_call", "iterations_mean",
        "launches_per_call", "device_idle_share"}
    assert line["metrics"]["device_idle_share"]["value"] == \
        pytest.approx(70.0)
    assert line["correct"] is True


def test_counters_come_from_the_untraced_window(monkeypatch):
    """The host clock's and the counters' readers read the first window,
    which runs untraced: its calls alone, not the traced windows'."""
    monkeypatch.setattr(runner, "_profiler", lambda dev, with_host:
                        _FakeProfiler())
    monkeypatch.setattr(tr, "device_trace", lambda prof, s: _fake_trace())
    monkeypatch.setattr(tr, "from_profiler", _fake_trace)
    seen = {}
    read = runner.Context.__init__

    def spy(self, answers, latencies_s, *a, **k):
        read(self, answers, latencies_s, *a, **k)
        seen.update(calls=self.calls, lat=len(latencies_s),
                    trace_calls=self.trace_calls)
    monkeypatch.setattr(runner.Context, "__init__", spy)
    cell = manifest.Cell(manifest.load(), "dense50.cold")
    r = runner.run(cell, 5, 0.2, True, 0.0, device="cpu",
                   overrides=dict(batch=16, pool=2))
    assert seen["calls"] == seen["lat"] >= 1 and seen["trace_calls"] >= 1
    assert r["attempted"] > 16 * (seen["calls"] + seen["trace_calls"])


def test_trace_reduction():
    t = _fake_trace(None)
    assert t.window_s == pytest.approx(0.01)
    assert t.busy_s == pytest.approx(0.003)
    assert t.kernel_s("slot_round_kernel") == pytest.approx(0.002)
    assert t.kernel_launches == 1
    assert t.device_ops()[0] == ["slot_round_kernel", pytest.approx(0.002)]
    gaps = dict(t.idle_gaps_by_label())
    assert gaps["ops.slot.slot_solve > aten::item"] == pytest.approx(0.002)
    assert gaps["ops.slot.slot_solve > python"] == pytest.approx(0.005)
    assert tr.kernel_id("void chol_rinv_kernel<2, 1>(float const*)") \
        == "chol_rinv_kernel"
    s, e = t.busy_intervals()
    assert np.array_equal(e - s, [2 * 10 ** 6, 10 ** 6])


def test_main_prints_the_result_last_and_the_checks_on_stderr(
        monkeypatch, capsys):
    import torch
    sys.path.insert(0, str(manifest.BENCH))
    import run as run_mod
    fake = {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
            "device": {}, "checks": {"pass_share": {"value": 1.0,
                                                    "min": 0.999,
                                                    "ok": True}}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(runner, "run", lambda *a, **k: fake)
    assert run_mod.main(["--workload", "dense50.cold", "--seed", "1",
                         "--seconds", "1", "--trace", "0"]) == 0
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == fake
    assert err.strip().splitlines()[-1] == "check pass_share 1.0 >= 0.999 ok"
