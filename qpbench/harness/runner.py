"""One run of one cell: set-up, the measured windows, the check.

Set-up makes the cell's pool of inputs on the device from the seed, has
the entry adapter prepare one call's arguments from each pool item, and
warms the entry with one call (every pool item has the same shapes).  A
window calls the entry back to back, one client, pool item after pool
item: it starts with the first timed call and ends when the first call
that finishes after its length finishes.

An untraced run has one window of ``seconds``: the end-to-end metrics.
A traced run has three, one after another, on the same pool:

1. ``seconds`` untraced: each call's time on the host clock, the port's
   counters and the answers' iterations, as an untraced run sees them;
2. ``TRACE_SECONDS`` under ``torch.profiler`` recording the card alone, with
   the readers' launch records laid over the port (``hooks``): the busy
   time, each kernel's time and the kernels launched;
3. ``LABEL_SECONDS`` under the profiler with the host's events and the
   adapter's spans: the labels of the card's idle gaps (``breakdown``).

After the windows: the peak of device memory is read, the program's
arguments are dropped, the reference solves each distinct QP of the pool
(``judge``) and every answer of every window is held against it.
"""
from __future__ import annotations

import json
import statistics
import time
from contextlib import nullcontext

import torch

from . import data, judge
from . import hooks as hk
from . import trace as tr

# the traced windows' lengths: the profiler's own processing after a
# window takes about as long again as the window, and a traced run has to
# end within its time limit on a slower host too
TRACE_SECONDS = 15.0
LABEL_SECONDS = 5.0


class Context:
    """What a metric's reader reads: the first window's calls, times,
    counters and iterations; the card-only trace with its calls and
    launch records (traced runs)."""

    def __init__(self, answers, latencies_s, window_s, setup_s, attempted,
                 deltas, records=None, trace=None, trace_calls=0):
        self.calls, self.latencies_s = len(answers), latencies_s
        self.window_s, self.setup_s = window_s, setup_s
        self.attempted = attempted
        self.iterations = torch.cat([a[1][2].reshape(-1) for a in answers]) \
            if answers else torch.zeros(0)
        self._deltas, self._records = deltas, records or {}
        self.trace, self.trace_calls = trace, trace_calls

    def counter(self, target: str):
        return self._deltas[target]

    def records(self, reader_name: str) -> list:
        return self._records.get(reader_name, [])


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _profiler(dev, with_host: bool):
    """A ``torch.profiler.profile`` of the card (and the host), or None
    off the card."""
    if dev.type != "cuda":
        return None
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if with_host:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    return torch.profiler.profile(activities=acts)


def _window(entry, prepared, seconds, answers, start, log, name):
    """Calls back to back from pool item ``start`` on, until the first
    call that ends after ``seconds``; appends (pool index, answer) to
    ``answers``.  Returns each call's host time and the window's length."""
    P = len(prepared)
    latencies = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = start
    while True:
        a = time.perf_counter()
        out = entry.call(*prepared[i % P])
        b = time.perf_counter()
        answers.append((i % P, out))
        latencies.append(b - a)
        i += 1
        if b >= deadline:
            break
    thirds = [latencies[k * len(latencies) // 3:
                        (k + 1) * len(latencies) // 3] for k in range(3)]
    items = [latencies[(p - start) % P::P] for p in range(P)]
    log(f"qpbench: {name}: {len(latencies)} calls in {b - t0:.3f} s; "
        "mean ms a call by third of the window: " + " / ".join(
            f"{1e3 * statistics.fmean(t):.1f}" for t in thirds if t)
        + "; by pool item: " + " / ".join(
            f"{1e3 * statistics.fmean(t):.1f}" for t in items if t))
    return latencies, b - t0


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device="cuda", overrides: dict | None = None,
        log=lambda line: None) -> dict:
    """The result of one run (the keys of the result line, ``checks``
    last), ``cell`` a ``manifest.Cell``; ``t_start`` the host clock at
    process start.  ``overrides`` replaces traffic keys (tests: smaller
    calls, the CPU); ``log`` takes a line on each stage's host time."""
    dev = torch.device(device)
    config, traffic = cell.config, dict(cell.traffic)
    traffic.update(overrides or {})
    entry = cell.entry
    marks = [("start to set-up", time.perf_counter())]
    pool = data.make_pool(config, traffic, seed, dev)
    prepared = [entry.prepare(item, config, traffic) for item in pool]
    _sync(dev)
    marks.append(("inputs", time.perf_counter()))
    entry.call(*prepared[0])
    _sync(dev)
    marks.append(("warm call", time.perf_counter()))

    readers = {m["name"]: cell.readers[m["name"]]
               for m in cell.per_layer} if trace else {}
    counters = sorted({c for r in readers.values()
                       for c in getattr(r, "COUNTERS", ())})
    before = {c: hk.read_counter(c) for c in counters}
    answers = []
    setup_s = time.perf_counter() - t_start
    latencies, window_s = _window(entry, prepared, seconds, answers, 0, log,
                                  "window")
    deltas = {c: hk.read_counter(c) - before[c] for c in counters}
    first = list(answers)
    marks.append(("window", time.perf_counter()))

    records, t_dev, t_host, dev_calls = {}, None, None, 0
    if trace:
        hooks = hk.Hooks()
        try:
            for r in readers.values():
                if hasattr(r, "LAUNCH"):
                    hooks.launches(r.LAUNCH, r.record,
                                   records.setdefault(r.__name__, []))
            prof = _profiler(dev, with_host=False)
            n0 = len(answers)
            with prof or nullcontext():
                _, dev_s = _window(entry, prepared,
                                   min(seconds, TRACE_SECONDS), answers,
                                   len(answers), log, "card-only trace")
            dev_calls = len(answers) - n0
        finally:
            hooks.restore()
        if prof is not None:
            t_dev = tr.device_trace(prof, dev_s)
            del prof
        marks.append(("card-only traced window", time.perf_counter()))
        try:
            for target in getattr(entry, "SPANS", ()):
                hooks.span(target)
            prof = _profiler(dev, with_host=True)
            with prof or nullcontext():
                with torch.profiler.record_function(tr.WINDOW):
                    _window(entry, prepared, min(seconds, LABEL_SECONDS),
                            answers, len(answers), log, "host and card trace")
        finally:
            hooks.restore()
        if prof is not None:
            t_host = tr.from_profiler(prof)
            del prof
        marks.append(("labelled traced window", time.perf_counter()))

    memory_peak = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    del prepared
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    qpc = data.qps_per_call(config, traffic)
    attempted = len(answers) * qpc
    opt = torch.tensor(sorted(entry.OPTIMAL))
    failed = sum(qpc - int(torch.isin(out[1].to(torch.int64), opt).sum())
                 for _, out in answers)
    flags, counts = torch.unique(torch.cat([out[1].reshape(-1).to(
        torch.int64) for _, out in answers]), return_counts=True)
    log("qpbench: exit flags " + json.dumps(dict(zip(flags.tolist(),
                                                     counts.tolist()))))
    refs, uncertified = judge.reference_answers(config, traffic, pool)
    values = judge.numbers(answers, refs, entry.OPTIMAL, config["gate"],
                           uncertified)
    checks = judge.checks(values, cell.limits)
    marks.append(("reference and check", time.perf_counter()))

    ctx = Context(first, latencies, window_s, setup_s, len(first) * qpc,
                  deltas, records, t_dev, dev_calls)
    metrics, extra = {}, {}
    for m in cell.per_layer if trace else cell.end_to_end:
        v = cell.readers[m["name"]].read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if t_dev is not None:
        extra = {"busy_s": t_dev.busy_s, "window_s": t_dev.window_s}
    marks.append(("metrics", time.perf_counter()))
    prev = t_start
    for name, at in marks:
        log(f"qpbench: {name} {at - prev:.3f} s")
        prev = at
    result = {
        "correct": all(c["ok"] for c in checks.values()),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu",
            "count": 1,
            "memory_peak_bytes": memory_peak,
            **extra,
        },
    }
    if t_dev is not None and t_host is not None:
        result["breakdown"] = {"device_ops": t_dev.device_ops(),
                               "idle_gaps": t_host.idle_gaps_by_label()}
    result["checks"] = checks
    return result
