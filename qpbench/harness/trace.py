"""Traced windows, reduced from ``torch.profiler``'s events.

A traced run records two windows (``runner``):

* the card alone (``device_trace``): every device operation (kernels,
  copies, sets) of the window gives the busy time (the union of their
  intervals), each kernel's time and the number of kernels launched.  No
  host event is recorded, so the host runs at nearly its untraced pace;
  the window is its length on the host clock.
* the host and the card (``from_profiler``), a short window inside the
  user annotation ``qpbench.window``: the host's events on the thread
  that ran it (the spans the runner wraps around the port's functions,
  ``qpbench:<module.function>``, and the operators and runtime calls
  beneath them) label each idle gap of the card with what the host was
  doing at its middle.  Recording them roughly doubles the host's time a
  call, so only the labels are read from this window.

The arithmetic of the busy and idle shares is that of the repository's
``chip_profile.py``, applied to the measured window.
"""
from __future__ import annotations

import functools
import re
from collections import defaultdict

import numpy as np

WINDOW = "qpbench.window"
SPAN = "qpbench:"


def kernel_id(name: str) -> str:
    """A device operation's short name: a kernel's function name without
    its return type, namespaces, template arguments and parameters
    (``void (anonymous namespace)::slot_round_kernel<3>(Ptrs, int)`` ->
    ``slot_round_kernel``; a bare ``kernel`` keeps its namespace); a copy
    or a set as the profiler names it, without the details in brackets."""
    s = name.replace("(anonymous namespace)::", "").strip()
    if s.startswith(("Memcpy", "Memset")):
        return s.split("(")[0].strip()
    while re.search(r"<[^<>]*>", s):
        s = re.sub(r"<[^<>]*>", "", s)
    s = s.split("(")[0].split()
    parts = (s[-1] if s else name).split("::")
    return "::".join(parts[-2:]) if parts[-1] == "kernel" else parts[-1]


class Trace:
    """Device and host intervals of one traced window, in ns."""

    def __init__(self, w0, w1, dev, host):
        """``dev``: (names, starts, ends) of device operations; ``host``:
        (names, starts, ends, is_span) of the window thread's events."""
        self.w0, self.w1 = int(w0), int(w1)
        names, s, e = dev
        s, e = np.asarray(s, np.int64), np.asarray(e, np.int64)
        keep = (e > self.w0) & (s < self.w1)
        self.dev_names = [kernel_id(n) for n, k in zip(names, keep) if k]
        self.dev_s = np.clip(s[keep], self.w0, self.w1)
        self.dev_e = np.clip(e[keep], self.w0, self.w1)
        hn, hs, he, hsp = host
        self.host = (list(hn), np.asarray(hs, np.int64),
                     np.asarray(he, np.int64), np.asarray(hsp, bool))

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) * 1e-9

    def busy_intervals(self):
        """The union of the device operations' intervals, sorted."""
        if not len(self.dev_s):
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        o = np.argsort(self.dev_s, kind="stable")
        s, e = self.dev_s[o], self.dev_e[o]
        run_end = np.maximum.accumulate(e)
        new = np.ones(len(s), bool)
        new[1:] = s[1:] > run_end[:-1]
        starts = s[new]
        ends = np.maximum.reduceat(e, np.flatnonzero(new))
        return starts, ends

    @property
    def busy_s(self) -> float:
        s, e = self.busy_intervals()
        return float((e - s).sum()) * 1e-9

    @property
    def kernel_launches(self) -> int:
        """Kernels the card ran in the window (copies and sets are not
        launches)."""
        return sum(not n.startswith(("Memcpy", "Memset"))
                   for n in self.dev_names)

    @functools.cached_property
    def _op_seconds(self) -> dict:
        """Summed device time of each operation's short name."""
        out = defaultdict(float)
        for n, s, e in zip(self.dev_names, self.dev_s, self.dev_e):
            out[n] += (e - s) * 1e-9
        return dict(out)

    def kernel_s(self, name: str) -> float:
        """Device time of the kernel ``name`` (its short name)."""
        return self._op_seconds.get(name, 0.0)

    def idle_gaps(self):
        """(start, end) of the window's stretches with no device work."""
        s, e = self.busy_intervals()
        gs = np.concatenate([[self.w0], e])
        ge = np.concatenate([s, [self.w1]])
        keep = ge > gs
        return gs[keep], ge[keep]

    def gap_labels(self, gs, ge):
        """For each gap, ``<span> > <operation>``: the innermost span and
        the innermost other host event running at its middle ("entry" and
        "python" where there is none)."""
        names, hs, he, span = self.host
        mids = (gs + ge) // 2
        out_span = _innermost(names, hs, he, span, mids)
        out_op = _innermost(names, hs, he, ~span, mids)
        return [f"{a[len(SPAN):] if a else 'entry'} > {b or 'python'}"
                for a, b in zip(out_span, out_op)]

    def device_ops(self, top: int = 10) -> list:
        """The ``top`` device operations by their summed time, [name, s]."""
        ops = sorted(self._op_seconds.items(), key=lambda kv: -kv[1])
        return [[n, s] for n, s in ops[:top]]

    def idle_gaps_by_label(self, top: int = 10) -> list:
        """The idle time summed by ``gap_labels``, the ``top`` labels,
        [label, s]."""
        gs, ge = self.idle_gaps()
        by = defaultdict(float)
        for lab, a, b in zip(self.gap_labels(gs, ge), gs, ge):
            by[lab] += (b - a) * 1e-9
        gaps = sorted(by.items(), key=lambda kv: -kv[1])
        return [[n, s] for n, s in gaps[:top]]


def _innermost(names, starts, ends, mask, points):
    """The name of the innermost of the masked intervals that covers each
    point (None where none does); the intervals of one thread nest."""
    idx = np.flatnonzero(mask)
    if not len(idx):
        return [None] * len(points)
    s, e = starts[idx], ends[idx]
    o = np.lexsort((-e, s))               # by start, the outer one first
    s, e, idx = s[o], e[o], idx[o]
    parent = np.full(len(s), -1, np.int64)
    stack = []
    for i in range(len(s)):
        while stack and e[stack[-1]] <= s[i]:
            stack.pop()
        parent[i] = stack[-1] if stack else -1
        stack.append(i)
    out = []
    for p, i in zip(points, np.searchsorted(s, points, side="right") - 1):
        while i >= 0 and e[i] < p:
            i = parent[i]
        out.append(names[idx[i]] if i >= 0 else None)
    return out


def _annotation(e) -> bool:
    """Whether a device-side event is a host annotation projected onto the
    card's timeline (no work of the card's own)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return "annotation" in str(kind())
    return e.is_user_annotation() or e.name().startswith(("qpbench",
                                                           SPAN))


def _device_events(events):
    """(names, starts, ends) of the card's own operations among
    ``events`` (not the annotations projected onto its timeline)."""
    dev = ([], [], [])
    for e in events:
        if e.device_type().name == "CUDA" and not _annotation(e):
            dev[0].append(e.name())
            dev[1].append(e.start_ns())
            dev[2].append(e.end_ns())
    return dev


def device_trace(prof, window_s: float) -> Trace:
    """The ``Trace`` of a profile that recorded the card alone over one
    window of ``window_s`` seconds on the host clock (no device work
    before or after it: the window starts after a synchronisation and
    ends with its results on the host).  The window is laid from the
    first device operation's start, and stretched to the last one's end
    where that lies later."""
    dev = _device_events(prof.profiler.kineto_results.events())
    if not dev[0]:
        return Trace(0, int(window_s * 1e9), dev, ([], [], [], []))
    w0 = min(dev[1])
    w1 = max(max(dev[2]), w0 + int(window_s * 1e9))
    return Trace(w0, w1, dev, ([], [], [], []))


def from_profiler(prof) -> Trace:
    """The ``Trace`` of a ``torch.profiler.profile`` of the host and the
    card whose events hold one ``qpbench.window`` annotation."""
    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == WINDOW
           and e.device_type().name == "CPU"]
    if not win:
        raise RuntimeError("the trace holds no qpbench.window annotation")
    w = win[0]
    w0, w1, thread = w.start_ns(), w.end_ns(), w.start_thread_id()
    host = ([], [], [], [])
    for e in events:
        if e.device_type().name != "CUDA" and e.start_thread_id() == thread \
                and e is not w:
            s = e.start_ns()
            if s > w1 or e.end_ns() < w0 or e.name() == WINDOW:
                continue
            host[0].append(e.name())
            host[1].append(s)
            host[2].append(e.end_ns())
            host[3].append(e.name().startswith(SPAN))
    return Trace(w0, w1, _device_events(events), host)
