"""Instrumentation a traced run lays over the port from the benchmark's
side, and takes off again once the window has closed.

* Spans: each ``module:function`` an entry adapter lists in ``SPANS`` is
  wrapped in a ``torch.profiler.record_function`` named
  ``qpbench:<module>.<function>`` (without the package's name), so the
  trace shows which layer the host was in.
* Launch records: a per-layer reader with ``LAUNCH = "module:function"``
  and ``record(args, kwargs, out)`` gets that function wrapped; each call
  appends what ``record`` keeps (shapes and references to small result
  tensors: no device work, no sync) to the reader's list.
* Counters: module attributes named ``module:attribute``, read before and
  after the window.

The functions are replaced on their modules, where the port looks them up
at each call.
"""
from __future__ import annotations

import functools
import importlib

import torch


def resolve(target: str):
    """(module, attribute name) of ``module:attribute``."""
    mod, _, attr = target.partition(":")
    return importlib.import_module(mod), attr


def read_counter(target: str):
    mod, attr = resolve(target)
    return getattr(mod, attr)


class Hooks:
    """Replacements of module attributes, undone by ``restore``."""

    def __init__(self):
        self._saved = []

    def _replace(self, target, make):
        mod, attr = resolve(target)
        fn = getattr(mod, attr)
        self._saved.append((mod, attr, fn))
        setattr(mod, attr, make(fn))

    def span(self, target: str):
        name = "qpbench:" + target.split(".", 1)[-1].replace(":", ".")

        def make(fn):
            @functools.wraps(fn)
            def wrapped(*a, **k):
                with torch.profiler.record_function(name):
                    return fn(*a, **k)
            return wrapped
        self._replace(target, make)

    def launches(self, target: str, record, sink: list):
        def make(fn):
            @functools.wraps(fn)
            def wrapped(*a, **k):
                out = fn(*a, **k)
                rec = record(a, k, out)
                if rec is not None:
                    sink.append(rec)
                return out
            return wrapped
        self._replace(target, make)

    def restore(self):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()
