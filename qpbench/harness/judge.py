"""What decides ``correct``: every answer of the window against the plain
reference.

Each timed call returns, for every QP it was handed, x, an exit flag and
an iteration count.  The reference (``reference/ipm.py``, float64) solves
each distinct QP of the pool once, after the window; every call's answers
are held against the reference's for its pool item.  With ``gate`` the
configuration's accuracy gate on ||x - x_ref||_2:

* ``missing``: answers due and not given (a call that returned fewer
  rows, or rows that are not finite where flagged optimal);
* ``optimal_share``: answers flagged optimal, over all due (the others
  say that they failed, which is no wrong answer, but a path that stops
  solving says it on every lane);
* ``silent_share``: answers flagged optimal beyond the gate, over those
  flagged optimal (a wrong answer with a clean flag);
* ``gap_median``: the median ||x - x_ref||_2 of the answers flagged
  optimal;
* ``uncertified``: QPs whose reference answer failed its own check.

A cell's ``cells/<workload>.json`` gives each number its limit (``min``
or ``max``); ``missing`` and ``uncertified`` are always held to 0.
"""
from __future__ import annotations

import math

import torch

from . import data
from reference import ipm


def reference_answers(config: dict, traffic: dict, pool: list,
                      precision: str = "float64", block: int = 4096):
    """The reference's x (Q, n) for every pool item, and how many of its
    QPs it could not certify.  Blocks of ``block`` QPs keep it small."""
    Q = data.qps_per_call(config, traffic)
    rho = float((traffic.get("settings") or {}).get("rho_soft", 0.0))
    out, uncertified = [], 0
    for item in pool:
        xs = []
        for b0 in range(0, Q, block):
            H, f, C, bu, bl, soft = data.reference_problem(
                config, item, slice(b0, b0 + block))
            x, ok = ipm.solve(H, f, C, bu, bl, soft=soft, rho=rho,
                              precision=precision)
            xs.append(x.to(torch.float64))
            uncertified += int((~ok).sum()) if precision == "float64" else 0
        out.append(torch.cat(xs))
    return out, uncertified


def numbers(answers, refs, optimal_flags, gate: float, uncertified: int):
    """The compared numbers of a window: ``answers`` a list of
    (pool index, (x, flags, iterations)) in call order; ``refs`` the
    reference x of each pool item."""
    due = sum(refs[p].shape[0] for p, _ in answers)
    got_ok, got_pass, missing, gaps = 0, 0, 0, []
    opt_set = torch.tensor(sorted(optimal_flags))
    for p, (x, flags, _) in answers:
        ref = refs[p]
        rows = min(x.shape[0], ref.shape[0], flags.shape[0])
        missing += ref.shape[0] - rows
        xd = x[:rows].to(ref.device, torch.float64)
        gap = (xd - ref[:rows]).norm(dim=1)
        opt = torch.isin(flags[:rows].to(torch.int64), opt_set) \
            .to(ref.device)
        finite = torch.isfinite(gap)
        missing += int((opt & ~finite).sum())
        opt = opt & finite
        got_ok += int(opt.sum())
        got_pass += int((opt & (gap <= gate)).sum())
        gaps.append(gap[opt])
    g = torch.cat(gaps) if gaps else torch.zeros(0, dtype=torch.float64)
    return dict(
        missing=missing,
        uncertified=uncertified,
        optimal_share=got_ok / due if due else 0.0,
        silent_share=(got_ok - got_pass) / got_ok if got_ok else 1.0,
        gap_median=float(g.median()) if g.numel() else math.inf,
    )


def checks(values: dict, limits: dict) -> dict:
    """Each compared number with its limit and verdict, in a fixed order:
    ``missing`` and ``uncertified`` (max 0), then the cell's own."""
    out = {}
    rules = {"missing": {"max": 0}, "uncertified": {"max": 0}}
    rules.update({k: v for k, v in limits.items()
                  if isinstance(v, dict) and ("min" in v or "max" in v)})
    for name, rule in rules.items():
        v = values[name]
        if "min" in rule:
            out[name] = {"value": v, "min": rule["min"],
                         "ok": v >= rule["min"]}
        else:
            out[name] = {"value": v, "max": rule["max"],
                         "ok": v <= rule["max"]}
    return out
