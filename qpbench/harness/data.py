"""A cell's inputs: a pool of distinct calls' worth of QPs, made on the
device from the seed, and the same QPs as the reference sees them.

The configuration's ``generator`` names the form; ``qp`` is the one
there is: ``traffic["batch"]`` independent QPs a call (``gen.qp_batch``),
the first ``traffic["soft_rows"]`` rows of each flagged soft.

Both sides get the served type (``config["dtype"]``): the port these
tensors, the reference the same numbers widened to float64.
"""
from __future__ import annotations

import torch

from . import gen

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def make_pool(config: dict, traffic: dict, seed: int, device) -> list:
    """``traffic["pool"]`` items, each one call's inputs: a dict of
    tensors on ``device`` in the served type (and ``soft``, a (B, m) bool
    mask, for the ``qp`` form)."""
    g = gen.generator(seed, device)
    dt = DTYPES[config["dtype"]]
    n, m, ms = config["n"], config["m"], config.get("ms", 0)
    shape = (n, m, ms, config["n_active"], config["kappa"])
    pool = []
    if config["generator"] == "qp":
        for _ in range(traffic["pool"]):
            d = gen.qp_batch(g, traffic["batch"], *shape)
            item = {k: d[k].to(dt).contiguous()
                    for k in ("H", "f", "A", "bupper", "blower")}
            soft = torch.zeros((traffic["batch"], m), dtype=torch.bool,
                               device=device)
            soft[:, :traffic.get("soft_rows", 0)] = True
            item["soft"] = soft
            pool.append(item)
    else:
        raise ValueError(f"generator {config['generator']!r}")
    return pool


def qps_per_call(config: dict, traffic: dict) -> int:
    return traffic["batch"]


def reference_problem(config: dict, item: dict, lanes: slice):
    """QPs ``lanes`` of a pool item in the reference's form: H (b, n, n),
    f (b, n), C (b, m, n) (simple bounds as identity rows), bupper,
    blower (b, m) and the soft mask (b, m) or None; in the order the
    answers come."""
    ms = config.get("ms", 0)
    H, f, A = item["H"][lanes], item["f"][lanes], item["A"][lanes]
    bu, bl = item["bupper"][lanes], item["blower"][lanes]
    soft = item["soft"][lanes]
    soft = soft if bool(soft.any()) else None
    b, n = f.shape
    if ms:
        eye = torch.eye(n, dtype=A.dtype, device=A.device)[:ms]
        A = torch.cat([eye.expand(b, ms, n), A], 1)
    return H, f, A, bu, bl, soft
