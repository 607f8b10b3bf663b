"""The port's deploy-time warm-up (daqp_tpu_torch.warmup), the
counterpart of tests/test_precompile.py: each tier runs once at the
given shape on the CPU's twins and solves its trivial batch; an unknown
tier raises before any work."""
import numpy as np
import pytest
import torch

import daqp_tpu_torch as dt
from daqp_tpu_torch import batch as pbatch
from daqp_tpu_torch.ops import _build


def _recording(monkeypatch):
    calls = []
    for name in ("solve_batch_kernel_stream", "solve_batch_flat_jit"):
        fn = getattr(pbatch, name)

        def rec(*a, _fn=fn, _name=name, **kw):
            r = _fn(*a, **kw)
            calls.append((_name, kw, r))
            return r

        monkeypatch.setattr(pbatch, name, rec)
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_warmup_runs_each_tier_on_the_twins(monkeypatch, dtype):
    calls = _recording(monkeypatch)
    n, m, B = 4, 7, 8
    out = dt.warmup(n, m, B, tiers=("hard", "soft", "sw", "flat"),
                    dtype=dtype, device="cpu")
    assert list(out) == ["hard", "soft", "sw", "flat"]
    assert all(t >= 0.0 for t in out.values())
    assert [c[0] for c in calls] == ["solve_batch_kernel_stream"] * 3 \
        + ["solve_batch_flat_jit"]
    assert calls[1][1]["has_soft"] and calls[2][1]["sw"] is not None
    for _, _, r in calls:
        assert r.x.shape == (B, n) and r.x.dtype == dtype
        assert r.x.device.type == "cpu"
        assert (r.exitflag.numpy() == dt.EXIT_OPTIMAL).all(), r.exitflag
        assert np.abs(r.x.numpy()).max() == 0.0


def test_warmup_rejects_unknown_tier(monkeypatch):
    calls = _recording(monkeypatch)

    def no_build():
        raise AssertionError("built before the tiers were checked")

    monkeypatch.setattr(_build, "library", no_build)
    for device in (None, "cpu"):
        with pytest.raises(ValueError, match="nope"):
            dt.warmup(4, 7, 8, tiers=("hard", "nope"), device=device)
    assert calls == []
