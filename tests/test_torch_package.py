"""The PyTorch port's package surface (daqp_tpu_torch): no jax at import,
settings equal to the JAX package's, no silent fallback from the CUDA
path, and the not-yet-ported options raise."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daqp_tpu import types as jtypes
from daqp_tpu.api import _as_settings
import daqp_tpu_torch as dt
from daqp_tpu_torch import convert
from daqp_tpu_torch.ops import _build, chol as pchol, slot as pslot
from tests.gen import generate_test_qp_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_leaves_jax_out():
    code = ("import sys, daqp_tpu_torch; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'daqp_tpu' not in sys.modules, 'daqp_tpu imported'")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("which", ["reference", "f32", "overrides"])
def test_settings_equal_jax(which):
    if which == "reference":
        js, ps = jtypes.Settings(), dt.Settings()
    elif which == "f32":
        js, ps = jtypes.default_settings_f32(), dt.default_settings_f32()
    else:
        over = {"iter_limit": 1000, "pricing": 1, "primal_tol": 1e-5}
        js = _as_settings(over, jnp.float32)
        ps = dt.as_settings(over, torch.float32)
    assert len(dt.Settings._fields) == len(jtypes.Settings._fields) == 17
    assert convert.settings_from_jax(js) == ps
    assert dt.as_settings(None, torch.float64) == dt.Settings()


def test_cuda_path_raises_without_toolchain(monkeypatch, tmp_path):
    # with no nvcc the kernels' build raises: nothing falls back to the
    # plain twins, which only a CPU tensor reaches
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.library()
    meta = torch.empty((2, 3, 3), device="meta")
    with pytest.raises(ValueError, match="device"):
        pchol.chol_rinv(meta)
    st = dt.default_settings_f32()
    s = pslot.slot_init(torch.empty((2, 4, 3), device="meta"),
                        *(torch.empty((2, 4), device="meta"),) * 4,
                        n_true=3)
    with pytest.raises(ValueError, match="device"):
        pslot.run_slot_round(s, st, 3)


@pytest.mark.parametrize("kw", [dict(has_soft=True),
                                dict(sw=object()),
                                dict(guess_cap=10),
                                dict(deadline=1.0)])
def test_unported_options_raise(kw):
    d = generate_test_qp_batch(4, 3, 5, 0, 2, 1e1, rng=1, dtype=np.float32)
    args = [torch.as_tensor(d[k]) for k in
            ('H', 'f', 'A', 'bupper', 'blower', 'sense')]
    st = dt.default_settings_f32()
    with pytest.raises(NotImplementedError):
        dt.solve_batch_kernel_stream(*args, st=st, **kw)
    with pytest.raises(NotImplementedError):
        dt.solve_batch_kernel(*args, st=st, **kw)
