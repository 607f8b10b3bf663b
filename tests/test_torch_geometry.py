"""The port's geometry (``minrep``, ``isfeasible`` with the Farkas
certificate) against the JAX package's: the cases of test_minrep.py and
test_feasibility.py, in f64 on the CPU."""
import numpy as np
import pytest
import torch

import daqp_tpu
from daqp_tpu.geometry import isfeasible as j_isfeasible
import daqp_tpu_torch as dt

F64 = dict(dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("case", ["redundant", "tight", "bounds"])
def test_minrep_matches_jax(case):
    box = [[1.0, 0], [0, 1.0], [-1.0, 0], [0, -1.0]]
    if case == "redundant":
        A = np.array(box + [[1.0, 1.0], [1.0, 0.0]])
        b, ms, want = np.array([1.0, 1, 1, 1, 3.0, 2.0]), 0, [0] * 4 + [1, 1]
    elif case == "tight":
        A, b, ms = np.array(box + [[1.0, 1.0]]), np.array([1.0] * 4 + [2.0]), 0
        want = [0] * 5
    else:
        A, b, ms, want = np.array([[1.0, 1.0]]), np.array([1.0, 1, 5]), 2, \
            [0, 0, 1]
    red = dt.minrep(A, b, ms=ms, **F64)
    assert list(red) == want == list(np.asarray(daqp_tpu.minrep(A, b,
                                                                ms=ms)))


def test_isfeasible_matches_jax():
    A = np.array([[1.0, 1.0]])
    args = (A, np.array([1.0, 1, 1.5]), -np.ones(3) * 2)
    assert dt.isfeasible(*args, ms=2, **F64) == j_isfeasible(*args, ms=2)
    # infeasible, with the Farkas certificate validated
    A = np.array([[1.0, 0.0], [1.0, 0.0]])
    args = (A, np.array([-1.0, 5.0]), np.array([-5.0, 1.0]))
    assert not dt.isfeasible(*args, ms=0, validate=True, **F64)
    assert not j_isfeasible(*args, ms=0, validate=True)
    # region queries: shrinking boxes
    A = np.vstack([np.eye(3), np.ones((1, 3))])
    for r in (2.0, 1.0, 0.4):
        bu = np.concatenate([np.full(3, r), [1.0]])
        bl = np.concatenate([np.full(3, -r), [0.9]])
        assert dt.isfeasible(A, bu, bl, ms=0, **F64) == (3 * r >= 0.9) \
            == j_isfeasible(A, bu, bl, ms=0)
