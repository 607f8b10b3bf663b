"""The control: the reference with TF32 products in the port's place must
come out not correct, in every cell.  On the CPU at a size a test run
holds; ``test_control_at_the_cells_size`` runs it on a card at the cell's
own size (``readings.py`` prints the same readings seed by seed)."""
import pytest
import torch

from harness import judge, manifest
import readings

CELLS = [w["name"] for w in manifest.load()["workloads"]]


def _small(workload):
    return dict(batch=32, pool=2)


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_the_port_passes_on_the_cpu(workload):
    cell = manifest.Cell(manifest.load(), workload)
    r = readings.readings(cell, 2 ** 31 + 5, "cpu", True, _small(workload))
    ctrl = judge.checks(r["control"], cell.limits)
    assert not all(c["ok"] for c in ctrl.values()), ctrl
    assert r["control"]["gap_median"] > 3 * r["port"]["gap_median"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size")
    cell = manifest.Cell(manifest.load(), workload)
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        r = readings.readings(cell, seed, "cuda", True)
        ctrl = judge.checks(r["control"], cell.limits)
        port = judge.checks(r["port"], cell.limits)
        assert not all(c["ok"] for c in ctrl.values()), (seed, ctrl)
        assert all(c["ok"] for c in port.values()), (seed, port)
