"""``scripts/fuzz_torch.py``, the port's differential fuzzer, on the CPU:
one fixed seed of each family at a few lanes (the plain twins stand in
for the kernels), without the JAX package; every family must come out
with no finding."""
import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "fuzz_torch", os.path.join(ROOT, "scripts", "fuzz_torch.py"))
fuzz_torch = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fuzz_torch)


@pytest.mark.parametrize("family", fuzz_torch.FAMILIES)
def test_family_fixed_seed(family):
    fz = fuzz_torch.Fuzzer("cpu", small=True)
    fz.run(family, 100000 + fuzz_torch.FAMILIES.index(family))
    assert fz.instances[family] == 1
    assert fz.findings == [], fz.findings


def test_main_exit_code(capsys):
    # a budget of 0 s runs no round: no finding, exit 0, the summary line
    assert fuzz_torch.main(["0"]) == 0
    assert '"fuzz_torch"' in capsys.readouterr().out
