"""A run with the timed path broken underneath must come out not correct:
the harness's look for a card skipped (the CPU, the port's plain twins)
and the rest of the run driven as on the card, at a small size.  One case
for each fault a cell can have: a step that returns its state unchanged;
half of the batch left out; an answer altered where it is produced.  (No
cell spans chips, so no exchange between chips can be left out.)"""
import pytest

import daqp_tpu_torch.transform as transform
from daqp_tpu_torch.ops import dense, slot
from harness import manifest, runner

CELLS = [w["name"] for w in manifest.load()["workloads"]]


def _run(workload):
    cell = manifest.Cell(manifest.load(), workload)
    ov = dict(batch=16, pool=2)
    return runner.run(cell, 2 ** 31 + 23, 0.1, False, 0.0, device="cpu",
                      overrides=ov), cell


@pytest.fixture(scope="module")
def sound():
    """Each cell's checks in a sound run of the same seed and size."""
    return {w: _run(w)[0]["checks"] for w in CELLS}


def _newly_failed(sound, workload, r):
    """The checks ``r`` fails that the sound run passes."""
    return [k for k, c in r["checks"].items()
            if not c["ok"] and sound[workload][k]["ok"]]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_runs_are_correct(workload, sound):
    assert all(c["ok"] for c in sound[workload].values())


@pytest.mark.parametrize("workload", CELLS)
def test_a_step_that_returns_its_state_unchanged(workload, monkeypatch, sound):
    monkeypatch.setattr(slot, "run_slot_round", lambda s, *a, **k: s)
    monkeypatch.setattr(dense, "run_kernel_round", lambda s, *a, **k: s)
    r, _ = _run(workload)
    assert not r["correct"] and _newly_failed(sound, workload, r)


@pytest.mark.parametrize("workload", CELLS)
def test_half_of_the_batch_left_out(workload, monkeypatch, sound):
    cell = manifest.Cell(manifest.load(), workload)
    call = cell.entry.call

    def half(args, kwargs):
        x, flags, its = call(args, kwargs)
        k = x.shape[0] // 2
        return x[:k], flags[:k], its[:k]
    monkeypatch.setattr(cell.entry, "call", half)
    ov = dict(batch=16, pool=2)
    r = runner.run(cell, 2 ** 31 + 23, 0.1, False, 0.0, device="cpu",
                   overrides=ov)
    assert not r["correct"] and "missing" in _newly_failed(sound, workload, r)


@pytest.mark.parametrize("workload", CELLS)
def test_an_answer_altered_where_it_is_produced(workload, monkeypatch, sound):
    to_qp = transform.ldp_to_qp_solution
    monkeypatch.setattr(transform, "ldp_to_qp_solution",
                        lambda *a, **k: to_qp(*a, **k) + 1e-2)
    r, _ = _run(workload)
    assert not r["correct"] and _newly_failed(sound, workload, r)
