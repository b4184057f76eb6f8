"""A whole run with the timed path broken underneath comes out as not
correct: once for each fault a cell can have (``bench/harness/faults.py``:
a step that returns its state unchanged, half of the batch left out with
the mean over the rest, an answer altered where it is produced, a decision
turned the wrong way; no cell spans chips).  The runs are on the CPU at a
small size, past the look for a card, held to each cell's own limits."""

import pytest

from bench.harness import faults
from bench.harness import spec as spec_mod

SPEC = spec_mod.benchmark()
ENTRY = {w["name"]: spec_mod.traffic(w["traffic"])["entry"] for w in SPEC["workloads"]}
# the generator faults reach every entry that fits generators; the SVM
# faults the classifier's alone
CELLS = [name for name, entry in ENTRY.items() if entry in ("classify", "generators")]
CLASSIFY = [name for name, entry in ENTRY.items() if entry == "classify"]


@pytest.mark.parametrize("cell", list(ENTRY))
def test_sound_small_run_is_correct(run_small, cell):
    assert run_small(cell)["correct"]


@pytest.mark.parametrize("fault", faults.GENERATOR_FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_generator_fault_is_not_correct(run_small, monkeypatch, cell, fault):
    fault(monkeypatch)
    assert not run_small(cell)["correct"]


@pytest.mark.parametrize("fault", faults.SVM_FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CLASSIFY)
def test_svm_fault_is_not_correct(run_small, monkeypatch, cell, fault):
    fault(monkeypatch)
    assert not run_small(cell)["correct"]


def test_decision_flipped_is_seen_by_the_verdict(run_small, monkeypatch):
    faults.decision_flipped(monkeypatch)
    checks = run_small(CLASSIFY[0])["checks"]
    assert checks["verdict"]["value"] > checks["verdict"]["limit"]
