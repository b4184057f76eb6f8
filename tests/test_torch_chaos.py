"""The port's chaos harness (``repro_torch.launch.chaos_vi``) on the CPU.

Kill/resume mirrors the reference's ``tests/test_resilience.py``: a
controller subprocess (``python -m repro_torch.launch.continuous_vi
--device cpu``) is SIGKILL'd at a journaled phase transition and re-run on
the same workdir; the resumed final model must be bit-identical to the
uninterrupted run's and report the rows it caught up.  The other five
scenarios run once each.  Every subprocess runs under the harness's
timeout; the whole file takes about half a minute on one worker.
"""

import json
import os

import pytest

from repro_torch import obs
from repro_torch.launch import chaos_vi

CPU = "cpu"


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The uninterrupted run every resumed run is held against."""
    ref_dir = str(tmp_path_factory.mktemp("reference"))
    proc = chaos_vi._run_controller(ref_dir, device=CPU)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rep = chaos_vi._report(ref_dir)
    assert rep["serve"]["mismatches"] == 0
    return chaos_vi._final_leaves(ref_dir, CPU)


@pytest.mark.parametrize("phase", ["state_saved", "activated"])
def test_continuous_kill_resume_bit_identical(tmp_path, reference, phase):
    out = chaos_vi.scenario_kill_resume(str(tmp_path), reference, [(phase, 1)],
                                        trace_dir=str(tmp_path / "traces"), device=CPU)
    kill = out["kills"][0]
    assert out["ok"] and kill["phase"] == phase
    assert kill["caught_up_rows"] == 4096  # 2,048 base rows + 2 x 1,024
    # one merged, validated timeline of the killed and the resumed process
    with open(kill["trace"]) as f:
        doc = json.load(f)
    obs.validate_chrome_trace(doc)
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"chaos/sigkill", "chaos/recovery"} <= names


def test_chaos_corrupt_state_falls_back(tmp_path, reference):
    out = chaos_vi.scenario_corrupt_state(str(tmp_path), reference, device=CPU)
    assert out["ok"] and out["fallback_from_rows"] < 4096


def test_chaos_degraded_activation_recovers(tmp_path, reference):
    out = chaos_vi.scenario_degraded_activation(str(tmp_path), reference, device=CPU)
    assert out["ok"] and len(out["failures"]) == 1


def test_chaos_transient_engine_absorbed(tmp_path, reference):
    assert chaos_vi.scenario_transient_engine(str(tmp_path), reference, device=CPU)["ok"]


def test_chaos_poison_isolation(tmp_path):
    out = chaos_vi.scenario_poison_isolation(str(tmp_path), device=CPU)
    assert out["ok"] and out["isolated_failures"] >= 1 and out["bisections"] >= 1


def test_chaos_torn_shard(tmp_path):
    assert chaos_vi.scenario_torn_shard(str(tmp_path))["ok"]


def test_chaos_main_runs_in_process_scenarios(tmp_path):
    """``main`` with a subset needs no reference run and writes its report."""
    out = str(tmp_path / "report.json")
    report = chaos_vi.main(["--scenarios", "poison_isolation,torn_shard", "--device", CPU,
                            "--tmp", str(tmp_path / "t"), "--trace-dir", "", "--out", out])
    assert report["ok"] and set(report["scenarios"]) == {"poison_isolation", "torn_shard"}
    assert "reference_rows" not in report
    with open(out) as f:
        assert json.load(f)["ok"]
    assert os.path.isdir(str(tmp_path / "t"))
