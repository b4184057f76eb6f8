"""The control: the plain reference put in the program's place and
computed in the precision below the configuration's (float32 with TF32
products), judged as a run judges the program, comes out as not correct
under each cell's own limits.  At a small size on the CPU; its readings at
the cells' own sizes on the card come from ``bench/tools/control.py``."""

import pytest

from bench.harness import judge
from bench.harness import spec as spec_mod
from bench.harness.traffic import make_inputs

SPEC = spec_mod.benchmark()


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_control_is_not_correct(small_config, cell_spec, cell):
    spec, cell_file = cell_spec(cell)
    w = spec_mod.workload(spec, cell)
    cfg = small_config(cell)
    entry = spec_mod.entry(spec_mod.traffic(w["traffic"])["entry"])
    inputs = make_inputs(cfg["dataset"], 2147483659)
    nums = entry.judge(inputs, entry.control(inputs, cfg, "cpu"), cfg, "cpu")
    ok, checks = judge.decide(nums, cell_file["limits"])
    assert not ok, checks
