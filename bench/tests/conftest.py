import copy
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# the generators entry, which no cell of BENCHMARK.json drives yet: held
# here to the paper-scale classify cell's limits on the generator numbers
GENERATORS_CELL = {"name": "appendix_c-2m.generators", "config": "appendix_c-2m",
                   "traffic": "generators", "chips": 1,
                   "why": "api.fit_classes of the two training classes alone"}
GENERATORS_LIMITS = ("structure", "verdict", "mse_gap", "coef_excess")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA card; run there with `pytest -m gpu tests/`",
    )


def spec_and_cell(cell_name):
    """BENCHMARK.json and the cell's file, with the generators entry's cell
    added where ``cell_name`` names it."""
    from bench.harness import spec as spec_mod

    spec = spec_mod.benchmark()
    if cell_name != GENERATORS_CELL["name"]:
        return spec, spec_mod.cell(cell_name)
    spec = copy.deepcopy(spec)
    spec["workloads"].append(dict(GENERATORS_CELL))
    limits = spec_mod.cell("appendix_c-2m.classify")["limits"]
    return spec, {"limits": {k: limits[k] for k in GENERATORS_LIMITS}}


def _small_config(cell_name):
    """A cell's configuration at a size the CPU runs in about a second:
    Appendix C at 6,000 rows, the SVM cut to 100 steps."""
    from bench.harness import spec as spec_mod

    spec, _ = spec_and_cell(cell_name)
    cfg = copy.deepcopy(spec_mod.config(spec_mod.workload(spec, cell_name)["config"]))
    cfg["dataset"]["m"] = 6000
    cfg["fit"]["svm"]["max_iter"] = 100
    return cfg


@pytest.fixture
def small_config():
    return _small_config


@pytest.fixture
def cell_spec():
    return spec_and_cell


@pytest.fixture
def run_small():
    """Run a cell once on the CPU at its small size, past the look for a
    card, against the cell's own limits; returns the result line."""
    from bench.harness import runner

    def run(cell_name, seed=2147483659):
        spec, cell = spec_and_cell(cell_name)
        result, _ = runner.run_cell(spec, cell_name, seed, 0.0, False, "cpu",
                                    time.perf_counter(), log=lambda *a: None,
                                    cfg=_small_config(cell_name), cell=cell)
        return result

    return run
