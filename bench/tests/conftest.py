import copy
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA card; run there with `pytest -m gpu tests/`",
    )


def spec_and_cell(cell_name):
    """BENCHMARK.json and the cell's file."""
    from bench.harness import spec as spec_mod

    return spec_mod.benchmark(), spec_mod.cell(cell_name)


def merged(base, over):
    """``base`` with ``over`` merged in: dicts key by key, other values
    replaced."""
    out = copy.deepcopy(base)
    for key, value in over.items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = merged(out[key], value)
        else:
            out[key] = copy.deepcopy(value)
    return out


def _small_config(cell_name):
    """A cell's configuration at a size the CPU runs in about a second: the
    configuration with its own ``small`` merged in (the run never reads
    ``small``)."""
    from bench.harness import spec as spec_mod

    spec, _ = spec_and_cell(cell_name)
    cfg = spec_mod.config(spec_mod.workload(spec, cell_name)["config"])
    return merged({k: v for k, v in cfg.items() if k != "small"}, cfg["small"])


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
