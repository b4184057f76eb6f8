"""``BENCHMARK.json`` and the files it names, found by name.

* ``bench/configs/<config>.json``: a configuration (its dataset, fit
  settings, source and cuts);
* ``bench/traffic/<traffic>.json``: a traffic mix (its entry and loop
  parameters);
* ``bench/workloads/<cell>.json``: a cell's limits for ``correct`` and the
  readings they were set from;
* ``bench/metrics/<metric>.py``: the reader of one per-layer metric.
"""

from __future__ import annotations

import importlib
import json
import re
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _load(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict:
    return _load(root / "BENCHMARK.json")


def workload(spec: Dict, name: str) -> Dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> Dict:
    return _load(BENCH / "configs" / f"{name}.json")


def traffic(name: str) -> Dict:
    return _load(BENCH / "traffic" / f"{name}.json")


def cell(name: str) -> Dict:
    return _load(BENCH / "workloads" / f"{name}.json")


def metrics_for(spec: Dict, cell_name: str, kind: str) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    without a ``workloads`` key and those that list the cell."""
    return [m for m in spec[kind] if "workloads" not in m or cell_name in m["workloads"]]


def reader(name: str):
    """The module of a per-layer metric's reader."""
    return importlib.import_module(f"bench.metrics.{name}")


def entry(name: str):
    return importlib.import_module(f"bench.entries.{name}")


def check_names(spec: Dict) -> List[str]:
    """Every name and unit in ``spec`` that breaks the contract's rules."""
    bad: List[str] = []
    names: List[Optional[str]] = [c["name"] for c in spec["configs"]]
    names += [w["name"] for w in spec["workloads"]]
    names += [w["config"] for w in spec["workloads"]] + [w["traffic"] for w in spec["workloads"]]
    names += [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    names += [k for c in spec["configs"] for k in c["reduced"]]
    bad += [f"name {n!r}" for n in names if not (isinstance(n, str) and NAME.match(n))]
    bad += [f"unit {m['unit']!r}" for m in spec["end_to_end"] + spec["per_layer"]
            if not UNIT.match(m["unit"])]
    return bad
