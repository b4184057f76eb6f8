"""BENCHMARK.json and the files it names: every name, unit and key within
the contract's rules, and every configuration, traffic mix, cell and
per-layer reader found by its name."""

import json
import re

import pytest

from bench.harness import spec as spec_mod

SPEC = spec_mod.benchmark()
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
LINE = re.compile(r"^[^\n\t]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_top_level_keys_and_sizes():
    assert set(SPEC) == TOP
    assert len(json.dumps(SPEC)) < 64 * 1024
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert 1 <= len(SPEC["paths"]) <= 16 and all(PATH.match(p) for p in SPEC["paths"])
    assert 1 <= len(SPEC["command"]) <= 32 and all(LINE.match(w) for w in SPEC["command"])
    for word in SPEC["command"]:
        assert not word.startswith("/") and ".." not in word


def test_names_and_units_follow_the_rules():
    assert spec_mod.check_names(SPEC) == []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in SPEC[kind]]
        assert len(names) == len(set(names)), kind


@pytest.mark.parametrize("kind,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries_have_just_the_contract_keys(kind, keys):
    for x in SPEC[kind]:
        extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
        assert keys <= set(x) <= keys | extra, x["name"]
        for field in ("why", "layer", "source"):
            if field in x:
                assert LINE.match(x[field]), (x["name"], field)
        if "better" in x:
            assert x["better"] in ("lower", "higher")


def test_metrics_and_bounds():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_every_cell_finds_its_files(w):
    cfg = spec_mod.config(w["config"])
    traffic = spec_mod.traffic(w["traffic"])
    cell = spec_mod.cell(w["name"])
    assert cfg["name"] == w["config"]
    entry = spec_mod.entry(traffic["entry"])
    for fn in ("prepare", "warm", "run", "phases", "stats", "extract", "judge", "control",
               "work"):
        assert callable(getattr(entry, fn)), fn
    assert cell["limits"].get("structure") == 0
    assert w["chips"] in (1, 4) and LINE.match(w["why"])
    reported = spec_mod.metrics_for(SPEC, w["name"], "end_to_end")
    assert {"setup_s", "fit_s"} <= {m["name"] for m in reported}
    assert spec_mod.metrics_for(SPEC, w["name"], "per_layer")


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_configs_state_their_source_and_cuts(c):
    assert c["file"] == f"bench/configs/{c['name']}.json"
    cfg = spec_mod.config(c["name"])
    assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    assert any(w["config"] == c["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_every_per_layer_metric_has_its_reader(m):
    mod = spec_mod.reader(m["name"])
    assert callable(mod.read)
    assert f"Unit ``{m['unit']}``; moves ``{m['moves']}``" in mod.__doc__
