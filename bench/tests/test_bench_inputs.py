"""A configuration's inputs and its CPU size are files found by name: the
generator module its ``dataset`` names (``bench/inputs/<generator>.py``) and
its own ``small``.  The Appendix C inputs are pinned bit for bit, and a toy
configuration that no file of the benchmark knows runs through the whole
run on the CPU, its generator and entry registered only as modules."""

import hashlib
import importlib
import json
import sys
import time
import types

import numpy as np
import pytest
import torch

from bench.harness import spec as spec_mod
from bench.harness import traffic
from bench.inputs import appendix_c as appendix_c_inputs

SPEC = spec_mod.benchmark()
DATASET = {"generator": "appendix_c", "data_seed": 0, "noise": 0.05, "test_frac": 0.4,
           "split_seed": 0}


def digest(inputs):
    h = hashlib.sha256()
    for key in ("Xtr", "ytr", "Xte", "yte"):
        a = np.ascontiguousarray(inputs[key])
        for part in (key, str(a.dtype), str(a.shape)):
            h.update(part.encode())
        h.update(a.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("m, seed, want", [
    (6000, 2147483659, "7302f4b6da60b27a5a36d53e2111c1ef887edc29123a9c68d6c69a030bd745b5"),
    (6000, 11, "18786d7cd1c56508afaba66da746c293fff3e14643e8c13a7ed0bbff623c74ba"),
    (2_000_000, 0, "4e8c6cc08164ca3e68fdc94aafc563f219a370453b96ce7c6044e1392f41c00e"),
])
def test_appendix_c_inputs_are_pinned(m, seed, want):
    assert digest(traffic.make_inputs({**DATASET, "m": m}, seed)) == want


def test_the_frozen_functions_stay_importable_from_traffic():
    assert traffic.appendix_c is appendix_c_inputs.appendix_c
    assert traffic.train_test_split is appendix_c_inputs.train_test_split


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_every_configuration_names_a_generator_and_a_small(config):
    cfg = spec_mod.config(config)
    gen = importlib.import_module(f"bench.inputs.{cfg['dataset']['generator']}")
    assert callable(gen.make)
    assert isinstance(cfg["small"], dict) and cfg["small"]


@pytest.mark.parametrize("name", ["no_such_generator", "no such generator"])
def test_an_unknown_generator_names_the_file_it_looked_for(name):
    with pytest.raises((LookupError, ValueError), match="bench/inputs/"):
        traffic.make_inputs({"generator": name}, 0)


# a configuration that no file of the benchmark knows: token ids drawn from
# the seed, and an entry that counts each id over the batch
TOY = "toy_tokens"
TOY_CELL = {"name": "toy-1m.count", "config": "toy-1m", "traffic": "toy_count", "chips": 1,
            "why": "a configuration, generator and entry of the test's own"}
TOY_CONFIG = {"name": "toy-1m", "dataset": {"generator": TOY, "rows": 1_000_000,
                                            "cols": 512, "vocab": 32000},
              "small": {"dataset": {"rows": 48, "cols": 16}}}


def _toy_make(dataset, seed):
    rng = np.random.default_rng(int(seed))
    ids = rng.integers(0, int(dataset["vocab"]), (int(dataset["rows"]), int(dataset["cols"])))
    return {"ids": ids.astype(np.int64)}


def _toy_entry(altered):
    def run(st):
        t0 = time.perf_counter()
        counts = torch.bincount(st["ids"].flatten(), minlength=st["vocab"])
        if altered:
            counts[0] += 1
        return {"counts": counts, "seconds": time.perf_counter() - t0}

    def judge(inputs, out, cfg, device):
        want = np.bincount(inputs["ids"].ravel(), minlength=cfg["dataset"]["vocab"])
        return {"structure": [] if out.shape == want.shape else ["counts: shape"],
                "count_gap": float(np.abs(out - want).max())}

    return types.SimpleNamespace(
        prepare=lambda cfg, traffic, inputs, device: {
            "ids": torch.as_tensor(inputs["ids"], device=device),
            "vocab": cfg["dataset"]["vocab"]},
        warm=run, run=run, phases=lambda rec: [],
        stats=lambda rec: {"signature": (), "seconds": rec["seconds"]},
        extract=lambda rec: rec["counts"].cpu().numpy(), judge=judge,
        work=lambda inputs, out, cfg: {"flops": float(inputs["ids"].size)})


@pytest.fixture
def toy(monkeypatch):
    """The toy registered: its generator and entry in ``sys.modules``
    alone, its configuration, traffic and cell file where the spec looks."""
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append(TOY_CELL)
    monkeypatch.setattr(spec_mod, "benchmark", lambda root=None: spec)
    monkeypatch.setattr(spec_mod, "config", lambda name: TOY_CONFIG if name == "toy-1m"
                        else pytest.fail(f"config {name}"))
    monkeypatch.setattr(spec_mod, "traffic", lambda name: {"entry": TOY} if name == "toy_count"
                        else pytest.fail(f"traffic {name}"))
    monkeypatch.setattr(spec_mod, "cell", lambda name: {"limits": {"structure": 0,
                                                                   "count_gap": 0}})
    monkeypatch.setitem(sys.modules, f"bench.inputs.{TOY}", types.SimpleNamespace(make=_toy_make))

    def entry(altered=False):
        monkeypatch.setitem(sys.modules, f"bench.entries.{TOY}", _toy_entry(altered))

    entry()
    return entry


def test_small_config_applies_the_toy_configurations_own_small(toy, small_config):
    cfg = small_config(TOY_CELL["name"])
    assert cfg["dataset"] == {"generator": TOY, "rows": 48, "cols": 16, "vocab": 32000}
    assert "small" not in cfg
    assert TOY_CONFIG["dataset"]["rows"] == 1_000_000


@pytest.mark.parametrize("altered", [False, True], ids=["sound", "count_altered"])
def test_a_toy_configuration_runs_with_no_edit_to_the_harness(toy, run_small, altered):
    toy(altered)
    result = run_small(TOY_CELL["name"])
    assert {"fit_s", "setup_s", "peak_mem_gib"} <= set(result["metrics"])
    assert all(m["value"] >= 0 for m in result["metrics"].values())
    assert result["correct"] is (not altered)
    assert result["checks"]["count_gap"] == {"value": float(altered), "limit": 0.0}

