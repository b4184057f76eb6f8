"""Nothing the benchmark runs imports JAX or the JAX package: in one
process with ``jax`` blocked, the reference's modules are imported first,
then every module under ``bench/`` and ``run.py``, and the loaded modules'
top-level names (the part before the first dot) are compared whole after
each step; the reference loads nothing of the program either."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SCRIPT = r"""
import importlib, json, pkgutil, runpy, sys
sys.modules["jax"] = None
sys.path[:0] = [{root!r}, {src!r}]
import bench

def tops():
    return sorted({{m.split(".", 1)[0] for m, mod in list(sys.modules.items())
                    if mod is not None}})

names = sorted(m.name for m in pkgutil.walk_packages(bench.__path__, "bench.")
               if ".tests" not in m.name)
for name in names:
    if name.startswith("bench.reference"):
        importlib.import_module(name)
after_reference = tops()
for name in names:
    importlib.import_module(name)
runpy.run_path({run!r}, run_name="not_main")
print(json.dumps({{"imported": names, "reference": after_reference, "all": tops()}}))
"""


def test_no_module_of_the_benchmark_loads_jax_or_the_jax_package():
    code = SCRIPT.format(root=str(ROOT), src=str(ROOT / "src"),
                         run=str(ROOT / "bench" / "run.py"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {"bench.harness.runner", "bench.metrics.fit_mfu",
            "bench.reference.pipeline"} <= set(got["imported"])
    assert not {"jax", "jaxlib", "flax", "repro", "repro_torch"} & set(got["reference"])
    assert not {"jax", "jaxlib", "flax", "repro"} & set(got["all"])
