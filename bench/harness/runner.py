"""One run of one cell: set-up, the measured window, the trace, the
comparison with the reference and the result line.

Set-up is everything from the process's start to the window: imports,
CUDA's start, the kernels' library (built on the first run in a checkout),
the inputs from the seed, and one warm fit at the cell's shapes.  The
window runs whole fits back to back, one caller waiting on each (a closed
loop), and closes with the first fit that ends after ``seconds``.  Once it
has closed and the memory peak is read, one fit of the window, drawn from
the seed, is judged against the plain reference.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import device as device_mod
from . import host as host_mod
from . import judge as judge_mod
from . import spec as spec_mod
from . import sync
from . import trace as trace_mod
from .traffic import make_inputs

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GIB = float(1 << 30)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


class RunData:
    """What the per-layer readers read: the window's fits (each entry's
    ``stats``), its timing, the reduced trace and the work one fit needs."""

    def __init__(self, stats: List[Dict], window_s: float, red: Optional[Dict], work: Dict):
        self.stats = stats
        self.window_s = window_s
        self.fit_s = window_s / len(stats)
        self.trace = red
        self.work = work

    def mean(self, key: str) -> Optional[float]:
        vals = [s[key] for s in self.stats if key in s]
        return float(np.mean(vals)) if len(vals) == len(self.stats) else None

    def kernel_seconds(self, part: str) -> Optional[float]:
        """Device seconds of the kernels whose name contains ``part``."""
        if self.trace is None:
            return None
        secs = sum(s for name, (_, s) in self.trace["kernels"].items() if part in name)
        return secs if secs > 0 else None


def run_cell(spec: Dict, cell_name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=print, cfg: Optional[Dict] = None,
             cell: Optional[Dict] = None) -> Tuple[Dict, List[str]]:
    """Run the cell once; returns the result line's object and the lines of
    compared numbers.  ``cfg`` and ``cell`` replace the configuration's and
    the cell's files (the tests' small sizes)."""
    import torch

    w = spec_mod.workload(spec, cell_name)
    cfg = cfg or spec_mod.config(w["config"])
    traffic = spec_mod.traffic(w["traffic"])
    cell = cell or spec_mod.cell(cell_name)
    entry = spec_mod.entry(traffic["entry"])
    on_card = torch.device(device).type == "cuda"

    t_in = time.perf_counter()
    inputs = make_inputs(cfg["dataset"], seed)
    t_prep = time.perf_counter()
    st = entry.prepare(cfg, traffic, inputs, device)
    t_warm = time.perf_counter()
    entry.warm(st)
    sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s: start to inputs {t_in - t_start:.3f} s, inputs "
        f"{t_prep - t_in:.3f} s, program objects {t_warm - t_prep:.3f} s, warm fit "
        f"{t_start + setup_s - t_warm:.3f} s")

    smi0 = device_mod.smi() if on_card else None
    probes0 = host_mod.probes(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    # the judged fit: one of the window's, drawn from the seed as the
    # window runs (a reservoir of one), so no other fit is kept
    pick = np.random.default_rng(seed)
    stats: List[Dict] = []
    phases: List = []
    kept = None
    gc.collect()
    # a traced run traces the window's first fits, up to trace.SECONDS, and
    # reads its per-layer metrics from them; the window runs on untraced
    tracer = trace_mod.Tracer(device) if trace else None
    traced = None
    if tracer is not None:
        tracer.__enter__()
    try:
        t0 = time.perf_counter()
        while True:
            rec = entry.run(st)
            t = time.perf_counter()
            stats.append(entry.stats(rec))
            if tracer is not None and traced is None:
                phases += entry.phases(rec)
            if pick.integers(len(stats)) == 0:
                kept, judged = rec, len(stats) - 1
            del rec
            if traced is None and tracer is not None and (
                    t - t0 >= min(seconds, trace_mod.SECONDS)):
                t_traced, traced = t, len(stats)
                tracer.__exit__(None, None, None)
                log(f"traced {traced} fits in {t_traced - t0:.3f} s; profiler stopped in "
                    f"{time.perf_counter() - t:.3f} s")
            if time.perf_counter() - t0 >= seconds:
                break
        t1 = time.perf_counter()
    finally:
        if tracer is not None and traced is None:
            tracer.__exit__(None, None, None)
    window_s = t1 - t0
    peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
    smi1 = device_mod.smi() if on_card else None
    host = host_mod.witness(probes0, host_mod.probes(device))
    log(f"window {window_s:.3f} s, {len(stats)} fits; nvidia-smi before {smi0} after {smi1}")
    log(f"host: {host}")

    red = None
    if tracer is not None:
        t_ev = time.perf_counter()
        red = trace_mod.reduce(tracer.events(), t0, t_traced, phases)
        log(f"trace reduced in {time.perf_counter() - t_ev:.3f} s: busy {red['busy_s']!r} s "
            f"of {red['window_s']!r} s")
    log(f"seconds a fit: {[round(s['seconds'], 4) for s in stats]}")
    if len({s["signature"] for s in stats}) != 1:
        log("the window's fits differ in structure: "
            f"{sorted({s['signature'] for s in stats})}")
    out = entry.extract(kept)
    del kept, st
    if on_card:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    nums = entry.judge(inputs, out, cfg, device)
    sync(device)
    log(f"reference {time.perf_counter() - t_ref:.3f} s (fit {judged} of the window judged)")
    correct, checks = judge_mod.decide(nums, cell["limits"])
    info = {k: v for k, v in nums.items() if k not in checks and k != "structure"}
    log(f"not limited: {info}")

    run = RunData(stats[:traced] if trace else stats, red["window_s"] if trace else window_s,
                  red, entry.work(inputs, out, cfg))
    metrics: Dict[str, Dict] = {}
    if not trace:
        values = {"fit_s": run.fit_s, "setup_s": setup_s, "peak_mem_gib": peak / GIB}
        for m in spec_mod.metrics_for(spec, cell_name, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in spec_mod.metrics_for(spec, cell_name, "per_layer"):
            v = spec_mod.reader(m["name"]).read(run)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = device_mod.describe(w["chips"]) if on_card else {"platform": "cpu", "kind": "cpu",
                                                           "count": 1}
    dev["memory_peak_bytes"] = peak
    if smi1 is not None:
        dev["power_limit"] = smi1.get("power.limit")
        dev["sm_clock"] = smi1.get("clocks.sm")
    result = {"correct": bool(correct), "attempted": len(stats), "failed": 0,
              "metrics": metrics, "device": dev}
    if red is not None:
        dev["busy_s"] = red["busy_s"]
        dev["window_s"] = red["window_s"]
        result["breakdown"] = trace_mod.breakdown(red)
    result["host"] = host
    result["checks"] = checks
    return result, judge_mod.lines(checks, list(nums.get("structure") or []))
