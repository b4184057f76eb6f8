"""Readings that the limits of ``correct`` are set from, at a cell's own
size, on the card:

    python3 bench/tools/control.py --workload <cell> --seeds 1,2,3 --control-seeds 4,5,6 \
        [--faults ihb_state_unchanged,svm_half_batch --fault-seeds 7,8,9]

For every seed of ``--seeds`` one fit of the program through the cell's
entry (after one warm fit), judged as a run judges it: the lower readings.
For every seed of ``--control-seeds`` the reference itself in the precision
below the configuration's (float32 with TF32 products) in the program's
place, judged the same way: the upper readings.  For every fault of
``--faults`` (``bench/harness/faults.py``; ``all`` names every one) and
every seed of ``--fault-seeds``, one fit of the program with that fault
planted, judged the same way.  Prints one JSON line a reading and a summary
line of each number's largest sound, smallest control and each fault's
smallest reading.  ``--out`` also writes the lines to a file.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s.strip()]


def _row(kind, seed, nums, seconds):
    row = {"kind": kind, "seed": seed, "seconds": round(seconds, 3)}
    for k, v in nums.items():
        row[k] = len(v) if k == "structure" else v
    if nums.get("structure"):
        row["messages"] = list(nums["structure"])[:5]
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from bench.harness import device as device_mod
    from bench.harness import faults as faults_mod
    from bench.harness import spec as spec_mod
    from bench.harness import sync
    from bench.harness.traffic import make_inputs

    device_mod.cache_dirs(ROOT)
    spec = spec_mod.benchmark(ROOT)
    w = spec_mod.workload(spec, args.workload)
    cfg = spec_mod.config(w["config"])
    traffic = spec_mod.traffic(w["traffic"])
    entry = spec_mod.entry(traffic["entry"])
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    warmed = False

    def program(kind, seed):
        nonlocal warmed
        inputs = make_inputs(cfg["dataset"], seed)
        st = entry.prepare(cfg, traffic, inputs, args.device)
        if not warmed:
            entry.warm(st)
            warmed = True
        t = time.perf_counter()
        rec = entry.run(st)
        fit_s = time.perf_counter() - t
        out = entry.extract(rec)
        del rec, st
        t = time.perf_counter()
        nums = entry.judge(inputs, out, cfg, args.device)
        sync(args.device)
        emit({**_row(kind, seed, nums, time.perf_counter() - t), "fit_s": fit_s})

    for seed in _seeds(args.seeds):
        program("program", seed)
    names = list(faults_mod.BY_NAME) if args.faults == "all" else [
        f for f in args.faults.split(",") if f]
    for name in names:
        mp = pytest.MonkeyPatch()
        faults_mod.BY_NAME[name](mp)
        try:
            for seed in _seeds(args.fault_seeds):
                program(f"fault:{name}", seed)
        finally:
            mp.undo()
    for seed in _seeds(args.control_seeds):
        inputs = make_inputs(cfg["dataset"], seed)
        t = time.perf_counter()
        out = entry.control(inputs, cfg, args.device)
        nums = entry.judge(inputs, out, cfg, args.device)
        sync(args.device)
        emit(_row("control", seed, nums, time.perf_counter() - t))
    summary = {"kind": "summary", "workload": args.workload}
    keys = sorted({k for r in rows for k, v in r.items()
                   if isinstance(v, (int, float)) and k not in ("seed", "seconds", "fit_s")})
    for k in keys:
        prog = [r[k] for r in rows if r["kind"] == "program" and k in r]
        ctl = [r[k] for r in rows if r["kind"] == "control" and k in r]
        summary[k] = {"program_max": max(prog) if prog else None,
                      "control_min": min(ctl) if ctl else None}
        for name in names:
            got = [r[k] for r in rows if r["kind"] == f"fault:{name}" and k in r]
            if got:
                summary[k][f"{name}_min"] = min(got)
    emit(summary)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
