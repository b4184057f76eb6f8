"""One traced run of a cell, read by the program's own spans, on the card:

    python3 bench/tools/span_trace.py --workload <cell> --seed <n> [--seconds 51] [--out <file>]

Runs the cell as ``bench/run.py --trace 1`` does, with a tracer that keeps
its device activities, and lays them against the spans the program recorded
in the traced window (``bench/harness/spans.py``).  Prints to standard error
the idle seconds of the card by the innermost span open at the time
(``between`` where none is) and, for each span name, its seconds, the device
activities that start inside it and its idle seconds; then the run's result
line, and last a JSON line of these readings with ``fista_kernels_per_step``
(activities inside ``svm/fista`` over the traced fits' FISTA steps),
``fista_idle`` (the share of ``svm/fista``'s time with none running, %) and
``block_kernels_per_step`` (the activities inside ``svm/fista_block`` by
name, over the steps).
``--out`` also writes that line to a file.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402

for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from collections import Counter  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from bench.harness import device as device_mod
    from bench.harness import runner
    from bench.harness import spans as spans_mod
    from bench.harness import spec as spec_mod
    from bench.harness import trace as trace_mod

    spec = spec_mod.benchmark(ROOT)
    seconds = spec["run_seconds"] if args.seconds is None else args.seconds
    device_mod.cache_dirs(ROOT)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        log("no CUDA card: no result")
        return 2

    class KeepingTracer(trace_mod.Tracer):
        """The harness's tracer, keeping its window's edges and its
        activities once read."""

        last = None

        def __enter__(self):
            super().__enter__()
            self.t_start = time.perf_counter()
            self._events = None
            KeepingTracer.last = self
            return self

        def __exit__(self, *exc):
            self.t_end = time.perf_counter()
            super().__exit__(*exc)

        def events(self):
            if self._events is None:
                self._events = super().events()
            return self._events

    trace_mod.Tracer = KeepingTracer
    log(f"card: {torch.cuda.get_device_name(0)}, nvidia-smi {device_mod.smi()}")
    result, lines = runner.run_cell(spec, args.workload, args.seed, seconds, True, "cuda",
                                    T_START, log=log)
    for line in lines:
        log(line)
    kt = KeepingTracer.last
    t0, t1 = kt.t_start, kt.t_end
    spans = [s for s in spans_mod.program_spans() if t0 <= s.start <= t1]
    busy = spans_mod.Busy(kt.events())
    layers = spans_mod.layers(spans, busy)
    idle = spans_mod.idle_by_leaf(spans, busy, t0, t1)
    idle_s = sum(idle.values())
    under = idle_s - idle.get(spans_mod.BETWEEN, 0.0)
    log(f"idle by leaf span, of {idle_s:.4f} s idle in {t1 - t0:.4f} s traced "
        f"({100.0 * under / idle_s if idle_s else 0.0:.2f}% under spans): "
        + ", ".join(f"{k} {v:.4f}" for k, v in sorted(idle.items(), key=lambda kv: -kv[1])))
    for name, row in sorted(layers.items(), key=lambda kv: -kv[1]["seconds"]):
        log(f"  {name}: {row['seconds']:.6f} s, {row['activities']} activities, "
            f"idle {row['idle_s']:.6f} s")
    print(json.dumps(result), flush=True)
    fits = sum(1 for s in spans if s.name == "pipeline/fit")
    iters = result["metrics"].get("svm_iters", {}).get("value")
    fista = layers.get("svm/fista")
    steps = fits * iters if fits and iters else None
    acts = kt.events()
    starts = [a[1] for a in acts]
    by_name = Counter()
    for sp in spans:
        if sp.name == "svm/fista_block":
            lo, hi = bisect.bisect_left(starts, sp.start), bisect.bisect_left(starts, sp.end)
            by_name.update(a[0][:trace_mod.NAME_CHARS] for a in acts[lo:hi])
    out = {"fits": fits, "idle_by_leaf": idle, "idle_under_spans": under / idle_s if idle_s
           else None, "layers": layers,
           "fista_kernels_per_step": fista["activities"] / steps if fista and steps else None,
           "fista_idle": 100.0 * fista["idle_s"] / fista["seconds"] if fista else None,
           "block_kernels_per_step": {k: n / steps for k, n in by_name.most_common()}
           if steps else None}
    print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
