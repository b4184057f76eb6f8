"""Run one cell of the benchmark once, on the CUDA card of this machine.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``, every number compared for ``correct`` beside its limit.  Those
numbers are also the last lines of standard error.  Without a card, or
with fewer cards than the cell asks for, the run prints no result and
exits with 2.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402

# one process with few threads: the host's math libraries run on the calling
# thread, so no idle pool competes with it for the cores
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from bench.harness import device as device_mod
    from bench.harness import spec as spec_mod

    spec = spec_mod.benchmark(ROOT)
    chips = spec_mod.workload(spec, args.workload)["chips"]
    device_mod.cache_dirs(ROOT)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA card(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from bench.harness import runner

    log(f"card: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"nvidia-smi {device_mod.smi()}; torch {torch.__version__} CUDA {torch.version.cuda}")
    result, lines = runner.run_cell(spec, args.workload, args.seed, args.seconds,
                                    bool(args.trace), "cuda", T_START, log=log)
    bad = runner.forbidden_modules()
    if bad:
        log(f"the run loaded {bad}: no result")
        return 3
    for line in lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
