"""Vanishing-ideal serving launcher: registry + engine + micro-batcher.

Counterpart of ``src/repro/launch/serve_vi.py``: stands the
:mod:`repro_torch.serving` stack up end to end on one device and replays a
request trace against it, reporting tail latency and throughput.

1. **model** — load a committed checkpoint (``--model-dir``; either
   package's ``VanishingIdealClassifier`` or single model), or fit a demo
   classifier on the paper's Appendix C data and, when ``--model-dir`` is
   given, save it there first (so the next run exercises the load path).
2. **engine** — :class:`~repro_torch.serving.engine.TransformEngine` on
   ``--device`` (default: the CUDA card; ``cpu`` is for tests).  Every row
   bucket is warmed before the trace starts.  ``--sharded`` raises
   (ROADMAP.md queue 1 item 12b).
3. **traffic** — ``--requests`` synthetic mixed-size requests (log-normal
   row counts around ``--mean-rows``), or a file trace (``--trace``: one
   request size per line).  ``--concurrency`` closed-loop clients submit
   through the :class:`~repro_torch.serving.batcher.MicroBatcher` and wait.
   The clients, the batcher's worker and the head share this process's
   interpreter lock, so the latencies are host-bound.
4. **report** — p50/p90/p99/p999 latency, rows/s, coalescing and recompile
   stats.  With ``OBS_TORCH_PROFILE=<dir>`` the replay runs in a
   ``torch.profiler`` window, and the report adds the device's busy seconds
   and idle share over the replay and the launches by kernel.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.serve_vi --device cpu --requests 64
    PYTHONPATH=src python -m repro_torch.launch.serve_vi --kind predict \\
        --model-dir runs/served-clf --requests 512 --concurrency 16     # on the card
"""

from __future__ import annotations

import argparse
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from .. import obs


def demo_classifier(m: int, psi: float, seed: int, device=None):
    """The reference's demo: Algorithm 2 with ``oavi:fast`` on
    ``appendix_c(m, seed)``, ``cap_terms=64``."""
    from ..core.pipeline import PipelineConfig, VanishingIdealClassifier
    from ..data.synthetic import appendix_c

    X, y = appendix_c(m=m, seed=seed)
    clf = VanishingIdealClassifier(
        PipelineConfig(method="oavi:fast", psi=psi, oavi_kw={"cap_terms": 64}), device=device)
    return clf.fit(X, y)


def synth_trace(num_requests: int, mean_rows: int, seed: int) -> List[int]:
    """Mixed request sizes: log-normal around ``mean_rows`` (heavy right
    tail, lots of small requests), clipped to ``[1, 16 * mean_rows]``; the
    reference's trace to the request."""
    rng = np.random.default_rng(seed)
    sizes = rng.lognormal(mean=np.log(max(mean_rows, 1)), sigma=0.9, size=num_requests)
    return [int(np.clip(round(s), 1, 16 * mean_rows)) for s in sizes]


def load_trace(path: str) -> List[int]:
    with open(path) as f:
        sizes = [int(line) for line in f if line.strip()]
    if not sizes:
        raise ValueError(f"trace file {path!r} is empty")
    return sizes


def make_payloads(scale, sizes: List[int], seed: int) -> List[np.ndarray]:
    """Request payloads: slices of one scaled Appendix C pool, as the
    reference draws them (``scale`` maps raw rows to the model's inputs)."""
    from ..data.synthetic import appendix_c

    rng = np.random.default_rng(seed + 1)
    pool, _ = appendix_c(m=max(sizes), seed=seed + 2)
    pool = scale(pool)  # scale once; requests are slices of the pool
    payloads = []
    for q in sizes:
        take = rng.integers(0, pool.shape[0] - q + 1)
        payloads.append(pool[take : take + q])
    return payloads


def replay(batcher, payloads: List[np.ndarray], *, kind: str, concurrency: int,
           replies: Optional[list] = None) -> Dict:
    """Closed-loop replay: ``concurrency`` clients each send their share of
    the trace, one in-flight request per client.  Returns latency/throughput
    stats (latencies in ms); ``replies`` (a list) receives each request's
    result at its index."""
    latencies = [0.0] * len(payloads)
    if replies is not None:
        replies[:] = [None] * len(payloads)
    errors: List[BaseException] = []
    next_idx = {"i": 0}
    idx_lock = threading.Lock()

    def client():
        while True:
            with idx_lock:
                i = next_idx["i"]
                if i >= len(payloads):
                    return
                next_idx["i"] = i + 1
            t0 = time.perf_counter()
            try:
                out = batcher.submit(payloads[i], kind).result()
            except BaseException as e:  # surfaced after the run
                errors.append(e)
                return
            latencies[i] = (time.perf_counter() - t0) * 1e3
            if replies is not None:
                replies[i] = out

    threads = [threading.Thread(target=client) for _ in range(concurrency)]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t_start
    if errors:
        raise errors[0]
    rows = sum(p.shape[0] for p in payloads)
    lat = obs.percentile_summary(latencies)
    return {
        "requests": len(payloads),
        "rows": rows,
        "wall_s": wall,
        "rows_per_s": rows / max(wall, 1e-9),
        "requests_per_s": len(payloads) / max(wall, 1e-9),
        "lat_p50_ms": lat["p50"],
        "lat_p90_ms": lat["p90"],
        "lat_p99_ms": lat["p99"],
        "lat_p999_ms": lat["p999"],
        "lat_max_ms": lat["max"],
    }


def main(argv=None, *, replies: Optional[list] = None) -> Dict:
    """Run the launcher; returns the report.  ``replies`` (a list) receives
    every request's result, in trace order."""
    from ..checkpoint import store as ckpt_store
    from ..serving import BatcherConfig, EngineConfig, MicroBatcher, ModelRegistry

    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--model-dir", type=str, default=None,
                    help="checkpoint dir to load (or save the demo fit into)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card; 'cpu' only when asked)")
    ap.add_argument("--sharded", action="store_true",
                    help="the sharded engine (not ported: ROADMAP.md queue 1 item 12b)")
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--mean-rows", type=int, default=128)
    ap.add_argument("--trace", type=str, default=None,
                    help="file with one request size per line (overrides synthetic)")
    ap.add_argument("--kind", choices=["transform", "predict"], default="predict")
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--max-delay-ms", type=float, default=2.0)
    ap.add_argument("--max-batch-rows", type=int, default=8192)
    ap.add_argument("--min-bucket", type=int, default=64)
    ap.add_argument("--max-bucket", type=int, default=16384)
    ap.add_argument("--fit-m", type=int, default=4000,
                    help="demo-fit sample count when no checkpoint exists")
    ap.add_argument("--psi", type=float, default=0.005)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.sharded:
        raise NotImplementedError(
            "serve_vi --sharded is not ported yet: ROADMAP.md queue 1 item 12b")

    registry = ModelRegistry(
        device=args.device,
        engine_config=EngineConfig(min_bucket=args.min_bucket, max_bucket=args.max_bucket),
    )
    t0 = time.perf_counter()
    if args.model_dir and ckpt_store.latest_step(args.model_dir) is not None:
        entry = registry.load("default", args.model_dir)
        print(f"loaded checkpoint {args.model_dir!r}")
    else:
        print(f"fitting demo classifier (m={args.fit_m}, psi={args.psi}) ...")
        clf = demo_classifier(args.fit_m, args.psi, args.seed, device=registry.device)
        if args.model_dir:
            clf.save(args.model_dir)
            print(f"saved demo classifier to {args.model_dir!r}")
        entry = registry.register("default", clf, path=args.model_dir)
    t_up = time.perf_counter() - t0
    engine = entry.engine
    if engine is None:
        raise SystemExit("loaded servable has no fused plan (VCA?); nothing to serve")
    print(f"serving {entry.name!r} v{entry.version}: {len(entry.models)} models, "
          f"{entry.num_features} features, {engine!r}; warm in {t_up:.2f}s")

    kind = args.kind if entry.head is not None else "transform"
    if kind != args.kind:
        print(f"(no classifier head — serving {kind!r} requests instead)")
    sizes = load_trace(args.trace) if args.trace else synth_trace(
        args.requests, args.mean_rows, args.seed)
    payloads = make_payloads(entry.scale, sizes, args.seed)

    batcher = MicroBatcher(
        engine, head=entry.head,
        config=BatcherConfig(max_batch_rows=args.max_batch_rows,
                             max_delay_ms=args.max_delay_ms),
    )
    with obs.device.profile_window("serve_vi/replay") as window:
        with batcher:
            report = replay(batcher, payloads, kind=kind, concurrency=args.concurrency,
                            replies=replies)

    es, bs = engine.stats, batcher.stats
    report.update(
        device=str(engine.device),
        recompiles=es["recompiles"],
        device_calls=es["device_calls"],
        padded_rows=es["padded_rows"],
        batches=bs["batches"],
        coalesced_max=bs["coalesced_max"],
        requests_per_batch=bs["requests"] / max(bs["batches"], 1),
    )
    if window.prof is not None:
        busy_s, by_kernel = obs.device.profile_kernels(window.prof)
        report.update(device_busy_s=busy_s,
                      device_idle_share=1.0 - busy_s / max(report["wall_s"], 1e-9),
                      kernel_launches_by_name=by_kernel, profile_trace=window.path)
    print(f"{report['requests']} {kind} requests ({report['rows']} rows) in "
          f"{report['wall_s']:.2f}s — {report['rows_per_s']:,.0f} rows/s, "
          f"{report['requests_per_s']:.0f} req/s")
    print(f"latency p50 {report['lat_p50_ms']:.2f}ms  p90 {report['lat_p90_ms']:.2f}ms  "
          f"p99 {report['lat_p99_ms']:.2f}ms  max {report['lat_max_ms']:.2f}ms")
    print(f"engine: {es['device_calls']} device calls over {bs['batches']} batches "
          f"(max coalesce {bs['coalesced_max']}), {es['padded_rows']} padded rows, "
          f"{es['recompiles']} recompiles after warmup")
    if es["recompiles"]:
        print("WARNING: trace triggered recompiles — widen warmup or buckets")
    return report


if __name__ == "__main__":
    main()
