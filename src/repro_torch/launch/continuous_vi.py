"""Continuous vanishing-ideal fitting: ingest -> drift-gated update -> hot-swap.

Counterpart of ``src/repro/launch/continuous_vi.py`` on the port, with the
same flags (plus ``--device``), the same journal record kinds and the same
report keys.  Instead of fitting once and replaying a trace
(:mod:`repro_torch.launch.serve_vi`), this driver keeps a model CURRENT
while its training data grows, without ever taking serving down:

1. **ingest**: a writer thread appends row batches to a shard directory
   (:func:`repro_torch.data.synthetic.write_shards` ``append=True``;
   meta.json committed last, atomically), the arrival pattern of a
   production feature store.  The fit-side
   :class:`~repro_torch.streaming.source.ShardDirSource` picks the rows up
   in place via ``refresh()``.
2. **drift gate**: every arrival's rows feed a
   :class:`~repro_torch.online.DriftMonitor` (one-pass moments in the scaled
   space).  An update runs when drift triggers, when enough rows are
   pending (``--min-update-rows``), or when the stream ends.
3. **update**: :func:`repro_torch.online.update` folds the new rows into the
   persisted per-degree Gram state (one launch of the hand-written
   ``gram_update_acc`` kernel a folded chunk on the card, ``ihb_degree``
   once a degree with ``--engine fast``): bit-identical to a full streamed
   refit on all rows, O(new rows) of data work.
4. **activate**: the refreshed model is *staged* into the
   :class:`~repro_torch.serving.ModelRegistry` (``activate=False``), its
   engine warmed and its expected probe outputs recorded, then hot-swapped
   atomically.  Serving traffic (closed-loop prober threads through a
   per-version :class:`~repro_torch.serving.MicroBatcher`) never stops;
   every response is checked bitwise against the expected output of the
   version that served it, so a half-swapped or torn model would fail
   loudly.

Everything runs on ``--device`` (default: the CUDA card, which raises
without one; ``--device cpu`` only when asked).

Resilience (the contracts the chaos harness in
:mod:`repro_torch.launch.chaos_vi` exercises):

* **crash recovery**: every phase transition (ingest commit, update start,
  state persisted, version staged/activated) is journaled durably
  (:class:`~repro_torch.resilience.journal.Journal`, fsync per append)
  *before* its effects matter.  The per-update
  :class:`~repro_torch.online.FitState` is checkpointed with content
  checksums under ``workdir/state``.  A SIGKILL'd controller re-run with
  the same ``--workdir`` resumes: it loads the newest *verifiable* state,
  rebuilds + catches up the model with one :func:`~repro_torch.online.
  update` call (the fold's carry-in contract makes the final model
  bit-identical to an uninterrupted run), and the ingest thread skips
  batches whose shards are already committed (re-writing any torn orphan
  shard deterministically, since batches are keyed by ``(seed, batch)``).
* **degrade, don't die**: a failed update / stage / activation is
  journaled, any leaked staged version is removed, and the loop keeps
  serving the last-good version in a ``degraded`` health state; it recovers
  on the next successful update, and only ``--max-failures`` *consecutive*
  failures abort the process.
* **fault injection**: ``--chaos plan.json`` installs a deterministic
  :class:`~repro_torch.resilience.chaos.FaultPlan`; controller sites
  (``controller.update_start`` / ``state_saved`` / ``staged`` /
  ``activated``) fire *after* the corresponding journal append, so a
  ``sigkill`` fault there is exactly a crash between durable transitions.

Reported: per-update fold/replay accounting, staleness (data arrival ->
serving activation latency) per arrival, serve p50/p99 and the update/serve
overlap (requests completed while an update was in flight: the point of the
exercise), plus health / failure / resume accounting.  Where the reference
counts XLA recompiles (each update's ``recompiles``, ``warm_recompiles``,
and ``recompiles`` on resume), the port keeps the keys and counts what it
has instead: kernel builds (:func:`repro_torch.obs.device.compile_snapshot`)
after the base fit.  The kernels are built once a process, so the expected
value is 0.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.continuous_vi --increments 4
    PYTHONPATH=src python -m repro_torch.launch.continuous_vi --device cpu \
        --base-rows 65536 --increment-rows 4096 --drift-at-increment 2
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from .. import obs


# ---------------------------------------------------------------------------
# Data: deterministic arrival batches over the planted-polynomial stream
# ---------------------------------------------------------------------------


def arrival_batch(
    batch_idx: int, rows: int, n: int, seed: int, drifted: bool = False
) -> np.ndarray:
    """One deterministic ingest batch: near-algebraic-set rows (the
    construction behind :func:`repro_torch.data.synthetic.planted_stream_tile`),
    keyed by ``(seed, batch_idx)`` so replays are exact.  ``drifted`` batches
    are affinely shifted — the distribution the model was fitted on moved,
    which the frozen-scaler drift signals (mean shift, out-of-range values)
    are built to catch."""
    rng_w = np.random.default_rng(seed)
    k = min(3, n)
    w = rng_w.uniform(0.5, 1.5, k)
    c = rng_w.uniform(0.5, 1.5)
    rng = np.random.default_rng(np.random.SeedSequence([seed, batch_idx + 1]))
    X = rng.uniform(0.0, 1.0, (rows, n))
    s = (w * X[:, :k] ** 2).sum(axis=1)
    scale = (c / np.maximum(s, 1e-9)) ** 0.5
    X[:, :k] *= scale[:, None]
    X += rng.normal(0.0, 0.03, X.shape)
    if drifted:
        X = 0.6 * X + 0.35
    return X.astype(np.float32)


# ---------------------------------------------------------------------------
# Serving handle: one version's batcher + expected probe outputs
# ---------------------------------------------------------------------------


class ServingHandle:
    """Everything a prober needs from ONE model version, bound together so a
    single atomic reference swap retargets traffic: requests submitted
    through a handle are checked against the expected outputs of exactly the
    version that computes them (a torn swap cannot silently pass)."""

    def __init__(self, version: int, entry, batcher, expected: List[np.ndarray]):
        self.version = version
        self.entry = entry
        self.batcher = batcher
        self.expected = expected


def stage_handle(registry, name: str, version: int, probes, batcher_config):
    """Build the serving handle for a STAGED version: compute its expected
    probe outputs through the (already warmed) engine and start its
    micro-batcher — all before any traffic sees the version."""
    from ..serving import MicroBatcher

    entry = registry.get(name, version)
    expected = [np.asarray(entry.transform(p, scaled=True)) for p in probes]
    batcher = MicroBatcher(entry.engine, head=entry.head, config=batcher_config)
    batcher.start()
    return ServingHandle(version, entry, batcher, expected)


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------


def main(argv=None) -> Dict:
    from .. import _device
    from .. import api as vi_api
    from ..checkpoint import store as ckpt_store
    from ..core.oavi import OAVIConfig
    from ..data.synthetic import write_shards
    from ..online import DriftConfig, DriftMonitor, FitState
    from ..online import fit as online_fit
    from ..online import update as online_update
    from ..resilience import chaos
    from ..resilience.integrity import IntegrityError
    from ..resilience.journal import Journal, JournalError
    from ..serving import (
        BatcherConfig,
        EngineConfig,
        ModelRegistry,
        ShutdownError,
    )
    from ..streaming import ScaledSource, ShardDirSource
    from ..streaming.scaler import StreamingMinMaxScaler

    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--base-rows", type=int, default=4096,
                    help="rows in the initial (offline) fit")
    ap.add_argument("--increments", type=int, default=4,
                    help="number of ingest batches appended after the base")
    ap.add_argument("--increment-rows", type=int, default=1024,
                    help="rows per ingest batch (multiple of --shard-rows)")
    ap.add_argument("--shard-rows", type=int, default=1024)
    ap.add_argument("--chunk-rows", type=int, default=512)
    ap.add_argument("--n", type=int, default=3)
    ap.add_argument("--psi", type=float, default=0.005)
    ap.add_argument("--engine", choices=["fast", "oracle"], default="fast")
    ap.add_argument("--min-update-rows", type=int, default=2048,
                    help="pending-row trigger when drift stays quiet")
    ap.add_argument("--drift-at-increment", type=int, default=-1,
                    help="first drifted ingest batch index (-1: no drift)")
    ap.add_argument("--interval-ms", type=float, default=0.0,
                    help="ingest inter-arrival time (0: replay as fast as possible)")
    ap.add_argument("--serve-threads", type=int, default=2)
    ap.add_argument("--probe-rows", type=str, default="8,24,64",
                    help="comma-separated probe request sizes")
    ap.add_argument("--max-delay-ms", type=float, default=1.0)
    ap.add_argument("--workdir", type=str, default=None,
                    help="persistent working directory: shards/, state/, "
                    "journal.jsonl, final_model/ (default: a fresh temp dir)")
    ap.add_argument("--out", type=str, default=None,
                    help="write the report dict as JSON here")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chaos", type=str, default=None,
                    help="install a JSON FaultPlan (see repro_torch.resilience.chaos)")
    ap.add_argument("--max-failures", type=int, default=3,
                    help="consecutive failed updates tolerated before aborting")
    ap.add_argument("--keep-states", type=int, default=3,
                    help="FitState checkpoint steps retained under workdir/state")
    ap.add_argument("--no-resume", action="store_true",
                    help="ignore an existing journal/state and restart from scratch")
    ap.add_argument("--journal-max-records", type=int, default=0,
                    help="compact the journal after an activation once it "
                    "exceeds this many records (0: never compact)")
    ap.add_argument("--obs-dir", type=str, default=None,
                    help="export obs artifacts here: trace.json "
                    "(Chrome/Perfetto), metrics.jsonl and slo.json — "
                    "re-exported after every activation (flight recorder), "
                    "so a SIGKILL'd run still leaves its last snapshot")
    ap.add_argument("--slo-p99-ms", type=float, default=50.0,
                    help="serve latency SLO: at most --slo-budget of probe "
                    "requests may exceed this many milliseconds")
    ap.add_argument("--slo-budget", type=float, default=0.01,
                    help="error-budget fraction of the latency SLO "
                    "(0.01 == a p99 target at --slo-p99-ms)")
    ap.add_argument("--device", type=str, default=None,
                    help="device of the fits and the engines (default: the "
                    "CUDA card; 'cpu' only when asked)")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)

    if args.increment_rows % args.shard_rows or args.base_rows % args.shard_rows:
        raise SystemExit(
            "--base-rows and --increment-rows must be multiples of "
            "--shard-rows (append only ever adds whole shards)"
        )
    if args.chaos:
        chaos.install(chaos.FaultPlan.load(args.chaos))

    workdir = args.workdir or tempfile.mkdtemp(prefix="continuous_vi_")
    os.makedirs(workdir, exist_ok=True)
    shard_dir = os.path.join(workdir, "shards")
    state_dir = os.path.join(workdir, "state")
    final_dir = os.path.join(workdir, "final_model")
    journal_path = os.path.join(workdir, "journal.jsonl")

    # -- resume decision: a dead process left a durable lineage behind? ----
    # A mid-history-corrupted journal (JournalError) is not resumable — the
    # lineage is a lie; fall through to a loud from-scratch restart.
    try:
        journal = Journal(journal_path)
        resumed = (
            not args.no_resume
            and journal.last("base_fitted") is not None
            and bool(ckpt_store.committed_steps(state_dir))
        )
    except JournalError as e:
        print(f"journal unusable ({e}); restarting from scratch")
        journal = None
        resumed = False

    # the frozen scaler is recomputed, not persisted: the base batch is
    # deterministic in (seed, base_rows, n), so fresh and resumed processes
    # derive bit-identical scaling — a prerequisite for bit-identical folds
    base = arrival_batch(-1, args.base_rows, args.n, args.seed)
    scaler = StreamingMinMaxScaler().fit(base)
    config = OAVIConfig(psi=args.psi, engine=args.engine)
    total_rows = args.base_rows + args.increments * args.increment_rows

    state: Optional[FitState] = None
    if resumed:
        try:
            state = FitState.load(state_dir)  # newest VERIFIABLE committed step
        except (IntegrityError, FileNotFoundError, ValueError) as e:
            print(f"resume failed ({e}); refitting from scratch")
            resumed = False
    if not resumed:
        # fresh start: clear any half-written artifacts of a dead process
        if journal is not None:
            journal.close()
        for p in (shard_dir, state_dir, final_dir):
            if os.path.exists(p):
                shutil.rmtree(p)
        if os.path.exists(journal_path):
            os.remove(journal_path)
        journal = Journal(journal_path)
        write_shards(shard_dir, base, shard_rows=args.shard_rows)

    raw_src = ShardDirSource(shard_dir)
    src = ScaledSource(raw_src, scaler)

    # -- serving scaffolding (probes are deterministic on both paths) ------
    registry = ModelRegistry(device=dev, engine_config=EngineConfig(), warmup=True)
    probe_sizes = [int(s) for s in args.probe_rows.split(",") if s]
    pool = src.read(0, min(args.base_rows, 4096))
    rng = np.random.default_rng(args.seed + 7)
    probes = []
    for q in probe_sizes:
        take = rng.integers(0, pool.shape[0] - q + 1)
        probes.append(np.ascontiguousarray(pool[take : take + q]))
    batcher_config = BatcherConfig(max_delay_ms=args.max_delay_ms)
    handle_lock = threading.Lock()
    handle_box: Dict[str, Optional[ServingHandle]] = {"h": None}
    old_handles: List[ServingHandle] = []
    updating = threading.Event()

    # -- SLO monitor: burn-rate alerting drives the health state -----------
    # Serve latency reads the per-engine serve.transform_seconds histograms
    # the engines already feed; update reliability reads the loop counters
    # incremented below.  An alert degrades health long before
    # --max-failures would abort the process.
    updates_total_ctr = obs.registry().counter("loop.updates_total")
    update_failures_ctr = obs.registry().counter("loop.update_failures")
    slo_monitor = obs.slo.SLOMonitor([
        obs.slo.latency_objective(
            "serve-latency", "serve.transform_seconds",
            threshold_s=args.slo_p99_ms / 1e3, budget_frac=args.slo_budget,
        ),
        # a quarter of update attempts may fail before the budget burns:
        # transient faults are survivable by design (degrade, don't die)
        obs.slo.error_objective(
            "update-errors", "loop.update_failures", "loop.updates_total",
            budget_frac=0.25,
        ),
    ])
    slo_alerts_fired = 0

    def export_obs() -> Dict:
        """Flight-recorder export: trace + metrics + SLO state, atomically
        re-written after every activation so a killed run keeps its last
        consistent snapshot (the chaos harness merges these per-run docs)."""
        os.makedirs(args.obs_dir, exist_ok=True)
        paths = {
            "trace": os.path.join(args.obs_dir, "trace.json"),
            "metrics": os.path.join(args.obs_dir, "metrics.jsonl"),
            "slo": os.path.join(args.obs_dir, "slo.json"),
        }
        obs.export_trace(paths["trace"])
        obs.export_metrics(paths["metrics"])
        tmp = paths["slo"] + ".tmp"
        with open(tmp, "w") as f:
            json.dump(slo_monitor.state(), f, indent=1)
        os.replace(tmp, paths["slo"])
        return paths

    # -- journaled update cycle --------------------------------------------
    # Each chaos site fires AFTER its journal append: a sigkill fault there
    # is a crash between durable transitions, the exact case resume covers.
    arrivals: List[Dict] = []  # {"cum_rows", "t_arrival"} per batch
    arrivals_lock = threading.Lock()
    staleness: List[float] = []
    updates: List[Dict] = []
    failures: List[Dict] = []
    health = {"state": "ok", "consecutive_failures": 0}
    model = None
    fitted_rows = 0
    next_step = (ckpt_store.committed_steps(state_dir)[-1] + 1) if resumed else 1
    update_seq = sum(1 for r in journal.replay() if r["kind"] == "update_start")

    def update_cycle() -> Dict:
        """Fold -> persist state -> stage -> activate, each transition
        journaled first.  On failure: journal it, unwind any staged leak,
        re-raise — the caller decides degraded-vs-fatal."""
        nonlocal model, state, fitted_rows, next_step, update_seq
        builds0 = obs.device.compile_snapshot()[1]
        idx = update_seq
        update_seq += 1
        staged_version = None
        new_handle = None
        updating.set()
        t_up = time.perf_counter()
        updates_total_ctr.inc()
        journal.append("update_start", update=idx, rows_visible=src.num_rows)
        chaos.fire("controller.update_start", update=idx)
        try:
            result = online_update(model, state, src, scaler=scaler, device=dev)
            step = next_step
            result.state.save(state_dir, step=step)
            ckpt_store.cleanup(state_dir, args.keep_states)
            journal.append(
                "state_saved", update=idx, step=step, rows=result.state.num_rows
            )
            chaos.fire("controller.state_saved", update=idx)
            staged = registry.register("vi", result.model, activate=False)
            staged_version = staged.version
            new_handle = stage_handle(
                registry, "vi", staged.version, probes, batcher_config
            )
            journal.append("staged", update=idx, version=staged.version)
            chaos.fire("controller.staged", update=idx)
            registry.activate("vi", staged.version)
            with handle_lock:
                old = handle_box["h"]
                handle_box["h"] = new_handle
            journal.append(
                "activated",
                update=idx,
                version=staged.version,
                rows=result.state.num_rows,
            )
            chaos.fire("controller.activated", update=idx)
            obs.registry().gauge("serve.active_version").set(staged.version)
            obs.event("serve/activate", version=staged.version, update=idx)
            if (
                args.journal_max_records
                and len(journal.replay()) > args.journal_max_records
            ):
                dropped = journal.compact()
                if dropped:
                    print(f"journal compacted: dropped {dropped} records")
        except Exception as e:
            update_failures_ctr.inc()
            journal.append(
                "update_failed", update=idx, error=f"{type(e).__name__}: {e}"
            )
            if new_handle is not None:
                new_handle.batcher.stop()
            if staged_version is not None:
                try:
                    registry.remove("vi", staged_version)
                except KeyError:
                    pass  # never got registered
            raise
        finally:
            updating.clear()
        next_step = step + 1
        model, state = result.model, result.state
        fitted_rows = result.state.num_rows
        if old is not None:
            old_handles.append(old)  # stopped after the loop; drains in-flight
        t_active = time.perf_counter()
        with arrivals_lock:
            for a in arrivals:
                if "t_active" not in a and a["cum_rows"] <= fitted_rows:
                    a["t_active"] = t_active
                    staleness.append(t_active - a["t_arrival"])
        rec = dict(result.stats)
        rec.update(
            # kernel builds during the cycle (the reference's XLA recompiles)
            recompiles=obs.device.compile_snapshot()[1] - builds0,
            # the hand kernels the fold launched (one Gram launch a chunk)
            kernel_launches=dict(result.model.stats["kernel_launches"]),
            version=staged_version,
            rows=fitted_rows,
            time_to_active=t_active - t_up,
        )
        return rec

    # -- initial activation: base fit (fresh) or catch-up update (resumed) --
    resume_info: Dict = {"resumed": False}
    t_base_fit = 0.0
    if resumed:
        t0 = time.perf_counter()
        state_rows = state.num_rows
        rec = update_cycle()  # model=None: rebuild from state + fold pending
        resume_info = {
            "resumed": True,
            "state_rows": int(state_rows),
            "caught_up_rows": int(fitted_rows),
            "recompiles": rec["recompiles"],  # kernel builds of the catch-up
            "time_catch_up": time.perf_counter() - t0,
        }
        print(
            f"resumed: state at m={state_rows}, caught up to m={fitted_rows} "
            f"in {resume_info['time_catch_up']:.2f}s "
            f"({rec['recompiles']} kernel builds)"
        )
    else:
        t0 = time.perf_counter()
        builds0 = obs.device.compile_snapshot()[1]
        model, state = online_fit(
            src, config, chunk_rows=args.chunk_rows, scaler=scaler, device=dev
        )
        t_base_fit = time.perf_counter() - t0
        state.save(state_dir, step=0)
        journal.append("base_fitted", rows=state.num_rows, step=0)
        fitted_rows = state.num_rows
        entry = registry.register("vi", model, activate=True)
        if entry.engine is None:
            raise SystemExit("model set has no fused plan; nothing to serve")
        handle_box["h"] = stage_handle(
            registry, "vi", entry.version, probes, batcher_config
        )
        obs.registry().gauge("serve.active_version").set(entry.version)
        print(
            f"base fit: m={args.base_rows} |G|+|O|={model.stats['G_plus_O']} "
            f"in {t_base_fit:.2f}s "
            f"({obs.device.compile_snapshot()[1] - builds0} kernel builds)"
        )
    monitor = DriftMonitor.from_fit_state(state, DriftConfig())
    if args.obs_dir:
        export_obs()  # first flight-recorder snapshot: base fit / catch-up

    # -- serving traffic: closed-loop probers, bitwise-checked -------------
    stop_serving = threading.Event()
    serve_lat: List[List[float]] = [[] for _ in range(args.serve_threads)]
    serve_overlap = [0] * args.serve_threads  # completed while updating
    serve_mismatch = [0] * args.serve_threads
    serve_fault = [0] * args.serve_threads  # degraded-mode request failures
    serve_errors: List[BaseException] = []

    def prober(tid: int):
        prng = np.random.default_rng(args.seed + 100 + tid)
        while not stop_serving.is_set():
            i = int(prng.integers(0, len(probes)))
            with handle_lock:
                h = handle_box["h"]
            t_req = time.perf_counter()
            try:
                out = h.batcher.submit(probes[i], "transform").result()
            except ShutdownError:
                continue  # handle swapped under us and its batcher stopped
            except RuntimeError:
                serve_fault[tid] += 1  # injected/transient fault; keep serving
                continue
            except BaseException as e:  # pragma: no cover - surfaced below
                serve_errors.append(e)
                return
            serve_lat[tid].append((time.perf_counter() - t_req) * 1e3)
            if updating.is_set():
                serve_overlap[tid] += 1
            if not np.array_equal(out, h.expected[i]):
                serve_mismatch[tid] += 1

    serve_threads = [
        threading.Thread(target=prober, args=(t,), daemon=True)
        for t in range(args.serve_threads)
    ]
    for t in serve_threads:
        t.start()

    # -- ingest: append arrival batches to the shard dir -------------------
    # On resume, batches whose shards are already committed (meta.json rows)
    # are skipped; a torn append (orphan shard files past the committed
    # meta) is harmlessly re-written — batches are deterministic, so the
    # overwrite is bit-identical and the meta commit completes it.
    already = max(0, (raw_src.num_rows - args.base_rows) // args.increment_rows)
    ingest_done = threading.Event()
    ingest_errors: List[BaseException] = []

    def ingest():
        try:
            cum = args.base_rows + already * args.increment_rows
            for b in range(already, args.increments):
                drifted = 0 <= args.drift_at_increment <= b
                rows = arrival_batch(
                    b, args.increment_rows, args.n, args.seed, drifted
                )
                write_shards(shard_dir, rows, append=True)
                cum += args.increment_rows
                journal.append("ingested", batch=b, cum_rows=cum)
                with arrivals_lock:
                    arrivals.append(
                        {"cum_rows": cum, "t_arrival": time.perf_counter()}
                    )
                if args.interval_ms:
                    time.sleep(args.interval_ms / 1e3)
        except BaseException as e:  # surfaced by the controller loop
            ingest_errors.append(e)
        finally:
            ingest_done.set()

    ingest_thread = threading.Thread(target=ingest, daemon=True)
    ingest_thread.start()

    # -- controller: refresh -> drift gate -> update -> stage -> activate --
    try:
        while fitted_rows < total_rows:
            if ingest_errors:
                raise ingest_errors[0]
            alerts = slo_monitor.tick()
            if alerts:
                slo_alerts_fired += len(alerts)
                if health["state"] == "ok":
                    health["state"] = "degraded"
                    a = alerts[0]
                    obs.event(
                        "slo/alert", objective=a["objective"],
                        burn=round(a["burn"], 2),
                    )
                    print(
                        f"SLO alert [{a['objective']}]: burn "
                        f"{a['burn']:.1f}x >= {a['max_burn']}x "
                        f"(bad_frac {a['bad_frac']:.4f} vs budget "
                        f"{a['budget_frac']}); health degraded"
                    )
            elif health["state"] == "degraded" and not health["consecutive_failures"]:
                # the short window drained and updates are healthy again
                health["state"] = "ok"
                obs.event("slo/recovered")
                print("SLO recovered; health ok")
            grew = raw_src.refresh()
            if grew:
                # fold the freshly visible rows into the drift window
                for lo in range(src.num_rows - grew, src.num_rows, args.chunk_rows):
                    monitor.observe(
                        src.read(lo, min(lo + args.chunk_rows, src.num_rows))
                    )
            pending = src.num_rows - fitted_rows
            drifted, sig = monitor.should_refit()
            run = pending > 0 and (
                drifted
                or pending >= args.min_update_rows
                or (ingest_done.is_set() and src.num_rows == total_rows)
            )
            if not run:
                time.sleep(0.002)
                continue

            try:
                rec = update_cycle()
            except Exception as e:
                failures.append(
                    {"update": update_seq - 1, "error": f"{type(e).__name__}: {e}"}
                )
                health["consecutive_failures"] += 1
                health["state"] = "degraded"
                serving = handle_box["h"]
                print(
                    f"update failed ({type(e).__name__}: {e}); serving stays "
                    f"on last-good v{serving.version} "
                    f"[{health['consecutive_failures']} consecutive]"
                )
                if health["consecutive_failures"] > args.max_failures:
                    raise
                time.sleep(0.002)
                continue
            health["consecutive_failures"] = 0
            if not slo_monitor.alerting():
                health["state"] = "ok"
            rec["drift"] = sig
            updates.append(rec)
            monitor.rebase()
            if args.obs_dir:
                export_obs()  # flight recorder: survive a SIGKILL mid-loop
            print(
                f"update v{rec['version']}: +{rec['new_rows']} rows -> "
                f"{fitted_rows}, folded {rec['folded_degrees']} / replayed "
                f"{rec['replayed_degrees']} degrees, "
                f"{rec['recompiles']} kernel builds, active in "
                f"{rec['time_to_active']:.3f}s"
                + (f" [drift: {sig['triggered']}]" if sig["triggered"] else "")
            )
        ingest_thread.join()
        journal.append("done", rows=fitted_rows)
    finally:
        stop_serving.set()
        for t in serve_threads:
            t.join()
        for h in old_handles + [handle_box["h"]]:
            if h is not None:
                h.batcher.stop()
        journal.close()
    if serve_errors:
        raise serve_errors[0]

    # -- final model: persisted for the chaos harness's bit comparison ----
    if os.path.exists(final_dir):
        shutil.rmtree(final_dir)
    vi_api.save(model, final_dir)

    # -- report ------------------------------------------------------------
    # same sketch-backed summary as every other obs report (adds p999)
    lat = obs.percentile_summary(x for per in serve_lat for x in per)
    overlap_requests = int(sum(serve_overlap))
    mismatches = int(sum(serve_mismatch))
    update_busy = float(sum(u["time_to_active"] for u in updates))
    report = {
        "base_rows": args.base_rows,
        "total_rows": total_rows,
        "increments": args.increments,
        "engine": args.engine,
        "time_base_fit": t_base_fit,
        "updates": updates,
        "warm_recompiles": int(sum(u["recompiles"] for u in updates)),
        "versions_activated": 1 + len(updates),
        "staleness_s": staleness,
        "staleness_mean_s": float(np.mean(staleness)) if staleness else 0.0,
        "staleness_max_s": float(np.max(staleness)) if staleness else 0.0,
        "serve": {
            "requests": int(lat["count"]) if lat else 0,
            "mismatches": mismatches,
            "faults": int(sum(serve_fault)),
            "during_update_requests": overlap_requests,
            "lat_p50_ms": lat["p50"] if lat else 0.0,
            "lat_p99_ms": lat["p99"] if lat else 0.0,
            "lat_p999_ms": lat["p999"] if lat else 0.0,
        },
        "overlap": {
            "update_busy_s": update_busy,
            "served_during_updates": overlap_requests,
        },
        "health": health["state"],
        "update_failures": failures,
        "resume": resume_info,
        "workdir": workdir,
        "final_model": final_dir,
    }
    slo_monitor.tick()
    report["slo"] = {
        "alerts_fired": slo_alerts_fired,
        "alerting": slo_monitor.alerting(),
        "p99_target_ms": args.slo_p99_ms,
        "budget_frac": args.slo_budget,
        "objectives": [
            {k: o.get(k) for k in ("name", "kind", "total", "bad", "alerting")}
            for o in slo_monitor.state().get("objectives", [])
        ],
    }
    print(
        f"{len(updates)} updates to m={total_rows} "
        f"({report['warm_recompiles']} warm kernel builds), staleness "
        f"mean {report['staleness_mean_s']:.3f}s max {report['staleness_max_s']:.3f}s"
    )
    print(
        f"served {report['serve']['requests']} probe requests "
        f"(p50 {report['serve']['lat_p50_ms']:.2f}ms, "
        f"p99 {report['serve']['lat_p99_ms']:.2f}ms), "
        f"{overlap_requests} completed during in-flight updates, "
        f"{mismatches} bitwise mismatches"
    )
    if failures:
        print(
            f"{len(failures)} failed update attempts survived in degraded "
            f"mode (final health: {health['state']})"
        )
    if mismatches:
        print("ERROR: served responses diverged from their version's expected output")
    if report["slo"]["alerts_fired"]:
        print(
            f"SLO: {report['slo']['alerts_fired']} alert ticks fired "
            f"(final health: {health['state']})"
        )
    if args.obs_dir:
        paths = export_obs()
        report["obs"] = paths
        print(
            f"obs: trace -> {paths['trace']} (load in ui.perfetto.dev), "
            f"metrics -> {paths['metrics']}, slo -> {paths['slo']}"
        )
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
