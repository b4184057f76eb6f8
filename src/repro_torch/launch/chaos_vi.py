"""Chaos harness: drive the continuous controller through injected faults.

Counterpart of ``src/repro/launch/chaos_vi.py`` on the port: the same six
scenarios, each asserting a resilience contract of
:mod:`repro_torch.launch.continuous_vi` end to end, with failures scheduled
by a deterministic :class:`~repro_torch.resilience.chaos.FaultPlan` (never
by timing luck).  ``--device`` goes to every controller subprocess and
in-process fit (default: the CUDA card; ``cpu`` only when asked).

``kill_resume``
    SIGKILL the controller subprocess at a chosen journaled phase
    transition (``controller.update_start`` / ``state_saved`` / ``staged``
    / ``activated``), re-run it on the same workdir, and assert the resumed
    final model is **bit-identical** to an uninterrupted run's: the fold
    carry-in contract makes recovery exact, not approximate.  The resumed
    run must also serve with zero bitwise mismatches and build no kernel
    after its first (cold) catch-up update (``warm_recompiles == 0``).
``corrupt_state``
    Flip one bit in the newest committed ``FitState`` checkpoint leaf.
    Resume must land on the older verifiable step (corruption is never
    silent), catch up, and still reach the bit-identical final model.
``degraded_activation``
    Inject an activation failure mid-run.  The controller must keep serving
    the last-good version (zero mismatches), report the failed attempt, and
    recover to ``ok`` health on the retry.
``transient_engine``
    Inject transient device failures at the serving engine.  The batcher's
    bounded retry must absorb them: the run completes with zero mismatches.
``poison_isolation``
    Coalesce a poison request (payload carries the chaos sentinel) with
    good requests.  Bisection must fail exactly the poison request; the
    good requests' results stay bit-identical to direct engine outputs.
``torn_shard``
    Corrupt a shard file after its checksum was recorded.  Reading it must
    raise :class:`~repro_torch.resilience.integrity.IntegrityError` naming
    the file: corrupt rows are never served to a fit.

Trace export: every ``kill_resume`` kill runs its controller subprocesses
with the obs flight recorder on, then merges the killed run's trace with
the resumed run's (:func:`repro_torch.obs.merge_traces`) into ONE
Perfetto-valid ``--trace-dir/kill_<phase>_<at>.trace.json``: two processes
on one timeline with ``chaos/sigkill`` / ``chaos/recovery`` instant markers
at the crash boundary.

Every controller subprocess runs under a ``timeout``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.chaos_vi --fast --out report.json
    PYTHONPATH=src python -m repro_torch.launch.chaos_vi --fast --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

from .. import obs

# small enough that one controller subprocess finishes in seconds, large
# enough for two drift-quiet updates (the phases kill_resume targets)
RUN_ARGS = [
    "--base-rows", "2048",
    "--increments", "2",
    "--increment-rows", "1024",
    "--shard-rows", "1024",
    "--chunk-rows", "512",
    "--min-update-rows", "1024",
    "--serve-threads", "1",
]


def _run_controller(
    workdir: str,
    *,
    chaos_path: Optional[str] = None,
    timeout_s: float = 300.0,
    extra: Optional[List[str]] = None,
    obs_dir: Optional[str] = None,
    device: Optional[str] = None,
) -> subprocess.CompletedProcess:
    out = os.path.join(workdir, "report.json")
    cmd = [
        sys.executable, "-m", "repro_torch.launch.continuous_vi",
        *RUN_ARGS, "--workdir", workdir, "--out", out, *(extra or []),
    ]
    if device is not None:
        cmd += ["--device", str(device)]
    if chaos_path:
        cmd += ["--chaos", chaos_path]
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    if obs_dir:
        # flight recorder on: each activation re-exports, so even the
        # SIGKILL'd run leaves a usable (if partial) trace behind
        cmd += ["--obs-dir", obs_dir]
        env["OBS_ENABLED"] = "1"
    return subprocess.run(
        cmd, capture_output=True, text=True, timeout=timeout_s, env=env
    )


def _merge_scenario_trace(
    trace_dir: str, name: str, run_obs_dirs: List[str], markers: List[Dict]
) -> Optional[str]:
    """Merge per-run flight-recorder traces into one validated timeline."""
    docs = []
    for d in run_obs_dirs:
        p = os.path.join(d, "trace.json")
        if not os.path.exists(p):
            return None  # a run died before its first export; nothing to show
        with open(p) as f:
            docs.append(json.load(f))
    merged = obs.merge_traces(docs, markers=markers)
    obs.validate_chrome_trace(merged)
    os.makedirs(trace_dir, exist_ok=True)
    out = os.path.join(trace_dir, f"{name}.trace.json")
    tmp_path = out + ".tmp"
    with open(tmp_path, "w") as f:
        json.dump(merged, f)
    os.replace(tmp_path, out)
    return out


def _report(workdir: str) -> Dict:
    with open(os.path.join(workdir, "report.json")) as f:
        return json.load(f)


def _final_leaves(workdir: str, device: Optional[str] = None) -> Dict[str, np.ndarray]:
    from .. import api

    model = api.load(os.path.join(workdir, "final_model"), device=device)
    arrays, _ = model.to_state_dict()
    return arrays


def _assert_bit_identical(a: Dict, b: Dict, label: str) -> None:
    assert set(a) == set(b), f"{label}: leaf sets differ"
    for k in sorted(a):
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), (
            f"{label}: leaf {k!r} differs bitwise"
        )


def _check_completed(rep: Dict, label: str) -> None:
    assert rep["serve"]["mismatches"] == 0, f"{label}: served bitwise mismatches"
    assert rep["updates"] or rep["resume"]["resumed"], f"{label}: did no work"


# ---------------------------------------------------------------------------
# Scenarios
# ---------------------------------------------------------------------------


def scenario_kill_resume(
    tmp: str, reference: Dict, phases, trace_dir: Optional[str] = None,
    device: Optional[str] = None,
) -> Dict:
    from ..resilience.chaos import Fault, FaultPlan

    results = []
    for phase, at in phases:
        workdir = os.path.join(tmp, f"kill_{phase}_{at}")
        plan_path = os.path.join(tmp, f"kill_{phase}_{at}.json")
        FaultPlan([Fault(site=f"controller.{phase}", at=at, action="sigkill")]).save(
            plan_path
        )
        obs_killed = os.path.join(workdir, "obs_killed")
        obs_resumed = os.path.join(workdir, "obs_resumed")
        t0 = time.perf_counter()
        proc = _run_controller(workdir, chaos_path=plan_path, obs_dir=obs_killed,
                               device=device)
        assert proc.returncode == -9, (
            f"kill at {phase}#{at}: expected SIGKILL exit, got "
            f"{proc.returncode}\n{proc.stderr[-2000:]}"
        )
        proc = _run_controller(workdir, obs_dir=obs_resumed, device=device)  # resume
        recovery_s = time.perf_counter() - t0
        assert proc.returncode == 0, (
            f"resume after kill at {phase}#{at} failed:\n{proc.stderr[-2000:]}"
        )
        rep = _report(workdir)
        assert rep["resume"]["resumed"], f"kill at {phase}#{at}: did not resume"
        assert rep["warm_recompiles"] == 0, (
            f"kill at {phase}#{at}: kernel builds after catch-up"
        )
        _check_completed(rep, f"kill at {phase}#{at}")
        _assert_bit_identical(
            _final_leaves(workdir, device), reference, f"kill at {phase}#{at}"
        )
        trace_path = None
        if trace_dir:
            trace_path = _merge_scenario_trace(
                trace_dir,
                f"kill_{phase}_{at}",
                [obs_killed, obs_resumed],
                markers=[
                    {"name": "chaos/sigkill", "after_doc": 0,
                     "args": {"phase": phase, "at": at}},
                    {"name": "chaos/recovery", "after_doc": 0,
                     "args": {"phase": phase}},
                ],
            )
        results.append(
            {"phase": phase, "at": at, "recovery_s": recovery_s,
             "caught_up_rows": rep["resume"]["caught_up_rows"],
             "trace": trace_path}
        )
    return {"ok": True, "kills": results}


def scenario_corrupt_state(tmp: str, reference: Dict, device: Optional[str] = None) -> Dict:
    from ..checkpoint import store as ckpt_store
    from ..resilience.integrity import flip_bit

    workdir = os.path.join(tmp, "corrupt_state")
    proc = _run_controller(workdir, device=device)
    assert proc.returncode == 0, proc.stderr[-2000:]
    state_dir = os.path.join(workdir, "state")
    steps = ckpt_store.committed_steps(state_dir)
    assert len(steps) >= 2, "need >= 2 committed steps to exercise fallback"
    head = os.path.join(state_dir, f"step_{steps[-1]:08d}")
    leaves = [n for n in sorted(os.listdir(head)) if n.endswith(".npy")]
    victim = max((os.path.join(head, n) for n in leaves), key=os.path.getsize)
    flip_bit(victim, byte_offset=-1, bit=3)
    # corruption must be detected, never silent
    try:
        ckpt_store.verify(state_dir, steps[-1])
        raise AssertionError("flipped bit passed verification")
    except Exception as e:
        assert os.path.basename(victim) in str(e), "error does not name bad file"
    proc = _run_controller(workdir, device=device)  # resume: falls back to older step
    assert proc.returncode == 0, proc.stderr[-2000:]
    rep = _report(workdir)
    assert rep["resume"]["resumed"]
    assert rep["resume"]["state_rows"] < rep["total_rows"], (
        "resume should have landed on an OLDER (pre-corruption) step"
    )
    _check_completed(rep, "corrupt_state")
    _assert_bit_identical(_final_leaves(workdir, device), reference, "corrupt_state")
    return {"ok": True, "fallback_from_rows": rep["resume"]["state_rows"]}


def scenario_degraded_activation(tmp: str, reference: Dict,
                                 device: Optional[str] = None) -> Dict:
    from ..resilience.chaos import Fault, FaultPlan

    workdir = os.path.join(tmp, "degraded_activation")
    plan_path = os.path.join(tmp, "degraded_activation.json")
    FaultPlan([Fault(site="registry.activate", at=1, action="raise")]).save(plan_path)
    proc = _run_controller(workdir, chaos_path=plan_path, device=device)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rep = _report(workdir)
    assert len(rep["update_failures"]) == 1, "activation fault not recorded"
    assert "InjectedFault" in rep["update_failures"][0]["error"]
    assert rep["health"] == "ok", "controller did not recover after the retry"
    _check_completed(rep, "degraded_activation")
    _assert_bit_identical(_final_leaves(workdir, device), reference, "degraded_activation")
    return {"ok": True, "failures": rep["update_failures"]}


def scenario_transient_engine(tmp: str, reference: Dict,
                              device: Optional[str] = None) -> Dict:
    from ..resilience.chaos import Fault, FaultPlan

    workdir = os.path.join(tmp, "transient_engine")
    plan_path = os.path.join(tmp, "transient_engine.json")
    # two one-shot transient faults at serving-path device calls; bounded
    # retry (max_retries=2 default) must absorb each
    FaultPlan(
        [
            Fault(site="engine.transform", at=20, action="raise_transient"),
            Fault(site="engine.transform", at=40, action="raise_transient"),
        ]
    ).save(plan_path)
    proc = _run_controller(workdir, chaos_path=plan_path, device=device)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rep = _report(workdir)
    _check_completed(rep, "transient_engine")
    _assert_bit_identical(_final_leaves(workdir, device), reference, "transient_engine")
    return {"ok": True, "serve_faults": rep["serve"]["faults"]}


def scenario_poison_isolation(tmp: str, device: Optional[str] = None) -> Dict:
    """In-process: a poison request coalesced with good ones fails alone;
    the good requests' outputs stay bit-identical to direct evaluation."""
    from .. import api
    from ..resilience import chaos
    from ..resilience.chaos import Fault, FaultPlan, PoisonRequestError
    from ..serving import BatcherConfig, MicroBatcher, TransformEngine

    rng0 = np.random.default_rng(5)
    X = rng0.uniform(0, 1, (512, 3)).astype(np.float32)
    X[:, 2] = np.clip(X[:, 0] * X[:, 1] + rng0.normal(0, 0.01, 512), 0, 1)
    model = api.fit(X, method="oavi:fast", psi=0.01, backend="local", cap_terms=64,
                    device=device)
    engine = TransformEngine([model], device=device)
    engine.warmup()
    rng = np.random.default_rng(11)
    good = [rng.uniform(0, 1, (q, 3)).astype(np.float32) for q in (4, 8, 5)]
    expected = [np.asarray(engine.transform(g)) for g in good]
    poison = rng.uniform(0, 1, (3, 3)).astype(np.float32)
    poison[1, 2] = chaos.POISON_SENTINEL

    chaos.install(FaultPlan([Fault(site="engine.transform", action="poison")]))
    try:
        batcher = MicroBatcher(
            engine, config=BatcherConfig(max_delay_ms=20.0)
        )
        batcher.start()
        try:
            futs = [batcher.submit(g, "transform") for g in good]
            bad = batcher.submit(poison, "transform")
            outs = [f.result(timeout=60) for f in futs]
            try:
                bad.result(timeout=60)
                raise AssertionError("poison request did not fail")
            except PoisonRequestError:
                pass
        finally:
            batcher.stop()
    finally:
        chaos.uninstall()
    for out, exp in zip(outs, expected):
        assert np.array_equal(out, exp), (
            "good request diverged after poison bisection"
        )
    assert batcher.stats["isolated_failures"] >= 1
    return {
        "ok": True,
        "bisections": batcher.stats["bisections"],
        "isolated_failures": batcher.stats["isolated_failures"],
    }


def scenario_torn_shard(tmp: str) -> Dict:
    """In-process: corrupt a shard after its checksum commits; the reader
    must refuse it loudly, naming the file."""
    from ..data.synthetic import write_shards
    from ..resilience.integrity import IntegrityError, flip_bit
    from ..streaming.source import ShardDirSource

    shard_dir = os.path.join(tmp, "torn_shards")
    rng = np.random.default_rng(3)
    write_shards(shard_dir, rng.uniform(0, 1, (256, 4)).astype(np.float32),
                 shard_rows=64)
    victim = os.path.join(shard_dir, "shard_00002.npy")
    flip_bit(victim, byte_offset=200, bit=5)
    src = ShardDirSource(shard_dir)
    assert np.asarray(src.read(0, 64)).shape == (64, 4)  # clean shard serves
    try:
        src.read(128, 192)  # rows of the corrupted shard
        raise AssertionError("corrupt shard rows were served")
    except IntegrityError as e:
        assert "shard_00002.npy" in str(e), "error does not name the bad shard"
    return {"ok": True}


# ---------------------------------------------------------------------------


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--fast", action="store_true",
                    help="kill at 2 phases instead of all journaled phases")
    ap.add_argument("--scenarios", type=str, default=None,
                    help="comma-separated subset to run (default: all)")
    ap.add_argument("--tmp", type=str, default=None)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--trace-dir", type=str, default="results/chaos",
                    help="write merged kill/resume Perfetto traces here "
                    "(empty string: skip trace export)")
    ap.add_argument("--device", type=str, default=None,
                    help="device of the controllers and in-process fits "
                    "(default: the CUDA card; 'cpu' only when asked)")
    args = ap.parse_args(argv)
    from .. import _device

    _device.resolve(args.device)  # no card and no --device cpu: raise here
    dev = args.device

    tmp = args.tmp or tempfile.mkdtemp(prefix="chaos_vi_")
    os.makedirs(tmp, exist_ok=True)
    wanted = set(args.scenarios.split(",")) if args.scenarios else None

    def want(name: str) -> bool:
        return wanted is None or name in wanted

    report: Dict = {"tmp": tmp, "scenarios": {}}
    t_all = time.perf_counter()

    reference: Optional[Dict[str, np.ndarray]] = None
    needs_ref = any(
        want(s)
        for s in ("kill_resume", "corrupt_state", "degraded_activation",
                  "transient_engine")
    )
    if needs_ref:
        ref_dir = os.path.join(tmp, "reference")
        print("chaos_vi: uninterrupted reference run ...")
        proc = _run_controller(ref_dir, device=dev)
        assert proc.returncode == 0, proc.stderr[-2000:]
        reference = _final_leaves(ref_dir, dev)
        ref_rep = _report(ref_dir)
        assert ref_rep["serve"]["mismatches"] == 0
        report["reference_rows"] = ref_rep["total_rows"]

    if want("kill_resume"):
        phases = [("state_saved", 1), ("activated", 1)]
        if not args.fast:
            phases += [("update_start", 1), ("staged", 1), ("update_start", 2)]
        print(f"chaos_vi: kill_resume at {len(phases)} phases ...")
        report["scenarios"]["kill_resume"] = scenario_kill_resume(
            tmp, reference, phases, trace_dir=args.trace_dir or None, device=dev
        )
        traces = [
            k["trace"] for k in report["scenarios"]["kill_resume"]["kills"]
            if k.get("trace")
        ]
        if traces:
            print(f"chaos_vi: {len(traces)} merged traces -> {args.trace_dir}")
    if want("corrupt_state"):
        print("chaos_vi: corrupt_state ...")
        report["scenarios"]["corrupt_state"] = scenario_corrupt_state(tmp, reference, dev)
    if want("degraded_activation"):
        print("chaos_vi: degraded_activation ...")
        report["scenarios"]["degraded_activation"] = scenario_degraded_activation(
            tmp, reference, dev
        )
    if want("transient_engine"):
        print("chaos_vi: transient_engine ...")
        report["scenarios"]["transient_engine"] = scenario_transient_engine(
            tmp, reference, dev
        )
    if want("poison_isolation"):
        print("chaos_vi: poison_isolation ...")
        report["scenarios"]["poison_isolation"] = scenario_poison_isolation(tmp, dev)
    if want("torn_shard"):
        print("chaos_vi: torn_shard ...")
        report["scenarios"]["torn_shard"] = scenario_torn_shard(tmp)

    report["time_total_s"] = time.perf_counter() - t_all
    ok = all(s.get("ok") for s in report["scenarios"].values())
    report["ok"] = ok
    print(
        f"chaos_vi: {len(report['scenarios'])} scenarios "
        f"{'PASSED' if ok else 'FAILED'} in {report['time_total_s']:.1f}s"
    )
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    if not ok:  # pragma: no cover - assertions raise before this
        raise SystemExit(1)
    return report


if __name__ == "__main__":
    main()
