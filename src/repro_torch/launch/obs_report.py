"""Render exported obs artifacts as a human-readable report.

Counterpart of ``src/repro/launch/obs_report.py``.  Reads the files a run
leaves in one directory (anything that called
:func:`repro_torch.obs.export_metrics` into ``metrics.jsonl`` and
:func:`repro_torch.obs.export_trace` into ``trace.json``, and an
``slo.json`` where a control loop exported one) and prints:

* the metric table — every counter/gauge/histogram series with its labels,
  histograms as ``n/mean/p50/p99/p999/max`` (the same renderer the in-process
  ``obs.report_lines`` uses, so live and post-hoc reports read identically);
* the SLO state — per-objective burn rates and alert status from
  ``slo.json``;
* a trace summary — per-span event counts and total/mean durations, plus
  instant-event counts, aggregated from the Chrome-trace JSON.

``--follow`` re-reads and re-renders every ``--interval`` seconds; a torn
tail in ``metrics.jsonl`` (the writer died mid-line) is skipped with a
warning instead of crashing the watch loop, and a bad line before the tail
raises.  ``--format json`` emits the aggregates as one JSON document for
scripting.  The trace itself is best viewed in ui.perfetto.dev (or
``chrome://tracing``); this summary is for when all you have is a shell.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.obs_report --obs-dir runs/obs
    PYTHONPATH=src python -m repro_torch.launch.obs_report --obs-dir runs/obs --follow
    PYTHONPATH=src python -m repro_torch.launch.obs_report --obs-dir runs/obs \
        --format json
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional, Tuple

from .. import obs


def load_metric_rows(path: str) -> Tuple[Optional[List[Dict]], List[str]]:
    """Rows of a ``metrics.jsonl`` export plus warnings.

    ``(None, [...])`` when the file is absent.  A torn LAST line (the writer
    was killed mid-append) is skipped with a warning; a bad line anywhere
    else means the file is corrupt, not torn, and raises ``ValueError``.
    """
    if not os.path.exists(path):
        return None, [f"(no metrics at {path})"]
    with open(path) as f:
        lines = [ln for ln in f if ln.strip()]
    rows: List[Dict] = []
    warnings: List[str] = []
    for i, ln in enumerate(lines):
        try:
            rows.append(json.loads(ln))
        except json.JSONDecodeError as e:
            if i == len(lines) - 1:
                warnings.append(f"(torn tail skipped: {path} line {i + 1})")
                break
            raise ValueError(f"corrupt metrics file {path} at line {i + 1}: {e}")
    return rows, warnings


def trace_summary(path: str) -> Optional[Dict]:
    """Aggregate a Chrome-trace JSON into per-name span/event totals."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        doc = json.load(f)
    events = obs.validate_chrome_trace(doc)
    spans: Dict[str, List[float]] = {}
    instants: Dict[str, int] = {}
    for e in events:
        if e["ph"] == "X":
            tot = spans.setdefault(e["name"], [0.0, 0])
            tot[0] += e.get("dur", 0.0)
            tot[1] += 1
        elif e["ph"] == "i":
            instants[e["name"]] = instants.get(e["name"], 0) + 1
    return {
        "events": len(events),
        "spans": {
            name: {"n": int(n), "total_s": dur_us / 1e6,
                   "mean_ms": dur_us / n / 1e3}
            for name, (dur_us, n) in spans.items()
        },
        "instants": instants,
    }


def trace_summary_lines(summary: Optional[Dict], path: str) -> List[str]:
    if summary is None:
        return [f"(no trace at {path})"]
    lines = [f"trace: {summary['events']} events"]
    for name, s in sorted(
        summary["spans"].items(), key=lambda kv: -kv[1]["total_s"]
    ):
        lines.append(
            f"  span  {name:<28} n={s['n']:<7} total={s['total_s']:.3f}s "
            f"mean={s['mean_ms']:.3f}ms"
        )
    for name, n in sorted(summary["instants"].items()):
        lines.append(f"  event {name:<28} n={n}")
    return lines


def load_slo(path: str) -> Optional[Dict]:
    """The ``slo.json`` flight-recorder export (None when absent/torn)."""
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except json.JSONDecodeError:
        return None  # mid-replace torn read under --follow; next pass wins


def slo_lines(slo: Optional[Dict]) -> List[str]:
    if slo is None:
        return []
    lines = [f"slo: {'ALERTING' if slo.get('alerting') else 'ok'} "
             f"({slo.get('ticks', 0)} ticks)"]
    for o in slo.get("objectives", []):
        worst = 0.0
        for w in o.get("windows", []):
            worst = max(worst, w["long"]["burn"], w["short"]["burn"])
        target = (
            f"<= {o['threshold_s'] * 1e3:g}ms" if o["kind"] == "latency"
            else f"{o.get('bad_metric')}/{o.get('total_metric')}"
        )
        lines.append(
            f"  {'ALERT' if o.get('alerting') else 'ok   '} {o['name']:<20} "
            f"{target:<28} bad {o.get('bad', 0):g}/{o.get('total', 0):g} "
            f"budget {o['budget_frac']:g} worst-burn {worst:.2f}x"
        )
    return lines


def report_data(obs_dir: str) -> Dict:
    """Aggregates of one obs export directory (the ``--format json`` doc)."""
    rows, warnings = load_metric_rows(os.path.join(obs_dir, "metrics.jsonl"))
    return {
        "obs_dir": obs_dir,
        "metrics": rows,
        "warnings": warnings,
        "slo": load_slo(os.path.join(obs_dir, "slo.json")),
        "trace": trace_summary(os.path.join(obs_dir, "trace.json")),
    }


def report(obs_dir: str, data: Optional[Dict] = None) -> List[str]:
    """The full human-readable report for one obs export directory."""
    data = data or report_data(obs_dir)
    rows = data["metrics"]
    lines: List[str] = list(data["warnings"])
    if rows:
        # reuse the in-process renderer on the exported rows: the snapshot
        # schema is exactly what export_metrics wrote; drop its trace footer
        # (the real trace summary below aggregates the exported trace.json)
        snap = {"metrics": rows, "trace": {}}
        lines.extend(obs.report_lines(snap)[:-1])
    elif rows is not None:
        lines.append("(no metrics recorded)")
    slo = slo_lines(data["slo"])
    if slo:
        lines.append("")
        lines.extend(slo)
    lines.append("")
    lines.extend(
        trace_summary_lines(data["trace"], os.path.join(obs_dir, "trace.json"))
    )
    return lines


def main(argv=None) -> List[str]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--obs-dir", type=str, default="results/obs",
                    help="directory holding metrics.jsonl, trace.json and "
                    "(where a control loop exported one) slo.json")
    ap.add_argument("--follow", action="store_true",
                    help="re-render every --interval seconds until interrupted")
    ap.add_argument("--interval", type=float, default=2.0)
    ap.add_argument("--format", choices=["text", "json"], default="text",
                    help="json: one machine-readable document on stdout")
    args = ap.parse_args(argv)

    def render() -> List[str]:
        data = report_data(args.obs_dir)
        if args.format == "json":
            lines = [json.dumps(data, indent=1)]
        else:
            lines = report(args.obs_dir, data)
        print("\n".join(lines))
        return lines

    lines = render()
    if args.follow:
        try:
            while True:
                time.sleep(max(args.interval, 0.1))
                print(f"\n--- {time.strftime('%H:%M:%S')} ---")
                lines = render()
        except KeyboardInterrupt:
            pass
    return lines


if __name__ == "__main__":
    main()
