"""Rolling perf baseline + noise-aware regression gate over BENCH history.

Counterpart of ``src/repro/obs/baseline.py``, kept as the port's own copy
(standard library and :mod:`.metrics` only).

A benchmark history (``results/history.jsonl``; the JAX package's
``benchmarks/history.py`` writes one) holds one record per invocation: git
SHA, an environment fingerprint, every flattened ``BENCH_*.json``
headline number, and serialized histogram-sketch snapshots of the run's
timing series.  This module is the *pure* half of the gate — parsing and
the regression decision — so it is unit-testable without running a single
benchmark.

The decision rule per timing metric (keys whose leaf field looks like a
duration) is spread-aware rather than mean-based:

- baseline = the **minimum** across history (best observed — timing noise is
  one-sided, the min is the closest to the true cost);
- the allowance is ``baseline * max(1 + tolerance, observed_spread *
  (1 + spread_margin))`` where ``observed_spread = max/min`` over history —
  a metric that historically wobbles 1.4x is allowed to wobble 1.4x, while a
  stable one gets the flat tolerance;
- metrics faster than ``min_time_s`` are skipped (they time the clock, not
  the code), and metrics with fewer than ``min_records`` history points are
  reported but never failed.

Sketch snapshots give a second, distribution-level band: history sketches
for a series merge exactly (bucket counts add), and the current run's p99
must stay within the merged baseline's p99 times the same tolerance plus
two sketch bucket widths.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from .metrics import Histogram, bucket_relative_error

__all__ = [
    "RECORD_SCHEMA",
    "check_regression",
    "is_time_metric",
    "load_history",
    "merge_sketches",
]

RECORD_SCHEMA = "bench-history.v1"

# leaf-field suffixes that mark a flattened BENCH number as a duration
_TIME_SUFFIXES = ("_s", "_ms", "_us", "_seconds", "_sec")
_TIME_FIELDS = {"seconds", "time_total", "wall_s"}


def is_time_metric(key: str) -> bool:
    """Whether a flattened metric key (``bench/section:field``) is a duration
    (only durations are gated — counts and bytes regress differently)."""
    field = key.rsplit(":", 1)[-1]
    return field in _TIME_FIELDS or field.endswith(_TIME_SUFFIXES)


def load_history(path: str) -> Tuple[List[Dict], List[str]]:
    """Parse a history JSONL file; returns (records, warnings).

    A torn/truncated **last** line (the writer died mid-append) is skipped
    with a warning — the same contract as the resilience journal's torn-tail
    handling.  Malformed JSON *before* the tail means real corruption and
    raises ``ValueError`` loudly.  Records with a foreign schema tag are
    skipped with a warning so future schema bumps stay readable.
    """
    records: List[Dict] = []
    warnings: List[str] = []
    try:
        with open(path) as f:
            lines = f.readlines()
    except FileNotFoundError:
        return [], [f"{path}: no history yet"]
    stripped = [(i, ln.strip()) for i, ln in enumerate(lines)]
    stripped = [(i, ln) for i, ln in stripped if ln]
    for pos, (lineno, line) in enumerate(stripped):
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            if pos == len(stripped) - 1:
                warnings.append(
                    f"{path}:{lineno + 1}: torn tail skipped ({e.msg})")
                break
            raise ValueError(
                f"{path}:{lineno + 1}: corrupt history record mid-file: {e}"
            ) from e
        if rec.get("schema") != RECORD_SCHEMA:
            warnings.append(
                f"{path}:{lineno + 1}: skipping schema "
                f"{rec.get('schema')!r} (want {RECORD_SCHEMA!r})")
            continue
        records.append(rec)
    return records, warnings


def merge_sketches(records: List[Dict], series: str) -> Optional[Histogram]:
    """Exact merge of one series' sketch snapshots across history records."""
    merged: Optional[Histogram] = None
    for rec in records:
        state = (rec.get("sketches") or {}).get(series)
        if not state:
            continue
        h = Histogram.from_state(state)
        merged = h if merged is None else merged.merge(h)
    return merged


def check_regression(
    current: Dict,
    baseline_records: List[Dict],
    *,
    tolerance: float = 0.25,
    spread_margin: float = 0.05,
    min_records: int = 2,
    min_time_s: float = 0.005,
    min_sketch_count: int = 20,
) -> Dict:
    """Compare one history record against the rolling baseline.

    Returns ``{"status": "pass" | "fail" | "insufficient", "findings": [...],
    "checked": int, "skipped": [...], "warnings": [...]}``.  ``findings`` are
    dicts naming the metric, the current value, the baseline, and the
    allowance that was exceeded.  ``insufficient`` means no metric had
    enough history to gate — a vacuous pass the caller should surface.
    """
    findings: List[Dict] = []
    skipped: List[str] = []
    checked = 0

    metrics = current.get("metrics") or {}
    for key in sorted(metrics):
        if not is_time_metric(key):
            continue
        try:
            cur = float(metrics[key])
        except (TypeError, ValueError):
            continue
        vals = []
        for rec in baseline_records:
            v = (rec.get("metrics") or {}).get(key)
            if isinstance(v, (int, float)):
                vals.append(float(v))
        if len(vals) < min_records:
            skipped.append(f"{key}: only {len(vals)} history point(s)")
            continue
        best, worst = min(vals), max(vals)
        if best < min_time_s:
            skipped.append(f"{key}: baseline {best:.3g}s below timing floor")
            continue
        spread = worst / best
        allowed = best * max(1.0 + tolerance, spread * (1.0 + spread_margin))
        checked += 1
        if cur > allowed:
            findings.append({
                "kind": "metric",
                "key": key,
                "current": cur,
                "baseline_best": best,
                "baseline_worst": worst,
                "allowed": allowed,
                "ratio": cur / best,
            })

    cur_sketches = current.get("sketches") or {}
    band_pad = 2.0 * bucket_relative_error()
    for series in sorted(cur_sketches):
        merged = merge_sketches(baseline_records, series)
        if merged is None or merged.count < min_sketch_count:
            skipped.append(f"sketch {series}: insufficient baseline samples")
            continue
        cur_h = Histogram.from_state(cur_sketches[series])
        cur_p99 = cur_h.quantile(0.99)
        base_p99 = merged.quantile(0.99)
        if cur_p99 is None or base_p99 is None or base_p99 < min_time_s:
            skipped.append(f"sketch {series}: below timing floor or empty")
            continue
        allowed = base_p99 * (1.0 + tolerance + band_pad)
        checked += 1
        if cur_p99 > allowed:
            findings.append({
                "kind": "sketch",
                "key": series,
                "current": cur_p99,
                "baseline_best": base_p99,
                "allowed": allowed,
                "ratio": cur_p99 / base_p99,
            })

    if checked == 0:
        status = "insufficient"
    else:
        status = "fail" if findings else "pass"
    return {
        "status": status,
        "findings": findings,
        "checked": checked,
        "skipped": skipped,
        "tolerance": tolerance,
    }
