"""SLO objectives and multi-window burn-rate alerting over the registry.

Counterpart of ``src/repro/obs/slo.py``, kept as the port's own copy (standard
library and :mod:`.metrics` only).

An :class:`Objective` defines a service-level target as a *bad-event
fraction budget* evaluated against metrics that already exist in the
:mod:`repro_torch.obs.metrics` registry:

- a **latency** objective reads a latency histogram and counts samples above
  a threshold as bad (``p99 <= 25ms`` becomes ``budget_frac=0.01`` over
  ``threshold_s=0.025`` — at most 1% of requests may exceed the threshold);
- an **events** objective reads a bad/total counter pair (update failures
  over update attempts).

:class:`SLOMonitor` snapshots the cumulative metrics on every :meth:`tick`
and evaluates *burn rates* over sliding windows by subtracting snapshots —
exact, because sketch bucket counts and counters are cumulative.  The burn
rate is the observed bad fraction divided by the budget fraction: burn 1.0
consumes the error budget exactly at the sustainable rate, burn 14.4 on a
5%-of-period window is the classic page-now threshold.  An objective alerts
when BOTH the long and the short window of any :class:`BurnWindow` pair
exceed that pair's threshold — the long window provides evidence, the short
window confirms the problem is still happening (so recovered incidents stop
alerting as soon as the short window drains).

A control loop drives its health state from this monitor (alert ->
``degraded`` long before a failure budget would kill the loop) and exports
:meth:`SLOMonitor.state` as ``slo.json`` for ``launch/obs_report.py``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .core import registry as _global_registry
from .metrics import Counter, Histogram, Registry

__all__ = [
    "BurnWindow",
    "DEFAULT_WINDOWS",
    "Objective",
    "SLOMonitor",
    "error_objective",
    "latency_objective",
]


@dataclasses.dataclass(frozen=True)
class BurnWindow:
    """One (long, short) burn-rate window pair with its alert threshold."""

    long_s: float
    short_s: float
    max_burn: float


# Scaled-down versions of the classic 1h/5m + 6h/30m pairs: the continuous
# loop's whole lifetime is minutes, so windows are seconds here.  Callers
# with real uptime pass their own.
DEFAULT_WINDOWS: Tuple[BurnWindow, ...] = (
    BurnWindow(long_s=60.0, short_s=5.0, max_burn=14.4),
    BurnWindow(long_s=300.0, short_s=30.0, max_burn=6.0),
)


@dataclasses.dataclass(frozen=True)
class Objective:
    """A bad-fraction budget over registry metrics (build via the helpers)."""

    name: str
    budget_frac: float
    kind: str  # "latency" | "events"
    metric: Optional[str] = None          # latency: histogram name
    threshold_s: float = 0.0              # latency: bad above this
    labels: Tuple[Tuple[str, str], ...] = ()
    bad_metric: Optional[str] = None      # events: numerator counter
    total_metric: Optional[str] = None    # events: denominator counter

    def describe(self) -> Dict:
        d = {"name": self.name, "kind": self.kind,
             "budget_frac": self.budget_frac}
        if self.kind == "latency":
            d["metric"] = self.metric
            d["threshold_s"] = self.threshold_s
            if self.labels:
                d["labels"] = dict(self.labels)
        else:
            d["bad_metric"] = self.bad_metric
            d["total_metric"] = self.total_metric
        return d


def latency_objective(name: str, metric: str, threshold_s: float,
                      budget_frac: float = 0.01, **labels) -> Objective:
    """At most ``budget_frac`` of samples in ``metric`` above ``threshold_s``
    (``budget_frac=0.01`` == a p99 target at the threshold)."""
    if not 0.0 < budget_frac < 1.0:
        raise ValueError(f"budget_frac must be in (0, 1), got {budget_frac}")
    return Objective(
        name=name, budget_frac=budget_frac, kind="latency", metric=metric,
        threshold_s=float(threshold_s),
        labels=tuple(sorted((k, str(v)) for k, v in labels.items())),
    )


def error_objective(name: str, bad_metric: str, total_metric: str,
                    budget_frac: float = 0.01) -> Objective:
    """At most ``budget_frac`` of ``total_metric`` events in ``bad_metric``."""
    if not 0.0 < budget_frac < 1.0:
        raise ValueError(f"budget_frac must be in (0, 1), got {budget_frac}")
    return Objective(name=name, budget_frac=budget_frac, kind="events",
                     bad_metric=bad_metric, total_metric=total_metric)


class SLOMonitor:
    """Evaluate objectives by differencing cumulative metric snapshots.

    ``tick()`` is cheap (a registry scan plus O(windows) subtraction) and is
    meant to run once per control-loop iteration.  ``now`` is injectable for
    deterministic tests; it defaults to ``time.monotonic``.
    """

    def __init__(self, objectives: Sequence[Objective],
                 windows: Sequence[BurnWindow] = DEFAULT_WINDOWS,
                 registry: Optional[Registry] = None,
                 now: Callable[[], float] = time.monotonic) -> None:
        if not objectives:
            raise ValueError("SLOMonitor needs at least one objective")
        self._objectives = list(objectives)
        self._windows = tuple(windows)
        self._registry = registry
        self._now = now
        self._horizon = max(w.long_s for w in self._windows)
        # per objective: cumulative (t, total, bad) snapshots, oldest first
        self._history: Dict[str, List[Tuple[float, float, float]]] = {
            o.name: [] for o in self._objectives
        }
        self._state: Dict = {"objectives": [], "alerting": False, "ticks": 0}

    def _reg(self) -> Registry:
        return self._registry if self._registry is not None else _global_registry()

    def _totals(self, o: Objective) -> Tuple[float, float]:
        """Cumulative (total, bad) event counts for an objective, now."""
        reg = self._reg()
        if o.kind == "latency":
            want = dict(o.labels)
            total = bad = 0.0
            for got, metric in reg.find(o.metric or ""):
                if not isinstance(metric, Histogram):
                    continue
                if any(got.get(k) != v for k, v in want.items()):
                    continue
                total += metric.count
                bad += metric.count_above(o.threshold_s)
            return total, bad
        bad = sum(m.value for _, m in reg.find(o.bad_metric or "")
                  if isinstance(m, Counter))
        total = sum(m.value for _, m in reg.find(o.total_metric or "")
                    if isinstance(m, Counter))
        return float(total), float(bad)

    @staticmethod
    def _window_burn(hist: List[Tuple[float, float, float]], t: float,
                     window_s: float, budget_frac: float) -> Dict:
        """Burn rate over [t - window_s, t] from cumulative snapshots."""
        cur = hist[-1]
        base = hist[0]
        for rec in hist:  # latest snapshot at or before the window start
            if rec[0] <= t - window_s:
                base = rec
            else:
                break
        d_total = cur[1] - base[1]
        d_bad = cur[2] - base[2]
        frac = (d_bad / d_total) if d_total > 0 else 0.0
        return {
            "window_s": window_s,
            "events": d_total,
            "bad": d_bad,
            "bad_frac": frac,
            "burn": frac / budget_frac,
        }

    def tick(self, now: Optional[float] = None) -> List[Dict]:
        """Record one snapshot and re-evaluate; returns active alerts."""
        t = self._now() if now is None else float(now)
        alerts: List[Dict] = []
        obj_states: List[Dict] = []
        for o in self._objectives:
            total, bad = self._totals(o)
            hist = self._history[o.name]
            hist.append((t, total, bad))
            # keep one snapshot older than the horizon as the window base
            while len(hist) > 2 and hist[1][0] <= t - self._horizon:
                hist.pop(0)
            windows = []
            alerting = False
            for w in self._windows:
                long_b = self._window_burn(hist, t, w.long_s, o.budget_frac)
                short_b = self._window_burn(hist, t, w.short_s, o.budget_frac)
                fired = (long_b["burn"] >= w.max_burn
                         and short_b["burn"] >= w.max_burn)
                alerting = alerting or fired
                windows.append({
                    "max_burn": w.max_burn,
                    "long": long_b,
                    "short": short_b,
                    "alerting": fired,
                })
            state = dict(o.describe())
            state.update({
                "total": total,
                "bad": bad,
                "windows": windows,
                "alerting": alerting,
            })
            obj_states.append(state)
            if alerting:
                worst = max(
                    (w for w in windows if w["alerting"]),
                    key=lambda w: w["long"]["burn"],
                )
                alerts.append({
                    "objective": o.name,
                    "burn": worst["long"]["burn"],
                    "max_burn": worst["max_burn"],
                    "bad_frac": worst["long"]["bad_frac"],
                    "budget_frac": o.budget_frac,
                })
        self._state = {
            "objectives": obj_states,
            "alerting": bool(alerts),
            "ticks": self._state.get("ticks", 0) + 1,
            "t": t,
        }
        return alerts

    def alerting(self) -> bool:
        return bool(self._state.get("alerting"))

    def state(self) -> Dict:
        """JSON-serializable view of the last evaluation (``slo.json``)."""
        return self._state
