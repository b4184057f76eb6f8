"""Metric primitives: counters, gauges, and mergeable streaming histograms.

Counterpart of ``src/repro/obs/metrics.py`` (standard library only), kept as
the port's own copy so that ``repro_torch`` imports nothing of ``repro``;
the sketch, its buckets and its summaries are the reference's to the bit.

These are the always-on building blocks of ``repro_torch.obs``.  Unlike spans and
trace events (which are gated by :func:`repro_torch.obs.enabled`), metric objects
are plain thread-safe accumulators that components own directly — the public
``stats`` dicts across the repo are views over them, so they must keep
working even when tracing is disabled.

The histogram is a fixed log-bucket sketch: values land in geometric buckets
with ``BUCKETS_PER_OCTAVE`` buckets per factor of 2, so any quantile is
recoverable to within one bucket (a multiplicative error of at most
``2**(1/BUCKETS_PER_OCTAVE) ~ 4.4%``) without storing samples.  Sketches
merge by adding bucket counts, which makes the merge exact and associative —
per-thread or per-process sketches can be combined in any order.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "BUCKETS_PER_OCTAVE",
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "bucket_relative_error",
]

# Bucket resolution of the log sketch.  16 buckets per octave keeps the
# worst-case quantile error under 4.4% while a full lognormal latency
# distribution still fits in a few dozen sparse buckets.
BUCKETS_PER_OCTAVE = 16

_LOG2 = math.log(2.0)


def bucket_relative_error() -> float:
    """Worst-case multiplicative quantile error of the sketch (one bucket)."""
    return 2.0 ** (1.0 / BUCKETS_PER_OCTAVE) - 1.0


def _bucket_index(value: float) -> int:
    """Map a positive value to its geometric bucket index.

    Bucket ``i`` covers ``(2**((i-1)/B), 2**(i/B)]`` so the bucket's upper
    edge is an upper bound for every sample in it.
    """
    return math.ceil(math.log(value) / _LOG2 * BUCKETS_PER_OCTAVE)


def _bucket_upper(index: int) -> float:
    return 2.0 ** (index / BUCKETS_PER_OCTAVE)


class Counter:
    """Monotonic thread-safe counter."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, amount: int = 1) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> int:
        return self._value

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self._value}


class Gauge:
    """Last-write-wins value with an optional high-water helper."""

    __slots__ = ("_lock", "_value")

    def __init__(self, value: float = 0.0) -> None:
        self._lock = threading.Lock()
        self._value = value

    def set(self, value: float) -> None:
        with self._lock:
            self._value = value

    def set_max(self, value: float) -> None:
        with self._lock:
            if value > self._value:
                self._value = value

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self._value}


class Histogram:
    """Mergeable streaming histogram over positive values (log-bucket sketch).

    Tracks exact ``count``/``sum``/``min``/``max`` alongside sparse geometric
    bucket counts.  Non-positive values are legal and land in a dedicated
    underflow bucket (they count toward ``count`` and quantile rank but
    report as 0.0).
    """

    __slots__ = ("_lock", "_buckets", "_underflow", "count", "sum", "min", "max")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._buckets: Dict[int, int] = {}
        self._underflow = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self.count += 1
            self.sum += value
            if value < self.min:
                self.min = value
            if value > self.max:
                self.max = value
            if value <= 0.0:
                self._underflow += 1
            else:
                idx = _bucket_index(value)
                self._buckets[idx] = self._buckets.get(idx, 0) + 1

    def observe_many(self, values: Iterable[float]) -> None:
        for v in values:
            self.observe(v)

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other`` into ``self`` (exact: bucket counts add)."""
        with other._lock:
            buckets = dict(other._buckets)
            underflow = other._underflow
            count, total = other.count, other.sum
            lo, hi = other.min, other.max
        with self._lock:
            for idx, c in buckets.items():
                self._buckets[idx] = self._buckets.get(idx, 0) + c
            self._underflow += underflow
            self.count += count
            self.sum += total
            if lo < self.min:
                self.min = lo
            if hi > self.max:
                self.max = hi
        return self

    def quantile(self, q: float) -> Optional[float]:
        """Upper-edge quantile estimate, clamped to the observed [min, max].

        Returns None on an empty sketch — there is no sample to estimate, and
        a fabricated 0.0 would read as a real (excellent) latency downstream.
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            if self.count == 0:
                return None
            rank = q * (self.count - 1)  # np.percentile-style rank
            seen = self._underflow
            if rank < seen:
                return max(self.min, 0.0) if self.min <= 0.0 else self.min
            for idx in sorted(self._buckets):
                seen += self._buckets[idx]
                if rank < seen:
                    est = _bucket_upper(idx)
                    return min(max(est, self.min), self.max)
            return self.max

    def count_above(self, threshold: float) -> int:
        """Samples strictly above ``threshold`` (to sketch resolution).

        Counts every bucket whose upper edge exceeds the threshold, so values
        in the threshold's own bucket are attributed as "above" — the estimate
        errs pessimistic by at most one bucket (~4.4%).  Used by the SLO
        monitor to turn a latency sketch into a bad-event count.
        """
        with self._lock:
            above = sum(c for idx, c in self._buckets.items()
                        if _bucket_upper(idx) > threshold)
            if threshold < 0.0:
                above += self._underflow
            return above

    def to_state(self) -> dict:
        """Serializable sketch state; exact round-trip via :meth:`from_state`.

        Bucket keys are stringified for JSON; ``min``/``max`` are None when
        empty (the inf sentinels are not JSON-representable).
        """
        with self._lock:
            return {
                "buckets": {str(i): c for i, c in self._buckets.items()},
                "underflow": self._underflow,
                "count": self.count,
                "sum": self.sum,
                "min": None if self.count == 0 else self.min,
                "max": None if self.count == 0 else self.max,
            }

    @classmethod
    def from_state(cls, state: dict) -> "Histogram":
        h = cls()
        h._buckets = {int(i): int(c) for i, c in state.get("buckets", {}).items()}
        h._underflow = int(state.get("underflow", 0))
        h.count = int(state.get("count", 0))
        h.sum = float(state.get("sum", 0.0))
        h.min = math.inf if state.get("min") is None else float(state["min"])
        h.max = -math.inf if state.get("max") is None else float(state["max"])
        return h

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    @property
    def num_buckets(self) -> int:
        """Occupied sketch buckets — the histogram's actual state size."""
        with self._lock:
            return len(self._buckets) + (1 if self._underflow else 0)

    def summary(self) -> dict:
        """Point-in-time summary with SLO quantiles.

        An empty sketch returns a None-valued summary (``count`` 0, ``sum``
        0.0, every statistic None) rather than NaN or a divide-by-zero — the
        consumer can tell "no data" from "observed zeros".
        """
        with self._lock:
            count, total = self.count, self.sum
            lo = self.min if count else None
            hi = self.max if count else None
        return {
            "count": count,
            "sum": total,
            "mean": total / count if count else None,
            "min": lo,
            "max": hi,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
            "p999": self.quantile(0.999),
        }

    def snapshot(self) -> dict:
        snap = self.summary()
        snap["type"] = "histogram"
        return snap


_METRIC_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Registry:
    """Name + label-set keyed metric store.

    Keys are ``(name, frozenset(labels.items()))`` so label order never
    matters.  ``counter``/``gauge``/``histogram`` are get-or-create and the
    type of an existing name+labels pair is sticky (mismatches raise).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, frozenset], object] = {}

    def _get(self, kind: str, name: str, labels: Dict[str, object]):
        key = (name, frozenset((k, str(v)) for k, v in labels.items()))
        cls = _METRIC_TYPES[kind]
        with self._lock:
            metric = self._metrics.get(key)
            if metric is None:
                metric = cls()
                self._metrics[key] = metric
            elif not isinstance(metric, cls):
                raise TypeError(
                    f"metric {name!r} with labels {dict(labels)!r} already "
                    f"registered as {type(metric).__name__}, not {kind}"
                )
            return metric

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", name, labels)

    def find(self, name: str) -> List[Tuple[dict, object]]:
        """All (labels, metric) pairs registered under ``name``."""
        with self._lock:
            items = list(self._metrics.items())
        return [(dict(key[1]), m) for key, m in items if key[0] == name]

    def percentile_summary(self, name: str, **labels) -> Optional[dict]:
        """Merged histogram summary across every series under ``name``.

        Series are filtered to those whose labels are a superset of the given
        ``labels``.  Returns None for an unknown metric name, for a name with
        no matching histogram series, or when every matching sketch is empty
        — never a NaN-valued dict.
        """
        want = {k: str(v) for k, v in labels.items()}
        merged = Histogram()
        matched = False
        for got, metric in self.find(name):
            if not isinstance(metric, Histogram):
                continue
            if any(got.get(k) != v for k, v in want.items()):
                continue
            matched = True
            merged.merge(metric)
        if not matched or merged.count == 0:
            return None
        return merged.summary()

    def snapshot(self) -> List[dict]:
        """Stable-ordered list of metric snapshots (one dict per series)."""
        with self._lock:
            items = list(self._metrics.items())
        rows = []
        for (name, labelset), metric in items:
            row = {"name": name, "labels": dict(sorted(labelset))}
            row.update(metric.snapshot())  # type: ignore[attr-defined]
            rows.append(row)
        rows.sort(key=lambda r: (r["name"], sorted(r["labels"].items())))
        return rows

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()


def percentile_summary(values, unit_scale: float = 1.0) -> Optional[dict]:
    """Build a Histogram from raw samples and return its summary.

    Shared replacement for the hand-rolled ``np.percentile`` reporters in
    ``launch/serve_vi.py``: one sketch, one
    rounding rule, and p999 for free.  Returns None for an empty sample set.
    """
    vals = [float(v) * unit_scale for v in values]
    if not vals:
        return None
    h = Histogram()
    h.observe_many(vals)
    return h.summary()
