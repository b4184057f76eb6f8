"""The program's own spans (``repro_torch.obs``) in a run: grouped by fit,
put on the host clock and laid against the device's activity.

A span is ``(name, start, end, seconds, args)``: ``start`` and ``end`` on the
host's ``time.perf_counter()`` clock (``obs.epoch() + ts * 1e-6``), the
clock onto which :class:`bench.harness.trace.Tracer` maps the device's
activity, and ``seconds`` the span's own duration as the program recorded
it.  A device activity is ``(name, start, end)`` on that clock, as
``Tracer.events()`` gives it.

The program records ``pipeline/fit`` (``fit=<n>``) and ``pipeline/predict``
(the ``fit=<n>`` it predicts with) around Algorithm 2's phases, and the
pipeline's ``stats`` hold three of their inner spans' durations
(``time_generators``, ``time_transform``, ``time_svm``).  :func:`traced_fits`
finds a run's fits by those durations, so a program that records no such
spans reads ``None``.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

# (span name, stats key): durations that a fit's stats share with its spans
STATS_SPANS = (("pipeline/generators", "time_generators"),
               ("pipeline/transform", "time_transform"), ("svm/fit", "time_svm"))
# the stats and the trace hold one duration, in seconds and in microseconds
MATCH_S = 1e-9
BETWEEN = "between"


class Span(NamedTuple):
    name: str
    start: float
    end: float
    seconds: float
    args: dict


def program_spans(events: Optional[Sequence[dict]] = None,
                  epoch: Optional[float] = None) -> List[Span]:
    """The complete spans of ``events`` (Chrome-trace dicts; by default the
    program's trace buffer and its ``obs.epoch()``), in order of start,
    outer spans first."""
    if events is None:
        from repro_torch import obs

        events = obs.trace_events()
        epoch = obs.epoch() if hasattr(obs, "epoch") else None
    if epoch is None:
        epoch = 0.0
    out = [Span(e["name"], epoch + e["ts"] * 1e-6, epoch + (e["ts"] + e["dur"]) * 1e-6,
                e["dur"] * 1e-6, e.get("args") or {})
           for e in events if e.get("ph") == "X"]
    out.sort(key=lambda s: (s.start, -s.end))
    return out


def by_fit(spans: Sequence[Span]) -> Dict[int, List[Span]]:
    """Each fit's spans by its ``fit=<n>``: its ``pipeline/fit`` and
    ``pipeline/predict`` spans and every span that starts inside them."""
    out: Dict[int, List[Span]] = {}
    for top in spans:
        if top.name in ("pipeline/fit", "pipeline/predict") and "fit" in top.args:
            out.setdefault(top.args["fit"], []).extend(
                s for s in spans if top.start <= s.start <= top.end)
    return {n: sorted(group, key=lambda s: (s.start, -s.end)) for n, group in out.items()}


def _matches(group: Sequence[Span], stats: Dict) -> bool:
    for name, key in STATS_SPANS:
        first = next((s for s in group if s.name == name), None)
        if first is None or key not in stats or abs(first.seconds - stats[key]) > MATCH_S:
            return False
    return True


def traced_fits(run) -> Optional[List[List[Span]]]:
    """The spans of each fit of ``run.stats``, in its order, or ``None``
    where some fit has none (obs off, or a program without them)."""
    groups = list(by_fit(program_spans()).values())
    out = []
    for stats in run.stats:
        found = [g for g in groups if _matches(g, stats)]
        if len(found) != 1:
            return None
        out.append(found[0])
    return out or None


def per_step_us(run, name: str) -> Optional[float]:
    """The spans named ``name`` a fit over its ``svm_iters``, in
    microseconds, mean over ``run``'s fits; ``None`` without spans."""
    fits = traced_fits(run)
    if fits is None or not all(s.get("svm_iters") for s in run.stats):
        return None
    return sum(seconds(f, name) / s["svm_iters"] * 1e6
               for f, s in zip(fits, run.stats)) / len(fits)


def seconds(spans: Iterable[Span], name: str) -> float:
    """The summed duration of the spans named ``name``."""
    return sum(s.seconds for s in spans if s.name == name)


def self_seconds(spans: Sequence[Span], name: str, child: str) -> float:
    """The spans named ``name`` less the time their ``child`` spans cover."""
    total = 0.0
    for s in spans:
        if s.name == name:
            inner = sum(min(c.end, s.end) - max(c.start, s.start) for c in spans
                        if c.name == child and c.start < s.end and c.end > s.start)
            total += s.seconds - inner
    return total


class Busy:
    """The device's busy time: its activities merged into disjoint
    intervals, with their starts kept for counting."""

    def __init__(self, activities: Iterable[Tuple[str, float, float]]) -> None:
        acts = sorted((s, e) for _, s, e in activities)
        self.starts_all = [s for s, _ in acts]
        merged: List[List[float]] = []
        for s, e in acts:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.starts = [m[0] for m in merged]
        self.ends = [m[1] for m in merged]
        self.cum = [0.0]
        for s, e in merged:
            self.cum.append(self.cum[-1] + (e - s))

    def count(self, a: float, b: float) -> int:
        """Activities that start in ``[a, b)``."""
        return bisect.bisect_left(self.starts_all, b) - bisect.bisect_left(self.starts_all, a)

    def within(self, a: float, b: float) -> float:
        """Busy seconds inside ``[a, b]``."""
        i = bisect.bisect_right(self.ends, a)
        j = bisect.bisect_left(self.starts, b)
        if b <= a or i >= j:
            return 0.0
        return (self.cum[j] - self.cum[i] - max(0.0, a - self.starts[i])
                - max(0.0, self.ends[j - 1] - b))


def layers(spans: Sequence[Span], busy: Busy) -> Dict[str, Dict[str, float]]:
    """For each span name: its ``seconds``, the device ``activities`` that
    start inside its spans, and its ``idle_s`` (span time with no activity
    running)."""
    out: Dict[str, Dict[str, float]] = {}
    for s in spans:
        row = out.setdefault(s.name, {"seconds": 0.0, "activities": 0, "idle_s": 0.0})
        row["seconds"] += s.seconds
        row["activities"] += busy.count(s.start, s.end)
        row["idle_s"] += (s.end - s.start) - busy.within(s.start, s.end)
    return out


def leaves(spans: Sequence[Span], t0: float, t1: float) -> List[Tuple[float, float, Optional[str]]]:
    """``[t0, t1]`` cut where the innermost open span changes: ``(start,
    end, name)``, ``None`` where no span is open.  Spans nest on the one
    calling thread; one that outlives its parent is cut at the parent's
    end."""
    out: List[Tuple[float, float, Optional[str]]] = []
    stack: List[Tuple[float, str]] = []
    cur = t0

    def emit(upto: float) -> None:
        nonlocal cur
        upto = min(upto, t1)
        if upto > cur:
            out.append((cur, upto, stack[-1][1] if stack else None))
            cur = upto

    for s in sorted(spans, key=lambda s: (s.start, -s.end)):
        while stack and stack[-1][0] <= s.start:
            emit(stack[-1][0])
            stack.pop()
        emit(s.start)
        stack.append((min(s.end, stack[-1][0]) if stack else s.end, s.name))
    while stack:
        emit(stack[-1][0])
        stack.pop()
    emit(t1)
    return out


def idle_by_leaf(spans: Sequence[Span], busy: Busy, t0: float, t1: float) -> Dict[str, float]:
    """The device's idle seconds in ``[t0, t1]`` by the innermost span open
    at the time; ``between`` where none is."""
    out: Dict[str, float] = {}
    for s, e, name in leaves(spans, t0, t1):
        idle = (e - s) - busy.within(s, e)
        if idle > 0:
            key = name or BETWEEN
            out[key] = out.get(key, 0.0) + idle
    return out
