"""Chrome-trace event recording and export.

Counterpart of ``src/repro/obs/trace.py`` (standard library only), kept as
the port's own copy so that ``repro_torch`` imports nothing of ``repro``.

Span/instant events accumulate in a bounded ring buffer and export as the
Chrome trace-event JSON format (``{"traceEvents": [...]}``) that loads
directly in ``ui.perfetto.dev`` or ``chrome://tracing``.

Event vocabulary (the subset of the spec we emit):

- ``ph: "X"`` — complete event: a span with ``ts``/``dur`` in microseconds.
- ``ph: "i"`` — instant event (compile, recompile, regrowth, activation...).
- ``ph: "C"`` — counter sample (live-memory timeline gauges).
- ``ph: "M"`` — metadata (process/thread names), emitted at export time.

``pid`` is the real process id; ``tid`` is a stable small integer per Python
thread so nested spans from one thread stack correctly in the timeline.
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque
from typing import Dict, List, Optional

__all__ = [
    "TraceBuffer",
    "chrome_trace",
    "export_chrome_trace",
    "merge_traces",
    "validate_chrome_trace",
]

_REQUIRED_KEYS = {"name", "ph", "ts", "pid", "tid"}
_KNOWN_PHASES = {"X", "i", "B", "E", "M", "C"}


class TraceBuffer:
    """Thread-safe bounded buffer of Chrome-trace events."""

    def __init__(self, maxlen: int = 100_000) -> None:
        self._lock = threading.Lock()
        # hot path is lock-free: deque.append with maxlen is itself
        # thread-safe and lossless under the GIL; ``_added`` is a telemetry
        # counter (racy increments may undercount drops, never events).
        # Records are plain tuples — building the Chrome-trace dict (7 keys
        # hashed, cache-cold between device calls) costs several times the
        # tuple append, so it is deferred to :meth:`events` at export time:
        #   ("X", name, ts_us, dur_us, tid, args)   complete (span)
        #   ("i", name, ts_us, tid, args)           instant
        #   ("C", name, ts_us, tid, values)         counter sample
        self._events: deque = deque(maxlen=maxlen)
        self._tids: Dict[int, int] = {}
        self._pid = os.getpid()
        self._added = 0

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids) + 1)
        return tid

    def add_complete(self, name: str, ts_us: float, dur_us: float,
                     args: Optional[dict] = None) -> None:
        self._added += 1
        self._events.append(("X", name, ts_us, dur_us, self._tid(), args))

    def add_instant(self, name: str, ts_us: float,
                    args: Optional[dict] = None) -> None:
        self._added += 1
        self._events.append(("i", name, ts_us, self._tid(), args))

    def add_counter(self, name: str, ts_us: float, values: dict) -> None:
        """Record a Chrome counter sample (``ph: "C"``).

        ``values`` maps series name -> number; Perfetto renders one stacked
        counter track per (pid, name).  Used for the live-memory timeline.
        """
        self._added += 1
        self._events.append(("C", name, ts_us, self._tid(), values))

    def __len__(self) -> int:
        return len(self._events)

    @property
    def dropped(self) -> int:
        return max(0, self._added - len(self._events))

    def events(self) -> List[dict]:
        """Materialize the buffered records as Chrome-trace event dicts."""
        while True:
            try:
                raw = list(self._events)
                break
            except RuntimeError:
                continue  # deque mutated mid-copy by a concurrent append
        pid = self._pid
        out = []
        for rec in raw:
            if rec[0] == "X":
                _, name, ts, dur, tid, args = rec
                out.append({
                    "name": name, "ph": "X", "ts": ts, "dur": dur,
                    "pid": pid, "tid": tid, "args": args or {},
                })
            elif rec[0] == "C":
                _, name, ts, tid, args = rec
                out.append({
                    "name": name, "ph": "C", "ts": ts, "pid": pid,
                    "tid": tid, "args": args or {},
                })
            else:
                _, name, ts, tid, args = rec
                out.append({
                    "name": name, "ph": "i", "ts": ts, "pid": pid,
                    "tid": tid, "s": "t",  # thread-scoped instant
                    "args": args or {},
                })
        return out

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._added = 0


def chrome_trace(events: List[dict], process_name: str = "repro_torch") -> dict:
    """Wrap raw events in the Chrome trace-event container format."""
    pid = os.getpid()
    rounded = []
    for e in events:  # rounding deferred off the recording hot path
        e = dict(e)
        e["ts"] = round(e["ts"], 3)
        if "dur" in e:
            e["dur"] = round(e["dur"], 3)
        rounded.append(e)
    events = rounded
    meta = [{
        "name": "process_name",
        "ph": "M",
        "ts": 0,
        "pid": pid,
        "tid": 0,
        "args": {"name": process_name},
    }]
    tids = sorted({e["tid"] for e in events})
    for tid in tids:
        meta.append({
            "name": "thread_name",
            "ph": "M",
            "ts": 0,
            "pid": pid,
            "tid": tid,
            "args": {"name": f"thread-{tid}"},
        })
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def export_chrome_trace(events: List[dict], path: str,
                        process_name: str = "repro_torch") -> str:
    """Write events as a Chrome-trace JSON file; returns the path."""
    doc = chrome_trace(events, process_name=process_name)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path


def merge_traces(docs: List[dict], markers: Optional[List[dict]] = None,
                 gap_us: float = 1_000.0,
                 harness_name: str = "harness") -> dict:
    """Merge per-process trace documents onto one sequential timeline.

    Each document keeps its own process track (its real ``pid``; a synthetic
    one on collision) but is shifted so document ``i`` begins after document
    ``i-1`` ends — per-process ``perf_counter`` epochs share no origin, so
    only within-process ordering is meaningful and a sequential layout is the
    honest rendering of e.g. a killed controller followed by its resume.

    ``markers`` inject instant events from the merging (harness) process onto
    a dedicated track: ``{"name": ..., "after_doc": i, "args": {...}}`` lands
    on the merged timeline at the boundary after document ``i`` (``-1`` = the
    very start), e.g. kill and recovery markers between two processes.
    """
    merged: List[dict] = []
    seen_pids: set = set()
    boundaries: Dict[int, float] = {-1: 0.0}
    cursor = 0.0
    for i, doc in enumerate(docs):
        events = doc.get("traceEvents", [])
        payload = [e for e in events if e.get("ph") != "M"]
        meta = [e for e in events if e.get("ph") == "M"]
        pids = {e["pid"] for e in payload} | {e["pid"] for e in meta}
        pid_map = {}
        for pid in sorted(pids):
            new = pid
            while new in seen_pids:
                new += 100_000  # same-pid docs still get distinct tracks
            pid_map[pid] = new
            seen_pids.add(new)
        t0 = min((e["ts"] for e in payload), default=0.0)
        end = cursor
        for e in meta:
            e = dict(e)
            e["pid"] = pid_map[e["pid"]]
            merged.append(e)
        for e in payload:
            e = dict(e)
            e["pid"] = pid_map[e["pid"]]
            e["ts"] = e["ts"] - t0 + cursor
            end = max(end, e["ts"] + e.get("dur", 0.0))
            merged.append(e)
        boundaries[i] = end
        cursor = end + gap_us
    harness_pid = os.getpid()
    while harness_pid in seen_pids:
        harness_pid += 100_000
    if markers:
        merged.append({
            "name": "process_name", "ph": "M", "ts": 0,
            "pid": harness_pid, "tid": 0, "args": {"name": harness_name},
        })
        last = max(boundaries.values())
        for k, m in enumerate(markers):
            ts = boundaries.get(m.get("after_doc", -1), last) + gap_us * 0.5
            merged.append({
                "name": m["name"], "ph": "i", "ts": round(ts, 3) + k * 1e-3,
                "pid": harness_pid, "tid": 1, "s": "g",  # global-scoped
                "args": m.get("args") or {},
            })
    return {"traceEvents": merged, "displayTimeUnit": "ms"}


def validate_chrome_trace(doc: dict) -> List[dict]:
    """Validate a trace document against the Chrome trace-event schema.

    Raises ``ValueError`` on the first malformed event; returns the list of
    non-metadata events on success.  Used by tests and ``chip_smoke.py`` so an
    unloadable trace.json fails loudly instead of silently in the viewer.
    """
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("trace document must be a dict with 'traceEvents'")
    events = doc["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    payload = []
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        missing = _REQUIRED_KEYS - set(ev)
        if missing:
            raise ValueError(f"event {i} missing keys {sorted(missing)}: {ev}")
        if ev["ph"] not in _KNOWN_PHASES:
            raise ValueError(f"event {i} has unknown phase {ev['ph']!r}")
        if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0:
            raise ValueError(f"event {i} has bad ts: {ev['ts']!r}")
        if not isinstance(ev["pid"], int) or not isinstance(ev["tid"], int):
            raise ValueError(f"event {i} pid/tid must be ints: {ev}")
        if ev["ph"] == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"complete event {i} has bad dur: {dur!r}")
        if ev["ph"] != "M":
            payload.append(ev)
    return payload
