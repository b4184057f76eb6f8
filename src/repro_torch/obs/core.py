"""Process-global observability state: spans, events, snapshot/export.

Counterpart of ``src/repro/obs/core.py``.  The one difference is the
profiler annotation: the reference wraps spans in
``jax.profiler.TraceAnnotation``; the port wraps them in
``torch.profiler.record_function`` and, once the process has initialized
CUDA, an NVTX range, so obs spans line up with a ``torch.profiler`` (or
Nsight) timeline.  Neither synchronizes the device.

Contract (asserted by ``tests/test_torch_obs.py``):

- ``span()``/``event()`` when obs is disabled are true no-ops: they return a
  shared singleton and allocate nothing on the hot path.
- ``timed()`` always times: it is a span while obs is enabled and, while it
  is disabled, two clock reads that record nothing, so the ``stats`` it
  feeds keep working with tracing off.
- A span's ``ts`` is microseconds after :func:`epoch`, a
  ``time.perf_counter()`` reading: ``epoch() + ts * 1e-6`` puts it back on
  the host clock, the clock a device trace is mapped onto.
- Enabling obs never changes numerics — instrumentation only reads clocks
  and appends to buffers; fitted models are bit-identical either way.
- Metric objects (see :mod:`repro_torch.obs.metrics`) are *not* gated: the public
  ``stats`` dicts around the repo are views over them and must keep working
  with tracing off.

Env toggles (read once at import, overridable via :func:`configure`):

- ``OBS_ENABLED``      default 1 — master switch for spans/events.
- ``OBS_TRACE_EVENTS`` default 100000 — trace ring-buffer capacity.
- ``OBS_SAMPLE_EVERY`` default 1 — keep every Nth span per span name
  (deterministic counter-based sampling, no randomness).
- ``OBS_TORCH_TRACE``  default 0 — additionally wrap each span in
  ``torch.profiler.record_function`` (and an NVTX range on a card) so obs
  spans line up with device timelines when a profile is being captured.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

from .metrics import Registry
from .trace import TraceBuffer, chrome_trace, export_chrome_trace

__all__ = [
    "span", "timed", "epoch", "event", "counter_event", "enabled", "enable",
    "disable", "disabled", "configure", "reset", "registry", "trace_events",
    "snapshot", "export_trace", "export_metrics", "report_lines",
]


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


class _State:
    def __init__(self) -> None:
        self.enabled = _env_int("OBS_ENABLED", 1) != 0
        self.sample_every = max(1, _env_int("OBS_SAMPLE_EVERY", 1))
        self.torch_trace = _env_int("OBS_TORCH_TRACE", 0) != 0
        self.buffer = TraceBuffer(maxlen=max(16, _env_int("OBS_TRACE_EVENTS", 100_000)))
        self.registry = Registry()
        self.epoch = time.perf_counter()
        self._sample_lock = threading.Lock()
        self._sample_counts: Dict[str, int] = {}

    def now_us(self) -> float:
        return (time.perf_counter() - self.epoch) * 1e6

    def sampled(self, name: str) -> bool:
        """Deterministic per-name sampling: keep every Nth occurrence."""
        if self.sample_every == 1:
            return True
        with self._sample_lock:
            n = self._sample_counts.get(name, 0)
            self._sample_counts[name] = n + 1
        return n % self.sample_every == 0


_STATE = _State()
_LOCAL = threading.local()


class _TorchRange:
    """``torch.profiler.record_function`` plus, once the process has
    initialized CUDA, an NVTX range of the same name.  Both only record host
    markers: no device synchronization, no effect on what runs."""

    __slots__ = ("_name", "_rf", "_nvtx")

    def __init__(self, name: str) -> None:
        import torch  # deferred: obs.core is imported by stdlib-only tooling

        self._name = name
        self._rf = torch.profiler.record_function(name)
        self._nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()

    def __enter__(self) -> "_TorchRange":
        self._rf.__enter__()
        if self._nvtx:
            import torch

            torch.cuda.nvtx.range_push(self._name)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._nvtx:
            import torch

            torch.cuda.nvtx.range_pop()
        self._rf.__exit__(exc_type, exc, tb)


class Span:
    """A recorded span.  Use via ``with obs.span("fit/degree", d=3): ...``.
    ``start`` is its ``time.perf_counter()`` reading at entry."""

    __slots__ = ("name", "args", "start", "_torch_ctx", "duration_s")

    def __init__(self, name: str, args: Optional[dict]) -> None:
        self.name = name
        self.args = args
        self.start = 0.0
        self._torch_ctx = None
        self.duration_s = 0.0

    def __enter__(self) -> "Span":
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        stack.append(self.name)
        if _STATE.torch_trace:
            self._torch_ctx = _TorchRange(self.name)
            self._torch_ctx.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        t1 = time.perf_counter()
        dur = self.duration_s = t1 - self.start
        if self._torch_ctx is not None:
            self._torch_ctx.__exit__(exc_type, exc, tb)
        _LOCAL.stack.pop()
        st = _STATE
        # inline the sample_every == 1 fast path: this exit runs on serving's
        # per-request hot path, where even one extra call shows up in the
        # obs overhead budget.  Durations live in the trace buffer
        # only; aggregate latencies belong to the components' own always-on
        # histograms (``fit.seconds``, ``serve.transform_seconds``, ...)
        if st.sample_every == 1 or st.sampled(self.name):
            st.buffer.add_complete(
                self.name, (self.start - st.epoch) * 1e6, dur * 1e6, self.args)


class _NoopSpan:
    """Shared do-nothing span returned when obs is disabled."""

    __slots__ = ()
    name = ""
    args = None
    duration_s = 0.0

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


_NOOP_SPAN = _NoopSpan()


class _Timer:
    """The clock readings of :func:`timed` while obs is disabled."""

    __slots__ = ("start", "duration_s")

    def __enter__(self) -> "_Timer":
        self.start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.duration_s = time.perf_counter() - self.start


def span(name: str, **args):
    """Open a (nested, thread-safe) span.  No-op singleton when disabled."""
    if not _STATE.enabled:
        return _NOOP_SPAN
    return Span(name, args or None)


def timed(name: str, **args):
    """A span that times whether or not obs is enabled: on exit it holds
    ``start`` (``time.perf_counter()`` at entry) and ``duration_s``.  While
    obs is enabled it is :func:`span`'s recorded span; while disabled it
    only reads the clock twice."""
    if not _STATE.enabled:
        return _Timer()
    return Span(name, args or None)


def epoch() -> float:
    """The ``time.perf_counter()`` reading at which trace timestamps are 0."""
    return _STATE.epoch


def event(name: str, **args) -> None:
    """Record an instant event (compile, recompile, activation...)."""
    if not _STATE.enabled:
        return
    _STATE.buffer.add_instant(name, _STATE.now_us(), args or None)


def counter_event(name: str, **values) -> None:
    """Record a counter sample (``ph: "C"``) on the trace timeline.

    Values must be numbers; Perfetto renders them as a stacked counter track
    (the live-memory timeline).  No-op when obs is disabled.
    """
    if not _STATE.enabled:
        return
    _STATE.buffer.add_counter(name, _STATE.now_us(), values)


def current_stack() -> List[str]:
    """Names of the open spans on this thread, outermost first."""
    return list(getattr(_LOCAL, "stack", ()))


def enabled() -> bool:
    return _STATE.enabled


def enable() -> None:
    _STATE.enabled = True


def disable() -> None:
    _STATE.enabled = False


class disabled:
    """Context manager that temporarily disables span/event recording."""

    def __enter__(self):
        self._prev = _STATE.enabled
        _STATE.enabled = False
        return self

    def __exit__(self, *exc):
        _STATE.enabled = self._prev


def configure(enabled: Optional[bool] = None,
              sample_every: Optional[int] = None,
              torch_trace: Optional[bool] = None,
              trace_capacity: Optional[int] = None) -> None:
    """Override env-derived settings at runtime."""
    if enabled is not None:
        _STATE.enabled = enabled
    if sample_every is not None:
        _STATE.sample_every = max(1, int(sample_every))
    if torch_trace is not None:
        _STATE.torch_trace = torch_trace
    if trace_capacity is not None:
        _STATE.buffer = TraceBuffer(maxlen=max(16, int(trace_capacity)))


def registry() -> Registry:
    """The process-global metric registry."""
    return _STATE.registry


def trace_events() -> List[dict]:
    return _STATE.buffer.events()


def reset(metrics: bool = True, trace: bool = True) -> None:
    """Clear recorded state (tests / between bench trials)."""
    if trace:
        _STATE.buffer.clear()
    if metrics:
        _STATE.registry.clear()
    with _STATE._sample_lock:
        _STATE._sample_counts.clear()


def snapshot() -> dict:
    """Point-in-time view of all metrics plus trace-buffer counters."""
    return {
        "metrics": _STATE.registry.snapshot(),
        "trace": {
            "events": len(_STATE.buffer),
            "dropped": _STATE.buffer.dropped,
        },
        "enabled": _STATE.enabled,
    }


def export_trace(path: str, process_name: str = "repro_torch") -> str:
    """Write the trace buffer as Chrome-trace JSON; returns the path."""
    return export_chrome_trace(_STATE.buffer.events(), path,
                               process_name=process_name)


def trace_document(process_name: str = "repro_torch") -> dict:
    return chrome_trace(_STATE.buffer.events(), process_name=process_name)


def export_metrics(path: str) -> str:
    """Write one JSONL line per metric series; returns the path."""
    rows = _STATE.registry.snapshot()
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    os.replace(tmp, path)
    return path


def report_lines(snap: Optional[dict] = None) -> List[str]:
    """Render a metric snapshot as an aligned human-readable table."""
    snap = snap or snapshot()
    rows = []
    for m in snap["metrics"]:
        labels = ",".join(f"{k}={v}" for k, v in sorted(m["labels"].items()))
        name = f"{m['name']}{{{labels}}}" if labels else m["name"]
        if m["type"] == "counter":
            rows.append((name, "counter", f"{m['value']}"))
        elif m["type"] == "gauge":
            rows.append((name, "gauge", f"{m['value']:g}"))
        else:
            fmt = lambda v: "-" if v is None else f"{v:.6g}"  # noqa: E731
            rows.append((
                name, "histogram",
                f"n={m['count']} mean={fmt(m['mean'])} p50={fmt(m['p50'])} "
                f"p99={fmt(m['p99'])} p999={fmt(m['p999'])} max={fmt(m['max'])}",
            ))
    if not rows:
        return ["(no metrics recorded)"]
    w_name = max(len(r[0]) for r in rows)
    w_type = max(len(r[1]) for r in rows)
    lines = [f"{n:<{w_name}}  {t:<{w_type}}  {v}" for n, t, v in rows]
    tr = snap.get("trace", {})
    lines.append(
        f"trace: {tr.get('events', 0)} events buffered, "
        f"{tr.get('dropped', 0)} dropped"
    )
    return lines
