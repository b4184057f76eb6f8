"""repro_torch.obs — tracing, metrics and profiling for the port.

Counterpart of ``src/repro/obs`` with the same public names.  Quick tour::

    from repro_torch import obs

    with obs.span("fit/degree", d=3):
        ...                                # timed, nested, thread-safe
    with obs.timed("pipeline/fit") as t:   # a span that also times with obs off
        ...
    t.duration_s                           # seconds; t.start on perf_counter
    obs.epoch() + ts * 1e-6                # a trace ts back on perf_counter
    obs.event("fit/regrowth", Lcap=128)    # instant marker

    h = obs.registry().histogram("serve.transform_seconds", backend="local")
    h.observe(0.004)
    h.summary()["p999"]

    obs.export_trace("results/trace.json")     # open in ui.perfetto.dev
    obs.export_metrics("results/metrics.jsonl")
    print("\n".join(obs.report_lines()))

Spans and events are gated by ``OBS_ENABLED`` (default on) and are true
no-ops when disabled; metric objects are always live because the port's
public ``stats`` dicts are views over them.  ``OBS_TORCH_TRACE=1`` adds a
``torch.profiler.record_function`` (and an NVTX range on a card) to every
span; ``OBS_TORCH_PROFILE=<dir>`` turns :func:`device.profile_window` into a
``torch.profiler`` capture written there.  See ``core.py`` and
``device.py``.

The spans of the port, by module:

- ``core/oavi.py`` ``FitScope``: ``fit`` (a fit loop, ``backend=``) and
  ``fit/degree`` inside it; ``fit/regrowth`` events.
- ``core/pipeline.py`` (Algorithm 2): ``pipeline/fit`` (``fit=<n>``, a
  per-process count) holding ``pipeline/generators`` (``pipeline/scale``,
  then the class fits' ``fit``), ``pipeline/transform`` and ``svm/fit``;
  ``pipeline/predict`` (``fit=<n>`` of the fit it predicts with) holding
  ``pipeline/transform`` and ``svm/decision``.
- ``core/svm.py`` ``LinearSVM.fit``: ``svm/upload``, ``svm/power``,
  ``svm/fista`` (each ``svm/stop_test``, the host blocked on the device's
  stopping test, and each ``svm/fista_block`` of ``CHECK_EVERY`` steps
  launched), ``svm/download``.
- ``streaming/fit.py``: ``streaming/accumulate``; ``core/distributed.py``:
  ``fit/all_reduce``; serving: ``serve/transform``, ``serve/warmup_compile``,
  ``batcher/execute``; ``checkpoint/save`` and ``checkpoint/restore``.
"""

from . import baseline, device, slo  # noqa: F401
from .core import (  # noqa: F401
    configure,
    counter_event,
    current_stack,
    disable,
    disabled,
    enable,
    enabled,
    epoch,
    event,
    export_metrics,
    export_trace,
    registry,
    report_lines,
    reset,
    snapshot,
    span,
    timed,
    trace_document,
    trace_events,
)
from .metrics import (  # noqa: F401
    BUCKETS_PER_OCTAVE,
    Counter,
    Gauge,
    Histogram,
    Registry,
    bucket_relative_error,
    percentile_summary,
)
from .trace import (  # noqa: F401
    chrome_trace,
    export_chrome_trace,
    merge_traces,
    validate_chrome_trace,
)

__all__ = [
    "baseline", "device", "slo",
    "configure", "counter_event", "current_stack", "disable", "disabled",
    "enable", "enabled", "epoch", "event", "export_metrics", "export_trace",
    "registry", "report_lines", "reset", "snapshot", "span", "timed",
    "trace_document", "trace_events",
    "BUCKETS_PER_OCTAVE", "Counter", "Gauge", "Histogram", "Registry",
    "bucket_relative_error", "percentile_summary",
    "chrome_trace", "export_chrome_trace", "merge_traces",
    "validate_chrome_trace",
]
