"""Device-level observability of the port: build time, analytic cost,
memory, profiles.

Counterpart of ``src/repro/obs/device.py``.  The reference reads XLA; the
port has none, so each of its four facilities has a counterpart that
reports the same keys:

- **Compile accounting** becomes kernel-build accounting.  The port's
  counterpart of an XLA compile is building the hand-written kernels at
  their first launch (``kernels/_build.py``: one ``nvcc`` per source, in
  parallel, then a ``ctypes`` load).  ``_build.py`` adds each build's
  seconds to a process-global counter, and :class:`CompileWindow` /
  :func:`compile_snapshot` read it.  Eager PyTorch compiles nothing else, so
  once the library is loaded every window reads 0.
- **Per-step cost** is counted from shapes, not lowered: :func:`step_cost`
  calls an analytic cost function once per ``(fn, signature)`` and caches
  the result.  ``torch.utils.flop_counter`` would see neither the ``ctypes``
  launches of the hand kernels nor ``addcmul``, and would count 0 on the card
  where the CPU counts a BLAS product; an analytic count is the same number
  on both.  The fits count through :func:`repro_torch.kernels.ops.flop_count`.
- **Memory**: :func:`device_memory_stats` is ``torch.cuda.memory_stats``
  under the reference's keys, :func:`live_buffer_bytes` is
  ``torch.cuda.memory_allocated``.  Off the card (or before the process has
  initialized CUDA) they return ``{}`` and ``None``, as the reference does on
  a backend without allocator statistics.
- **Profiler windows**: :func:`profile_window` opens a
  ``torch.profiler.profile`` (CPU and, on a card, CUDA activity) when
  ``OBS_TORCH_PROFILE=<dir>`` is set, and writes its Chrome trace there.

Everything here is gated by ``OBS_DEVICE`` (default on) and
:func:`repro_torch.obs.enabled`, and none of it changes what a fit or a
transform computes: nothing here synchronizes the device.
"""

from __future__ import annotations

import itertools
import os
import re
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

from .core import counter_event, enabled, event, registry

__all__ = [
    "CompileWindow",
    "add_build_seconds",
    "capture_stats",
    "compile_snapshot",
    "device_enabled",
    "device_memory_stats",
    "live_buffer_bytes",
    "profile_kernels",
    "profile_window",
    "sample_memory",
    "step_cost",
]


def _env_flag(name: str, default: int) -> bool:
    try:
        return int(os.environ.get(name, default)) != 0
    except ValueError:
        return default != 0


def device_enabled() -> bool:
    """Device-level capture is on: ``OBS_DEVICE`` (default 1) and obs enabled."""
    return enabled() and _env_flag("OBS_DEVICE", 1)


# ---------------------------------------------------------------------------
# Kernel-build accounting (the port's compile time)
# ---------------------------------------------------------------------------

_COMPILE_LOCK = threading.Lock()
_COMPILE = {"seconds": 0.0, "count": 0}


def add_build_seconds(seconds: float) -> None:
    """Record one build of the kernels' library (called by
    ``kernels/_build.py``); emits a ``device/kernel_build`` event."""
    with _COMPILE_LOCK:
        _COMPILE["seconds"] += seconds
        _COMPILE["count"] += 1
    event("device/kernel_build", seconds=round(seconds, 6))


def compile_snapshot() -> Tuple[float, int]:
    """Cumulative (seconds, count) of kernel builds in this process."""
    with _COMPILE_LOCK:
        return _COMPILE["seconds"], _COMPILE["count"]


class CompileWindow:
    """Delta of kernel-build time over a ``with`` region.

    The counter is process-global, so a build triggered by another thread
    lands in every open window (an upper bound, as in the reference).
    ``seconds``/``count`` are 0 until exit.
    """

    __slots__ = ("seconds", "count", "_s0", "_c0")

    def __init__(self) -> None:
        self.seconds = 0.0
        self.count = 0

    def __enter__(self) -> "CompileWindow":
        self._s0, self._c0 = compile_snapshot()
        return self

    def __exit__(self, *exc) -> None:
        s1, c1 = compile_snapshot()
        self.seconds = s1 - self._s0
        self.count = c1 - self._c0


# ---------------------------------------------------------------------------
# Per-step analytic cost
# ---------------------------------------------------------------------------

_COST_LOCK = threading.Lock()
_COST_CACHE: "OrderedDict[Tuple, Optional[Dict]]" = OrderedDict()
_COST_CACHE_CAP = 512
_CAPTURE = {"captures": 0, "failures": 0, "seconds": 0.0}


def capture_stats() -> Dict:
    """Cost-capture telemetry: captures, failures, cumulative capture time."""
    with _COST_LOCK:
        return dict(_CAPTURE)


def _capture_cost(fn: Callable, args, kwargs) -> Optional[Dict]:
    t0 = time.perf_counter()
    try:
        work = fn(*args, **kwargs)
    except Exception:
        with _COST_LOCK:
            _CAPTURE["failures"] += 1
        return None
    dt = time.perf_counter() - t0
    cost = {
        "flops": float(work.get("flops", 0.0)),
        "bytes_accessed": float(work.get("bytes_accessed", 0.0)),
        "bytes_out": float(work.get("bytes_out", 0.0)),
        "capture_s": round(dt, 6),
    }
    with _COST_LOCK:
        _CAPTURE["captures"] += 1
        _CAPTURE["seconds"] += dt
    registry().histogram("device.cost_capture_seconds").observe(dt)
    event("device/cost_capture", flops=cost["flops"],
          bytes_accessed=cost["bytes_accessed"], capture_s=cost["capture_s"])
    return cost


def step_cost(fn: Callable, sig, args, kwargs: Optional[dict] = None) -> Optional[Dict]:
    """Analytic cost of one step at one signature.

    ``fn(*args, **kwargs)`` returns the step's work counted from its shapes,
    a dict with ``flops`` and optionally ``bytes_accessed`` / ``bytes_out``.
    Returns ``{"flops", "bytes_accessed", "bytes_out", "capture_s"}``, or
    None while capture is off (a None is not cached, so the next enabled
    call counts).  The result is cached per ``(fn, sig)``.
    """
    if not device_enabled():
        return None
    key = (id(fn), sig)
    with _COST_LOCK:
        if key in _COST_CACHE:
            return _COST_CACHE[key]
    cost = _capture_cost(fn, args, kwargs or {})
    with _COST_LOCK:
        _COST_CACHE[key] = cost
        while len(_COST_CACHE) > _COST_CACHE_CAP:
            _COST_CACHE.popitem(last=False)
    return cost


# ---------------------------------------------------------------------------
# Live-memory timeline
# ---------------------------------------------------------------------------


def _cuda_device(device=None):
    """The CUDA device to read, or None: off the card, before CUDA is
    initialized (reading stats must not create a context), or for a CPU
    ``device``."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    if device is None:
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    return dev if dev.type == "cuda" else None


def device_memory_stats(device=None) -> Dict:
    """The caching allocator's counters of the card, under the reference's
    keys (``peak_bytes_in_use``, ``bytes_in_use``, ``bytes_reserved``,
    ``num_allocs``); ``{}`` off the card.  ``peak_bytes_in_use`` is
    ``torch.cuda.max_memory_allocated``: the high-water mark since the
    process started or since the last ``reset_peak_memory_stats``."""
    dev = _cuda_device(device)
    if dev is None:
        return {}
    import torch

    stats = torch.cuda.memory_stats(dev)
    return {
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
        "num_allocs": int(stats.get("allocation.all.allocated", 0)),
    }


def live_buffer_bytes(device=None) -> Optional[int]:
    """Bytes of live tensors on the card (``torch.cuda.memory_allocated``);
    None off the card."""
    dev = _cuda_device(device)
    if dev is None:
        return None
    import torch

    return int(torch.cuda.memory_allocated(dev))


def sample_memory(stats: Optional[Dict] = None, device=None) -> Dict:
    """One memory-timeline sample: gauges, a trace counter, and stats peaks.

    Updates ``stats["peak_bytes"]`` (allocator high-water) and
    ``stats["live_bytes_peak"]`` (live tensors) in place when a stats dict
    is given, refreshes the ``device.live_bytes`` / ``device.peak_bytes``
    registry gauges and, when obs recording is on, appends a
    ``device/memory`` counter event.  Returns the raw sample (``{}`` off the
    card, or for a CPU ``device``)."""
    out: Dict = {}
    live = live_buffer_bytes(device)
    if live is not None:
        out["live_bytes"] = live
        if stats is not None:
            stats["live_bytes_peak"] = max(live, int(stats.get("live_bytes_peak") or 0))
    peak = device_memory_stats(device).get("peak_bytes_in_use")
    if peak is not None:
        out["peak_bytes"] = int(peak)
        if stats is not None:
            stats["peak_bytes"] = max(int(peak), int(stats.get("peak_bytes") or 0))
    if not out:
        return out
    reg = registry()
    if live is not None:
        reg.gauge("device.live_bytes").set(float(live))
        reg.gauge("device.live_bytes_peak").set_max(float(live))
    if peak is not None:
        reg.gauge("device.peak_bytes").set(float(peak))
    if device_enabled():
        # counter args must stay numeric: Perfetto stacks them as series
        counter_event("device/memory", **{k: float(v) for k, v in out.items()})
    return out


# ---------------------------------------------------------------------------
# torch.profiler windows
# ---------------------------------------------------------------------------

_PROFILE_LOCK = threading.Lock()
_PROFILE_ACTIVE = {"on": False}
_PROFILE_SEQ = itertools.count()


class _ProfileWindow:
    """One ``torch.profiler`` capture window; inner or overlapping windows
    are no-ops (one profiler at a time).  On exit the capture is written as
    a Chrome trace under the window's directory (``path``) and kept on
    ``prof`` for ``key_averages()``.  Obs instant events mark both edges."""

    __slots__ = ("_dir", "_name", "_started", "prof", "path")

    def __init__(self, log_dir: str, name: str) -> None:
        self._dir = log_dir
        self._name = name
        self._started = False
        self.prof = None
        self.path: Optional[str] = None

    def __enter__(self) -> "_ProfileWindow":
        with _PROFILE_LOCK:
            if _PROFILE_ACTIVE["on"]:
                return self
            _PROFILE_ACTIVE["on"] = True
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            os.makedirs(self._dir, exist_ok=True)
            prof = profile(activities=activities)
            prof.__enter__()
        except Exception:
            with _PROFILE_LOCK:
                _PROFILE_ACTIVE["on"] = False
            raise
        self.prof = prof
        self._started = True
        event("device/profile_start", window=self._name, dir=self._dir)
        return self

    def __exit__(self, *exc) -> None:
        if not self._started:
            return
        try:
            self.prof.__exit__(*exc)
            safe = re.sub(r"[^A-Za-z0-9_.-]+", "_", self._name)
            self.path = os.path.join(
                self._dir, f"{safe}-{os.getpid()}-{next(_PROFILE_SEQ)}.json")
            self.prof.export_chrome_trace(self.path)
            event("device/profile_stop", window=self._name, path=self.path)
        finally:
            with _PROFILE_LOCK:
                _PROFILE_ACTIVE["on"] = False


class _NoopWindow:
    __slots__ = ()
    prof = None
    path = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NOOP_WINDOW = _NoopWindow()


def profile_window(name: str):
    """Profiler window: with ``OBS_TORCH_PROFILE=<dir>`` the returned
    context manager captures a ``torch.profiler`` trace written under that
    directory; otherwise it is a shared no-op.  Safe to nest: only the
    outermost window captures."""
    log_dir = os.environ.get("OBS_TORCH_PROFILE", "")
    if not log_dir or not enabled():
        return _NOOP_WINDOW
    return _ProfileWindow(log_dir, name)


def profile_kernels(prof) -> Tuple[float, Dict[str, int]]:
    """Device seconds and launches by kernel name in a finished
    ``torch.profiler`` capture (kernels only: an operator's device time
    repeats its kernels')."""
    from torch.autograd import DeviceType

    busy_us = 0.0
    counts: Dict[str, int] = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            busy_us += ev.self_device_time_total
            counts[ev.key] = counts.get(ev.key, 0) + ev.count
    return busy_us / 1e6, counts
