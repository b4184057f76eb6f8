"""The traced window: ``torch.profiler`` over the card's activity, reduced
to kernel time by name, the busy and idle time of the card, and the idle
time by what the host was doing.

Host and device clocks are tied by one marker: before the window the
tracer synchronizes, reads the host clock and launches a short spin kernel
that nothing else launches; the kernel's start on the trace's clock, less
that reading, maps host times onto the trace.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

# the traced part of a window: whole fits until this many seconds have passed
# (a classify fit launches ~3e5 kernels; a longer trace takes minutes to read)
SECONDS = 15.0
MARK = "spin_kernel"
MARK_CYCLES = 100_000
NAME_CHARS = 120


def _span(e) -> Tuple[float, float]:
    """A raw profiler event's start and end in seconds."""
    if hasattr(e, "start_ns"):
        return e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9
    return e.start_us() * 1e-6, (e.start_us() + e.duration_us()) * 1e-6


class Tracer:
    def __init__(self, device) -> None:
        self.device = device
        self._prof = None
        self._t_mark = 0.0

    def __enter__(self) -> "Tracer":
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize(self.device)
        self._t_mark = time.perf_counter()
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize(self.device)
        return self

    def __exit__(self, *exc) -> None:
        import torch

        torch.cuda.synchronize(self.device)
        self._prof.__exit__(*exc)

    def events(self) -> List[Tuple[str, float, float]]:
        """Every device activity as ``(name, start, end)`` in seconds on the
        host clock, the marker left out, in order of start.  Read from the
        profiler's raw events, which a window of some 10^5 launches gives
        in seconds, not from its event tree."""
        from torch.autograd import DeviceType

        raw = [(e.name(), *_span(e)) for e in self._prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
        marks = [s for name, s, _ in raw if MARK in name]
        if not marks:
            raise RuntimeError("the trace lost the tracer's marker kernel")
        off = min(marks) - self._t_mark
        out = [(name, s - off, e - off) for name, s, e in raw if MARK not in name]
        out.sort(key=lambda r: r[1])
        return out


def reduce(events: Sequence[Tuple[str, float, float]], t0: float, t1: float,
           phases: Sequence[Tuple[str, float, float]]) -> Dict:
    """The window ``[t0, t1]`` of a trace: ``kernels`` ({name: [launches,
    seconds]}), ``busy_s`` (time in which some activity ran), ``window_s``,
    and ``idle`` ({host phase: idle seconds}; ``between`` is the host
    between the fits' phases)."""
    kernels: Dict[str, List[float]] = {}
    busy = 0.0
    gaps: List[Tuple[float, float]] = []
    cur_s = cur_e = None
    for name, s, e in events:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += e - s
        if cur_e is None:
            gaps.append((t0, s))
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is None:
        gaps.append((t0, t1))
    else:
        busy += cur_e - cur_s
        gaps.append((cur_e, t1))
    idle: Dict[str, float] = {}
    ordered = sorted(phases, key=lambda p: p[1])
    first = 0
    for gs, ge in gaps:
        covered = 0.0
        while first < len(ordered) and ordered[first][2] <= gs:
            first += 1
        for k in range(first, len(ordered)):
            name, ps, pe = ordered[k]
            if ps >= ge:
                break
            part = min(ge, pe) - max(gs, ps)
            if part > 0:
                idle[name] = idle.get(name, 0.0) + part
                covered += part
        if ge - gs - covered > 0:
            idle["between"] = idle.get("between", 0.0) + (ge - gs - covered)
    return {"kernels": kernels, "busy_s": busy, "window_s": t1 - t0, "idle": idle}


def breakdown(red: Dict, top: int = 10) -> Dict:
    """The result line's ``breakdown``: the device activities that took
    most time, and the idle time by host phase."""
    ops = sorted(red["kernels"].items(), key=lambda kv: -kv[1][1])[:top]
    idle = sorted(red["idle"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[name[:NAME_CHARS], secs] for name, (_, secs) in ops],
            "idle_gaps": [[name, secs] for name, secs in idle]}
