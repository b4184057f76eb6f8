"""The host beside the window.  The cells' fits are paced by the host's
launches, so a run times two fixed probes before and after its window:

* ``probe_ms``: a fixed pure-Python loop, in ms (the median of five);
* ``launch_us``: a fixed run of small operations on the card, in us a
  launch.

Counters of ``/proc`` (load average, steal time, the cores' clock, the
thread's run delay) are not read: the machines with the card report a load
of 0.00, no steal, a fixed clock and no scheduler statistics.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, Optional

PROBE_N = 200_000
LAUNCHES = 2000


def probe_ms() -> float:
    """Median of five timings of a fixed pure-Python loop, in ms."""
    times = []
    for _ in range(5):
        t = time.perf_counter()
        acc = 0
        for i in range(PROBE_N):
            acc += i * i
        times.append(time.perf_counter() - t)
    return 1e3 * statistics.median(times)


def launch_us(device) -> Optional[float]:
    """Host time a small operation takes to launch on ``device``, in us
    (None off the card)."""
    import torch

    if torch.device(device).type != "cuda":
        return None
    x = torch.zeros(16, device=device)
    torch.cuda.synchronize(device)
    t = time.perf_counter()
    for _ in range(LAUNCHES):
        x.add_(1.0)
    torch.cuda.synchronize(device)
    return 1e6 * (time.perf_counter() - t) / LAUNCHES


def probes(device) -> Dict:
    """Both probes, taken outside the window."""
    return {"probe_ms": probe_ms(), "launch_us": launch_us(device)}


def witness(before: Dict, after: Dict) -> Dict:
    """The probes before and after the window, side by side."""
    return {k: [round(before[k], 3), round(after[k], 3)] for k in before
            if before[k] is not None}
