"""Shared code of the benchmark: the spec, the inputs, the timing loop,
the tracer, the device record, the work counts and the comparison.  Nothing
here knows a particular cell: cells, configurations, traffic mixes and
per-layer metrics are files found by name."""

from __future__ import annotations


def sync(device) -> None:
    """Wait for ``device``'s queued work (nothing to wait for on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
