"""Request-batched serving of vanishing-ideal feature transforms on one
device (counterpart of ``src/repro/serving``).

Once the generators are built, the (FT) feeding Algorithm 2's linear SVM is
polynomial evaluation.  This package turns the fused transform of
:mod:`repro_torch.api` into a service:

* :class:`~repro_torch.serving.engine.TransformEngine` — one plan per model
  set, its constants held on the device, pow2 query-size buckets warmed
  before traffic, every call row-stable (bit-identical to the direct
  transform on the same device).
* :class:`~repro_torch.serving.batcher.MicroBatcher` — coalesces concurrent
  transform / predict requests into one padded device call and scatters the
  results back to each caller, with retries, poison bisection, deadlines and
  a loss-free shutdown.
* :class:`~repro_torch.serving.registry.ModelRegistry` — loads models and
  classifiers from checkpoint paths (either package's), warms their engines,
  and hot-swaps versions.

``python -m repro_torch.launch.serve_vi`` stands the whole stack up and
replays a request trace.  The sharded engine is ROADMAP.md queue 1 item 12b.
"""

from .batcher import BatcherConfig, DeadlineExceeded, MicroBatcher, ShutdownError
from .engine import EngineConfig, TransformEngine, UnsupportedModelError
from .registry import ModelRegistry, RegistryEntry, load_servable

__all__ = [
    "BatcherConfig",
    "DeadlineExceeded",
    "EngineConfig",
    "MicroBatcher",
    "ModelRegistry",
    "RegistryEntry",
    "ShutdownError",
    "TransformEngine",
    "UnsupportedModelError",
    "load_servable",
]
