"""Incremental OAVI on the port (counterpart of ``repro.online``).

The Gram statistics behind the streaming degree step add over rows and fold
bit-reproducibly under the Gram kernel's carry-in, so a fit over arriving
data is a fold: persist the per-degree accumulators (:class:`FitState`),
fold new chunks into them (:func:`update`, bit-identical to a full streamed
refit of the grown data), re-run the degree steps that do not depend on m,
and decide when to refit from one-pass drift signals
(:class:`DriftMonitor`).  The continuous loop that serves while it folds
is :mod:`repro_torch.launch.continuous_vi`.
"""

from .drift import DriftConfig, DriftMonitor
from .state import FIT_STATE_FORMAT, DegreeRecord, FitState
from .update import UpdateResult, fit, update

__all__ = [
    "DegreeRecord",
    "DriftConfig",
    "DriftMonitor",
    "FIT_STATE_FORMAT",
    "FitState",
    "UpdateResult",
    "fit",
    "update",
]
