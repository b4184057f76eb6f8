"""Runtime substrate: fault tolerance (checkpoint-restart, stragglers,
re-placement on resume).  Counterpart of ``src/repro/runtime``."""
from . import fault_tolerance
from .fault_tolerance import StepFailure, TrainLoop, TrainLoopConfig, reshard_tree

__all__ = ["fault_tolerance", "TrainLoop", "TrainLoopConfig", "StepFailure", "reshard_tree"]
