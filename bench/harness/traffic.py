"""The benchmark's inputs: the one general generator that turns a
configuration and a run seed into the arrays a cell hands to the program
and to the reference, and the paper's preprocessing.

The generator is a lookup: a configuration's ``dataset["generator"]`` names
the module ``bench/inputs/<generator>.py``, whose ``make(dataset, seed)``
makes the inputs.  ``appendix_c`` and ``train_test_split``, the frozen
copies of the paper's dataset and split, live in ``bench/inputs/
appendix_c.py`` and are importable from here as well.
"""

from __future__ import annotations

import importlib
from typing import Dict

import numpy as np

from ..inputs.appendix_c import appendix_c, train_test_split
from .spec import NAME

__all__ = ["appendix_c", "train_test_split", "make_inputs", "min_max_scale"]


def make_inputs(dataset: Dict, seed: int) -> Dict[str, np.ndarray]:
    """The cell's inputs for run seed ``seed``: ``make(dataset, seed)`` of
    the module that ``dataset["generator"]`` names."""
    name = dataset["generator"]
    if not (isinstance(name, str) and NAME.match(name)):
        raise ValueError(f"generator {name!r} is no name of a module in bench/inputs/")
    module = f"bench.inputs.{name}"
    try:
        gen = importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise LookupError(f"no generator {name!r}: bench/inputs/{name}.py not found") from None
    return gen.make(dataset, seed)


def min_max_scale(Xtr: np.ndarray, X: np.ndarray, dtype=np.float32) -> np.ndarray:
    """Min-max scaling into [0, 1]^n with the statistics of ``Xtr``, in
    float64, the result rounded to ``dtype`` (the paper's preprocessing;
    a constant feature maps to 0)."""
    Xtr = np.asarray(Xtr, np.float64)
    lo = Xtr.min(axis=0)
    rng = Xtr.max(axis=0) - lo
    scale = np.where(rng > 0, 1.0 / np.maximum(rng, 1e-300), 0.0)
    out = np.clip((np.asarray(X, np.float64) - lo) * scale, 0.0, 1.0)
    return out.astype(dtype)
