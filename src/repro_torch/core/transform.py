"""Min-max scaling into [0, 1]^n (Section 3.2), as the paper applies it.

A copy of ``MinMaxScaler`` from the JAX package's ``repro.core.transform``
(numpy only); the port's tests hold the two equal.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class MinMaxScaler:
    """Min-max feature scaling into [0, 1]^n (fit on train, reused on test).

    Statistics are computed in float64 for numerical safety; ``dtype`` (when
    set) casts the *output*, so downstream float32 models are not silently
    fed float64 data.  ``dtype=None`` keeps float64.
    """

    lo: Optional[np.ndarray] = None
    scale: Optional[np.ndarray] = None
    dtype: Optional[str] = None

    def fit(self, X) -> "MinMaxScaler":
        X = np.asarray(X, dtype=np.float64)
        self.lo = X.min(axis=0)
        rng = X.max(axis=0) - self.lo
        self.scale = np.where(rng > 0, 1.0 / np.maximum(rng, 1e-300), 0.0)
        return self

    def transform(self, X) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        out = np.clip((X - self.lo) * self.scale, 0.0, 1.0)
        return out.astype(self.dtype) if self.dtype is not None else out

    def fit_transform(self, X) -> np.ndarray:
        return self.fit(X).transform(X)
