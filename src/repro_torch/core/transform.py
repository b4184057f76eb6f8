"""Feature transformation (FT) and min-max scaling (Section 3.2).

Copies of ``MinMaxScaler`` and the per-model ``feature_transform`` loop from
the JAX package's ``repro.core.transform``; the port's tests hold each pair
equal.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

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


def feature_transform(models: Sequence, Z, dtype: Optional[str] = None) -> np.ndarray:
    """(FT): stack ``|g(Z)|`` over the generators of every per-class model.

    ``models`` -- one fitted generator model per class (``OAVIModel`` or
    ``VCAModel``), each evaluated on its own device in its own dtype.  Returns host numpy (q, sum_i |G^i|) in
    ``dtype`` (default: the first model's dtype), and (q, 0) float64 for no
    models.

    This is the per-model loop; :func:`repro_torch.api.feature_transform`
    fuses OAVI models into one evaluation and falls back to this loop for
    the rest.
    """
    out_dtype = np.dtype(dtype) if dtype is not None else None
    cols: List[np.ndarray] = []
    for model in models:
        G = model.evaluate_G(Z).cpu().numpy()
        if out_dtype is None:
            out_dtype = G.dtype
        cols.append(np.abs(G).astype(out_dtype, copy=False))
    if not cols:
        return np.zeros((np.asarray(Z).shape[0], 0), out_dtype or np.float64)
    return np.concatenate(cols, axis=1)
