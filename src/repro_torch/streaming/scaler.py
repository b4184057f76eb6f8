"""One-pass streaming min-max scaling — bit-exact vs the in-memory scaler.

A copy of the JAX package's ``repro.streaming.scaler`` (numpy only), on the
port's own :class:`repro_torch.core.transform.MinMaxScaler`.

Min and max are exactly associative and commutative reductions (no rounding
ever occurs), so accumulating per-chunk extrema in any chunking produces the
*identical* ``lo`` / ``scale`` statistics as
:meth:`repro_torch.core.transform.MinMaxScaler.fit` on the materialized array; the
(inherited) elementwise ``transform`` is then bit-identical row for row in
every output dtype it threads (f32 / bf16 / f16 / f64).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.transform import MinMaxScaler
from .source import DataSource, as_source, iter_chunks

DEFAULT_CHUNK_ROWS = 4096


@dataclasses.dataclass
class StreamingMinMaxScaler(MinMaxScaler):
    """Min-max scaling fitted one chunk at a time.

    ``partial_fit`` folds a chunk's extrema into the running statistics and
    refreshes ``lo`` / ``scale``, so the scaler is usable (and serializable,
    via the inherited fields) after any prefix of the stream; ``fit_source``
    drives one full pass over a :class:`~repro_torch.streaming.source.DataSource`.
    The in-memory ``fit(X)`` still works and resets the stream state.
    """

    hi: Optional[np.ndarray] = None

    def reset(self) -> "StreamingMinMaxScaler":
        self.lo = self.hi = self.scale = None
        return self

    def partial_fit(self, chunk) -> "StreamingMinMaxScaler":
        chunk = np.asarray(chunk, dtype=np.float64)
        if chunk.shape[0] == 0:
            return self
        lo = chunk.min(axis=0)
        hi = chunk.max(axis=0)
        if self.hi is None or self.lo is None:
            self.lo, self.hi = lo, hi
        else:
            self.lo = np.minimum(self.lo, lo)
            self.hi = np.maximum(self.hi, hi)
        rng = self.hi - self.lo
        self.scale = np.where(rng > 0, 1.0 / np.maximum(rng, 1e-300), 0.0)
        return self

    def fit(self, X) -> "StreamingMinMaxScaler":
        return self.reset().partial_fit(X)

    def fit_source(
        self, source: DataSource, chunk_rows: int = DEFAULT_CHUNK_ROWS
    ) -> "StreamingMinMaxScaler":
        """One pass over ``source``; only the padded trailing chunk's valid
        rows enter the statistics."""
        self.reset()
        for chunk, valid in iter_chunks(as_source(source), chunk_rows):
            self.partial_fit(chunk[:valid])
        if self.lo is None:
            raise ValueError("cannot fit a scaler on an empty source")
        return self
