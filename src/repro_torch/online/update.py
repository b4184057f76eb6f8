"""Incremental OAVI: fold new rows into persisted Gram state.

Counterpart of ``src/repro/online/update.py``.  :func:`update` takes a fitted
model, its :class:`~repro_torch.online.state.FitState` and the *grown*
source (old rows first, new rows appended) and returns the model of the
grown data, degree by degree:

* a degree whose stored :class:`DegreeRecord` still matches the new fit's
  decision history folds only rows ``[aligned_rows, m_new)`` into the saved
  accumulators: its data work drops from O(m) to O(new rows);
* a degree whose border changed (new data flipped a verdict upstream)
  replays rows ``[0, m_new)``.  The book is built by appending only, so the
  degrees before the first changed verdict keep folding.

Both paths give accumulators bit-identical to a full streamed refit of the
grown source at matched capacity: the fold resumes on a
:data:`~repro_torch.kernels.ops.GRAM_BLOCK` boundary, so the Gram kernel's
blocked fp32 reduction sees the block partition of one pass (its carry-in
contract), and the degree step then runs on equal inputs.  The Pearson
moments are snapshotted on the ``chunk_rows`` grid, the one-pass fold's own
partition, for the same reason.  The degree step re-runs for every degree,
folded or replayed: it is O(Lcap^2) and independent of m.

The degree loop is the streaming fit's (:func:`repro_torch.streaming.fit.
fit_degrees`), with the snapshot and resume switched on.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np

from .. import _device
from ..core import oracles
from ..core.oavi import OAVIConfig, OAVIModel, check_config, finish_fit_stats
from ..core.ordering import pearson_order_from_moments
from ..kernels import ops as kernel_ops
from ..streaming.fit import (
    DEFAULT_CHUNK_ROWS,
    _check_chunk_rows,
    fit_degrees,
    new_stats,
    pearson_moments,
)
from ..streaming.source import DataSource, as_source
from .state import DegreeRecord, FitState


@dataclasses.dataclass
class UpdateResult:
    """What :func:`update` hands back: the refreshed model (bit-identical to
    a full refit of the grown data), the fit state for the *next* update,
    and the update's accounting."""

    model: OAVIModel
    state: FitState
    stats: Dict


def _probe_row(source: DataSource, row: int) -> np.ndarray:
    return np.array(source.read(row, row + 1)[0])


def _pearson_perm(
    source: DataSource,
    chunk_rows: int,
    config: OAVIConfig,
    base: Optional[FitState],
) -> Tuple[np.ndarray, Tuple[np.ndarray, np.ndarray], int]:
    """Feature permutation of the (grown) source and the chunk-aligned
    moment snapshot for the next state.

    Moments are snapshotted at ``(m // chunk_rows) * chunk_rows``, a chunk
    boundary of the one-pass fold, so folding new full chunks onto the
    snapshot reproduces :func:`~repro_torch.streaming.fit.
    streaming_pearson_order`'s float64 sums bit for bit.  A base state with
    another ``chunk_rows`` cannot reuse its snapshot (another partition):
    the moments are then recomputed from the start."""
    m = source.num_rows
    aligned = (m // chunk_rows) * chunk_rows
    if (
        base is not None
        and base.moments is not None
        and base.chunk_rows == chunk_rows
        and base.moment_rows <= aligned
    ):
        s1, s2 = pearson_moments(source, chunk_rows, start=base.moment_rows, stop=aligned,
                                 s1=base.moments[0], s2=base.moments[1])
    else:
        s1, s2 = pearson_moments(source, chunk_rows, stop=aligned)
    s1f, s2f = pearson_moments(source, chunk_rows, start=aligned, s1=s1, s2=s2)
    perm = pearson_order_from_moments(s1f, s2f, m,
                                      reverse=(config.ordering == "reverse_pearson"))
    return perm, (s1, s2), aligned


def _scaler_stats(scaler) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    if scaler is None or getattr(scaler, "lo", None) is None:
        return None, None
    lo = np.asarray(scaler.lo, np.float64)
    hi = getattr(scaler, "hi", None)
    if hi is None and getattr(scaler, "scale", None) is not None:
        # a plain MinMaxScaler keeps (lo, scale); recover hi where the range
        # was non-degenerate, else hi = lo
        scale = np.asarray(scaler.scale, np.float64)
        hi = np.where(scale > 0, lo + 1.0 / np.where(scale > 0, scale, 1.0), lo)
    return lo, (None if hi is None else np.asarray(hi, np.float64))


def _drive(
    source: DataSource,
    config: OAVIConfig,
    chunk_rows: int,
    state_in: Optional[FitState],
    perm: Optional[np.ndarray],
    moments: Optional[Tuple[np.ndarray, np.ndarray]],
    moment_rows: int,
    scaler,
    prefetch: bool,
    device,
) -> Tuple[OAVIModel, FitState]:
    """The degree loop behind :func:`fit` (``state_in=None``: every degree
    streams all rows) and :func:`update` (matching degrees fold only the
    rows past the snapshot)."""
    check_config(config)
    dev = _device.resolve(device)
    t_start = time.perf_counter()
    launches0 = kernel_ops.launch_counts()
    reads0 = oracles.host_reads
    m, n = source.num_rows, source.num_features
    base_rows = state_in.num_rows if state_in is not None else 0
    stats = new_stats(m, n, chunk_rows, online={
        "base_rows": base_rows,
        "new_rows": m - base_rows,
        "folded_degrees": 0,
        "replayed_degrees": [],
    })
    book, generators, Lcap, snapshots = fit_degrees(
        source, config, chunk_rows, perm, dev, prefetch, stats, base=state_in, capture=True)
    finish_fit_stats(stats, book, generators, Lcap, launches0, reads0, t_start)
    scaler_lo, scaler_hi = _scaler_stats(scaler)
    model = OAVIModel(n=n, psi=config.psi, book=book, generators=generators,
                      feature_perm=perm, stats=stats, dtype=config.dtype, device=dev)
    new_state = FitState(
        n=n,
        num_rows=m,
        aligned_rows=(m // kernel_ops.GRAM_BLOCK) * kernel_ops.GRAM_BLOCK,
        chunk_rows=chunk_rows,
        config=config,
        book_parents=np.asarray(book.parents, np.int32),
        book_vars=np.asarray(book.vars, np.int32),
        records=[DegreeRecord(**snap) for snap in snapshots],
        feature_perm=None if perm is None else np.asarray(perm),
        moments=moments,
        moment_rows=moment_rows,
        scaler_lo=scaler_lo,
        scaler_hi=scaler_hi,
        probe_first=_probe_row(source, 0) if m else None,
        probe_last=_probe_row(source, m - 1) if m else None,
    )
    return model, new_state


def fit(
    source,
    config: OAVIConfig = OAVIConfig(),
    *,
    chunk_rows: int = DEFAULT_CHUNK_ROWS,
    scaler=None,
    prefetch: bool = True,
    device=None,
) -> Tuple[OAVIModel, FitState]:
    """Streamed OAVI fit that also captures the incremental
    :class:`FitState`: the model equals :func:`repro_torch.streaming.fit`'s
    on the same source and ``chunk_rows`` bit for bit.  ``scaler`` (a fitted
    min-max scaler, the frozen one the source is composed with) is recorded
    in the state as the drift reference.  ``device=None`` means the CUDA
    card."""
    source = as_source(source)
    chunk_rows = _check_chunk_rows(chunk_rows)
    perm = moments = None
    moment_rows = 0
    if config.ordering in ("pearson", "reverse_pearson"):
        perm, moments, moment_rows = _pearson_perm(source, chunk_rows, config, None)
    return _drive(source, config, chunk_rows, None, perm, moments, moment_rows, scaler,
                  prefetch, device)


def update(
    model: Optional[OAVIModel],
    state: FitState,
    source,
    *,
    chunk_rows: Optional[int] = None,
    scaler=None,
    prefetch: bool = True,
    check_probes: bool = True,
    device=None,
) -> UpdateResult:
    """Refit on a grown source, folding instead of re-reading where possible.

    ``source`` must be the FULL grown dataset: rows ``[0, state.num_rows)``
    equal to the data the state accumulated (same scaler, same order), the
    new rows appended.  Whole access is needed because a flipped verdict
    makes the affected degrees replay every row; unchanged degrees never
    read the old rows.  The returned model equals a streamed fit
    (:func:`repro_torch.streaming.fit` or :func:`fit`) of the same source at
    the same capacity and chunk size, bit for bit, for every engine.
    ``device=None`` means the CUDA card.
    """
    t0 = time.perf_counter()
    source = as_source(source)
    config = state.config
    chunk_rows = state.chunk_rows if chunk_rows is None else _check_chunk_rows(chunk_rows)
    m_new = source.num_rows
    if source.num_features != state.n:
        raise ValueError(
            f"source has {source.num_features} features, state was built on {state.n}"
        )
    if m_new < state.num_rows:
        raise ValueError(
            f"source shrank: {m_new} rows < state.num_rows={state.num_rows}; "
            "update() only supports appended data"
        )
    if model is not None:
        mp = np.asarray(model.book.parents, np.int32)
        mv = np.asarray(model.book.vars, np.int32)
        if not (np.array_equal(mp, state.book_parents) and np.array_equal(mv, state.book_vars)):
            raise ValueError(
                "model/state mismatch: the FitState does not belong to this "
                "model (different term books)"
            )
    if check_probes and state.probe_first is not None and state.num_rows:
        same_first = np.array_equal(_probe_row(source, 0), state.probe_first)
        same_last = state.probe_last is None or np.array_equal(
            _probe_row(source, state.num_rows - 1), state.probe_last)
        if not (same_first and same_last):
            raise ValueError(
                "source prefix mismatch: rows the state already accumulated "
                "changed (different data, ordering, or scaler); incremental "
                "statistics would be silently wrong — refit from scratch"
            )

    refit_reason = None
    perm = moments = None
    moment_rows = 0
    state_eff: Optional[FitState] = state
    if chunk_rows != state.chunk_rows:
        # another chunk grid re-partitions the Pearson moment sums; the Gram
        # records stay foldable (their alignment is GRAM_BLOCK)
        refit_reason = "chunk_rows_changed"
    if config.ordering in ("pearson", "reverse_pearson"):
        perm, moments, moment_rows = _pearson_perm(source, chunk_rows, config, state)
        if state.feature_perm is None or not np.array_equal(perm,
                                                            np.asarray(state.feature_perm)):
            # the permutation relabels every book column: no record survives
            state_eff = None
            refit_reason = "feature_order_changed"
    elif state.feature_perm is not None:
        state_eff = None
        refit_reason = "feature_order_changed"

    new_model, new_state = _drive(source, config, chunk_rows, state_eff, perm, moments,
                                  moment_rows, scaler, prefetch, device)
    if scaler is None:
        # carry the drift reference forward unless the caller replaces it
        new_state.scaler_lo = state.scaler_lo
        new_state.scaler_hi = state.scaler_hi
    online = new_model.stats["online"]
    online["base_rows"] = state.num_rows  # even when records were dropped
    online["new_rows"] = m_new - state.num_rows
    if refit_reason is not None:
        online["refit_reason"] = refit_reason
    up_stats = {
        "base_rows": state.num_rows,
        "new_rows": m_new - state.num_rows,
        "folded_degrees": online["folded_degrees"],
        "replayed_degrees": list(online["replayed_degrees"]),
        "refit_reason": refit_reason,
        "chunks": new_model.stats["streaming"]["num_chunks"],
        "time_update": time.perf_counter() - t0,
    }
    return UpdateResult(model=new_model, state=new_state, stats=up_stats)
