"""Drift detection from one-pass statistics — the refit trigger.

A copy of the JAX package's ``repro.online.drift`` (numpy only); the tests
hold its signals equal to the reference's.

The continuous loop should not refit on every arrival (an update is cheap
but not free) nor serve a stale model once the data moved.  The
:class:`DriftMonitor` decides, from exactly the statistics the fit already
keeps — per-feature first/second moments and the frozen min-max range — and
nothing else: observing a chunk is O(rows * n) host adds, no device work.

Signals, all computed in the *scaled* space the models are fitted in:

* **mean shift** — per-feature ``|mean_window - mean_ref| / std_ref``: the
  distribution moved.
* **mse0 ratio** — per-feature windowed variance over reference variance
  (either direction).  The per-feature variance is the closed-form MSE of
  the best degree-0 fit — the ``mse0`` every OAVI degree step starts from —
  so a blown-up ratio means polynomials that used to vanish on the data no
  longer do (or vice versa): the vanishing structure itself changed.
* **out-of-range fraction** — share of values outside ``[0, 1]`` under the
  *frozen* scaler: new data escaped the min-max box the scaler was fitted
  on, the one failure the frozen-scaler design cannot absorb (the loop
  should refit with a fresh scaler).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from .state import FitState


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """Refit-trigger thresholds (see module docstring for the signals)."""

    mean_shift: float = 0.25  # max per-feature |mean shift| / ref std
    mse0_ratio: float = 2.0  # max per-feature var ratio (either direction)
    range_frac: float = 1e-3  # tolerated fraction of out-of-[0,1] values
    min_rows: int = 512  # don't judge drift on fewer window rows

    def __post_init__(self):
        if self.mean_shift <= 0 or self.mse0_ratio <= 1.0 or self.range_frac < 0:
            raise ValueError(
                "need mean_shift > 0, mse0_ratio > 1, range_frac >= 0; got "
                f"({self.mean_shift}, {self.mse0_ratio}, {self.range_frac})"
            )


class DriftMonitor:
    """Fold incoming (scaled) chunks into window statistics; compare against
    a reference (typically the fitted data's own moments).

    Usage::

        monitor = DriftMonitor.from_fit_state(state)   # or set_reference()
        monitor.observe(scaled_chunk)                  # per arrival
        if monitor.should_refit()[0]:
            ...run the update, then monitor.rebase()
    """

    def __init__(self, config: DriftConfig = DriftConfig()):
        self.config = config
        self._ref: Optional[Tuple[np.ndarray, np.ndarray, int]] = None
        self.reset_window()

    # -- reference ----------------------------------------------------------

    def set_reference(self, s1: np.ndarray, sq: np.ndarray, rows: int) -> None:
        """Reference from one-pass sums: ``s1[j] = sum x_j``,
        ``sq[j] = sum x_j^2`` over ``rows`` scaled rows."""
        if rows <= 1:
            raise ValueError(f"reference needs > 1 rows, got {rows}")
        self._ref = (
            np.asarray(s1, np.float64).copy(),
            np.asarray(sq, np.float64).copy(),
            int(rows),
        )

    @classmethod
    def from_fit_state(
        cls, state: FitState, config: DriftConfig = DriftConfig()
    ) -> "DriftMonitor":
        """Reference = the Pearson moment snapshot the fit already paid for
        (``s1`` and ``diag(s2)`` over ``moment_rows`` rows).  Requires a
        state fitted with a Pearson ordering (otherwise no moments exist —
        use :meth:`set_reference` with your own pass)."""
        if state.moments is None or state.moment_rows <= 1:
            raise ValueError(
                "FitState carries no moment statistics (ordering='none'?); "
                "seed the monitor with set_reference() instead"
            )
        mon = cls(config)
        s1, s2 = state.moments
        mon.set_reference(s1, np.diagonal(s2), state.moment_rows)
        return mon

    # -- window -------------------------------------------------------------

    def reset_window(self) -> None:
        self._w_s1: Optional[np.ndarray] = None
        self._w_sq: Optional[np.ndarray] = None
        self._w_rows = 0
        self._w_oob = 0
        self._w_vals = 0

    def observe(self, chunk) -> None:
        """Fold one chunk of *scaled* rows into the drift window."""
        rows = np.asarray(chunk, np.float64)
        if rows.ndim != 2 or rows.shape[0] == 0:
            return
        if self._w_s1 is None:
            self._w_s1 = np.zeros((rows.shape[1],), np.float64)
            self._w_sq = np.zeros((rows.shape[1],), np.float64)
        self._w_s1 += rows.sum(axis=0)
        self._w_sq += (rows * rows).sum(axis=0)
        self._w_rows += rows.shape[0]
        self._w_oob += int(((rows < 0.0) | (rows > 1.0)).sum())
        self._w_vals += rows.size

    def rebase(self) -> None:
        """After a refit absorbed the window: fold it into the reference and
        start a fresh window (the new normal includes the observed data)."""
        if self._ref is not None and self._w_rows:
            s1, sq, rows = self._ref
            self._ref = (s1 + self._w_s1, sq + self._w_sq, rows + self._w_rows)
        self.reset_window()

    # -- signals ------------------------------------------------------------

    @property
    def window_rows(self) -> int:
        return self._w_rows

    def signals(self) -> Dict:
        """Current drift signals (NaN-free; zeros while the window or the
        reference is empty)."""
        out = {
            "window_rows": self._w_rows,
            "mean_shift": 0.0,
            "mse0_ratio": 1.0,
            "oob_frac": 0.0,
        }
        if self._ref is None or self._w_rows == 0:
            return out
        s1, sq, rows = self._ref
        mean_r = s1 / rows
        var_r = np.maximum(sq / rows - mean_r**2, 0.0)
        mean_w = self._w_s1 / self._w_rows
        var_w = np.maximum(self._w_sq / self._w_rows - mean_w**2, 0.0)
        eps = 1e-12
        std_r = np.sqrt(np.maximum(var_r, eps))
        out["mean_shift"] = float(np.max(np.abs(mean_w - mean_r) / std_r))
        ratio = np.maximum(var_w, eps) / np.maximum(var_r, eps)
        out["mse0_ratio"] = float(np.max(np.maximum(ratio, 1.0 / ratio)))
        out["oob_frac"] = float(self._w_oob / max(self._w_vals, 1))
        return out

    def should_refit(self) -> Tuple[bool, Dict]:
        """(trigger, signals-with-verdict).  Never triggers before
        ``min_rows`` window rows (tiny windows are all variance)."""
        sig = self.signals()
        cfg = self.config
        triggered = []
        if self._w_rows >= cfg.min_rows:
            if sig["mean_shift"] > cfg.mean_shift:
                triggered.append("mean_shift")
            if sig["mse0_ratio"] > cfg.mse0_ratio:
                triggered.append("mse0_ratio")
            if sig["oob_frac"] > cfg.range_frac:
                triggered.append("oob_frac")
        sig["triggered"] = triggered
        return bool(triggered), sig
