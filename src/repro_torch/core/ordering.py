"""Data-driven term ordering via Pearson correlation (Section 5, Algorithm 5).

Features are sorted *increasingly* by their total absolute Pearson correlation
with all features, making monomial-aware algorithms (OAVI, ABM) invariant to
the initial feature permutation of the data set.

A copy of the JAX package's ``repro.core.ordering``: the port imports nothing
of that package, and its tests hold the two copies equal.
"""

from __future__ import annotations

import numpy as np


def pearson_correlation_matrix(X: np.ndarray) -> np.ndarray:
    """|r_{ij}| for all feature pairs; constant features get r = 0 (off-diag)."""
    X = np.asarray(X, dtype=np.float64)
    Xc = X - X.mean(axis=0, keepdims=True)
    std = np.sqrt((Xc * Xc).sum(axis=0))
    denom = np.outer(std, std)
    cov = Xc.T @ Xc
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.where(denom > 0, cov / np.maximum(denom, 1e-300), 0.0)
    np.fill_diagonal(r, 1.0)
    return np.abs(r)


def pearson_scores(X: np.ndarray) -> np.ndarray:
    """p_i = sum_j |r_{c_i c_j}| (Line 2 of Algorithm 5)."""
    return pearson_correlation_matrix(X).sum(axis=1)


def pearson_order(X: np.ndarray, reverse: bool = False) -> np.ndarray:
    """Permutation sorting features increasingly by p_i (decreasingly if
    ``reverse``).  Ties are broken by original index (stable), which the paper
    notes happens with probability 0 on noisy data."""
    p = pearson_scores(X)
    order = np.argsort(-p if reverse else p, kind="stable")
    return order.astype(np.int64)


def pearson_scores_from_moments(s1: np.ndarray, s2: np.ndarray, m: int) -> np.ndarray:
    """``p_i`` from streamed float64 sufficient statistics ``s1 = sum_r x_r``
    and ``s2 = sum_r x_r x_r^T`` — the out-of-core counterpart of
    :func:`pearson_scores`.  The centered covariance ``s2 - s1 s1^T / m``
    agrees with the two-pass in-memory formula up to float64 summation-order
    drift, which can only flip the resulting ordering on (measure-zero)
    near-exact score ties."""
    s1 = np.asarray(s1, np.float64)
    cov = np.asarray(s2, np.float64) - np.outer(s1, s1) / float(m)
    std = np.sqrt(np.maximum(np.diag(cov), 0.0))
    denom = np.outer(std, std)
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.where(denom > 0, cov / np.maximum(denom, 1e-300), 0.0)
    np.fill_diagonal(r, 1.0)
    return np.abs(r).sum(axis=1)


def pearson_order_from_moments(
    s1: np.ndarray, s2: np.ndarray, m: int, reverse: bool = False
) -> np.ndarray:
    """Streaming-moments variant of :func:`pearson_order`."""
    p = pearson_scores_from_moments(s1, s2, m)
    order = np.argsort(-p if reverse else p, kind="stable")
    return order.astype(np.int64)
