"""Datasets of the paper's experiments, for the port.

A copy of ``appendix_c``, ``uci_like``, ``multiclass_planted``,
``lognormal_sizes``, ``random_cube`` and ``train_test_split`` from the JAX
package's ``repro.data.synthetic`` (numpy only; the port imports nothing of
that package):

* :func:`appendix_c` — the paper's 2M-sample synthetic dataset, to its exact
  specification (Appendix C): class 1 satisfies ``x1^2 + 0.01 x2 + x3^2 = 1``,
  class 2 satisfies ``x1^2 + x3^2 = 1.3``, both perturbed by N(0, 0.05^2).
* :func:`uci_like` — datasets matching the (m, n, #classes) shapes of the
  paper's UCI table, with classes planted on distinct random algebraic sets.
* :func:`multiclass_planted`, :func:`lognormal_sizes` — k planted classes of
  given (lognormal-skewed) sizes: the multi-class fit benchmark's regime.
* :func:`random_cube` — uniform noise in [0,1]^n (Figure 1's setting).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# (m, n, num_classes) of the paper's Table 2 datasets.
UCI_SHAPES: Dict[str, Tuple[int, int, int]] = {
    "bank": (1372, 4, 2),
    "credit": (30000, 22, 2),
    "htru": (17898, 8, 2),
    "seeds": (210, 7, 3),
    "skin": (245057, 3, 2),
    "spam": (4601, 57, 2),
}


def appendix_c(m: int = 2_000_000, seed: int = 0, noise: float = 0.05):
    """The paper's synthetic dataset (Appendix C).  Returns (X, y) raw
    (un-scaled); apply min-max scaling as the pipeline does."""
    rng = np.random.default_rng(seed)
    m1 = m // 2
    m2 = m - m1
    # class 1: x1^2 + 0.01 x2 + x3^2 - 1 = 0
    x2 = rng.uniform(0.0, 1.0, m1)
    theta = rng.uniform(0.0, 2.0 * np.pi, m1)
    r2 = np.maximum(1.0 - 0.01 * x2, 0.0)
    x1 = np.sqrt(r2) * np.cos(theta)
    x3 = np.sqrt(r2) * np.sin(theta)
    c1 = np.stack([x1, x2, x3], axis=1)
    # class 2: x1^2 + x3^2 - 1.3 = 0  (x2 free)
    theta = rng.uniform(0.0, 2.0 * np.pi, m2)
    x1 = np.sqrt(1.3) * np.cos(theta)
    x3 = np.sqrt(1.3) * np.sin(theta)
    x2 = rng.uniform(0.0, 1.0, m2)
    c2 = np.stack([x1, x2, x3], axis=1)
    X = np.concatenate([c1, c2], axis=0)
    X += rng.normal(0.0, noise, X.shape)
    y = np.concatenate([np.zeros(m1, np.int32), np.ones(m2, np.int32)])
    perm = rng.permutation(m)
    return X[perm].astype(np.float32), y[perm]


def _planted_class(rng, m: int, n: int, degree: int = 2, noise: float = 0.03):
    """Sample points near a random degree-``degree`` algebraic set in R^n.

    We draw a random polynomial constraint on the first 3 (or n) coordinates
    and project random points onto it approximately via one Newton step, then
    add noise — cheap, and guarantees an approximately-vanishing polynomial
    exists for the class.
    """
    k = min(3, n)
    w = rng.uniform(0.5, 1.5, k)
    c = rng.uniform(0.5, 1.5)
    X = rng.uniform(0.0, 1.0, (m, n))
    # constraint sum_j w_j x_j^degree = c on the first k coords; rescale those
    s = (w * X[:, :k] ** degree).sum(axis=1)
    scale = (c / np.maximum(s, 1e-9)) ** (1.0 / degree)
    X[:, :k] *= scale[:, None]
    X += rng.normal(0.0, noise, X.shape)
    return X


def uci_like(name: str, seed: int = 0):
    """Procedural stand-in with the (m, n, k) shape of the named UCI set."""
    if name not in UCI_SHAPES:
        raise KeyError(f"unknown dataset {name!r}; options: {sorted(UCI_SHAPES)}")
    m, n, k = UCI_SHAPES[name]
    rng = np.random.default_rng(seed)
    sizes = [m // k] * k
    sizes[-1] += m - sum(sizes)
    Xs, ys = [], []
    for c, mc in enumerate(sizes):
        Xs.append(_planted_class(rng, mc, n, degree=2 + (c % 2)))
        ys.append(np.full(mc, c, np.int32))
    X = np.concatenate(Xs, axis=0)
    y = np.concatenate(ys)
    perm = rng.permutation(m)
    return X[perm].astype(np.float32), y[perm]


def multiclass_planted(sizes, n: int = 4, seed: int = 0):
    """k classes of the given ``sizes``, each planted on its own random
    algebraic set (see :func:`_planted_class`) — the multi-class fit
    benchmark's dataset.  Returns shuffled ``(X, y)``."""
    rng = np.random.default_rng(seed)
    Xs, ys = [], []
    for c, mc in enumerate(sizes):
        Xs.append(_planted_class(rng, int(mc), n, degree=2 + (c % 2)))
        ys.append(np.full(int(mc), c, np.int32))
    X = np.concatenate(Xs, axis=0)
    y = np.concatenate(ys)
    perm = rng.permutation(X.shape[0])
    return X[perm].astype(np.float32), y[perm]


def lognormal_sizes(k: int, mean_rows: int, sigma: float = 0.8, seed: int = 0):
    """Lognormal-skewed class sizes with the given mean — the skewed-classes
    regime of the multi-class benchmark (min size clipped to 32)."""
    rng = np.random.default_rng(seed)
    raw = rng.lognormal(mean=0.0, sigma=sigma, size=k)
    sizes = np.maximum((raw / raw.mean() * mean_rows).astype(int), 32)
    return [int(s) for s in sizes]


def random_cube(m: int, n: int, seed: int = 0):
    """Uniform [0,1]^n noise (Figure 1 setting: no algebraic structure)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, (m, n)).astype(np.float32)


def train_test_split(X, y, test_frac: float = 0.4, seed: int = 0):
    """Paper's 60/40 random partition."""
    rng = np.random.default_rng(seed)
    m = X.shape[0]
    perm = rng.permutation(m)
    cut = int(round(m * (1.0 - test_frac)))
    tr, te = perm[:cut], perm[cut:]
    return X[tr], y[tr], X[te], y[te]
