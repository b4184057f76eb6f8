"""The benchmark's inputs: frozen copies of the paper's dataset generators
and the one general generator that turns a configuration and a run seed
into the arrays a cell hands to the program and to the reference.

``appendix_c`` and ``train_test_split`` are copies of the program's
``repro_torch.data.synthetic`` functions, kept here so that a later change
to the program cannot move the yardstick.

What a run seed changes: a configuration fixes its dataset (generator,
sizes and ``data_seed``) and its train/test partition (``split_seed``), as a
deployment fixes the data it fits.  The run seed draws the order of the
training rows and the order of the test rows.  Every seed therefore hands
the program the same rows in another order: the same work, and the same
fitted structure up to the rounding that the row order changes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def appendix_c(m: int = 2_000_000, seed: int = 0, noise: float = 0.05):
    """The paper's synthetic dataset (Appendix C): class 1 on
    ``x1^2 + 0.01 x2 + x3^2 = 1``, class 2 on ``x1^2 + x3^2 = 1.3``, both
    perturbed by N(0, noise^2).  Returns (X float32, y int32), unscaled."""
    rng = np.random.default_rng(seed)
    m1 = m // 2
    m2 = m - m1
    x2 = rng.uniform(0.0, 1.0, m1)
    theta = rng.uniform(0.0, 2.0 * np.pi, m1)
    r2 = np.maximum(1.0 - 0.01 * x2, 0.0)
    x1 = np.sqrt(r2) * np.cos(theta)
    x3 = np.sqrt(r2) * np.sin(theta)
    c1 = np.stack([x1, x2, x3], axis=1)
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


def train_test_split(X, y, test_frac: float = 0.4, seed: int = 0):
    """The paper's random partition (60/40 by default)."""
    rng = np.random.default_rng(seed)
    m = X.shape[0]
    perm = rng.permutation(m)
    cut = int(round(m * (1.0 - test_frac)))
    tr, te = perm[:cut], perm[cut:]
    return X[tr], y[tr], X[te], y[te]


GENERATORS = {
    "appendix_c": lambda p: appendix_c(m=int(p["m"]), seed=int(p["data_seed"]),
                                       noise=float(p.get("noise", 0.05))),
}


def make_inputs(dataset: Dict, seed: int) -> Dict[str, np.ndarray]:
    """The cell's inputs for run seed ``seed``: the configuration's dataset
    split 60/40 (or as it says), each part in an order drawn from ``seed``.
    Returns host arrays ``Xtr, ytr, Xte, yte`` as users hand them to the
    API: raw float32 rows and int32 labels."""
    X, y = GENERATORS[dataset["generator"]](dataset)
    Xtr, ytr, Xte, yte = train_test_split(X, y, test_frac=float(dataset["test_frac"]),
                                          seed=int(dataset["split_seed"]))
    rng = np.random.default_rng(int(seed))
    p_tr = rng.permutation(Xtr.shape[0])
    p_te = rng.permutation(Xte.shape[0])
    return {"Xtr": Xtr[p_tr], "ytr": ytr[p_tr], "Xte": Xte[p_te], "yte": yte[p_te]}


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
