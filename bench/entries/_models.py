"""Shared helpers of the entries: the program's fitted models as plain
data, the per-class rows, and the work of a set of fitted models."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..harness import work as work_mod


def plain_model(model) -> Dict:
    """A fitted OAVI model of the program as the reference's plain dict."""
    perm = model.feature_perm
    return {
        "perm": np.arange(model.n) if perm is None else np.asarray(perm, np.int64),
        "O": [tuple(int(e) for e in t) for t in model.book.terms],
        "G": [(tuple(int(e) for e in g.term), np.asarray(g.coeffs), float(g.mse))
              for g in model.generators],
    }


def fit_work(models: Sequence[Dict], sizes: Sequence[int], max_degree: int) -> Dict:
    """Gram and candidate-loop work of one fit over all classes:
    ``{"gram": (flops, bytes), "ihb_degree": (flops, bytes)}``."""
    g = [0.0, 0.0]
    c = [0.0, 0.0]
    for mdl, m in zip(models, sizes):
        for step in work_mod.degree_steps(mdl, int(m), max_degree):
            g = [g[0] + step["gram"][0], g[1] + step["gram"][1]]
            c = [c[0] + step["loop"][0], c[1] + step["loop"][1]]
    return {"gram": tuple(g), "ihb_degree": tuple(c)}


def group_timing(models) -> Dict[str, float]:
    """The class-batched group's timing contract, shared by its models."""
    st = models[0].stats
    return {k: float(st[k]) for k in ("time_setup", "time_degrees", "time_finalize",
                                       "time_total") if k in st}


def signature(models: List) -> tuple:
    """A fit's structure in brief, to tell fits of different work apart."""
    return tuple((m.num_O, m.num_G) for m in models)
