"""Algorithm 2 written plainly, and the judge of a fitted classifier.

The outputs judged are plain dicts, as the benchmark's entries copy them
from the program:

* ``models``: one model dict per class (see :mod:`.oavi`), classes in
  sorted order;
* ``test_features``: the (FT) features of the test rows the classifier
  computed to predict them, or ``None``;
* ``W``, ``b``: the SVM head; ``pred``: the predicted test labels.

:func:`classify` runs the whole pipeline itself (the control, at
``prec="tf32"``).  :func:`judge_classify` derives everything again at
float64 from the raw inputs, following the models' structure as
:func:`.oavi.judge` does, and returns the numbers compared.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..harness.traffic import min_max_scale
from . import oavi, svm


def scaled_classes(Xtr: np.ndarray, ytr: np.ndarray):
    """The training rows min-max scaled into float32 and cut by class."""
    Xs = min_max_scale(Xtr, Xtr)
    classes = np.unique(ytr)
    return Xs, classes, [Xs[ytr == c] for c in classes]


def features(X: np.ndarray, models: Sequence[Dict], coefs: Sequence[Sequence], prec: str,
             device) -> torch.Tensor:
    """(FT) over every class's model, columns class by class."""
    blocks = [oavi.evaluate(X, mdl, cs, prec, device) for mdl, cs in zip(models, coefs)]
    return torch.cat(blocks, dim=1)


def classify(inputs: Dict, fit_cfg: Dict, prec: str, device) -> Dict:
    """Fit Algorithm 2 on the training rows and predict the test rows, every
    decision this file's own, in ``prec``."""
    Xtr, ytr, Xte = inputs["Xtr"], inputs["ytr"], inputs["Xte"]
    Xs, classes, Xcs = scaled_classes(Xtr, ytr)
    psi, maxd = float(fit_cfg["psi"]), int(fit_cfg["max_degree"])
    models = [oavi.fit(Xc, psi, maxd, prec, device) for Xc in Xcs]
    coefs = [[g[1] for g in mdl["G"]] for mdl in models]
    Ftr = features(Xs, models, coefs, prec, device)
    s = fit_cfg["svm"]
    W, b, iters, cls = svm.fit(Ftr, ytr, s["lam"], s["max_iter"], s["tol"], prec)
    del Ftr
    Fte = features(min_max_scale(Xtr, Xte), models, coefs, prec, device).cpu().numpy()
    return {"models": models, "classes": cls, "test_features": Fte, "W": W, "b": b,
            "svm_iters": iters, "pred": cls[np.argmax(Fte @ W + b, axis=1)]}


def judge_models(Xcs: Sequence[np.ndarray], models: Sequence[Dict], fit_cfg: Dict,
                 device) -> Dict:
    """:func:`.oavi.judge` over every class: messages, the worst of each
    number, and each class's float64 coefficients (``None`` where its
    structure failed)."""
    psi, maxd = float(fit_cfg["psi"]), int(fit_cfg["max_degree"])
    out = {"structure": [], "verdict": 0.0, "mse_gap": 0.0, "coef_excess": 0.0, "coefs": []}
    if len(models) != len(Xcs):
        out["structure"].append(f"{len(models)} models for {len(Xcs)} classes")
        return out
    for c, (Xc, mdl) in enumerate(zip(Xcs, models)):
        r = oavi.judge(Xc, mdl, psi, maxd, device)
        out["structure"] += [f"class {c}: {e}" for e in r["structure"]]
        for key in ("verdict", "mse_gap", "coef_excess"):
            out[key] = max(out[key], float(r[key]))
        out["coefs"].append(r["coef"])
    return out


def _rel_max(got: np.ndarray, want: np.ndarray) -> float:
    """Largest entry of ``|got - want|`` over the largest ``|want|``."""
    return float(np.max(np.abs(got - want)) / max(float(np.max(np.abs(want))), 1e-30))


def judge_classify(inputs: Dict, out: Dict, fit_cfg: Dict, device) -> Dict:
    """Every number compared for a classifier's outputs ``out`` (see the
    module docstring), worked out again at float64 from ``inputs``."""
    Xtr, ytr, Xte = inputs["Xtr"], inputs["ytr"], inputs["Xte"]
    Xs, classes, Xcs = scaled_classes(Xtr, ytr)
    res = judge_models(Xcs, out["models"], fit_cfg, device)
    nums = {k: res[k] for k in ("verdict", "mse_gap", "coef_excess")}
    nums["structure"] = list(res["structure"])
    n_feat = sum(len(m["G"]) for m in out["models"])
    if not np.array_equal(np.asarray(out.get("classes")), classes):
        nums["structure"].append("classes differ")
    if np.shape(out["W"]) != (n_feat, len(classes)) or np.shape(out["b"]) != (len(classes),):
        nums["structure"].append(f"SVM head of shape {np.shape(out['W'])} for {n_feat} features")
    if np.shape(out["pred"]) != (Xte.shape[0],):
        nums["structure"].append("a prediction per test row is missing")
    if nums["structure"]:
        return nums
    coefs = res["coefs"]
    Ftr = features(Xs, out["models"], coefs, "fp64", device)
    s = fit_cfg["svm"]
    W, b, iters, _ = svm.fit(Ftr, ytr, s["lam"], s["max_iter"], s["tol"], "fp64")
    f_ref = svm.objective(Ftr, ytr, W, b, s["lam"])
    nums["svm_objective"] = abs(svm.objective(Ftr, ytr, out["W"], out["b"], s["lam"]) - f_ref) / f_ref
    del Ftr
    Fte = features(min_max_scale(Xtr, Xte), out["models"], coefs, "fp64", device).cpu().numpy()
    if out.get("test_features") is not None:
        F = np.asarray(out["test_features"], np.float64)
        nums["feature_gap"] = float(np.max(np.abs(F - Fte))) if F.shape == Fte.shape else np.inf
    Wb = np.concatenate([np.asarray(out["W"], np.float64), np.asarray(out["b"], np.float64)[None]])
    nums["svm_gap"] = _rel_max(Wb, np.concatenate([W, b[None]]))
    nums["svm_iters_ref"] = iters
    scores = Fte @ W + b
    pred_ref = classes[np.argmax(scores, axis=1)]
    flips = np.asarray(out["pred"]) != pred_ref
    top2 = np.sort(scores, axis=1)[:, -2:]
    margin = (top2[:, 1] - top2[:, 0]) / max(float(np.median(np.abs(scores))), 1e-30)
    nums["label_flips"] = int(flips.sum())
    nums["label_margin"] = float(margin[flips].max()) if flips.any() else 0.0
    return nums


def judge_generators(Xcs: List[np.ndarray], models: Sequence[Dict], fit_cfg: Dict,
                     device) -> Dict:
    """The numbers compared for per-class generator fits of ``Xcs``."""
    res = judge_models(Xcs, models, fit_cfg, device)
    return {k: res[k] for k in ("structure", "verdict", "mse_gap", "coef_excess")}
