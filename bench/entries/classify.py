"""Algorithm 2 as its users run it: ``VanishingIdealClassifier.fit`` on
the training rows, then ``predict`` on the test rows.  One timed fit is
both calls."""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

import numpy as np

from ..harness import sync
from ..harness import work as work_mod
from ..reference import pipeline as ref
from . import _models


def prepare(cfg: Dict, traffic: Dict, inputs: Dict, device) -> Dict:
    from repro_torch.core.pipeline import PipelineConfig, VanishingIdealClassifier
    from repro_torch.core.svm import LinearSVMConfig

    f, s = cfg["fit"], cfg["fit"]["svm"]
    config = PipelineConfig(
        method=f["method"], psi=f["psi"], class_batch=f["class_batch"],
        oavi_kw={"max_degree": f["max_degree"], "dtype": f["dtype"]},
        svm=LinearSVMConfig(lam=s["lam"], max_iter=s["max_iter"], tol=s["tol"],
                            dtype=s["dtype"]))
    # the warm-up fit: the same shapes, its SVM cut to a few checks
    warm = dataclasses.replace(config, svm=dataclasses.replace(
        config.svm, max_iter=int(traffic["warm_svm_iters"])))
    return {"cls": VanishingIdealClassifier, "config": config, "warm": warm,
            "inputs": inputs, "device": device}


def _fit(st: Dict, config) -> Dict:
    x = st["inputs"]
    clf = st["cls"](config, device=st["device"])
    feats = []
    inner = clf.transform

    def transform(X):  # keeps the test features that predict computes
        F = inner(X)
        feats.append(F)
        return F

    clf.transform = transform
    t0 = time.perf_counter()
    clf.fit(x["Xtr"], x["ytr"])
    t_fit = time.perf_counter()
    pred = clf.predict(x["Xte"])
    sync(st["device"])
    return {"t0": t0, "t_fit": t_fit, "t1": time.perf_counter(), "clf": clf, "pred": pred,
            "feats": feats[-1] if feats else None}


def warm(st: Dict) -> None:
    _fit(st, st["warm"])


def run(st: Dict) -> Dict:
    return _fit(st, st["config"])


def phases(rec: Dict):
    s = rec["clf"].stats
    t = rec["t0"]
    out = []
    for name, key in (("generators", "time_generators"), ("transform", "time_transform"),
                      ("svm", "time_svm")):
        out.append((name, t, t + s[key]))
        t += s[key]
    return out + [("predict", rec["t_fit"], rec["t1"])]


def stats(rec: Dict) -> Dict:
    clf = rec["clf"]
    s = clf.stats
    return {"time_generators": s["time_generators"], "time_transform": s["time_transform"],
            "time_svm": s["time_svm"], "svm_iters": s["svm"]["iters"],
            **_models.group_timing(clf.models), "signature": _models.signature(clf.models),
            "seconds": rec["t1"] - rec["t0"]}


def extract(rec: Dict) -> Dict:
    clf = rec["clf"]
    return {"models": [_models.plain_model(m) for m in clf.models], "classes": clf.classes_,
            "test_features": rec["feats"], "W": clf.svm.W, "b": clf.svm.b,
            "svm_iters": clf.svm.stats["iters"], "pred": rec["pred"]}


def judge(inputs: Dict, out: Dict, cfg: Dict, device) -> Dict:
    return ref.judge_classify(inputs, out, cfg["fit"], device)


def control(inputs: Dict, cfg: Dict, device) -> Dict:
    return ref.classify(inputs, cfg["fit"], "tf32", device)


def work(inputs: Dict, out: Dict, cfg: Dict) -> Dict:
    ytr = inputs["ytr"]
    sizes = [int(np.sum(ytr == c)) for c in np.unique(ytr)]
    w = _models.fit_work(out["models"], sizes, int(cfg["fit"]["max_degree"]))
    q = inputs["Xtr"].shape[0] + inputs["Xte"].shape[0]
    p = sum(len(m["G"]) for m in out["models"])
    flops = (w["gram"][0] + w["ihb_degree"][0]
             + sum(work_mod.transform(q, m) for m in out["models"])
             + work_mod.fista(inputs["Xtr"].shape[0], p, len(sizes), int(out["svm_iters"])))
    return {**w, "flops": flops}
