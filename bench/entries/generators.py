"""Algorithm 2's generator phase alone: ``api.fit_classes`` of the
training classes, min-max scaled as the pipeline scales them.  One timed
fit is one call."""

from __future__ import annotations

import time
from typing import Dict

from ..harness import sync
from ..reference import oavi as ref_oavi
from ..reference import pipeline as ref
from . import _models


def class_rows(inputs: Dict):
    """The inputs of this entry, handed alike to the program and to the
    reference: the training rows scaled into float32 and cut by class."""
    if "classes" not in inputs:
        inputs["classes"] = ref.scaled_classes(inputs["Xtr"], inputs["ytr"])[2]
    return inputs["classes"]


def prepare(cfg: Dict, traffic: Dict, inputs: Dict, device) -> Dict:
    from repro_torch import api

    f = cfg["fit"]
    kw = dict(method=f["method"], psi=f["psi"], class_batch=f["class_batch"],
              max_degree=f["max_degree"], dtype=f["dtype"], device=device)
    return {"fit": api.fit_classes, "kw": kw, "classes": class_rows(inputs), "device": device}


def run(st: Dict) -> Dict:
    t0 = time.perf_counter()
    models = st["fit"](st["classes"], **st["kw"])
    sync(st["device"])
    return {"t0": t0, "t1": time.perf_counter(), "models": models}


def warm(st: Dict) -> None:
    run(st)


def phases(rec: Dict):
    t = _models.group_timing(rec["models"])
    a = rec["t0"] + t["time_setup"]
    b = rec["t0"] + t["time_total"] - t["time_finalize"]
    c = rec["t0"] + t["time_total"]
    return [("fit_setup", rec["t0"], a), ("degree_loop", a, b), ("finalize", b, c),
            ("api_return", c, rec["t1"])]


def stats(rec: Dict) -> Dict:
    return {**_models.group_timing(rec["models"]),
            "signature": _models.signature(rec["models"]), "seconds": rec["t1"] - rec["t0"]}


def extract(rec: Dict) -> Dict:
    return {"models": [_models.plain_model(m) for m in rec["models"]]}


def judge(inputs: Dict, out: Dict, cfg: Dict, device) -> Dict:
    return ref.judge_generators(class_rows(inputs), out["models"], cfg["fit"], device)


def control(inputs: Dict, cfg: Dict, device) -> Dict:
    f = cfg["fit"]
    return {"models": [ref_oavi.fit(Xc, float(f["psi"]), int(f["max_degree"]), "tf32", device)
                       for Xc in class_rows(inputs)]}


def work(inputs: Dict, out: Dict, cfg: Dict) -> Dict:
    sizes = [Xc.shape[0] for Xc in class_rows(inputs)]
    w = _models.fit_work(out["models"], sizes, int(cfg["fit"]["max_degree"]))
    return {**w, "flops": w["gram"][0] + w["ihb_degree"][0]}
