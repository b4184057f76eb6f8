"""Algorithm 2: per-class generator construction -> (FT) -> linear SVM.

Counterpart of ``src/repro/core/pipeline.py``.  The per-class OAVI fits run
sequentially through :func:`repro_torch.api.fit_classes`, the features come
from the fused :func:`repro_torch.api.feature_transform`, and the l1
squared-hinge :class:`~repro_torch.core.svm.LinearSVM` classifies them.
Everything runs on ``device`` (``None`` = the CUDA card).

Not ported yet: class-batched fits (ROADMAP.md queue 1 item 10), streaming
fits and ``capture_fit_state`` (item 11); ``attach_engine`` (item 13) and
``save`` / ``load`` (item 15) raise :class:`NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from .. import _device
from .svm import LinearSVM, LinearSVMConfig
from .transform import MinMaxScaler


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """The reference's ``PipelineConfig`` less the fields of unported paths
    (``mesh``, ``class_batch``, ``chunk_rows``, ``capture_fit_state``)."""

    method: str = "fast"  # repro_torch.api method spec (or bare OAVI variant)
    psi: float = 0.005
    svm: LinearSVMConfig = dataclasses.field(default_factory=LinearSVMConfig)
    oavi_kw: Optional[Dict] = None  # forwarded to the method config
    backend: str = "auto"  # 'auto' | 'local' (both run the local fit)
    batch_size: Optional[int] = None  # fused-transform chunking (rows)


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md {item}")


class VanishingIdealClassifier:
    """Fit per-class generators, transform, train a linear SVM (Algorithm 2)."""

    def __init__(self, config: PipelineConfig = PipelineConfig(), device=None):
        self.config = config
        self.device = _device.resolve(device)
        self.dtype = (config.oavi_kw or {}).get("dtype", "float32")
        self.scaler = MinMaxScaler(dtype=self.dtype)
        self.models: List = []
        self.svm = LinearSVM(config.svm, device=self.device)
        self.classes_: Optional[np.ndarray] = None
        self.stats: Dict = {}

    def _feature_transform(self, X) -> np.ndarray:
        from .. import api

        return api.feature_transform(
            self.models, X, batch_size=self.config.batch_size, dtype=self.dtype,
            device=self.device,
        )

    def head(self, feats) -> np.ndarray:
        """Classifier head over precomputed (FT) features: SVM argmax."""
        return self.svm.predict(np.asarray(feats))

    def fit(self, X, y) -> "VanishingIdealClassifier":
        from .. import api

        cfg = self.config
        t0 = time.perf_counter()
        X = self.scaler.fit_transform(X)
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        self.models = api.fit_classes(
            [X[y == c] for c in self.classes_],
            method=cfg.method,
            psi=cfg.psi,
            backend=cfg.backend,
            device=self.device,
            **dict(cfg.oavi_kw or {}),
        )
        t_gen = time.perf_counter() - t0
        t1 = time.perf_counter()
        Xt = self._feature_transform(X)
        t_transform = time.perf_counter() - t1
        t2 = time.perf_counter()
        self.svm.fit(Xt, y)
        t_svm = time.perf_counter() - t2
        agg = api.aggregate_fit_stats(self.models)
        self.stats = {
            "time_generators": t_gen,
            "time_transform": t_transform,
            "time_svm": t_svm,
            "time_total": time.perf_counter() - t0,
            "num_features": Xt.shape[1],
            "G_plus_O": sum(m.num_G + m.num_O for m in self.models),
            "regrowths": agg["regrowths"],
            "kernel_launches": agg["kernel_launches"],
            "per_class": [m.stats for m in self.models],
            "svm": self.svm.stats,
        }
        return self

    def transform(self, X) -> np.ndarray:
        return self._feature_transform(self.scaler.transform(X))

    def predict(self, X) -> np.ndarray:
        return self.svm.predict(self.transform(X))

    def score(self, X, y) -> float:
        return float(np.mean(self.predict(X) == np.asarray(y)))

    # -- not ported yet ----------------------------------------------------

    def attach_engine(self, *args, **kwargs):
        raise _not_ported("the serving engine (attach_engine)", "queue 1 item 13")

    def save(self, path: str) -> str:
        raise _not_ported("classifier save", "queue 1 item 15")

    @classmethod
    def load(cls, path: str):
        raise _not_ported("classifier load", "queue 1 item 15")
